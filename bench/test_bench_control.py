"""The control of each cell at a size the CPU holds: the plain reference
put in the program's place one precision below the configuration's
(int4 for the int8 products and TF32 for float32 attention in the
executed plan, fp8 for bfloat16 training, TF32 for the float32 served
model) must come out not correct by the cell's limits, as must a
training step on half of each batch. On the chip the same readings are
taken at each cell's own size (`bench/calibrate.py`)."""

import pytest

from bench import harness


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("cell", ["glm4-9b.exec-decode32k",
                                  "minicpm-2b.train-4x1024",
                                  "glm4-9b.serve-decode-b32",
                                  "minicpm-2b.serve-prefill-b4"])
def test_control_is_not_correct(cell, seed, tiny_run, one_thread):
    run = tiny_run(cell, seed=seed, seconds=0.2)
    sources = ["control"] + (["half_batch"] if "train" in cell else [])
    res = harness.run_cell(run, sources)
    limits = run.cell.workload["limits"]
    assert res["correct"], res["checks"]
    for s in sources:
        assert not harness.judge(res["readings"][s], limits), \
            (s, res["readings"])
