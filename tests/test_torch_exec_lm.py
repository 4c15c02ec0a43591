"""The port's execution zoo (`repro_torch/exec_lm.py`) against the
reference's `benchmarks/exec_lm.py`: the same constants and flags, and the
reduced run on the CPU (greedy solves, so no MIP wall clock) with the same
plans as the reference lowers from the same solves."""

import json

import pytest

torch = pytest.importorskip("torch")

import benchmarks.exec_lm as ref_exec_lm
import repro.configs as ref_configs
import repro.core.executor as ref_executor
import repro.core.frontend as ref_frontend
import repro.core.network as ref_network
from benchmarks.common import md_table as ref_md_table
from repro.core.arch import default_arch as ref_default_arch
from repro_torch import exec_lm


def test_constants_kept_from_reference():
    assert exec_lm.EXEC_SHAPES.keys() == ref_exec_lm.EXEC_SHAPES.keys()
    for name, spec in exec_lm.EXEC_SHAPES.items():
        ref = ref_exec_lm.EXEC_SHAPES[name]
        assert (spec.name, spec.seq_len, spec.global_batch, spec.kind) == \
            (ref.name, ref.seq_len, ref.global_batch, ref.kind)
    assert exec_lm.REDUCED_ARCHS == ref_exec_lm.REDUCED_ARCHS
    assert (exec_lm.RANK_FLOOR, exec_lm.MIN_RANK_POINTS, exec_lm.QUICK_CAP_S,
            exec_lm.QUICK_AVG_S) == \
        (ref_exec_lm.RANK_FLOOR, ref_exec_lm.MIN_RANK_POINTS,
         ref_exec_lm.QUICK_CAP_S, ref_exec_lm.QUICK_AVG_S)
    rows = [["a", 1, 0.123456, "-"], ["b", 22, 1e-5, "ok"]]
    assert exec_lm.md_table(["x", "y", "z", "w"], rows) == \
        ref_md_table(["x", "y", "z", "w"], rows)


def test_default_device_without_cuda_fails_before_solving(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_solve(*args, **kwargs):
        raise AssertionError("solved before the device check")
    monkeypatch.setattr(exec_lm, "optimize_network", no_solve)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exec_lm.main(["--reduced"])
    with pytest.raises(SystemExit):      # the reference's interpret flag
        exec_lm.main(["--reduced", "--no-interpret"])


def test_exec_lm_reduced_cpu_matches_reference_plans(tmp_path, monkeypatch):
    """Every row numerics OK on the plain versions; all three kernel
    families and both models' wGrad covered; each row's op count equal to
    the reference's `lower_plan` on the same greedy solve."""
    monkeypatch.setenv("MIREDO_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("MIREDO_REPORTS", str(tmp_path / "reports"))
    payload = exec_lm.run(reduced=True, device="cpu",
                          archs=exec_lm.REDUCED_ARCHS, mode="greedy",
                          repeats=1)
    rows = payload["rows"]
    assert len(rows) == len(exec_lm.REDUCED_ARCHS) * len(exec_lm.EXEC_SHAPES)
    assert all(r["numerics_ok"] and r["paths"] == ["plain"] for r in rows)
    assert payload["kernels"] == sorted(exec_lm.KERNELS)
    assert payload["wgrad_covered"] == sorted(exec_lm.REDUCED_ARCHS)
    assert payload["device"] == "cpu" and payload["n_rank_points"] >= \
        exec_lm.MIN_RANK_POINTS
    saved = json.loads((tmp_path / "reports" / "torch_exec_lm.json")
                       .read_text())
    assert saved["rows"] == json.loads(json.dumps(rows))
    rarch = ref_default_arch()
    for r in rows:
        rcfg = ref_configs.get_config(r["model"]).reduced()
        rspec = ref_exec_lm.EXEC_SHAPES[r["scenario"]]
        work = ref_frontend.extract_workload(rcfg, rspec)
        net = ref_network.optimize_network(
            list(work.layers), rarch, "greedy", counts=list(work.counts),
            use_cache=False, workers=1)
        ref = ref_executor.lower_plan(rcfg, rspec, net, rarch)
        assert r["ops"] == len(ref.ops) and r["unique"] <= ref.n_unique, r
        assert r["predicted_serial_cycles"] == ref.predicted_serial_cycles
