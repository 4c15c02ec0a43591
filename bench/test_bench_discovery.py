"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as new files alone: the harness finds and runs them by
name with no edit to any file it has."""

import json
import shutil

from bench import harness
from bench.trace import Trace


def test_new_files_alone(tmp_path, monkeypatch, tiny_run, one_thread):
    root = tmp_path / "bench"
    shutil.copytree(harness.BENCH, root,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
              if p.is_file()}
    (root / "configs" / "tiny-dense.json").write_text(json.dumps({
        "name": "tiny-dense", "source": "https://example.org/tiny",
        "arch": "glm4-9b", "family": "dense", "reduced": [],
        "model": {"n_layers": 2, "d_model": 32, "n_heads": 2,
                  "n_kv_heads": 1, "head_dim": 16, "d_ff": 64,
                  "vocab_size": 100, "padded_vocab": 2048,
                  "gated_mlp": True, "tie_embeddings": True,
                  "rope_theta": 10000.0, "norm_eps": 1e-5}}))
    (root / "traffic" / "prefill-tiny.json").write_text(json.dumps({
        "driver": "live_prefill", "batch": 2, "lengths": [4, 8],
        "repeats": 1, "sample_batches": 2}))
    (root / "workloads" / "tiny-dense.prefill-tiny.json").write_text(
        json.dumps({"config": "tiny-dense", "traffic": "prefill-tiny",
                    "chips": 1, "why": "a test",
                    "limits": {"token_gap": 1e-3, "logits_err": 1e-4}}))
    (root / "metrics" / "batches_seen.prefill.py").write_text(
        'UNIT = "batches"\n\n\ndef read(ctx):\n'
        '    if ctx.e2e != "ttft_ms_p95":\n        return None\n'
        '    return ctx.work["steps"]\n')
    monkeypatch.setattr(harness, "BENCH", root)
    cell = harness.find_cell("tiny-dense.prefill-tiny")
    assert cell.config["model"]["d_model"] == 32
    run = harness.Run(cell=cell, seed=7, seconds=0.2, device="cpu")
    res = harness.run_cell(run)
    assert res["correct"], res["checks"]
    assert res["metrics"]["ttft_ms_p95"]["value"] > 0
    ctx = harness.Context("ttft_ms_p95", Trace(1.0, [("k", 0.0, 0.5)], [],
                                               2), {"steps": 2}, {})
    got = harness.read_metrics(ctx)
    assert got["batches_seen.prefill"] == {"value": 2, "unit": "batches"}
    assert got["idle_share.prefill"]["value"] == 50.0
    for rel, data in before.items():
        assert (root / rel).read_bytes() == data, rel
