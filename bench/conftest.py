"""Fixtures of the benchmark's CPU tests: each cell shrunk to a size the
CPU runs in a second or two, through the same drivers and references."""

import pytest

#: Sizes of the CPU tests: every configuration at two layers and small
#: widths, every traffic mix at a few tokens (the MIP in its greedy mode).
TINY_MODEL = {
    "glm4-9b": {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
                "head_dim": 16, "d_ff": 128, "vocab_size": 256,
                "padded_vocab": 2048},
    "minicpm-2b": {"n_layers": 2, "d_model": 128, "n_heads": 4,
                   "n_kv_heads": 4, "head_dim": 32, "d_ff": 256,
                   "vocab_size": 1000, "padded_vocab": 2048},
}
TINY_TRAFFIC = {
    "exec-decode32k": {"mode": "greedy"},
    "train-4x1024": {"batch": 4, "seq": 16, "feed_batches": 4},
    "serve-decode-b32": {"batch": 4, "prompt_len": 16, "max_seq": 48,
                         "gen_len": 8, "prefill_group": 2,
                         "sample_requests": 2},
    "serve-prefill-b4": {"batch": 2, "lengths": [8, 16], "repeats": 1,
                         "sample_batches": 2},
}
CELLS = ("glm4-9b.exec-decode32k", "minicpm-2b.train-4x1024",
         "glm4-9b.serve-decode-b32", "minicpm-2b.serve-prefill-b4")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips without one)")


@pytest.fixture
def tiny_run(tmp_path, monkeypatch):
    """``tiny_run(cell, seed=..., seconds=...)``: a CPU ``Run`` of the
    cell at the test sizes, its solve cache in a temporary directory."""
    from bench import harness
    monkeypatch.setenv("MIREDO_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("MIREDO_REPORTS", str(tmp_path / "reports"))

    def make(name, seed=2 ** 31 + 11, seconds=0.5, model=None,
             traffic=None):
        cell = harness.find_cell(name)
        ov = {"model": {**TINY_MODEL[cell.workload["config"]],
                        **(model or {})},
              "traffic": {**TINY_TRAFFIC[cell.workload["traffic"]],
                          **(traffic or {})}}
        return harness.Run(cell=cell, seed=seed, seconds=seconds,
                           device="cpu", overrides=ov)
    return make


@pytest.fixture
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
