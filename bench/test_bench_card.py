"""Each cell through the command itself on the card, briefly: the
result line's keys, the device and ``correct``. Skips without a CUDA
device; run on the card with ``python -m pytest -m gpu bench/``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from bench import conftest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", conftest.CELLS)
def test_cell_on_card(cell, card):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2
