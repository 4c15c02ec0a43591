"""Nothing the benchmark runs imports JAX or the JAX package (``jax``,
``jaxlib``, ``flax``, ``repro``, ``benchmarks``, compared as whole
top-level names, so ``repro_torch`` passes), and the references import
nothing of the program either."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness

BENCH = Path(harness.__file__).resolve().parent
ROOT = BENCH.parent
BLOCK = "import sys\nfor m in {mods!r}:\n    sys.modules[m] = None\n"


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.partition(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(
    p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*.py")
    if ".cache" not in p.parts))
def test_sources_import_no_jax(path):
    tops = _imports(BENCH / path)
    assert not tops & set(harness.FORBIDDEN), tops
    if path.startswith(("reference/", "weights.py", "peaks.py")):
        assert "repro_torch" not in tops, tops


def _python(code: str) -> subprocess.CompletedProcess:
    env = {"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}", "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cells_run_with_jax_blocked(tmp_path):
    code = BLOCK.format(mods=list(harness.FORBIDDEN)) + f"""
import os
os.environ["MIREDO_CACHE"] = {str(tmp_path)!r}
from bench import conftest, harness
for name in conftest.CELLS:
    cell = harness.find_cell(name)
    ov = {{"model": conftest.TINY_MODEL[cell.workload["config"]],
          "traffic": conftest.TINY_TRAFFIC[cell.workload["traffic"]]}}
    res = harness.run_cell(harness.Run(cell=cell, seed=3, seconds=0.2,
                                       device="cpu", overrides=ov))
    assert res["correct"], (name, res["checks"])
assert harness.forbidden_loaded() == [], harness.forbidden_loaded()
print("ran", len(conftest.CELLS))
"""
    out = _python(code)
    assert out.returncode == 0 and "ran 4" in out.stdout, out.stderr[-3000:]


def test_references_import_no_program():
    code = BLOCK.format(mods=list(harness.FORBIDDEN) + ["repro_torch"]) + """
import torch
from bench import peaks, weights
from bench.reference import dense_lm, ops, precision
c = {"n_layers": 1, "d_model": 16, "n_heads": 2, "n_kv_heads": 1,
     "head_dim": 8, "d_ff": 32, "padded_vocab": 64, "gated_mlp": True,
     "tie_embeddings": True, "rope_theta": 1e4, "norm_eps": 1e-5}
_, w = weights.draw(torch, weights.dense_layout(c), 1, "cpu")
x = dense_lm.logits(w, c, torch.zeros(1, 4, dtype=torch.long))
assert x.shape == (1, 4, 64)
assert not [m for m, mod in sys.modules.items()
            if mod is not None and m.partition(".")[0] == "repro_torch"]
print("ok")
"""
    out = _python(code)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-3000:]
