"""The port stands alone: nothing under `src/repro_torch/`, nor
`chip_smoke.py`, imports JAX, the JAX package or its benchmarks, and the
reduced slices (`serve_lm`, and `exec_lm` over mamba2-1.3b) run in a
process where none of them can be imported."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    return files


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_no_jax_or_reference_imports():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom):
                if node.level == 0 and _forbidden(node.module or ""):
                    bad.append((path, node.module))
            elif isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    node.value.startswith(("repro.", "jax.")):
                bad.append((path, node.value))   # importlib targets
    assert not bad, bad


def test_config_registry_points_at_port():
    from repro_torch.configs import registry
    assert all(m.startswith("repro_torch.configs.")
               for m in registry._MODULES.values())


def test_slice_runs_with_jax_and_reference_blocked(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['repro'] = None\n"
        "sys.modules['benchmarks'] = None\n"
        "from repro_torch import exec_lm, serve_lm\n"
        "rep = serve_lm.main(['--reduced', '--device', 'cpu', '--mode', "
        "'greedy'])\n"
        "assert rep.numerics_ok and rep.n_ops == 8\n"
        "out = exec_lm.run(reduced=True, device='cpu', mode='greedy',\n"
        "                  archs=('mamba2-1.3b',), repeats=1)\n"
        "assert all(r['numerics_ok'] for r in out['rows'])\n"
        "assert 'ssd_scan' in out['kernels']\n"
        "assert not any(m.split('.')[0] in ('jax', 'repro', 'benchmarks')\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ISOLATED-OK')\n")
    env = dict(os.environ, MIREDO_CACHE=str(tmp_path),
               MIREDO_REPORTS=str(tmp_path / "reports"),
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ISOLATED-OK" in res.stdout
