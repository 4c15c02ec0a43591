"""The port stands alone: nothing under `src/repro_torch/`, nor
`chip_smoke.py`, imports JAX, the JAX package or its benchmarks, and the
reduced slices (`serve_lm`, `exec_lm` over mamba2-1.3b, ``python -m
repro_torch.serve_lm --live`` for glm4-9b, mamba2-1.3b and
qwen2-moe-a2.7b, ``serve_lm --traffic``, the train step, `train_lm`
through a restart and `optimize_network` on a 2-chip mesh) run in a
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
        "import runpy\n"
        "for arch in ('glm4-9b', 'mamba2-1.3b'):\n"
        "    sys.argv = ['serve_lm', '--live', '--reduced', '--device',\n"
        "                'cpu', '--arch', arch]\n"
        "    try:\n"
        "        runpy.run_module('repro_torch.serve_lm', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, e.code\n"
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


def test_moe_live_and_traffic_run_with_jax_and_reference_blocked(tmp_path):
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = sys.modules['repro'] = None\n"
        "sys.modules['benchmarks'] = None\n"
        "for argv in (['--live', '--reduced', '--device', 'cpu', '--arch',\n"
        "              'qwen2-moe-a2.7b'], ['--traffic']):\n"
        "    sys.argv = ['serve_lm'] + argv\n"
        "    try:\n"
        "        runpy.run_module('repro_torch.serve_lm', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, e.code\n"
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
    assert "continuous batching:" in res.stdout


def test_train_step_runs_with_jax_and_reference_blocked(tmp_path):
    """Two train steps of reduced minicpm-2b (WSD) and qwen2-moe-a2.7b,
    with 2 microbatches and the int8 compression on."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['repro'] = None\n"
        "sys.modules['benchmarks'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.train import optimizer, steps\n"
        "for arch in ('minicpm-2b', 'qwen2-moe-a2.7b'):\n"
        "    cfg = get_config(arch).reduced()\n"
        "    sc = steps.StepConfig(compute_dtype=torch.float32,\n"
        "                          microbatches=2, compress_pod_grads=True)\n"
        "    state = steps.init_train_state(0, cfg, sc)\n"
        "    step = steps.make_train_step(\n"
        "        cfg, optimizer.OptimizerConfig(schedule='wsd'), sc)\n"
        "    toks = torch.randint(0, cfg.vocab_size, (4, 8))\n"
        "    for _ in range(2):\n"
        "        state, met = step(state, {'tokens': toks, 'labels': toks})\n"
        "    assert torch.isfinite(met['loss']) and int(state.opt.step) == 2\n"
        "    assert state.residuals is not None\n"
        "assert not any(m.split('.')[0] in ('jax', 'repro', 'benchmarks')\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ISOLATED-OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ISOLATED-OK" in res.stdout


def test_train_driver_and_mesh_run_with_jax_and_reference_blocked(tmp_path):
    """``train_lm`` (reduced minicpm-2b on the CPU) through a checkpoint
    restart, and ``optimize_network`` on a 2-chip mesh (greedy), with
    ``jax`` and ``repro`` blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['repro'] = None\n"
        "sys.modules['benchmarks'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from repro_torch import train_lm\n"
        "argv = ['--reduced', '--device', 'cpu', '--batch', '2', '--seq',\n"
        "        '8', '--ckpt-dir', sys.argv[1], '--ckpt-every', '2']\n"
        "l1, _ = train_lm.run(argv + ['--steps', '3'])\n"
        "l2, st = train_lm.run(argv + ['--steps', '5'])\n"
        "assert len(l1) == 3 and len(l2) == 3 and int(st.opt.step) == 6\n"
        "from repro_torch.core import workload as wl\n"
        "from repro_torch.core.arch import default_arch\n"
        "from repro_torch.core.mesh import make_mesh\n"
        "from repro_torch.core.network import optimize_network\n"
        "layers = [wl.gemm('a', 8, 16, 32), wl.gemm('b', 8, 32, 16)]\n"
        "net = optimize_network(layers, None, 'greedy',\n"
        "                       mesh=make_mesh(default_arch(), 2),\n"
        "                       use_cache=False, workers=1)\n"
        "assert all('shard' in lr.record for lr in net.layers)\n"
        "assert net.scheduled['cycles'] > 0\n"
        "assert not any(m.split('.')[0] in ('jax', 'repro', 'benchmarks')\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ISOLATED-OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path / "ck")],
                         env=env, cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ISOLATED-OK" in res.stdout
    assert "[restore] resumed from step 2" in res.stdout


def test_every_module_imports_and_launch_runs_with_jax_and_reference_blocked(
        tmp_path):
    """Every module of the port imports with ``jax`` and ``repro``
    blocked; the scorer's torch backend, the bridge MIP, the sharding plan
    and a reduced dry-run cell (its own process: the fake process group)
    run there too."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = sys.modules['repro'] = None\n"
        "sys.modules['benchmarks'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'repro_torch.launch.mesh', 'repro_torch.launch.roofline',\n"
        "        'repro_torch.launch.dryrun'} <= set(names)\n"
        "from repro_torch.core import baselines, latency_batched as lb\n"
        "from repro_torch.core import workload as wl\n"
        "from repro_torch.core.arch import default_arch\n"
        "from repro_torch.core.gpu_bridge import select_matmul_blocks\n"
        "from repro_torch.configs import SHAPES, get_config\n"
        "from repro_torch.launch.roofline import model_flops\n"
        "from repro_torch.sharding.rules import make_plan\n"
        "layer, arch = wl.gemm('iso', 32, 512, 512), default_arch()\n"
        "pool = baselines.candidate_pool(layer, arch, budget=64)\n"
        "a = lb.score_mappings(pool, layer, arch, backend='torch',\n"
        "                      device='cpu')\n"
        "assert (a.cycles == lb.score_mappings(pool, layer, arch).cycles\n"
        "        ).all()\n"
        "assert select_matmul_blocks(128, 4096, 4096).status == 'OPTIMAL'\n"
        "class M:\n"
        "    mesh_dim_names, shape = ('data', 'model'), (16, 16)\n"
        "plan = make_plan(M(), get_config('glm4-9b'), SHAPES['decode_32k'])\n"
        "assert plan.cache_spec('kv') == (None, 'data', 'model', None, None)\n"
        "assert model_flops('glm4-9b', 'decode_32k') > 0\n"
        "import torch.distributed as dist\n"
        "from torch.testing._internal.distributed.fake_pg import FakeStore\n"
        "from repro_torch.launch.dryrun import lower_cell\n"
        "from repro_torch.launch.mesh import make_production_mesh\n"
        "dist.init_process_group('fake', store=FakeStore(), rank=0,\n"
        "                        world_size=256)\n"
        "rec = lower_cell('mamba2-1.3b', 'decode_32k', multi_pod=False,\n"
        "                 mesh=make_production_mesh(device_type='cpu'),\n"
        "                 cfg=get_config('mamba2-1.3b').reduced())\n"
        "dist.destroy_process_group()\n"
        "assert rec['status'] == 'ok' and rec['flops_error'] is None, rec\n"
        "assert rec['shapes']['caches'] and rec['flops_global'] > 0\n"
        "assert not any(m.split('.')[0] in ('jax', 'repro', 'benchmarks')\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ISOLATED-OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ISOLATED-OK" in res.stdout


def test_harness_clis_run_with_jax_and_reference_blocked(tmp_path):
    """``python -m repro_torch.gpu_bridge_bench`` and ``python -m
    repro_torch.perf_hillclimb`` (glm4-9b ``decode_32k`` kv-int8 at
    published widths on the fake process group) with ``jax``,
    ``repro`` and ``benchmarks`` blocked; each writes its record under
    ``--out`` and nothing else."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['repro'] = None\n"
        "sys.modules['benchmarks'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from repro_torch import gpu_bridge_bench, perf_hillclimb\n"
        "assert gpu_bridge_bench.main(['--out', 'bench']) == 0\n"
        "assert perf_hillclimb.main(['--cell', 'glm4-9b:decode_32k:single',\n"
        "                            '--variant', 'kv-int8',\n"
        "                            '--out', 'climb']) == 0\n"
        "assert not any(m.split('.')[0] in ('jax', 'repro', 'benchmarks')\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ISOLATED-OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ISOLATED-OK" in res.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == ["bench", "climb"]
    assert [p.name for p in (tmp_path / "bench").iterdir()] == \
        ["gpu_bridge.json"]
    assert [p.name for p in (tmp_path / "climb").iterdir()] == \
        ["glm4-9b__decode_32k__single__kv-int8.json"]
