"""The port's launch modules against the JAX package's: `model_flops` for
every arch x shape, `roofline_terms` against its formula with the H100's
rates, the mesh constructors on fake and gloo process groups, and
reduced-width dry-run cells (`repro_torch.launch.dryrun`) whose shapes and
per-device bytes equal those the reference's specs give over
``jax.eval_shape``.

Every process group lives in a subprocess: the fake backend is
process-wide, and a parallel run puts several test files in one worker.
The reference's side runs in a subprocess too, because importing its
dry-run module asks XLA for 512 host devices."""

import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.configs import SHAPES as RSHAPES
from repro.launch import roofline as rroofline
from repro_torch.configs import ARCH_IDS, SHAPES
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import roofline

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
#: (arch, shape, multi-pod) of the reduced dry-run cells: a decode cell
#: (KV caches), a train cell on the multi-pod mesh (optimizer state) and
#: an encoder-decoder prefill (frontend input, output caches).
CELLS = (("glm4-9b", "decode_32k", False),
         ("mamba2-1.3b", "train_4k", True),
         ("seamless-m4t-large-v2", "prefill_32k", False))


def _run(code: str, *args, timeout=300):
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                          *map(str, args)], env=ENV, capture_output=True,
                         text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    return res.stdout


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_model_flops_equal_reference(arch_id, shape):
    assert shape in RSHAPES
    assert roofline.model_flops(arch_id, shape) == \
        rroofline.model_flops(arch_id, shape)


def _record(**kw):
    rec = {"arch": "glm4-9b", "shape": "decode_32k", "multi_pod": False,
           "status": "ok", "mesh": {"data": 16, "model": 16},
           "flops_per_device": 3.0e12, "bytes_per_device": 7.0e9,
           "collective_bytes_per_device": None,
           "collective_reason": "none lowered",
           "memory": {"argument_bytes": 5.0e9, "temp_bytes": None}}
    rec.update(kw)
    return rec


def test_roofline_terms_formula_and_absent_collectives():
    t = roofline.roofline_terms(_record())
    assert t["t_compute_s"] == 3.0e12 / lmesh.PEAK_BF16_FLOPS
    assert t["t_memory_s"] == 7.0e9 / lmesh.HBM_BW
    assert t["t_collective_s"] is None
    assert t["absent_terms"] == {"collective": "none lowered"}
    assert t["dominant"] == "compute"
    mflops = roofline.model_flops("glm4-9b", "decode_32k") / 256
    assert t["model_flops_per_device"] == mflops
    assert t["useful_compute_ratio"] == mflops / 3.0e12
    assert t["roofline_fraction"] == \
        (mflops / lmesh.PEAK_BF16_FLOPS) / (3.0e12 / lmesh.PEAK_BF16_FLOPS)
    assert t["hbm_gb_per_device"] == 5.0
    assert not t["temp_bytes_counted"]
    # a collective dict reads over one card's NVLink rate, negatives clamp
    t = roofline.roofline_terms(_record(
        collective_bytes_per_device={"all-gather": 4.5e11, "x": -1.0},
        memory={"argument_bytes": 5.0e9, "temp_bytes": 2.56e11}))
    assert t["t_collective_s"] == 4.5e11 / lmesh.LINK_BW == 1.0
    assert t["dominant"] == "collective"
    assert t["hbm_gb_per_device"] == 6.0
    # no flop count: the compute term is absent too, memory dominates
    t = roofline.roofline_terms(_record(flops_per_device=None,
                                        flops_error="NotImplementedError"))
    assert t["t_compute_s"] is None and t["dominant"] == "memory"
    assert t["absent_terms"]["compute"] == "NotImplementedError"
    assert roofline.roofline_terms({"status": "skipped", "reason": "r"}) == \
        {"status": "skipped", "reason": "r"}


def test_h100_constants():
    assert (lmesh.PEAK_BF16_FLOPS, lmesh.PEAK_INT8_OPS, lmesh.HBM_BW,
            lmesh.LINK_BW) == (989e12, 1979e12, 3.35e12, 450e9)


def test_mesh_constructors():
    out = _run("""
        import torch, torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch import mesh as lm
        try:
            lm.make_production_mesh(device_type="cpu")
        except RuntimeError as e:
            print("NO-GROUP", e)
        for world, multi in ((256, False), (512, True)):
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=world)
            m = lm.make_production_mesh(multi_pod=multi, device_type="cpu")
            print("MESH", world, m.mesh_dim_names, tuple(m.shape))
            try:
                lm.make_production_mesh(multi_pod=not multi,
                                        device_type="cpu")
            except ValueError as e:
                print("WRONG-SIZE", world)
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=4)
        m = lm.make_host_mesh(device_type="cpu")
        print("HOST", m.mesh_dim_names, tuple(m.shape))
        if not torch.cuda.is_available():
            try:
                lm.make_host_mesh()
            except RuntimeError as e:
                print("NO-CARD", e)
        dist.destroy_process_group()
        """)
    assert "NO-GROUP" in out
    assert "MESH 256 ('data', 'model') (16, 16)" in out
    assert "MESH 512 ('pod', 'data', 'model') (2, 16, 16)" in out
    assert "WRONG-SIZE 256" in out and "WRONG-SIZE 512" in out
    assert "HOST ('data', 'model') (1, 4)" in out
    import torch
    if not torch.cuda.is_available():
        assert "NO-CARD" in out


#: The reference's side of the dry-run cells: global shapes and specs from
#: its own plan over ``jax.eval_shape``, with its dry-run's cache and
#: input shardings (``_cache_shardings``, ``_sanitize``) on its 512-device
#: host mesh.
_REFERENCE = """
    import json, sys
    import jax
    from repro.launch import dryrun as rd
    from repro.launch.mesh import make_production_mesh
    from repro.configs import SHAPES, get_config
    from repro.sharding.rules import make_plan
    from repro.train.steps import StepConfig, init_train_state, \\
        make_prefill_step

    def name(path):
        return ".".join(str(getattr(q, "name", getattr(q, "key",
                        getattr(q, "idx", q)))) for q in path)

    def specs(tree, spec_of):
        out = {}
        jax.tree_util.tree_map_with_path(
            lambda p, l: out.__setitem__(name(p), [list(l.shape),
                                                   str(l.dtype),
                                                   spec_of(p, l)]), tree)
        return out

    res = {}
    for arch, shape_name, multi in json.loads(sys.argv[1]):
        cfg, shape = get_config(arch).reduced(), SHAPES[shape_name]
        mesh = make_production_mesh(multi_pod=multi)
        plan = make_plan(mesh, cfg, shape)
        sc = StepConfig(remat=True, microbatches=1)
        key = jax.random.PRNGKey(0)
        pspec = lambda p, l: [list(e) if isinstance(e, tuple) else e
                              for e in plan.param_spec(
                                  tuple(str(getattr(q, "key", getattr(
                                      q, "idx", q))) for q in p), l)]
        sspec = lambda sh: [list(e) if isinstance(e, tuple) else e
                            for e in sh.spec]
        state = jax.eval_shape(lambda k: init_train_state(k, cfg, sc), key)
        cell = {"params": specs(state.params, pspec)}
        if shape.kind == "train":
            cell["state"] = specs(state.opt, pspec)
        batch = rd.input_specs(cfg, shape)
        cell["inputs"] = {
            k: [list(v.shape), str(v.dtype),
                sspec(rd._sanitize(mesh, plan.batch_spec(), v.shape))
                if v.ndim >= 2 else []] for k, v in batch.items()}
        caches = None
        if shape.kind == "decode":
            caches = jax.eval_shape(lambda: rd.init_caches(
                cfg, shape.global_batch, shape.seq_len))
        elif shape.kind == "prefill":
            caches = jax.eval_shape(make_prefill_step(cfg, sc),
                                    state.params, batch)[1]
        if caches is not None:
            shard = rd._cache_shardings(plan, caches)
            flat = dict(zip(
                [name(p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(caches)[0]],
                jax.tree_util.tree_leaves(shard)))
            cell["caches"] = specs(caches, lambda p, l: sspec(flat[name(p)]))
        res[f"{arch}/{shape_name}/{multi}"] = cell
    print(json.dumps(res))
"""


#: `lower_cell` for (arch, shape, multi-pod) at the reduced widths on the
#: production mesh over the fake process group, as the dry run's CLI lays
#: it out; prints the record.
_LOWER_REDUCED = """
    import json, sys
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import make_production_mesh

    arch, shape, multi = sys.argv[1], sys.argv[2], bool(int(sys.argv[3]))
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        rec = lower_cell(arch, shape, multi_pod=multi, mesh=mesh,
                         cfg=get_config(arch).reduced())
    finally:
        dist.destroy_process_group()
    print(json.dumps(rec))
"""


@pytest.fixture(scope="module")
def reference_cells():
    out = _run(_REFERENCE, json.dumps(CELLS), timeout=600)
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape,multi", CELLS)
def test_dryrun_cell_matches_reference_specs(tmp_path, reference_cells,
                                             arch, shape, multi):
    """One cell of `dryrun.lower_cell` at the config's reduced widths, in
    its own process on the fake process group: every input, parameter
    leaf, optimizer moment and cache has the reference's global shape,
    dtype and spec, and its local shape and per-device bytes are the
    largest shard that spec gives."""
    rec = json.loads(_run(_LOWER_REDUCED, arch, shape, int(multi))
                     .strip().splitlines()[-1])
    assert rec["status"] == "ok"
    axes = rec["mesh"]
    assert axes == ({"pod": 2, "data": 16, "model": 16} if multi
                    else {"data": 16, "model": 16})
    ref = reference_cells[f"{arch}/{shape}/{multi}"]
    kinds = {"params": "params", "inputs": "inputs", "state": "state",
             "caches": "caches"}
    total = 0
    for kind, group in kinds.items():
        want = ref.get(kind, {})
        got = rec["shapes"][group]
        if kind == "state":
            want = {f"opt.{k}": v for k, v in want.items()}
        assert set(got) == set(want), (kind, set(got) ^ set(want))
        for name, (shape_, dtype, spec) in want.items():
            e = got[name]
            spec = [tuple(s) if isinstance(s, list) else s for s in spec]
            assert e["shape"] == shape_, (kind, name)
            assert e["dtype"] == dtype, (kind, name)
            assert [tuple(s) if isinstance(s, list) else s
                    for s in e["spec"]] == spec, (kind, name)
            counts = [math.prod(axes[a] for a in
                                ((s,) if isinstance(s, str) else s or ()))
                      for s in spec] + [1] * (len(shape_) - len(spec))
            local = [-(-d // c) for d, c in zip(shape_, counts)]
            assert e["local_shape"] == local, (kind, name)
            size = {"float32": 4, "bfloat16": 2, "int32": 4}[dtype]
            assert e["bytes_per_device"] == math.prod(local) * size
            total += e["bytes_per_device"]
    assert rec["bytes_per_device"] == total
    assert rec["flops_error"] is None and rec["flops_global"] > 0
    assert rec["flops_per_device"] == rec["flops_global"] / math.prod(
        axes.values())
    assert rec["flops_basis"] == "global/devices"
    assert rec["collective_bytes_per_device"] is None
    # the record is of the reduced config; model_flops (and with it the
    # useful-compute ratio) reads the arch's published one, so only the
    # terms taken from the record are held here
    t = roofline.roofline_terms(rec)
    assert t["status"] == "ok" and t["t_collective_s"] is None
    assert t["t_compute_s"] == rec["flops_per_device"] / lmesh.PEAK_BF16_FLOPS
    assert t["t_memory_s"] == rec["bytes_per_device"] / lmesh.HBM_BW
    assert t["dominant"] in ("compute", "memory")


def test_dryrun_skips_long_context_for_attention_models(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "glm4-9b", "--shape", "long_500k", "--out", str(tmp_path)], env=ENV, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads((tmp_path / "glm4-9b__long_500k__single.json")
                     .read_text())
    assert rec["status"] == "skipped"
    assert "glm4-9b" in roofline.format_table(str(tmp_path))
