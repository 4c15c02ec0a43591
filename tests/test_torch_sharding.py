"""The port's sharding plan (`repro_torch.sharding.rules`) against the JAX
package's `make_plan`: every flag, every parameter leaf's spec and the
batch, activation and cache specs, for every architecture on the single-
and multi-pod production meshes; the port's per-layer parameter names
through `param_names`; and, in a subprocess on a fake 16 x 16
``DeviceMesh``, the local shard shapes of a reduced model's DTensors
against the shapes the reference's specs give.

Specs are compared entry for entry: the port's are tuples with the shape
of the reference's ``PartitionSpec``."""

import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import SHAPES as RSHAPES
from repro.configs import get_config as rget_config
from repro.sharding import rules as rrules
from repro.train.steps import StepConfig as RStepConfig
from repro.train.steps import init_train_state as rinit_train_state
from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes, \
    get_config
from repro_torch.models import transformer
from repro_torch.sharding import rules

ROOT = Path(__file__).resolve().parents[1]
MESH_SHAPES = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
}
FLAGS = ("data_axes", "model_axis", "shard_seq", "attn_tp", "kv_tp",
         "moe_ep")
ACTS = ("hidden", "logits", "ffn_hidden", "attn_q", "attn_out",
        "moe_expert_in", "moe_expert_out", "ssm_x", "unknown")
CACHES = ("kv", "kv_len", "ssm_h", "ssm_conv", "unknown")


class FakeMesh:
    """The reference test's duck-typed mesh: ``axis_names`` and a
    ``shape`` dict."""
    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.devices = np.empty(tuple(shape.values()), dtype=object)


class FakeDeviceMesh:
    """A ``DeviceMesh``'s face without a process group: ``mesh_dim_names``
    and a ``shape`` tuple."""
    def __init__(self, shape: dict):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_REF_LEAVES: dict = {}


def _ref_leaves(arch_id):
    """{key path: leaf} of the reference's whole train state, abstractly."""
    if arch_id not in _REF_LEAVES:
        cfg = rget_config(arch_id)
        shapes = jax.eval_shape(
            lambda k: rinit_train_state(k, cfg, RStepConfig()),
            jax.random.PRNGKey(0))
        out = {}

        def visit(path, leaf):
            out[tuple(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path)] = leaf
            return leaf
        jax.tree_util.tree_map_with_path(visit, shapes)
        _REF_LEAVES[arch_id] = out
    return _REF_LEAVES[arch_id]


def _local_shape(shape, spec, axes: dict):
    """The largest shard's shape under ``spec``: each dimension in
    ceil-sized chunks over the product of its axes (a DTensor's split)."""
    counts = [math.prod(axes[a] for a in rules.spec_axes(e)) for e in spec]
    counts += [1] * (len(shape) - len(spec))
    return tuple(-(-int(d) // c) for d, c in zip(shape, counts))


def _cells(arch_id):
    return [name for name, spec in applicable_shapes(get_config(arch_id))
            .items() if spec is not None]


@pytest.mark.parametrize("mesh_name", list(MESH_SHAPES))
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_plan_matches_reference(arch_id, mesh_name):
    """Flags, every leaf's spec, and the batch, activation and cache
    specs, for every applicable shape; on both faces of a mesh."""
    shape = MESH_SHAPES[mesh_name]
    leaves = _ref_leaves(arch_id)
    assert len(leaves) > 10
    for cell in _cells(arch_id):
        ref = rrules.make_plan(FakeMesh(shape), rget_config(arch_id),
                               RSHAPES[cell])
        for mesh in (FakeDeviceMesh(shape), FakeMesh(shape)):
            plan = rules.make_plan(mesh, get_config(arch_id), SHAPES[cell])
            for flag in FLAGS:
                assert getattr(plan, flag) == getattr(ref, flag), \
                    (cell, flag)
            assert plan.batch_spec() == tuple(ref.batch_spec()), cell
            for name in ACTS:
                assert plan.act_spec(name) == tuple(ref.act_spec(name)), \
                    (cell, name)
            for kind in CACHES:
                assert plan.cache_spec(kind) == \
                    tuple(ref.cache_spec(kind)), (cell, kind)
            if cell == _cells(arch_id)[0]:
                for path, leaf in leaves.items():
                    assert plan.param_spec(path, leaf) == \
                        tuple(ref.param_spec(path, leaf)), path


@pytest.mark.parametrize("mesh_name", list(MESH_SHAPES))
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_port_parameter_names_take_the_reference_leaf_spec(arch_id,
                                                           mesh_name):
    """Every parameter of the port's model (built on the meta device) has
    a leaf in the reference's tree, of the rank `param_names` says, and
    its spec is that leaf's with the stacked layer axis dropped."""
    shape = MESH_SHAPES[mesh_name]
    leaves = _ref_leaves(arch_id)
    params = {p[1:]: leaf for p, leaf in leaves.items() if p[0] == ".params"
              or p[0] == "params"}
    assert params
    cfg = get_config(arch_id)
    plan = rules.make_plan(FakeDeviceMesh(shape), cfg, SHAPES["train_4k"])
    ref = rrules.make_plan(FakeMesh(shape), rget_config(arch_id),
                           RSHAPES["train_4k"])
    model = transformer.init_model(cfg, None, device="meta")
    seen = set()
    for name, p in model.named_parameters():
        path = tuple(rules.reference_leaf(name).split("."))
        leaf = params[path]
        assert leaf.ndim == rules.reference_ndim(name, p), name
        want = tuple(ref.param_spec(path, leaf))
        if path != tuple(name.split(".")) and want:
            assert want[0] is None, name
            want = want[1:]
        assert plan.param_spec_for(name, p) == want, name
        seen.add(path)
    assert seen == set(params)


def test_placements_on_a_fake_mesh():
    mesh = FakeDeviceMesh({"pod": 2, "data": 16, "model": 16})
    from torch.distributed.tensor import Replicate, Shard
    assert rules.placements((("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert rules.placements((), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError):
        rules.placements((("model", "data"),), mesh)
    with pytest.raises(ValueError):
        rules.placements(("data", "data"), mesh)


def test_shard_fn_passes_plain_tensors_and_raises_on_dtensors():
    """On a plain tensor ``shard_fn`` is a no-op; on a DTensor it
    redistributes, and a spec the tensor cannot take raises where the
    reference's would swallow the error (one process, gloo, world 1)."""
    code = textwrap.dedent("""
        import torch, torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Replicate, Shard, \\
            distribute_tensor
        from repro_torch.configs import SHAPES, get_config
        from repro_torch.sharding import rules
        dist.init_process_group("gloo", init_method="tcp://localhost:0",
                                rank=0, world_size=1)
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        plan = rules.make_plan(mesh, get_config("glm4-9b").reduced(),
                               SHAPES["decode_32k"])
        fn = plan.shard_fn()
        x = torch.randn(4, 3, 8)
        assert fn("hidden", x) is x
        d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        y = fn("logits", d)
        assert list(y.placements) == [Shard(0), Shard(2)], y.placements
        assert torch.equal(y.full_tensor(), x)
        try:
            fn("attn_q", d)       # a 4-entry spec on a 3-dim tensor
        except ValueError as e:
            print("RAISED", e)
        dist.destroy_process_group()
        """)
    res = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "RAISED" in res.stdout


def test_dtensor_local_shapes_on_a_fake_16x16_mesh():
    """A reduced glm4-9b and qwen2-moe-a2.7b distributed as DTensors on a
    fake 16 x 16 ``DeviceMesh`` (the ``fake`` process group at world 256,
    rank 0, meta tensors): every parameter's local shard shape equals the
    largest shard the reference's spec gives its leaf, one layer of it."""
    code = textwrap.dedent("""
        import json, torch, torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.configs import SHAPES, get_config
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.models import transformer
        from repro_torch.sharding import rules
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=256)
        mesh = make_production_mesh(device_type="cpu")
        out = {}
        for arch in ("glm4-9b", "qwen2-moe-a2.7b"):
            cfg = get_config(arch).reduced()
            plan = rules.make_plan(mesh, cfg, SHAPES["train_4k"])
            model = transformer.init_model(cfg, None, device="meta")
            out[arch] = {n: list(t.to_local().shape) for n, t in
                         rules.distribute_params(model, plan, mesh).items()}
        print(json.dumps(out))
        dist.destroy_process_group()
        """)
    res = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    import json
    got = json.loads(res.stdout.strip().splitlines()[-1])
    mesh = MESH_SHAPES["single"]
    for arch, local in got.items():
        rcfg = rget_config(arch).reduced()
        ref = rrules.make_plan(FakeMesh(mesh), rcfg, RSHAPES["train_4k"])
        shapes = jax.eval_shape(
            lambda k: rinit_train_state(k, rcfg, RStepConfig()).params,
            jax.random.PRNGKey(0))
        leaves = {}
        jax.tree_util.tree_map_with_path(
            lambda p, l: leaves.__setitem__(
                tuple(str(getattr(q, "key", getattr(q, "idx", q)))
                      for q in p), l), shapes)
        assert len(local) >= len(leaves)
        for name, shape in local.items():
            path = tuple(rules.reference_leaf(name).split("."))
            leaf = leaves[path]
            spec = tuple(ref.param_spec(path, leaf))
            want = list(_local_shape(leaf.shape, spec, mesh))
            if path != tuple(name.split(".")):
                assert want[0] == leaf.shape[0]     # the layer axis whole
                want = want[1:]
            assert shape == want, (arch, name, shape, want, spec)
