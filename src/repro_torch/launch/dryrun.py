"""Dry run of one (arch x shape x mesh) cell on the production mesh: the
shapes and per-device bytes of every input, parameter and state or cache
under the sharding plan, and the step's flops. Nothing is allocated and
no device is touched:

  * the mesh is `launch.mesh.make_production_mesh` laid over the
    ``"fake"`` process group at world size 256 (512 with
    ``--multi-pod``), this process standing for rank 0;
  * the model, its state and caches are built on ``torch.device("meta")``
    and distributed as DTensors with the plan's placements
    (`sharding.rules`), so each local shape is the largest shard's;
  * flops are counted by ``torch.utils.flop_counter.FlopCounterMode`` over
    the step on meta tensors, at 1 and 2 layer units, and extrapolated to
    the full depth with the reference's clamp. An op without a meta
    kernel makes them null, the op named in ``flops_error``; any other
    error fails the cell.

What the record holds that the reference's does not, and why:

  * ``flops_basis: "global/devices"``: no partitioned program is lowered,
    so ``flops_per_device`` is the global count over the mesh size, and
    only the ops FlopCounterMode knows are counted (matmuls, convolutions,
    attention), not elementwise work;
  * ``collective_bytes_per_device``, by kind (all-gather, all-reduce,
    reduce-scatter, all-to-all), is what one step issues with the plan
    inside the forward (``shard_fn``), the parameters, state, inputs and
    caches laid as ``DTensor``s on the fake mesh: the result bytes of
    every functional collective DTensor dispatches (`CollectiveBytes`),
    as the reference sums the result shapes of its HLO's collectives,
    counted at 1 and 2 layer units and extrapolated with the same clamp
    as the flops; beside them ``collective_link_bytes_per_device``, the
    bytes a device receives over its links for them in a ring (an
    all-gather's result less its own shard, a reduce-scatter's input
    less its own, twice that for an all-reduce). On a mesh of host ranks
    DTensor moves a shard from one
    dimension to another by an all-gather and a slice (gloo has no
    all-to-all); the count books that move as the all-to-all a card mesh
    issues, with its output's bytes. Where the
    step cannot run on the fake mesh the bytes are null and
    ``collective_reason`` names the op, as ``flops_error`` does;
  * ``bytes_per_device`` is the step's inputs, parameters, state and
    caches, each read or written once (``bytes_basis``): a lower bound on
    the memory term;
  * the step's memory per device is counted in the same pass as the
    collectives, on each rank's local shards (`StepMemory`), at 1 and 2
    layer units and extrapolated with the same clamp:
    ``bytes_accessed_per_device`` sums every op's operands and results,
    once per op, with no fusion (``bytes_accessed_basis``; an upper bound
    where XLA's count is of a fused program); ``memory.peak_bytes`` is
    the largest sum of live storages during the step, arguments,
    autograd's saved tensors and the collectives' results included, and
    ``memory.temp_bytes_per_device`` that peak less the arguments (the
    step's outputs among the temporaries). ``memory.temp_bytes`` is the
    reference's convention, summed over the mesh. Where the pass cannot
    run they are null, ``memory_reason`` naming the op;

Overrides take the reference's meaning: ``cfg_transform`` maps the config
before the 1- and 2-unit configs are cut, and ``step_overrides`` update the
``StepConfig`` of every step built.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
        --shape decode_32k --out DIR

Run each cell in its own process: the fake process group is process-wide.
A record is written to ``DIR/<arch>__<shape>__<single|multi>.json`` and
nowhere else.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes, \
    get_config
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.param_names import reference_leaf
from repro_torch.sharding import rules
from repro_torch.sharding.rules import sanitize

META = torch.device("meta")
BYTES_BASIS = ("inputs, parameters, optimizer state and caches per device, "
               "each read or written once; temporaries in "
               "memory.temp_bytes_per_device")
BYTES_ACCESSED_BASIS = ("every op's local operands and results per device, "
                        "once per op, no fusion (views excluded): an upper "
                        "bound on a fused program's bytes accessed")


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                dtype=torch.bfloat16) -> dict:
    """Meta stand-ins for every model input (the reference's
    ``input_specs``)."""
    b = shape.global_batch
    l = 1 if shape.is_decode else shape.seq_len
    specs = {"tokens": torch.empty((b, l), dtype=torch.int32, device=META)}
    if shape.kind == "train":
        specs["labels"] = torch.empty((b, l), dtype=torch.int32, device=META)
    if cfg.modality in ("audio", "vision") and not shape.is_decode:
        specs["frontend"] = torch.empty((b, cfg.frontend_seq, cfg.d_model),
                                        dtype=dtype, device=META)
    return specs


def _entry(t: torch.Tensor, spec: tuple, mesh, layers: int = 1) -> dict:
    """One tensor's record: its global shape (``layers`` stacked in front
    when > 1, as the reference's tree holds it), dtype, spec, the local
    shape of its DTensor on ``mesh`` and the bytes of that shard."""
    from torch.distributed.tensor import distribute_tensor
    local = list(distribute_tensor(t, mesh, rules.placements(spec, mesh))
                 .to_local().shape)
    shape = list(t.shape)
    if layers > 1:
        shape, local = [layers] + shape, [layers] + local
    return {"shape": shape, "dtype": str(t.dtype).replace("torch.", ""),
            "spec": list(spec), "local_shape": local,
            "bytes_per_device": math.prod(local) * t.element_size()}


def param_entries(named, plan, mesh) -> dict:
    """One entry per leaf of the reference's parameter tree, from the
    port's (name, tensor) pairs (parameters, or an optimizer moment by
    its parameter's name): the per-layer tensors of a stack are one leaf
    with a leading layer axis, whose spec is the reference's (that axis
    never sharded)."""
    groups: dict[str, list] = {}
    for name, p in named:
        groups.setdefault(reference_leaf(name), []).append((name, p))
    out = {}
    for leaf, members in groups.items():
        name, p = members[0]
        spec = plan.param_spec_for(name, p)
        e = _entry(p, spec, mesh, layers=len(members)
                   if leaf != name else 1)
        e["spec"] = list(plan.param_spec(tuple(leaf.split(".")),
                                         p.ndim + (leaf != name)))
        out[leaf] = e
    return out


def _leaves(tree, prefix: str = ""):
    """(name, tensor) of a cache tree: NamedTuple fields by name, tuple
    items by index, None skipped."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    fields = getattr(tree, "_fields", None)
    keys = fields if fields is not None else range(len(tree))
    for k, sub in zip(keys, tree):
        yield from _leaves(sub, f"{prefix}.{k}" if prefix else str(k))


def _cache_spec(t: torch.Tensor, plan, mesh) -> tuple:
    nd = t.ndim
    ssm = t.dtype == torch.float32 and t.shape[-1] != 1
    kind = {5: "ssm_h" if ssm else "kv", 4: "ssm_conv",
            2: "kv_len"}.get(nd)
    if kind is not None:
        return sanitize(plan.cache_spec(kind)[:nd], t.shape, mesh)
    return plan.batch_spec() if nd == 3 else ()


def cache_entries(caches, plan, mesh) -> dict:
    """The reference's cache shardings (``_cache_shardings``): by rank and
    dtype, a 5-d float32 tensor is an SSM state, another 5-d one a KV
    cache, 4-d an SSM conv state, 2-d the KV lengths, 3-d (the encoder's
    memory) the batch spec as it is, anything else replicated; a cache
    spec is cut to the tensor's rank and sanitized. One departure: the
    scales of an int8 KV cache (``attention.KV_QUANT``; float32,
    (layers, B, S, KV, 1)) are laid as the cache they scale, where the
    reference's rule takes them for an SSM state and keeps a whole
    sequence on every device, which can cost more than the int8 cache
    saves."""
    return {name: _entry(t, _cache_spec(t, plan, mesh), mesh)
            for name, t in _leaves(caches)}


STEP_CFG = dict(remat=True, microbatches=1)


def _step_config(step_overrides: dict | None):
    from repro_torch.train import steps
    return steps.StepConfig(**{**STEP_CFG, **(step_overrides or {})})


def _step_flops(cfg: ModelConfig, shape: ShapeSpec,
                step_overrides: dict | None = None) -> float:
    """Global flops of one step of ``cfg`` on meta tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import transformer
    from repro_torch.train import optimizer, steps

    step_cfg = _step_config(step_overrides)
    model = transformer.init_model(cfg, None, torch.float32, META)
    batch = input_specs(cfg, shape)
    with FlopCounterMode(display=False) as counter:
        if shape.kind == "train":
            params = dict(model.named_parameters())
            state = steps.TrainState(params=model,
                                     opt=optimizer.init_adamw(params),
                                     residuals=None, rng=0)
            steps.make_train_step(cfg, optimizer.OptimizerConfig(),
                                  step_cfg)(state, batch)
        elif shape.kind == "prefill":
            steps.make_prefill_step(cfg, step_cfg)(model, batch)
        else:
            caches = steps.init_caches(cfg, shape.global_batch,
                                       shape.seq_len, device=META)
            steps.make_decode_step(cfg, step_cfg)(model, batch, caches)
    return float(counter.get_total_flops())


#: The functional collectives DTensor dispatches, by the reference's
#: names of their kinds.
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all"}


#: The bytes each device receives over its links in a ring collective
#: of n ranks, per byte of its result.
LINK_SHARE = {"all-gather": lambda n: (n - 1) / n,
              "all-to-all": lambda n: (n - 1) / n,
              "reduce-scatter": lambda n: n - 1,
              "all-reduce": lambda n: 2 * (n - 1) / n}


def _group_size(func, args, kwargs) -> int:
    """The ranks of a functional collective's group, from its arguments."""
    bound = dict(zip((a.name for a in func._schema.arguments), args))
    bound.update(kwargs or {})
    if "group_size" in bound:
        return int(bound["group_size"])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(bound["group_name"]).size()


class CollectiveBytes(TorchDispatchMode):
    """Sums, by kind (`COLLECTIVE_KINDS`) and per device, the result
    bytes of every collective dispatched under it (``bytes``: the local
    tensors DTensor hands its collectives, the reference's measure) and
    the bytes a device receives over its links for them in a ring
    (``link_bytes``, `LINK_SHARE`). A ``DTensor`` op is let through
    first (``NotImplemented``), as ``CommDebugMode`` does, so that the
    mode sees the collectives it desugars into."""

    def __init__(self):
        super().__init__()
        self.bytes: dict[str, float] = {}
        self.link_bytes: dict[str, float] = {}
        self._inside = 0

    def add(self, kind: str, out, ranks: int) -> None:
        if self._inside:
            return
        n = float(sum(t.numel() * t.element_size()
                      for t in torch.utils._pytree.tree_leaves(out)
                      if isinstance(t, torch.Tensor)))
        self.bytes[kind] = self.bytes.get(kind, 0.0) + n
        self.link_bytes[kind] = self.link_bytes.get(kind, 0.0) + \
            n * LINK_SHARE[kind](ranks)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        ns, _, name = func._schema.name.partition("::")
        if ns in ("_c10d_functional", "_dtensor") and \
                name in COLLECTIVE_KINDS:
            self.add(COLLECTIVE_KINDS[name], out,
                     _group_size(func, args, kwargs))
        return out

    @contextlib.contextmanager
    def host_all_to_all(self):
        """On a mesh of host ranks DTensor's shard-to-shard move is an
        all-gather and a slice: counted here as the all-to-all that a
        card mesh issues (its output's bytes), the all-gather inside it
        not counted."""
        from torch.distributed.tensor import placement_types
        orig = placement_types.shard_dim_alltoall

        def counted(input, gather_dim, shard_dim, mesh, mesh_dim):
            self._inside += 1
            try:
                out = orig(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                self._inside -= 1
            self.add("all-to-all", out, mesh.size(mesh_dim))
            return out

        placement_types.shard_dim_alltoall = counted
        try:
            yield
        finally:
            placement_types.shard_dim_alltoall = orig


def _is_view(func) -> bool:
    """An op whose every result aliases an input without writing it (a
    view): it moves no bytes."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and
                              not r.alias_info.is_write for r in rets)


class StepMemory(TorchDispatchMode):
    """The memory of the plain (local) tensors' ops dispatched under it:
    ``accessed``, every op's tensor operands and results, each once per
    op, views excluded; ``live``, the bytes of the storages alive now,
    counted once however many views share them and freed when the last
    goes (weak references on the storages); ``peak``, the largest
    ``live`` seen. Storages made before the mode count from `hold`. A
    ``DTensor`` op is let through first, as in `CollectiveBytes`, so that
    the mode sees its local ops; DTensor's shape propagation on fake
    tensors is not counted."""

    def __init__(self):
        super().__init__()
        self.accessed = 0.0
        self.live = 0
        self.peak = 0
        self._refs: dict[int, weakref.ref] = {}

    def _freed(self, key: int, n: int) -> None:
        self.live -= n
        self._refs.pop(key, None)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        n = st.nbytes()
        self._refs[key] = weakref.ref(
            st, lambda _, key=key, n=n: self._freed(key, n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def hold(self, tree) -> int:
        """Counts the storages of ``tree``'s tensors (a module's parameters
        and buffers; a ``DTensor``'s local shard) as live; returns the
        bytes live after."""
        from torch.distributed.tensor import DTensor
        for t in torch.utils._pytree.tree_leaves(tree):
            if isinstance(t, torch.nn.Module):
                self.hold([*t.parameters(), *t.buffers()])
                continue
            if isinstance(t, DTensor):
                t = t._local_tensor
            if isinstance(t, torch.Tensor):
                self._track(t)
        return self.live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        outs = [t for t in torch.utils._pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in outs) or \
                any(issubclass(t, FakeTensor) for t in types):
            return out
        if not _is_view(func):
            seen = set()
            for t in torch.utils._pytree.tree_leaves((args, kwargs, outs)):
                if isinstance(t, torch.Tensor) and id(t) not in seen:
                    seen.add(id(t))
                    self.accessed += t.numel() * t.element_size()
        for t in outs:
            self._track(t)
        return out


def _step_collectives(cfg: ModelConfig, shape: ShapeSpec, mesh,
                      step_overrides: dict | None = None
                      ) -> tuple[dict, dict, dict]:
    """(result bytes, link bytes) per device, by kind, of the collectives
    one step of ``cfg`` issues on ``mesh`` with the plan inside the
    forward (`CollectiveBytes`), and the step's memory per device
    (`StepMemory`: ``accessed``, ``peak``, and ``arguments``, the bytes of
    its arguments): the parameters, AdamW moments, inputs (rank >= 2 on
    the sanitized batch spec) and the decode step's caches
    (`cache_entries`' specs) as ``DTensor``s on meta tensors."""
    from repro_torch.models import transformer
    from repro_torch.sharding.state import map_state, place
    from repro_torch.train import optimizer, steps

    plan = rules.make_plan(mesh, cfg, shape)
    step_cfg = _step_config(step_overrides)
    model = map_state(
        transformer.init_model(cfg, None, torch.float32, META),
        lambda n, p: place(p, mesh, plan.param_spec_for(n, p)))
    batch = {k: place(v, mesh, sanitize(plan.batch_spec(), v.shape, mesh)
                      if v.ndim >= 2 else ())
             for k, v in input_specs(cfg, shape).items()}
    if shape.kind == "train":
        params = dict(model.named_parameters())
        args = (steps.TrainState(params=model,
                                 opt=optimizer.init_adamw(params),
                                 residuals=None, rng=0), batch)
        step = steps.make_train_step(cfg, optimizer.OptimizerConfig(),
                                     step_cfg, plan.shard_fn())
    elif shape.kind == "prefill":
        args = (model, batch)
        step = steps.make_prefill_step(cfg, step_cfg, plan.shard_fn())
    else:
        caches = map_state(
            steps.init_caches(cfg, shape.global_batch, shape.seq_len,
                              device=META),
            lambda n, t: place(t, mesh, _cache_spec(t, plan, mesh)))
        args = (model, batch, caches)
        step = steps.make_decode_step(cfg, step_cfg, plan.shard_fn())
    counter, memory = CollectiveBytes(), StepMemory()
    held = memory.hold(args)
    with counter, counter.host_all_to_all(), memory:
        step(*args)
    return counter.bytes, counter.link_bytes, {
        "accessed": memory.accessed, "peak": memory.peak,
        "arguments": held}


def _op_error(e: BaseException) -> str:
    frame = traceback.extract_tb(e.__traceback__)[-1]
    return (f"{type(e).__name__} at {frame.name} "
            f"({os.path.basename(frame.filename)}:{frame.lineno}): "
            f"{e}")[:500]


def lower_cell(arch_id: str, shape_name: str, *, multi_pod: bool, mesh,
               cfg: ModelConfig | None = None,
               step_overrides: dict | None = None,
               cfg_transform=None) -> dict:
    """The record of one cell on ``mesh`` (the production mesh): of
    ``cfg`` (the arch's published config by default) mapped by
    ``cfg_transform``, with ``step_overrides`` on every step's
    ``StepConfig``."""
    t0 = time.monotonic()
    cfg = cfg or get_config(arch_id)
    if cfg_transform is not None:
        cfg = cfg_transform(cfg)
    shape = SHAPES[shape_name]
    if applicable_shapes(cfg)[shape_name] is None:
        return {"arch": arch_id, "shape": shape_name,
                "multi_pod": multi_pod, "status": "skipped",
                "reason": "quadratic attention at 512k seq "
                          "(assignment rule)"}
    from repro_torch.models import transformer
    from repro_torch.train import optimizer, steps

    plan = rules.make_plan(mesh, cfg, shape)
    n_dev = math.prod(rules.mesh_axes(mesh).values())

    # cost slope from two small exact counts, as the reference's
    unit = cfg.attn_every if cfg.family == "hybrid" else 1
    if cfg.family == "encdec":
        c1 = dataclasses.replace(cfg, encoder_layers=1, n_layers=1)
        c2 = dataclasses.replace(cfg, encoder_layers=2, n_layers=2)
        n_units = float(cfg.n_layers)   # enc and dec depths are equal (24)
    else:
        c1 = dataclasses.replace(cfg, n_layers=unit)
        c2 = dataclasses.replace(cfg, n_layers=2 * unit)
        n_units = cfg.n_layers / unit
    def extrap(a, b):
        # clamp: one-time (depth-independent) costs can make b < a;
        # never extrapolate below the measured floor
        return max(a + (n_units - 1.0) * (b - a), min(a, b), 0.0)

    flops = f1 = f2 = flops_error = None
    t_flops = time.monotonic()
    try:
        f1 = _step_flops(c1, shape, step_overrides)
        f2 = _step_flops(c2, shape, step_overrides)
        flops = extrap(f1, f2)
    except NotImplementedError as e:        # an op with no meta kernel
        flops_error = _op_error(e)
    t_flops = time.monotonic() - t_flops

    coll = link = coll1 = coll2 = coll_error = mem1 = mem2 = None
    accessed = peak = temp = None
    t_coll = time.monotonic()
    try:
        (coll1, link1, mem1), (coll2, link2, mem2) = (
            _step_collectives(c, shape, mesh, step_overrides)
            for c in (c1, c2))
        coll, link = ({k: extrap(a.get(k, 0.0), b.get(k, 0.0))
                       for k in sorted(set(a) | set(b))}
                      for a, b in ((coll1, coll2), (link1, link2)))
        accessed = extrap(mem1["accessed"], mem2["accessed"])
        peak = extrap(mem1["peak"], mem2["peak"])
        temp = extrap(mem1["peak"] - mem1["arguments"],
                      mem2["peak"] - mem2["arguments"])
    except NotImplementedError as e:
        # an op without a meta kernel or a DTensor sharding strategy
        coll_error = _op_error(e)
    t_coll = time.monotonic() - t_coll

    model = transformer.init_model(cfg, None, torch.float32, META)
    # the decode step's input caches; the prefill's are its output
    caches = None
    if shape.is_decode:
        caches = steps.init_caches(cfg, shape.global_batch, shape.seq_len,
                                   device=META)
    elif shape.kind == "prefill" and flops_error is None:
        _, caches = steps.make_prefill_step(cfg, _step_config(
            step_overrides))(model, input_specs(cfg, shape))
    params = param_entries(model.named_parameters(), plan, mesh)
    inputs = {k: _entry(v, sanitize(plan.batch_spec(), v.shape, mesh)
                        if v.ndim >= 2 else (), mesh)
              for k, v in input_specs(cfg, shape).items()}
    state = {}
    if shape.kind == "train":
        opt = optimizer.init_adamw(dict(model.named_parameters()))
        for moment in ("m", "v"):
            for leaf, e in param_entries(getattr(opt, moment).items(), plan,
                                         mesh).items():
                state[f"opt.{moment}.{leaf}"] = e
        state["opt.step"] = _entry(opt.step, (), mesh)
    cache = cache_entries(caches, plan, mesh) if caches is not None else {}
    by_kind = {kind: sum(e["bytes_per_device"] for e in group.values())
               for kind, group in (("inputs", inputs), ("params", params),
                                   ("state", state), ("caches", cache))}
    argument = by_kind["inputs"] + by_kind["params"] + by_kind["state"] + \
        (by_kind["caches"] if shape.is_decode else 0)
    return {
        "arch": arch_id,
        "shape": shape_name,
        "multi_pod": multi_pod,
        "status": "ok",
        "mesh": rules.mesh_axes(mesh),
        "flops_per_device": None if flops is None else flops / n_dev,
        "flops_basis": "global/devices",
        "flops_global": flops,
        "flops_error": flops_error,
        "bytes_per_device": sum(by_kind.values()),
        "bytes_basis": BYTES_BASIS,
        "bytes_per_device_by_kind": by_kind,
        "bytes_accessed_per_device": accessed,
        "bytes_accessed_basis": BYTES_ACCESSED_BASIS,
        "collective_bytes_per_device": coll,
        "collective_link_bytes_per_device": link,
        **({"collective_reason": coll_error} if coll is None else {}),
        "flops_rolled_module": None,
        "memory": {"argument_bytes": argument,
                   "output_bytes": 0 if shape.is_decode
                   else by_kind["caches"],
                   "temp_bytes": None if temp is None else temp * n_dev,
                   "temp_bytes_per_device": temp, "peak_bytes": peak},
        **({"memory_reason": coll_error} if peak is None else {}),
        "seconds": round(time.monotonic() - t0, 1),
        "seconds_counting_flops": round(t_flops, 1),
        "seconds_counting_collectives": round(t_coll, 1),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "cost_extrapolation": {"unit_layers": unit, "n_units": n_units,
                               "f1": f1, "f2": f2, "coll1": coll1,
                               "coll2": coll2, "mem1": mem1, "mem2": mem2},
        "shapes": {"inputs": inputs, "params": params, "state": state,
                   "caches": cache},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Dry run of one (arch x shape x mesh) cell on the fake "
                    "process group: per-device shapes and bytes under the "
                    "sharding plan, and the step's flops.")
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (pod=2, data=16, model=16) mesh of 512 ranks")
    ap.add_argument("--out", required=True,
                    help="directory for the JSON record")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh

    world = 512 if args.multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    tag = f"{args.arch}__{args.shape}__" \
          f"{'multi' if args.multi_pod else 'single'}"
    try:
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device_type="cpu")
        rec = lower_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                         mesh=mesh)
    except Exception as e:                  # the record says what failed
        rec = {"arch": args.arch, "shape": args.shape,
               "multi_pod": args.multi_pod, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
    finally:
        dist.destroy_process_group()
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, tag + ".json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[dryrun] {tag}: {rec['status']} ({rec.get('seconds', '-')} s) "
          f"-> {path}", flush=True)
    return 0 if rec["status"] in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
