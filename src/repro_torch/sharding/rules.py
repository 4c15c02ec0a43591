"""Sharding rules: logical-axis -> mesh-axis resolution with divisibility
fallbacks, resolved per architecture when the mesh is built; and the CIM
mesh's shard choices under the same divisibility discipline.

Mesh axes:
  pod    (multi-pod only) — outermost data-parallel hop
  data   — FSDP: parameters / optimizer state sharded, gathered per layer;
           batch (and long-sequence) dimension of activations
  model  — TP: attention heads / FFN hidden / vocab; EP: MoE experts

Strategy per tensor class (the reference's, unchanged):
  * dense kernels (d_in, d_out): ("data", "model") — FSDP x TP
  * attention projections: TP over heads when divisible, else fully-FSDP
    ((("data", "model"), None)) with replicated attention compute
  * MoE experts (E, d, f): EP ("model", "data", None) when E % model == 0,
    else TP inside experts (None, "data", "model")
  * embeddings (V, d): ("model", "data") — vocab-sharded
  * activations (B, L, D): (("pod", "data"), None, None); batch=1
    long-context shards the sequence axis instead

A spec is a tuple with the shape of the reference's ``PartitionSpec``: one
entry per tensor dimension (trailing ones may be left out), each ``None``,
an axis name or a tuple of axis names, so the two compare entry for entry.
`placements` turns one into DTensor placements on a ``DeviceMesh``.

``mesh`` is anything with named axes and a size per axis: a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names``,
``shape``) or a duck-typed mesh with ``axis_names`` and a ``shape`` dict,
as the reference's tests build. Building a plan touches no device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import layers
from repro_torch.param_names import reference_leaf, reference_ndim

Spec = tuple


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a duck-typed mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    shape = mesh.shape
    if isinstance(shape, dict):
        return {a: int(shape[a]) for a in mesh.axis_names}
    return dict(zip(mesh.axis_names, (int(s) for s in shape)))


@dataclasses.dataclass
class ShardingPlan:
    mesh: Any
    cfg: ModelConfig
    shape: ShapeSpec
    data_axes: tuple[str, ...]      # ("pod","data") or ("data",)
    model_axis: str
    shard_seq: bool                 # batch too small -> shard sequence
    attn_tp: bool                   # heads divisible by model axis
    kv_tp: bool                     # kv heads divisible
    moe_ep: bool

    # ---- parameter specs ---------------------------------------------------
    def param_spec(self, path: tuple[str, ...], leaf: Any) -> Spec:
        """Spec for one leaf of the reference's parameter tree, by its key
        path. Layer-stacked subtrees (scan-over-layers: 'blocks',
        'enc_blocks', 'tail') carry a leading layer axis that is never
        sharded — the logical rule applies to the remaining dims.
        ``leaf`` is the leaf or its rank."""
        name = "/".join(str(p) for p in path)
        nd = leaf if isinstance(leaf, int) else getattr(leaf, "ndim", 0)
        model = self.model_axis
        data = "data"
        stacked = any(seg in name for seg in ("blocks", "tail/"))
        if "tail" in name.split("/"):
            stacked = True
        if "shared_attn" in name:
            stacked = False
        end = nd - (1 if stacked else 0)   # effective (logical) rank

        def wrap(*spec_dims):
            return (None, *spec_dims) if stacked else tuple(spec_dims)

        if end <= 1:
            return ()
        # embeddings
        if "embed" in name and "table" in name:
            return (model, data)
        # MoE expert banks (E, d_in, d_out)
        if ("experts" in name or "shared/" in name or
                name.endswith("shared")) and end == 3:
            if self.moe_ep and "experts" in name:
                return wrap(model, data, None)
            return wrap(None, data, model)
        if "router" in name:
            return wrap(data, None)
        # attention projections
        if any(k in name for k in ("wq", "wk", "wv")):
            tp_ok = self.attn_tp if "wq" in name else self.kv_tp
            return wrap(data, model) if tp_ok else wrap((data, model), None)
        if "wo" in name:
            return wrap(model, data) if self.attn_tp \
                else wrap((data, model), None)
        # MLP
        if any(k in name for k in ("up", "gate")) and end == 2:
            return wrap(data, model) if self._ff_tp() \
                else wrap((data, model), None)
        if "down" in name and end == 2:
            return wrap(model, data) if self._ff_tp() \
                else wrap((data, model), None)
        # SSM projections
        if "in_proj" in name:
            return wrap(data, None)     # split boundaries misalign with TP
        if "out_proj" in name:
            return wrap(model, data) if self._ssm_tp() \
                else wrap((data, model), None)
        if "conv_w" in name:
            return wrap(None, None)
        if end == 2:
            return wrap(data, None)
        return ()

    def param_spec_for(self, name: str, param: Any) -> Spec:
        """Spec for one of the port's parameters (``blocks.3.attn.wq.w``):
        the spec of its leaf in the reference's tree, with the stacked
        layer axis (never sharded) dropped for a per-layer tensor."""
        leaf = reference_leaf(name)
        spec = self.param_spec(tuple(leaf.split(".")),
                               reference_ndim(name, param))
        if leaf != name and spec:
            if spec[0] is not None:
                raise ValueError(f"{name}: the layer axis of {leaf} is "
                                 f"sharded ({spec})")
            spec = spec[1:]
        return spec

    def _axis(self, name: str) -> int:
        return mesh_axes(self.mesh)[name]

    def _ff_tp(self) -> bool:
        ms = self._axis(self.model_axis)
        ff = self.cfg.moe_d_ff or self.cfg.d_ff
        return ff % ms == 0 if ff else False

    def _ssm_tp(self) -> bool:
        # shard the SSD head dimension (d_inner) across model axis
        ms = self._axis(self.model_axis)
        d_inner = self.cfg.ssm_expand * self.cfg.d_model
        n_heads = d_inner // max(self.cfg.ssm_head_dim, 1)
        return n_heads % ms == 0 if n_heads else False

    # ---- activation / batch specs ------------------------------------------
    @property
    def _data(self):
        """The data axes as one spec entry: a lone axis by its name, as a
        ``PartitionSpec`` normalises a one-axis tuple."""
        return self.data_axes[0] if len(self.data_axes) == 1 \
            else self.data_axes

    def batch_spec(self) -> Spec:
        if self.shard_seq:
            return (None, self._data)
        return (self._data, None)

    def act_spec(self, logical: str) -> Spec:
        data = self._data
        model = self.model_axis
        batch = None if self.shard_seq else data
        seq = data if self.shard_seq else None
        return {
            "hidden": (batch, seq, None),
            "logits": (batch, seq, model),
            "ffn_hidden": (batch, seq, model) if self._ff_tp()
            else (batch, seq, None),
            "attn_q": (batch, seq, model if self.attn_tp else None, None),
            "attn_out": (batch, seq, model if self.attn_tp else None, None),
            "moe_expert_in": (model if self.moe_ep else None, None, None),
            "moe_expert_out": (model if self.moe_ep else None, None, None),
            "ssm_x": (batch, seq, model if self._ssm_tp() else None, None),
        }.get(logical, ())

    def shard_fn(self) -> "PlanShard":
        """The forward's ``shard`` (`models.layers.Shard`) for this plan:
        ``shard(logical, x)`` gives a plain tensor back as it is and
        redistributes a ``DTensor`` to ``act_spec(logical)`` on its own
        mesh, each axis that does not divide its dim dropped
        (`sanitize`: a decode step's length-1 sequence); its methods run
        their steps on each rank's shards. Unlike
        the reference's, which swallows the ``ValueError`` / ``KeyError``
        of a constraint that does not apply, an error here (a spec longer
        than the tensor, an axis the mesh lacks) raises."""
        return PlanShard(self)

    # ---- KV cache / SSM state specs -----------------------------------------
    def cache_spec(self, kind: str) -> Spec:
        data = self._data
        model = self.model_axis
        batch = None if self.shard_seq else data
        seq = data if self.shard_seq else None
        if kind == "kv":           # (layers, B, S, KV, hd)
            if self.kv_tp:
                return (None, batch, seq, model, None)
            # kv heads not divisible: shard the cache's sequence axis on the
            # model axis instead of replicating 16x (HBM capacity!)
            if seq is None:
                return (None, batch, model, None, None)
            return (None, batch, seq, None, None)
        if kind == "kv_len":       # (layers, B)
            return (None, batch)
        if kind == "ssm_h":        # (layers, B, H, P, N)
            return (None, batch, model if self._ssm_tp() else None,
                    None, None)
        if kind == "ssm_conv":     # (layers, B, K-1, conv_dim)
            return (None, batch, None, model if self._ssm_tp() else None)
        return ()


def make_plan(mesh, cfg: ModelConfig, shape: ShapeSpec) -> ShardingPlan:
    axes = mesh_axes(mesh)
    model_axis = "model"
    data_axes = tuple(a for a in ("pod", "data") if a in axes)
    ms = axes[model_axis]
    total_data = math.prod(axes[a] for a in data_axes)
    shard_seq = shape.global_batch < total_data
    attn_tp = cfg.n_heads % ms == 0 if cfg.n_heads else False
    kv_tp = cfg.n_kv_heads % ms == 0 if cfg.n_kv_heads else False
    moe_ep = (cfg.moe_sharding == "ep" or
              (cfg.moe_sharding == "auto" and cfg.n_experts % ms == 0)) \
        and cfg.n_experts > 0 and cfg.n_experts % ms == 0
    return ShardingPlan(mesh=mesh, cfg=cfg, shape=shape,
                        data_axes=data_axes, model_axis=model_axis,
                        shard_seq=shard_seq, attn_tp=attn_tp, kv_tp=kv_tp,
                        moe_ep=moe_ep)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def sanitize(spec: tuple, shape, mesh) -> tuple:
    """Drop mesh axes from any dim they do not evenly divide (decode steps
    have degenerate length-1 axes, batch=1 long-context cells, etc.), as
    the reference's ``_sanitize`` does: the whole entry when it divides,
    else its longest dividing prefix."""
    axes = mesh_axes(mesh)
    dims = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for d, size in zip(dims, shape):
        if d is None:
            out.append(None)
            continue
        names = spec_axes(d)
        keep, n = [], 1
        if size % math.prod(axes[a] for a in names) == 0:
            keep = list(names)
        else:
            for a in names:
                if size % (n * axes[a]) == 0:
                    keep.append(a)
                    n *= axes[a]
                else:
                    break
        out.append(tuple(keep) if len(keep) > 1 else
                   (keep[0] if keep else None))
    return tuple(out)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` in mesh-dimension order: ``Shard(d)``
    on every mesh dimension named by entry d (both for
    ``("data", "model")``), ``Replicate()`` on the others. A tuple entry
    must list its axes in mesh order, which is the order a DTensor shards
    them in; an axis may shard one dimension only."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec entry {entry} is not in mesh order "
                             f"{names}")
        for a in axes:
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"axis {a!r} shards two dimensions of "
                                 f"{spec}")
            out[i] = Shard(d)
    return out


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (a parameter made from one is)."""
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


class _GradBack(torch.autograd.Function):
    """The identity on a ``DTensor``, whose backward hands its gradient on
    in the value's own layout and in contiguous memory, and copies it
    only where it is not so already: a product's backward can leave a
    gradient split otherwise (the MoE's shared experts split tokens 256
    ways, which a batch of 128 cannot take back through a reshape) or
    with a transposed local shard (the attention's, which the product's
    backward then views as a matrix)."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate
        # a partial sum's gradient is whole on every rank
        ctx.layout = (x.device_mesh, tuple(
            Replicate() if p.is_partial() else p for p in x.placements))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        mesh, placements = ctx.layout
        if tuple(grad.placements) != placements:
            grad = grad.redistribute(mesh, placements)
        if grad.to_local().is_contiguous():
            return grad
        return grad.clone(memory_format=torch.contiguous_format)


class PlanShard(layers.Shard):
    """`ShardingPlan.shard_fn`: where a mesh run's forward lays each
    activation, and how its explicit steps run. Every method gives a
    step on plain tensors the default's plain result."""

    def __init__(self, plan: ShardingPlan):
        self.plan = plan

    def __call__(self, logical: str, x):
        if not is_dtensor(x):
            return x
        spec = self.plan.act_spec(logical)
        if len(spec) > x.ndim:
            raise ValueError(f"{logical}: spec {spec} has more entries "
                             f"than the tensor's {x.ndim} dims")
        mesh = x.device_mesh
        return x.redistribute(mesh, placements(
            sanitize(spec, x.shape, mesh), mesh))

    def scope(self, *tensors):
        """``implicit_replication``, so that the plain tensors the model
        makes from shapes (positions, masks, the aux loss's zero: each
        with the global shape) take part as replicated ``DTensor``s on
        the mesh of the operand they meet. With no ``DTensor`` among
        ``tensors``, or inside another such scope (whose exit would
        otherwise switch the outer one off), it does nothing."""
        if any(is_dtensor(t) for t in tensors):
            from torch.distributed.tensor import DTensor
            from torch.distributed.tensor.experimental import \
                implicit_replication
            if not DTensor._op_dispatcher._allow_implicit_replication:
                return implicit_replication()
        return contextlib.nullcontext()

    def rows(self, table, ids):
        """`embedding_rows` of a ``DTensor`` table."""
        return embedding_rows(table, ids) if is_dtensor(table) else \
            table[ids]

    def weight(self, w):
        """A ``DTensor`` weight with the shards of every axis but the
        model axis gathered, FSDP's per-layer all-gather: the product then
        has one layout of least cost, the same on every rank."""
        if not is_dtensor(w):
            return w
        from torch.distributed.tensor import Replicate
        names = w.device_mesh.mesh_dim_names
        return w.redistribute(w.device_mesh, [
            p if names[i] == self.plan.model_axis else Replicate()
            for i, p in enumerate(w.placements)])

    def heads(self, x, n_heads, head_dim):
        """The split into heads of a ``DTensor`` whose last axis the
        product left split over mesh axes that do not divide ``n_heads``
        (a shard need not end on a head's edge, and DTensor cannot split
        such an axis): that axis whole over them first. Its gradient goes
        back to the product as `keep` hands it."""
        if is_dtensor(x):
            from torch.distributed.tensor import Replicate, Shard
            x = self.keep(x)
            last = x.ndim - 1
            split = [i for i, p in enumerate(x.placements)
                     if isinstance(p, Shard) and p.dim == last]
            ways = math.prod(x.device_mesh.size(i) for i in split)
            if n_heads % ways:
                x = x.redistribute(x.device_mesh, [
                    Replicate() if i in split else p
                    for i, p in enumerate(x.placements)])
        return super().heads(x, n_heads, head_dim)

    def keep(self, x):
        """A ``DTensor`` whose gradient comes back on its own layout, in
        contiguous memory (`_GradBack`)."""
        return _GradBack.apply(x) if is_dtensor(x) else x

    def like(self, x, ref):
        if not is_dtensor(ref):
            return x
        from torch.distributed.tensor import Replicate, Shard
        mesh = ref.device_mesh
        if not is_dtensor(x):
            x = replicated(x, mesh)
        return x.redistribute(mesh, [
            p if isinstance(p, Shard) and x.shape[p.dim] == ref.shape[p.dim]
            else Replicate() for p in ref.placements])

    def attend(self, fn, q, k, v, kv_length=None):
        if not is_dtensor(q):
            return fn(q, k, v, kv_length)
        return attention_on_shards(fn, q, k, v, kv_length)

    def on_batch(self, fn, lead, args, batch_axes, out_axes):
        if not is_dtensor(lead):
            return fn(*args)
        return batch_on_shards(fn, lead, args, batch_axes, out_axes)

    def whole(self, fn, *args):
        """``fn`` on every rank on the whole values: each ``DTensor``
        argument gathered (replicated), ``fn`` run on the local tensors,
        each tensor it returns a replicated ``DTensor`` (its gradient the
        whole gradient, the same on every rank)."""
        mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
        if mesh is None:
            return fn(*args)
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils._pytree import tree_map
        rep = [Replicate()] * mesh.ndim
        local = [a.redistribute(mesh, rep).to_local() if is_dtensor(a)
                 else a for a in args]
        return tree_map(
            lambda t: DTensor.from_local(t, mesh, rep, run_check=False)
            if isinstance(t, torch.Tensor) else t, fn(*local))


def embedding_rows(table, ids):
    """``table[ids]`` for a ``DTensor`` table laid out as the plan lays
    an embedding, ``("model", "data")``, and ids on the batch spec.

    Looked up as it stands, the rows would inherit the table's ``data``
    shards on the feature axis and the ids' on the batch axis: one mesh
    axis on two dimensions, which a DTensor cannot hold (the reference's
    ``DuplicateSpecError``, ROADMAP Queue C fault 7). So the table's
    ``data`` shards (every mesh axis that shards its feature axis) are
    gathered first, FSDP's per-layer all-gather, and the rows are looked
    up on the vocab-sharded table (``local_map``): each rank indexes its
    vocab slice with its own ids and zeros the rows outside the slice, a
    partial sum over ``model`` that the last step reduces (an
    all-reduce) onto the ids' own layout with a trailing replicated
    feature axis: ``act_spec("hidden")``. On one rank this is the plain
    ``table[ids]``, forward and backward, bit for bit."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    table = table.redistribute(mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == 1 else p
        for p in table.placements])
    if not is_dtensor(ids):
        ids = replicated(ids, mesh)
    vocab = [i for i, p in enumerate(table.placements)
             if isinstance(p, Shard) and p.dim == 0]
    if len(vocab) > 1:
        raise ValueError(f"the table's vocab axis is sharded over "
                         f"{len(vocab)} mesh axes")
    rows_of = [Replicate() if i in vocab or not isinstance(p, Shard) else p
               for i, p in enumerate(ids.placements)]
    ids = ids.redistribute(mesh, rows_of)
    lo, size = 0, table.shape[0]
    if vocab:
        size = -(-table.shape[0] // mesh.size(vocab[0]))
        lo = mesh.get_coordinate()[vocab[0]] * size

    def lookup(t, i):
        mine = (i >= lo) & (i < lo + t.shape[0])
        rows = t[torch.clamp(i - lo, 0, max(t.shape[0] - 1, 0))]
        return torch.where(mine[..., None], rows, 0.0) if vocab else rows

    batch = {i for i, p in enumerate(rows_of) if isinstance(p, Shard)}
    out = local_map(
        lookup, out_placements=[Partial() if i in vocab else p
                                for i, p in enumerate(rows_of)],
        in_placements=(table.placements, rows_of),
        in_grad_placements=([Partial() if i in batch else p
                             for i, p in enumerate(table.placements)],
                            rows_of),
        device_mesh=mesh)(table, ids)
    return out.redistribute(mesh, rows_of)


def attention_on_shards(fn, q, k, v, kv_length=None):
    """``fn(q, k, v, kv_length)``, an attention over (B, L, H, hd)
    operands, on each rank's own batch rows and heads: q's layout on the
    mesh with its sequence axis gathered (a query attends to every key),
    k and v (and the (B,) ``kv_length``, by batch) laid out alike, and
    the plain attention run on the local tensors
    (``local_map``). Every (batch, head) slice is independent, so each
    rank's slice of the output and of the gradients is exact. DTensor
    itself would fold a batch axis sharded over ``data`` and a head axis
    sharded over ``model`` into one axis for its batched product, which
    torch 2.13 lays out as a strided shard and torch 2.11 refuses.

    A decode step (one query) whose k and v are split along their
    sequence over a mesh axis, as the plan lays a KV cache whose heads do
    not divide the model axis, keeps them there (`_attend_key_shards`)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    layout = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
              for p in q.placements]
    by_batch = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in layout]
    if kv_length is not None and not is_dtensor(kv_length):
        kv_length = replicated(kv_length, mesh)
    split = [i for i, p in enumerate(k.placements)
             if isinstance(p, Shard) and p.dim == 1] if is_dtensor(k) else []
    if split and q.shape[1] == 1 and kv_length is not None:
        return _attend_key_shards(fn, q, k, v, kv_length, layout, split)
    q, k, v = (t.redistribute(mesh, layout) for t in (q, k, v))
    if kv_length is None:
        return local_map(lambda a, b, c: fn(a, b, c, None),
                         out_placements=layout,
                         in_placements=(layout, layout, layout),
                         device_mesh=mesh)(q, k, v)
    kv_length = kv_length.redistribute(mesh, by_batch)
    return local_map(fn, out_placements=layout,
                     in_placements=(layout, layout, layout, by_batch),
                     device_mesh=mesh)(q, k, v, kv_length)


def _attend_key_shards(fn, q, k, v, kv_length, layout, split):
    """A decode step on k and v split along their sequence over the mesh
    axis ``split``: q gathered over that axis (one query row), each rank
    attends over its own keys from their first position on, and the
    softmax's max and sum and the output's shares are reduced over the
    axis (``fn``'s ``k_offset`` and ``reduce``, `attention.dot_attention`).
    So the cache never moves: what crosses the axis is q and three
    reductions the size of the output, where gathering k and v into q's
    head layout would move the whole cache, repeated to every query
    head, at every step."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    if len(split) > 1:
        raise ValueError(f"keys split over {len(split)} mesh axes")
    (axis,) = split
    out = [Replicate() if i == axis else p for i, p in enumerate(layout)]
    keys = [Shard(1) if i == axis else p for i, p in enumerate(layout)]
    by_batch = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in out]
    q = q.redistribute(mesh, out)
    k, v = (t.redistribute(mesh, keys) for t in (k, v))
    kv_length = kv_length.redistribute(mesh, by_batch)
    offset = mesh.get_coordinate()[axis] * -(-k.shape[1] //
                                             mesh.size(axis))

    def reduce(op, t):
        return funcol.all_reduce(t, op, (mesh, axis))

    return local_map(lambda a, b, c, n: fn(a, b, c, n, k_offset=offset,
                                           reduce=reduce),
                     out_placements=out,
                     in_placements=(out, keys, keys, by_batch),
                     device_mesh=mesh)(q, k, v, kv_length)


def batch_on_shards(fn, lead, args, batch_axes, out_axes):
    """``fn(*args)`` on each rank's batch rows: the mesh axes that shard
    ``lead``'s first axis shard each argument's batch axis
    (``batch_axes``, ``None`` for an argument without one, which every
    rank then holds whole) and each output's (``out_axes``); every other
    mesh axis holds them whole, so ``fn`` runs on plain local tensors
    (``local_map``). An argument without a batch axis meets every rank's
    rows, so its gradient is a partial sum over the batch's mesh axes.
    ``None`` arguments pass as they are."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = lead.device_mesh
    data = {i for i, p in enumerate(lead.placements)
            if isinstance(p, Shard) and p.dim == 0}

    def layout(axis, other):
        return [Shard(axis) if axis is not None and i in data else other
                for i in range(mesh.ndim)]

    placed, ins, grads = [], [], []
    for t, axis in zip(args, batch_axes):
        if t is None:
            placed.append(None)
            ins.append(None)
            grads.append(None)
            continue
        if not is_dtensor(t):
            t = replicated(t, mesh)
        placed.append(t.redistribute(mesh, layout(axis, Replicate())))
        ins.append(layout(axis, Replicate()))
        grads.append(ins[-1] if axis is not None else
                     [Partial() if i in data else Replicate()
                      for i in range(mesh.ndim)])
    outs = tuple(layout(axis, Replicate()) for axis in out_axes)
    return local_map(fn, out_placements=outs, in_placements=tuple(ins),
                     in_grad_placements=tuple(grads),
                     device_mesh=mesh)(*placed)


def replicated(t, mesh):
    """A plain tensor, the same on every rank, as a replicated
    ``DTensor`` on ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def distribute_params(model, plan: ShardingPlan, mesh) -> dict:
    """Every parameter of ``model`` as a ``DTensor`` on ``mesh`` with its
    plan's placements, by the port's parameter name."""
    from torch.distributed.tensor import distribute_tensor
    return {name: distribute_tensor(
        p.detach(), mesh, placements(plan.param_spec_for(name, p), mesh))
        for name, p in model.named_parameters()}


#: Mesh shard-choice names (kept string-identical to `core/mesh.py`'s
#: constants; asserted in tests/test_torch_mesh.py so they cannot drift).
m_REPLICATE = "replicate"
m_SPLIT_N = "split_n"
m_SPLIT_K = "split_k"


def mesh_tp_choices(n_chips: int, *, out_channels: int, reduce_dim: int,
                    n_heads: int | None = None,
                    n_experts: int | None = None) -> tuple[str, ...]:
    """Valid CIM-mesh shard choices for one canonical layer, under the same
    divisibility discipline `make_plan` applies per tensor class — the
    mesh path (`core/mesh.py`) resolves its per-layer TP choices here so
    the sharding rules and the analytical mesh model can never disagree
    on when TP engages.

    Returned names (preference order): ``replicate`` (always — the
    fully-FSDP / replicated-compute fallback analog, the layer whole on
    one chip), ``split_n`` (TP over output channels — attention heads for
    qkv/o projections, FFN hidden for MLPs; the `attn_tp` rule) and
    ``split_k`` (TP over the reduction dim with a partial-sum all-reduce).

    Fallback semantics, mirroring `make_plan`:
      * ``n_heads`` given and ``n_heads % n_chips != 0`` → the `attn_tp`
        rule fails, both splits are withheld (splitting inside a head
        misaligns attention compute — the rules replicate instead of
        raising), leaving ``("replicate",)``.
      * ``n_experts`` given and ``n_experts % n_chips == 0`` → expert
        parallelism: whole expert GEMMs distribute across chips as
        replicated instances (the mesh placement layer spreads the
        ``count=E`` instances), so no intra-GEMM split is offered.
      * ``n_experts`` given and ``E % n_chips != 0`` → the `moe_ep` rule
        fails and falls back to TP *inside* each expert (the
        ``P(None, "data", "model")`` branch): splits by plain
        divisibility, ``replicate`` when neither divides.

    Pure arithmetic — no jax objects — so the mesh path can resolve
    choices without building a device mesh."""
    choices = [m_REPLICATE]
    if n_chips <= 1:
        return tuple(choices)
    if n_heads is not None and (n_heads <= 0 or n_heads % n_chips != 0):
        return tuple(choices)
    if n_experts is not None and n_experts > 0 and \
            n_experts % n_chips == 0:
        return tuple(choices)
    if out_channels % n_chips == 0 and out_channels >= n_chips:
        choices.append(m_SPLIT_N)
    if reduce_dim % n_chips == 0 and reduce_dim >= n_chips:
        choices.append(m_SPLIT_K)
    return tuple(choices)


def mesh_grad_choices(n_chips: int, *, out_channels: int,
                      reduce_dim: int) -> tuple[str, ...]:
    """Valid CIM-mesh shard choices for one weight-grad GEMM
    (`workload.OP_WGRAD`, canonical dims N=K_fwd, K=N_fwd, C=M tokens) —
    the FSDP side of the rules, mirroring the ``data`` axis strategy
    `make_plan` applies to parameters/optimizer state:

      * ``replicate`` — always valid: one chip computes the full gradient.
      * ``split_n`` — FSDP sharded gradients: each chip computes the 1/n
        slice of delta_W along the forward weight's output channels it
        owns (the P("data", ...) parameter shard), when divisible.
      * ``split_k`` — data parallelism: chips split the token reduction
        dim and ring-all-reduce fp32 partial gradients (the classic DP
        gradient sync; `mesh.shard_eval` prices the all-reduce at
        accumulator width), when divisible.

    No head/expert fallbacks: gradients have no attention-compute or
    routing alignment constraint — a grad shard never has to follow the
    head boundary the forward TP rule protects. Pure arithmetic, like
    `mesh_tp_choices`."""
    choices = [m_REPLICATE]
    if n_chips <= 1:
        return tuple(choices)
    if out_channels % n_chips == 0 and out_channels >= n_chips:
        choices.append(m_SPLIT_N)
    if reduce_dim % n_chips == 0 and reduce_dim >= n_chips:
        choices.append(m_SPLIT_K)
    return tuple(choices)
