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

import dataclasses
import math
from typing import Any

from repro_torch.configs.base import ModelConfig, ShapeSpec
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

    def shard_fn(self):
        """``fn(logical, x)``: a plain tensor comes back as it is; a
        ``DTensor`` is redistributed to ``act_spec(logical)`` on its own
        mesh. Unlike the reference's, which swallows the ``ValueError`` /
        ``KeyError`` of a constraint that does not apply, an error here
        (a spec longer than the tensor, an axis the mesh lacks) raises."""
        def fn(logical: str, x):
            from torch.distributed.tensor import DTensor
            if not isinstance(x, DTensor):
                return x
            spec = self.act_spec(logical)
            if len(spec) > x.ndim:
                raise ValueError(f"{logical}: spec {spec} has more entries "
                                 f"than the tensor's {x.ndim} dims")
            return x.redistribute(x.device_mesh,
                                  placements(spec, x.device_mesh))
        return fn

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
