"""The sharding rules' mesh shard choices: which CIM-mesh shard choices
(`core/mesh.py`) one layer admits, under the divisibility discipline the
reference's `make_plan` applies per tensor class (TP over heads when they
divide, expert parallelism when the experts divide, else TP inside each
expert; FSDP and data parallelism for weight gradients).

Pure arithmetic, no device objects. ``ShardingPlan`` / ``make_plan``, the
device-mesh half of the reference's rules, are not here: they come with
sharding (ROADMAP Queue A.4).
"""

from __future__ import annotations


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
