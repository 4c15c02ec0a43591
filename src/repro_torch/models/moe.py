"""Mixture-of-Experts layer: top-k routing with a fixed expert capacity,
plus optional shared experts (Qwen-MoE); Arctic's dense residual MLP
beside it lives in the block (`transformer.AttnBlock`).

Two dispatch implementations, chosen by ``MOE_DISPATCH`` at call time as
in the reference: ``"scatter"`` (the default; indexed scatter / gather
over an (E * C + 1, D) buffer whose last row is the sink of dropped
slots, O(T * K + E * C * D) memory) and ``"einsum"`` (the textbook dense
one-hot dispatch / combine, O(T * E * C) memory). Both give the same
routing: router logits and softmax in float32, top-k (ties to the lower
expert index, as ``jax.lax.top_k``), the gates
renormalised, each slot's position in its expert's buffer from an
exclusive cumsum over the token-major (T * K, E) one-hot, and slots past
``capacity = max(1, int(capacity_factor * T * K / E))`` dropped.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Dense, Shard, _param, \
    init_parameters, no_shard

MOE_DISPATCH = "scatter"      # "scatter" | "einsum"


class ExpertWeights(nn.Module):
    """One weight of every expert of a bank: ``w`` (n, d_in, d_out), drawn
    as ``d_in ** -0.5`` times a standard normal (not truncated, as the
    reference's bank)."""

    def __init__(self, n: int, d_in: int, d_out: int, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.w = _param((n, d_in, d_out), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        f = self.w if self.w.dtype == torch.float32 else torch.empty_like(
            self.w, dtype=torch.float32)
        f.normal_(0.0, 1.0 / math.sqrt(self.w.shape[1]), generator=generator)
        if f is not self.w:
            self.w.copy_(f)


class ExpertBank(nn.Module):
    def __init__(self, n: int, d_model: int, d_ff: int, gated: bool, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.up = ExpertWeights(n, d_model, d_ff, **kw)
        self.down = ExpertWeights(n, d_ff, d_model, **kw)
        if gated:
            self.gate = ExpertWeights(n, d_model, d_ff, **kw)


class MoE(nn.Module):
    """``router``, ``experts`` and, with shared experts, ``shared``."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 n_shared: int, gated: bool, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.router = Dense(d_model, n_experts, **kw)
        self.experts = ExpertBank(n_experts, d_model, d_ff, gated, **kw)
        if n_shared:
            self.shared = ExpertBank(n_shared, d_model, d_ff, gated, **kw)


def init_moe(generator, d_model: int, d_ff: int, n_experts: int,
             n_shared: int, gated: bool, dtype=torch.float32,
             device=None) -> MoE:
    return init_parameters(MoE(d_model, d_ff, n_experts, n_shared, gated,
                               dtype=dtype, device=device), generator)


def _expert_hidden(bank: ExpertBank, x: torch.Tensor, gated: bool,
                   shard: Shard = no_shard) -> torch.Tensor:
    """x: (E, C, D) -> the experts' hidden (E, C, F), per-expert weights
    (E, D, F)."""
    w = lambda ew: shard.weight(ew.w).to(x.dtype)
    up = torch.bmm(x, w(bank.up))
    if gated:
        return F.silu(torch.bmm(x, w(bank.gate))) * up
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(up, approximate="tanh")


def _expert_down(bank: ExpertBank, h: torch.Tensor,
                 shard: Shard = no_shard) -> torch.Tensor:
    return torch.bmm(h, shard.weight(bank.down.w).to(h.dtype))


def _expert_ffn(bank: ExpertBank, x: torch.Tensor, gated: bool,
                shard: Shard = no_shard) -> torch.Tensor:
    """x: (E, C, D) -> (E, C, D) with per-expert weights (E, D, F)."""
    return _expert_down(bank, _expert_hidden(bank, x, gated, shard), shard)


def top_k_experts(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest along the last axis, as
    ``jax.lax.top_k``: among equal values the lower index first (a
    uniform router over zero tokens ties every expert). ``torch.topk``
    promises no order among ties; a stable descending sort keeps it."""
    values, indices = torch.sort(probs, dim=-1, descending=True,
                                 stable=True)
    return values[..., :k], indices[..., :k]


class TokenGroup:
    """Where the tokens a MoE layer's dispatch sees stand among all of the
    layer's, and which experts it builds (`layers.Shard.moe_dispatch`'s
    ``group``): this default is one device that holds every token and
    every expert. A mesh's (`sharding.rules.MoETokens`) splits the tokens
    into ``segments`` runs of the global token order on each rank, gives
    each run's ``offsets`` (the routed slots of each expert in all the
    runs before it), the rank's ``experts(n)`` (lo, hi) and the means,
    sums and gradient sums over the ranks that hold the other ``tokens``
    or ``experts``."""

    segments = 1

    def offsets(self, counts):
        return None

    def experts(self, n: int) -> tuple[int, int]:
        return 0, n

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        return t.mean(dim=0)

    def reduce(self, op: str, t: torch.Tensor, over: str) -> torch.Tensor:
        return t

    def grad_sum(self, t: torch.Tensor, over: str) -> torch.Tensor:
        return t


ONE_DEVICE = TokenGroup()


def route(params: MoE, tokens: torch.Tensor, *, n_experts: int,
          top_k: int, capacity_factor: float = 1.25):
    """The routing of (T, D) tokens: (probs (T, E) float32, expert_idx
    (T, K), gate_vals (T, K) float32 with dropped slots zeroed, the
    position of each slot in its expert's buffer (T, K), keep (T, K),
    capacity)."""
    capacity = max(1, int(capacity_factor * tokens.shape[0] * top_k /
                          n_experts))
    return (*_route(tokens, params.router.w, n_experts=n_experts,
                    top_k=top_k, capacity=capacity), capacity)


def _route(tokens, router_w, *, n_experts: int, top_k: int, capacity: int,
           group: TokenGroup = ONE_DEVICE):
    """`route` of the tokens ``group`` holds, at the layer's ``capacity``:
    each slot's position counts the slots of its expert in every token
    before it, those of the other runs (``group.offsets``) included."""
    logits = tokens.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k_experts(probs, top_k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    onehot = F.one_hot(expert_idx, n_experts)                   # T, K, E
    flat = onehot.reshape(group.segments, -1, n_experts)
    pos = torch.cumsum(flat, dim=1) - flat
    before = group.offsets(flat.sum(dim=1))
    if before is not None:
        pos = pos + before[:, None]
    pos_in_expert = (pos.reshape(onehot.shape) * onehot).sum(dim=-1)
    keep = pos_in_expert < capacity
    return probs, expert_idx, gate_vals * keep, pos_in_expert, keep


def _slots(expert_idx, slot, lo: int, hi: int, capacity: int):
    """(T * K,) each slot's row in the buffer of experts [lo, hi): its
    expert's block and its position there; a dropped slot's (``slot`` =
    capacity) and one of another expert's the sink row past the end."""
    dest = (expert_idx - lo) * capacity + torch.clamp_max(slot, capacity - 1)
    mine = (slot < capacity) & (expert_idx >= lo) & (expert_idx < hi)
    return torch.where(mine, dest, (hi - lo) * capacity).reshape(-1)


def _one_hots(expert_idx, slot, lo: int, hi: int, n_experts: int,
              capacity: int, dtype):
    """The einsum dispatch's one-hots of experts [lo, hi): (experts (T, K,
    E'), the dispatch (T, E', C))."""
    onehot = F.one_hot(expert_idx, n_experts).to(dtype)
    if (lo, hi) != (0, n_experts):
        onehot = onehot[..., lo:hi]
    # a dropped slot's position is `capacity`: an all-zero row, as
    # jax.nn.one_hot gives for an index past its classes
    pos_oh = F.one_hot(slot, capacity + 1)[..., :capacity].to(dtype)
    return onehot, torch.einsum("tke,tkc->tec", onehot, pos_oh)


def _dispatch(tokens, router_w, group, *, n_experts: int, top_k: int,
              capacity: int, scatter: bool):
    """`layers.Shard.moe_dispatch`'s ``fn``: (the experts' input (E', C,
    D) of the experts [lo, hi) the group builds, summed over the ranks
    that hold other tokens, (gate_vals, expert_idx, slot) by token, the
    aux loss). ``slot`` is each slot's position, ``capacity`` where it is
    dropped."""
    group = group or ONE_DEVICE
    probs, expert_idx, gate_vals, pos_in_expert, keep = _route(
        tokens, router_w, n_experts=n_experts, top_k=top_k,
        capacity=capacity, group=group)
    # load-balancing aux loss (Switch-style)
    me = group.mean(probs)
    ce = group.mean(F.one_hot(expert_idx[:, 0], n_experts).to(
        torch.float32))
    aux = n_experts * torch.sum(me * ce)
    slot = torch.where(keep, pos_in_expert, capacity)
    lo, hi = group.experts(n_experts)
    # each rank builds its experts' rows: a token's gradient is summed
    # over the ranks that hold the others
    src = group.grad_sum(tokens, "experts")
    d = tokens.shape[-1]
    if scatter:
        flat_dest = _slots(expert_idx, slot, lo, hi, capacity)
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        buf = torch.zeros(((hi - lo) * capacity + 1, d), dtype=src.dtype,
                          device=src.device)
        buf.index_add_(0, flat_dest, src[rows.repeat_interleave(top_k)])
        expert_in = buf[:-1].reshape(hi - lo, capacity, d)
    else:
        _, disp = _one_hots(expert_idx, slot, lo, hi, n_experts, capacity,
                            src.dtype)
        expert_in = torch.einsum("td,tec->ecd", src, disp)
    # the ranks' slots are disjoint: their sum is each rank's own rows
    return group.reduce("sum", expert_in, "tokens"), \
        (gate_vals, expert_idx, slot), aux


def _combine(expert_out, gate_vals, expert_idx, slot, group, *,
             n_experts: int, capacity: int, scatter: bool):
    """`layers.Shard.moe_combine`'s ``fn``: the experts' outputs back at
    the group's tokens, (T, D), summed over the ranks that hold the other
    experts."""
    group = group or ONE_DEVICE
    lo, hi = group.experts(n_experts)
    # the rows of every token of the layer, of which these are the
    # group's: their gradient is summed over the ranks of the others
    expert_out = group.grad_sum(expert_out, "tokens")
    gate_vals = group.grad_sum(gate_vals, "experts")
    n_tok, top_k = expert_idx.shape
    d = expert_out.shape[-1]
    if scatter:
        # each slot's row, and the sink's zeros for a dropped slot or
        # another rank's expert, without a copy of the buffer
        rows = _slots(expert_idx, slot, lo, hi, capacity)
        flat_out = expert_out.reshape(-1, d)
        sink = rows == flat_out.shape[0]
        picked = torch.where(sink[:, None], 0.0,
                             flat_out[torch.where(sink, 0, rows)])
        out = torch.sum(picked.reshape(n_tok, top_k, d) *
                        gate_vals[..., None].to(expert_out.dtype), dim=1)
    else:
        onehot, disp = _one_hots(expert_idx, slot, lo, hi, n_experts,
                                 capacity, expert_out.dtype)
        combine = torch.einsum("tec,tk,tke->tec", disp,
                               gate_vals.to(expert_out.dtype), onehot)
        out = torch.einsum("ecd,tec->td", expert_out, combine)
    return group.reduce("sum", out, "experts")


def moe(params: MoE, x: torch.Tensor, *, n_experts: int, top_k: int,
        gated: bool, capacity_factor: float = 1.25,
        shard: Shard = no_shard):
    """x: (B, L, D). Returns (out, aux_loss): the routed (and shared)
    experts' output and the Switch-style load-balancing loss.

    The routing, the dispatch into the experts' buffers and the combine
    run through ``shard.moe_dispatch`` / ``shard.moe_combine``: on a mesh
    each rank routes its own tokens, at the capacity and positions of the
    whole layer's (`sharding.rules.moe_dispatch_on_shards`), and the
    experts run on the plan's ``moe_expert_in`` / ``moe_expert_out``
    layout."""
    b, l, d = x.shape
    n_tok = b * l
    if MOE_DISPATCH not in ("scatter", "einsum"):
        raise ValueError(f"MOE_DISPATCH {MOE_DISPATCH!r}")
    kw = dict(n_experts=n_experts,
              capacity=max(1, int(capacity_factor * n_tok * top_k /
                                  n_experts)),
              scatter=MOE_DISPATCH == "scatter")
    expert_in, how, aux = shard.moe_dispatch(
        functools.partial(_dispatch, top_k=top_k, **kw), x, params.router.w)
    h = _expert_hidden(params.experts, shard("moe_expert_in", expert_in),
                       gated, shard)
    del expert_in   # a served step frees the buffer before the down product
    expert_out = shard("moe_expert_out",
                       _expert_down(params.experts, h, shard))
    del h
    out = shard.moe_combine(functools.partial(_combine, **kw), expert_out,
                            how, x)

    if hasattr(params, "shared"):
        tokens = shard.keep(x.reshape(n_tok, d))
        n_sh = params.shared.up.w.shape[0]
        sh_in = tokens[None].expand(n_sh, n_tok, d)
        # on the tokens' own layout, whatever the experts' left: the
        # split back into (b, l) needs the rows split as b splits
        out = out + shard.like(_expert_ffn(params.shared, sh_in, gated,
                                           shard).sum(dim=0),
                               tokens).reshape(b, l, d)
    return out, aux
