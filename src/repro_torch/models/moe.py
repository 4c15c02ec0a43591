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


def _expert_ffn(bank: ExpertBank, x: torch.Tensor, gated: bool,
                shard: Shard = no_shard) -> torch.Tensor:
    """x: (E, C, D) -> (E, C, D) with per-expert weights (E, D, F)."""
    w = lambda ew: shard.weight(ew.w).to(x.dtype)
    up = torch.bmm(x, w(bank.up))
    if gated:
        h = F.silu(torch.bmm(x, w(bank.gate))) * up
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(up, approximate="tanh")
    return torch.bmm(h, w(bank.down))


def top_k_experts(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest along the last axis, as
    ``jax.lax.top_k``: among equal values the lower index first (a
    uniform router over zero tokens ties every expert). ``torch.topk``
    promises no order among ties; a stable descending sort keeps it."""
    values, indices = torch.sort(probs, dim=-1, descending=True,
                                 stable=True)
    return values[..., :k], indices[..., :k]


def route(params: MoE, tokens: torch.Tensor, *, n_experts: int,
          top_k: int, capacity_factor: float = 1.25):
    """The routing of (T, D) tokens: (probs (T, E) float32, expert_idx
    (T, K), gate_vals (T, K) float32 with dropped slots zeroed, the
    position of each slot in its expert's buffer (T, K), keep (T, K),
    capacity)."""
    return _route(tokens, params.router.w, n_experts=n_experts,
                  top_k=top_k, capacity_factor=capacity_factor)


def _route(tokens, router_w, *, n_experts: int, top_k: int,
           capacity_factor: float):
    n_tok = tokens.shape[0]
    logits = tokens.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k_experts(probs, top_k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    capacity = max(1, int(capacity_factor * n_tok * top_k / n_experts))
    onehot = F.one_hot(expert_idx, n_experts)                   # T, K, E
    flat = onehot.reshape(n_tok * top_k, n_experts)
    pos = (torch.cumsum(flat, dim=0) - flat).reshape(onehot.shape)
    pos_in_expert = (pos * onehot).sum(dim=-1)                  # T, K
    keep = pos_in_expert < capacity
    return (probs, expert_idx, gate_vals * keep, pos_in_expert, keep,
            capacity)


def moe(params: MoE, x: torch.Tensor, *, n_experts: int, top_k: int,
        gated: bool, capacity_factor: float = 1.25,
        shard: Shard = no_shard):
    """x: (B, L, D). Returns (out, aux_loss): the routed (and shared)
    experts' output and the Switch-style load-balancing loss.

    The routing, the dispatch into the experts' buffers and the combine
    run through ``shard.whole``: on a mesh every rank routes every token
    of the global batch, as the reference's capacity and positions count
    them, and no layout of the scatter is left for DTensor to choose
    (its strategies for ``index_add`` tie, and a tie broken differently
    on two ranks sends them into different collectives). The experts run
    on the plan's ``moe_expert_in`` / ``moe_expert_out`` layout."""
    b, l, d = x.shape
    n_tok = b * l
    scatter = MOE_DISPATCH == "scatter"
    if MOE_DISPATCH not in ("scatter", "einsum"):
        raise ValueError(f"MOE_DISPATCH {MOE_DISPATCH!r}")

    def dispatch(x, router_w):
        """(expert_in (E, C, D), what the combine needs, aux loss)."""
        tokens = x.reshape(n_tok, d)
        probs, expert_idx, gate_vals, pos_in_expert, keep, capacity = \
            _route(tokens, router_w, n_experts=n_experts, top_k=top_k,
                   capacity_factor=capacity_factor)
        # load-balancing aux loss (Switch-style)
        me = probs.mean(dim=0)
        ce = F.one_hot(expert_idx[:, 0], n_experts).to(
            torch.float32).mean(dim=0)
        aux = n_experts * torch.sum(me * ce)
        if scatter:
            dest = expert_idx * capacity + torch.clamp_max(pos_in_expert,
                                                           capacity - 1)
            flat_dest = torch.where(keep, dest,
                                    n_experts * capacity).reshape(-1)
            src = torch.arange(n_tok, device=x.device).repeat_interleave(
                top_k)
            buf = torch.zeros((n_experts * capacity + 1, d), dtype=x.dtype,
                              device=x.device)
            buf.index_add_(0, flat_dest, tokens[src])
            return buf[:-1].reshape(n_experts, capacity, d), \
                (flat_dest, gate_vals), aux
        onehot = F.one_hot(expert_idx, n_experts).to(x.dtype)
        # a dropped slot's position is `capacity`: an all-zero row, as
        # jax.nn.one_hot gives for an index past its classes
        pos_oh = F.one_hot(torch.where(keep, pos_in_expert, capacity),
                           capacity + 1)[..., :capacity].to(x.dtype)
        disp = torch.einsum("tke,tkc->tec", onehot, pos_oh)
        combine = torch.einsum("tec,tk,tke->tec", disp,
                               gate_vals.to(x.dtype), onehot)
        return torch.einsum("td,tec->ecd", tokens, disp), (combine,), aux

    def gather_back(expert_out, *how):
        """The experts' outputs back at their tokens, (T, D)."""
        if scatter:
            flat_dest, gate_vals = how
            flat_out = torch.cat([expert_out.reshape(-1, d),
                                  expert_out.new_zeros((1, d))])
            picked = flat_out[flat_dest].reshape(n_tok, top_k, d)
            return torch.sum(picked * gate_vals[..., None].to(x.dtype),
                             dim=1)
        return torch.einsum("ecd,tec->td", expert_out, how[0])

    expert_in, how, aux = shard.whole(dispatch, x, params.router.w)
    expert_in = shard("moe_expert_in", expert_in)
    expert_out = _expert_ffn(params.experts, expert_in, gated, shard)
    expert_out = shard("moe_expert_out", expert_out)
    out = shard.whole(gather_back, expert_out, *how)

    if hasattr(params, "shared"):
        tokens = x.reshape(n_tok, d)
        n_sh = params.shared.up.w.shape[0]
        sh_in = tokens[None].expand(n_sh, n_tok, d)
        out = out + _expert_ffn(params.shared, sh_in, gated, shard).sum(
            dim=0)
    return out.reshape(b, l, d), aux
