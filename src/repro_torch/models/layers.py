"""Core layers: norms, dense, MLPs, RoPE, embeddings.

Each layer is a small ``nn.Module`` that holds its parameters under the
reference's names, beside a plain function that applies it (``rms_norm``
reads ``params.scale`` where the reference reads ``params["scale"]``).
``init_*`` build a layer and draw its weights from a ``torch.Generator``;
the modules' own constructors leave the parameters uninitialised, which
is what `convert.params_from_numpy` fills. Parameters carry no gradient:
this is the serving half of the runtime.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn


class Shard:
    """The forward's ``shard``: ``shard(logical, x)`` constrains the
    activation ``x`` at one of the reference's logical names, and the
    methods run the few steps whose layout a mesh must choose itself. This
    default changes nothing: every activation as it is, every step on its
    plain tensors. A mesh run passes the plan's
    (`sharding.rules.ShardingPlan.shard_fn`), which lays ``DTensor``s on
    the plan's specs and runs these steps on each rank's shards."""

    def __call__(self, logical: str, x: torch.Tensor) -> torch.Tensor:
        return x

    def scope(self, *tensors):
        """The context a forward or a backward over ``tensors`` runs in."""
        return contextlib.nullcontext()

    def rows(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """The embedding lookup ``table[ids]``."""
        return table[ids]

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A weight as a product reads it."""
        return w

    def heads(self, x: torch.Tensor, n_heads: int,
              head_dim: int) -> torch.Tensor:
        """A projection's output (..., n_heads * head_dim) split into
        (..., n_heads, head_dim)."""
        return x.reshape(*x.shape[:-1], n_heads, head_dim)

    def keep(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, its gradient brought back on ``x``'s own layout (a step
        after it may leave the gradient laid otherwise)."""
        return x

    def like(self, x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
        """``x`` on ``ref``'s layout, dimension for dimension (a
        dimension of one, which broadcasts against ``ref``'s, whole), so
        that a step between the two runs on each rank's own shards (a
        decode step's write of its new row into the cache)."""
        return x

    def attend(self, fn, q, k, v, kv_length=None):
        """``fn(q, k, v, kv_length)``: an attention over (B, L, H, hd)
        operands, which may take ``k_offset`` (the position of k's first
        row) and ``reduce(op, t)`` (``op`` "max" or "sum" over the ranks
        that hold the other rows of k and v) when k and v are split along
        their sequence."""
        return fn(q, k, v, kv_length)

    def on_batch(self, fn, lead, args, batch_axes, out_axes):
        """``fn(*args)``, which treats every batch row on its own:
        ``batch_axes`` names each argument's batch axis (None for one
        without), ``out_axes`` each output's; ``lead`` is the argument
        whose layout the batch follows."""
        return fn(*args)

    def unembed(self, table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The LM head ``x @ table.T``, in x's dtype."""
        return x @ table.to(x.dtype).T

    def loss(self, fn, logits, labels):
        """``fn(logits, labels)``, a loss over (B, L, V) logits, which may
        take ``lo`` (the vocab id of the logits' first column) and
        ``reduce(op, t, over)`` (``op`` "max" or "sum" over the ranks
        that hold the other vocab slices, ``over="vocab"``, or the other
        tokens, ``"tokens"``) when the logits are split."""
        return fn(logits, labels)

    def moe_dispatch(self, fn, x, router_w):
        """``fn(tokens, router_w, group)`` on the (T, D) tokens of x (B,
        L, D): (the experts' input (E, C, D), how the combine finds each
        token's slots: three tensors by token, the aux loss). ``group``
        (None: one device holding every token and expert) says where a
        rank's tokens stand among all of them and which experts it
        builds (`models.moe.TokenGroup`)."""
        return fn(x.reshape(-1, x.shape[-1]), router_w, None)

    def moe_combine(self, fn, expert_out, how, x):
        """``fn(expert_out, *how, group)``, the experts' output back at
        the (T, D) tokens of x, in x's shape; ``how`` and ``group`` as
        `moe_dispatch` gave and took them."""
        return fn(expert_out, *how, None).reshape(x.shape)


#: The forward's default ``shard``.
no_shard = Shard()


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def truncated_normal_(t: torch.Tensor, std: float,
                      generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place with ``std`` times a standard normal truncated
    to [-2, 2], drawn in float32 by inverse-CDF sampling (as
    ``jax.random.truncated_normal``, though not its numbers) and cast to
    ``t``'s dtype."""
    lo, hi = (math.erf(v / math.sqrt(2.0)) for v in (-2.0, 2.0))
    f = t if t.dtype == torch.float32 else torch.empty_like(
        t, dtype=torch.float32)
    f.uniform_(lo, hi, generator=generator)
    f.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)
    if f is not t:
        t.copy_(f)
    return t


def init_parameters(module: nn.Module, generator: torch.Generator | None,
                    place=None) -> nn.Module:
    """Draw every parameter of ``module`` from ``generator``: each
    submodule's ``reset_parameters`` fills its own parameters, in
    ``modules()`` order. A parameter on the meta device is allocated on
    the generator's device just before its submodule draws it, so a
    module built on meta is drawn one submodule at a time. ``place(name,
    p)``, when given, is called on each parameter right after its
    submodule draws it and its result takes the parameter's place (a mesh
    run lays it on its shards, `sharding.state`); the drawn tensor is then
    freed before the next submodule is drawn."""
    for prefix, m in module.named_modules():
        reset = getattr(m, "reset_parameters", None)
        own = list(m.named_parameters(recurse=False))
        if reset is None:
            if own:
                raise ValueError(f"{prefix}: parameters without "
                                 f"reset_parameters")
            continue
        for attr, p in own:
            if p.is_meta:
                setattr(m, attr, _param(p.shape, p.dtype, generator.device))
        reset(generator)
        if place is not None:
            for attr, p in list(m.named_parameters(recurse=False)):
                name = f"{prefix}.{attr}" if prefix else attr
                setattr(m, attr, nn.Parameter(place(name, p),
                                              requires_grad=False))
    return module


def truncated_normal(generator: torch.Generator, shape, std: float,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    return truncated_normal_(torch.empty(shape, dtype=dtype, device=device),
                             std, generator)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.scale = _param((dim,), torch.float32, device)

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.scale)


def init_rmsnorm(dim: int, device=None) -> RMSNorm:
    return init_parameters(RMSNorm(dim, device=device), None)


def rms_norm(params: RMSNorm, x: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params.scale).to(dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.scale = _param((dim,), torch.float32, device)
        self.bias = _param((dim,), torch.float32, device)

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)


def init_layernorm(dim: int, device=None) -> LayerNorm:
    return init_parameters(LayerNorm(dim, device=device), None)


def layer_norm(params: LayerNorm, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * params.scale + params.bias).to(dtype)


# ---------------------------------------------------------------------------
# Dense / MLP
# ---------------------------------------------------------------------------

class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.w = _param((d_in, d_out), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        truncated_normal_(self.w, 1.0 / math.sqrt(self.w.shape[0]),
                          generator)


def init_dense(generator, d_in: int, d_out: int, dtype=torch.float32,
               device=None) -> Dense:
    return init_parameters(Dense(d_in, d_out, dtype=dtype, device=device),
                           generator)


def dense(params: Dense, x: torch.Tensor,
          shard: Shard = no_shard) -> torch.Tensor:
    """A plain product outside any kernel, as the reference leaves it. On
    a mesh a weight whose gradient the step takes is read through
    ``shard.keep``: its gradient goes back onto its own shards as the
    backward reaches it, where DTensor's product leaves it whole (a
    partial sum) until the backward ends, every layer's at once."""
    w = shard.keep(params.w) if params.w.requires_grad else params.w
    return x @ w.to(x.dtype)


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, gated: bool, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.up = Dense(d_model, d_ff, dtype=dtype, device=device)
        self.down = Dense(d_ff, d_model, dtype=dtype, device=device)
        if gated:
            self.gate = Dense(d_model, d_ff, dtype=dtype, device=device)


def init_mlp(generator, d_model: int, d_ff: int, gated: bool,
             dtype=torch.float32, device=None) -> MLP:
    return init_parameters(MLP(d_model, d_ff, gated, dtype=dtype,
                               device=device), generator)


def mlp(params: MLP, x: torch.Tensor, gated: bool,
        shard=no_shard) -> torch.Tensor:
    h = dense(params.up, x, shard)
    if gated:
        h = F.silu(dense(params.gate, x, shard)) * h
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h, approximate="tanh")
    h = shard("ffn_hidden", h)
    return dense(params.down, h, shard)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). The angles
    are float32 whatever x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (.., L, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, vocab: int, d_model: int, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.table = _param((vocab, d_model), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        truncated_normal_(self.table, 0.02, generator)


def init_embedding(generator, vocab: int, d_model: int, dtype=torch.float32,
                   device=None) -> Embedding:
    return init_parameters(Embedding(vocab, d_model, dtype=dtype,
                                     device=device), generator)


def embed(params: Embedding, ids: torch.Tensor, dtype=torch.bfloat16,
          shard: Shard = no_shard) -> torch.Tensor:
    """Rows of the table in ``dtype``; gathered before the cast, which
    gives the reference's cast-then-gather values without casting the
    whole table."""
    return shard.rows(params.table, ids).to(dtype)


def unembed(params: Embedding, x: torch.Tensor,
            shard: Shard = no_shard) -> torch.Tensor:
    return shard.unembed(params.table, x)
