"""Model assembly for the ``dense`` and ``ssm`` families.

  dense : pre-norm GQA blocks + (gated) MLP
  ssm   : Mamba2 (SSD) blocks, attention-free

The reference stacks each family's layers along a leading axis and scans
over them; here they are an ``nn.ModuleList`` and a Python loop, and the
per-layer caches are stacked along a leading layer axis as the
reference's scan returns them. Modes:
  "prefill" tokens -> logits + caches
  "decode"  one token + caches -> logits + caches

The ``moe``, ``vlm``, ``hybrid`` and ``encdec`` families and the training
mode are not ported yet (ROADMAP Queue A, items 4 and 5): they raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import Attention, attention
from repro_torch.models.layers import MLP, Embedding, RMSNorm, embed, \
    init_parameters, mlp, rms_norm, unembed
from repro_torch.models.ssm import Mamba2, mamba2_block

FAMILIES = ("dense", "ssm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: the "
            f"port runs {FAMILIES}; ROADMAP Queue A item 4 brings moe, "
            f"vlm, hybrid and encdec")


class AttnBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.resolved_head_dim, **kw)
        self.ln2 = RMSNorm(cfg.d_model, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.gated_mlp, **kw)


class MambaBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, device=device)
        self.mamba = Mamba2(cfg.d_model, expand=cfg.ssm_expand,
                            head_dim=cfg.ssm_head_dim,
                            groups=cfg.ssm_groups, state=cfg.ssm_state,
                            conv=cfg.ssm_conv, dtype=dtype, device=device)


class LM(nn.Module):
    """The parameters of one model, under the reference's names:
    ``embed``, ``ln_f``, ``unembed`` (unless tied) and ``blocks``."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        self.embed = Embedding(cfg.padded_vocab(), cfg.d_model, **kw)
        self.ln_f = RMSNorm(cfg.d_model, device=device)
        if not cfg.tie_embeddings:
            self.unembed = Embedding(cfg.padded_vocab(), cfg.d_model, **kw)
        block = AttnBlock if cfg.family == "dense" else MambaBlock
        self.blocks = nn.ModuleList(block(cfg, **kw)
                                    for _ in range(cfg.n_layers))


def init_model(cfg: ModelConfig, generator: torch.Generator | None,
               dtype=torch.float32, device=None) -> LM:
    """The model with every weight drawn from ``generator`` (on
    ``device``); ``generator=None`` leaves them uninitialised, for
    `convert.params_from_numpy` to fill (``device="meta"`` allocates
    nothing)."""
    model = LM(cfg, dtype=dtype, device=device)
    return model if generator is None else init_parameters(model, generator)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ForwardOut:
    logits: torch.Tensor
    caches: Any = None


def _layer(stack, i: int):
    """Layer ``i`` of caches stacked along a leading layer axis."""
    return type(stack)(*(None if t is None else t[i] for t in stack))


def _stacked(per_layer: list):
    return type(per_layer[0])(*(None if ts[0] is None else torch.stack(ts)
                                for ts in zip(*per_layer)))


def _attn_block_apply(blk: AttnBlock, x, cfg: ModelConfig, cache, *,
                      causal: bool, use_flash: bool):
    h = rms_norm(blk.ln1, x, cfg.norm_eps)
    attn_out, new_cache = attention(
        blk.attn, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        causal=causal, cache=cache, use_flash=use_flash)
    x = x + attn_out
    h = rms_norm(blk.ln2, x, cfg.norm_eps)
    return x + mlp(blk.mlp, h, cfg.gated_mlp), new_cache


def _attn_stack(blocks, x, cfg, caches, *, use_flash):
    """caches: stacked per-layer KVCache for decode, or None (prefill
    collects fresh ones)."""
    new = []
    for i, blk in enumerate(blocks):
        x, c = _attn_block_apply(
            blk, x, cfg, None if caches is None else _layer(caches, i),
            causal=True, use_flash=use_flash)
        new.append(c)
    return x, _stacked(new)


def _ssm_stack(blocks, x, cfg, states, is_decode):
    """The model's SSM layers call ``mamba2_block`` without ``use_kernel``,
    as the reference's ``_ssm_stack`` does: its forward runs the plain
    SSD product."""
    new = []
    for i, blk in enumerate(blocks):
        h = rms_norm(blk.ln, x, cfg.norm_eps)
        out, st = mamba2_block(blk.mamba, h, cfg, state=_layer(states, i)
                               if is_decode else None)
        x = x + out
        new.append(st)
    return x, _stacked(new)


def forward(params: LM, cfg: ModelConfig, tokens: torch.Tensor, *,
            mode: str = "prefill", caches: Any = None,
            use_flash: bool = False,
            compute_dtype=torch.bfloat16) -> ForwardOut:
    """tokens: (B, L) integer ids."""
    _check_family(cfg)
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(
            f"mode {mode!r}: the port serves (prefill, decode); the train "
            f"mode comes with the training slice (ROADMAP Queue A item 5)")
    is_decode = mode == "decode"
    if is_decode and caches is None:
        raise ValueError("decode needs the caches of a prefill")
    x = embed(params.embed, tokens, compute_dtype)
    if cfg.family == "dense":
        x, new_caches = _attn_stack(params.blocks, x, cfg,
                                    caches if is_decode else None,
                                    use_flash=use_flash)
    else:
        x, new_caches = _ssm_stack(params.blocks, x, cfg, caches, is_decode)
    x = rms_norm(params.ln_f, x, cfg.norm_eps)
    table = params.embed if cfg.tie_embeddings else params.unembed
    return ForwardOut(logits=unembed(table, x), caches=new_caches)
