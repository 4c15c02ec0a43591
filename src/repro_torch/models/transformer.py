"""Model assembly for every architecture family of the registry.

  dense  : pre-norm GQA blocks + (gated) MLP
  moe    : GQA blocks + routed experts (+ shared experts / Arctic's dense
           residual MLP)
  vlm    : the dense decoder, with precomputed frontend embeddings (stubbed
           image patches) in front of the text in prefill
  ssm    : Mamba2 (SSD) blocks, attention-free
  hybrid : Mamba2 backbone + one parameter-shared attention block after
           every ``attn_every`` Mamba2 blocks (Zamba2), then a tail
  encdec : bidirectional encoder over precomputed frontend embeddings
           (stubbed audio frames) + causal decoder with cross-attention
           (Seamless backbone)

The reference stacks each family's layers along a leading axis and scans
over them; here they are an ``nn.ModuleList`` and a Python loop, and the
per-layer caches are stacked along a leading layer axis as the
reference's scan returns them. Modes:
  "train"   tokens -> logits (full sequence, causal, no caches)
  "prefill" tokens -> logits + caches
  "decode"  one token + caches -> logits + caches

In train mode ``remat=True`` recomputes each block in the backward pass
(``torch.utils.checkpoint``) where the reference wraps its scan body in
``jax.checkpoint``: the attention blocks of the dense, moe and vlm stacks
and of the encoder, and every Mamba2 block (the hybrid's shared attention
block and the encoder-decoder's decoder blocks are not wrapped, as in the
reference).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import Attention, _repeat_kv, attend, \
    attention
from repro_torch.models.layers import MLP, Embedding, RMSNorm, dense, \
    Shard, embed, init_parameters, mlp, no_shard, rms_norm, unembed
from repro_torch.models.moe import MoE, moe
from repro_torch.models.ssm import Mamba2, mamba2_block
from repro_torch.runtime.spans import span

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} ({cfg.name}) is not one "
                         f"of {FAMILIES}")


class AttnBlock(nn.Module):
    """``ln1``, ``attn``, ``ln2`` and the feed-forward: ``mlp``, or in the
    ``moe`` family ``moe`` (with ``mlp`` beside it under Arctic's
    ``dense_residual``)."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.resolved_head_dim, **kw)
        self.ln2 = RMSNorm(cfg.d_model, device=device)
        if cfg.n_experts and cfg.family == "moe":
            self.moe = MoE(cfg.d_model, cfg.moe_d_ff, cfg.n_experts,
                           cfg.n_shared_experts, cfg.gated_mlp, **kw)
            if cfg.dense_residual:
                self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.gated_mlp, **kw)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.gated_mlp, **kw)


class CrossBlock(AttnBlock):
    """A decoder block of the ``encdec`` family: the attention block with
    a cross-attention (``ln_x``, ``xattn``) over the encoder's memory."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32,
                 device=None):
        super().__init__(cfg, dtype=dtype, device=device)
        self.ln_x = RMSNorm(cfg.d_model, device=device)
        self.xattn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.resolved_head_dim, dtype=dtype,
                               device=device)


class MambaBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, device=device)
        self.mamba = Mamba2(cfg.d_model, expand=cfg.ssm_expand,
                            head_dim=cfg.ssm_head_dim,
                            groups=cfg.ssm_groups, state=cfg.ssm_state,
                            conv=cfg.ssm_conv, dtype=dtype, device=device)


def hybrid_groups(cfg: ModelConfig) -> tuple[int, int]:
    """(groups, layers in groups) of a hybrid model: each group is
    ``attn_every`` Mamba2 blocks and the shared attention block; the
    ``n_layers - grouped`` blocks after them are the tail."""
    n_groups = cfg.n_layers // cfg.attn_every
    return n_groups, n_groups * cfg.attn_every


class LM(nn.Module):
    """The parameters of one model, under the reference's names:
    ``embed``, ``ln_f``, ``unembed`` (unless tied) and ``blocks``; the
    hybrid's ``tail`` (when the groups leave layers over) and
    ``shared_attn``; the encoder-decoder's ``enc_blocks`` and ``ln_enc``.
    """

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        stack = lambda block, n: nn.ModuleList(block(cfg, **kw)
                                               for _ in range(n))
        self.embed = Embedding(cfg.padded_vocab(), cfg.d_model, **kw)
        self.ln_f = RMSNorm(cfg.d_model, device=device)
        if not cfg.tie_embeddings:
            self.unembed = Embedding(cfg.padded_vocab(), cfg.d_model, **kw)
        fam = cfg.family
        if fam in ("dense", "moe", "vlm"):
            self.blocks = stack(AttnBlock, cfg.n_layers)
        elif fam == "ssm":
            self.blocks = stack(MambaBlock, cfg.n_layers)
        elif fam == "hybrid":
            _, grouped = hybrid_groups(cfg)
            self.blocks = stack(MambaBlock, grouped)
            if cfg.n_layers > grouped:
                self.tail = stack(MambaBlock, cfg.n_layers - grouped)
            self.shared_attn = AttnBlock(cfg, **kw)
        else:                                           # encdec
            self.enc_blocks = stack(AttnBlock, cfg.encoder_layers)
            self.blocks = stack(CrossBlock, cfg.n_layers)
            self.ln_enc = RMSNorm(cfg.d_model, device=device)


def init_model(cfg: ModelConfig, generator: torch.Generator | None,
               dtype=torch.float32, device=None, place=None) -> LM:
    """The model with every weight drawn from ``generator``, on its
    device, one module at a time (`layers.init_parameters`, which hands
    each drawn parameter to ``place`` when given); ``generator=None``
    leaves them uninitialised on ``device``, for
    `convert.params_from_numpy` to fill (``device="meta"`` allocates
    nothing)."""
    if generator is None:
        return LM(cfg, dtype=dtype, device=device)
    return init_parameters(LM(cfg, dtype=dtype, device="meta"), generator,
                           place)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ForwardOut:
    logits: torch.Tensor
    caches: Any = None
    aux_loss: torch.Tensor | None = None


def _layer(stack, i: int):
    """Layer ``i`` of caches stacked along a leading layer axis."""
    return type(stack)(*(None if t is None else t[i] for t in stack))


def _stacked(per_layer: list):
    return type(per_layer[0])(*(None if ts[0] is None else torch.stack(ts)
                                for ts in zip(*per_layer)))


def _cross_attention(blk: CrossBlock, x, cfg: ModelConfig, memory,
                     mem_cross_kv, shard: Shard = no_shard):
    """The decoder's attention over the encoder's memory: K and V from
    ``memory`` (prefill) or the cache's ``mem_cross_kv`` (decode), no
    RoPE, no mask, the plain product as in the reference. Returns (x,
    (k, v))."""
    hd = cfg.resolved_head_dim
    hx = rms_norm(blk.ln_x, x, cfg.norm_eps)
    b, l, _ = hx.shape
    q = shard.heads(dense(blk.xattn.wq, hx, shard), cfg.n_heads, hd)
    if mem_cross_kv is None:
        k = shard.heads(dense(blk.xattn.wk, memory, shard), cfg.n_kv_heads,
                        hd)
        v = shard.heads(dense(blk.xattn.wv, memory, shard), cfg.n_kv_heads,
                        hd)
    else:
        k, v = mem_cross_kv
    rep = cfg.n_heads // cfg.n_kv_heads
    o = attend(q, _repeat_kv(k, rep), _repeat_kv(v, rep), causal=False,
               shard=shard)
    return x + dense(blk.xattn.wo, o.reshape(b, l, -1), shard), (k, v)


def _attn_block_apply(blk: AttnBlock, x, cfg: ModelConfig, cache, *,
                      causal: bool, use_flash: bool, memory=None,
                      mem_cross_kv=None, shard=no_shard):
    """Returns (x, new KV cache, the MoE aux loss or None, the cross K/V
    or None)."""
    h = rms_norm(blk.ln1, x, cfg.norm_eps)
    attn_out, new_cache = attention(
        blk.attn, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        causal=causal, cache=cache, use_flash=use_flash, shard=shard)
    x = x + attn_out
    cross_kv = aux = None
    if memory is not None or mem_cross_kv is not None:
        x, cross_kv = _cross_attention(blk, x, cfg, memory, mem_cross_kv,
                                       shard)
    h = rms_norm(blk.ln2, x, cfg.norm_eps)
    if hasattr(blk, "moe"):
        out, aux = moe(blk.moe, h, n_experts=cfg.n_experts, top_k=cfg.top_k,
                       gated=cfg.gated_mlp, shard=shard)
        if hasattr(blk, "mlp"):                 # Arctic's dense residual
            out = out + mlp(blk.mlp, h, cfg.gated_mlp, shard)
    else:
        out = mlp(blk.mlp, h, cfg.gated_mlp, shard)
    return x + out, new_cache, aux, cross_kv


def _run(remat: bool, fn, *args):
    """``fn(*args)``; under ``remat`` its activations are not kept but
    recomputed in the backward pass."""
    return checkpoint(fn, *args, use_reentrant=False) if remat \
        else fn(*args)


def _attn_train(blk: AttnBlock, x, cfg, causal: bool, use_flash: bool,
                shard):
    """One attention block without caches: (x, the MoE aux loss or
    None)."""
    x, _, aux, _ = _attn_block_apply(blk, x, cfg, None, causal=causal,
                                     use_flash=use_flash, shard=shard)
    return x, aux


def _attn_stack(blocks, x, cfg, caches, *, causal: bool, use_flash: bool,
                train: bool = False, remat: bool = False, shard=no_shard):
    """caches: stacked per-layer KVCache for decode, or None (prefill
    collects fresh ones; train keeps none). Returns (x, the summed aux
    loss or None, stacked caches or None in train mode)."""
    new, aux = [], None
    for i, blk in enumerate(blocks):
        if train:
            x, aux_l = _run(remat, _attn_train, blk, x, cfg, causal,
                            use_flash, shard)
        else:
            x, c, aux_l, _ = _attn_block_apply(
                blk, x, cfg, None if caches is None else _layer(caches, i),
                causal=causal, use_flash=use_flash, shard=shard)
            new.append(c)
        if aux_l is not None:
            aux = aux_l if aux is None else aux + aux_l
    return x, aux, None if train else _stacked(new)


def _mamba_layer(blk: MambaBlock, x, cfg, state, shard=no_shard):
    """One residual Mamba2 layer. The model's SSM layers call
    ``mamba2_block`` without ``use_kernel``, as the reference's
    ``_ssm_stack`` and ``_hybrid_stack`` do: its forward runs the plain
    SSD product."""
    out, st = mamba2_block(blk.mamba, rms_norm(blk.ln, x, cfg.norm_eps), cfg,
                           state=state, shard=shard)
    return x + out, st


def _mamba_train(blk: MambaBlock, x, cfg, shard):
    return _mamba_layer(blk, x, cfg, None, shard)[0]


def _ssm_stack(blocks, x, cfg, states, is_decode, train=False, remat=False,
               shard=no_shard):
    new = []
    for i, blk in enumerate(blocks):
        if train:
            x = _run(remat, _mamba_train, blk, x, cfg, shard)
            continue
        x, st = _mamba_layer(blk, x, cfg,
                             _layer(states, i) if is_decode else None, shard)
        new.append(st)
    return x, None if train else _stacked(new)


def _hybrid_stack(params: LM, x, cfg, caches, is_decode, use_flash,
                  train=False, remat=False, shard=no_shard):
    """Groups of ``attn_every`` Mamba2 blocks, each followed by the one
    parameter-shared attention block, then the tail. caches: (SSM states
    stacked over n_layers, KV caches stacked over the groups); prefill
    makes fresh ones (the reference's dummy caches only shape its scan),
    train none."""
    n_groups, grouped = hybrid_groups(cfg)
    states, kv = caches if is_decode else (None, None)
    layers = list(params.blocks) + list(getattr(params, "tail", ()))
    new_states, new_kv = [], []

    def mamba(i, x):
        if train:
            return _run(remat, _mamba_train, layers[i], x, cfg, shard)
        x, st = _mamba_layer(layers[i], x, cfg,
                             _layer(states, i) if is_decode else None, shard)
        new_states.append(st)
        return x

    for g in range(n_groups):
        for i in range(g * cfg.attn_every, (g + 1) * cfg.attn_every):
            x = mamba(i, x)
        x, c, _, _ = _attn_block_apply(
            params.shared_attn, x, cfg, _layer(kv, g) if is_decode else None,
            causal=True, use_flash=use_flash, shard=shard)
        if not train:
            new_kv.append(c)
    for i in range(grouped, cfg.n_layers):
        x = mamba(i, x)
    return x, None if train else (_stacked(new_states), _stacked(new_kv))


def _encdec_stack(params: LM, x, cfg, caches, frontend_embeds, is_decode,
                  compute_dtype, use_flash, train=False, remat=False,
                  shard=no_shard):
    """Prefill and train encode the frontend embeddings bidirectionally
    (the plain product, ``use_flash=False`` as in the reference) into the
    memory and compute each decoder layer's cross K/V from it; decode
    reads them from the caches (self KV, (cross K, cross V), memory)."""
    if is_decode:
        kv, cross_kvs, memory = caches
    else:
        if frontend_embeds is None:
            raise ValueError("the encdec family needs frontend embeddings")
        m, _, _ = _attn_stack(params.enc_blocks,
                              frontend_embeds.to(compute_dtype), cfg, None,
                              causal=False, use_flash=False, train=train,
                              remat=remat, shard=shard)
        memory = rms_norm(params.ln_enc, m, cfg.norm_eps)
        kv = cross_kvs = None
    new_kv, new_ck, new_cv = [], [], []
    for i, blk in enumerate(params.blocks):
        ckv = None if cross_kvs is None else (cross_kvs[0][i],
                                              cross_kvs[1][i])
        x, c, _, (ck, cv) = _attn_block_apply(
            blk, x, cfg, None if kv is None else _layer(kv, i), causal=True,
            use_flash=use_flash, memory=memory if ckv is None else None,
            mem_cross_kv=ckv, shard=shard)
        if not train:
            new_kv.append(c)
            new_ck.append(ck)
            new_cv.append(cv)
    if train:
        return x, None
    return x, (_stacked(new_kv), (torch.stack(new_ck), torch.stack(new_cv)),
               memory)


def forward(params: LM, cfg: ModelConfig, tokens: torch.Tensor, *,
            mode: str = "prefill", caches: Any = None,
            frontend_embeds: torch.Tensor | None = None,
            use_flash: bool = False, remat: bool = False,
            compute_dtype=torch.bfloat16, shard=no_shard) -> ForwardOut:
    """tokens: (B, L) integer ids. frontend_embeds: (B, S_front, D)
    precomputed embeddings of the stubbed modality: the ``vlm`` prefill
    and train modes put them in front of the text (and drop their
    positions from the logits), the ``encdec`` prefill and train modes
    encode them; decode reads neither. ``mode`` defaults to ``"prefill"``
    (the serving call sites rely on it; the reference's default is
    ``"train"``). Train mode returns no caches; ``remat`` takes effect
    only there. Train mode with ``use_flash`` raises: the flash kernel
    has no backward, and its output would carry no gradient.

    ``shard(logical, x)`` constrains the activations at the reference's
    logical names (``hidden``, ``logits``, ``attn_q``, ``attn_out``,
    ``ffn_hidden``, ``moe_expert_in``, ``moe_expert_out``, ``ssm_x``);
    a mesh run passes `sharding.rules.ShardingPlan.shard_fn`, with the
    parameters and the inputs ``DTensor``s, and the forward then runs
    in its ``scope`` (`layers.Shard`). The default changes nothing."""
    _check_family(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r} is not train, prefill or decode")
    if mode == "train" and use_flash:
        raise ValueError("train mode with use_flash: flash_attention has "
                         "no backward; train on the plain product")
    is_decode, train = mode == "decode", mode == "train"
    remat = remat and train
    if is_decode and caches is None:
        raise ValueError("decode needs the caches of a prefill")
    fam = cfg.family
    prefix = frontend_embeds is not None and fam == "vlm" and not is_decode
    with shard.scope(tokens):
        x = embed(params.embed, tokens, compute_dtype, shard)
        if prefix:
            x = torch.cat([frontend_embeds.to(compute_dtype), x], dim=1)
        x = shard("hidden", x)
        aux = None
        if fam in ("dense", "moe", "vlm"):
            x, aux, new_caches = _attn_stack(
                params.blocks, x, cfg, caches if is_decode else None,
                causal=True, use_flash=use_flash, train=train, remat=remat,
                shard=shard)
        elif fam == "ssm":
            x, new_caches = _ssm_stack(params.blocks, x, cfg, caches,
                                       is_decode, train, remat, shard)
        elif fam == "hybrid":
            x, new_caches = _hybrid_stack(params, x, cfg, caches, is_decode,
                                          use_flash, train, remat, shard)
        else:
            x, new_caches = _encdec_stack(params, x, cfg, caches,
                                          frontend_embeds, is_decode,
                                          compute_dtype, use_flash, train,
                                          remat, shard)
        x = rms_norm(params.ln_f, x, cfg.norm_eps)
        if prefix:
            x = x[:, frontend_embeds.shape[1]:]
        table = params.embed if cfg.tie_embeddings else params.unembed
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        with span("model.lm_head"):
            logits = shard("logits", unembed(table, x, shard))
    return ForwardOut(logits=logits, caches=new_caches, aux_loss=aux)
