"""GQA attention with RoPE, causal masking, a KV cache and the
flash_attention kernel for long causal prefills
(`repro_torch/kernels/flash_attention`)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.models.layers import Dense, Shard, apply_rope, dense, \
    init_parameters, no_shard


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S, KV, hd): the compute dtype, or int8
    v: torch.Tensor       # (B, S, KV, hd)
    length: torch.Tensor  # (B,) int32: valid prefix length
    k_scale: torch.Tensor | None = None   # (B, S, KV, 1) f32 when int8
    v_scale: torch.Tensor | None = None


# Module-level implementation switches, read at call time (the
# reference's defaults):
ATTN_IMPL = "chunked"     # "naive" | "chunked" (online softmax, L >= 2048)
KV_QUANT = False          # int8 KV cache (capacity optimization)

#: Shortest causal prefill that runs on the flash_attention kernel.
FLASH_MIN_LEN = 512


class Attention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.wq = Dense(d_model, n_heads * head_dim, **kw)
        self.wk = Dense(d_model, n_kv_heads * head_dim, **kw)
        self.wv = Dense(d_model, n_kv_heads * head_dim, **kw)
        self.wo = Dense(n_heads * head_dim, d_model, **kw)


def init_attention(generator, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, dtype=torch.float32,
                   device=None) -> Attention:
    return init_parameters(Attention(d_model, n_heads, n_kv_heads, head_dim,
                                     dtype=dtype, device=device), generator)


def _repeat_kv(x: torch.Tensor, rep: int) -> torch.Tensor:
    if rep == 1:
        return x
    b, s, kv, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, rep, hd).reshape(
        b, s, kv * rep, hd)


def dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, kv_length=None, k_offset: int = 0,
                  reduce=None) -> torch.Tensor:
    """q: (B,Lq,H,hd); k,v: (B,Lk,H,hd). Returns (B,Lq,H,hd). Scores and
    softmax in float32, the probabilities cast back to q's dtype.

    k and v may be one slice of the keys along the sequence, starting at
    position ``k_offset``, with ``reduce(op, t)`` reducing ``t`` by
    ``op`` ("max" or "sum") over the holders of every slice: then the
    softmax takes the max and the sum over every slice, and each slice's
    share of the output is summed (the split-K form of a decode step)."""
    b, lq, h, hd = q.shape
    lk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    kpos = k_offset + torch.arange(lk, device=q.device)
    neg = torch.finfo(torch.float32).min
    if causal:
        qpos = torch.arange(lq, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        scores = scores.masked_fill(~mask[None, None], neg)
    if kv_length is not None:
        valid = kpos[None, :] < kv_length[:, None]
        scores = scores.masked_fill(~valid[:, None, None, :], neg)
    if reduce is None:
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)
    m = reduce("max", torch.amax(scores, dim=-1, keepdim=True))
    p = torch.exp(scores - m)
    probs = (p / reduce("sum", torch.sum(p, dim=-1, keepdim=True))).to(
        q.dtype)
    return reduce("sum", torch.einsum("bhqk,bkhd->bqhd", probs, v))


def dot_attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, block_k: int = 1024,
                          kv_length=None) -> torch.Tensor:
    """Online-softmax attention over KV blocks of ``block_k`` (a loop in
    place of the reference's scan): float32 running max, sum and
    accumulator, probabilities in q's dtype, the (Lq, Lk) score tensor
    never whole."""
    bsz, lq, h, hd = q.shape
    lk = k.shape[1]
    block_k = min(block_k, lk)
    if lk % block_k:
        raise ValueError(f"Lk {lk} is not a multiple of block_k {block_k}")
    scale = 1.0 / math.sqrt(hd)
    qpos = torch.arange(lq, device=q.device)
    m = torch.full((bsz, h, lq), -1e30, dtype=torch.float32, device=q.device)
    s_sum = torch.zeros((bsz, h, lq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bsz, h, lq, hd), dtype=torch.float32, device=q.device)
    qf = q.to(torch.float32)
    for start in range(0, lk, block_k):
        kc = k[:, start:start + block_k]
        vc = v[:, start:start + block_k]
        scores = torch.einsum("bqhd,bkhd->bhqk", qf,
                              kc.to(torch.float32)) * scale
        kpos = start + torch.arange(block_k, device=q.device)
        if causal:
            mask = kpos[None, :] <= qpos[:, None]
            scores = scores.masked_fill(~mask[None, None], -1e30)
        if kv_length is not None:
            valid = kpos[None, :] < kv_length[:, None]
            scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None]).to(q.dtype)
        s_sum = s_sum * alpha + p.sum(dim=-1, dtype=torch.float32)
        pv = torch.einsum("bhqk,bkhd->bhqd", p, vc)
        acc = acc * alpha[..., None] + pv.to(torch.float32)
        m = m_new
    out = acc / torch.clamp_min(s_sum, 1e-20)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attend(q, k, v, *, causal: bool, kv_length=None, chunked: bool = False,
           shard: Shard = no_shard) -> torch.Tensor:
    """`dot_attention` (or `dot_attention_chunked`) of q, k, v, through
    ``shard.attend``: on a mesh, on each rank's own shards."""
    def fn(q, k, v, kv_length, k_offset=0, reduce=None):
        if chunked:
            if reduce is not None:
                raise ValueError("the chunked attention takes whole keys")
            return dot_attention_chunked(q, k, v, causal=causal,
                                         kv_length=kv_length)
        return dot_attention(q, k, v, causal=causal, kv_length=kv_length,
                             k_offset=k_offset, reduce=reduce)
    return shard.attend(fn, q, k, v, kv_length)


def quantize_kv(x: torch.Tensor):
    """Per-(position, head) symmetric int8 KV quantization."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.float32)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def _flash(q, kf, vf) -> torch.Tensor:
    """The causal prefill on the flash_attention kernel at the bridge's
    tile for this shape and card (the kernel's plain version on CPU
    tensors)."""
    from repro_torch.core.gpu_bridge import device_sms, select_flash_blocks
    from repro_torch.kernels.flash_attention.ops import flash_attention
    b, l, h, hd = q.shape
    bq, bk = select_flash_blocks(l, l, hd, bytes_el=q.element_size(),
                                 batch_heads=b * h, n_sms=device_sms())
    return flash_attention(q, kf, vf, causal=True, block_q=bq, block_k=bk)


def attention(params: Attention, x: torch.Tensor, *, n_heads: int,
              n_kv_heads: int, head_dim: int, rope_theta: float,
              causal: bool = True, cache: KVCache | None = None,
              use_flash: bool = False, shard: Shard = no_shard):
    """Returns (out, new_cache). Prefill: cache=None, full seq. Decode:
    x is (B, 1, D) and cache holds past K/V."""
    b, l, _ = x.shape
    q = shard.heads(dense(params.wq, x), n_heads, head_dim)
    k = shard.heads(dense(params.wk, x), n_kv_heads, head_dim)
    v = shard.heads(dense(params.wv, x), n_kv_heads, head_dim)
    q = shard("attn_q", q)
    rep = n_heads // n_kv_heads
    if cache is None:
        pos = torch.arange(l, device=x.device)
        if rope_theta:
            q = apply_rope(q, pos, rope_theta)
            k = apply_rope(k, pos, rope_theta)
        kf, vf = _repeat_kv(k, rep), _repeat_kv(v, rep)
        if use_flash and causal and l >= FLASH_MIN_LEN:
            out = _flash(q, kf, vf)
        else:
            out = attend(q, kf, vf, causal=causal,
                         chunked=ATTN_IMPL == "chunked" and l >= 2048,
                         shard=shard)
        length = torch.full((b,), l, dtype=torch.int32, device=x.device)
        if KV_QUANT:
            qk, sk = quantize_kv(k)
            qv, sv = quantize_kv(v)
            new_cache = KVCache(k=qk, v=qv, length=length, k_scale=sk,
                                v_scale=sv)
        else:
            new_cache = KVCache(k=k, v=v, length=length)
    else:
        # single-token decode against the cache
        pos = cache.length                                  # (B,)
        if rope_theta:
            q = apply_rope(q, pos[:, None], rope_theta)
            k = apply_rope(k, pos[:, None], rope_theta)
        # the reference's one-hot(length) write: a row whose length has
        # reached max_seq gets an all-zero row, so its write is dropped;
        # the new row and the one-hot on the cache's layout, so that the
        # write runs on each rank's own rows of the cache
        k, v = shard.like(k, cache.k), shard.like(v, cache.v)
        s = cache.k.shape[1]
        oh = (torch.arange(s, device=x.device)[None, :] ==
              cache.length[:, None]).to(torch.float32)     # (B, S)
        if cache.k_scale is not None:
            qk, sk = quantize_kv(k)
            qv, sv = quantize_kv(v)
            ohq = shard.like(oh[:, :, None, None], cache.k)
            k_cache = cache.k + (ohq * qk.to(torch.float32)).to(cache.k.dtype)
            v_cache = cache.v + (ohq * qv.to(torch.float32)).to(cache.v.dtype)
            k_scale = cache.k_scale + ohq * sk
            v_scale = cache.v_scale + ohq * sv
            kf = _repeat_kv(dequantize_kv(k_cache, k_scale, x.dtype), rep)
            vf = _repeat_kv(dequantize_kv(v_cache, v_scale, x.dtype), rep)
            new_cache = KVCache(k=k_cache, v=v_cache,
                                length=cache.length + 1,
                                k_scale=k_scale, v_scale=v_scale)
        else:
            ohq = shard.like(oh[:, :, None, None].to(cache.k.dtype),
                             cache.k)
            k_cache = cache.k + ohq * k.to(cache.k.dtype)
            v_cache = cache.v + ohq * v.to(cache.v.dtype)
            kf = _repeat_kv(k_cache, rep)
            vf = _repeat_kv(v_cache, rep)
            new_cache = KVCache(k=k_cache, v=v_cache,
                                length=cache.length + 1)
        out = attend(q, kf, vf, causal=False, kv_length=cache.length + 1,
                     shard=shard)
    out = shard("attn_out", out)
    out = out.reshape(b, l, n_heads * head_dim)
    return dense(params.wo, out), new_cache


def init_kv_cache(batch: int, max_seq: int, n_kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (batch, max_seq, n_kv_heads, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device))
