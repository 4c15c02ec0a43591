"""Plain references of the executor's ops: the rowwise-quantized int8
product with its scale epilogue, and attention."""

from __future__ import annotations

import math

import torch

from bench.reference.precision import matmul


def quantize_rows(x: torch.Tensor, axis: int, bits: int = 8):
    """Symmetric quantization of each row along ``axis`` to ``bits``:
    the scale is the row's largest magnitude over 2**(bits-1) - 1 (at
    least 1e-8 of it), the values rounded half to even and clipped.
    Returns (integer values as float64, float32 scales along the other
    axis)."""
    top = 2 ** (bits - 1) - 1
    xf = x.to(torch.float32)
    scale = torch.clamp_min(xf.abs().amax(dim=axis, keepdim=True),
                            1e-8) / top
    q = torch.clamp(torch.round(xf / scale), -top, top)
    return q.to(torch.float64), scale.squeeze(axis)


def quantized_matmul(x: torch.Tensor, w: torch.Tensor,
                     bits: int = 8) -> torch.Tensor:
    """(M, K) @ (K, N) through quantization of x by rows and w by
    columns: the integer sums exact in float64, then ``(sums * x_scale)
    * w_scale`` in float32."""
    xq, xs = quantize_rows(x, axis=1, bits=bits)
    wq, ws = quantize_rows(w, axis=0, bits=bits)
    acc = (xq @ wq).to(torch.float32)
    return acc * xs[:, None] * ws[None, :]


def attention(q, k, v, *, causal: bool, precision: str = "f32",
              block: int = 1024) -> torch.Tensor:
    """q: (B, Lq, H, hd); k, v: (B, Lk, H, hd) -> (B, Lq, H, hd) in
    float32: softmax of q k^T / sqrt(hd) (causal: a query at position i
    of the last Lq sees keys up to Lk - Lq + i), in blocks of ``block``
    query rows."""
    b, lq, h, hd = q.shape
    lk = k.shape[1]
    kt = k.permute(0, 2, 3, 1).to(torch.float32)         # (B, H, hd, Lk)
    vv = v.permute(0, 2, 1, 3).to(torch.float32)         # (B, H, Lk, hd)
    out = []
    for s in range(0, lq, block):
        qb = q[:, s:s + block].permute(0, 2, 1, 3).to(torch.float32)
        scores = matmul(qb, kt, precision) / math.sqrt(hd)
        if causal:
            qpos = torch.arange(s, s + qb.shape[2], device=q.device) + \
                (lk - lq)
            mask = torch.arange(lk, device=q.device)[None, :] <= \
                qpos[:, None]
            scores = scores.masked_fill(~mask, float("-inf"))
        p = torch.softmax(scores, dim=-1)
        out.append(matmul(p, vv, precision).permute(0, 2, 1, 3))
    return torch.cat(out, dim=1)
