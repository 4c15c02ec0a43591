"""Plain PyTorch versions of the INT8 matmul: the oracle every kernel
launch is checked against, and what the wrapper runs on CPU tensors."""

import torch


def matmul_int8_ref(x_q, w_q, x_scale, w_scale, out_dtype=torch.bfloat16):
    """(M, K) int8 @ (K, N) int8 -> int32 sums, then
    ``(acc * x_scale[:, None]) * w_scale[None, :]`` in float32.

    The sums are taken in float64, where every partial sum of int8 products
    is an exact integer (|acc| <= 127**2 * K < 2**53), so they equal the
    int32 accumulation; CUDA has no int32 matrix product to take them in."""
    acc = x_q.to(torch.float64) @ w_q.to(torch.float64)
    out = acc.to(torch.float32) * x_scale.to(torch.float32)[:, None] * \
        w_scale.to(torch.float32)[None, :]
    return out.to(out_dtype)


def quantize_rowwise(x, axis=-1):
    """Symmetric per-row INT8 quantization; returns (q, scale).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.squeeze(axis)
