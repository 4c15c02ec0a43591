"""ctypes binding of ``csrc/flash_attention.cu`` and its launch counter.

The CUDA source names the TPU kernel it replaces and what bounds it. The
tile sets below are the template instantiations the source dispatches on;
`core/gpu_bridge.py` picks blocks from them."""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

BQ_TILES = (1, 16, 32, 64)
BK_TILES = (32, 64, 128)
MAX_HEAD_DIM = 128          # one thread per output column, 128 threads
#: Shared-memory buffers per KV tile: the kernel loads, then computes (no
#: software pipeline yet).
STAGES = 1

#: Kernel launches so far (the plain version on CPU tensors is not one).
launches = 0


def smem_bytes(bq: int, bk: int, head_dim: int, bytes_el: int) -> int:
    """Dynamic shared memory of one CTA: the f32 q tile, scores and row
    statistics, and the K (rows padded by one 32-bit word) and V tiles in
    the input type."""
    return 4 * (bq * head_dim + bq * bk + 3 * bq) + \
        bytes_el * (bk * (head_dim + 4 // bytes_el) + bk * head_dim)


def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
        [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_blhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, block_q: int = 64,
                         block_k: int = 128) -> torch.Tensor:
    """q: (B, Lq, H, hd); k, v: (B, Lk, H, hd) -> (B, Lq, H, hd) in q's
    dtype. Row ``b*H + h`` of the reference's (B*H, L, hd) fold is read
    in place through strides.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    Blocks need not divide the lengths: the kernel masks ragged tails."""
    global launches
    if block_q not in BQ_TILES or block_k not in BK_TILES:
        raise ValueError(f"blocks {(block_q, block_k)} outside the kernel's "
                         f"tile set {BQ_TILES} x {BK_TILES}")
    b, lq, h, hd = q.shape
    lk = k.shape[1]
    if k.shape != (b, lk, h, hd) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention takes float32 or bfloat16 q, k, v "
                        "of one dtype")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside 1..{MAX_HEAD_DIM}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, lq, lk, hd, 1.0 / math.sqrt(hd), int(causal), block_q,
        block_k, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    return out
