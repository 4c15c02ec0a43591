"""ctypes binding of ``csrc/matmul_int8.cu`` and its launch counter.

The CUDA source names the TPU kernel it replaces and what bounds it. The
tile sets below are the template instantiations the source dispatches on;
`core/gpu_bridge.py` picks blocks from them."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.matmul_int8.ref import matmul_int8_ref

BM_TILES = (16, 32, 64, 128)
BN_TILES = (32, 64, 128)
BK_TILES = (32, 64, 128)
#: Shared-memory buffers per tile: the kernel loads, then computes (no
#: software pipeline yet).
STAGES = 1
#: The tiles are static shared memory, which a CTA may hold up to 48 KB of.
SMEM_LIMIT = 48 * 1024

#: Kernel launches so far (the plain version on CPU tensors is not one).
launches = 0


def smem_bytes(bm: int, bk: int, bn: int) -> int:
    """Static shared memory of one CTA: the int8 x tile [bm][bk + 4] and
    the transposed w tile [bn][bk + 4]."""
    return (bm + bn) * (bk + 4)


def _launcher():
    fn = _build.load("matmul_int8").matmul_int8_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def matmul_int8(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor, *, bm: int = 128, bk: int = 128,
                bn: int = 128, out_dtype=torch.bfloat16) -> torch.Tensor:
    """x_q: (M, K) int8; w_q: (K, N) int8; x_scale: (M,) f32;
    w_scale: (N,) f32 -> (M, N) out_dtype (float32 or bfloat16).

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    Blocks need not divide the dims: the kernel masks ragged edges."""
    global launches
    if bm not in BM_TILES or bk not in BK_TILES or bn not in BN_TILES:
        raise ValueError(f"blocks {(bm, bk, bn)} outside the kernel's tile "
                         f"set {BM_TILES} x {BK_TILES} x {BN_TILES}")
    m, k = x_q.shape
    k2, n = w_q.shape
    if k != k2 or x_scale.shape != (m,) or w_scale.shape != (n,):
        raise ValueError(f"shapes {tuple(x_q.shape)} @ {tuple(w_q.shape)} "
                         f"with scales {tuple(x_scale.shape)}, "
                         f"{tuple(w_scale.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype {out_dtype} is not float32/bfloat16")
    devices = {t.device for t in (x_q, w_q, x_scale, w_scale)}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return matmul_int8_ref(x_q, w_q, x_scale, w_scale, out_dtype)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8 or \
            x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise TypeError("matmul_int8 takes int8 operands and float32 scales")
    x_q, w_q = x_q.contiguous(), w_q.contiguous()
    x_scale, w_scale = x_scale.contiguous(), w_scale.contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=device)
    err = _launcher()(
        x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
        w_scale.data_ptr(), out.data_ptr(), m, n, k, bm, bk, bn,
        int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul_int8 launch failed: CUDA error {err}")
    launches += 1
    return out
