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

#: block_q = 1 runs the decode kernel (one query row per CTA, K and V
#: streamed through registers); 16, 32 and 64 the prefill kernel (BQ / 16
#: warps, 16 query rows each, on the tensor cores).
BQ_TILES = (1, 16, 32, 64)
#: In the prefill kernel the KV tile's rows. In the decode kernel a warp's
#: chunk is bk / 32 keys and each warp keeps two chunks in flight, so a
#: CTA has bk / 4 keys in flight.
BK_TILES = (32, 64, 128)
#: Prefill: hd is zero-padded in shared memory to the smallest of these
#: (the template instances); decode: four columns per lane of a warp.
HEAD_DIM_TILES = (64, 128)
MAX_HEAD_DIM = 128
#: Slots of the prefill kernel's KV ring in shared memory: K_j in one, V_j
#: in the other, so V_j's copy overlaps q.K_j^T and K_{j+1}'s copy P.V_j.
#: `smem_bytes` counts the whole ring. The decode kernel stages no K or V
#: in shared memory; its prefetch of the next chunk is in registers.
STAGES = 2
#: Warps of the decode kernel's CTA, each on its own share of the keys.
DECODE_WARPS = 4

#: Kernel launches so far (the plain version on CPU tensors is not one).
launches = 0


def padded_head_dim(head_dim: int) -> int:
    """The prefill kernel's head-dim instance: hd zero-padded to it."""
    return min(t for t in HEAD_DIM_TILES if t >= head_dim)


def smem_bytes(bq: int, bk: int, head_dim: int, bytes_el: int) -> int:
    """Dynamic shared memory of one CTA, as the launch passes it. Prefill
    (bq >= 16): the q tile [bq][hd'] and the ring's ``STAGES`` KV slots
    [bk][hd'] in the input type, hd' = `padded_head_dim`. Decode (bq = 1):
    only each warp's f32 accumulator, max and sum for the final merge,
    whatever bk and dtype."""
    if bq == 1:
        return 4 * DECODE_WARPS * (head_dim + 2)
    return bytes_el * padded_head_dim(head_dim) * (bq + STAGES * bk)


def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
        [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def occupancy(bq: int, bk: int, head_dim: int,
              dtype: torch.dtype) -> dict[str, int]:
    """What the card runs one (bq, bk, head_dim, dtype) launch with:
    registers per thread, shared memory per CTA (static plus the dynamic
    bytes the launch passes) and resident CTAs per SM, from the CUDA
    runtime. Needs the card."""
    fn = _build.load("flash_attention").flash_attention_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    ctas, regs, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = fn(bq, bk, head_dim, int(dtype == torch.bfloat16),
             ctypes.byref(ctas), ctypes.byref(regs), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"flash_attention occupancy query failed: CUDA "
                           f"error {err}")
    return {"ctas_per_sm": ctas.value, "regs": regs.value,
            "smem_bytes": smem.value}


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
