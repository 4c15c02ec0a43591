"""ctypes binding of ``csrc/matmul_int8.cu``, its launch counter and the
split-K rule.

The CUDA source names the TPU kernel it replaces and what bounds it. The
tile sets below are the template instantiations the source dispatches on;
`core/gpu_bridge.py` picks blocks from them."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.matmul_int8.ref import matmul_int8_ref

BM_TILES = (16, 32, 64, 128)
BN_TILES = (32, 64, 128)
BK_TILES = (32, 64, 128)
#: Shared-memory stages of the cp.async ring: two K steps in flight while
#: the tensor cores work on the third. `smem_bytes` counts the whole ring.
STAGES = 3
#: Dynamic shared memory one CTA may opt into on an H100 (227 KB of the
#: SM's 256 KB); the launch sets the opt-in for every tile past 48 KB.
SMEM_LIMIT = 232_448

#: Kernel launches so far (the plain version on CPU tensors is not one).
launches = 0


def smem_bytes(bm: int, bk: int, bn: int) -> int:
    """Dynamic shared memory of one CTA, as the launch passes it: ``STAGES``
    slots of the ring, each the int8 x tile [bm][bk] and the w tile
    [bk][bn], swizzled, unpadded, and nothing else."""
    return STAGES * (bm * bk + bk * bn)


def split_k(m: int, n: int, k: int, bm: int, bk: int, bn: int,
            n_sms: int) -> int:
    """CTAs that share one output tile's K steps: 1 when the
    ceil(m/bm) * ceil(n/bn) tiles already give every SM one, else as many
    as bring the grid up to ``n_sms`` CTAs, as long as each split still
    loads at least as many operand bytes (its K steps of bk * (bm + bn))
    as the int32 partial tile it writes (4 * bm * bn): at 128^3, two K
    steps. Never more than ceil(k/bk), so no CTA is left without a step."""
    tiles = -(-m // bm) * -(-n // bn)
    steps = max(1, -(-k // bk))
    if tiles >= n_sms:
        return 1
    min_steps = -(-4 * bm * bn // (bk * (bm + bn)))
    return max(1, min(n_sms // tiles, steps // min_steps))


_split_rule = split_k      # the wrapper's argument of that name shadows it


@functools.cache
def _launcher():
    fn = _build.load("matmul_int8").matmul_int8_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def occupancy(bm: int, bk: int, bn: int) -> dict[str, int]:
    """What the card runs one (bm, bk, bn) launch with: threads per CTA,
    registers and local memory (spills) per thread, shared memory per CTA
    (static plus the dynamic bytes the launch passes) and resident CTAs per
    SM, from the CUDA runtime. Needs the card."""
    fn = _build.load("matmul_int8").matmul_int8_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 5
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int() for _ in range(5)]
    err = fn(bm, bk, bn, *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"matmul_int8 occupancy query failed: CUDA "
                           f"error {err}")
    return dict(zip(("ctas_per_sm", "threads", "regs", "local_bytes",
                     "smem_bytes"), (v.value for v in vals)))


def matmul_int8(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor, *, bm: int = 128, bk: int = 128,
                bn: int = 128, out_dtype=torch.bfloat16,
                split_k: int | None = None) -> torch.Tensor:
    """x_q: (M, K) int8; w_q: (K, N) int8; x_scale: (M,) f32;
    w_scale: (N,) f32 -> (M, N) out_dtype (float32 or bfloat16).

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    Blocks need not divide the dims: the kernel masks ragged edges.
    ``split_k`` CTAs share each output tile's K steps, their int32 partials
    summed exactly in split order by a second pass; ``None`` takes the rule
    `split_k` gives for this card's SM count."""
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
    steps = max(1, -(-k // bk))
    if split_k is not None and not 1 <= split_k <= steps:
        raise ValueError(f"split_k {split_k} outside 1..{steps} "
                         f"(ceil(K / bk) K steps)")
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
    if split_k is None:
        split_k = _split_rule(m, n, k, bm, bk, bn, _sm_count(device.index))
    x_q, w_q = x_q.contiguous(), w_q.contiguous()
    x_scale, w_scale = x_scale.contiguous(), w_scale.contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=device)
    # split-K: one m x n int32 partial per split, each written in full
    workspace = torch.empty(split_k * m * n, dtype=torch.int32,
                            device=device) if split_k > 1 else None
    err = _launcher()(
        x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
        w_scale.data_ptr(), out.data_ptr(),
        workspace.data_ptr() if workspace is not None else None, m, n, k,
        bm, bk, bn, split_k, int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul_int8 launch failed: CUDA error {err}")
    launches += 1
    return out
