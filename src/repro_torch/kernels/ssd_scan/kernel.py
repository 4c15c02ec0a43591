"""ctypes binding of ``csrc/ssd_scan.cu`` and its launch counter.

The CUDA source names the TPU kernel it replaces and what bounds it. It
reads every operand through element strides, so ``ssd_intra_chunk_bcqh``
(the public `ops.ssd_intra_chunk`) hands it the (B, NC, Q, H, .) layout in
place and ``ssd_intra_chunk_bh`` the reference's flattened
(B*NC*H, Q, .) one. The tile sets below are the template instances the
source dispatches on; `core/gpu_bridge.select_ssd_block` picks the query
tile."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref

#: Query rows of one CTA (``bt``). Its 4 warps own bt / 16 row groups of
#: 16 rows, and split each key slot into 64 / bt key groups.
BT_TILES = (16, 32, 64)
WARPS = 4
#: Keys of one slot of the ring in shared memory, and its slots: the copy
#: of slot j + 1 overlaps the products on slot j.
KEY_TILE = 64
STAGES = 2
#: N and P are zero-padded in shared memory to the smallest of these (the
#: template instances).
DIM_TILES = (64, 128)
#: Largest state size N and head dim P the kernel takes.
MAX_DIM = 128
DTYPES = (torch.float32, torch.bfloat16)

#: Kernel launches so far (the plain version on CPU tensors is not one).
launches = 0


def padded_dim(d: int) -> int:
    """The instance N or P is zero-padded to."""
    return min(t for t in DIM_TILES if t >= d)


def key_groups(bt: int) -> int:
    """Warps of a CTA that share one row group, each on its own keys."""
    return WARPS * 16 // bt


def smem_bytes(n: int, p: int, bytes_el: int) -> int:
    """Dynamic shared memory of one CTA, as the launch passes it, whatever
    the query tile: the ring's ``STAGES`` slots, each B [64][N'] and X
    [64][P'] in the input type (N', P' = `padded_dim`) and the slot's s and
    dt in float32. The C tile passes through a slot on its way to
    registers, and the key groups' partial sums reuse the ring."""
    return STAGES * (KEY_TILE * (padded_dim(n) + padded_dim(p)) * bytes_el +
                     2 * KEY_TILE * 4)


def occupancy(bt: int, n: int, p: int, dtype: torch.dtype) -> dict[str, int]:
    """What the card runs one (bt, N, P, dtype) launch with: registers and
    local memory per thread, shared memory per CTA (static plus the
    dynamic bytes the launch passes) and resident CTAs per SM, from the
    CUDA runtime. Needs the card."""
    fn = _build.load("ssd_scan").ssd_scan_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    ctas, regs, smem, local = (ctypes.c_int() for _ in range(4))
    err = fn(bt, n, p, int(dtype == torch.bfloat16), ctypes.byref(ctas),
             ctypes.byref(regs), ctypes.byref(smem), ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"ssd_scan occupancy query failed: CUDA error "
                           f"{err}")
    return {"ctas_per_sm": ctas.value, "regs": regs.value,
            "smem_bytes": smem.value, "local_bytes": local.value}


def _launcher():
    fn = _build.load("ssd_scan").ssd_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _strides4(t: torch.Tensor) -> list[int]:
    """(batch, chunk, t, head) element strides of a (B, NC, Q, H[, D])
    tensor."""
    return list(t.stride()[:4])


def ssd_intra_chunk_bcqh(c: torch.Tensor, b: torch.Tensor, s: torch.Tensor,
                         dt: torch.Tensor, x: torch.Tensor, *,
                         block_t: int | None = None) -> torch.Tensor:
    """c, b: (B, NC, Q, H, N); s, dt: (B, NC, Q, H); x: (B, NC, Q, H, P)
    -> y (B, NC, Q, H, P) in x's dtype. All five share one dtype, float32
    or bfloat16; the arithmetic is float32.

    CUDA tensors launch the kernel, which reads them in place through
    their strides, with query tiles of ``block_t`` rows (one of
    ``BT_TILES``; by default `gpu_bridge.select_ssd_block` for this grid
    and card); CPU tensors take the plain version."""
    global launches
    if block_t is not None and block_t not in BT_TILES:
        raise ValueError(f"block_t {block_t} outside the kernel's tile set "
                         f"{BT_TILES}")
    if c.dim() != 5 or s.dim() != 4:
        raise ValueError(f"c {tuple(c.shape)} / s {tuple(s.shape)} are not "
                         f"(B, NC, Q, H, N) / (B, NC, Q, H)")
    bsz, nc, q, h, n = c.shape
    p = x.shape[-1]
    if b.shape != c.shape or s.shape != (bsz, nc, q, h) or \
            dt.shape != s.shape or x.shape != (bsz, nc, q, h, p):
        raise ValueError(f"c {tuple(c.shape)}, b {tuple(b.shape)}, "
                         f"s {tuple(s.shape)}, dt {tuple(dt.shape)}, "
                         f"x {tuple(x.shape)} do not match")
    tensors = (c, b, s, dt, x)
    if any(t.dtype not in DTYPES for t in tensors) or \
            len({t.dtype for t in tensors}) != 1:
        raise TypeError(f"ssd_scan takes float32 or bfloat16 operands of "
                        f"one dtype, got {[t.dtype for t in tensors]}")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return ssd_intra_chunk_ref(c, b, s, dt, x)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if not (1 <= n <= MAX_DIM and 1 <= p <= MAX_DIM):
        raise ValueError(f"N = {n}, P = {p} outside 1..{MAX_DIM}")
    # the kernel reads the last dim of c, b and x contiguously
    c, b, x = (t if t.stride(-1) == 1 else t.contiguous() for t in (c, b, x))
    y = torch.empty((bsz, nc, q, h, p), dtype=x.dtype, device=device)
    if y.numel() == 0:
        return y
    if block_t is None:
        from repro_torch.core.gpu_bridge import device_sms, select_ssd_block
        block_t = select_ssd_block(bsz * nc * h, q, n_sms=device_sms())
    strides = (ctypes.c_longlong * 24)(*(
        _strides4(c) + _strides4(b) + _strides4(s) + _strides4(dt) +
        _strides4(x) + _strides4(y)))
    err = _launcher()(
        c.data_ptr(), b.data_ptr(), s.data_ptr(), dt.data_ptr(),
        x.data_ptr(), y.data_ptr(), bsz, nc, q, h, n, p,
        ctypes.addressof(strides), int(x.dtype == torch.bfloat16), block_t,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    launches += 1
    return y


def ssd_intra_chunk_bh(c: torch.Tensor, b: torch.Tensor, s: torch.Tensor,
                       dt: torch.Tensor, x: torch.Tensor, *,
                       block_t: int | None = None) -> torch.Tensor:
    """c, b: (BCH, Q, N); s, dt: (BCH, Q); x: (BCH, Q, P) -> (BCH, Q, P).
    BCH = batch * n_chunks * heads, the reference's flattened grid; each
    cell is read as a (B=BCH, NC=1, Q, H=1) view."""
    if c.dim() != 3 or s.dim() != 2 or x.dim() != 3:
        raise ValueError(f"c {tuple(c.shape)}, s {tuple(s.shape)}, "
                         f"x {tuple(x.shape)} are not (BCH, Q, .)")
    y = ssd_intra_chunk_bcqh(c[:, None, :, None], b[:, None, :, None],
                             s[:, None, :, None], dt[:, None, :, None],
                             x[:, None, :, None], block_t=block_t)
    return y[:, 0, :, 0]
