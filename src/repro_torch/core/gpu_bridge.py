"""MIREDO -> GPU bridge: kernel block shapes from a solved CIM mapping,
over the H100's memory hierarchy (device memory -> shared memory ->
registers). The counterpart of the reference's `core/tpu_bridge.py` for
the two functions the measured-execution backend calls.

What changes from the TPU bridge:
  * legality: the TPU's lane/sublane alignment (multiples of 128 and 8)
    becomes membership in the tile set the CUDA kernel instantiates
    (powers of two, `kernels/*/kernel.py`). The kernels mask ragged tails,
    so a block need not divide its dim and nothing is padded;
  * eq. (9) capacity: a block's shared memory times the kernel's stage
    count must fit what one CTA may use, in place of the pipelined
    (doubled) working set against VMEM. The int32 / f32 accumulators live
    in registers on the GPU, not in the on-chip buffer;
  * the shared-memory default is the H100's (below), never the TPU's VMEM.

The bridge MIP (`select_matmul_blocks`) is off the measured-execution
path and is not ported yet.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.matmul_int8 import kernel as mm_kernel

#: Shared memory one CTA can use on an H100 (227 KB of the SM's 256 KB,
#: as dynamic shared memory after opting in).
SMEM_BYTES = 232_448


def device_smem_bytes() -> int:
    """Shared memory a CTA can opt into: the card's own figure when a CUDA
    device is present, else the H100's."""
    if not torch.cuda.is_available():
        return SMEM_BYTES
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return int(getattr(props, "shared_memory_per_block_optin", SMEM_BYTES))


def _snap(hint: int, dim: int, tiles, cap: int) -> int:
    """The smallest tile that covers ``min(hint, dim)`` (a block past the
    dim only adds masked work), among tiles no larger than ``cap``; the
    largest such tile when none covers it."""
    allowed = [t for t in tiles if t <= cap] or [min(tiles)]
    covering = [t for t in allowed if t >= min(hint, dim)]
    return min(covering) if covering else max(allowed)


def _smaller(tiles, t: int) -> int:
    below = [x for x in tiles if x < t]
    return max(below) if below else t


def select_blocks_from_mapping(mapping, layer, arch, *,
                               smem_bytes: int | None = None,
                               cap: int = 128) -> tuple[int, int, int]:
    """Translate a solved MIREDO mapping into matmul_int8 blocks
    ``(bm, bk, bn)``.

    The measured-execution backend (`core/executor.py`) runs each optimized
    GEMM on kernels/matmul_int8; the block shapes come from the mapping the
    MIP actually chose: a dim's on-chip tile extent — spatial unrolls plus
    every temporal factor that *all* operands indexing the dim hold above
    DRAM — is the working set MIREDO decided to keep resident, i.e. the CIM
    analogue of a CTA's tile. Each extent is snapped to the kernel's tile
    set and clamped by ``cap``; the blocks are then halved until the
    kernel's shared memory times its stage count fits one CTA (eq. 9).

    ``cap`` bounds every block dim; the measured-execution backend lowers
    it so each op spans several CTAs. The kernel's tiles are static shared
    memory (at most 48 KB), which every tile of its set fits in one stage,
    so the halving acts only when ``smem_bytes`` asks for less.
    """
    from repro_torch.core import workload as wl

    m, k, n = layer.bound("N"), layer.bound("C"), layer.bound("K")
    hints = {d: 1 for d in ("N", "C", "K")}
    for ax in arch.spatial:
        for d, f in mapping.spatial.get(ax.name, ()):
            if d in hints:
                hints[d] *= f
    for i, (d, f) in enumerate(mapping.temporal):
        if d in hints and all(
                mapping.level_of[lam][i] >= 1
                for lam in mapping.level_of if wl.is_relevant(d, lam)):
            hints[d] *= f
    tiles_m, tiles_k, tiles_n = (mm_kernel.BM_TILES, mm_kernel.BK_TILES,
                                 mm_kernel.BN_TILES)
    bm = _snap(hints["N"], m, tiles_m, cap)
    bk = _snap(hints["C"], k, tiles_k, cap)
    bn = _snap(hints["K"], n, tiles_n, cap)
    budget = mm_kernel.SMEM_LIMIT if smem_bytes is None else \
        min(mm_kernel.SMEM_LIMIT, smem_bytes)
    while mm_kernel.STAGES * mm_kernel.smem_bytes(bm, bk, bn) > budget:
        # eq. 9 per CTA
        if bm >= max(bk, bn) and bm > min(tiles_m):
            bm = _smaller(tiles_m, bm)
        elif bk >= bn and bk > min(tiles_k):
            bk = _smaller(tiles_k, bk)
        elif bn > min(tiles_n):
            bn = _smaller(tiles_n, bn)
        else:
            break
    return bm, bk, bn


def select_flash_blocks(seq_q: int, seq_k: int, head_dim: int, *,
                        bytes_el: int = 4,
                        smem_bytes: int | None = None) -> tuple[int, int]:
    """(block_q, block_k) from the kernel's tile set with the fewest
    (q-tile, KV-tile) steps whose shared memory times the stage count fits
    one CTA — the degenerate (single-level) instance of eq. 9, counting K
    and V in ``bytes_el`` bytes, the dtype the kernel is given. Ties go to
    the least masked tail, so a decode step (seq_q = 1) takes block_q = 1.
    """
    if not 1 <= head_dim <= flash_kernel.MAX_HEAD_DIM:
        raise ValueError(f"head dim {head_dim} outside the kernel's "
                         f"1..{flash_kernel.MAX_HEAD_DIM}")
    budget = device_smem_bytes() if smem_bytes is None else smem_bytes
    best, best_key = None, None
    for bq in flash_kernel.BQ_TILES:
        for bk in flash_kernel.BK_TILES:
            ws = flash_kernel.smem_bytes(bq, bk, head_dim, bytes_el)
            if flash_kernel.STAGES * ws > budget:
                continue
            nq, nk = math.ceil(seq_q / bq), math.ceil(seq_k / bk)
            key = (nq * nk, nq * bq + nk * bk)
            if best_key is None or key < best_key:
                best, best_key = (bq, bk), key
    if best is None:
        raise ValueError(f"no flash tile fits {budget} bytes of shared "
                         f"memory at head dim {head_dim}")
    return best
