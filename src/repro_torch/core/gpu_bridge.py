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
    count (matmul_int8 keeps a ring of 3) must fit what one CTA may opt
    into, in place of the pipelined (doubled) working set against VMEM.
    The int32 / f32 accumulators live in registers on the GPU, not in the
    on-chip buffer;
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
    it so each op spans several CTAs. The budget is the smaller of the
    kernel's opt-in ceiling and the card's (``device_smem_bytes``) unless
    ``smem_bytes`` is given. Every tile of the set fits an H100's with its
    whole ring (128^3: 3 x 32 KB), so the halving acts only when
    ``smem_bytes`` asks for less.
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
    budget = min(mm_kernel.SMEM_LIMIT, device_smem_bytes()
                 if smem_bytes is None else smem_bytes)
    return fit_blocks(bm, bk, bn, budget)


def fit_blocks(bm: int, bk: int, bn: int, budget: int) -> tuple[int, int, int]:
    """eq. 9 per CTA: halve the largest of (bm, bk, bn) within its tile set
    until the kernel's ring (``STAGES`` x ``smem_bytes``) fits ``budget``
    bytes; blocks that fit come back unchanged."""
    tiles_m, tiles_k, tiles_n = (mm_kernel.BM_TILES, mm_kernel.BK_TILES,
                                 mm_kernel.BN_TILES)
    while mm_kernel.STAGES * mm_kernel.smem_bytes(bm, bk, bn) > budget:
        if bm >= max(bk, bn) and bm > min(tiles_m):
            bm = _smaller(tiles_m, bm)
        elif bk >= bn and bk > min(tiles_k):
            bk = _smaller(tiles_k, bk)
        elif bn > min(tiles_n):
            bn = _smaller(tiles_n, bn)
        else:
            break
    return bm, bk, bn


#: block_k of a decode step (seq_q = 1) by the operands' bytes per element:
#: the bk that measured fastest on path A's decode shape (glm4-9b
#: decode_32k: b 128, Lk 512, 32 heads of 128) in `chip_smoke.py`'s bk
#: sweep, in both of two runs on an NVIDIA H100 80GB HBM3 at 700 W (ms per
#: call, run 1 / run 2; PERF.md, Findings):
#:   float32   bk 32: 0.7263 / 0.7170, bk 64: 0.7321 / 0.7153,
#:             bk 128: 0.7210 / 0.7069;
#:   bfloat16  bk 32: 0.4162 / 0.4138, bk 64: 0.3786 / 0.3702,
#:             bk 128: 0.3852 / 0.3780.
DECODE_BLOCK_K = {4: 128, 2: 64}


def select_flash_blocks(seq_q: int, seq_k: int, head_dim: int, *,
                        bytes_el: int = 4,
                        smem_bytes: int | None = None) -> tuple[int, int]:
    """(block_q, block_k) for the flash_attention kernels.

    Decode (seq_q = 1) takes block_q = 1, the decode kernel, at
    ``DECODE_BLOCK_K[bytes_el]`` whatever seq_k and head_dim. That kernel
    stages no K or V tile, so the TPU's fewest-steps objective says nothing
    there: bk only sets how many keys each warp keeps in flight (bk / 16)
    against how many CTAs fit an SM, and the rule is the measured fastest.

    Prefill takes the tiled kernel's tile with the fewest (q-tile,
    KV-tile) steps whose shared memory times the stage count fits one CTA
    — the degenerate (single-level) instance of eq. 9, counting K and V in
    ``bytes_el`` bytes, the dtype the kernel is given; ties go to the
    least masked tail.
    """
    if not 1 <= head_dim <= flash_kernel.MAX_HEAD_DIM:
        raise ValueError(f"head dim {head_dim} outside the kernel's "
                         f"1..{flash_kernel.MAX_HEAD_DIM}")
    budget = device_smem_bytes() if smem_bytes is None else smem_bytes
    if seq_q == 1:
        if bytes_el not in DECODE_BLOCK_K:
            raise ValueError(f"the decode kernel takes 4- or 2-byte "
                             f"operands, not {bytes_el}")
        bk = DECODE_BLOCK_K[bytes_el]
        need = flash_kernel.smem_bytes(1, bk, head_dim, bytes_el)
        if need > budget:
            raise ValueError(f"the decode kernel's {need} bytes of shared "
                             f"memory exceed {budget}")
        return 1, bk
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
