"""MIREDO -> GPU bridge: kernel block shapes from a solved CIM mapping,
over the H100's memory hierarchy (device memory -> shared memory ->
registers). The counterpart of the reference's `core/tpu_bridge.py` for
the two functions the measured-execution backend calls.

What changes from the TPU bridge:
  * legality: the TPU's lane/sublane alignment (multiples of 128 and 8)
    becomes membership in the tile set the CUDA kernel instantiates
    (powers of two, `kernels/*/kernel.py`). The kernels mask ragged tails,
    so a block need not divide its dim and nothing is padded;
  * eq. (9) capacity: a block's shared memory, the kernel's whole ring
    included (`kernel.smem_bytes`; matmul_int8 keeps a ring of 3), must
    fit what one CTA may opt into, in place of the pipelined (doubled)
    working set against VMEM. The int32 / f32 accumulators live in
    registers on the GPU, not in the on-chip buffer;
  * the shared-memory default is the H100's (below), never the TPU's VMEM.

The bridge MIP (`select_matmul_blocks`) re-instantiates the paper's
formulation over this hierarchy for the matmul_int8 kernel. As in the
reference it stays off the measured-execution path: the executor takes
the mapping-derived blocks (`select_blocks_from_mapping`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.mip.model import LinExpr, MipModel
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.matmul_int8 import kernel as mm_kernel
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.launch.mesh import HBM_BW, PEAK_INT8_OPS

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
    kernel's shared memory, its ring included, fits one CTA (eq. 9).

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
    until the kernel's shared memory (``smem_bytes``, the whole ring) fits
    ``budget`` bytes; blocks that fit come back unchanged."""
    tiles_m, tiles_k, tiles_n = (mm_kernel.BM_TILES, mm_kernel.BK_TILES,
                                 mm_kernel.BN_TILES)
    while mm_kernel.smem_bytes(bm, bk, bn) > budget:
        if bm >= max(bk, bn) and bm > min(tiles_m):
            bm = _smaller(tiles_m, bm)
        elif bk >= bn and bk > min(tiles_k):
            bk = _smaller(tiles_k, bk)
        elif bn > min(tiles_n):
            bn = _smaller(tiles_n, bn)
        else:
            break
    return bm, bk, bn


@dataclasses.dataclass
class BlockChoice:
    """A matmul_int8 tile from the bridge MIP: the blocks, whether the
    operand ring overlaps loads with the tensor cores (always, see
    `select_matmul_blocks`), the model's time at the pick, the CTA's
    shared memory and the solver's status (``"fallback"`` when it
    failed)."""
    bm: int
    bk: int
    bn: int
    double_buffered: bool
    est_seconds: float
    smem_bytes: int
    status: str


def matmul_traffic(m: int, k: int, n: int, bm: int, bn: int) -> int:
    """Device-memory bytes of one (m, k, n) matmul_int8 at (bm, bn): the
    reference's weight-reload model. x is read once per column of tiles
    (ceil(n / bn) times), w once per row of tiles (ceil(m / bm) times),
    the 4-byte output written once."""
    return m * k * math.ceil(n / bn) + k * n * math.ceil(m / bm) + 4 * m * n


def matmul_seconds(m: int, k: int, n: int, bm: int, bn: int) -> float:
    """The model's time of one call: loads overlap the tensor cores (the
    kernel's ring), so the larger of the traffic over ``HBM_BW`` and the
    2mnk operations over ``PEAK_INT8_OPS``."""
    return max(matmul_traffic(m, k, n, bm, bn) / HBM_BW,
               2.0 * m * n * k / PEAK_INT8_OPS)


def tile_order(m: int, k: int, n: int) -> list[tuple[int, int, int]]:
    """Every (bm, bk, bn) of the kernel's tile set, in the order that
    breaks the model's ties (bk enters no traffic term, and many tiles
    share a reload count): least tensor-core work issued with the masked
    tails, then the fewest K steps, then the least shared memory."""
    def key(t):
        bm, bk, bn = t
        work = (math.ceil(m / bm) * bm) * (math.ceil(n / bn) * bn) * \
            (math.ceil(k / bk) * bk)
        return work, math.ceil(k / bk), mm_kernel.smem_bytes(bm, bk, bn), t
    return sorted(((bm, bk, bn) for bm in mm_kernel.BM_TILES
                   for bk in mm_kernel.BK_TILES
                   for bn in mm_kernel.BN_TILES), key=key)


#: Weight of one step of `tile_order` in the MIP's objective, in units of
#: the compulsory time (every operand read once): small enough that the
#: 36 steps never outweigh a reload, large enough to clear the solver's
#: absolute gap (1e-6).
TIE_WEIGHT = 1e-5


def matmul_objective(m: int, k: int, n: int, bm: int, bk: int,
                     bn: int) -> float:
    """What `select_matmul_blocks` minimises at one tile: the model's time
    in units of the compulsory time, plus ``TIE_WEIGHT`` per step of
    `tile_order`."""
    unit = (m * k + k * n + 4 * m * n) / HBM_BW
    rank = tile_order(m, k, n).index((bm, bk, bn))
    return matmul_seconds(m, k, n, bm, bn) / unit + TIE_WEIGHT * rank


def select_matmul_blocks(m: int, k: int, n: int, *,
                         smem_bytes: int = SMEM_BYTES,
                         time_limit_s: float = 5.0) -> BlockChoice:
    """MIP block-shape selection for the matmul_int8 kernel: the
    reference's `tpu_bridge.select_matmul_blocks` over the H100's
    hierarchy.

        min  T + TIE_WEIGHT * rank(bm, bk, bn)
        s.t. T >= t_mem = traffic(bm, bn) / HBM_BW        (Table III,
             T >= t_tc  = 2mnk / PEAK_INT8_OPS              overlapped row)
             smem_bytes(bm, bk, bn) <= smem_bytes          (eq. 9)

    Each block dimension is a one-hot over the tile set the kernel
    instantiates (``BM_TILES``, ``BK_TILES``, ``BN_TILES``), in place of
    the reference's lane / sublane alignment: the kernel masks ragged
    tails, so a tile need not divide its dimension and nothing is padded.
    One binary per (bm, bk, bn), tied to the three one-hots, carries the
    terms that are not separable: the shared memory and the tie order.

    Capacity (eq. 9) counts the kernel's whole 3-stage ``cp.async`` ring
    (`mm_kernel.smem_bytes`); the int32 accumulator lives in registers.
    The reference's psi^DM binary doubles the working set when loads
    overlap compute; the kernel always runs its ring, so that choice is
    fixed: the capacity is the ring's, the Table III row is the
    overlapped one (T >= t_mem, T >= t_tc) and ``double_buffered`` is
    reported True. A single-buffered row would describe a kernel that
    does not exist.

    Traffic is the reference's weight-reload model (`matmul_traffic`).
    Times are in units of the compulsory time (every operand read once)
    so that the solver's tolerances are relative to the problem. Ties
    (bk enters no time term) go by `tile_order`. A failed solve returns
    the smallest tile of the set with ``status="fallback"``, as the
    reference returns its default block.
    """
    if min(m, k, n) < 1:
        raise ValueError(f"matmul ({m}, {k}, {n}) has an empty dimension")
    cm, ck, cn = mm_kernel.BM_TILES, mm_kernel.BK_TILES, mm_kernel.BN_TILES
    order = tile_order(m, k, n)
    unit = (m * k + k * n + 4 * m * n) / HBM_BW
    mdl = MipModel("gpu-matmul-blocks")
    vm = mdl.add_one_hot("bm", len(cm))
    vk = mdl.add_one_hot("bk", len(ck))
    vn = mdl.add_one_hot("bn", len(cn))
    z = mdl.add_choice("tile", order)
    for (bm, bk, bn), v in z.items():
        mdl.add_le(v - vm[cm.index(bm)], 0.0)
        mdl.add_le(v - vk[ck.index(bk)], 0.0)
        mdl.add_le(v - vn[cn.index(bn)], 0.0)
    mdl.add_le(sum((float(mm_kernel.smem_bytes(*t)) * v
                    for t, v in z.items()), LinExpr({}, 0.0)),
               float(smem_bytes))
    traffic = LinExpr({}, float(4 * m * n))
    for c, v in zip(cn, vn):
        traffic = traffic + float(m * k * math.ceil(n / c)) * v
    for c, v in zip(cm, vm):
        traffic = traffic + float(k * n * math.ceil(m / c)) * v
    t = mdl.add_var("T", 0.0, math.inf)
    mdl.add_ge(t - traffic * (1.0 / (HBM_BW * unit)), 0.0)
    mdl.add_ge(t, 2.0 * m * n * k / PEAK_INT8_OPS / unit)
    mdl.minimize(t + sum((TIE_WEIGHT * r * z[tile]
                          for r, tile in enumerate(order)),
                         LinExpr({}, 0.0)))
    sol = mdl.solve(time_limit_s=time_limit_s, mip_rel_gap=0.0)
    if not sol.ok:
        bm, bk, bn = min(cm), min(ck), min(cn)
        return BlockChoice(bm, bk, bn, True, math.nan,
                           mm_kernel.smem_bytes(bm, bk, bn), "fallback")
    bm, bk, bn = max(z, key=lambda tile: sol[z[tile]])
    return BlockChoice(bm, bk, bn, True, sol[t] * unit,
                       mm_kernel.smem_bytes(bm, bk, bn), sol.status.name)


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


#: Largest KV tile the prefill pick takes; see `select_flash_blocks`.
PREFILL_MAX_BK = 64

#: Streaming multiprocessors of an H100 SXM.
SMS = 132


def device_sms() -> int:
    """Streaming multiprocessors of the card when a CUDA device is
    present, else the H100's."""
    if not torch.cuda.is_available():
        return SMS
    return torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count


def select_flash_blocks(seq_q: int, seq_k: int, head_dim: int, *,
                        bytes_el: int = 4, smem_bytes: int | None = None,
                        batch_heads: int | None = None,
                        n_sms: int | None = None) -> tuple[int, int]:
    """(block_q, block_k) for the flash_attention kernels.

    Decode (seq_q = 1) takes block_q = 1, the decode kernel, at
    ``DECODE_BLOCK_K[bytes_el]`` whatever seq_k and head_dim. That kernel
    stages no K or V tile, so the TPU's fewest-steps objective says nothing
    there: bk only sets how many keys each warp keeps in flight (bk / 16)
    against how many CTAs fit an SM, and the rule is the measured fastest.

    Prefill runs the prefill kernel on one of its (bq, bk) tiles, bq >= 16,
    and needs ``batch_heads`` (B * H) and the card's ``n_sms``. Among the
    tiles of bk <= ``PREFILL_MAX_BK`` whose CTA (`kernel.smem_bytes`: the q
    tile and the KV ring in ``bytes_el`` bytes) fits the budget, it takes
    the fewest (q-tile, KV-tile) steps; ties go to the least masked tail.
    When that tile's grid, ``batch_heads * ceil(seq_q / bq)`` CTAs, fills
    less than half of ``n_sms``, it takes the largest bq whose grid fills
    half (then the fewest steps). So on an H100 a prefill of 33 rows or
    more runs 64 x 64 unless its grid is that small.

    Read off `chip_smoke.py`'s prefill sweep (every tile, causal; ms in
    two runs, run 1 / run 2, on an NVIDIA H100 80GB HBM3 at 700 W;
    PERF.md, Findings). bk 128 loses wherever it fits two CTAs as well
    (bfloat16), so the cap is not a shared-memory limit:
      (b, L, h, hd) (1, 4096, 32, 128): 64 x 64 the fastest, float32
        1.7750 / 1.7584, bfloat16 0.6815 / 0.6813; 64 x 128 (one resident
        CTA in float32, two in bfloat16) 2.1506 / 2.1483 and 0.7631 /
        0.7745;
      (2, 264, 8, 128), 80 CTAs at bq 64: 64 x 64 the fastest, float32
        0.0325 / 0.0325, bfloat16 0.0175 / 0.0174; 32 x 64 (144 CTAs)
        0.0360 / 0.0362 and 0.0192 / 0.0194;
      (1, 64, 36, 64), 36 CTAs at bq 64: 32 x 64 (72 CTAs) the fastest,
        float32 0.0101 / 0.0101, bfloat16 0.0089 / 0.0087; 64 x 64
        0.0107 / 0.0109 and 0.0095 / 0.0093;
      (1, 128 | 256 | 512, 36, 64): float32 64 x 64 the fastest at 128
        (0.0130 / 0.0132) and 256 (0.0196 / 0.0197); at 512 64 x 128
        0.0360 / 0.0363 against 64 x 64's 0.0368 / 0.0367 (+2.1 / +1.2 %,
        the float32 cell the rule misses; bk 128 loses 7-8 % at 128 and
        256). bfloat16 64 x 64 the fastest at 512; 32 x 64 (144 and 288
        CTAs) beats it at 128 by 3.8 / 1.7 % and at 256 by 5.0 / 5.3 %.
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
    if batch_heads is None or n_sms is None:
        raise ValueError("a prefill pick needs batch_heads (B * H) and "
                         "n_sms")
    fits = [(bq, bk) for bq in flash_kernel.BQ_TILES if bq > 1
            for bk in flash_kernel.BK_TILES if bk <= PREFILL_MAX_BK and
            flash_kernel.smem_bytes(bq, bk, head_dim, bytes_el) <= budget]
    if not fits:
        raise ValueError(f"no flash tile fits {budget} bytes of shared "
                         f"memory at head dim {head_dim}")

    def steps(tile):
        nq, nk = math.ceil(seq_q / tile[0]), math.ceil(seq_k / tile[1])
        return nq * nk, nq * tile[0] + nk * tile[1]

    def grid(tile):
        return batch_heads * math.ceil(seq_q / tile[0])
    best = min(fits, key=steps)
    fills = [t for t in fits if grid(t) >= n_sms / 2]
    if fills and grid(best) < n_sms / 2:
        best = min(fills, key=lambda t: (-t[0], steps(t)))
    return best


def select_ssd_block(cells: int, seq_q: int, *, n_sms: int) -> int:
    """Query-tile rows ``bt`` of the ssd_scan kernel for ``cells``
    (batch * chunks * heads) cells of ``seq_q`` rows on a card of
    ``n_sms`` SMs: the largest bt of ``BT_TILES`` whose grid,
    ``cells * ceil(seq_q / bt)`` CTAs, fills half of ``n_sms``, else the
    smallest. A smaller tile puts more CTAs on a cell and splits each
    CTA's keys over more key groups, so a CTA's products shrink while the
    keys it loads do not, and the cell's keys are read once per tile: it
    pays only where the card would stand half idle.

    Read off `chip_smoke.py`'s ssd sweep (`SSD_SWEEP`, every bt; ms of two
    runs, run 1 / run 2, on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md,
    Findings), as (b, nc, Q, h, N, P):
      (1, 1, 256, 1, 128, 64), 4 CTAs at bt 64: bt 16 the fastest, float32
        0.0145 / 0.0139 (bt 32 0.0156 / 0.0160, bt 64 0.0179 / 0.0183),
        bfloat16 0.0128 / 0.0130 (0.0131 / 0.0131, 0.0160 / 0.0152);
      (1, 1, 64, 1, 128, 64), one CTA at bt 64: bt 16 float32 0.0095 /
        0.0095, +8 % on bt 32 (0.0088 / 0.0089), bt 64 0.0107 / 0.0109;
        bfloat16 bt 16 the fastest, 0.0077 / 0.0078;
      (1, 4, 256, 3, 128, 64), 96 CTAs at bt 32: float32 bt 32 the
        fastest, 0.0160 / 0.0159; bfloat16 bt 16 0.0136 / 0.0138 against
        bt 32's 0.0138 in run 2;
      (1, 128, 256, 64, 128, 64), 32,768 CTAs at bt 64: bt 64 the
        fastest, float32 1.7619 / 1.7636 (bt 16 3.662), bfloat16 0.9684 /
        0.9690 (bt 16 1.739).
    """
    if cells < 1 or seq_q < 1 or n_sms < 1:
        raise ValueError(f"cells {cells}, seq_q {seq_q}, n_sms {n_sms} "
                         f"must be positive")
    for bt in sorted(ssd_kernel.BT_TILES, reverse=True):
        if cells * math.ceil(seq_q / bt) >= n_sms / 2:
            return bt
    return min(ssd_kernel.BT_TILES)
