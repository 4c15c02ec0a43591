"""Analytical latency model (paper §IV-D, Table III) — direct evaluator.

This module is the *semantic oracle*: the MIP in ``formulation.py`` encodes
exactly this recursion with big-M row selection, the heuristic baselines call
it directly, and ``simulator.py`` validates it event-by-event (Fig. 4(a)).

Recursion, innermost MVM upward (i = temporal slot index, λ = operand):

    L_{imax+1} = P_{imax+1,λ} = L_MVM                      (boundary)
    L_i  = max( L_{i+1} * N_{i+1},  max_λ combined(i, λ) )
    combined = P_{i+1,λ}                    (no transfer at this slot)
             | T_{i,λ} + P_{i+1,λ}          (single-buffered transfer)
             | max(T_{i,λ}, P_{i+1,λ})      (double-buffered transfer)
    P_{i,λ} = Table III row (single/double × I,W / O, or no-transfer)
    total   = max_λ P_{0,λ} + one-time fills

Transfer placement: slot i carries a transfer for λ iff its dim is relevant
to λ (otherwise the operand is *data-stationary* across the slot: "incurs no
transfer latency") and some used level lies below the slot's level. The chunk
is B^T of the slot's level; weight transfers whose destination is the CIM
macro pay ``mode_switch_cycles`` on top (Memory-mode reload, Fig. 2(a)) and
are never overlapped.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import workload as wl
from repro_torch.core.arch import CimArch, INPUT, MeshLink, OPERANDS, OUTPUT, WEIGHT
from repro_torch.core.mapping import Mapping, SizeContext


@dataclasses.dataclass
class SlotInfo:
    dim: str
    n: int
    level: dict[str, int]
    transfer: dict[str, float]      # T_{i,λ} in cycles (0 = no transfer)
    double: dict[str, bool]         # psi^DL_{i,λ}


@dataclasses.dataclass
class LatencyReport:
    total_cycles: float
    p0: dict[str, float]
    one_time_cycles: float
    slots: list[SlotInfo]
    l_path: list[float]             # L_i per slot
    spatial_util: float             # used PE lanes / physical lanes
    temporal_util: float            # ideal busy cycles / total cycles
    macs: int

    @property
    def ideal_cycles(self) -> float:
        return self.total_cycles * self.temporal_util


def _hop_cycles(mapping: Mapping, layer: wl.Layer, arch: CimArch,
                operand: str, m_src: int, m_dst: int | None,
                ctx: SizeContext | None = None) -> float:
    """Eq. (11) for one hop: chunk bytes / source-level effective bandwidth,
    plus the Memory-mode switch penalty for weight reloads into the macro."""
    if ctx is not None:
        chunk = ctx.transfer_bytes(operand, m_src)
        bw = ctx.eff_bw_bytes(m_src)
    else:
        chunk = mapping.transfer_bytes(layer, operand, arch, m_src)
        bw = mapping.eff_bw_bytes(arch, m_src)
    t = math.ceil(chunk / bw)
    if operand == WEIGHT and m_dst == arch.macro_level:
        t += arch.mode_switch_cycles
    return float(t)


def transfer_cycles(mapping: Mapping, layer: wl.Layer, arch: CimArch,
                    operand: str, slot: int) -> float:
    """T_{i,λ} per eq. (11) for the slot's source level."""
    m = mapping.level_of[operand][slot]
    return _hop_cycles(mapping, layer, arch, operand, m,
                       mapping.next_used_below(operand, m))


def operand_transfer_table(mapping: Mapping, layer: wl.Layer, arch: CimArch,
                           operand: str,
                           ctx: SizeContext | None = None) -> dict[int, float]:
    """T cycles keyed by *source* level, for every hop of the operand's
    used-level chain (plus the initial DRAM hop under key 0 when level 0
    holds no slots for the operand). T_{i,λ} depends on the slot only
    through its level, so this table — computed once per (mapping, operand)
    — is the single source of truth the scalar slot analysis, the one-time
    fill accounting and the batched packer (`latency_batched.py`) all read."""
    used = mapping.used_levels(operand)
    table: dict[int, float] = {}
    for m_prev, m_dst in zip(used, used[1:]):
        table[m_prev] = _hop_cycles(mapping, layer, arch, operand,
                                    m_prev, m_dst, ctx)
    if used and used[0] != 0:
        table[0] = _hop_cycles(mapping, layer, arch, operand, 0, used[0], ctx)
    return table


def analyze_slots(mapping: Mapping, layer: wl.Layer, arch: CimArch,
                  tables: dict[str, dict[int, float]] | None = None
                  ) -> list[SlotInfo]:
    if tables is None:
        tables = {lam: operand_transfer_table(mapping, layer, arch, lam)
                  for lam in OPERANDS}
    dest_of = {lam: {m: mapping.next_used_below(lam, m)
                     for m in mapping.used_levels(lam)}
               for lam in OPERANDS}
    slots = []
    for i, (dim, n) in enumerate(mapping.temporal):
        level = {lam: mapping.level_of[lam][i] for lam in OPERANDS}
        transfer, double = {}, {}
        for lam in OPERANDS:
            m = level[lam]
            dest = dest_of[lam][m]
            has = wl.is_relevant(dim, lam) and dest is not None
            transfer[lam] = tables[lam][m] if has else 0.0
            dbl = has and mapping.is_double_buffered(lam, dest, arch)
            if lam == WEIGHT and dest == arch.macro_level:
                dbl = False  # mode exclusivity
            double[lam] = dbl
        slots.append(SlotInfo(dim, n, level, transfer, double))
    return slots


def _row(operand: str, t: float, dbl: bool, l_i: float, n: float,
         p_inner: float) -> float:
    """Table III, verbatim rows with coefficients clamped at >= 0."""
    c = lambda x: max(x, 0.0)
    if t == 0.0:
        return l_i * c(n - 1) + p_inner
    if not dbl:
        if operand in (INPUT, WEIGHT):
            return l_i * c(n - 2) + 2 * t + p_inner
        return l_i * c(n - 1) + 2 * t + p_inner
    if operand in (INPUT, WEIGHT):
        return max(l_i * c(n - 3) + 2 * t + max(t, p_inner), t * n)
    return l_i * c(n - 2) + t + max(t, l_i) + max(t, p_inner)


def operand_fill_hops(mapping: Mapping, layer: wl.Layer, arch: CimArch,
                      operand: str,
                      table: dict[int, float] | None = None
                      ) -> list[tuple[bool, float]]:
    """Per hop of the operand's used-level chain, ``(triggered, cycles)``.

    A hop is *triggered* when some relevant temporal slot at or above its
    source level re-runs it inside the loop nest (charged by the Table III
    recursion); untriggered hops are one-time fills charged on top by
    ``evaluate``. The initial DRAM hop (when level 0 holds no slots for the
    operand) is by construction never triggered. The weight chain with NO
    triggered hop is the scheduler's residency condition
    (`scheduler.weight_residency`), so this is the single source of truth
    for both accountings."""
    used = mapping.used_levels(operand)
    n = mapping.n_slots()
    if table is None:
        table = operand_transfer_table(mapping, layer, arch, operand)
    hops: list[tuple[bool, float]] = []
    for m_prev in used[:-1]:
        triggered = any(
            wl.is_relevant(mapping.temporal[i][0], operand)
            and mapping.level_of[operand][i] <= m_prev
            for i in range(n))
        hops.append((triggered, table[m_prev]))
    if used and used[0] != 0:
        hops.append((False, table[0]))
    return hops


def evaluate(mapping: Mapping, layer: wl.Layer,
             arch: CimArch) -> LatencyReport:
    slots = analyze_slots(mapping, layer, arch)
    n_slots = len(slots)
    l_mvm = float(arch.l_mvm_cycles)

    l_next = l_mvm                      # L_{i+1}
    n_next = 1.0                        # N_{i+1}
    p_next = {lam: l_mvm for lam in OPERANDS}
    l_path = [0.0] * n_slots

    for i in range(n_slots - 1, -1, -1):
        s = slots[i]
        combined = 0.0
        for lam in OPERANDS:
            t = s.transfer[lam]
            if t == 0.0:
                combined = max(combined, p_next[lam])
            elif s.double[lam]:
                combined = max(combined, max(t, p_next[lam]))
            else:
                combined = max(combined, t + p_next[lam])
        l_i = max(l_next * n_next, combined)
        l_path[i] = l_i
        p_cur = {lam: _row(lam, s.transfer[lam], s.double[lam], l_i,
                           float(s.n), p_next[lam]) for lam in OPERANDS}
        l_next, n_next, p_next = l_i, float(s.n), p_cur

    # One-time fills: operand hops never triggered by any relevant temporal
    # slot above the destination (fully-stationary tiles loaded once). The
    # chain includes the initial DRAM hop when level 0 holds no slots for λ
    # — charged at B^T_0 (full multicast traffic, source precision),
    # identical to the MIP's OTC for the DRAM hop.
    one_time = 0.0
    for lam in OPERANDS:
        one_time += sum(t for triggered, t in
                        operand_fill_hops(mapping, layer, arch, lam)
                        if not triggered)

    total = max(p_next.values()) + one_time

    phys = math.prod(ax.size for ax in arch.spatial)
    used_lanes = math.prod(
        mapping.spatial_extent(ax.name) for ax in arch.spatial)
    spatial_util = used_lanes / phys
    temporal_iters = math.prod(f for _, f in mapping.temporal)
    ideal = temporal_iters * l_mvm
    return LatencyReport(
        total_cycles=total,
        p0=p_next,
        one_time_cycles=one_time,
        slots=slots,
        l_path=l_path,
        spatial_util=spatial_util,
        temporal_util=min(1.0, ideal / max(total, 1e-9)),
        macs=layer.macs,
    )


# ---------------------------------------------------------------------------
# Inter-chip link transfer terms (mesh extension, DESIGN.md §Mesh optimization)
# ---------------------------------------------------------------------------

def link_transfer_cycles(bytes_: float, link: MeshLink, hops: int) -> float:
    """Point-to-point transfer of ``bytes_`` over ``hops`` store-and-forward
    links: each hop re-serializes the payload at the link bandwidth and pays
    the fixed router latency. This is the mesh-level analogue of eq. (11) —
    chunk bytes over effective bandwidth, ceil'd to whole cycles — with the
    hop count playing the multicast-traffic role the on-chip model charges
    via ``eff_bw_bytes``. Monotone non-increasing in ``bandwidth_bits`` and
    exactly zero for zero hops (same-chip transfer)."""
    if hops <= 0 or bytes_ <= 0:
        return 0.0
    per_hop = math.ceil(bytes_ / link.bytes_per_cycle())
    return float(hops) * (per_hop + link.hop_latency_cycles)


def ring_allreduce_cycles(bytes_: float, link: MeshLink,
                          n_chips: int) -> float:
    """Ring all-reduce of ``bytes_`` of partial sums across ``n_chips``:
    2(N-1) steps each moving a 1/N chunk over one link (reduce-scatter +
    all-gather). Both the ring and the grid topology embed a Hamiltonian
    ring, so the same bound serves both. Zero for a single chip."""
    if n_chips <= 1 or bytes_ <= 0:
        return 0.0
    chunk = math.ceil(math.ceil(bytes_ / n_chips) / link.bytes_per_cycle())
    return 2.0 * (n_chips - 1) * (chunk + link.hop_latency_cycles)


def idealized_cycles(mapping: Mapping, layer: wl.Layer,
                     arch: CimArch) -> float:
    """The oversimplified cost model of prior work (paper limitation ❶):
    latency per level = max(compute, transfer) assuming perfect overlap
    everywhere. Used by the ZigZag-style heuristic baseline to *pick* its
    mapping; the resulting mapping is then re-scored with `evaluate`."""
    compute, terms = idealized_terms(mapping, layer, arch)
    worst = compute
    for num, bw in terms:
        worst = max(worst, num / bw)
    return float(worst)


def idealized_terms(mapping: Mapping, layer: wl.Layer, arch: CimArch,
                    ctx: SizeContext | None = None
                    ) -> tuple[int, list[tuple[float, float]]]:
    """The idealized model's raw terms: ``(compute_cycles, [(num, bw), ...])``
    with one ``num / bw`` transfer bound per (operand, used level with a
    destination), in the scalar evaluation order. Shared with the batched
    packer (`latency_batched.py`) so both front-ends derive the same
    quantities."""
    temporal_iters = math.prod(f for _, f in mapping.temporal)
    compute = temporal_iters * arch.l_mvm_cycles
    terms: list[tuple[float, float]] = []
    for lam in OPERANDS:
        for m in mapping.used_levels(lam):
            if mapping.next_used_below(lam, m) is None:
                continue
            # iterations of loops at or above this level that change the tile
            iters = 1
            for i, (dim, f) in enumerate(mapping.temporal):
                if mapping.level_of[lam][i] <= m and wl.is_relevant(dim, lam):
                    iters *= f
            if ctx is not None:
                terms.append((iters * ctx.transfer_bytes(lam, m),
                              ctx.eff_bw_bytes(m)))
            else:
                chunk = mapping.transfer_bytes(layer, lam, arch, m)
                terms.append((iters * chunk, mapping.eff_bw_bytes(arch, m)))
    return compute, terms
