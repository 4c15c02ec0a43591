"""Dataflow mapping representation + tile/size computation.

A ``Mapping`` fixes every decision the MIREDO MIP optimizes (paper §IV-C):

  * spatial unrolling: per spatial axis, the (dim, factor) list unrolled on it
    (variables X^U),
  * the temporal loop nest: ordered (dim, factor) slots, outermost first
    (variables X^L / psi^L),
  * per-operand memory-level assignment of every temporal slot (variables
    X^M / X^Z — "uneven mapping": each operand owns its own partition of the
    nest into per-level loop blocks),
  * per-(operand, level) buffering mode (psi^DM) and implied bypass
    (psi^U = level has no slots for the operand).

Size conventions (paper eqs. 6–10, aggregate-granularity — see DESIGN.md):
  * stored tile  B^S(m, λ): product over λ-relevant dims of all temporal
    factors assigned to levels >= m, times spatial extents of axes with
    C_u >= m (union across lanes; multicast-replicated copies counted once).
  * transfer chunk B^T(m, λ): same but temporal factors at levels >= m+1
    only — the chunk streamed per iteration of level-m loops.
  * capacities and bandwidths are aggregated over *used* lanes of axes that
    replicate the level (axes with C_u <= m).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core import workload as wl
from repro_torch.core.arch import (CimArch, INPUT, OPERANDS, OUTPUT, WEIGHT,
                             operand_bits)


@dataclasses.dataclass(frozen=True)
class Mapping:
    spatial: dict[str, tuple[tuple[str, int], ...]]  # axis -> ((dim, f), ...)
    temporal: tuple[tuple[str, int], ...]            # outer..inner (dim, f)
    level_of: dict[str, tuple[int, ...]]             # operand -> level/slot
    double_buf: frozenset[tuple[str, int]]           # (operand, level) w/ DB

    # ---- structural queries ---------------------------------------------
    def n_slots(self) -> int:
        return len(self.temporal)

    def spatial_extent(self, axis: str, dim: str | None = None) -> int:
        fs = self.spatial.get(axis, ())
        return math.prod(f for d, f in fs if dim is None or d == dim)

    def spatial_dim_extent(self, dim: str, arch: CimArch,
                           min_cu: int | None = None) -> int:
        """Product of factors of `dim` unrolled on axes with C_u >= min_cu."""
        out = 1
        for ax in arch.spatial:
            if min_cu is not None and ax.at_level < min_cu:
                continue
            out *= self.spatial_extent(ax.name, dim)
        return out

    def used_levels(self, operand: str) -> list[int]:
        # Memoized: every analysis pass asks repeatedly, and mappings are
        # frozen. Callers must not mutate the returned list (none do).
        cache = self.__dict__.get("_used_lv")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_used_lv", cache)
        v = cache.get(operand)
        if v is None:
            v = sorted(set(self.level_of[operand]))
            cache[operand] = v
        return v

    def deepest_used(self, operand: str) -> int:
        return max(self.level_of[operand], default=0)

    def next_used_below(self, operand: str, m: int) -> int | None:
        for x in self.used_levels(operand):
            if x > m:
                return x
        return None

    def is_double_buffered(self, operand: str, level: int,
                           arch: CimArch) -> bool:
        if not arch.level(level).double_bufferable:
            return False
        if level == arch.macro_level:
            return False  # shared peripherals: never overlap (Fig. 2a)
        return (operand, level) in self.double_buf

    # ---- tile sizes -------------------------------------------------------
    def _tile_bounds(self, layer: wl.Layer, operand: str, arch: CimArch,
                     min_level: int, spatial_min_cu: int) -> dict[str, int]:
        t = {d: 1 for d in wl.DIMS}
        levels = self.level_of[operand]
        for (d, f), m in zip(self.temporal, levels):
            if m >= min_level:
                t[d] *= f
        for ax in arch.spatial:
            if ax.at_level >= spatial_min_cu:
                for d, f in self.spatial.get(ax.name, ()):
                    t[d] *= f
        return t

    def stored_elems(self, layer: wl.Layer, operand: str, arch: CimArch,
                     m: int) -> int:
        """B^S (eq. 6): union tile stored at level m."""
        t = self._tile_bounds(layer, operand, arch, m, m)
        return wl.operand_tile_elems(layer, operand, t)

    def transfer_elems(self, layer: wl.Layer, operand: str, arch: CimArch,
                       m: int) -> int:
        """B^T (eq. 10): chunk streamed per iteration of level-m loops."""
        t = self._tile_bounds(layer, operand, arch, m + 1, m)
        return wl.operand_tile_elems(layer, operand, t)

    def stored_bytes(self, layer: wl.Layer, operand: str, arch: CimArch,
                     m: int) -> float:
        return self.stored_elems(layer, operand, arch, m) * \
            operand_bits(arch, m, operand) / 8.0

    def transfer_bytes(self, layer: wl.Layer, operand: str, arch: CimArch,
                       m: int) -> float:
        # Source-level precision: psum write-backs leave the core at 32-bit
        # (SIMD requantizes at the GBuf boundary); inbound I/W are 8-bit
        # throughout. Keeps the MIP transfer-size linearization exact.
        bits = operand_bits(arch, m, operand)
        return self.transfer_elems(layer, operand, arch, m) * bits / 8.0

    # ---- aggregated hardware quantities -----------------------------------
    def used_lanes(self, arch: CimArch, m: int) -> int:
        """Used lane count of axes whose per-lane hardware includes level m
        (capacity/bandwidth aggregation — see SpatialAxis.replicates_from)."""
        out = 1
        for ax in arch.spatial:
            if ax.replicates_from is not None and ax.replicates_from <= m:
                out *= self.spatial_extent(ax.name)
        return out

    def eff_bw_bytes(self, arch: CimArch, m: int) -> float:
        return arch.level(m).bytes_per_cycle() * self.used_lanes(arch, m)

    def eff_capacity(self, arch: CimArch, m: int) -> float | None:
        cap = arch.level(m).capacity_bytes
        if cap is None:
            return None
        return cap * self.used_lanes(arch, m)


@dataclasses.dataclass
class SizeContext:
    """Memoized per-mapping size/bandwidth/capacity tables.

    ``Mapping.stored_bytes``/``transfer_bytes`` recompute their tile-bound
    scan per call; the analysis helpers (`latency.operand_transfer_table`,
    `energy.operand_energy_hops`, `latency.idealized_terms`,
    `mapping.capacity_usage`) query the same handful of (operand, level)
    sizes repeatedly, which dominates batched packing
    (`latency_batched.pack`). This context computes every needed entry in
    one monotone suffix-product pass per operand — identical integer
    products, so byte-identical bytes — and answers lookups from dicts.
    Entries exist for each operand's used levels plus DRAM (level 0);
    anything else falls back to the mapping's own methods."""

    mapping: Mapping
    layer: wl.Layer
    arch: CimArch
    stored: dict[str, dict[int, float]]
    transfer: dict[str, dict[int, float]]
    bw: dict[int, float]
    cap: dict[int, float | None]

    def stored_bytes(self, operand: str, m: int) -> float:
        v = self.stored[operand].get(m)
        if v is None:
            return self.mapping.stored_bytes(self.layer, operand,
                                             self.arch, m)
        return v

    def transfer_bytes(self, operand: str, m: int) -> float:
        v = self.transfer[operand].get(m)
        if v is None:
            return self.mapping.transfer_bytes(self.layer, operand,
                                               self.arch, m)
        return v

    def eff_bw_bytes(self, m: int) -> float:
        return self.bw[m]

    def eff_capacity(self, m: int) -> float | None:
        return self.cap[m]


#: dim-name -> index into `wl.DIMS`-ordered tile vectors (hot-path helper)
_DI = {d: i for i, d in enumerate(wl.DIMS)}


def size_context(mapping: Mapping, layer: wl.Layer,
                 arch: CimArch) -> SizeContext:
    """Build the memoized size tables for one mapping (see `SizeContext`).

    Per operand the temporal part of every level's tile is a *suffix*
    product of the slot factors (level assignment is monotone), so one
    innermost-to-outermost walk yields the stored tile (slots at levels
    >= m) and the transfer chunk (slots at levels >= m+1) for every used
    level, plus the DRAM-source chunk at level 0. Tiles are 7-int vectors
    in `wl.DIMS` order; all products are exact integer arithmetic, so the
    resulting bytes are bit-identical to the per-call mapping methods."""
    # spatial per-axis per-dim factor products, and used lanes per axis
    ax_dims: list[tuple[int, list[tuple[int, int]]]] = []
    ax_lanes: list[tuple[int | None, int]] = []
    for ax in arch.spatial:
        d: dict[int, int] = {}
        for dim, f in mapping.spatial.get(ax.name, ()):
            k = _DI[dim]
            d[k] = d.get(k, 1) * f
        ax_dims.append((ax.at_level, list(d.items())))
        ax_lanes.append((ax.replicates_from, math.prod(d.values())))

    bw, cap = {}, {}
    for m in range(arch.n_levels):
        lanes = 1
        for rep, ext in ax_lanes:
            if rep is not None and rep <= m:
                lanes *= ext
        bw[m] = arch.level(m).bytes_per_cycle() * lanes
        c = arch.level(m).capacity_bytes
        cap[m] = None if c is None else c * lanes

    ones = [1] * 7
    sp_cache: dict[int, list[int]] = {}

    def spatial_tile(min_cu: int) -> list[int]:
        sp = sp_cache.get(min_cu)
        if sp is None:
            sp = list(ones)
            for at, items in ax_dims:
                if at >= min_cu:
                    for k, f in items:
                        sp[k] *= f
            sp_cache[min_cu] = sp
        return sp

    stride = layer.stride
    tmp_idx = [(_DI[d], f) for d, f in mapping.temporal]

    def elems(lam: str, td: list[int], sp: list[int]) -> int:
        # inlined wl.operand_tile_elems on the (temporal x spatial) tile —
        # same integer products, index order N K C OY OX FY FX
        if lam == WEIGHT:
            return (td[1] * sp[1]) * (td[2] * sp[2]) \
                * (td[5] * sp[5]) * (td[6] * sp[6])
        if lam == OUTPUT:
            return (td[0] * sp[0]) * (td[1] * sp[1]) \
                * (td[3] * sp[3]) * (td[4] * sp[4])
        iy = (td[3] * sp[3] - 1) * stride + td[5] * sp[5]
        ix = (td[4] * sp[4] - 1) * stride + td[6] * sp[6]
        return (td[0] * sp[0]) * (td[2] * sp[2]) * iy * ix

    stored: dict[str, dict[int, float]] = {}
    transfer: dict[str, dict[int, float]] = {}
    for lam in OPERANDS:
        lv = mapping.level_of[lam]
        n = len(lv)
        ms = sorted(set(lv) | {0}, reverse=True)
        td = list(ones)
        st_l, tr_l = {}, {}
        i = n
        for m in ms:
            # td holds the suffix of slots at levels > m (== >= m+1, since
            # consecutive ms are consecutive used levels)
            sp = spatial_tile(m)
            tr_elems = elems(lam, td, sp)
            while i > 0 and lv[i - 1] >= m:
                i -= 1
                k, f = tmp_idx[i]
                td[k] *= f
            st_elems = elems(lam, td, sp)
            bits = operand_bits(arch, m, lam)
            tr_l[m] = tr_elems * bits / 8.0
            st_l[m] = st_elems * bits / 8.0
        stored[lam] = st_l
        transfer[lam] = tr_l
    return SizeContext(mapping=mapping, layer=layer, arch=arch,
                       stored=stored, transfer=transfer, bw=bw, cap=cap)


def capacity_usage(mapping: Mapping, layer: wl.Layer, arch: CimArch,
                   ctx: SizeContext | None = None
                   ) -> list[tuple[int, float, dict[str, float]]]:
    """Eq. (9) raw terms, one entry per capacity-bounded level:
    ``(m, eff_capacity, {operand: (1 + psi^DM) * stored_bytes})`` over the
    operands that hold slots at (and are served by) level m. Single source
    of truth for ``validate``'s capacity clause and the batched feasibility
    check (`latency_batched.py`). ``ctx`` routes size lookups through a
    prebuilt `SizeContext` (identical values, memoized)."""
    out: list[tuple[int, float, dict[str, float]]] = []
    used = {lam: set(mapping.used_levels(lam)) for lam in OPERANDS}
    for m in range(arch.n_levels):
        cap = ctx.eff_capacity(m) if ctx is not None else \
            mapping.eff_capacity(arch, m)
        if cap is None:
            continue
        sizes: dict[str, float] = {}
        for lam in OPERANDS:
            if m not in used[lam]:
                continue
            if not arch.serves(m, lam):
                continue
            mult = 2 if mapping.is_double_buffered(lam, m, arch) else 1
            sizes[lam] = mult * (ctx.stored_bytes(lam, m) if ctx is not None
                                 else mapping.stored_bytes(layer, lam,
                                                           arch, m))
        out.append((m, cap, sizes))
    return out


def validate(mapping: Mapping, layer: wl.Layer, arch: CimArch) -> list[str]:
    """Return a list of constraint violations (empty = feasible)."""
    errs: list[str] = []
    # (2) each dim's factors multiply back to the bound.
    for d in wl.DIMS:
        prod = math.prod(f for dd, f in mapping.temporal if dd == d)
        for ax in arch.spatial:
            prod *= mapping.spatial_extent(ax.name, d)
        if prod != layer.bound(d):
            errs.append(f"dim {d}: factor product {prod} != {layer.bound(d)}")
    # C^X: spatial axis dim legality + axis size.
    for ax in arch.spatial:
        for d, f in mapping.spatial.get(ax.name, ()):
            if d not in ax.dims:
                errs.append(f"axis {ax.name} cannot unroll dim {d}")
        if mapping.spatial_extent(ax.name) > ax.size:
            errs.append(f"axis {ax.name} over-unrolled")
    for lam in OPERANDS:
        lv = mapping.level_of[lam]
        if len(lv) != mapping.n_slots():
            errs.append(f"{lam}: level_of length mismatch")
            continue
        # Loop blocks: outer loops at outer (smaller-m) levels.
        for a, b in zip(lv, lv[1:]):
            if a > b:
                errs.append(f"{lam}: level assignment not monotonic {lv}")
                break
        # C^M legality.
        for m in set(lv):
            if not arch.serves(m, lam):
                errs.append(f"level {arch.level(m).name} cannot hold {lam}")
    # Weights must terminate in the macro array (in-situ computation).
    if mapping.deepest_used(WEIGHT) != arch.macro_level and \
            mapping.n_slots() > 0:
        # allowed only if all weight factors are spatial (tiny layer)
        pass
    # (9) capacity with double-buffering multiplier.
    for m, cap, sizes in capacity_usage(mapping, layer, arch):
        level = arch.level(m)
        if level.shared:
            if sum(sizes.values()) > cap + 1e-9:
                errs.append(
                    f"{level.name}: {sum(sizes.values()):.0f}B > {cap:.0f}B")
        else:
            for lam, s in sizes.items():
                if s > cap + 1e-9:
                    errs.append(f"{level.name}[{lam}]: {s:.0f}B > {cap:.0f}B")
    # Macro geometry: wordline/bitline extents within array.
    for ax in arch.spatial:
        if mapping.spatial_extent(ax.name) > ax.size:
            errs.append(f"{ax.name} exceeds physical size")
    return errs
