"""Hierarchical CIM architecture abstraction (paper §III-A, Fig. 1, Table IV).

The accelerator is modeled as an ordered memory hierarchy plus spatial
unrolling axes plus a CIM macro:

    m=0  off-chip DRAM          (source of all operands)
    m=1  Global Buffer (GBuf)   (shared across operands, multicast network)
    m=2  Local Buffer  (LBuf)   (per CIM core)
    m=3  Register files         (IReg / WReg / OReg, dedicated per operand)
    m=4  CIM macro array        (weights resident; Memory-mode vs Compute-mode)

Larger ``m`` is *closer to the macro* — matching the paper's index convention
(eq. 5: "a larger index value m denotes a memory level closer to the CIM
macros").

Every level can be, per operand:
  * bypassed            (psi^U = 0),
  * single-buffered     (full capacity, transfers serialize with compute),
  * double-buffered     (transfers overlap compute, HALF effective capacity —
                         modeled per paper eq. 9 as (1 + psi^DM) * Size <= CA).

The CIM macro is special: Memory mode (weight update) and Compute mode (MVM)
share peripheral circuits, so weight reloads can never overlap computation
(Fig. 2(a)); this is expressed by forcing single-buffering for the weight
operand at the macro level plus a constant ``mode_switch_cycles`` charged per
reload event.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

# Operand identifiers (paper index λ).
INPUT = "I"
WEIGHT = "W"
OUTPUT = "O"
OPERANDS = (INPUT, WEIGHT, OUTPUT)


@dataclasses.dataclass(frozen=True)
class MemLevel:
    """One memory hierarchy level.

    Attributes:
      name: human-readable name.
      capacity_bytes: total capacity (``None`` = unbounded, e.g. DRAM). For
        ``shared=True`` the capacity is shared across all served operands
        (paper eq. 9 sums over λ); otherwise it is per-operand.
      bus_bits: bus width in bits per cycle for transfers sourced from this
        level (paper constant BW_m, eq. 11).
      serves: which operands this level can hold (paper matrix C^M).
      shared: whether capacity is shared across operands.
      bypassable: whether an operand may skip this level (psi^U = 0).
      double_bufferable: whether psi^DM = 1 is allowed here.
      access_energy_pj_per_byte: per-byte access energy (PCACTI-class
        constant; used by energy.py — ratios, not absolute joules, matter
        for the paper's EDP comparisons).
    """

    name: str
    capacity_bytes: int | None
    bus_bits: int
    serves: tuple[str, ...] = OPERANDS
    shared: bool = True
    bypassable: bool = False
    double_bufferable: bool = True
    access_energy_pj_per_byte: float = 1.0

    def bytes_per_cycle(self) -> float:
        return self.bus_bits / 8.0


@dataclasses.dataclass(frozen=True)
class SpatialAxis:
    """A spatial unrolling axis (paper matrix C^X).

    Attributes:
      name: axis name ("core", "wordline", "bitline").
      size: number of parallel lanes.
      dims: tensor dims allowed to unroll on this axis.
      at_level: hierarchy level index at/below which the axis multiplies
        tile/transfer-chunk sizes (paper constant C_u: "the summation over u
        is performed for all indices satisfying C_u >= m"). Unrolling across
        cores multiplies GBuf->LBuf multicast traffic (at_level=2);
        wordline/bitline unrolling multiplies register->macro traffic
        (at_level=4).
      replicates_from: first hierarchy level that physically exists once per
        lane of this axis (cores replicate LBuf/Reg/Macro -> 2); ``None``
        when no memory level is per-lane (wordline/bitline lanes live
        *inside* the macro array). Governs capacity/bandwidth aggregation.
    """

    name: str
    size: int
    dims: tuple[str, ...]
    at_level: int
    replicates_from: int | None = None


@dataclasses.dataclass(frozen=True)
class CimArch:
    """Complete accelerator description (paper Table IV defaults)."""

    levels: tuple[MemLevel, ...]
    spatial: tuple[SpatialAxis, ...]
    macro_rows: int = 128          # wordlines: input-vector chunk length
    macro_cols: int = 32           # bitlines: output channels per macro
    l_mvm_cycles: int = 16         # bit-serial MVM latency (8b serial + ADC pipe)
    mode_switch_cycles: int = 10   # Memory<->Compute mode transition (Fig 2a)
    mac_energy_pj: float = 0.08    # per INT8 MAC inside the macro
    freq_ghz: float = 1.0
    name: str = "cim"

    # ---- derived helpers -------------------------------------------------
    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def macro_level(self) -> int:
        return len(self.levels) - 1

    def level(self, m: int) -> MemLevel:
        return self.levels[m]

    def axis(self, name: str) -> SpatialAxis:
        for ax in self.spatial:
            if ax.name == name:
                return ax
        raise KeyError(name)

    def serves(self, m: int, operand: str) -> bool:
        return operand in self.levels[m].serves

    def validate(self) -> None:
        assert self.levels[0].capacity_bytes is None, "level 0 must be DRAM"
        for ax in self.spatial:
            assert 0 <= ax.at_level < self.n_levels
        # Macro must serve weights and be single-buffer-only for them.
        assert WEIGHT in self.levels[self.macro_level].serves


# Operand precision in bits, per level. Outputs travel as 32-bit partial sums
# near the macro and as 8-bit requantized activations in the outer hierarchy
# (SIMD unit requantizes on GBuf write-back) — a documented simplification.
def operand_bits(arch: CimArch, m: int, operand: str) -> int:
    if operand == OUTPUT:
        return 32 if m >= 2 else 8
    return 8


def default_arch(
    *,
    n_cores: int = 8,
    macro_rows: int = 128,
    macro_cols: int = 32,
    gbuf_kb: float = 8.0,
    lbuf_kb: float = 256.0,
    reg_bytes: int = 2048,
    gbuf_bus_bits: int = 256,
    lbuf_bus_bits: int = 128,
    dram_bus_bits: int = 64,
    double_buffered: bool = True,
    name: str = "miredo-tab4",
) -> CimArch:
    """The paper's Table IV configuration (defaults) with sweepable knobs.

    ``double_buffered=False`` is the single-buffer-only policy point of the
    co-design space (`core/dse.py`): no on-chip level may double-buffer, so
    every transfer serializes with compute (psi^DM forced to 0)."""
    levels = (
        MemLevel("DRAM", None, dram_bus_bits, OPERANDS, shared=True,
                 bypassable=False, double_bufferable=False,
                 access_energy_pj_per_byte=160.0),
        MemLevel("GBuf", int(gbuf_kb * 1024), gbuf_bus_bits, OPERANDS,
                 shared=True, bypassable=True,
                 double_bufferable=double_buffered,
                 access_energy_pj_per_byte=6.0),
        MemLevel("LBuf", int(lbuf_kb * 1024), lbuf_bus_bits, OPERANDS,
                 shared=True, bypassable=True,
                 double_bufferable=double_buffered,
                 access_energy_pj_per_byte=2.0),
        MemLevel("Reg", reg_bytes, lbuf_bus_bits, OPERANDS, shared=False,
                 bypassable=True, double_bufferable=double_buffered,
                 access_energy_pj_per_byte=0.6),
        MemLevel("Macro", macro_rows * macro_cols, lbuf_bus_bits, (WEIGHT,),
                 shared=False, bypassable=False, double_bufferable=False,
                 access_energy_pj_per_byte=0.3),
    )
    spatial = (
        # Partition output channels / output pixels across cores: no
        # cross-core psum reduction needed (SIMD accumulates within core).
        SpatialAxis("core", n_cores, ("K", "OY", "OX", "N"), at_level=2,
                    replicates_from=2),
        # Macro wordlines carry the flattened input-channel x filter window;
        # bitlines carry output channels (Fig. 1(c) orientation).
        SpatialAxis("wordline", macro_rows, ("C", "FY", "FX"), at_level=4,
                    replicates_from=None),
        SpatialAxis("bitline", macro_cols, ("K",), at_level=4,
                    replicates_from=None),
    )
    arch = CimArch(levels=levels, spatial=spatial, macro_rows=macro_rows,
                   macro_cols=macro_cols, name=name)
    arch.validate()
    return arch


def sweep_arch(**kw) -> CimArch:
    """Convenience for Fig. 5(b–d) hardware sweeps."""
    return default_arch(**kw)


def max_spatial_macs(arch: CimArch) -> int:
    """Peak MACs per cycle-group: product of all spatial axis sizes."""
    return math.prod(ax.size for ax in arch.spatial)


# ---------------------------------------------------------------------------
# Multi-chip mesh vocabulary (DESIGN.md §Mesh optimization)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshLink:
    """One inter-chip link of a CIM chip mesh (`core/mesh.py`).

    The link is the mesh-level analogue of a `MemLevel` bus: a bandwidth in
    bits per cycle, a fixed per-hop router/SerDes latency, and a per-byte
    transfer energy (chip-to-chip SerDes energy dwarfs on-chip SRAM access
    — the NoC dataflow literature's constant, arXiv:2111.11744). All three
    are solver-relevant and therefore part of the structural mesh
    fingerprint (`mesh.mesh_fingerprint` — the cache-key contract).

    Attributes:
      bandwidth_bits: bits per cycle per directed link.
      hop_latency_cycles: fixed per-hop latency (router traversal).
      energy_pj_per_byte: per-byte, per-hop transfer energy.
    """

    bandwidth_bits: int = 256
    hop_latency_cycles: int = 4
    energy_pj_per_byte: float = 10.0

    def bytes_per_cycle(self) -> float:
        return self.bandwidth_bits / 8.0

    def validate(self) -> None:
        assert self.bandwidth_bits >= 8, self.bandwidth_bits
        assert self.hop_latency_cycles >= 0, self.hop_latency_cycles


# ---------------------------------------------------------------------------
# Co-design support: area proxy + structural serde (DESIGN.md §Co-design DSE)
# ---------------------------------------------------------------------------

#: Bits per CIM crossbar cell (INT8 weights, one weight per cell column
#: group — the paper's precision setup).
CELL_BITS = 8


def n_macros(arch: CimArch) -> int:
    """Number of physical CIM macro arrays: product of the spatial axes that
    replicate the macro level (``replicates_from`` at or above it). Wordline/
    bitline lanes live *inside* one macro and do not multiply the count."""
    return math.prod(
        ax.size for ax in arch.spatial
        if ax.replicates_from is not None
        and ax.replicates_from <= arch.macro_level)


def area_proxy(arch: CimArch) -> int:
    """Silicon-cost proxy for the Pareto frontier (`core/dse.py`):
    macros x crossbar bits = n_macros x macro_rows x macro_cols x CELL_BITS.

    CIM die area is dominated by the macro arrays (cell mats + per-bitline
    ADCs scale with rows x cols x macro count); SRAM buffer capacity is
    deliberately *not* counted, so along the buffer-capacity knobs the DSE
    answers "how much buffer does this macro budget need" rather than
    trading buffers against macros — a documented simplification."""
    return n_macros(arch) * arch.macro_rows * arch.macro_cols * CELL_BITS


def core_axis(arch: CimArch) -> SpatialAxis | None:
    """The spatial axis whose lanes replicate the macro level — the unit the
    network scheduler (`core/scheduler.py`) allocates between pipeline
    stages. ``None`` when no axis replicates per-lane macros (a single-macro
    chip: nothing to partition)."""
    for ax in arch.spatial:
        if ax.replicates_from is not None and \
                ax.replicates_from <= arch.macro_level:
            return ax
    return None


def with_cores(arch: CimArch, n: int) -> CimArch:
    """Structural variant of ``arch`` with the core axis resized to ``n``
    lanes (buffers, macro geometry and all other axes unchanged). Used by
    the scheduler's core-scaling probes: how much slower does a layer get
    on a ``n``-core slice of the chip?"""
    ax = core_axis(arch)
    assert ax is not None and n >= 1, (ax, n)
    spatial = tuple(
        dataclasses.replace(a, size=n) if a.name == ax.name else a
        for a in arch.spatial)
    return dataclasses.replace(arch, spatial=spatial,
                               name=f"{arch.name}-c{n}")


def arch_fingerprint(arch: CimArch) -> str:
    """Canonical *structural* serialization for cache keys (`core/cache.py`
    digests this). Covers every field that can change a solve result:
    per-level capacity/bus/serves/shared/bypassable/double-bufferable and
    access energy, spatial axes, macro geometry and timing/energy constants.
    Excludes ``name`` (two structurally identical archs must share cache
    entries — the DSE grid generates archs by knobs, not by name) and
    ``freq_ghz`` (cycles and pJ are frequency-independent)."""
    parts = []
    for lv in arch.levels:
        parts.append(
            f"{lv.name}:{lv.capacity_bytes}:{lv.bus_bits}:"
            f"{','.join(lv.serves)}:{int(lv.shared)}:{int(lv.bypassable)}:"
            f"{int(lv.double_bufferable)}:{lv.access_energy_pj_per_byte!r}")
    for ax in arch.spatial:
        parts.append(f"{ax.name}:{ax.size}:{','.join(ax.dims)}:"
                     f"{ax.at_level}:{ax.replicates_from}")
    parts.append(f"{arch.macro_rows}x{arch.macro_cols}:{arch.l_mvm_cycles}:"
                 f"{arch.mode_switch_cycles}:{arch.mac_energy_pj!r}")
    return "|".join(parts)
