"""Energy / EDP model (paper §V reports EDP ratios; constants PCACTI-class).

Energy counts *physical* traffic (unlike the latency model's pipeline-edge
accounting): every hop of every operand contributes
    loads(hop) × chunk_bytes × (e_read(src) + e_write(dst)),
where loads = product of relevant temporal factors above the destination
block (reuse over irrelevant loops is free). Partial-sum write-backs pay a
read-modify-write factor while reduction dims remain un-accumulated above.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import workload as wl
from repro_torch.core.arch import CimArch, OPERANDS, OUTPUT, WEIGHT
from repro_torch.core.latency import LatencyReport, evaluate
from repro_torch.core.mapping import Mapping, SizeContext

REDUCTION_DIMS = ("C", "FY", "FX")


@dataclasses.dataclass
class EnergyReport:
    total_pj: float
    traffic_pj: dict[str, float]
    mac_pj: float
    bytes_moved: dict[str, float]


def hop_loads(mapping: Mapping, operand: str, m_dst: int) -> int:
    """Number of distinct tile loads into level m_dst for the operand."""
    loads = 1
    for i, (dim, f) in enumerate(mapping.temporal):
        if mapping.level_of[operand][i] < m_dst and \
                wl.is_relevant(dim, operand):
            loads *= f
    return loads


def operand_energy_hops(mapping: Mapping, layer: wl.Layer, arch: CimArch,
                        operand: str,
                        ctx: SizeContext | None = None
                        ) -> list[tuple[float, float]]:
    """Per hop of the operand's (DRAM-prepended) used-level chain, the
    ``(total_bytes, e_coef)`` pair whose product is the hop's traffic energy.
    ``total_bytes`` carries the psum read-modify-write doubling. Single
    source of truth for ``evaluate_energy`` and the batched packer
    (`latency_batched.py`)."""
    used = mapping.used_levels(operand)
    # Prepend DRAM as the universal source if not already present.
    if not used or used[0] != 0:
        used = [0] + used
    hops: list[tuple[float, float]] = []
    for m_src, m_dst in zip(used, used[1:]):
        loads = hop_loads(mapping, operand, m_dst)
        chunk = ctx.stored_bytes(operand, m_dst) if ctx is not None \
            else mapping.stored_bytes(layer, operand, arch, m_dst)
        total_bytes = loads * chunk
        e = arch.level(m_src).access_energy_pj_per_byte + \
            arch.level(m_dst).access_energy_pj_per_byte
        if operand == OUTPUT:
            # read-modify-write while reduction dims above m_dst exist
            rmw = any(
                wl.is_relevant(dim, operand) is False
                and dim in REDUCTION_DIMS
                and mapping.level_of[operand][i] < m_dst
                for i, (dim, _) in enumerate(mapping.temporal))
            if rmw:
                total_bytes *= 2
        hops.append((total_bytes, e))
    return hops


def evaluate_energy(mapping: Mapping, layer: wl.Layer,
                    arch: CimArch) -> EnergyReport:
    traffic = {lam: 0.0 for lam in OPERANDS}
    bytes_moved = {lam: 0.0 for lam in OPERANDS}
    for lam in OPERANDS:
        for total_bytes, e in operand_energy_hops(mapping, layer, arch, lam):
            traffic[lam] += total_bytes * e
            bytes_moved[lam] += total_bytes
    mac_pj = layer.macs * arch.mac_energy_pj
    total = sum(traffic.values()) + mac_pj
    return EnergyReport(total_pj=total, traffic_pj=traffic, mac_pj=mac_pj,
                        bytes_moved=bytes_moved)


@dataclasses.dataclass
class EdpReport:
    latency: LatencyReport
    energy: EnergyReport

    @property
    def cycles(self) -> float:
        return self.latency.total_cycles

    @property
    def edp(self) -> float:
        """pJ * s  (cycles converted at arch frequency)."""
        return self.energy.total_pj * self.latency.total_cycles


def evaluate_edp(mapping: Mapping, layer: wl.Layer, arch: CimArch,
                 latency: LatencyReport | None = None) -> EdpReport:
    lat = latency if latency is not None else evaluate(mapping, layer, arch)
    return EdpReport(latency=lat, energy=evaluate_energy(mapping, layer, arch))
