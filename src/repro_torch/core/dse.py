"""Hardware/dataflow co-design DSE (DESIGN.md §Co-design DSE).

The paper's headline claim — EDP reductions "across various DNN models and
hardware setups" — is a *joint* statement about dataflow and architecture.
This module closes the architecture half: instead of optimizing dataflow
against a handful of hand-picked ``CimArch`` presets, it sweeps a
parameterized architecture space (macro geometry, core count, buffer
capacities, link bandwidths, double-buffering policy) against any workload
the frontends produce and emits a Pareto frontier over

    (latency cycles, energy pJ, area proxy = macros x crossbar bits).

Exhaustive MIP over the grid is unaffordable (minutes per arch), so the
exploration is **multi-fidelity**:

  1. **Screening pass (cheap, no MIP).** Every grid arch is scored with the
     same incumbent machinery that warm-starts the MIP (`baselines`):
     greedy constructor plus a small accurate-model stochastic search, run
     on a MAC-coverage-representative subset of the unique layers. Archs
     that another no-larger-area arch beats *decisively* — by more than the
     screening slack in BOTH latency and energy — are pruned: the slack
     absorbs the incumbent-vs-MIP fidelity gap, so a point the MIP could
     still promote onto the frontier survives (regression-tested against
     exhaustive MIP on a tiny grid in ``tests/test_dse.py``). Exact
     screening ties — knobs the incumbent mappings never exercised —
     collapse to their most-capable representative.
  2. **Full pass (MIP).** Survivors get warm-started MIP solves through the
     existing network pipeline (`network.optimize_over_archs`): structural
     layer dedup, MAC-weighted budgets and process fan-out all apply per
     arch, and ONE shared ``ResultCache`` with arch-aware keys makes sweep
     reruns incremental. The latency objective is the **scheduled**
     end-to-end number (`core/scheduler.py`): weight-resident segment
     packing and layer-to-core pipelining, so the frontier credits extra
     cores/macros for the parallelism they enable — the per-layer serial
     sum (which treats the chip as a per-layer constant) only rides along
     for reporting (`DsePoint.serial_cycles`).

Every frontier point's mapping set is re-checked with the mapping validator
(`mapping.validate`) — the frontier is only as good as the feasibility of
the mappings behind it.

    from repro_torch.core.dse import ArchSpace, run_dse
    res = run_dse(layers, counts, ArchSpace())
    for p in res.frontier:
        print(p.arch_name, p.cycles, p.energy_pj, p.area_bits)
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Sequence

from repro_torch.core import workload as wl
from repro_torch.core.arch import CimArch, area_proxy, default_arch
from repro_torch.core.cache import (ResultCache, layer_cache_key,
                              mapping_from_json)
from repro_torch.core.mapping import validate
from repro_torch.core.network import (NetworkResult, dedup_layers,
                                optimize_over_archs)

#: Default screening-prune slack: an arch is pruned only when a no-larger
#: arch beats it by >25% in BOTH latency and energy at screening fidelity.
DEFAULT_SLACK = 0.25
#: Default stochastic-search budget per (layer, arch) during screening.
DEFAULT_SCREEN_SAMPLES = 64
#: Screening layer subset: top unique layers by multiplicity-weighted MACs
#: until this fraction of total MACs is covered (capped at _MAX_LAYERS).
SCREEN_MAC_COVERAGE = 0.97
SCREEN_MAX_LAYERS = 8


# ---------------------------------------------------------------------------
# Architecture space
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArchSpace:
    """Cartesian grid over ``default_arch`` knobs.

    Each field lists candidate values; ``enumerate()`` yields one validated
    ``CimArch`` per grid point with a deterministic knob-derived name.
    Capacities in KB, bandwidths in bus bits/cycle; ``double_buffered``
    toggles the policy for every on-chip level at once (the macro stays
    single-buffered regardless — Fig. 2(a))."""

    macro: tuple[tuple[int, int], ...] = ((64, 32), (128, 32), (256, 64))
    n_cores: tuple[int, ...] = (4, 8, 16)
    gbuf_kb: tuple[float, ...] = (8.0,)
    lbuf_kb: tuple[float, ...] = (256.0,)
    gbuf_bus_bits: tuple[int, ...] = (256,)
    lbuf_bus_bits: tuple[int, ...] = (128,)
    double_buffered: tuple[bool, ...] = (True,)
    prefix: str = "dse"

    @property
    def size(self) -> int:
        return (len(self.macro) * len(self.n_cores) * len(self.gbuf_kb) *
                len(self.lbuf_kb) * len(self.gbuf_bus_bits) *
                len(self.lbuf_bus_bits) * len(self.double_buffered))

    def enumerate(self) -> list[CimArch]:
        out = []
        for (rows, cols), nc, g, l, gbw, lbw, db in itertools.product(
                self.macro, self.n_cores, self.gbuf_kb, self.lbuf_kb,
                self.gbuf_bus_bits, self.lbuf_bus_bits,
                self.double_buffered):
            name = (f"{self.prefix}-m{rows}x{cols}-c{nc}-g{g:g}k-l{l:g}k"
                    f"-bw{gbw}x{lbw}-{'db' if db else 'sb'}")
            out.append(default_arch(
                macro_rows=rows, macro_cols=cols, n_cores=nc,
                gbuf_kb=g, lbuf_kb=l, gbuf_bus_bits=gbw,
                lbuf_bus_bits=lbw, double_buffered=db, name=name))
        return out


# ---------------------------------------------------------------------------
# Points + Pareto dominance
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DsePoint:
    """One arch's position in objective space at one fidelity.

    At MIP fidelity ``cycles`` is the *scheduled* end-to-end latency
    (`core/scheduler.py`: weight-resident segments, pipelined cores) —
    extra cores and macros now genuinely help an arch onto the frontier
    instead of idling in the serial sum, which is kept in
    ``serial_cycles``. Screening points are incumbent serial sums."""

    arch_name: str
    cycles: float
    energy_pj: float
    area_bits: int
    fidelity: str = "mip"            # "screen" | "mip"
    serial_cycles: float | None = None
    #: SLO goodput (tokens/sec, mean over the serve scenario's models) from
    #: the request-level serving simulator (`core/serving.py`); None when
    #: no serve scenario was evaluated.
    goodput_tok_s: float | None = None
    #: Which objective vector `objectives()` exposes: "latency" ranks by
    #: scheduled cycles, "slo_goodput" by -goodput (both alongside energy
    #: and area, all minimized).
    rank_by: str = "latency"

    @property
    def edp(self) -> float:
        return self.cycles * self.energy_pj

    def objectives(self) -> tuple[float, float, float]:
        if self.rank_by == "slo_goodput":
            if self.goodput_tok_s is None:
                raise ValueError(
                    f"{self.arch_name}: rank_by='slo_goodput' needs a "
                    "goodput (run_dse(serve=ServeScenario(...)))")
            return (-self.goodput_tok_s, self.energy_pj,
                    float(self.area_bits))
        return (self.cycles, self.energy_pj, float(self.area_bits))


def dominates(a: DsePoint, b: DsePoint) -> bool:
    """Standard Pareto dominance: ``a`` no worse than ``b`` in every
    objective and strictly better in at least one (minimization)."""
    ao, bo = a.objectives(), b.objectives()
    return all(x <= y for x, y in zip(ao, bo)) and ao != bo


def pareto_frontier(points: Sequence[DsePoint]) -> list[DsePoint]:
    """Non-dominated subset, input order preserved. Exact ties in objective
    space keep the first occurrence only."""
    out: list[DsePoint] = []
    for p in points:
        if any(dominates(q, p) for q in points):
            continue
        if any(q.objectives() == p.objectives() for q in out):
            continue
        out.append(p)
    return out


def _capability(arch: CimArch) -> tuple:
    """Total buffering capability, used only to pick the representative of a
    screening tie: more capacity/bandwidth/buffering = more mappings for the
    MIP pass to exploit."""
    return (sum(lv.capacity_bytes or 0 for lv in arch.levels),
            sum(lv.bus_bits for lv in arch.levels),
            sum(lv.double_bufferable for lv in arch.levels))


def screen_prune(points: Sequence[DsePoint],
                 slack: float = DEFAULT_SLACK,
                 archs: dict[str, CimArch] | None = None
                 ) -> tuple[list[DsePoint], list[DsePoint]]:
    """Split screening points into (survivors, pruned). Two rules:

    1. **Decisive dominance.** ``p`` is pruned iff some ``q`` with no larger
       area beats it by more than ``slack`` in BOTH latency and energy:

           area_q <= area_p  and  cycles_q * (1+slack) <= cycles_p
                             and  energy_q * (1+slack) <= energy_p.

       Area is exact (a grid constant, not an estimate), so it carries no
       slack; latency/energy are incumbent estimates, so a decisive margin
       is required before a point is written off — the MIP typically
       improves the incumbent by far less than ``slack``, which is what the
       never-prunes-the-MIP-optimum regression in ``tests/test_dse.py``
       checks. Since the full pass ranks by *scheduled* latency the slack
       must additionally absorb the serial-vs-scheduled gap (observed
       single-digit % on the zoo; widen ``slack`` for workloads where
       cross-layer pipelining dominates — a documented limitation).

    2. **Exact ties.** Points with *identical* (cycles, energy, area) are
       archs the screening fidelity cannot distinguish — typically a knob
       the incumbent mappings never exercised (e.g. GBuf 2 KB vs 8 KB when
       every incumbent bypasses the GBuf). One representative goes to the
       MIP pass: the arch with the greatest buffering capability when
       ``archs`` is given (most headroom for the MIP to exploit), else the
       first in input order."""
    drop_idx: set[int] = set()
    for i, p in enumerate(points):
        if any(q.area_bits <= p.area_bits
               and q.cycles * (1.0 + slack) <= p.cycles
               and q.energy_pj * (1.0 + slack) <= p.energy_pj
               for q in points if q is not p):
            drop_idx.add(i)
    ties: dict[tuple, list[int]] = {}
    for i, p in enumerate(points):
        if i not in drop_idx:
            ties.setdefault(p.objectives(), []).append(i)
    for group in ties.values():
        if len(group) < 2:
            continue
        if archs is not None:
            rep = max(group,
                      key=lambda i: _capability(archs[points[i].arch_name]))
        else:
            rep = group[0]
        drop_idx.update(i for i in group if i != rep)
    keep = [p for i, p in enumerate(points) if i not in drop_idx]
    drop = [p for i, p in enumerate(points) if i in drop_idx]
    return keep, drop


# ---------------------------------------------------------------------------
# Screening pass (cheap incumbents, no MIP)
# ---------------------------------------------------------------------------

def _screen_subset(layers: Sequence[wl.Layer], counts: Sequence[int],
                   *, coverage: float = SCREEN_MAC_COVERAGE,
                   max_layers: int = SCREEN_MAX_LAYERS
                   ) -> list[tuple[wl.Layer, int]]:
    """Representative (unique layer, total multiplicity) subset: heaviest
    unique layers by multiplicity-weighted MACs until ``coverage`` of total
    MACs is reached (capped). The same subset scores every arch, so the
    screening ranking is consistent even though it is not the full sum."""
    unique, keys = dedup_layers(layers)
    mult: dict[str, int] = {}
    for k, c in zip(keys, counts):
        mult[k] = mult.get(k, 0) + int(c)
    weighted = [(ul, mult[layer_cache_key(ul)]) for ul in unique]
    weighted.sort(key=lambda lc: -(lc[0].macs * lc[1]))
    total = sum(l.macs * c for l, c in weighted)
    subset, seen = [], 0
    for l, c in weighted[:max_layers]:
        if subset and seen >= coverage * total:
            break
        subset.append((l, c))
        seen += l.macs * c
    return subset


def screen_arch(subset: Sequence[tuple[wl.Layer, int]], arch: CimArch, *,
                samples: int = DEFAULT_SCREEN_SAMPLES,
                seed: int = 0) -> DsePoint:
    """Incumbent-fidelity score of one arch: per subset layer, the better of
    the greedy constructor and a ``samples``-budget accurate-model
    stochastic search (exactly the incumbents that warm-start the MIP),
    aggregated with multiplicities. No MIP is built or solved.

    Scoring is batched: the greedy candidate and the search winner go
    through `latency_batched.score_mappings` in one dispatch (bit-equal to
    the scalar `evaluate_edp`, so the selected incumbent and the summed
    cycles/energy are unchanged)."""
    import numpy as np

    from repro_torch.core import latency_batched as lb
    from repro_torch.core.baselines import greedy_mapping, heuristic_search

    cycles = energy = 0.0
    for layer, mult in subset:
        cands = [greedy_mapping(layer, arch)]
        if samples > 0:
            r = heuristic_search(layer, arch, budget=samples, seed=seed,
                                 accurate=True)
            cands.append(r.mapping)
        sc = lb.score_mappings(cands, layer, arch,
                               need=("feasible", "latency", "energy"))
        k = int(np.argmin(sc.edp))     # tie -> greedy, as before
        cycles += float(sc.cycles[k]) * mult
        energy += float(sc.energy_pj[k]) * mult
    return DsePoint(arch_name=arch.name, cycles=cycles, energy_pj=energy,
                    area_bits=area_proxy(arch), fidelity="screen")


# ---------------------------------------------------------------------------
# Full co-exploration
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DseResult:
    archs: dict[str, CimArch]              # full grid, name -> arch
    screen_points: dict[str, DsePoint]     # screening fidelity (whole grid)
    survivors: list[str]                   # arch names sent to the MIP pass
    pruned: list[str]                      # arch names screened out
    networks: dict[str, NetworkResult]     # MIP pass, survivors only
    points: dict[str, DsePoint]            # MIP fidelity, survivors only
    frontier: list[DsePoint]               # non-dominated MIP points,
                                           # sorted by ascending area
    validation: dict[str, list[str]]       # frontier arch -> mapping errors
    wall_s: float
    rank_by: str = "latency"               # objective set behind `frontier`

    @property
    def prune_fraction(self) -> float:
        n = len(self.archs)
        return len(self.pruned) / n if n else 0.0

    def frontier_by(self, rank_by: str) -> list[DsePoint]:
        """The Pareto frontier under either objective set, from the same
        MIP-fidelity points — lets one run compare the latency-ranked and
        goodput-ranked frontiers directly (``rank_by="slo_goodput"``
        requires the run to have evaluated a serve scenario)."""
        pts = [dataclasses.replace(p, rank_by=rank_by)
               for p in self.points.values()]
        return sorted(pareto_frontier(pts),
                      key=lambda p: (p.area_bits, p.cycles))

    def best_under_area(self, area_bits: float,
                        objective: str = "edp") -> DsePoint | None:
        """Co-design answer: best frontier point within an area budget."""
        feas = [p for p in self.frontier if p.area_bits <= area_bits]
        return min(feas, key=lambda p: getattr(p, objective), default=None)


def run_dse(layers: Sequence[wl.Layer],
            counts: Sequence[int] | None,
            space: ArchSpace | Sequence[CimArch],
            mode: str = "miredo", *,
            screen: bool = True,
            screen_slack: float = DEFAULT_SLACK,
            screen_samples: int = DEFAULT_SCREEN_SAMPLES,
            per_layer_cap_s: float = 10.0,
            total_budget_s: float | None = None,
            cache: ResultCache | None = None,
            use_cache: bool = True,
            workers: int | None = None,
            validate_frontier: bool = True,
            schedule_boundaries: Sequence[int] | None = None,
            rank_by: str = "latency",
            serve=None,
            verbose: bool = False) -> DseResult:
    """Co-explore the architecture grid against one workload.

    ``space`` is an ``ArchSpace`` or an explicit arch list; ``counts`` the
    per-layer network multiplicities (``None`` = all 1);
    ``schedule_boundaries`` the sub-stream start indices when ``layers``
    pools several independent workloads (the scheduler must not pipeline
    across them). ``screen=False``
    skips the pruning pass and runs the MIP on the whole grid (the
    exhaustive reference the screening guarantee is tested against).
    ``total_budget_s`` is the *per-arch* global solver budget forwarded to
    ``optimize_network``; the default derives from ``per_layer_cap_s`` as
    usual. Returns a ``DseResult`` whose ``frontier`` holds the
    non-dominated (scheduled cycles, energy, area) points at MIP fidelity
    — latency is the multi-core schedule's end-to-end number, not the
    serial per-layer sum — each with every mapping re-validated when
    ``validate_frontier`` is on.

    ``rank_by="slo_goodput"`` (with a ``serve=ServeScenario(...)`` traffic
    scenario from `core/serving.py`) ranks the frontier by sustained
    tokens/sec under SLO instead of single-pass latency: every survivor is
    additionally run through the request-level serving simulator (iteration
    costs from this arch's own scheduled solves) and the first objective
    becomes ``-goodput``.  Passing ``serve`` with the default
    ``rank_by="latency"`` annotates ``DsePoint.goodput_tok_s`` without
    changing the frontier, and ``DseResult.frontier_by`` re-ranks the same
    points either way.  Note the screening prune still uses incumbent
    latency/energy — its never-prunes-the-optimum guarantee is argued for
    the latency objectives; use ``screen=False`` when goodput and latency
    rankings are expected to diverge hard (see DESIGN.md §Serving
    simulator)."""
    t0 = time.monotonic()
    if rank_by not in ("latency", "slo_goodput"):
        raise ValueError(f"unknown rank_by {rank_by!r}")
    if rank_by == "slo_goodput" and serve is None:
        raise ValueError("rank_by='slo_goodput' requires a serve scenario "
                         "(serving.ServeScenario)")
    layers = list(layers)
    counts = [1] * len(layers) if counts is None else list(counts)
    assert len(counts) == len(layers)
    grid = space.enumerate() if isinstance(space, ArchSpace) else list(space)
    names = [a.name for a in grid]
    assert len(set(names)) == len(names), f"duplicate arch names: {names}"
    archs = {a.name: a for a in grid}

    # -- screening pass -----------------------------------------------------
    subset = _screen_subset(layers, counts)
    screen_points = {a.name: screen_arch(subset, a, samples=screen_samples)
                     for a in grid}
    if screen:
        kept, dropped = screen_prune(list(screen_points.values()),
                                     slack=screen_slack, archs=archs)
        survivors = [p.arch_name for p in kept]
        pruned = [p.arch_name for p in dropped]
    else:
        survivors, pruned = list(names), []
    if verbose:
        print(f"[dse] grid {len(grid)} -> {len(survivors)} survivors "
              f"({len(pruned)} pruned by screening)", flush=True)

    # -- full pass: warm-started MIPs through the network pipeline ----------
    networks = optimize_over_archs(
        layers, [archs[n] for n in survivors], mode, counts=counts,
        cache=cache, use_cache=use_cache, per_layer_cap_s=per_layer_cap_s,
        total_budget_s=total_budget_s, workers=workers,
        schedule_boundaries=schedule_boundaries, verbose=verbose)
    # MIP-fidelity latency is the *scheduled* end-to-end number: the
    # network scheduler decides how the arch's cores are actually shared
    # across layers, so core/macro-rich grid points are credited for the
    # parallelism they enable rather than scored as if every layer ran
    # alone (the serial sum rides along for reporting).
    # Traffic fidelity: run each survivor through the serving simulator
    # (iteration cost anchored on that arch's own scheduled solves) so the
    # frontier can rank by sustained tokens/sec under SLO.
    goodputs: dict[str, float] = {}
    if serve is not None:
        from repro_torch.core.serving import arch_goodput
        for n in networks:
            goodputs[n] = arch_goodput(serve, archs[n], cache=cache,
                                       use_cache=use_cache)["mean"]
            if verbose:
                print(f"[dse] serve {n}: goodput "
                      f"{goodputs[n]:.3g} tok/s", flush=True)
    points = {
        n: DsePoint(arch_name=n,
                    cycles=(net.scheduled or net.totals)["cycles"],
                    # scheduled energy too: it carries any greedy-basis
                    # swap delta, so EDP pairs cycles with the energy of
                    # the mappings the schedule actually executes
                    energy_pj=(net.scheduled or net.totals)["energy_pj"],
                    area_bits=area_proxy(archs[n]), fidelity="mip",
                    serial_cycles=net.totals["cycles"],
                    goodput_tok_s=goodputs.get(n), rank_by=rank_by)
        for n, net in networks.items()}

    frontier = sorted(pareto_frontier(list(points.values())),
                      key=lambda p: (p.area_bits, p.cycles))

    # -- frontier feasibility: re-validate every mapping --------------------
    validation: dict[str, list[str]] = {}
    if validate_frontier:
        for p in frontier:
            arch, errs, seen = archs[p.arch_name], [], set()
            for lr in networks[p.arch_name].layers:
                if lr.key in seen:      # shared mapping, validated once
                    continue
                seen.add(lr.key)
                mp = mapping_from_json(lr.record["mapping"])
                errs += [f"{lr.layer.name}: {e}"
                         for e in validate(mp, lr.layer, arch)]
            validation[p.arch_name] = errs
    return DseResult(archs=archs, screen_points=screen_points,
                     survivors=survivors, pruned=pruned, networks=networks,
                     points=points, frontier=frontier,
                     validation=validation,
                     wall_s=round(time.monotonic() - t0, 2),
                     rank_by=rank_by)


# ---------------------------------------------------------------------------
# Mesh DSE: chip-count / link-bandwidth axes (DESIGN.md §Mesh optimization)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshSpace:
    """Cartesian grid over `mesh.MeshArch` knobs: chip presets x chip count
    x link bandwidth/hop latency x topology. ``enumerate()`` yields one
    validated mesh per grid point (1-chip points included — they ARE the
    single chip, anchoring the frontier's scaling story). Chips default to
    the Table-IV preset; pass explicit ``CimArch``es to co-sweep chip
    geometry with the mesh axes."""

    chips: tuple[CimArch, ...] = dataclasses.field(
        default_factory=lambda: (default_arch(),))
    n_chips: tuple[int, ...] = (1, 2, 4)
    link_bits: tuple[int, ...] = (128, 256)
    hop_latency: tuple[int, ...] = (4,)
    topologies: tuple[str, ...] = ("ring",)
    prefix: str = "mesh"

    @property
    def size(self) -> int:
        return (len(self.chips) * len(self.n_chips) * len(self.link_bits) *
                len(self.hop_latency) * len(self.topologies))

    def enumerate(self) -> list:
        from repro_torch.core.arch import MeshLink
        from repro_torch.core.mesh import make_mesh
        out = []
        for chip, n, bits, hl, topo in itertools.product(
                self.chips, self.n_chips, self.link_bits,
                self.hop_latency, self.topologies):
            name = (f"{self.prefix}-{chip.name}-n{n}-{topo}"
                    f"-lb{bits}-hl{hl}")
            out.append(make_mesh(chip, n,
                                 link=MeshLink(bandwidth_bits=bits,
                                               hop_latency_cycles=hl),
                                 topology=topo, name=name))
        return out


def run_mesh_dse(layers: Sequence[wl.Layer],
                 counts: Sequence[int] | None,
                 space: MeshSpace | Sequence,
                 mode: str = "miredo", *,
                 per_layer_cap_s: float = 10.0,
                 total_budget_s: float | None = None,
                 cache: ResultCache | None = None,
                 use_cache: bool = True,
                 workers: int | None = None,
                 validate_frontier: bool = True,
                 schedule_boundaries: Sequence[int] | None = None,
                 verbose: bool = False) -> DseResult:
    """Sweep a mesh grid against one workload: `run_dse`'s chip-count /
    link-bandwidth axes. Every mesh point runs through
    ``optimize_network(mesh=...)`` — 1-chip points take the single-chip
    path, multi-chip points the sharded mesh pipeline — and the frontier
    ranks (scheduled cycles, energy, mesh area = n_chips x chip area).

    No screening pass: the mesh grid multiplies a handful of link/count
    knobs onto each chip, and all sub-layer solves of every mesh sharing a
    chip hit the same chip-keyed records in the shared cache, so the MIP
    pass is already incremental where screening would help
    (``screen_points`` comes back empty, ``survivors`` is the whole grid).
    Frontier validation checks each record's mapping against the
    **sub-layer it actually maps** (the shard decomposition) on
    ``mesh.chip``. Returns a `DseResult` whose ``archs`` values are
    `mesh.MeshArch` instances."""
    from repro_torch.core.mesh import shard_sub_layer
    from repro_torch.core.network import optimize_network

    t0 = time.monotonic()
    layers = list(layers)
    counts = [1] * len(layers) if counts is None else list(counts)
    assert len(counts) == len(layers)
    grid = space.enumerate() if isinstance(space, MeshSpace) else list(space)
    names = [m.name for m in grid]
    assert len(set(names)) == len(names), f"duplicate mesh names: {names}"
    meshes = {m.name: m for m in grid}
    cache = cache if cache is not None else (
        ResultCache() if use_cache else None)

    networks: dict[str, NetworkResult] = {}
    for m in grid:
        networks[m.name] = optimize_network(
            layers, mesh=m, mode=mode, counts=counts, cache=cache,
            use_cache=use_cache, per_layer_cap_s=per_layer_cap_s,
            total_budget_s=total_budget_s, workers=workers,
            schedule_boundaries=schedule_boundaries, verbose=verbose)
        if verbose:
            net = networks[m.name]
            print(f"[mesh-dse] {m.name}: "
                  f"{(net.scheduled or net.totals)['cycles']:.4g} cycles",
                  flush=True)

    points = {
        n: DsePoint(arch_name=n,
                    cycles=(net.scheduled or net.totals)["cycles"],
                    energy_pj=(net.scheduled or net.totals)["energy_pj"],
                    area_bits=meshes[n].n_chips * area_proxy(meshes[n].chip),
                    fidelity="mip",
                    serial_cycles=net.totals["cycles"])
        for n, net in networks.items()}
    frontier = sorted(pareto_frontier(list(points.values())),
                      key=lambda p: (p.area_bits, p.cycles))

    validation: dict[str, list[str]] = {}
    if validate_frontier:
        for p in frontier:
            m, errs, seen = meshes[p.arch_name], [], set()
            for lr in networks[p.arch_name].layers:
                if lr.key in seen:
                    continue
                seen.add(lr.key)
                shard = lr.record.get("shard") or {}
                sub = shard_sub_layer(lr.layer,
                                      shard.get("choice", "replicate"),
                                      m.n_chips)
                mp = mapping_from_json(lr.record["mapping"])
                errs += [f"{lr.layer.name}: {e}"
                         for e in validate(mp, sub, m.chip)]
            validation[p.arch_name] = errs
    return DseResult(archs=meshes, screen_points={}, survivors=list(names),
                     pruned=[], networks=networks, points=points,
                     frontier=frontier, validation=validation,
                     wall_s=round(time.monotonic() - t0, 2))
