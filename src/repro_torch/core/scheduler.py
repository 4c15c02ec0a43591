"""Network-level multi-core scheduler: weight-resident layer-to-core
allocation + pipelined segment execution (DESIGN.md §Network scheduler).

The network pipeline (`core/network.py`) scores a model as a *serial sum*
of per-layer latencies: every layer owns all cores exclusively and pays its
full macro weight program-in (mode-switch stall, paper Fig. 2(a)) at every
layer boundary. System-level CIM efficiency is decided by *which weights
stay resident on which cores* and how layers pipeline across them (CIMFlow,
arXiv:2505.01107) — this module closes that gap on top of the per-layer
mappings `optimize_network` already produced:

  1. **Segment packing.** The ordered layer stream is partitioned into
     contiguous *segments* whose combined weight footprints fit the chip's
     macro capacity simultaneously (a dynamic program over all contiguous
     splits; per-segment cost below). A stage whose weights exceed the chip
     (count x weight bytes > all macros) — or whose mapping is not
     weight-stationary to begin with — executes serially, exactly as the
     per-layer record already models (intra-layer reloads included).
  2. **Layer-to-core allocation.** Within a segment, stages partition the
     core axis: stage i gets ``c_i`` cores, its (count_i) weight slices
     spread across those cores' macros (capacity floor
     ``count_i x w_bytes_i <= c_i x per-core macro bytes``), and computes
     at the core-scaled per-item latency ``t_i(c_i)``. The split is a small
     MIP over `core/mip/model.py` (one-hot core choice per stage, shared
     core budget, makespan epigraph) with a greedy water-filling fallback
     mirroring `network.allocate_budgets`; the better of the two is kept,
     so the MIP never loses to the fallback.
  3. **Pipelined segment schedule.** Weights load once per segment (one
     DRAM->macro program-in per weight slice, ONE mode-switch exposure
     instead of one per layer instance) and the stages stream activations
     GBuf->GBuf: item k of stage i feeds item min(k, count_{i-1}-1) of
     stage i+1. Segment latency:

         load    = sum_i ceil(count_i * w_bytes_i / BW_dram) + switch
         compute = exact makespan of the item stream at zero ready time
                   (`simulator.stream_finish_times` — the identical
                   recursion the event replay uses; the closed
                   fill+bottleneck form serves only as the allocators'
                   objective)

     ``load + compute`` upper-bounds the event replay: the replay starts
     stages as their own weights land (delaying every stage by at most
     the full load delays the finish by at most the full load). The
     simulator's network mode (`simulator.simulate_segment`) is the
     out-of-band cross-check (`cross_check`), the same discipline
     Fig. 4(a) applies to single layers.

Cost-model fidelity: per-item latency at full cores is the *record's* own
(MIP-fidelity) cycles minus its one-time weight fill — `weight_residency`
mirrors `latency.evaluate`'s one-time accounting exactly — and the core
sensitivity ``t_i(c)/t_i(n_cores)`` is probed with the same greedy
constructor that warm-starts the MIP (`baselines.greedy_mapping` on a
`arch.with_cores` variant), clamped monotone (more cores never hurt).
When the record's mapping streams weights (the solo-latency MIP has no
incentive to keep them resident), the scheduler may swap in the greedy
incumbent's weight-stationary mapping as the stage basis — residency is
exactly the network-level objective the per-layer solve cannot see.

Guarantees:
  * scheduled cycles <= serial cycles, always: every segment is charged
    ``min(pipelined, serial)`` and the DP may always fall back to
    serial singletons;
  * strictly better whenever a segment of record-resident stages keeps
    >=2 instances on chip (at minimum the saved mode-switch stalls);
    greedy-basis swaps only ever engage when they win too;
  * energy follows the mappings actually executed: record-basis segments
    leave it unchanged (every weight slice loads exactly once per
    instance in both schedules — the scheduler loads them *together*,
    the serial baseline one-by-one), and a pipelined greedy-basis swap
    charges its mapping's energy difference (`Schedule.energy_delta_pj`).

Counts are treated as *distinct* weight sets (depth repeats). For
batch-multiplicity counts the footprint is overcounted — a conservative
simplification (fewer packing opportunities, never an infeasible one).

Written-residency caveat (training workloads, `core/training.py`): a
layer with ``weight_written`` set carries a stationary operand that is
*produced* by the step that consumes it (a wGrad GEMM's resident operand
is the activation gradient of this very step), so there is nothing to
preload and keep resident across pipelined items — `weight_residency`
returns (False, 0.0) for such layers regardless of the mapping, the
greedy weight-stationary basis swap never engages, and the stage executes
serially exactly as its record prices it (intra-layer fills included).
Non-resident stages are serial singletons, so scheduled <= serial holds
unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core import workload as wl
from repro_torch.core.arch import CimArch, WEIGHT, core_axis, n_macros, with_cores
from repro_torch.core.cache import layer_cache_key, mapping_from_json
from repro_torch.core.latency import evaluate, operand_fill_hops
from repro_torch.core.mapping import Mapping

#: Wall-clock cap per segment-allocation MIP (they are tens of binaries;
#: the greedy fallback covers a cap hit).
ALLOC_MIP_CAP_S = 2.0


# ---------------------------------------------------------------------------
# Weight residency (mirrors latency.evaluate's one-time fill accounting)
# ---------------------------------------------------------------------------

def weight_residency(mapping: Mapping, layer: wl.Layer,
                     arch: CimArch) -> tuple[bool, float]:
    """(resident, fill_cycles) for the weight operand.

    ``resident`` iff no temporal slot ever retriggers a weight hop — the
    weights are fully stationary after their one-time program-in, so they
    *can* stay resident across executions. ``fill_cycles`` is exactly the
    weight share of `latency.evaluate`'s one-time fills (both read the
    same `latency.operand_fill_hops` chain), so
    ``record cycles - fill_cycles`` is the per-item resident latency at
    full cores. Non-resident mappings return (False, 0.0): their weight
    traffic lives inside the recursion and cannot be split out.

    A ``weight_written`` layer returns (False, 0.0) unconditionally: its
    stationary operand is produced by the step itself (wGrad GEMMs), so
    no mapping can make it preloadable — the residency record the packing
    would amortize does not exist before the items run."""
    if layer.weight_written:
        return False, 0.0
    hops = operand_fill_hops(mapping, layer, arch, WEIGHT)
    if any(triggered for triggered, _ in hops):
        return False, 0.0
    return True, sum(t for _, t in hops)


def weight_bytes(layer: wl.Layer) -> int:
    """One instance's weight footprint (INT8: one byte per element)."""
    return layer.operand_elems(WEIGHT)


def chip_macro_bytes(arch: CimArch) -> int:
    """Total weight-resident capacity: every physical macro's cell array."""
    cap = arch.level(arch.macro_level).capacity_bytes
    assert cap is not None
    return n_macros(arch) * cap


# ---------------------------------------------------------------------------
# Core-scaled per-item latency
# ---------------------------------------------------------------------------

class CoreScaling:
    """Greedy-probe core-sensitivity curves, memoized per (layer key, c).

    ``factor(layer, key, c)`` = greedy cycles on the c-core chip slice /
    greedy cycles on the full chip, clamped >= 1 and monotone non-increasing
    in c (a stage may always ignore surplus cores). The probes use the same
    incumbent constructor that warm-starts the MIP, so the curve is cheap
    (no solver) yet shape-aware; the absolute anchor stays the record's
    MIP-fidelity cycles."""

    def __init__(self, arch: CimArch):
        from repro_torch.core.baselines import greedy_mapping
        self._greedy = greedy_mapping
        self.arch = arch
        ax = core_axis(arch)
        self.n_cores = ax.size if ax is not None else 1
        self._variant = {self.n_cores: arch}
        self._cycles: dict[tuple[str, int], float] = {}
        self._factor: dict[tuple[str, int], float] = {}

    def _greedy_cycles(self, layer: wl.Layer, key: str, c: int) -> float:
        k = (key, c)
        if k not in self._cycles:
            arch = self._variant.get(c)
            if arch is None:
                arch = self._variant[c] = with_cores(self.arch, c)
            mp = self._greedy(layer, arch)
            self._cycles[k] = evaluate(mp, layer, arch).total_cycles
        return self._cycles[k]

    def factor(self, layer: wl.Layer, key: str, c: int) -> float:
        c = max(1, min(c, self.n_cores))
        if c == self.n_cores:
            return 1.0
        k = (key, c)
        if k not in self._factor:
            base = self._greedy_cycles(layer, key, self.n_cores)
            raw = max(1.0, self._greedy_cycles(layer, key, c) / max(base, 1.0))
            # monotone: fewer cores are never faster than one more of them
            self._factor[k] = max(raw, self.factor(layer, key, c + 1))
        return self._factor[k]


# ---------------------------------------------------------------------------
# Plan dataclasses
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StagePlan:
    """One layer instance-group inside a segment."""

    name: str
    key: str                    # structural dedup key (cache.layer_cache_key)
    count: int                  # executions (distinct weight sets, see above)
    weight_bytes: int           # per-instance weight footprint
    serial_cycles: float        # count x record cycles (the serial baseline)
    resident_cycles: float      # per-item latency at full cores, weights in
    resident: bool              # a weight-stationary mapping exists
    basis: str = "record"       # mapping behind resident_cycles:
                                # "record" | "greedy" (resident fallback)
    #: count x (basis-mapping energy - record energy); nonzero only for
    #: greedy-basis stages — charged iff the pipelined path is taken, so
    #: scheduled energy always reflects the mappings actually executed.
    energy_delta_pj: float = 0.0
    c_min: int = 1              # capacity floor on allocated cores
    cores: int = 0              # allocated cores (0 until planned)
    t_cycles: float = 0.0       # per-item latency at `cores`

    @property
    def load_bytes(self) -> int:
        return self.count * self.weight_bytes


@dataclasses.dataclass
class SegmentPlan:
    """A contiguous run of stages whose weights are co-resident."""

    stages: list[StagePlan]
    load_cycles: float = 0.0         # one-time weight program-in, whole seg
    compute_cycles: float = 0.0      # pipelined fill + bottleneck
    serial_cycles: float = 0.0       # sum of per-stage serial baselines
    #: "pipelined" iff the weight-resident schedule strictly beats the
    #: serial fallback for this run of stages; "serial" otherwise (either
    #: ineligible — non-resident / oversized — or pipelining simply loses,
    #: e.g. core partitioning costs more than the saved reloads).
    mode: str = "serial"
    allocator: str = "-"             # "mip" | "greedy" | "-"

    @property
    def pipelined_cycles(self) -> float:
        return self.load_cycles + self.compute_cycles

    @property
    def cycles(self) -> float:
        """What the schedule charges: never worse than serial."""
        if self.mode == "pipelined":
            return self.pipelined_cycles
        return self.serial_cycles

    @property
    def packed(self) -> bool:
        """True when the segment genuinely keeps >1 weight-resident
        instance on chip AND the pipelined schedule is the one taken —
        i.e. this segment strictly beats its serial baseline."""
        return self.mode == "pipelined" and \
            sum(st.count for st in self.stages) > 1

    @property
    def energy_delta_pj(self) -> float:
        """Energy adjustment vs the serial records: nonzero only when the
        pipelined path executes greedy-basis (swapped) mappings."""
        if self.mode != "pipelined":
            return 0.0
        return sum(st.energy_delta_pj for st in self.stages)


@dataclasses.dataclass
class Schedule:
    arch_name: str
    segments: list[SegmentPlan]
    serial_cycles: float
    scheduled_cycles: float

    @property
    def n_packed(self) -> int:
        return sum(seg.packed for seg in self.segments)

    @property
    def saved_cycles(self) -> float:
        return self.serial_cycles - self.scheduled_cycles

    @property
    def energy_delta_pj(self) -> float:
        return sum(seg.energy_delta_pj for seg in self.segments)

    def totals(self) -> dict[str, float]:
        return {
            "cycles": self.scheduled_cycles,
            "serial_cycles": self.serial_cycles,
            "saved_cycles": self.saved_cycles,
            "n_segments": float(len(self.segments)),
            "n_packed": float(self.n_packed),
            "energy_delta_pj": self.energy_delta_pj,
        }

    def stage_segment_ids(self) -> list[int]:
        """Segment index of each stage in stream order. Stages are the
        input layers of `schedule_network` in order and segments are
        contiguous, so this is the layer-index -> segment map the
        measured-execution backend (`core/executor.py`) uses to annotate
        its ops with the segment that will execute them."""
        out: list[int] = []
        for i, seg in enumerate(self.segments):
            out += [i] * len(seg.stages)
        return out


# ---------------------------------------------------------------------------
# Per-segment cost: core allocation (MIP + greedy water-filling fallback)
# ---------------------------------------------------------------------------

#: Multi-stage runs whose item streams exceed this are not pipelined
#: (packable segments are naturally small — every instance's weights must
#: fit the macros — so this is a guard, not a working limit).
ITEM_FLOW_CAP = 100_000


def _pipeline_compute(ts: Sequence[float], counts: Sequence[int]) -> float:
    """Fill + bottleneck closed form — the *allocation objective* only
    (linear in the MIP's one-hot terms; exact when stage counts are equal,
    optimistic when a downstream stage has more items than an upstream
    one). Segments are *charged* with the exact item recursion
    (`_exact_compute`), never with this."""
    return sum(ts) + max((n - 1) * t for n, t in zip(counts, ts))


def _exact_compute(ts: Sequence[float], counts: Sequence[int]) -> float:
    """Exact makespan of the index-matched item stream at zero ready time
    — the same recursion `simulator.simulate_segment` replays, so
    ``load + _exact_compute`` upper-bounds the replay (delaying every
    stage's start by at most the full load delays the finish by at most
    the full load)."""
    if len(ts) == 1:
        return counts[0] * ts[0]
    from repro_torch.core.simulator import stream_finish_times
    return max(stream_finish_times(counts, ts, [0.0] * len(ts)))


def _allocate_greedy(stages: Sequence[StagePlan], n_cores: int,
                     t_of) -> list[int]:
    """Water-filling: start every stage at its capacity floor, then hand
    spare cores to whichever stage improves the pipelined makespan most
    (mirroring `network.allocate_budgets`' redistribution). Grants are
    multi-core jumps, not single increments: layer factorizations are
    mostly powers of two, so the latency curve is a staircase and +1 core
    frequently sits on a plateau that +2 escapes."""
    alloc = [st.c_min for st in stages]
    counts = [st.count for st in stages]
    spare = n_cores - sum(alloc)

    def obj(a: list[int]) -> float:
        return _pipeline_compute([t_of(i, c) for i, c in enumerate(a)],
                                 counts)

    cur = obj(alloc)
    while spare > 0:
        best = None                     # (obj, extra_cores, stage index)
        for i in range(len(stages)):
            for extra in range(1, spare + 1):
                trial = list(alloc)
                trial[i] += extra
                o = obj(trial)
                if o < cur - 1e-9 and \
                        (best is None or (o, extra) < best[:2]):
                    best = (o, extra, i)
        if best is None:
            break
        cur, extra, i = best
        alloc[i] += extra
        spare -= extra
    return alloc


def _allocate_mip(stages: Sequence[StagePlan], n_cores: int, t_of,
                  time_limit_s: float = ALLOC_MIP_CAP_S) -> list[int] | None:
    """Exact core split: one-hot core choice per stage, shared core budget,
    makespan epigraph variable. Returns None when the solver yields nothing
    usable (the caller keeps the greedy split)."""
    from repro_torch.core.mip.model import LinExpr, MipModel

    m = MipModel("sched-alloc")
    zero = LinExpr({}, 0.0)
    xs: list[dict[int, object]] = []
    for i, st in enumerate(stages):
        vs = {c: m.add_binary(f"x[{i},{c}]")
              for c in range(st.c_min, n_cores + 1)}
        m.add_eq(sum(vs.values(), zero), 1.0)
        xs.append(vs)
    m.add_le(sum((c * v for vs in xs for c, v in vs.items()), zero),
             float(n_cores))
    z = m.add_var("makespan", 0.0)
    fill = zero
    for i, (st, vs) in enumerate(zip(stages, xs)):
        m.add_ge(z - sum(((st.count - 1) * t_of(i, c)) * v
                         for c, v in vs.items()), 0.0)
        fill = fill + sum((t_of(i, c) * v for c, v in vs.items()), zero)
    m.minimize(z + fill)
    try:
        sol = m.solve(time_limit_s=time_limit_s, mip_rel_gap=0.0)
    except Exception:
        return None
    if not sol.ok:
        return None
    alloc = []
    for vs in xs:
        c = max(vs, key=lambda c: sol[vs[c]])
        if sol[vs[c]] < 0.5:
            return None
        alloc.append(c)
    if sum(alloc) > n_cores:
        return None
    return alloc


def _plan_segment(stages: list[StagePlan], arch: CimArch, n_cores: int,
                  scaling: CoreScaling, *, use_mip: bool,
                  mip_time_limit_s: float,
                  layers_of: dict[str, wl.Layer]) -> SegmentPlan:
    seg = SegmentPlan(stages=stages,
                      serial_cycles=sum(st.serial_cycles for st in stages))
    if any(not st.resident or st.c_min > n_cores for st in stages):
        assert len(stages) == 1, "non-resident stages must be singletons"
        return seg                                  # serial, as recorded

    def t_of(i: int, c: int) -> float:
        st = stages[i]
        return st.resident_cycles * scaling.factor(layers_of[st.key],
                                                   st.key, c)

    counts = [st.count for st in stages]

    def exact_of(a: Sequence[int]) -> float:
        return _exact_compute([t_of(i, c) for i, c in enumerate(a)], counts)

    alloc = _allocate_greedy(stages, n_cores, t_of)
    allocator = "greedy"
    if use_mip and len(stages) > 1:
        mip = _allocate_mip(stages, n_cores, t_of,
                            time_limit_s=mip_time_limit_s)
        # both candidates are judged by the EXACT charge, so the MIP's
        # allocation never loses to the greedy fallback under the metric
        # the segment is actually billed with
        if mip is not None and exact_of(mip) <= exact_of(alloc) + 1e-9:
            alloc, allocator = mip, "mip"
    bw = arch.level(0).bytes_per_cycle()
    load = 0.0
    for i, (st, c) in enumerate(zip(stages, alloc)):
        st.cores = c
        st.t_cycles = t_of(i, c)
        load += math.ceil(st.load_bytes / bw)
    seg.load_cycles = load + arch.mode_switch_cycles
    seg.compute_cycles = exact_of(alloc)
    seg.allocator = allocator
    if seg.pipelined_cycles < seg.serial_cycles:
        seg.mode = "pipelined"
    return seg


# ---------------------------------------------------------------------------
# Schedule: DP over contiguous segmentations
# ---------------------------------------------------------------------------

def schedule_network(layers: Sequence, arch: CimArch, *,
                     boundaries: Sequence[int] | None = None,
                     use_mip: bool = True,
                     mip_time_limit_s: float = ALLOC_MIP_CAP_S,
                     verbose: bool = False) -> Schedule:
    """Schedule a network's solved layers onto the chip.

    ``layers`` is `NetworkResult.layers` (or any sequence of objects with
    ``.layer``, ``.count``, ``.key`` and ``.record``, the record carrying
    the solved ``mapping`` + ``cycles``). Stages keep input order (network
    order is execution order); segmentation is a DP over every contiguous
    split, each segment costed at ``min(pipelined, serial)``, so the total
    is optimal for the segment cost model and never worse than the serial
    sum. The final chosen multi-stage segments are re-allocated with the
    exact MIP (greedy fallback, never worse).

    ``boundaries`` marks indices where a new *independent* layer stream
    starts (e.g. the next (model, scenario) workload in a pooled
    benchmark call): no segment may span one — scheduling across
    unrelated networks would fabricate pipelining that can never
    execute."""
    ax = core_axis(arch)
    n_cores = ax.size if ax is not None else 1
    core_bytes = chip_macro_bytes(arch) // max(n_cores, 1)
    scaling = CoreScaling(arch)

    # ---- stage list (one per input layer record, input order) -------------
    # A stage is pipeline-eligible when a weight-stationary mapping exists
    # for it: the record's own mapping when it is resident, else the greedy
    # incumbent's (the per-layer MIP minimizes *solo* latency and may
    # happily stream weights — network-level residency is exactly the
    # objective it cannot see, so the scheduler may swap mappings; the
    # serial baseline always keeps the record's number and the min() guard
    # keeps the swap strictly-improving-or-ignored).
    from repro_torch.core.baselines import greedy_mapping
    from repro_torch.core.energy import evaluate_edp

    stages: list[StagePlan] = []
    layers_of: dict[str, wl.Layer] = {}
    # key -> (resident, resident_cycles, basis, per-instance energy delta)
    basis_of: dict[str, tuple[bool, float, str, float]] = {}
    for lr in layers:
        key = lr.key
        layers_of.setdefault(key, lr.layer)
        if key not in basis_of:
            if lr.layer.weight_written:
                # produced stationary operand: never resident, and the
                # greedy weight-stationary swap has nothing to offer
                basis_of[key] = (False, 0.0, "record", 0.0)
        if key not in basis_of:
            mp = mapping_from_json(lr.record["mapping"])
            resident, fill = weight_residency(mp, lr.layer, arch)
            if resident:
                basis_of[key] = (True, max(lr.record["cycles"] - fill, 1.0),
                                 "record", 0.0)
            else:
                gmp = greedy_mapping(lr.layer, arch)
                g_res, g_fill = weight_residency(gmp, lr.layer, arch)
                if g_res:
                    g = evaluate_edp(gmp, lr.layer, arch)
                    basis_of[key] = (
                        True, max(g.latency.total_cycles - g_fill, 1.0),
                        "greedy",
                        g.energy.total_pj - lr.record["energy_pj"])
                else:
                    basis_of[key] = (False, 0.0, "record", 0.0)
        resident, rc, basis, de = basis_of[key]
        w = weight_bytes(lr.layer)
        c_min = max(1, math.ceil(lr.count * w / max(core_bytes, 1)))
        stages.append(StagePlan(
            name=lr.layer.name, key=key, count=int(lr.count),
            weight_bytes=w,
            serial_cycles=lr.count * lr.record["cycles"],
            resident_cycles=rc, resident=resident, basis=basis,
            energy_delta_pj=lr.count * de, c_min=c_min))

    # ---- DP over contiguous splits ----------------------------------------
    # cost(i, j) = min(pipelined, serial) for stages[i:j]; a run is
    # pipeline-eligible iff every stage is resident and the capacity floors
    # fit the core budget together. Greedy allocation inside the DP (cheap,
    # memoized probes); the exact MIP refines the winning segmentation.
    n = len(stages)
    best = [0.0] + [math.inf] * n
    cut = [0] * (n + 1)
    cuts_inside = sorted(b for b in set(boundaries or ()) if 0 < b < n)

    def run_cost(i: int, j: int) -> float:
        if any(i < b < j for b in cuts_inside):
            return math.inf           # independent streams never co-pack
        sub = stages[i:j]
        if len(sub) > 1 and (
                any(not st.resident for st in sub) or
                sum(st.c_min for st in sub) > n_cores or
                sum(st.count for st in sub) > ITEM_FLOW_CAP):
            return math.inf
        seg = _plan_segment([dataclasses.replace(st) for st in sub],
                            arch, n_cores, scaling, use_mip=False,
                            mip_time_limit_s=mip_time_limit_s,
                            layers_of=layers_of)
        return seg.cycles

    for j in range(1, n + 1):
        for i in range(j - 1, -1, -1):
            if j - i > n_cores:        # each stage needs >= 1 core
                break
            c = run_cost(i, j)
            if best[i] + c < best[j]:
                best[j], cut[j] = best[i] + c, i
            if c == math.inf and j - i > 1:
                break                  # longer runs only get harder

    # ---- materialize the chosen segments (exact-MIP refinement) -----------
    bounds: list[tuple[int, int]] = []
    j = n
    while j > 0:
        bounds.append((cut[j], j))
        j = cut[j]
    bounds.reverse()
    segments = [
        _plan_segment(stages[i:j], arch, n_cores, scaling,
                      use_mip=use_mip, mip_time_limit_s=mip_time_limit_s,
                      layers_of=layers_of)
        for i, j in bounds]

    serial = sum(st.serial_cycles for st in stages)
    scheduled = sum(seg.cycles for seg in segments)
    if verbose:
        packed = sum(seg.packed for seg in segments)
        print(f"[scheduler/{arch.name}] {n} stages -> {len(segments)} "
              f"segments ({packed} packed): {serial:.4g} serial -> "
              f"{scheduled:.4g} scheduled cycles")
    return Schedule(arch_name=arch.name, segments=segments,
                    serial_cycles=serial, scheduled_cycles=scheduled)


# ---------------------------------------------------------------------------
# Event-simulator cross-check (the Fig. 4(a) discipline, network mode)
# ---------------------------------------------------------------------------

def cross_check(schedule: Schedule, arch: CimArch, *,
                max_items: int = 100_000) -> tuple[float, int]:
    """(mean accuracy, n segments checked) of the analytical segment model
    against `simulator.simulate_segment` over every pipelined segment small
    enough to replay. Accuracy per segment is 1 - |model - sim| / sim —
    the exact metric the Fig. 4(a) benchmark and `test_latency_model`'s
    simulator-agreement gate use for single layers."""
    from repro_torch.core.simulator import simulate_segment

    accs = []
    for seg in schedule.segments:
        if seg.mode != "pipelined":
            continue
        if sum(st.count for st in seg.stages) > max_items:
            continue
        sim = simulate_segment(
            [(st.count, st.t_cycles, st.load_bytes) for st in seg.stages],
            arch)
        accs.append(1.0 - abs(seg.pipelined_cycles - sim.total_cycles) /
                    max(sim.total_cycles, 1.0))
    return (sum(accs) / len(accs) if accs else 1.0), len(accs)


# ---------------------------------------------------------------------------
# Mesh schedule: one-hot (chip, core) placement over a MeshArch
# ---------------------------------------------------------------------------
# The single-chip machinery above generalizes to `mesh.MeshArch` one level
# up (DESIGN.md §Mesh optimization): stages carry their *sub-layer* (the
# per-chip shard the mesh record solved), replicate stages place one-hot on
# a (chip, cores) pair, split stages occupy every chip symmetrically (the
# shard is an SPMD decomposition — c cores on each chip), and the segment
# cost adds two mesh terms the single-chip model has no concept of:
# per-item shard communication (`comm_cycles`, inside t_i — it recurs every
# item) and the inter-chip activation hop between adjacent stages hosted on
# different chips (`xfer_cycles`, threaded into the exact item recursion
# via `simulator.stream_finish_times`' xfer argument). Placement candidates
# are judged by that exact charge — xfer included — so the placement MIP
# never loses to the greedy water-filling fallback under the metric the
# segment is billed with, the same discipline `_plan_segment` applies.
# Weight program-ins of ALL chips serialize on one shared DRAM channel
# (the conservative single-host-memory assumption `simulate_segment`
# replays); per-chip residency capacity bounds what each chip holds.


@dataclasses.dataclass
class MeshStagePlan(StagePlan):
    """One layer instance-group of a mesh segment. `weight_bytes` is the
    PER-CHIP sub-layer footprint (the full layer's for replicate); `chip`
    is the host placement (-1 = split stage, resident on every chip)."""

    sub_key: str = ""           # structural key of the per-chip sub-layer
    choice: str = "replicate"   # mesh.SHARD_CHOICES member
    span_all: bool = False      # split stage: occupies all chips
    n_active: int = 1           # chips computing (DRAM-load multiplier)
    comm_cycles: float = 0.0    # per-item shard communication (in t_cycles)
    out_bytes: int = 0          # per-item activation output (xfer volume)
    chip: int = -1              # host chip (replicate) or -1 (split)
    xfer_cycles: float = 0.0    # per-item hop from the upstream stage

    @property
    def total_load_bytes(self) -> int:
        """DRAM bytes programmed across all chips holding this stage."""
        return self.count * self.weight_bytes * self.n_active


def _mesh_hosts(stages: Sequence[MeshStagePlan],
                chips: Sequence[int]) -> list[int]:
    """Activation host chip per stage: a split stage's traffic is anchored
    at chip 0 by convention (its input broadcast/scatter originates there
    and the gather/all-reduce result lands there — `mesh.shard_eval`)."""
    return [g if g >= 0 else 0 for g in chips]


def _mesh_exact(stages: Sequence[MeshStagePlan], chips: Sequence[int],
                cores: Sequence[int], mesh, t_of) -> float:
    """Exact makespan of the placed item stream at zero ready time — the
    recursion `simulate_segment` replays, with the per-item inter-chip
    activation hop between differently-hosted adjacent stages."""
    from repro_torch.core.latency import link_transfer_cycles
    from repro_torch.core.simulator import stream_finish_times

    ts = [t_of(i, c) for i, c in enumerate(cores)]
    counts = [st.count for st in stages]
    if len(stages) == 1:
        return counts[0] * ts[0]
    hosts = _mesh_hosts(stages, chips)
    xfer = [0.0] + [
        link_transfer_cycles(stages[i - 1].out_bytes, mesh.link,
                             mesh.chip_distance(hosts[i - 1], hosts[i]))
        for i in range(1, len(stages))]
    return max(stream_finish_times(counts, ts, [0.0] * len(ts), xfer))


def _mesh_place_greedy(stages: Sequence[MeshStagePlan], mesh, n_cores: int,
                       t_of) -> tuple[list[int], list[int]] | None:
    """Water-filling placement: reserve every split stage on all chips,
    place replicate stages (heaviest first) on the chip with the most free
    macro bytes, then hand spare cores to whichever stage improves the
    pipelined makespan most (`_allocate_greedy`'s multi-core jumps; a
    split stage's grant consumes cores on EVERY chip). None when the
    stages do not co-fit the mesh."""
    n_chips = mesh.n_chips
    cap = chip_macro_bytes(mesh.chip)
    free_b = [float(cap)] * n_chips
    free_c = [n_cores] * n_chips
    chips = [-1] * len(stages)
    for st in stages:
        if st.span_all:
            for g in range(n_chips):
                free_b[g] -= st.load_bytes
                free_c[g] -= st.c_min
    if any(b < 0 for b in free_b) or any(c < 0 for c in free_c):
        return None
    order = sorted((i for i, st in enumerate(stages) if not st.span_all),
                   key=lambda i: -stages[i].load_bytes)
    for i in order:
        st = stages[i]
        cand = [g for g in range(n_chips)
                if free_b[g] >= st.load_bytes and free_c[g] >= st.c_min]
        if not cand:
            return None
        g = max(cand, key=lambda g: (free_b[g], -g))
        chips[i] = g
        free_b[g] -= st.load_bytes
        free_c[g] -= st.c_min

    alloc = [st.c_min for st in stages]
    counts = [st.count for st in stages]

    def obj(a: list[int]) -> float:
        return _pipeline_compute([t_of(i, c) for i, c in enumerate(a)],
                                 counts)

    def spare_for(i: int) -> int:
        return min(free_c) if stages[i].span_all else free_c[chips[i]]

    cur = obj(alloc)
    while True:
        best = None                     # (obj, extra_cores, stage index)
        for i in range(len(stages)):
            for extra in range(1, spare_for(i) + 1):
                trial = list(alloc)
                trial[i] += extra
                o = obj(trial)
                if o < cur - 1e-9 and \
                        (best is None or (o, extra) < best[:2]):
                    best = (o, extra, i)
        if best is None:
            break
        cur, extra, i = best
        alloc[i] += extra
        if stages[i].span_all:
            for g in range(len(free_c)):
                free_c[g] -= extra
        else:
            free_c[chips[i]] -= extra
    return chips, alloc


def _mesh_place_mip(stages: Sequence[MeshStagePlan], mesh, n_cores: int,
                    t_of, time_limit_s: float = ALLOC_MIP_CAP_S
                    ) -> tuple[list[int], list[int]] | None:
    """Exact joint placement: the segment MIP generalized from one-hot
    core choice (`_allocate_mip`) to one-hot **(chip, cores)** choice per
    replicate stage — split stages keep a one-hot cores choice applied on
    every chip — under per-chip core budgets, per-chip residency byte
    capacity and the shared makespan epigraph. Returns None when the
    solver yields nothing usable (the caller keeps the greedy placement)."""
    from repro_torch.core.mip.model import LinExpr, MipModel

    n_chips = mesh.n_chips
    cap = chip_macro_bytes(mesh.chip)
    cap_eff = float(cap) - sum(st.load_bytes for st in stages
                               if st.span_all)
    if cap_eff < 0:
        return None
    m = MipModel("mesh-alloc")
    zero = LinExpr({}, 0.0)
    sel: list[dict] = []                 # stage -> {option: Var}
    for i, st in enumerate(stages):
        crange = range(st.c_min, n_cores + 1)
        if st.span_all:
            opts = list(crange)
        else:
            opts = [(g, c) for g in range(n_chips) for c in crange]
        if not opts:
            return None
        sel.append(m.add_choice(f"x[{i}]", opts))
    for g in range(n_chips):
        cores_g = zero
        bytes_g = zero
        for st, vs in zip(stages, sel):
            if st.span_all:
                cores_g = cores_g + sum((c * v for c, v in vs.items()),
                                        zero)
            else:
                cores_g = cores_g + sum((c * v for (gg, c), v in vs.items()
                                         if gg == g), zero)
                bytes_g = bytes_g + sum(
                    (float(st.load_bytes) * v for (gg, _), v in vs.items()
                     if gg == g), zero)
        m.add_le(cores_g, float(n_cores))
        m.add_le(bytes_g, cap_eff)
    z = m.add_var("makespan", 0.0)
    fill = zero

    def cores_of(opt):
        return opt if isinstance(opt, int) else opt[1]

    for i, (st, vs) in enumerate(zip(stages, sel)):
        m.add_ge(z - sum((((st.count - 1) * t_of(i, cores_of(o))) * v
                          for o, v in vs.items()), zero), 0.0)
        fill = fill + sum((t_of(i, cores_of(o)) * v
                           for o, v in vs.items()), zero)
    m.minimize(z + fill)
    try:
        sol = m.solve(time_limit_s=time_limit_s, mip_rel_gap=0.0)
    except Exception:
        return None
    if not sol.ok:
        return None
    chips, alloc = [], []
    for st, vs in zip(stages, sel):
        o = max(vs, key=lambda o: sol[vs[o]])
        if sol[vs[o]] < 0.5:
            return None
        if st.span_all:
            chips.append(-1)
            alloc.append(o)
        else:
            chips.append(o[0])
            alloc.append(o[1])
    # re-verify the budgets the way _allocate_mip re-verifies its core sum
    for g in range(n_chips):
        used_c = sum(c for st, gg, c in zip(stages, chips, alloc)
                     if st.span_all or gg == g)
        used_b = sum(st.load_bytes for st, gg in zip(stages, chips)
                     if not st.span_all and gg == g)
        if used_c > n_cores or used_b > cap_eff + 1e-6:
            return None
    return chips, alloc


def _plan_mesh_segment(stages: list[MeshStagePlan], mesh,
                       scaling: CoreScaling, *, use_mip: bool,
                       mip_time_limit_s: float,
                       layers_of: dict[str, wl.Layer]) -> SegmentPlan:
    """Mesh counterpart of `_plan_segment`: same SegmentPlan contract
    (min(pipelined, serial) charging, exact-judged MIP-over-greedy), with
    placement instead of bare core allocation. A multi-stage run that does
    not co-fit the mesh simply stays serial (equivalent to the DP's
    singleton split, never wrong)."""
    chip = mesh.chip
    ax = core_axis(chip)
    n_cores = ax.size if ax is not None else 1
    seg = SegmentPlan(stages=stages,
                      serial_cycles=sum(st.serial_cycles for st in stages))
    if any(not st.resident or st.c_min > n_cores for st in stages):
        assert len(stages) == 1, "non-resident stages must be singletons"
        return seg

    def t_of(i: int, c: int) -> float:
        st = stages[i]
        return st.resident_cycles * scaling.factor(
            layers_of[st.sub_key], st.sub_key, c) + st.comm_cycles

    placed = _mesh_place_greedy(stages, mesh, n_cores, t_of)
    if placed is None:
        return seg                                  # does not co-fit: serial
    allocator = "greedy"

    def exact_of(p: tuple[list[int], list[int]]) -> float:
        return _mesh_exact(stages, p[0], p[1], mesh, t_of)

    if use_mip and len(stages) > 1:
        mip = _mesh_place_mip(stages, mesh, n_cores, t_of,
                              time_limit_s=mip_time_limit_s)
        if mip is not None and exact_of(mip) <= exact_of(placed) + 1e-9:
            placed, allocator = mip, "mip"
    chips, alloc = placed
    from repro_torch.core.latency import link_transfer_cycles
    hosts = _mesh_hosts(stages, chips)
    bw = chip.level(0).bytes_per_cycle()
    load = 0.0
    for i, (st, g, c) in enumerate(zip(stages, chips, alloc)):
        st.chip = g
        st.cores = c
        st.t_cycles = t_of(i, c)
        st.xfer_cycles = 0.0 if i == 0 else link_transfer_cycles(
            stages[i - 1].out_bytes, mesh.link,
            mesh.chip_distance(hosts[i - 1], hosts[i]))
        load += math.ceil(st.total_load_bytes / bw)
    seg.load_cycles = load + chip.mode_switch_cycles
    seg.compute_cycles = exact_of(placed)
    seg.allocator = allocator
    if seg.pipelined_cycles < seg.serial_cycles:
        seg.mode = "pipelined"
    return seg


def schedule_mesh(layers: Sequence, mesh, *,
                  boundaries: Sequence[int] | None = None,
                  use_mip: bool = True,
                  mip_time_limit_s: float = ALLOC_MIP_CAP_S,
                  verbose: bool = False) -> Schedule:
    """Schedule a network's *mesh* records (`mesh.optimize_mesh_network`)
    onto a `mesh.MeshArch` — `schedule_network` one level up. A 1-chip
    mesh IS the chip: delegate, bit for bit.

    Stage basis mirrors `schedule_network` exactly, applied to each
    record's **sub-layer** (reconstructed from the record's shard
    decomposition): residency/fill from the sub-mapping on ``mesh.chip``,
    the greedy weight-stationary swap when the record's own mapping
    streams weights, core-sensitivity via the chip's `CoreScaling`. On
    top, each stage's per-item latency carries its shard communication
    (``+ comm_cycles``, not core-scaled — link time does not shrink with
    cores) and segments pay per-item activation hops between
    differently-hosted adjacent stages."""
    from repro_torch.core.mesh import (REPLICATE, out_bytes_per_elem,
                                 shard_sub_layer)
    from repro_torch.core.arch import OUTPUT

    if mesh.n_chips <= 1:
        return schedule_network(layers, mesh.chip, boundaries=boundaries,
                                use_mip=use_mip,
                                mip_time_limit_s=mip_time_limit_s,
                                verbose=verbose)
    chip = mesh.chip
    ax = core_axis(chip)
    n_cores = ax.size if ax is not None else 1
    core_bytes = chip_macro_bytes(chip) // max(n_cores, 1)
    scaling = CoreScaling(chip)

    from repro_torch.core.baselines import greedy_mapping
    from repro_torch.core.energy import evaluate_edp

    stages: list[MeshStagePlan] = []
    layers_of: dict[str, wl.Layer] = {}
    # full-layer key -> (resident, resident_cycles, basis, per-instance
    # energy delta) — the shard choice is a function of the full-layer key
    # within one mesh solve, so the memo stays keyed like schedule_network's
    basis_of: dict[str, tuple[bool, float, str, float]] = {}
    for lr in layers:
        rec = lr.record
        shard = rec.get("shard") or {}
        choice = shard.get("choice", REPLICATE)
        n_active = int(shard.get("n_active", 1))
        sub = shard_sub_layer(lr.layer, choice, mesh.n_chips)
        sub_key = layer_cache_key(sub)
        layers_of.setdefault(sub_key, sub)
        chip_cycles = float(rec.get("chip_cycles", rec["cycles"]))
        chip_energy = float(rec.get("chip_energy_pj", rec["energy_pj"]))
        comm = float(rec.get("comm_cycles", 0.0))
        if lr.key not in basis_of and sub.weight_written:
            # produced stationary operand (wGrad shard): never resident
            basis_of[lr.key] = (False, 0.0, "record", 0.0)
        if lr.key not in basis_of:
            mp = mapping_from_json(rec["mapping"])
            resident, fill = weight_residency(mp, sub, chip)
            if resident:
                basis_of[lr.key] = (True, max(chip_cycles - fill, 1.0),
                                    "record", 0.0)
            else:
                gmp = greedy_mapping(sub, chip)
                g_res, g_fill = weight_residency(gmp, sub, chip)
                if g_res:
                    g = evaluate_edp(gmp, sub, chip)
                    basis_of[lr.key] = (
                        True, max(g.latency.total_cycles - g_fill, 1.0),
                        "greedy",
                        n_active * (g.energy.total_pj - chip_energy))
                else:
                    basis_of[lr.key] = (False, 0.0, "record", 0.0)
        resident, rc, basis, de = basis_of[lr.key]
        w = weight_bytes(sub)
        c_min = max(1, math.ceil(lr.count * w / max(core_bytes, 1)))
        stages.append(MeshStagePlan(
            name=lr.layer.name, key=lr.key, count=int(lr.count),
            weight_bytes=w,
            serial_cycles=lr.count * rec["cycles"],
            resident_cycles=rc, resident=resident, basis=basis,
            energy_delta_pj=lr.count * de, c_min=c_min,
            sub_key=sub_key, choice=choice,
            span_all=choice != REPLICATE, n_active=n_active,
            comm_cycles=comm,
            out_bytes=lr.layer.operand_elems(OUTPUT) *
            out_bytes_per_elem(lr.layer)))

    # ---- DP over contiguous splits (schedule_network's, mesh budgets) -----
    n = len(stages)
    n_chips = mesh.n_chips
    best = [0.0] + [math.inf] * n
    cut = [0] * (n + 1)
    cuts_inside = sorted(b for b in set(boundaries or ()) if 0 < b < n)

    def run_cost(i: int, j: int) -> float:
        if any(i < b < j for b in cuts_inside):
            return math.inf           # independent streams never co-pack
        sub = stages[i:j]
        if len(sub) > 1 and (
                any(not st.resident for st in sub) or
                sum(st.c_min * (n_chips if st.span_all else 1)
                    for st in sub) > n_chips * n_cores or
                sum(st.count for st in sub) > ITEM_FLOW_CAP):
            return math.inf
        seg = _plan_mesh_segment([dataclasses.replace(st) for st in sub],
                                 mesh, scaling, use_mip=False,
                                 mip_time_limit_s=mip_time_limit_s,
                                 layers_of=layers_of)
        return seg.cycles

    for j in range(1, n + 1):
        for i in range(j - 1, -1, -1):
            if j - i > n_chips * n_cores:   # each stage needs >= 1 core
                break
            c = run_cost(i, j)
            if best[i] + c < best[j]:
                best[j], cut[j] = best[i] + c, i
            if c == math.inf and j - i > 1:
                break                  # longer runs only get harder

    bounds: list[tuple[int, int]] = []
    j = n
    while j > 0:
        bounds.append((cut[j], j))
        j = cut[j]
    bounds.reverse()
    segments = [
        _plan_mesh_segment(stages[i:j], mesh, scaling, use_mip=use_mip,
                           mip_time_limit_s=mip_time_limit_s,
                           layers_of=layers_of)
        for i, j in bounds]

    serial = sum(st.serial_cycles for st in stages)
    scheduled = sum(seg.cycles for seg in segments)
    if verbose:
        packed = sum(seg.packed for seg in segments)
        print(f"[scheduler/{mesh.name}] {n} stages -> {len(segments)} "
              f"segments ({packed} packed, {n_chips} chips): "
              f"{serial:.4g} serial -> {scheduled:.4g} scheduled cycles")
    return Schedule(arch_name=mesh.name, segments=segments,
                    serial_cycles=serial, scheduled_cycles=scheduled)


def cross_check_mesh(schedule: Schedule, mesh, *,
                     max_items: int = 100_000) -> tuple[float, int]:
    """`cross_check` for mesh schedules: replay every pipelined segment
    through `simulator.simulate_segment` in network mode — total DRAM
    load bytes across all chips holding each stage, per-item inter-chip
    activation hops as the 4th stage element — and report the same
    Fig. 4(a) mean-accuracy metric."""
    from repro_torch.core.simulator import simulate_segment

    accs = []
    for seg in schedule.segments:
        if seg.mode != "pipelined":
            continue
        if sum(st.count for st in seg.stages) > max_items:
            continue
        sim = simulate_segment(
            [(st.count, st.t_cycles, st.total_load_bytes, st.xfer_cycles)
             for st in seg.stages], mesh.chip)
        accs.append(1.0 - abs(seg.pipelined_cycles - sim.total_cycles) /
                    max(sim.total_cycles, 1.0))
    return (sum(accs) / len(accs) if accs else 1.0), len(accs)
