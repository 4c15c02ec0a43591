"""Discrete-event pipeline simulator (the paper's "detailed hardware
simulation", §V-A) used to validate the analytical latency model (Fig 4a).

Simulates the mapped loop nest iteration-by-iteration with explicit:
  * per-link transfer channels (serialized on each source level's bus),
  * single/double buffer occupancy per (operand, destination level) —
    single: the next tile transfer must wait until the current tile's last
    consumer finishes (mutually-exclusive access, Fig. 2(b));
    double: one prefetch outstanding (half-capacity already enforced by the
    mapping validator),
  * operand synchronization — an MVM fires only when BOTH its input and
    weight chunks have arrived (Fig. 2(c)),
  * CIM mode-switch stalls — weight reloads into the macro array require
    compute to drain, pay ``mode_switch_cycles``, and never overlap MVMs
    (Fig. 2(a)),
  * output write-back — single-buffered output registers block the next MVM
    until the previous chunk drains (Fig. 2(c)).

This is an independent implementation sharing only the tile-geometry helpers
with latency.py, so agreement between the two is meaningful evidence.

Call path: the optimizers and the network pipeline score mappings with the
analytical model (`latency.evaluate` via `energy.evaluate_edp` — DESIGN.md
§Network pipeline); the simulator is the *out-of-band* cross-check, driven
by `benchmarks/fig4a_model_accuracy.py` (accuracy over sampled mappings)
and `examples/quickstart.py` (single-layer sanity check). It never sits on
the solve path. `simulate_segment` is the *network-mode* counterpart: it
replays one weight-resident segment of the multi-core scheduler
(`core/scheduler.py`) and cross-checks the analytical schedule model the
same way (`scheduler.cross_check`, `benchmarks/sched_lm.py`).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import workload as wl
from repro_torch.core.arch import CimArch, INPUT, OPERANDS, OUTPUT, WEIGHT
from repro_torch.core.mapping import Mapping


@dataclasses.dataclass
class Hop:
    operand: str
    src: int                 # source level (owns the bus channel)
    dst: int                 # destination level
    chunk_cycles: int        # per-transfer cycles (incl. mode switch)
    watch: tuple[int, ...]   # temporal slot indices whose change retriggers
    double: bool
    is_macro_reload: bool


def _build_hops(mapping: Mapping, layer: wl.Layer, arch: CimArch) -> list[Hop]:
    hops: list[Hop] = []
    for lam in OPERANDS:
        used = mapping.used_levels(lam)
        if not used or used[0] != 0:
            used = [0] + used
        for src, dst in zip(used, used[1:]):
            # chunk = B^T at the source level (same as Mapping.transfer_bytes
            # and the MIP's TC: full multicast traffic, source precision).
            chunk = mapping.transfer_bytes(layer, lam, arch, src)
            bw = mapping.eff_bw_bytes(arch, src)
            cyc = math.ceil(chunk / bw)
            reload = lam == WEIGHT and dst == arch.macro_level
            if reload:
                cyc += arch.mode_switch_cycles
            watch = tuple(
                i for i, (dim, _) in enumerate(mapping.temporal)
                if mapping.level_of[lam][i] < dst and wl.is_relevant(dim, lam))
            dbl = mapping.is_double_buffered(lam, dst, arch) and not reload
            hops.append(Hop(lam, src, dst, cyc, watch, dbl, reload))
    return hops


@dataclasses.dataclass
class SimReport:
    total_cycles: float
    mvm_count: int
    stall_breakdown: dict[str, float]


def simulate(mapping: Mapping, layer: wl.Layer, arch: CimArch,
             max_iters: int = 2_000_000) -> SimReport:
    slots = mapping.temporal
    n_slots = len(slots)
    iters = math.prod(f for _, f in slots)
    if iters > max_iters:
        raise ValueError(f"temporal space {iters} > max_iters {max_iters}")

    hops = _build_hops(mapping, layer, arch)
    in_hops = [h for h in hops if h.operand in (INPUT, WEIGHT)]
    out_hops = [h for h in hops if h.operand == OUTPUT]
    l_mvm = arch.l_mvm_cycles

    # State -----------------------------------------------------------------
    chan_free = [0.0] * arch.n_levels          # per source-level bus
    compute_free = 0.0
    # per-hop: time current tile became ready; release times of buffer slots
    ready = [0.0] * len(hops)
    # buffer slot release times (len 1 = single, 2 = double)
    slots_free: list[list[float]] = [
        [0.0] * (2 if h.double else 1) for h in hops]
    last_consume = [0.0] * len(hops)
    stalls = {"transfer_wait": 0.0, "mode_switch": 0.0, "writeback": 0.0}

    # First fill: every inbound hop transfers its first chunk at t=0,
    # respecting hierarchy order (parent before child).
    order = sorted(range(len(hops)), key=lambda k: hops[k].dst)
    parent_ready: dict[tuple[str, int], float] = {}

    def do_transfer(k: int, now: float) -> float:
        h = hops[k]
        pr = parent_ready.get((h.operand, h.src), 0.0)
        sf = min(slots_free[k])
        start = max(now, chan_free[h.src], pr, sf)
        if h.is_macro_reload:
            start = max(start, compute_free)
        end = start + h.chunk_cycles
        chan_free[h.src] = end
        # occupy the freed slot; the true release time is set when the
        # tile is retired (on the next transfer for this hop).
        i = slots_free[k].index(sf)
        slots_free[k][i] = end
        parent_ready[(h.operand, h.dst)] = end
        return end

    counters = [0] * n_slots
    total_mvm = 0
    now = 0.0
    for k in order:
        if hops[k].operand != OUTPUT:
            ready[k] = do_transfer(k, 0.0)

    for it in range(iters):
        changed = set()
        if it > 0:
            # odometer increment, innermost first
            for pos in range(n_slots - 1, -1, -1):
                counters[pos] += 1
                changed.add(pos)
                if counters[pos] < slots[pos][1]:
                    break
                counters[pos] = 0
            else:
                pass
        # retrigger transfers whose watched loops changed
        if it > 0:
            for k in order:
                h = hops[k]
                if h.operand == OUTPUT:
                    continue
                if changed & set(h.watch):
                    # retire old tile: slot frees when last consumer done
                    j = slots_free[k].index(min(slots_free[k]))
                    slots_free[k][j] = last_consume[k]
                    ready[k] = do_transfer(k, now)
        # operand sync: innermost input+weight chunks must be present
        t_ready = now
        for k, h in enumerate(hops):
            if h.operand != OUTPUT and h.dst == mapping.deepest_used(h.operand):
                t_ready = max(t_ready, ready[k])
        stalls["transfer_wait"] += max(0.0, t_ready - max(now, compute_free))
        start = max(t_ready, compute_free)
        end = start + l_mvm
        compute_free = end
        for k, h in enumerate(hops):
            if h.operand != OUTPUT:
                last_consume[k] = end
        total_mvm += 1
        now = end
        # output write-back per hop when its watched loops will change next
        # (drain at tile boundary). Approximate: drain the innermost output
        # hop every iteration group where the output tile index changes.
        for k, h in enumerate(hops):
            if h.operand != OUTPUT:
                continue
            nxt_change = _will_change(counters, slots, h.watch)
            if nxt_change or it == iters - 1:
                sf = min(slots_free[k])
                start_t = max(now, chan_free[h.src], sf)
                end_t = start_t + h.chunk_cycles
                chan_free[h.src] = end_t
                j = slots_free[k].index(sf)
                slots_free[k][j] = end_t
                if not h.double:
                    stalls["writeback"] += max(0.0, end_t - now)
                    compute_free = max(compute_free, end_t)
                now = max(now, min(end_t, compute_free)) if h.double else now

    # drain channels
    final = max([compute_free] + chan_free)
    return SimReport(total_cycles=final, mvm_count=total_mvm,
                     stall_breakdown=stalls)


# ---------------------------------------------------------------------------
# Network mode: segment-level event simulation (DESIGN.md §Network scheduler)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SegmentSimReport:
    total_cycles: float
    load_cycles: float          # when the last weight program-in leaves the bus
    stage_finish: list[float]   # per stage, its last item's completion time


def stream_finish_times(counts, ts, ready, xfer=None) -> list[float]:
    """Last-item finish time per stage of the index-matched item stream:
    item k of stage i starts after item k-1 on the same stage AND item
    min(k, count_{i-1}-1) of the upstream stage, each item taking ``ts[i]``
    cycles, stage i's first item not before ``ready[i]``. This recursion IS
    the segment dependency structure — `simulate_segment` replays it with
    bus-serialized ready times, and the scheduler charges its segments
    with the zero-ready evaluation (`scheduler`), so the two can never
    encode different pipelines.

    ``xfer`` (mesh network mode) is a per-stage inter-chip activation
    transfer: when adjacent stages of a segment live on different chips,
    the upstream item must additionally cross ``xfer[i]`` cycles of links
    before stage i may consume it (`latency.link_transfer_cycles` over the
    host-chip distance — `scheduler.schedule_mesh`). ``None`` or all-zero
    is exactly the single-chip recursion."""
    finish_prev: list[float] | None = None
    out: list[float] = []
    xfer = [0.0] * len(counts) if xfer is None else list(xfer)
    for n, t, rdy, x in zip(counts, ts, ready, xfer):
        fin = [0.0] * n
        cur = float(rdy)
        for k in range(n):
            dep = 0.0
            if finish_prev is not None:
                dep = finish_prev[min(k, len(finish_prev) - 1)] + x
            fin[k] = max(cur, dep) + t
            cur = fin[k]
        finish_prev = fin
        out.append(fin[-1])
    return out


def simulate_segment(stages, arch: CimArch,
                     max_items: int = 1_000_000) -> SegmentSimReport:
    """Event-driven replay of one weight-resident segment — the network-mode
    counterpart of `simulate` that validates the scheduler's analytical
    segment model (`scheduler._pipeline_compute` + load term) the way
    Fig. 4(a) validates `latency.evaluate` for single layers.

    ``stages`` is an ordered sequence of ``(count, t_cycles, load_bytes)``
    triples (what `scheduler.SegmentPlan` stages carry): ``count`` items of
    ``t_cycles`` each, with ``load_bytes`` of weights programmed into the
    stage's macros before its first item. Mesh network mode appends a 4th
    element, ``xfer_cycles``: the per-item inter-chip activation hop from
    the upstream stage's host chip (`scheduler.schedule_mesh`), threaded
    into the item recursion via `stream_finish_times`' ``xfer``.
    Mechanics, reusing the single-layer machinery's conventions:

      * every weight program-in is a `Hop` (DRAM -> macro, macro-reload) and
        all of them serialize on the DRAM bus channel (``chan_free[0]``,
        exactly like `simulate`'s per-source-level channels); the stage's
        cores then pay ``mode_switch_cycles`` off-bus before computing;
      * items stream: item k of stage i starts after item k-1 on the same
        stage's cores AND item min(k, count_{i-1}-1) of the upstream stage
        (GBuf->GBuf activation streaming; index-matched, surplus downstream
        items follow the last upstream item — `stream_finish_times`, the
        same recursion the scheduler charges its segments with).

    Unlike the analytical model — which conservatively serializes the whole
    segment load before any compute — the replay lets early stages compute
    while later stages' weights still stream, so it never finishes later;
    agreement within the Fig. 4(a) tolerance is what
    `scheduler.cross_check` asserts."""
    stages = [(int(s[0]), float(s[1]), int(s[2]),
               float(s[3]) if len(s) > 3 else 0.0) for s in stages]
    if sum(n for n, _, _, _ in stages) > max_items:
        raise ValueError(f"segment items exceed max_items {max_items}")
    bw = arch.level(0).bytes_per_cycle()
    chan_free = [0.0] * arch.n_levels
    hops = [Hop(WEIGHT, 0, arch.macro_level, math.ceil(b / bw), (),
                False, True) for _, _, b, _ in stages]
    ready: list[float] = []
    for hop in hops:
        start = chan_free[hop.src]
        chan_free[hop.src] = start + hop.chunk_cycles
        ready.append(chan_free[hop.src] + arch.mode_switch_cycles)
    load_cycles = chan_free[0]

    stage_finish = stream_finish_times(
        [n for n, _, _, _ in stages], [t for _, t, _, _ in stages], ready,
        xfer=[x for _, _, _, x in stages])
    total = max(stage_finish + [load_cycles])
    return SegmentSimReport(total_cycles=total, load_cycles=load_cycles,
                            stage_finish=stage_finish)


def _will_change(counters: list[int], slots, watch: tuple[int, ...]) -> bool:
    """True if the next odometer increment flips any watched position."""
    if not watch:
        return False
    # next increment flips positions from the innermost up to the first
    # position that does not wrap
    n = len(slots)
    for pos in range(n - 1, -1, -1):
        if pos in watch:
            return True
        if counters[pos] + 1 < slots[pos][1]:
            return False
    return False
