"""Network-level dataflow optimization pipeline (DESIGN.md §Network pipeline).

The paper's headline numbers (Fig. 5a) are *network*-level: a per-layer MIP
solved for every layer of a whole model. Doing that serially with a flat
wall-clock cap per layer wastes most of the time — ResNet repeats blocks,
transformers repeat the same handful of GEMMs per layer, and big layers
burn the full cap while tiny ones solve in milliseconds. This module:

  1. **dedups** structurally identical layers (same loop bounds + stride;
     ``cache.layer_cache_key``) — one solve covers every repeat, each
     instance re-scored from the shared mapping;
  2. allocates one **global wall-clock budget** across the unique layers
     still to be solved, weighted by MAC count (big layers dominate network
     latency, so they get the solver time) with a per-layer floor and cap;
  3. fans the solves out over a ``concurrent.futures.ProcessPoolExecutor``
     (HiGHS holds the GIL — processes, not threads);
  4. reads/writes the shared on-disk ``ResultCache`` so reruns are
     incremental.

Every MIP solve is warm-started with the greedy/heuristic incumbent inside
``optimize_layer`` (upper-bound row + fallback), so a time-capped solve
always yields a feasible mapping — the pipeline never returns ``None``.

``NetworkResult.totals`` is deliberately the **serial sum**: every layer
instance owns all cores and pays a full macro weight program-in at its
boundary. The pipelined end-to-end number — weight-resident segments,
layer-to-core allocation, reload paid once per segment — is the network
scheduler's (`core/scheduler.py`, DESIGN.md §Network scheduler) and is
surfaced as ``NetworkResult.scheduled``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import multiprocessing
import os
import time
from typing import Sequence

from repro_torch.core import workload as wl
from repro_torch.core.arch import CimArch
from repro_torch.core.cache import (MIP_MODES, ResultCache, layer_cache_key,
                              mapping_from_json, solve_layer,
                              solve_record_key)
#: Default global budget = fraction × (per-layer cap × unique layers to
#: solve). The serial seed spent the full cap on every layer; MAC-weighted
#: splitting preserves solution quality at roughly half the total time
#: because the cap is mostly burned by layers the solver cannot improve
#: within it anyway (see DESIGN.md §Network pipeline).
DEFAULT_BUDGET_FRACTION = 0.5
#: Minimum per-layer solver budget (seconds) when the global budget allows.
MIN_SOLVE_S = 5.0


# ---------------------------------------------------------------------------
# Dedup + budget allocation
# ---------------------------------------------------------------------------

def dedup_layers(layers: Sequence[wl.Layer]) -> tuple[list[wl.Layer],
                                                      list[str]]:
    """Return (unique layers in first-seen order, structural key per input
    layer). Two layers are identical iff all loop bounds and the stride
    match — names are ignored."""
    unique: list[wl.Layer] = []
    seen: dict[str, int] = {}
    keys: list[str] = []
    for layer in layers:
        k = layer_cache_key(layer)
        keys.append(k)
        if k not in seen:
            seen[k] = len(unique)
            unique.append(layer)
    return unique, keys


def allocate_budgets(layers: Sequence[wl.Layer], total_s: float,
                     min_s: float = MIN_SOLVE_S,
                     max_s: float | None = None) -> list[float]:
    """Split ``total_s`` seconds across layers proportionally to MACs,
    clamped to [min_s, max_s]; clamp slack is redistributed to the
    remaining layers so the budgets always sum to ``total_s`` (up to the
    hard bounds n*min_s / n*max_s).

    The sum-to-total contract is only as good as the solver's respect for
    each allocation: `formulation.solve_ladder` charges every fallback
    rung — and `portfolio.race` every racing member — against ONE deadline
    anchored at the solve's start, so a layer's wall clock stays within
    its allocated seconds (+ scheduling epsilon) no matter how many rungs
    or members run. (The pre-v8 ladder re-floored each rung at
    ``min(5, time_limit_s)`` and could overshoot a 5 s budget 3×.)"""
    n = len(layers)
    if n == 0:
        return []
    total_s = float(total_s)
    if total_s <= n * min_s:
        return [total_s / n] * n
    if max_s is not None and total_s >= n * max_s:
        return [float(max_s)] * n
    w = [float(max(1, l.macs)) for l in layers]
    fixed: dict[int, float] = {}
    while True:
        free = [i for i in range(n) if i not in fixed]
        rem = total_s - sum(fixed.values())
        if not free:
            return [fixed[i] for i in range(n)]
        if rem <= min_s * len(free):
            # floors no longer affordable: split what's left evenly
            share = rem / len(free)
            return [fixed.get(i, share) for i in range(n)]
        sw = sum(w[i] for i in free)
        alloc = {i: rem * w[i] / sw for i in free}
        # cap overweight layers first and re-spread their excess; only when
        # no caps bind do floors get applied — flooring too early would
        # strand the capped layers' excess instead of redistributing it
        over = [i for i in free
                if max_s is not None and alloc[i] > max_s]
        if over:
            for i in over:
                fixed[i] = max_s
            continue
        under = [i for i in free if alloc[i] < min_s]
        if under:
            for i in under:
                fixed[i] = min_s
            continue
        return [fixed[i] if i in fixed else alloc[i] for i in range(n)]


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LayerResult:
    layer: wl.Layer
    count: int                  # multiplicity of this instance in the net
    key: str                    # structural dedup/cache key
    record: dict                # solve record, re-scored for this instance

    @property
    def cycles(self) -> float:
        return self.record["cycles"]

    @property
    def energy_pj(self) -> float:
        return self.record["energy_pj"]

    @property
    def edp(self) -> float:
        return self.record["edp"]


@dataclasses.dataclass
class NetworkResult:
    mode: str
    arch_name: str
    layers: list[LayerResult]   # one per input layer, input order
    n_unique: int
    n_solved: int               # unique layers actually solved (cache misses)
    cache_hits: int
    budgets: dict[str, float]   # structural key -> allocated seconds
    wall_s: float
    totals: dict[str, float]    # serial-sum aggregates (see _aggregate)
    #: Multi-core schedule totals (`core/scheduler.py`): end-to-end cycles
    #: with weight-resident segments and core-partitioned pipelining —
    #: keys: cycles, serial_cycles, saved_cycles, n_segments, n_packed,
    #: energy_delta_pj, energy_pj (the executed mappings': serial records
    #: plus any pipelined greedy-basis swap deltas) and edp (energy x
    #: scheduled cycles). ``None`` when scheduling was disabled.
    scheduled: dict[str, float] | None = None
    #: The full `scheduler.Schedule` behind ``scheduled`` (segments, core
    #: allocations, per-stage latencies), for reporting and cross-checks.
    schedule: object | None = None

    @property
    def scheduled_cycles(self) -> float:
        """End-to-end latency: the multi-core schedule's cycles when
        scheduling ran, the serial sum otherwise."""
        return float((self.scheduled or self.totals)["cycles"])

    def record_of(self, name: str) -> dict:
        for lr in self.layers:
            if lr.layer.name == name:
                return lr.record
        raise KeyError(name)


def _aggregate(layers: list[LayerResult]) -> dict[str, float]:
    """Serial-sum aggregates: every layer instance owns all cores
    exclusively and pays its own weight program-in, so ``cycles`` is an
    upper bound on end-to-end latency, not the pipelined number — that is
    ``NetworkResult.scheduled`` (`core/scheduler.py`, DESIGN.md §Network
    scheduler). ``edp`` sums per-layer EDPs (the paper's Fig. 5 metric)."""
    tot = {"cycles": 0.0, "energy_pj": 0.0, "edp": 0.0, "macs": 0.0}
    for lr in layers:
        tot["cycles"] += lr.cycles * lr.count
        tot["energy_pj"] += lr.energy_pj * lr.count
        tot["edp"] += lr.edp * lr.count
        tot["macs"] += lr.layer.macs * lr.count
    return tot


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

def _solve_job(args):
    """Process-pool entry point (top-level: must be picklable)."""
    layer, arch, mode, cfg, *rest = args
    ws = rest[0] if len(rest) > 0 else None
    pf = rest[1] if len(rest) > 1 else None
    return solve_layer(layer, arch, mode, cfg, warm_start=ws, portfolio=pf)


def optimize_network(layers: Sequence[wl.Layer], arch: CimArch | None = None,
                     mode: str = "miredo", *,
                     mesh=None,
                     counts: Sequence[int] | None = None,
                     cfg=None,
                     total_budget_s: float | None = None,
                     per_layer_cap_s: float = 60.0,
                     workers: int | None = None,
                     cache: ResultCache | None = None,
                     use_cache: bool = True,
                     schedule: bool = True,
                     schedule_boundaries: Sequence[int] | None = None,
                     warm_starts: dict[str, dict] | None = None,
                     portfolio=None,
                     verbose: bool = False) -> NetworkResult:
    """Optimize every layer of a network and aggregate latency/energy/EDP.

    ``mesh`` (a `mesh.MeshArch`, mutually exclusive with ``arch``) targets
    a multi-chip mesh: ``n_chips > 1`` dispatches to
    `mesh.optimize_mesh_network` (per-layer TP sharding + the (chip, core)
    placement scheduler); a **1-chip mesh IS its chip** — the call
    continues below on ``mesh.chip``, taking the single-chip path bit for
    bit (the invariant `tests/test_mesh.py` pins).

    ``warm_starts`` maps `layer_cache_key` -> mapping JSON; for MIP modes
    each matching unique layer's solve receives that mapping as an extra
    incumbent (re-validated against this arch — see
    `formulation.optimize_layer`). Warm-started solves cache under keys
    carrying a warm-start digest, so they never alias cold records.
    Baseline modes ignore warm starts entirely.

    ``portfolio`` (a `portfolio.Portfolio`) replaces each MIP-mode layer
    solve with a race of the portfolio's members inside the layer's
    allocated budget (`core/portfolio.py`); the portfolio digest joins the
    cache key so raced records never alias single-solve records. Baseline
    modes ignore it.

    ``counts`` gives per-input-layer multiplicity (e.g. ResNet block repeat
    counts, transformer depth); identical layers dedup to one solve either
    way. ``total_budget_s`` is the global solver wall-clock budget for MIP
    modes, split across the *unique* layers by MACs; it defaults to
    ``DEFAULT_BUDGET_FRACTION * per_layer_cap_s * n_unique``. The split is
    over all unique layers (not just cache misses) so a rerun re-derives
    identical per-layer budgets and hence identical cache keys. Baseline
    modes (heuristic/greedy/random) are cheap and ignore the budget.

    ``totals`` is the *serial sum* over instances (every layer alone on the
    chip, weight reload at every boundary); with ``schedule=True`` (default)
    the multi-core scheduler additionally packs weight-resident segments
    and pipelines them (`core/scheduler.py`), filling ``result.scheduled``
    (end-to-end cycles, never worse than ``totals['cycles']``) and
    ``result.schedule``. Callers pooling several *independent* workloads
    into one call (e.g. `benchmarks/lm_models.py`) must pass
    ``schedule_boundaries`` — the start index of each sub-stream — so no
    segment pipelines across unrelated networks.
    """
    from repro_torch.core.energy import evaluate_edp
    from repro_torch.core.formulation import FormulationConfig

    if mesh is not None:
        assert arch is None, "pass either arch or mesh, not both"
        if mesh.n_chips > 1:
            from repro_torch.core.mesh import optimize_mesh_network
            return optimize_mesh_network(
                layers, mesh, mode, counts=counts, cfg=cfg,
                total_budget_s=total_budget_s,
                per_layer_cap_s=per_layer_cap_s, workers=workers,
                cache=cache, use_cache=use_cache, schedule=schedule,
                schedule_boundaries=schedule_boundaries,
                warm_starts=warm_starts, portfolio=portfolio,
                verbose=verbose)
        arch = mesh.chip
    assert arch is not None, "either arch or mesh is required"

    t0 = time.monotonic()
    layers = list(layers)
    counts = [1] * len(layers) if counts is None else list(counts)
    assert len(counts) == len(layers)
    base_cfg = cfg or FormulationConfig(time_limit_s=per_layer_cap_s)
    cache = cache if cache is not None else (
        ResultCache() if use_cache else None)

    unique, keys = dedup_layers(layers)
    is_mip = mode in MIP_MODES

    # Resolve cache hits before budgeting: only real solves get solver time.
    records: dict[str, dict] = {}
    cfg_of: dict[str, object] = {}
    ws_of: dict[str, dict | None] = {}
    to_solve: list[wl.Layer] = []
    if not is_mip:
        # budget-independent: cache key uses the base config as-is
        for ul in unique:
            k = layer_cache_key(ul)
            cfg_of[k] = base_cfg
            rec = cache.get(solve_record_key(mode, ul, arch, base_cfg)) \
                if cache else None
            if rec is not None:
                records[k] = rec
            else:
                to_solve.append(ul)
        budgets = {layer_cache_key(ul): 0.0 for ul in to_solve}
    else:
        # Budgets are allocated over ALL unique layers — not just cache
        # misses — so a rerun with the same inputs re-derives the same
        # per-layer budgets and hence the same cache keys.
        if total_budget_s is None:
            total_budget_s = (DEFAULT_BUDGET_FRACTION * per_layer_cap_s *
                              len(unique))
        alloc = allocate_budgets(
            unique, total_budget_s,
            min_s=min(MIN_SOLVE_S, per_layer_cap_s),
            max_s=per_layer_cap_s)
        budgets = {}
        for ul, b in zip(unique, alloc):
            k = layer_cache_key(ul)
            c = dataclasses.replace(base_cfg, time_limit_s=b)
            cfg_of[k] = c
            ws = warm_starts.get(k) if warm_starts else None
            ws_of[k] = ws
            rec = cache.get(solve_record_key(mode, ul, arch, c,
                                             warm_start=ws,
                                             portfolio=portfolio)) \
                if cache else None
            if rec is not None:
                records[k] = rec
            else:
                to_solve.append(ul)
                budgets[k] = b

    cache_hits = len(unique) - len(to_solve)

    # Fan out the remaining solves; longest budgets first for packing.
    if to_solve:
        nw = workers or os.cpu_count() or 1
        order = sorted(
            to_solve,
            key=lambda l: -budgets.get(layer_cache_key(l), l.macs))
        jobs = [(l, arch, mode, cfg_of[layer_cache_key(l)],
                 ws_of.get(layer_cache_key(l)),
                 portfolio if is_mip else None) for l in order]
        if nw > 1 and len(jobs) > 1:
            # spawn, not fork: forking a process whose runtime already
            # started threads (torch, CUDA) can deadlock the children
            with concurrent.futures.ProcessPoolExecutor(
                    max_workers=nw,
                    mp_context=multiprocessing.get_context("spawn")) as ex:
                out = list(ex.map(_solve_job, jobs))
        else:
            out = [_solve_job(j) for j in jobs]
        for l, rec in zip(order, out):
            k = layer_cache_key(l)
            records[k] = rec
            if cache is not None:
                cache.put(solve_record_key(mode, l, arch, cfg_of[k],
                                           warm_start=ws_of.get(k),
                                           portfolio=portfolio), rec)
            if verbose:
                print(f"[network/{mode}] {l.name}: {rec['status']} "
                      f"{rec['cycles']:.3g} cyc in {rec['solve_s']}s")

    # Re-score the shared mapping for every instance (identical structure =>
    # identical numbers, but the record carries the instance's own name and
    # the evaluation proves the mapping is valid for it).
    out_layers: list[LayerResult] = []
    for layer, count, k in zip(layers, counts, keys):
        rec = dict(records[k])
        mapping = mapping_from_json(rec["mapping"])
        edp = evaluate_edp(mapping, layer, arch)
        rec.update({
            "layer": layer.name,
            "cycles": edp.latency.total_cycles,
            "energy_pj": edp.energy.total_pj,
            "edp": edp.edp,
            "spatial_util": edp.latency.spatial_util,
            "temporal_util": edp.latency.temporal_util,
        })
        out_layers.append(LayerResult(layer=layer, count=count, key=k,
                                      record=rec))

    totals = _aggregate(out_layers)
    scheduled = sched = None
    if schedule:
        from repro_torch.core.scheduler import schedule_network
        sched = schedule_network(out_layers, arch,
                                 boundaries=schedule_boundaries,
                                 verbose=verbose)
        scheduled = sched.totals()
        # energy of the mappings actually executed: the serial records'
        # energy plus the delta of any pipelined greedy-basis swaps
        # (zero when no swap engages — see scheduler.py guarantees)
        scheduled["energy_pj"] = totals["energy_pj"] + \
            sched.energy_delta_pj
        scheduled["edp"] = scheduled["energy_pj"] * sched.scheduled_cycles

    return NetworkResult(
        mode=mode, arch_name=arch.name, layers=out_layers,
        n_unique=len(unique), n_solved=len(to_solve),
        cache_hits=cache_hits, budgets=budgets,
        wall_s=round(time.monotonic() - t0, 2),
        totals=totals, scheduled=scheduled, schedule=sched)


def optimize_over_archs(layers: Sequence[wl.Layer],
                        archs: Sequence[CimArch],
                        mode: str = "miredo", *,
                        counts: Sequence[int] | None = None,
                        cache: ResultCache | None = None,
                        use_cache: bool = True,
                        incremental: bool = False,
                        verbose: bool = False,
                        **net_kwargs) -> dict[str, NetworkResult]:
    """Batch-over-archs entry point (the co-design DSE's full-fidelity pass,
    `core/dse.py`): run ``optimize_network`` for the same workload under
    every architecture, sharing ONE ``ResultCache`` across all of them.

    Cache keys are arch-aware (`cache.arch_cache_key` digests the structural
    `arch.arch_fingerprint`), so per-arch records never collide, reruns of a
    sweep are incremental, and a grid point that equals a previously solved
    arch — under any name — is free. Returns ``{arch.name: NetworkResult}``
    in input order; arch names must be unique.

    ``incremental=True`` (MIP modes only) threads *neighbor warm starts*
    along the sweep: each arch's solved per-layer mappings become extra
    incumbents for the next arch's solves (re-validated there — adjacent
    grid points usually share near-optimal dataflows, so the MIP starts
    from a tight UB). This changes solver inputs, so results may differ
    from independent cold solves and records cache under warm-start-
    digested keys; leave it off (the default) when byte-reproducible
    cold-solve output matters."""
    archs = list(archs)
    names = [a.name for a in archs]
    assert len(set(names)) == len(names), f"duplicate arch names: {names}"
    cache = cache if cache is not None else (
        ResultCache() if use_cache else None)
    out: dict[str, NetworkResult] = {}
    warm: dict[str, dict] | None = None
    for arch in archs:
        if verbose:
            print(f"[over-archs/{mode}] {arch.name}", flush=True)
        res = optimize_network(
            layers, arch, mode, counts=counts, cache=cache,
            use_cache=use_cache, warm_starts=warm, verbose=verbose,
            **net_kwargs)
        out[arch.name] = res
        if incremental and mode in MIP_MODES:
            warm = {lr.key: lr.record["mapping"] for lr in res.layers}
    return out
