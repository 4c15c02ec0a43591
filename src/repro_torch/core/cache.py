"""Mapping (de)serialization + on-disk solve-record cache.

Promoted out of ``benchmarks/common.py`` so the network pipeline
(``core/network.py``), the benchmark scripts and the examples all share one
cache with one key schema (DESIGN.md §Network pipeline).

Cache keys cover the *complete* solve identity:

  * the layer structure (all loop bounds + stride — not the name, so
    structurally identical layers share entries; this same key is the
    network pipeline's dedup key),
  * the full architecture *structure* (hierarchy capacities/buses/serves/
    bypass/buffering flags, access energies, spatial axes, macro geometry,
    timing constants — but not the arch name; `arch.arch_fingerprint`),
  * every ``FormulationConfig`` field that can change the result (the seed's
    key omitted ``mu1``/``mu2_frac``/``latency_slack``/``mip_rel_gap``/
    ``combo_cap`` and silently served stale mappings when objective weights
    changed — hence ``CACHE_VERSION``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time

from repro_torch.core import workload as wl
from repro_torch.core.arch import CimArch, arch_fingerprint
from repro_torch.core.mapping import Mapping

# v2: key covers all FormulationConfig fields.
# v3: arch key is structural (`arch.arch_fingerprint`): it now covers
#     per-level `bypassable` and access energies (the v2 key ignored both,
#     so archs differing only in energy constants shared stale records) and
#     drops the arch *name*, so the DSE grid's generated archs hit the same
#     entries as an identically-shaped hand-built arch.
# v4: records feed the network scheduler (`core/scheduler.py`), which
#     derives weight residency, per-instance weight footprints and resident
#     latency from the record's mapping + cycles. Those inputs are fully
#     determined by fields the structural key already covers (all loop
#     bounds + stride fix the weight tensor; the arch fingerprint fixes the
#     macro capacity and mode-switch cost — no new key fields needed), but
#     pre-scheduler v3 entries predate that contract, so the version bump
#     retires them wholesale rather than letting them serve records the
#     scheduler was never validated against.
# v5: the key space grows an optional warm-start digest component
#     (incremental DSE re-solves inject a neighboring arch's solved mapping
#     as an extra incumbent — `solve_record_key(..., warm_start=...)`), and
#     the cache is now routinely shared across runs on disk
#     (``--cache-dir`` / ``MIREDO_CACHE``). v4 records were written before
#     warm-started and cold solves could coexist, so the bump draws a clean
#     line: every v5 record states via its key whether a warm start shaped
#     it. Cold-solve keys are otherwise structurally identical to v4.
# v6: the arch position of the key accepts a `MeshArch` (`core/mesh.py`):
#     its fingerprint folds in every solver-relevant mesh field — chip
#     structure, chip count, topology, link bandwidth / hop latency / link
#     energy (a solver-relevant field missing from the key
#     serves stale records — two meshes differing only in link bandwidth
#     pick different shard choices). Mesh-level records additionally store
#     the shard decomposition, which v5 keys could never address, and
#     single-chip keys are unchanged except for the version prefix.
# v7: the layer key grows the written-resident-operand field
#     (`workload.Layer.weight_written`, the training frontend's wGrad
#     GEMMs). The scheduler's residency basis and dedup both key on the
#     structural layer key, and a wGrad layer whose bounds coincide with a
#     forward layer's must never share that layer's basis or record — its
#     stationary operand is produced per step, so residency packing and
#     fill amortization do not apply. Read-weight layer keys are unchanged
#     except for the version prefix.
# v8: two key-space changes land together. (a) The key space grows an
#     optional portfolio digest component (`core/portfolio.py` races K
#     solver parameterizations per layer — a different member grid is a
#     different solver, so `solve_record_key(..., portfolio=...)` appends
#     ``__pf<digest>`` for MIP modes). (b) ``latency_slack`` is
#     canonicalized to ``max(latency_slack, BIG_M_FLOOR)`` before keying:
#     the big-M row uses exactly that floor
#     (`formulation.solve_ladder`), so v7 keyed records that could never
#     differ (e.g. slack 2.0 vs 4.0) apart. v7 records also predate the
#     shared-deadline budget fix, so their ``solve_s`` no longer reflects
#     the budget contract — retired wholesale.
CACHE_VERSION = 8

#: Modes whose solves run the MIP (and therefore depend on every solver
#: field); baseline modes only consume the factorization knobs.
MIP_MODES = ("miredo", "ws")

# Config fields with no effect on the solve result (excluded from the key).
_CFG_KEY_EXCLUDE = ("verbose",)

# Solver-only fields, canonicalized out of baseline-mode keys: a heuristic
# record must hit the cache regardless of the MIP budget it ran beside.
_NON_MIP_CANONICAL = dict(time_limit_s=0.0, mu1=1.0, mu2_frac=0.0,
                          mip_rel_gap=0.0, combo_cap=0, latency_slack=0.0,
                          weight_stationary=False)


def default_cache_dir() -> str:
    return os.environ.get("MIREDO_CACHE", "reports/cache")


# ---------------------------------------------------------------------------
# Mapping (de)serialization
# ---------------------------------------------------------------------------

def mapping_to_json(m: Mapping) -> dict:
    return {
        "spatial": {k: list(map(list, v)) for k, v in m.spatial.items()},
        "temporal": list(map(list, m.temporal)),
        "level_of": {k: list(v) for k, v in m.level_of.items()},
        "double_buf": sorted(map(list, m.double_buf)),
    }


def mapping_from_json(d: dict) -> Mapping:
    return Mapping(
        spatial={k: tuple(tuple(x) for x in v)
                 for k, v in d["spatial"].items()},
        temporal=tuple(tuple(x) for x in d["temporal"]),
        level_of={k: tuple(v) for k, v in d["level_of"].items()},
        double_buf=frozenset((a, b) for a, b in d["double_buf"]))


# ---------------------------------------------------------------------------
# Key schema
# ---------------------------------------------------------------------------

def _digest(s: str) -> str:
    return hashlib.sha1(s.encode()).hexdigest()[:12]


def arch_cache_key(arch) -> str:
    """Structural arch key: digests ``arch.arch_fingerprint`` — the name is
    *not* part of the identity, so two archs differing only in LBuf capacity
    (or any other knob) get distinct keys while renamed-but-identical archs
    share entries (the DSE grid relies on both properties). A `MeshArch`
    (anything exposing ``fingerprint()``) keys on its own fingerprint, which
    embeds the chip fingerprint plus chip count, topology and all link
    fields — duck-typed here so `cache` need not import `mesh`."""
    fp = (arch_fingerprint(arch) if isinstance(arch, CimArch)
          else arch.fingerprint())
    return _digest(fp)


def layer_cache_key(layer: wl.Layer) -> str:
    """Structural key: loop bounds + stride + ``weight_written``, *not*
    the name — identical shapes share cache entries and dedup to one
    solve. The bounds also fix every scheduler-relevant derived quantity
    (the K*C*FY*FX weight footprint `scheduler.weight_bytes` packs
    against), so the scheduler introduces no additional key fields — only
    the v4 version bump. ``weight_written`` joined in v7: it flips the
    scheduler's residency basis (`scheduler.weight_residency`), so a
    wGrad layer must never alias a same-shaped forward layer."""
    dims = ",".join(f"{d}={layer.bound(d)}" for d in wl.DIMS)
    return _digest(f"{dims}|s{layer.stride}"
                   f"|wr{int(layer.weight_written)}")


def config_cache_key(cfg) -> str:
    """Key over every result-affecting FormulationConfig field.

    ``latency_slack`` is canonicalized to ``max(latency_slack,
    BIG_M_FLOOR)`` before keying: the solver applies exactly that floor to
    the big-M scale (`formulation.solve_ladder`), so every slack value at
    or below the floor produces the bit-identical solve — keying them
    apart would store duplicate records that can never differ (v8)."""
    from repro_torch.core.formulation import BIG_M_FLOOR

    items = dataclasses.asdict(cfg)
    if "latency_slack" in items:
        items["latency_slack"] = max(items["latency_slack"], BIG_M_FLOOR)
    items = sorted(
        (k, v) for k, v in items.items() if k not in _CFG_KEY_EXCLUDE)
    return _digest("|".join(f"{k}={v!r}" for k, v in items))


def solve_record_key(mode: str, layer: wl.Layer, arch, cfg,
                     warm_start: dict | None = None,
                     portfolio=None) -> str:
    """``warm_start`` (a mapping JSON injected as a neighbor incumbent —
    incremental DSE re-solves) changes the solver's inputs, so warm-started
    records carry an extra digest component: they can never serve, or be
    served by, the structural key of an independent cold solve. Likewise
    ``portfolio`` (a `portfolio.Portfolio`): a different member grid is a
    different solver, so its digest joins the key — for MIP modes only,
    since baseline modes never run the MIP and must hit the same entry
    regardless of the portfolio racing beside them (v8)."""
    if mode not in MIP_MODES:
        cfg = dataclasses.replace(cfg, **_NON_MIP_CANONICAL)
    key = (f"v{CACHE_VERSION}__{mode}__{layer_cache_key(layer)}"
           f"__{arch_cache_key(arch)}__{config_cache_key(cfg)}")
    if warm_start is not None:
        key += "__ws" + _digest(json.dumps(warm_start, sort_keys=True))
    if portfolio is not None and mode in MIP_MODES:
        key += "__pf" + portfolio.digest()
    return key


# ---------------------------------------------------------------------------
# On-disk record cache
# ---------------------------------------------------------------------------

class ResultCache:
    """JSON record store keyed by ``solve_record_key``; one file per record."""

    def __init__(self, directory: str | None = None):
        self.directory = directory or default_cache_dir()

    def path(self, key: str) -> str:
        return os.path.join(self.directory, key + ".json")

    def get(self, key: str) -> dict | None:
        p = self.path(key)
        if not os.path.exists(p):
            return None
        try:
            with open(p) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError):
            return None          # partial write / corrupt entry: resolve

    def put(self, key: str, rec: dict) -> str:
        os.makedirs(self.directory, exist_ok=True)
        p = self.path(key)
        tmp = p + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, p)       # atomic vs concurrent workers
        return p


# ---------------------------------------------------------------------------
# Solving (uncached core + cached wrapper)
# ---------------------------------------------------------------------------

def solve_layer(layer: wl.Layer, arch: CimArch, mode: str,
                cfg=None, warm_start: dict | None = None,
                portfolio=None) -> dict:
    """One uncached solve. mode: 'miredo' | 'ws' | 'heuristic' | 'greedy' |
    'random'. Returns {mode, layer, mapping, cycles, energy_pj, edp,
    spatial_util, temporal_util, solve_s, status}; MIP-mode records
    additionally carry {incumbent_cycles, improved} (the native
    greedy/heuristic incumbent the MIP had to beat, and whether it did)
    and, when a portfolio raced, {portfolio: {winner, members: [...]}}.

    MIP modes always return a feasible mapping: ``optimize_layer`` seeds the
    solve with the greedy/heuristic incumbent (warm start) and falls back to
    it when the time-capped solver finds nothing better. ``warm_start`` (a
    mapping JSON, e.g. a neighboring arch's solved mapping during
    incremental DSE) adds one more incumbent to that pool for MIP modes;
    baseline modes ignore it. ``portfolio`` (a `portfolio.Portfolio`) races
    its members instead of the single-parameterization solve for MIP modes;
    baseline modes ignore it too.
    """
    from repro_torch.core.baselines import greedy_mapping, heuristic_search
    from repro_torch.core.energy import evaluate_edp
    from repro_torch.core.formulation import FormulationConfig, optimize_layer

    cfg = cfg or FormulationConfig()
    ws = mapping_from_json(warm_start) if warm_start is not None else None
    t0 = time.monotonic()
    res = pf_out = None
    if mode in MIP_MODES:
        c = (dataclasses.replace(cfg, weight_stationary=True)
             if mode == "ws" else cfg)
        if portfolio is not None:
            from repro_torch.core.portfolio import race
            pf_out = race(layer, arch, c, portfolio, warm_start=ws)
            res = pf_out.result
        else:
            res = optimize_layer(layer, arch, c, warm_start=ws)
        mapping, status = res.mapping, res.status.name
    elif mode == "heuristic":
        r = heuristic_search(layer, arch, budget=2000, seed=0,
                             accurate=False, k_min=cfg.k_min,
                             alpha=cfg.alpha)
        mapping, status = r.mapping, "HEURISTIC"
    elif mode == "random":
        r = heuristic_search(layer, arch, budget=2000, seed=0,
                             accurate=True, k_min=cfg.k_min, alpha=cfg.alpha)
        mapping, status = r.mapping, "RANDOM"
    elif mode == "greedy":
        mapping, status = greedy_mapping(layer, arch), "GREEDY"
    else:
        raise ValueError(mode)
    assert mapping is not None, (mode, layer.name)
    edp = evaluate_edp(mapping, layer, arch)
    rec = {
        "mode": mode,
        "layer": layer.name,
        "mapping": mapping_to_json(mapping),
        "cycles": edp.latency.total_cycles,
        "energy_pj": edp.energy.total_pj,
        "edp": edp.edp,
        "spatial_util": edp.latency.spatial_util,
        "temporal_util": edp.latency.temporal_util,
        "solve_s": round(time.monotonic() - t0, 1),
        "status": status,
    }
    if res is not None:                      # MIP modes: solver diagnostics
        rec["incumbent_cycles"] = res.incumbent_latency
        rec["improved"] = res.improved
    if pf_out is not None:
        rec["portfolio"] = pf_out.to_json()
    return rec


def solve_cached(layer: wl.Layer, arch: CimArch, mode: str,
                 cfg=None, budget_s: float = 60.0,
                 cache: ResultCache | None = None) -> dict:
    """Cached single-layer solve (the seed benchmark entry point, now
    library-level). Prefer ``network.optimize_network`` for whole models —
    it dedups, allocates budget and fans out across processes."""
    from repro_torch.core.formulation import FormulationConfig

    cfg = cfg or FormulationConfig(time_limit_s=budget_s)
    cache = cache or ResultCache()
    key = solve_record_key(mode, layer, arch, cfg)
    rec = cache.get(key)
    if rec is not None:
        return rec
    rec = solve_layer(layer, arch, mode, cfg)
    cache.put(key, rec)
    return rec
