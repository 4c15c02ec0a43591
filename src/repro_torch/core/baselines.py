"""Baseline dataflow generators (paper §V-A).

* ``greedy_mapping``      — deterministic feasible constructor (also supplies
                            the MIP's big-M latency bound).
* ``ws_baseline``         — conventional Weight-Stationary dataflow: the
                            paper derives it "by imposing additional
                            constraints within our own MIP formulation";
                            we do exactly that (FormulationConfig
                            .weight_stationary=True).
* ``heuristic_search``    — ZigZag-style stochastic mapper: samples uneven
                            mappings and ranks them with the *idealized*
                            perfect-overlap cost model (the oversimplified
                            model the paper criticizes, limitation ❶); the
                            winner is then re-scored with the accurate
                            analytical model, exposing the modeling gap.
* ``random_search``       — uniform sampling, accurate model (ablation).
"""

from __future__ import annotations

import dataclasses
import math
import random

from repro_torch.core import workload as wl
from repro_torch.core.arch import CimArch, INPUT, OPERANDS, OUTPUT, WEIGHT
from repro_torch.core.factorization import factorize_layer_dims
from repro_torch.core.latency import evaluate, idealized_cycles
from repro_torch.core.mapping import Mapping, validate


# ---------------------------------------------------------------------------
# Greedy constructor
# ---------------------------------------------------------------------------

def _assign_levels(temporal: list[tuple[str, int]], layer: wl.Layer,
                   arch: CimArch, spatial: dict,
                   double_buf: frozenset) -> Mapping | None:
    """Assign per-operand levels innermost-out, deepest level that fits."""
    n = len(temporal)
    level_of = {}
    for lam in OPERANDS:
        legal = [m for m in range(arch.n_levels) if arch.serves(m, lam)]
        lv = [0] * n
        cur = max(legal)
        for i in range(n - 1, -1, -1):
            # try to keep current level; move outward (smaller m) while the
            # cumulative tile no longer fits.
            while True:
                lv[i] = cur
                probe = Mapping(spatial=spatial,
                                temporal=tuple(temporal),
                                level_of={**{o: tuple([0] * n)
                                             for o in OPERANDS
                                             if o != lam},
                                          lam: tuple(lv)},
                                double_buf=double_buf)
                cap = probe.eff_capacity(arch, cur)
                size = probe.stored_bytes(layer, lam, arch, cur)
                mult = 2 if probe.is_double_buffered(lam, cur, arch) else 1
                lvl = arch.level(cur)
                # Shared levels budget a fair share per served operand (the
                # sweep places one operand at a time, so the full capacity
                # would over-commit a level that must later hold all three);
                # dedicated levels grant their full per-operand capacity.
                budget = None if cap is None else \
                    (cap / len(lvl.serves) if lvl.shared else cap)
                if budget is None or mult * size <= budget:
                    break
                outer = [mm for mm in legal if mm < cur]
                if not outer:
                    break
                cur = max(outer)
            cur = lv[i]
        level_of[lam] = tuple(lv)
    mp = Mapping(spatial=spatial, temporal=tuple(temporal),
                 level_of=level_of, double_buf=double_buf)
    return mp if not validate(mp, layer, arch) else None


def greedy_mapping(layer: wl.Layer, arch: CimArch,
                   k_min: int = 3, alpha: float = 0.15) -> Mapping:
    """Deterministic, always-feasible mapping: fill macro spatial axes with
    the largest legal factors, order temporals weight-dims-outermost, place
    levels by capacity sweep, single-buffered everywhere."""
    factors = factorize_layer_dims({d: layer.bound(d) for d in wl.DIMS},
                                   alpha=alpha, k_min=k_min)
    pool: list[tuple[str, int]] = []
    for d, fs in sorted(factors.items()):
        pool += [(d, f) for f in fs]
    spatial: dict[str, list[tuple[str, int]]] = {}
    used = set()
    for ax in arch.spatial:
        room = ax.size
        chosen = []
        for idx, (d, f) in sorted(enumerate(pool),
                                  key=lambda kv: -kv[1][1]):
            if idx in used or d not in ax.dims or f > room:
                continue
            chosen.append((d, f))
            used.add(idx)
            room //= f
        spatial[ax.name] = chosen
    remaining = [pool[i] for i in range(len(pool)) if i not in used]
    w_dims = [p for p in remaining if wl.is_relevant(p[0], WEIGHT)]
    o_dims = [p for p in remaining if not wl.is_relevant(p[0], WEIGHT)]
    temporal = w_dims + o_dims
    mp = _assign_levels(temporal, layer, arch,
                        {k: tuple(v) for k, v in spatial.items()},
                        frozenset())
    if mp is None:
        # ultra-conservative fallback: everything streamed from DRAM
        level_of = {lam: tuple([0] * len(temporal)) for lam in OPERANDS}
        if temporal:
            level_of[WEIGHT] = tuple(
                [0] * (len(temporal) - 1) + [arch.macro_level])
        mp = Mapping(spatial={k: tuple(v) for k, v in spatial.items()},
                     temporal=tuple(temporal), level_of=level_of,
                     double_buf=frozenset())
        errs = validate(mp, layer, arch)
        if errs:
            raise AssertionError(f"greedy fallback infeasible: {errs}")
    return mp


# ---------------------------------------------------------------------------
# Stochastic mappers
# ---------------------------------------------------------------------------

def sample_mapping_raw(layer: wl.Layer, arch: CimArch, rng: random.Random,
                       factors: dict[str, list[int]]) -> Mapping:
    """One random uneven mapping, *not* validated. By construction the
    candidate satisfies every structural constraint (complete factor
    products, spatial axis membership and lane budgets, monotone per-operand
    level assignment, C^M legality, weights terminating in the macro) — the
    only clause it can still violate is the eq. (9) buffer capacity, which
    the batched scorer checks for the whole pool in one dispatch
    (`latency_batched.score_mappings(...).feasible`)."""
    pool: list[tuple[str, int]] = []
    for d, fs in sorted(factors.items()):
        pool += [(d, f) for f in fs]
    rng.shuffle(pool)
    spatial: dict[str, list[tuple[str, int]]] = {ax.name: []
                                                 for ax in arch.spatial}
    room = {ax.name: ax.size for ax in arch.spatial}
    temporal: list[tuple[str, int]] = []
    for d, f in pool:
        axes = [ax.name for ax in arch.spatial
                if d in ax.dims and f <= room[ax.name]]
        choice = rng.randrange(len(axes) + 2) if axes else 0
        if axes and choice < len(axes):
            ax = axes[choice]
            spatial[ax].append((d, f))
            room[ax] //= f
        else:
            temporal.append((d, f))
    n = len(temporal)
    level_of = {}
    for lam in OPERANDS:
        legal = sorted(m for m in range(arch.n_levels)
                       if arch.serves(m, lam))
        # random monotone assignment
        cur = legal[0]
        lv = []
        for i in range(n):
            ups = [mm for mm in legal if mm >= cur]
            cur = rng.choice(ups)
            lv.append(cur)
        if lam == WEIGHT and lv:
            # weights physically terminate in the macro array: relabel the
            # innermost loop block to the macro level.
            tail = lv[-1]
            for i in range(n - 1, -1, -1):
                if lv[i] != tail:
                    break
                lv[i] = arch.macro_level
        level_of[lam] = tuple(lv)
    dbuf = set()
    for lam in OPERANDS:
        for mm in set(level_of[lam]):
            if arch.level(mm).double_bufferable and mm != arch.macro_level \
                    and rng.random() < 0.5:
                dbuf.add((lam, mm))
    return Mapping(spatial={k: tuple(v) for k, v in spatial.items()},
                   temporal=tuple(temporal), level_of=level_of,
                   double_buf=frozenset(dbuf))


def _sample_mapping(layer: wl.Layer, arch: CimArch, rng: random.Random,
                    factors: dict[str, list[int]]) -> Mapping | None:
    """Validated variant of `sample_mapping_raw` (None = infeasible)."""
    mp = sample_mapping_raw(layer, arch, rng, factors)
    return mp if not validate(mp, layer, arch) else None


@dataclasses.dataclass
class SearchResult:
    mapping: Mapping
    chosen_by_cost: float      # the cost model used for selection
    eval_latency: float        # accurate analytical model
    n_feasible: int
    n_sampled: int


def candidate_pool(layer: wl.Layer, arch: CimArch, budget: int = 2000,
                   seed: int = 0, k_min: int = 3,
                   alpha: float = 0.15) -> list[Mapping]:
    """The ``budget`` raw samples `heuristic_search` ranks, in its order:
    one ``random.Random(seed)`` over the layer's factorization."""
    rng = random.Random(seed)
    factors = factorize_layer_dims({d: layer.bound(d) for d in wl.DIMS},
                                   alpha=alpha, k_min=k_min)
    return [sample_mapping_raw(layer, arch, rng, factors)
            for _ in range(budget)]


def heuristic_search(layer: wl.Layer, arch: CimArch, budget: int = 2000,
                     seed: int = 0, accurate: bool = False,
                     k_min: int = 3, alpha: float = 0.15,
                     backend: str | None = None,
                     device="cuda") -> SearchResult:
    """ZigZag-style mapper. ``accurate=False`` ranks candidates with the
    idealized perfect-overlap model (the strawman the paper criticizes);
    ``accurate=True`` ranks with the full analytical model (ablation).

    Enumerate-then-score: the whole candidate pool is sampled up front and
    ranked in one batched dispatch (`latency_batched.score_mappings` —
    bit-equal to the scalar oracle, so the winner, its cost and the
    feasible count are identical to the historical per-candidate loop).
    ``backend`` and ``device`` forward to the batched scorer: None or
    "numpy" scores on the host, "torch" in float64 on ``device``; both
    give the same bits, so the same winner."""
    from repro_torch.core import latency_batched as lb

    cands = candidate_pool(layer, arch, budget, seed, k_min, alpha)
    need = ("feasible", "latency") if accurate else ("feasible", "ideal")
    sc = lb.score_mappings(cands, layer, arch, need=need, backend=backend,
                           device=device)
    return pick_winner(cands, sc, layer, arch, accurate=accurate)


def pick_winner(cands: list[Mapping], sc, layer: wl.Layer, arch: CimArch,
                *, accurate: bool = False) -> SearchResult:
    """`heuristic_search`'s choice from its pool's scores ``sc`` (a
    `latency_batched.BatchScores` holding feasibility, and the idealized
    time or, with ``accurate``, the cycles): the first feasible minimum,
    else the greedy mapping."""
    import numpy as np

    best, best_cost = None, math.inf
    feas = int(sc.feasible.sum()) if cands else 0
    if feas:
        cost = np.where(sc.feasible,
                        sc.cycles if accurate else sc.idealized, math.inf)
        idx = int(np.argmin(cost))   # first minimum = first strict improver
        best, best_cost = cands[idx], float(cost[idx])
    if best is None:
        best = greedy_mapping(layer, arch)
        best_cost = idealized_cycles(best, layer, arch)
    return SearchResult(
        mapping=best, chosen_by_cost=best_cost,
        eval_latency=evaluate(best, layer, arch).total_cycles,
        n_feasible=feas, n_sampled=len(cands))


def random_search(layer: wl.Layer, arch: CimArch, budget: int = 2000,
                  seed: int = 0) -> SearchResult:
    return heuristic_search(layer, arch, budget, seed, accurate=True)


def ws_baseline(layer: wl.Layer, arch: CimArch, **kw):
    """Weight-stationary dataflow via the constrained MIP (paper §V-A)."""
    from repro_torch.core.formulation import FormulationConfig, optimize_layer
    cfg = kw.pop("cfg", None) or FormulationConfig(weight_stationary=True,
                                                   **kw)
    cfg.weight_stationary = True
    return optimize_layer(layer, arch, cfg)
