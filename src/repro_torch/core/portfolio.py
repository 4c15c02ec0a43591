"""Per-layer racing solver portfolio (ROADMAP open item 3, DESIGN.md
§Solver portfolio).

The paper caps Gurobi at 5 min/layer; our HiGHS-via-scipy port keeps the
cap but on many layers the time-capped solve still returns the warm-start
incumbent unimproved — the branch-and-bound never gets past the root, or
stops at the default 2% relative gap with the heuristic incumbent still in
hand. A *portfolio* races K deterministic parameterizations of the same
layer MIP inside the layer's **existing** allocated budget:

  * each `PortfolioMember` is a distinct (factorization-ladder rung,
    HiGHS ``presolve``/``node_limit``/``mip_rel_gap`` parameterization,
    incumbent-seed subset) combination — diversity, not redundancy;
  * members run **time-sliced** inside the layer's single process (the
    `network.optimize_network` workers are already saturated fanning out
    *layers*; racing sequentially keeps the winner independent of the
    worker count): member *i* receives a ``share``-weighted split of the
    budget left on the shared deadline (``remaining * share_i / sum(share_j,
    j >= i)``), so early finishers roll their slack forward to later
    members;
  * the best-known upper bound is **shared**: every member's prune row
    (``PMAX <= UB * 1.001``) is tightened from the running incumbent —
    improvements found by member *i* cut member *i+1*'s search region;
  * the returned result is best-of-portfolio by ``(eval_latency,
    member_index)``, so ties resolve to the earliest member and the
    outcome is a pure function of the member results — bit-deterministic
    and cache-stable. Full end-to-end bit-determinism additionally
    requires members to terminate on a deterministic criterion
    (optimality / ``node_limit``) rather than the wall clock; the default
    grid node-limits every non-baseline member for exactly this reason.

The portfolio can never return a worse ``eval_latency`` than its incumbent
pool (each member inherits `formulation.solve_ladder`'s never-worse
fallback), so seeding it with another solver's result — e.g. the single
baseline solve in ``benchmarks/opt_speed.py --portfolio`` — makes
"never worse than that solver" hold *by construction*.

Threaded through `formulation.optimize_layer(portfolio=)`,
`cache.solve_layer` / `solve_record_key` (the portfolio digest joins the
key; CACHE_VERSION=8) and `network.optimize_network(portfolio=)`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import time

from repro_torch.core import workload as wl
from repro_torch.core.arch import CimArch
from repro_torch.core.formulation import (FormulationConfig, MiredoResult,
                                    native_incumbents, solve_ladder)
from repro_torch.core.latency import evaluate
from repro_torch.core.mapping import Mapping, validate

#: Below this many seconds of remaining budget, a non-baseline member is
#: skipped instead of launched (building a formulation alone costs more).
MIN_MEMBER_SLICE_S = 0.05

#: Incumbent-seed subsets a member may start from (its own pool; the
#: running shared best is always added on top).
SEED_SUBSETS = ("all", "search", "greedy")


@dataclasses.dataclass(frozen=True)
class PortfolioMember:
    """One deterministic solver parameterization.

    ``rung`` picks the starting Flexible-Factorization ladder rung
    (`formulation.ladder_rungs`); ``node_limit``/``presolve``/
    ``mip_rel_gap`` map straight onto HiGHS options
    (`mip.model.MipModel.solve`); ``seed`` selects which native incumbents
    form the member's own pool (``all`` | ``search`` | ``greedy``) — a
    weaker seed changes the big-M scale and the fallback preference, i.e.
    a genuinely different search, while the *prune row* still tightens
    from the running shared UB; ``share`` weights the member's time slice
    (see `race`) — these solves are root-dominated, so wall clock, not
    node count, decides whether a member lands its first integer point."""
    name: str
    rung: int = 0
    node_limit: int | None = None
    presolve: bool | None = None
    mip_rel_gap: float | None = None
    seed: str = "all"
    share: float = 1.0

    def __post_init__(self):
        assert self.seed in SEED_SUBSETS, self.seed
        assert self.share > 0, self.share


@dataclasses.dataclass(frozen=True)
class Portfolio:
    """An ordered member grid. Order matters twice: earlier members see a
    looser shared UB (they *produce* it) and win eval-latency ties."""
    members: tuple[PortfolioMember, ...]

    def __post_init__(self):
        assert self.members, "a portfolio needs at least one member"

    def digest(self) -> str:
        """Cache-key component: digests every result-affecting member
        field, order-sensitively (`cache.solve_record_key`)."""
        blob = json.dumps([dataclasses.asdict(m) for m in self.members],
                          sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()[:12]


def default_portfolio() -> Portfolio:
    """The shipped K=3 grid, tuned on the reduced LM zoo
    (`benchmarks/opt_speed.py --portfolio`).

    * ``coarse`` — one rung coarser, triple slice share: a much smaller
      MIP. These solves are root-dominated (HiGHS spends the budget on
      presolve + root heuristics, rarely past node 2-3), so on layers
      where the fine model cannot land a single integer point in-budget
      the coarse model both lands one *and* often lands a better one
      (e.g. the reduced minicpm FFN-up GEMM: coarse finds 7114 cycles in
      ~1.5 s where the fine model needs >3 s to reach 8448). Runs first
      so its UB prunes the fine members.
    * ``base`` — the single-parameterization solve, unchanged knobs:
      keeps the portfolio's floor at the historical solver's quality on
      layers where the fine model wins in-slice.
    * ``gap0`` — near-zero relative gap, node-limited: keeps branching
      after the point where ``base`` would declare the (possibly
      still-heuristic) incumbent close enough; benefits most from the
      shared UB since it starts from the tightest prune row.
    """
    return Portfolio(members=(
        PortfolioMember(name="coarse", rung=1, share=3.0),
        PortfolioMember(name="base"),
        PortfolioMember(name="gap0", mip_rel_gap=1e-6, presolve=True,
                        node_limit=20000),
    ))


@dataclasses.dataclass
class MemberOutcome:
    """Per-member diagnostics: why did this member win / lose?"""
    index: int
    name: str
    status: str                   # Status name, or SKIPPED / OVERFLOW
    eval_latency: float           # inf when the member produced nothing
    solve_seconds: float
    mip_gap: float = math.nan
    mip_node_count: float = math.nan
    mip_dual_bound: float = math.nan
    improved: bool = False        # beat the native incumbent pool?

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class PortfolioOutcome:
    result: MiredoResult          # winner's result; solve_seconds = total
    winner: int                   # index into ``members``
    members: list[MemberOutcome]

    def to_json(self) -> dict:
        return {"winner": self.winner,
                "members": [m.to_json() for m in self.members]}


def _seed_pool(incumbents, seed: str):
    if seed == "all":
        return list(incumbents)
    # native_incumbents order: [search, greedy]
    return [incumbents[0 if seed == "search" else 1]]


def race(layer: wl.Layer, arch: CimArch, cfg: FormulationConfig,
         pf: Portfolio, warm_start: Mapping | None = None
         ) -> PortfolioOutcome:
    """Race ``pf``'s members on one layer inside ``cfg.time_limit_s``.

    Budget contract: the native incumbent pool, every member's builds and
    solves, and all fallback evaluation share ONE deadline anchored before
    the incumbent search — total wall clock stays within the layer's
    allocated budget + scheduling epsilon, same as the single solve after
    the ladder fix (`formulation.solve_ladder`).

    Returns the best member by ``(eval_latency, member_index)``; the
    winning `MiredoResult`'s ``solve_seconds`` is the portfolio's total
    elapsed time (that is what `network.allocate_budgets` charged).
    """
    t0 = time.monotonic()
    deadline = t0 + cfg.time_limit_s
    base = native_incumbents(layer, arch, cfg)
    native_ub = min(l for l, _ in base)
    shared: list[tuple[float, Mapping]] = []   # warm start + member results
    if warm_start is not None and not validate(warm_start, layer, arch):
        shared.append(
            (evaluate(warm_start, layer, arch).total_cycles, warm_start))

    best: tuple[float, int, MiredoResult] | None = None
    outcomes: list[MemberOutcome] = []
    last_exc: Exception | None = None
    for idx, mem in enumerate(pf.members):
        remaining = deadline - time.monotonic()
        if idx > 0 and remaining <= MIN_MEMBER_SLICE_S:
            outcomes.append(MemberOutcome(
                index=idx, name=mem.name, status="SKIPPED",
                eval_latency=math.inf, solve_seconds=0.0))
            continue
        # deterministic slice policy: a share-weighted split of what is
        # left, so early finishers fund later members
        w = sum(m.share for m in pf.members[idx:])
        slice_s = max(0.0, remaining) * mem.share / w
        mem_deadline = min(deadline, time.monotonic() + slice_s)
        # member pool = its seed subset + the shared running incumbents;
        # the prune row (min of the pool) is thereby tightened from the
        # best known UB across members
        pool = _seed_pool(base, mem.seed) + list(shared)
        mem_t0 = time.monotonic()
        try:
            res = solve_ladder(
                layer, arch, cfg, pool, t0=mem_t0, deadline=mem_deadline,
                incumbent_latency=native_ub, rung=mem.rung,
                node_limit=mem.node_limit, presolve=mem.presolve,
                mip_rel_gap=mem.mip_rel_gap)
        except Exception as e:          # all rungs overflowed for this member
            last_exc = e
            outcomes.append(MemberOutcome(
                index=idx, name=mem.name, status="OVERFLOW",
                eval_latency=math.inf,
                solve_seconds=time.monotonic() - mem_t0))
            continue
        outcomes.append(MemberOutcome(
            index=idx, name=mem.name, status=res.status.name,
            eval_latency=res.eval_latency, solve_seconds=res.solve_seconds,
            mip_gap=res.mip_gap, mip_node_count=res.mip_node_count,
            mip_dual_bound=res.mip_dual_bound,
            improved=res.eval_latency < native_ub))
        # share the member's result as an incumbent for later members
        if res.mapping is not None:
            shared.append((res.eval_latency, res.mapping))
        # winner ordering: (eval_latency, member_index) — strict < keeps
        # the earliest member on ties
        if best is None or res.eval_latency < best[0]:
            best = (res.eval_latency, idx, res)
    if best is None:
        raise last_exc or RuntimeError("every portfolio member failed")
    result = dataclasses.replace(
        best[2], solve_seconds=time.monotonic() - t0,
        incumbent_latency=native_ub)
    return PortfolioOutcome(result=result, winner=best[1],
                            members=outcomes)
