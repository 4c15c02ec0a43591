"""A small MIP modeling layer over ``scipy.optimize.milp`` (HiGHS).

Plays the role Gurobi's Python API plays in the paper: named variables,
linear constraints, big-M indicator constraints, one-hot selections and
AND/OR linearizations. Everything compiles to one sparse LinearConstraint
block; HiGHS runs exact branch-and-bound with a wall-clock cap (the paper
caps Gurobi at 5 min/layer; we default lower).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Iterable, Sequence

import numpy as np
import scipy.sparse as sp
from scipy.optimize import Bounds, LinearConstraint, milp


class Status(enum.Enum):
    OPTIMAL = 0
    FEASIBLE = 1          # time-capped incumbent
    INFEASIBLE = 2
    UNBOUNDED = 3
    ERROR = 4
    #: HiGHS reported a status outside the documented 0-3 range (e.g.
    #: scipy's 4 = "numerical trouble") but still handed back an
    #: assignment. The incumbent may violate constraints beyond feasibility
    #: tolerances, so callers must re-validate/re-score it before trusting
    #: it — exactly what `formulation.optimize_layer` does (decode ->
    #: `mapping.validate` -> `latency.evaluate`, never-worse-than-incumbent
    #: fallback). Mapped distinctly so such solves are *flagged* instead of
    #: silently passing as FEASIBLE.
    SUSPECT = 5


def status_of(raw_status: int, has_solution: bool) -> Status:
    """Map a scipy ``milp`` result status to `Status`.

    scipy documents 0=optimal, 1=iteration/time limit, 2=infeasible,
    3=unbounded, 4=other (e.g. numerical trouble). A limit-stopped solve
    with an incumbent is FEASIBLE; any *undocumented* status that still
    carries an assignment is SUSPECT (not FEASIBLE — see `Status.SUSPECT`);
    no assignment at all is ERROR. Pinned by
    ``tests/test_portfolio.py::test_status_mapping_table``."""
    if raw_status == 0:
        return Status.OPTIMAL
    if raw_status == 1:
        return Status.FEASIBLE if has_solution else Status.ERROR
    if raw_status == 2:
        return Status.INFEASIBLE
    if raw_status == 3:
        return Status.UNBOUNDED
    return Status.SUSPECT if has_solution else Status.ERROR


@dataclasses.dataclass(frozen=True)
class Var:
    idx: int
    name: str
    is_int: bool

    # Arithmetic sugar -> LinExpr
    def __mul__(self, k: float) -> "LinExpr":
        return LinExpr({self.idx: float(k)}, 0.0)

    __rmul__ = __mul__

    def __add__(self, other) -> "LinExpr":
        return LinExpr({self.idx: 1.0}, 0.0) + other

    __radd__ = __add__

    def __sub__(self, other) -> "LinExpr":
        return LinExpr({self.idx: 1.0}, 0.0) - other

    def __rsub__(self, other) -> "LinExpr":
        return LinExpr.of(other) - LinExpr({self.idx: 1.0}, 0.0)

    def __neg__(self) -> "LinExpr":
        return LinExpr({self.idx: -1.0}, 0.0)


@dataclasses.dataclass
class LinExpr:
    coef: dict[int, float]
    const: float = 0.0

    @staticmethod
    def of(x) -> "LinExpr":
        if isinstance(x, LinExpr):
            return x
        if isinstance(x, Var):
            return LinExpr({x.idx: 1.0}, 0.0)
        return LinExpr({}, float(x))

    def __add__(self, other) -> "LinExpr":
        o = LinExpr.of(other)
        c = dict(self.coef)
        for k, v in o.coef.items():
            c[k] = c.get(k, 0.0) + v
        return LinExpr(c, self.const + o.const)

    __radd__ = __add__

    def __sub__(self, other) -> "LinExpr":
        o = LinExpr.of(other)
        return self + LinExpr({k: -v for k, v in o.coef.items()}, -o.const)

    def __rsub__(self, other) -> "LinExpr":
        return LinExpr.of(other) - self

    def __mul__(self, k: float) -> "LinExpr":
        return LinExpr({i: v * k for i, v in self.coef.items()},
                       self.const * k)

    __rmul__ = __mul__

    def __neg__(self) -> "LinExpr":
        return self * -1.0


class MipModel:
    def __init__(self, name: str = "model"):
        self.name = name
        self._lb: list[float] = []
        self._ub: list[float] = []
        self._int: list[bool] = []
        self._names: list[str] = []
        # constraint triplets
        self._rows: list[dict[int, float]] = []
        self._rlb: list[float] = []
        self._rub: list[float] = []
        self._obj: dict[int, float] = {}
        self._obj_const = 0.0

    # ---- variables --------------------------------------------------------
    def add_var(self, name: str, lb: float = 0.0, ub: float = math.inf,
                integer: bool = False) -> Var:
        self._names.append(name)
        self._lb.append(lb)
        self._ub.append(ub)
        self._int.append(integer)
        return Var(len(self._names) - 1, name, integer)

    def add_binary(self, name: str) -> Var:
        return self.add_var(name, 0.0, 1.0, integer=True)

    def add_binaries(self, prefix: str, n: int) -> list[Var]:
        return [self.add_binary(f"{prefix}[{i}]") for i in range(n)]

    @property
    def n_vars(self) -> int:
        return len(self._names)

    @property
    def n_rows(self) -> int:
        return len(self._rows)

    # ---- constraints -------------------------------------------------------
    def _add_row(self, expr: LinExpr, lb: float, ub: float) -> None:
        self._rows.append(expr.coef)
        self._rlb.append(lb - expr.const)
        self._rub.append(ub - expr.const)

    def add_le(self, expr, rhs: float = 0.0) -> None:
        e = LinExpr.of(expr)
        self._add_row(e, -math.inf, rhs)

    def add_ge(self, expr, rhs: float = 0.0) -> None:
        e = LinExpr.of(expr)
        self._add_row(e, rhs, math.inf)

    def add_eq(self, expr, rhs: float = 0.0) -> None:
        e = LinExpr.of(expr)
        self._add_row(e, rhs, rhs)

    def add_indicator_le(self, binary: Var, expr, rhs: float,
                         big_m: float) -> None:
        """binary == 1  ->  expr <= rhs   (big-M)."""
        e = LinExpr.of(expr) + big_m * binary
        self._add_row(e, -math.inf, rhs + big_m)

    def add_indicator_ge(self, binary: Var, expr, rhs: float,
                         big_m: float) -> None:
        """binary == 1  ->  expr >= rhs   (big-M)."""
        e = LinExpr.of(expr) - big_m * binary
        self._add_row(e, rhs - big_m, math.inf)

    # ---- logical helpers ----------------------------------------------------
    def add_and(self, name: str, terms: Sequence[Var]) -> Var:
        z = self.add_binary(name)
        for t in terms:
            self.add_le(z - t, 0.0)                      # z <= t
        # z >= sum(t) - (n-1)
        self.add_le(sum(terms, LinExpr({}, 0.0)) - z, len(terms) - 1)
        return z

    def add_or(self, name: str, terms: Sequence[Var]) -> Var:
        z = self.add_binary(name)
        for t in terms:
            self.add_ge(z - t, 0.0)                      # z >= t
        self.add_le(z - sum(terms, LinExpr({}, 0.0)), 0.0)
        return z

    def add_max_ge(self, out: Var, exprs: Iterable) -> None:
        """out >= each expr; exact under minimization pressure."""
        for e in exprs:
            self.add_ge(out - LinExpr.of(e), 0.0)

    def add_one_hot(self, prefix: str, n: int, active=1) -> list[Var]:
        vs = self.add_binaries(prefix, n)
        e = sum(vs, LinExpr({}, 0.0))
        if isinstance(active, (int, float)):
            self.add_eq(e, float(active))
        else:
            self.add_eq(e - active, 0.0)
        return vs

    def add_choice(self, prefix: str, options: Sequence) -> dict:
        """One-hot selection over arbitrary hashable options: one binary
        per option, exactly one active. Returns ``{option: Var}`` so
        callers index by the option itself (e.g. a ``(chip, cores)`` pair
        — the mesh placement MIP, `scheduler.schedule_mesh`) instead of a
        positional list."""
        vs = {opt: self.add_binary(f"{prefix}[{opt}]") for opt in options}
        assert len(vs) == len(options), f"duplicate options in {prefix}"
        self.add_eq(sum(vs.values(), LinExpr({}, 0.0)), 1.0)
        return vs

    # ---- objective -----------------------------------------------------------
    def minimize(self, expr) -> None:
        e = LinExpr.of(expr)
        self._obj = dict(e.coef)
        self._obj_const = e.const

    # ---- solve -----------------------------------------------------------------
    def solve(self, time_limit_s: float = 60.0, mip_rel_gap: float = 0.01,
              verbose: bool = False, node_limit: int | None = None,
              presolve: bool | None = None):
        """``node_limit`` caps branch-and-bound nodes (a *deterministic*
        termination criterion — the solver portfolio's determinism lever,
        `core/portfolio.py`); ``presolve`` toggles HiGHS presolve (None =
        solver default, i.e. on)."""
        n = self.n_vars
        c = np.zeros(n)
        for i, v in self._obj.items():
            c[i] = v
        if self._rows:
            data, ri, ci = [], [], []
            for r, row in enumerate(self._rows):
                for i, v in row.items():
                    ri.append(r)
                    ci.append(i)
                    data.append(v)
            a = sp.csr_matrix((data, (ri, ci)),
                              shape=(len(self._rows), n))
            constraints = LinearConstraint(a, np.array(self._rlb),
                                           np.array(self._rub))
        else:
            constraints = ()
        # a negative limit would reach HiGHS as "unlimited" — clamp
        options = {"time_limit": max(0.0, time_limit_s),
                   "mip_rel_gap": mip_rel_gap,
                   "disp": verbose}
        if node_limit is not None:
            options["node_limit"] = int(node_limit)
        if presolve is not None:
            options["presolve"] = bool(presolve)
        res = milp(
            c=c,
            constraints=constraints,
            integrality=np.array([1 if b else 0 for b in self._int]),
            bounds=Bounds(np.array(self._lb), np.array(self._ub)),
            options=options,
        )
        status = status_of(res.status, res.x is not None)
        gap = getattr(res, "mip_gap", math.nan)
        return Solution(status=status,
                        objective=(res.fun + self._obj_const)
                        if res.fun is not None else math.nan,
                        values=res.x, model=self,
                        mip_gap=float(gap) if gap is not None else math.nan,
                        raw_status=int(res.status),
                        mip_node_count=_opt_float(
                            getattr(res, "mip_node_count", None)),
                        mip_dual_bound=_opt_float(
                            getattr(res, "mip_dual_bound", None)))


def _opt_float(v) -> float:
    return float(v) if v is not None else math.nan


@dataclasses.dataclass
class Solution:
    status: Status
    objective: float
    values: np.ndarray | None
    model: MipModel
    mip_gap: float = math.nan
    #: scipy's untranslated result status — kept so a SUSPECT solve's
    #: origin (e.g. 4 = numerical trouble) stays inspectable.
    raw_status: int = -1
    #: branch-and-bound nodes explored / best dual (lower) bound at
    #: termination; NaN when HiGHS did not report them. These make a losing
    #: portfolio member explainable: few nodes + weak bound = starved,
    #: many nodes + tight bound = the region genuinely holds nothing
    #: better (`core/portfolio.py`).
    mip_node_count: float = math.nan
    mip_dual_bound: float = math.nan

    def __getitem__(self, var: Var) -> float:
        assert self.values is not None
        return float(self.values[var.idx])

    def binary(self, var: Var) -> bool:
        return self[var] > 0.5

    @property
    def ok(self) -> bool:
        """Trustworthy solve: OPTIMAL or a limit-stopped FEASIBLE incumbent.
        Deliberately excludes SUSPECT so consumers that use the assignment
        *without* independent re-validation (the scheduler/mesh placement
        MIPs, `mip_latency_of`) treat numerical-trouble solves as failures
        and take their fallback path."""
        return self.status in (Status.OPTIMAL, Status.FEASIBLE) and \
            self.values is not None

    @property
    def usable(self) -> bool:
        """``ok`` plus SUSPECT-with-assignment: for callers that re-validate
        and re-score the decoded result independently before trusting it
        (`formulation.optimize_layer`'s decode -> validate -> evaluate ->
        never-worse-than-incumbent path, which stays authoritative)."""
        return self.ok or (self.status is Status.SUSPECT
                           and self.values is not None)
