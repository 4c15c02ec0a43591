"""MIREDO MIP formulation (paper §IV, eqs. 2–14 + Table III).

Maps the dataflow-optimization problem onto the MIP modeling layer:

  X^L[d,f,i]   factor -> temporal slot            (eq. 2)
  X^U[d,f,u]   factor -> spatial axis             (eq. 2, C^X legality eq. 3)
  X^M[d,f,λ,m] factor -> memory level per operand (uneven mapping, eq. 3)
  X^Z[i,λ,m]   slot i in operand λ's level-m loop block (eq. 3/4)
  ψ^L, ψ^U     active-slot / level-used indicators (eq. 4)
  X^N[λ,m,m']  transfer path between consecutive used levels (eq. 5)
  B^S / B^T    log-domain per-dim loop bounds (eqs. 6, 10)
  V^S / V^T    one-hot data-size selections over pre-enumerated combos
               (eqs. 7, 8; combos from Flexible-Factorization value sets)
  ψ^DM, ψ^DL   double-buffer mode / per-slot overlap indicators (eqs. 9, 12)
  T, P, L      transfer / processing / critical-path latencies
               (eq. 11, Table III rows, eq. 13)
  objective    μ1·max_λ P_0,λ − μ2·Σ m·Size_{m,λ}  (eq. 14)

All products of decision variables are linearized exactly: one factor per
temporal slot makes loop counts N_i selectable per-factor with big-M rows;
data sizes select pre-enumerated per-dim bound combos (the paper's H/Y/V
machinery); variable effective bandwidth (core-lane parallelism) is handled
by a one-hot over achievable core extents. Big-M constants derive from a
greedy feasible mapping's evaluated latency — the MIP search region
provably contains the optimum (see DESIGN.md §Decisions).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Sequence

from repro_torch.core import workload as wl
from repro_torch.core.arch import (CimArch, INPUT, OPERANDS, OUTPUT, WEIGHT,
                             operand_bits)
from repro_torch.core.factorization import (factorize_layer_dims,
                                      sub_multiset_products)
from repro_torch.core.latency import evaluate
from repro_torch.core.mapping import Mapping, validate
from repro_torch.core.mip.model import LinExpr, MipModel, Status

LOG2_M = 64.0  # big-M for log-domain equalities (log2 of any bound << 64)

#: Floor multiplier for the latency big-M: ``M_L = max(latency_slack,
#: BIG_M_FLOOR) * UB``. Recursion rows sum up to four latency terms (e.g.
#: ``P >= cd*L + 2T + MX``), so 4x the incumbent latency is the smallest
#: region that provably never clips a candidate the prune row
#: (``PMAX <= UB*1.001``) would keep. ``latency_slack`` values at or below
#: the floor are therefore equivalent by construction — the cache key
#: canonicalizes them (`cache.config_cache_key`) so they share records.
BIG_M_FLOOR = 4.0


class ComboOverflow(RuntimeError):
    """Size-combo enumeration exceeded the cap; retry with coarser factors."""


@dataclasses.dataclass
class FormulationConfig:
    alpha: float = 0.15
    k_min: int = 3
    mu1: float = 1.0
    mu2_frac: float = 0.02        # locality reward as fraction of latency UB
    time_limit_s: float = 60.0
    mip_rel_gap: float = 0.02
    combo_cap: int = 4096
    #: Latency big-M multiplier: ``M_L = max(latency_slack, BIG_M_FLOOR) *
    #: incumbent latency``. Values above the floor loosen the LP relaxation
    #: (see DESIGN.md §Decisions); values at/below it are floored and share
    #: cache records (`cache.config_cache_key` canonicalizes).
    latency_slack: float = 8.0
    weight_stationary: bool = False   # WS baseline (§V-A) extra constraints
    verbose: bool = False


@dataclasses.dataclass
class MiredoResult:
    mapping: Mapping | None
    status: Status
    objective: float
    mip_latency: float            # P_max inside the MIP
    eval_latency: float           # re-scored by the analytical evaluator
    solve_seconds: float
    n_vars: int
    n_rows: int
    mip_gap: float
    #: Best *native* incumbent latency (greedy/heuristic pool, excluding
    #: any injected neighbor warm start): the baseline of the
    #: incumbent-unimproved metric (`benchmarks/opt_speed.py --portfolio`).
    incumbent_latency: float = math.nan
    #: Solver diagnostics at termination (NaN when not reported): nodes
    #: explored and best dual bound — what makes a losing portfolio member
    #: explainable (starved vs exhausted region).
    mip_node_count: float = math.nan
    mip_dual_bound: float = math.nan

    @property
    def improved(self) -> bool:
        """Did the MIP beat the native warm-start incumbent?"""
        return (math.isfinite(self.incumbent_latency)
                and self.eval_latency < self.incumbent_latency)


class MiredoFormulation:
    def __init__(self, layer: wl.Layer, arch: CimArch,
                 cfg: FormulationConfig | None = None):
        self.layer = layer
        self.arch = arch
        self.cfg = cfg or FormulationConfig()
        self.factors = factorize_layer_dims(
            {d: layer.bound(d) for d in wl.DIMS},
            alpha=self.cfg.alpha, k_min=self.cfg.k_min)
        # flat factor list
        self.ff: list[tuple[str, int, int]] = []   # (dim, local idx, value)
        for d, fs in sorted(self.factors.items()):
            for j, f in enumerate(fs):
                self.ff.append((d, j, f))
        self.n_slots = len(self.ff)
        self.levels = list(range(arch.n_levels))
        self.m = MipModel(f"miredo[{layer.name}]")

    # ------------------------------------------------------------------
    def build(self, big_m_latency: float, big_m_transfer: float) -> None:
        m, arch, layer, cfg = self.m, self.arch, self.layer, self.cfg
        ff, n_slots = self.ff, self.n_slots
        nL = arch.n_levels
        log2 = math.log2

        # ---------------- mapping variables ----------------
        self.XL = {}
        self.XU = {}
        for k, (d, j, f) in enumerate(ff):
            for i in range(n_slots):
                self.XL[k, i] = m.add_binary(f"XL[{d}{j}={f},s{i}]")
            for ax in arch.spatial:
                if d in ax.dims:
                    self.XU[k, ax.name] = m.add_binary(f"XU[{d}{j},{ax.name}]")
        # symmetry breaking: identical (dim, value) factors get a canonical
        # assignment order (huge XL permutation symmetry otherwise).
        for k in range(len(ff) - 1):
            d, j, f = ff[k]
            d2, j2, f2 = ff[k + 1]
            if d == d2 and f == f2:
                rank_k = LinExpr({})
                rank_k2 = LinExpr({})
                for i in range(n_slots):
                    rank_k = rank_k + float(i + 1) * self.XL[k, i]
                    rank_k2 = rank_k2 + float(i + 1) * self.XL[k + 1, i]
                for a_i, ax in enumerate(arch.spatial):
                    if (k, ax.name) in self.XU:
                        rank_k = rank_k + float(n_slots + 1 + a_i) * \
                            self.XU[k, ax.name]
                        rank_k2 = rank_k2 + float(n_slots + 1 + a_i) * \
                            self.XU[k + 1, ax.name]
                m.add_le(rank_k - rank_k2, 0.0)
        # (2) uniqueness
        for k in range(len(ff)):
            terms = [self.XL[k, i] for i in range(n_slots)]
            terms += [self.XU[k, ax.name] for ax in arch.spatial
                      if (k, ax.name) in self.XU]
            m.add_eq(sum(terms, LinExpr({})), 1.0)
        # one factor per slot; psi^L prefix-active
        self.psiL = []
        for i in range(n_slots):
            occ = sum((self.XL[k, i] for k in range(len(ff))), LinExpr({}))
            p = m.add_binary(f"psiL[{i}]")
            m.add_eq(p - occ, 0.0)
            self.psiL.append(p)
        for i in range(n_slots - 1):
            m.add_ge(self.psiL[i] - self.psiL[i + 1], 0.0)
        # axis size limits (log domain)
        for ax in arch.spatial:
            e = LinExpr({})
            for k, (d, j, f) in enumerate(ff):
                if (k, ax.name) in self.XU:
                    e = e + log2(f) * self.XU[k, ax.name]
            m.add_le(e, log2(ax.size))

        # X^M per operand (uneven mapping); only levels serving the operand
        self.XM = {}
        for k, (d, j, f) in enumerate(ff):
            for lam in OPERANDS:
                legal = [mm for mm in self.levels if arch.serves(mm, lam)]
                for mm in legal:
                    self.XM[k, lam, mm] = m.add_binary(
                        f"XM[{d}{j},{lam},m{mm}]")
                is_temporal = sum((self.XL[k, i] for i in range(n_slots)),
                                  LinExpr({}))
                m.add_eq(sum((self.XM[k, lam, mm] for mm in legal),
                             LinExpr({})) - is_temporal, 0.0)

        # X^Z: slot-level block membership per operand (eq. 3) — exact via
        # lower bounds + per-slot one-hot against psi^L.
        self.XZ = {}
        for i in range(n_slots):
            for lam in OPERANDS:
                legal = [mm for mm in self.levels if arch.serves(mm, lam)]
                for mm in legal:
                    z = m.add_binary(f"XZ[s{i},{lam},m{mm}]")
                    self.XZ[i, lam, mm] = z
                m.add_eq(sum((self.XZ[i, lam, mm] for mm in legal),
                             LinExpr({})) - self.psiL[i], 0.0)
        for k in range(len(ff)):
            for i in range(n_slots):
                for lam in OPERANDS:
                    for mm in self.levels:
                        if (k, lam, mm) in self.XM and (i, lam, mm) in self.XZ:
                            m.add_ge(self.XZ[i, lam, mm] - self.XL[k, i]
                                     - self.XM[k, lam, mm], -1.0)
        # loop-block ordering: levels non-decreasing outer -> inner
        for lam in OPERANDS:
            for i in range(n_slots - 1):
                lhs = LinExpr({})
                for mm in self.levels:
                    if (i, lam, mm) in self.XZ:
                        lhs = lhs + mm * self.XZ[i, lam, mm]
                    if (i + 1, lam, mm) in self.XZ:
                        lhs = lhs - mm * self.XZ[i + 1, lam, mm]
                m.add_le(lhs - nL * (1 - self.psiL[i + 1] * 1.0), 0.0)

        # psi^U (eq. 4). Level 0 (DRAM) is the home of every tensor and is
        # always on the transfer path, independent of loop placement.
        self.psiU = {}
        for lam in OPERANDS:
            for mm in self.levels:
                if mm == 0:
                    one = m.add_binary(f"psiU[{lam},m0]")
                    m.add_eq(LinExpr({one.idx: 1.0}), 1.0)
                    self.psiU[lam, mm] = one
                    continue
                xs = [self.XM[k, lam, mm] for k in range(len(ff))
                      if (k, lam, mm) in self.XM]
                if xs:
                    self.psiU[lam, mm] = m.add_or(f"psiU[{lam},m{mm}]", xs)

        # NotDeepest / HasOut / X^N (eq. 5)
        self.notdeep = {}
        self.hasout = {}
        self.XN = {}
        for lam in OPERANDS:
            for mm in self.levels:
                if (lam, mm) not in self.psiU:
                    continue
                below = [self.psiU[lam, m2] for m2 in self.levels
                         if m2 > mm and (lam, m2) in self.psiU]
                if below:
                    nd = m.add_or(f"ND[{lam},m{mm}]", below)
                else:
                    nd = m.add_binary(f"ND[{lam},m{mm}]")
                    m.add_eq(LinExpr({nd.idx: 1.0}), 0.0)
                self.notdeep[lam, mm] = nd
                ho = m.add_and(f"HO[{lam},m{mm}]", [self.psiU[lam, mm], nd])
                self.hasout[lam, mm] = ho
            for mm in self.levels:
                if (lam, mm) not in self.psiU:
                    continue
                outs = []
                for m2 in self.levels:
                    if m2 <= mm or (lam, m2) not in self.psiU:
                        continue
                    xn = m.add_binary(f"XN[{lam},m{mm}->m{m2}]")
                    self.XN[lam, mm, m2] = xn
                    m.add_le(xn - self.psiU[lam, m2], 0.0)
                    # no hop across an intermediate used level
                    for m3 in self.levels:
                        if mm < m3 < m2 and (lam, m3) in self.psiU:
                            m.add_le(xn + self.psiU[lam, m3], 1.0)
                    outs.append(xn)
                if outs:
                    m.add_eq(sum(outs, LinExpr({}))
                             - self.hasout[lam, mm], 0.0)

        # weights must terminate in the macro array
        mac = arch.macro_level
        if (WEIGHT, mac) in self.psiU:
            m.add_ge(LinExpr({self.psiU[WEIGHT, mac].idx: 1.0}), 1.0)

        # psi^DM (eq. 9 buffering mode)
        self.psiDM = {}
        for lam in OPERANDS:
            for mm in self.levels:
                lvl = arch.level(mm)
                if (lam, mm) in self.psiU and lvl.double_bufferable \
                        and mm != mac:
                    dm = m.add_binary(f"psiDM[{lam},m{mm}]")
                    m.add_le(dm - self.psiU[lam, mm], 0.0)
                    self.psiDM[lam, mm] = dm

        # ---------------- core-extent one-hot (variable bandwidth) --------
        core_vals = self._core_extent_values()
        self.VE = self.m.add_one_hot("VE", len(core_vals))
        e_log = LinExpr({})
        for k, (d, j, f) in enumerate(ff):
            if (k, "core") in self.XU:
                e_log = e_log + log2(f) * self.XU[k, "core"]
        sel = LinExpr({})
        for v, var in zip(core_vals, self.VE):
            sel = sel + log2(v) * var
        m.add_eq(sel - e_log, 0.0)
        self.core_vals = core_vals

        # ---------------- size/transfer enumeration (eqs. 6-10) ----------
        self._build_sizes()

        # ---------------- capacity (eq. 9) --------------------------------
        self._build_capacity()

        # ---------------- latency (eq. 11-13, Table III) -------------------
        self._build_latency(big_m_latency, big_m_transfer)

        # ---------------- objective (eq. 14) -------------------------------
        size_term = LinExpr({})
        for (mm, lam), s in self.Size.items():
            size_term = size_term + float(mm) * s
        max_size = sum(
            mm * self._max_bytes(mm, lam)
            for (mm, lam) in self.Size.keys()) or 1.0
        mu2 = cfg.mu2_frac * big_m_latency / max_size
        m.minimize(cfg.mu1 * self.PMAX - mu2 * size_term)

        if cfg.weight_stationary:
            self._add_ws_constraints()

    # ------------------------------------------------------------------
    def _core_extent_values(self) -> list[int]:
        ax = self.arch.axis("core")
        pool = [f for (d, j, f) in self.ff if d in ax.dims]
        vals = [v for v in sub_multiset_products(pool) if v <= ax.size]
        return vals or [1]

    def _dim_values(self, d: str) -> list[int]:
        return sub_multiset_products(self.factors.get(d, []))

    def _max_bytes(self, mm: int, lam: str) -> float:
        return self.layer.operand_elems(lam) * \
            operand_bits(self.arch, mm, lam) / 8.0

    def _combos(self, mm: int, lam: str) -> list[dict[str, int]]:
        """Enumerate per-dim bound combos for (m, λ), capacity-filtered."""
        rel = [d for d in wl.RELEVANT[lam] if d in self.factors]
        value_sets = [self._dim_values(d) for d in rel]
        cap = self.arch.level(mm).capacity_bytes
        max_lanes = max(self.core_vals)
        out = []
        for combo in itertools.product(*value_sets):
            t = dict(zip(rel, combo))
            elems = wl.operand_tile_elems(self.layer, lam, t)
            b = elems * operand_bits(self.arch, mm, lam) / 8.0
            if cap is not None and b > cap * max_lanes * 2:
                continue
            out.append(t)
        if len(out) > self.cfg.combo_cap:
            raise ComboOverflow(
                f"{len(out)} combos for (m={mm}, {lam}); coarsen the "
                f"factorization (alpha/k_min)")
        return out

    def _combo_bytes(self, mm: int, lam: str, t: dict[str, int]) -> float:
        elems = wl.operand_tile_elems(self.layer, lam, t)
        return elems * operand_bits(self.arch, mm, lam) / 8.0

    def _bound_expr(self, d: str, lam: str, min_level: int,
                    spatial_min_cu: int) -> LinExpr:
        """Σ_f log2(F)·(Σ_{m'>=min_level} X^M + Σ_{u: C_u>=cu} X^U)."""
        e = LinExpr({})
        for k, (dd, j, f) in enumerate(self.ff):
            if dd != d:
                continue
            for mm in self.levels:
                if mm >= min_level and (k, lam, mm) in self.XM:
                    e = e + math.log2(f) * self.XM[k, lam, mm]
            for ax in self.arch.spatial:
                if ax.at_level >= spatial_min_cu and (k, ax.name) in self.XU:
                    e = e + math.log2(f) * self.XU[k, ax.name]
        return e

    def _build_sizes(self) -> None:
        m, arch, cfg = self.m, self.arch, self.cfg
        self.VS = {}
        self.VT = {}
        self.Size = {}
        self.TC = {}
        self.combos = {}
        for lam in OPERANDS:
            for mm in self.levels:
                if (lam, mm) not in self.psiU:
                    continue
                combos = self._combos(mm, lam)
                self.combos[mm, lam] = combos
                rel = [d for d in wl.RELEVANT[lam] if d in self.factors]
                # ---- V^S: stored size (skip DRAM: unbounded, no objective
                # term at m=0 anyway)
                if mm >= 1:
                    vs = m.add_binaries(f"VS[m{mm},{lam}]", len(combos))
                    m.add_eq(sum(vs, LinExpr({}))
                             - self.psiU[lam, mm], 0.0)
                    self.VS[mm, lam] = vs
                    for d in rel:
                        selected = LinExpr({})
                        for t, var in zip(combos, vs):
                            selected = selected + math.log2(t[d]) * var
                        bexpr = self._bound_expr(d, lam, mm, mm)
                        diff = selected - bexpr
                        # enforce only when psi^U = 1 (eq. 8)
                        gate = LOG2_M * (1 - self.psiU[lam, mm] * 1.0)
                        m.add_le(diff - gate, 0.0)
                        m.add_ge(diff + gate, 0.0)
                    size = m.add_var(f"Size[m{mm},{lam}]", 0.0,
                                     self._max_bytes(mm, lam))
                    sel_b = LinExpr({})
                    for t, var in zip(combos, vs):
                        sel_b = sel_b + self._combo_bytes(mm, lam, t) * var
                    m.add_eq(size - sel_b, 0.0)
                    self.Size[mm, lam] = size
                # ---- V^T: transfer chunk out of level mm (eq. 10/11)
                if (lam, mm) in self.hasout:
                    vt = m.add_binaries(f"VT[m{mm},{lam}]", len(combos))
                    m.add_eq(sum(vt, LinExpr({}))
                             - self.hasout[lam, mm], 0.0)
                    self.VT[mm, lam] = vt
                    for d in rel:
                        selected = LinExpr({})
                        for t, var in zip(combos, vt):
                            selected = selected + math.log2(t[d]) * var
                        bexpr = self._bound_expr(d, lam, mm + 1, mm)
                        diff = selected - bexpr
                        gate = LOG2_M * (1 - self.hasout[lam, mm] * 1.0)
                        m.add_le(diff - gate, 0.0)
                        m.add_ge(diff + gate, 0.0)

    def _transfer_cycles_const(self, mm: int, lam: str, t: dict[str, int],
                               lanes: int) -> float:
        bw = self.arch.level(mm).bytes_per_cycle() * lanes
        return math.ceil(self._combo_bytes(mm, lam, t) / bw)

    def _build_capacity(self) -> None:
        m, arch = self.m, self.arch
        self.DBX = {}
        cap_lanes = {}
        for mm in self.levels:
            lvl = arch.level(mm)
            if lvl.capacity_bytes is None:
                continue
            # effective capacity = cap * core extent when level replicated
            replicated = any(
                ax.replicates_from is not None and ax.replicates_from <= mm
                for ax in arch.spatial)
            cap_rhs = LinExpr({})
            if replicated:
                for v, var in zip(self.core_vals, self.VE):
                    cap_rhs = cap_rhs + (lvl.capacity_bytes * v) * var
            else:
                cap_rhs = LinExpr({}, float(lvl.capacity_bytes))
            served = [lam for lam in OPERANDS if (mm, lam) in self.Size]
            terms = LinExpr({})
            for lam in served:
                size = self.Size[mm, lam]
                dbx = m.add_var(f"DBX[m{mm},{lam}]", 0.0,
                                self._max_bytes(mm, lam))
                self.DBX[mm, lam] = dbx
                if (lam, mm) in self.psiDM:
                    big = self._max_bytes(mm, lam)
                    m.add_ge(dbx - size + big * (1 - self.psiDM[lam, mm]
                                                 * 1.0), 0.0)
                if lvl.shared:
                    terms = terms + size + dbx
                else:
                    m.add_le(size + dbx - cap_rhs, 0.0)
            if lvl.shared and served:
                m.add_le(terms - cap_rhs, 0.0)

    def _build_latency(self, m_lat: float, m_tr: float) -> None:
        m, arch, layer = self.m, self.arch, self.layer
        ff, n_slots = self.ff, self.n_slots
        l_mvm = float(arch.l_mvm_cycles)
        mac = arch.macro_level

        # DBdest[λ,m]: hop out of m lands in a double-buffered level (eq. 12,
        # destination-mode reading — see DESIGN.md).
        dbdest = {}
        for lam in OPERANDS:
            for mm in self.levels:
                if (lam, mm) not in self.hasout:
                    continue
                terms = []
                for m2 in self.levels:
                    if (lam, mm, m2) in self.XN and (lam, m2) in self.psiDM:
                        terms.append(m.add_and(
                            f"XNDM[{lam},{mm},{m2}]",
                            [self.XN[lam, mm, m2], self.psiDM[lam, m2]]))
                if terms:
                    dbdest[lam, mm] = m.add_or(f"DBd[{lam},m{mm}]", terms)

        # TC[m,λ]: cycles per transfer out of level m (eq. 11), with
        # lane-scaled bandwidth for replicated levels and the Memory-mode
        # switch penalty for weight reloads into the macro.
        for lam in OPERANDS:
            for mm in self.levels:
                if (mm, lam) not in self.VT:
                    continue
                tc = m.add_var(f"TC[m{mm},{lam}]", 0.0, m_tr)
                self.TC[mm, lam] = tc
                # pin to zero when the hop does not exist
                m.add_le(tc - m_tr * self.hasout[lam, mm], 0.0)
                combos = self.combos[mm, lam]
                vt = self.VT[mm, lam]
                ms_term = LinExpr({})
                if lam == WEIGHT and (lam, mm, mac) in self.XN:
                    ms_term = arch.mode_switch_cycles * self.XN[lam, mm, mac]
                lane_scaled = any(
                    ax.replicates_from is not None and ax.replicates_from <= mm
                    for ax in arch.spatial)
                if not lane_scaled:
                    sel = LinExpr({})
                    for t, var in zip(combos, vt):
                        sel = sel + self._transfer_cycles_const(
                            mm, lam, t, 1) * var
                    m.add_ge(tc - sel - ms_term, 0.0)
                else:
                    for t, var in zip(combos, vt):
                        for v, evar in zip(self.core_vals, self.VE):
                            cyc = self._transfer_cycles_const(mm, lam, t, v)
                            rhs = cyc * 1.0
                            e = tc - ms_term + m_tr * (1 - var * 1.0) \
                                + m_tr * (1 - evar * 1.0)
                            m.add_ge(e, rhs)

        # per-slot machinery
        self.T = {}
        self.P = {}
        self.L = []
        self.R = {}
        hasT = {}
        act_single = {}
        act_double = {}
        for i in range(n_slots):
            self.L.append(m.add_var(f"L[{i}]", l_mvm, m_lat))
            for lam in OPERANDS:
                self.P[i, lam] = m.add_var(f"P[{i},{lam}]", l_mvm, m_lat)
                self.T[i, lam] = m.add_var(f"T[{i},{lam}]", 0.0, m_tr)
        # boundary pseudo-slot
        p_bound = {lam: LinExpr({}, l_mvm) for lam in OPERANDS}

        for i in range(n_slots):
            for lam in OPERANDS:
                # R[i,λ]: slot's dim relevant to λ
                rel_expr = LinExpr({})
                for k, (d, j, f) in enumerate(self.ff):
                    if wl.is_relevant(d, lam):
                        rel_expr = rel_expr + self.XL[k, i]
                r = m.add_binary(f"R[{i},{lam}]")
                m.add_eq(LinExpr({r.idx: 1.0}) - rel_expr, 0.0)
                self.R[i, lam] = r
                # W1[i,λ,m] = XZ ∧ HasOut  (transfer possible at this slot)
                w1s = []
                for mm in self.levels:
                    if (i, lam, mm) in self.XZ and (lam, mm) in self.hasout:
                        w1s.append(m.add_and(
                            f"W1[{i},{lam},m{mm}]",
                            [self.XZ[i, lam, mm], self.hasout[lam, mm]]))
                ht = m.add_binary(f"HasT[{i},{lam}]")
                if w1s:
                    sw = sum(w1s, LinExpr({}))
                    m.add_le(LinExpr({ht.idx: 1.0}) - sw, 0.0)
                    m.add_le(ht - r, 0.0)
                    m.add_ge(LinExpr({ht.idx: 1.0}) - sw
                             - LinExpr({r.idx: 1.0}), -1.0)
                else:
                    m.add_eq(LinExpr({ht.idx: 1.0}), 0.0)
                hasT[i, lam] = ht
                # psi^DL via W2 = XZ ∧ DBdest
                w2s = []
                for mm in self.levels:
                    if (i, lam, mm) in self.XZ and (lam, mm) in dbdest:
                        w2s.append(m.add_and(
                            f"W2[{i},{lam},m{mm}]",
                            [self.XZ[i, lam, mm], dbdest[lam, mm]]))
                if w2s:
                    dl = m.add_or(f"psiDL[{i},{lam}]", w2s)
                else:
                    dl = m.add_binary(f"psiDL[{i},{lam}]")
                    m.add_eq(LinExpr({dl.idx: 1.0}), 0.0)
                a_d = m.add_and(f"ActD[{i},{lam}]", [ht, dl])
                act_double[i, lam] = a_d
                a_s = m.add_binary(f"ActS[{i},{lam}]")
                # single = HasT ∧ ¬DL  ->  a_s = ht - a_d
                m.add_eq(LinExpr({a_s.idx: 1.0}) - ht + a_d, 0.0)
                act_single[i, lam] = a_s
                # T[i,λ] >= TC[m,λ] when slot in block m and transfer active
                for mm in self.levels:
                    if (mm, lam) in self.TC and (i, lam, mm) in self.XZ:
                        e = self.T[i, lam] - self.TC[mm, lam] \
                            + m_tr * (1 - self.XZ[i, lam, mm] * 1.0) \
                            + m_tr * (1 - ht * 1.0)
                        m.add_ge(e, 0.0)

        # recursion rows (Table III), innermost upward
        self.PMAX = m.add_var("PMAX", l_mvm, m_lat)
        for i in range(n_slots - 1, -1, -1):
            L_i = self.L[i]
            if i == n_slots - 1:
                l_inner = LinExpr({}, l_mvm)
                p_inner = p_bound
                n_inner_rows = []          # inner N fixed to 1
            else:
                l_inner = LinExpr({self.L[i + 1].idx: 1.0})
                p_inner = {lam: LinExpr({self.P[i + 1, lam].idx: 1.0})
                           for lam in OPERANDS}
                n_inner_rows = [(k, f) for k, (d, j, f) in enumerate(ff)]
            # L_i >= L_{i+1} (propagation)
            m.add_ge(L_i - l_inner, 0.0)
            # L_i >= L_{i+1} * N_{i+1}   (per-factor big-M; gate scaled by F
            # because the bounded expression reaches F * m_lat)
            for k, f in n_inner_rows:
                m.add_ge(L_i - f * l_inner
                         + f * m_lat * (1 - self.XL[k, i + 1] * 1.0), 0.0)
            for lam in OPERANDS:
                t_v = self.T[i, lam]
                # combined components of L_i (active slots only)
                m.add_ge(L_i - p_inner[lam]
                         + m_lat * (1 - self.psiL[i] * 1.0), 0.0)
                m.add_ge(L_i - t_v - p_inner[lam]
                         + 2 * m_lat * (1 - act_single[i, lam] * 1.0), 0.0)
                m.add_ge(L_i - t_v
                         + m_lat * (1 - self.psiL[i] * 1.0), 0.0)
                # MX = max(T, P_inner); MXL = max(T, L_i)
                mx = m.add_var(f"MX[{i},{lam}]", 0.0, m_lat)
                m.add_ge(mx - t_v, 0.0)
                m.add_ge(mx - p_inner[lam], 0.0)
                mxl = m.add_var(f"MXL[{i},{lam}]", 0.0, m_lat)
                m.add_ge(mxl - t_v, 0.0)
                m.add_ge(mxl - L_i, 0.0)
                P_i = self.P[i, lam]
                m.add_ge(P_i - p_inner[lam], 0.0)   # monotone propagation
                ht = hasT[i, lam]
                a_s, a_d = act_single[i, lam], act_double[i, lam]
                is_o = lam == OUTPUT
                for k, (d, j, f) in enumerate(ff):
                    # Gates must dominate the full row magnitude, which
                    # scales with F: use (F+4)*m_lat.
                    gm = (f + 4) * m_lat
                    gate_slot = gm * (1 - self.XL[k, i] * 1.0)
                    # no-transfer row: P >= (F-1) L + P_inner
                    m.add_ge(P_i - (f - 1) * L_i - p_inner[lam]
                             + gate_slot + gm * (ht * 1.0), 0.0)
                    if not is_o:
                        cs = max(f - 2, 0)
                        m.add_ge(P_i - cs * L_i - 2 * t_v - p_inner[lam]
                                 + gate_slot
                                 + gm * (1 - a_s * 1.0), 0.0)
                        cd = max(f - 3, 0)
                        m.add_ge(P_i - cd * L_i - 2 * t_v - mx
                                 + gate_slot
                                 + gm * (1 - a_d * 1.0), 0.0)
                        m.add_ge(P_i - f * t_v + gate_slot
                                 + gm * (1 - a_d * 1.0), 0.0)
                    else:
                        cs = max(f - 1, 0)
                        m.add_ge(P_i - cs * L_i - 2 * t_v - p_inner[lam]
                                 + gate_slot
                                 + gm * (1 - a_s * 1.0), 0.0)
                        cd = max(f - 2, 0)
                        m.add_ge(P_i - cd * L_i - t_v - mxl - mx
                                 + gate_slot
                                 + gm * (1 - a_d * 1.0), 0.0)
                # inactive slot: P_i >= P_inner (already), == via minimization

        # ---- one-time fills -------------------------------------------------
        # A hop out of level m is "triggered" when some λ-relevant slot sits
        # at a level <= m; untriggered hops (fully-stationary tiles: initial
        # weight program-in, final output drain) cost one TC, charged once on
        # top of P_0 — mirrors latency.evaluate()'s one-time accounting.
        self.OTC = {}
        for lam in OPERANDS:
            for mm in self.levels:
                if (mm, lam) not in self.TC:
                    continue
                trig_terms = []
                for i in range(n_slots):
                    le_expr = LinExpr({})
                    for m2 in self.levels:
                        if m2 <= mm and (i, lam, m2) in self.XZ:
                            le_expr = le_expr + self.XZ[i, lam, m2]
                    tr = m.add_binary(f"TrL[{i},{lam},m{mm}]")
                    m.add_le(tr - self.R[i, lam], 0.0)
                    m.add_le(LinExpr({tr.idx: 1.0}) - le_expr, 0.0)
                    m.add_ge(LinExpr({tr.idx: 1.0}) - le_expr
                             - self.R[i, lam], -1.0)
                    trig_terms.append(tr)
                trig = m.add_or(f"Trig[{lam},m{mm}]", trig_terms) \
                    if trig_terms else None
                otc = m.add_var(f"OTC[{lam},m{mm}]", 0.0, m_tr)
                rhs = self.TC[mm, lam] - otc
                if trig is not None:
                    rhs = rhs - m_tr * trig
                m.add_le(rhs, 0.0)       # otc >= TC - M*trig
                self.OTC[lam, mm] = otc

        # One-time fills serialize with each other (shared DRAM/GBuf buses):
        # total = max_λ P_0,λ + Σ_{λ,m} OTC — matches latency.evaluate().
        ot_sum = LinExpr({})
        for (lam, mm), v in self.OTC.items():
            ot_sum = ot_sum + v
        for lam in OPERANDS:
            m.add_ge(self.PMAX - self.P[0, lam] - ot_sum, 0.0)

    # ------------------------------------------------------------------
    def _add_ws_constraints(self) -> None:
        """Weight-stationary baseline: weight-relevant loops outermost (each
        weight tile loaded exactly once) and no weight double-buffering."""
        m = self.m
        n = self.n_slots
        pos = {}
        for k, (d, j, f) in enumerate(self.ff):
            e = LinExpr({})
            for i in range(n):
                e = e + float(i) * self.XL[k, i]
            pos[k] = e
        for k, (d, j, f) in enumerate(self.ff):
            for k2, (d2, j2, f2) in enumerate(self.ff):
                if wl.is_relevant(d, WEIGHT) and not wl.is_relevant(d2, WEIGHT):
                    # pos_k <= pos_k2 whenever both factors are temporal:
                    # pos_k - pos_k2 + n*tk + n*tk2 <= 2n
                    tk = sum((self.XL[k, i] for i in range(n)), LinExpr({}))
                    tk2 = sum((self.XL[k2, i] for i in range(n)), LinExpr({}))
                    m.add_le(pos[k] - pos[k2] + n * tk + n * tk2, 2.0 * n)
        for (lam, mm), dm in list(self.psiDM.items()):
            if lam == WEIGHT:
                m.add_eq(LinExpr({dm.idx: 1.0}), 0.0)

    # ------------------------------------------------------------------
    def decode(self, sol) -> Mapping:
        arch = self.arch
        spatial: dict[str, list[tuple[str, int]]] = {ax.name: []
                                                     for ax in arch.spatial}
        slot_of: dict[int, int] = {}
        for k, (d, j, f) in enumerate(self.ff):
            placed = False
            for i in range(self.n_slots):
                if sol.binary(self.XL[k, i]):
                    slot_of[k] = i
                    placed = True
                    break
            if not placed:
                for ax in arch.spatial:
                    if (k, ax.name) in self.XU and \
                            sol.binary(self.XU[k, ax.name]):
                        spatial[ax.name].append((d, f))
                        break
        order = sorted(slot_of.items(), key=lambda kv: kv[1])
        temporal = tuple((self.ff[k][0], self.ff[k][2]) for k, _ in order)
        level_of = {}
        for lam in OPERANDS:
            lv = []
            for k, i in order:
                mm_sel = None
                for mm in self.levels:
                    if (k, lam, mm) in self.XM and \
                            sol.binary(self.XM[k, lam, mm]):
                        mm_sel = mm
                        break
                lv.append(mm_sel if mm_sel is not None else 0)
            level_of[lam] = tuple(lv)
        dbuf = set()
        for (lam, mm), dm in self.psiDM.items():
            if sol.binary(dm):
                dbuf.add((lam, mm))
        return Mapping(
            spatial={k: tuple(v) for k, v in spatial.items()},
            temporal=temporal, level_of=level_of,
            double_buf=frozenset(dbuf))


def pin_mapping(form: MiredoFormulation, mapping: Mapping) -> None:
    """Fix all structural binaries to encode a concrete mapping (testing:
    the MIP's internal latency must then equal latency.evaluate())."""
    m, arch = form.m, form.arch

    def pin(var, val):
        m._lb[var.idx] = m._ub[var.idx] = float(val)

    used = set()

    def take(d, fval):
        for k, (dd, j, fv) in enumerate(form.ff):
            if k not in used and dd == d and fv == fval:
                used.add(k)
                return k
        raise KeyError((d, fval))

    # canonical assignment order (matches the symmetry-breaking rows):
    # temporal slots first (by slot index), then spatial axes in arch order.
    spa, tmp = {}, {}
    for i, (d, fv) in enumerate(mapping.temporal):
        tmp[take(d, fv)] = i
    for ax in arch.spatial:
        for d, fv in mapping.spatial.get(ax.name, ()):
            spa[take(d, fv)] = ax.name
    for k in range(len(form.ff)):
        for i in range(form.n_slots):
            pin(form.XL[k, i], 1.0 if tmp.get(k) == i else 0.0)
        for ax in arch.spatial:
            if (k, ax.name) in form.XU:
                pin(form.XU[k, ax.name], 1.0 if spa.get(k) == ax.name
                    else 0.0)
    for k, i in tmp.items():
        for lam in OPERANDS:
            lv = mapping.level_of[lam][i]
            for mm in form.levels:
                if (k, lam, mm) in form.XM:
                    pin(form.XM[k, lam, mm], 1.0 if mm == lv else 0.0)
    for k in spa:
        for lam in OPERANDS:
            for mm in form.levels:
                if (k, lam, mm) in form.XM:
                    pin(form.XM[k, lam, mm], 0.0)
    for (lam, mm), dm in form.psiDM.items():
        pin(dm, 1.0 if (lam, mm) in mapping.double_buf else 0.0)


def mip_latency_of(layer: wl.Layer, arch: CimArch, mapping: Mapping,
                   cfg: FormulationConfig | None = None,
                   m_lat: float | None = None) -> float:
    """MIP-internal latency of a pinned mapping (consistency testing)."""
    cfg = cfg or FormulationConfig()
    if m_lat is None:
        m_lat = 8 * evaluate(mapping, layer, arch).total_cycles
    form = MiredoFormulation(layer, arch, cfg)
    form.build(m_lat, m_lat)
    pin_mapping(form, mapping)
    sol = form.m.solve(time_limit_s=cfg.time_limit_s, mip_rel_gap=1e-6)
    if not sol.ok:
        return math.nan
    return sol[form.PMAX]


def native_incumbents(layer: wl.Layer, arch: CimArch,
                      cfg: FormulationConfig) -> list[tuple[float, Mapping]]:
    """Greedy + accurate-heuristic incumbent pool, best first on ties.

    A stronger incumbent is pure upside: it tightens the MIP's pruning UB
    and raises the floor of the time-capped fallback (~0.2s for 2000
    accurate-model samples vs solver budgets in the tens of seconds).
    Shared by the single solve and every portfolio member
    (`core/portfolio.py` computes the pool once per layer)."""
    from repro_torch.core.baselines import greedy_mapping, heuristic_search
    greedy = greedy_mapping(layer, arch)
    g_lat = evaluate(greedy, layer, arch).total_cycles
    seed_res = heuristic_search(layer, arch, budget=2000, seed=1,
                                accurate=True, k_min=cfg.k_min,
                                alpha=cfg.alpha)
    # ties prefer the earlier entry: search incumbent, then greedy, then
    # (appended by the caller) any neighbor warm start — the historical
    # fallback preference
    return [(seed_res.eval_latency, seed_res.mapping), (g_lat, greedy)]


def ladder_rungs(cfg: FormulationConfig) -> list[tuple[float, int]]:
    """The Flexible-Factorization coarsening ladder: (alpha, k_min) per
    rung, finest first. Rung indices are a portfolio-member dimension
    (`portfolio.PortfolioMember.rung`)."""
    return [
        (cfg.alpha, cfg.k_min),
        (max(cfg.alpha, 0.5), 2),
        (1.0, 1),
    ]


def _fallback_result(incumbents, layer, arch, status, t0, *,
                     incumbent_latency, form=None, sol=None) -> MiredoResult:
    """Best-incumbent result for budget-exhausted / solution-less solves."""
    fallback = min(incumbents, key=lambda lc: lc[0])[1]
    rep = evaluate(fallback, layer, arch)
    return MiredoResult(
        mapping=fallback, status=status, objective=math.nan,
        mip_latency=math.nan, eval_latency=rep.total_cycles,
        solve_seconds=time.monotonic() - t0,
        n_vars=form.m.n_vars if form is not None else 0,
        n_rows=form.m.n_rows if form is not None else 0,
        mip_gap=sol.mip_gap if sol is not None else math.nan,
        incumbent_latency=incumbent_latency,
        mip_node_count=sol.mip_node_count if sol is not None else math.nan,
        mip_dual_bound=sol.mip_dual_bound if sol is not None else math.nan)


def solve_ladder(layer: wl.Layer, arch: CimArch, cfg: FormulationConfig,
                 incumbents: Sequence[tuple[float, Mapping]], *,
                 t0: float, deadline: float,
                 incumbent_latency: float | None = None,
                 rung: int = 0, node_limit: int | None = None,
                 presolve: bool | None = None,
                 mip_rel_gap: float | None = None) -> MiredoResult:
    """One parameterized pass down the factorization ladder under a hard
    shared deadline.

    **Budget contract**: *every* rung — builds
    included — is charged against the single ``deadline`` anchored at
    ``t0``. A rung that starts after the deadline is skipped, and the solve
    of the rung that does run gets exactly the remaining wall clock, so the
    3-rung combo-overflow fallback can no longer spend
    ``time_limit_s + ~10 s`` (each rung used to re-floor its budget at
    ``max(min(5, limit), remaining)``), which broke
    `network.allocate_budgets`' sum-to-total contract. When the deadline
    expires before any solve lands, the best incumbent is returned
    (`Status.ERROR`, the solution-less status) — never ``None``.

    ``rung``/``node_limit``/``presolve``/``mip_rel_gap`` are the portfolio
    member knobs (`core/portfolio.py`); the defaults reproduce the single
    baseline solve. SUSPECT solves (numerical trouble with an assignment)
    are decoded but only trusted if `mapping.validate` passes — the
    validate/fallback path stays authoritative.
    """
    gap = cfg.mip_rel_gap if mip_rel_gap is None else mip_rel_gap
    ub = min(l for l, _ in incumbents)
    if incumbent_latency is None:
        incumbent_latency = ub
    m_lat = max(cfg.latency_slack, BIG_M_FLOOR) * ub
    rungs = ladder_rungs(cfg)
    rungs = rungs[min(rung, len(rungs) - 1):]
    last_exc: Exception | None = None
    out_of_time = False
    for alpha, k_min in rungs:
        if time.monotonic() >= deadline:
            out_of_time = True
            break
        c = dataclasses.replace(cfg, alpha=alpha, k_min=k_min)
        try:
            form = MiredoFormulation(layer, arch, c)
            form.build(m_lat, m_lat)
        except ComboOverflow as e:
            last_exc = e
            continue
        # prune with the incumbent (+0.1% float slack)
        form.m.add_le(LinExpr({form.PMAX.idx: 1.0}), ub * 1.001)
        budget = max(0.0, deadline - time.monotonic())
        sol = form.m.solve(time_limit_s=budget, mip_rel_gap=gap,
                           verbose=cfg.verbose, node_limit=node_limit,
                           presolve=presolve)
        dt = time.monotonic() - t0
        if not sol.usable:
            # UB mapping may not be representable at this factorization
            # granularity; fall back to the best incumbent.
            return _fallback_result(incumbents, layer, arch, sol.status, t0,
                                    incumbent_latency=incumbent_latency,
                                    form=form, sol=sol)
        mapping = form.decode(sol)
        errs = validate(mapping, layer, arch)
        if errs:
            if sol.status is Status.SUSPECT:
                # numerical trouble produced a genuinely infeasible
                # assignment: flagged, not fatal — keep the incumbent
                return _fallback_result(
                    incumbents, layer, arch, sol.status, t0,
                    incumbent_latency=incumbent_latency, form=form, sol=sol)
            raise AssertionError(
                f"MIP produced infeasible mapping for {layer.name}: {errs}")
        rep = evaluate(mapping, layer, arch)
        # never return something worse than the incumbent
        if rep.total_cycles > ub:
            fallback = min(incumbents, key=lambda lc: lc[0])[1]
            rep_f = evaluate(fallback, layer, arch)
            if rep_f.total_cycles < rep.total_cycles:
                mapping, rep = fallback, rep_f
        return MiredoResult(
            mapping=mapping, status=sol.status, objective=sol.objective,
            mip_latency=sol[form.PMAX], eval_latency=rep.total_cycles,
            solve_seconds=dt, n_vars=form.m.n_vars, n_rows=form.m.n_rows,
            mip_gap=sol.mip_gap, incumbent_latency=incumbent_latency,
            mip_node_count=sol.mip_node_count,
            mip_dual_bound=sol.mip_dual_bound)
    if out_of_time or last_exc is None:
        # deadline exhausted (possibly before the first build): the
        # incumbent is the answer the budget paid for
        return _fallback_result(incumbents, layer, arch, Status.ERROR, t0,
                                incumbent_latency=incumbent_latency)
    raise last_exc


def optimize_layer(layer: wl.Layer, arch: CimArch,
                   cfg: FormulationConfig | None = None,
                   warm_start: Mapping | None = None,
                   portfolio=None) -> MiredoResult:
    """End-to-end: factorize -> build MIP -> solve -> decode -> re-score.

    The incumbent of a cheap accurate-model search provides (a) a valid upper
    bound that prunes the branch-and-bound tree (PMAX <= UB) and (b) tight
    big-M constants (any mapping worse than UB is never optimal). On combo
    explosion the layer retries with progressively coarser Flexible
    Factorization — the paper's own complexity-control knob — with all
    rungs charged against ONE deadline of ``cfg.time_limit_s`` seconds from
    entry (see `solve_ladder`).

    ``warm_start`` optionally injects a mapping solved for a *neighboring*
    architecture (incremental DSE re-solves): it is re-validated against
    this arch, and — only when feasible here and strictly better than the
    search incumbents — tightens the pruning UB and joins the fallback
    pool. ``None`` leaves behavior exactly unchanged.

    ``portfolio`` (a `portfolio.Portfolio`) races K deterministic solver
    parameterizations inside the same ``cfg.time_limit_s`` budget, sharing
    the best-known upper bound, and returns the best member's result by
    ``(eval_latency, member_index)`` — see `core/portfolio.py`. ``None``
    (default) runs the single baseline parameterization.
    """
    cfg = cfg or FormulationConfig()
    if portfolio is not None:
        from repro_torch.core.portfolio import race
        return race(layer, arch, cfg, portfolio, warm_start=warm_start).result
    t0 = time.monotonic()
    deadline = t0 + cfg.time_limit_s
    incumbents = native_incumbents(layer, arch, cfg)
    native_ub = min(l for l, _ in incumbents)
    if warm_start is not None and not validate(warm_start, layer, arch):
        incumbents.append(
            (evaluate(warm_start, layer, arch).total_cycles, warm_start))
    return solve_ladder(layer, arch, cfg, incumbents, t0=t0,
                        deadline=deadline, incumbent_latency=native_ub)
