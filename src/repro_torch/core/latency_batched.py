"""Batched analytical model: score N mappings of one (layer, arch) per
dispatch (DESIGN.md §Batched analytical model).

``latency.evaluate`` / ``energy.evaluate_edp`` are scalar Python called once
per candidate, which makes every optimization pass — stochastic search, DSE
screening, the MIP warm-start incumbents — evaluation-bound. This module
packs a whole candidate pool into fixed-shape arrays and replays the exact
same arithmetic vectorized over the batch:

  * the Table III recursion runs as a loop over the (right-aligned,
    identity-padded) slot axis with the three per-operand rows unrolled in
    ``OPERANDS`` order,
  * one-time fills, energy traffic, the idealized perfect-overlap bound and
    the eq. (9) capacity feasibility are left-folds over padded hop/level
    axes in the scalar evaluation order.

The scalar model remains the oracle: packing reads the *shared* slot
analysis (`latency.operand_transfer_table` via ``analyze_slots`` /
``operand_fill_hops``, `energy.operand_energy_hops`,
`latency.idealized_terms`, `mapping.capacity_usage`), every float op is
replayed in the scalar order under float64,
and padding is provably inert (an identity slot — n=1, no transfers — maps
the P vector through unchanged; padded hops add ``+ 0.0``). Total cycles,
energy and EDP are therefore *bit-equal* to the scalar oracle, which the
differential sweep in ``tests/test_latency_batched.py`` enforces.

``feasible`` covers the eq. (9) capacity clause only — the one clause a
sampler-constructed candidate (`baselines.sample_mapping_raw`) can violate;
structural legality (factor products, spatial axis membership, monotone
level assignment, C^M) holds for such candidates by construction. For
arbitrary mappings run ``mapping.validate`` instead.

Two backends evaluate the identical IEEE-754 operation sequence and return
bit-identical arrays: the NumPy loop, and ``backend="torch"``, the same
recursion and folds on float64 tensors on a device (the counterpart of the
reference's jitted backend). Both run the shared `_recursion_step` /
`_aggregate` code; the torch one through `_TorchOps`, an array namespace
that keeps every op eager and unfused, so each product and sum rounds once
as in the scalar model.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import workload as wl
from repro_torch.core.arch import CimArch, OPERANDS
from repro_torch.core.energy import operand_energy_hops
from repro_torch.core.latency import (analyze_slots, idealized_terms,
                                operand_fill_hops, operand_transfer_table)
from repro_torch.core.mapping import Mapping, capacity_usage, size_context

#: Everything the packer can materialize; trim to skip host-side analysis
#: work the consumer does not need (e.g. the idealized-model heuristic pass
#: needs no latency/energy packing).
ALL_NEEDS = ("latency", "energy", "ideal", "feasible")


@dataclasses.dataclass
class PackedBatch:
    """N mappings of one (layer, arch) as fixed-shape float64 arrays.

    Slot arrays are right-aligned: real slots occupy the *trailing*
    positions so the reverse (innermost-first) recursion processes them
    first and the leading identity padding (n=1, t=0) afterwards — which
    leaves the P vector untouched. Hop/term axes pad with zeros at the end.
    """

    mappings: list[Mapping]
    layer: wl.Layer
    arch: CimArch
    need: tuple[str, ...]
    nf: np.ndarray          # (B,S) slot factors, pad 1.0
    t: np.ndarray           # (B,S,3) T_{i,λ} cycles, pad 0.0
    dbl: np.ndarray         # (B,S,3) psi^DL, pad False
    fill_c: np.ndarray      # (B,L,3) untriggered one-time fill cycles
    e_term: np.ndarray      # (B,L,3) per-hop traffic pJ (bytes x pJ/byte,
                            # multiplied at pack time: a fused multiply-add
                            # inside a device fold would round differently
                            # than the scalar oracle's separate mul-then-add)
    ideal_num: np.ndarray   # (B,3L) idealized iters*chunk, pad 0.0
    ideal_bw: np.ndarray    # (B,3L) idealized eff bandwidth, pad 1.0
    compute: np.ndarray     # (B,) temporal_iters * l_mvm
    sizes: np.ndarray       # (B,Lc,3) (1+psi^DM)*stored bytes, pad 0.0
    caps: np.ndarray        # (B,Lc) effective capacity bytes
    shared: np.ndarray      # (Lc,) level-shared flags (arch constant)
    gated: bool = False     # infeasible rows hold padding; scores -> inf

    @property
    def batch(self) -> int:
        return len(self.mappings)


@dataclasses.dataclass
class BatchScores:
    """Per-mapping scores; fields are ``None`` when not packed (``need``)."""

    cycles: np.ndarray | None       # latency.evaluate total_cycles
    energy_pj: np.ndarray | None    # energy.evaluate_energy total_pj
    edp: np.ndarray | None          # evaluate_edp edp
    idealized: np.ndarray | None    # latency.idealized_cycles
    feasible: np.ndarray | None     # eq. (9) capacity clause (bool)


def _slot_width(n: int) -> int:
    """Bucket the slot axis to multiples of 4 so the jitted evaluator sees
    a handful of shapes across a run instead of one per pool."""
    return max(4, -(-n // 4) * 4)


def pack(mappings: Sequence[Mapping], layer: wl.Layer, arch: CimArch, *,
         need: Sequence[str] = ALL_NEEDS) -> PackedBatch:
    """Pack mappings into fixed-shape arrays via the shared slot analysis.

    When ``need`` includes "feasible", packing is *gated*: rows whose
    eq. (9) capacity check fails (the same comparison the evaluator
    replays) skip the latency/energy/idealized analysis entirely — the
    dominant cost on sampled pools, where most candidates are infeasible —
    and their scores come back as ``inf``. Feasible rows stay bit-equal to
    the scalar oracle. Omit "feasible" from ``need`` to force full packing
    of every row."""
    mappings = list(mappings)
    B, L = len(mappings), arch.n_levels
    S = _slot_width(max((mp.n_slots() for mp in mappings), default=1))
    K = 3 * L
    need = tuple(need)

    bounded = [m for m in range(L)
               if arch.level(m).capacity_bytes is not None]
    Lc = len(bounded)
    shared = np.array([arch.level(m).shared for m in bounded], dtype=bool)

    w_lat = "latency" in need
    w_en = "energy" in need
    w_id = "ideal" in need
    w_fe = "feasible" in need
    pad3 = [0.0, 0.0, 0.0]
    lam0, lam1, lam2 = OPERANDS
    shared_flag = [arch.level(m).shared for m in bounded]
    nf_l, t_l, dbl_l = [], [], []
    fill_l, e_l, num_l, bw_l, comp_l = [], [], [], [], []
    sz_l, cap_l = [], []
    packed_idx = []     # rows with analysis data (all rows when ungated)

    for b, mp in enumerate(mappings):
        # one memoized size table per mapping, shared by every analysis pass
        ctx = size_context(mp, layer, arch)
        row_ok = True
        if w_fe:
            usage = capacity_usage(mp, layer, arch, ctx)
            cap_row, sz_row = [], []
            for k, (_m, cap, sz) in enumerate(usage):
                s0 = sz.get(lam0, 0.0)
                s1 = sz.get(lam1, 0.0)
                s2 = sz.get(lam2, 0.0)
                cap_row.append(cap)
                sz_row.append([s0, s1, s2])
                # replay the evaluator's exact comparison (same floats,
                # same fold order) so gating can never disagree with the
                # `feasible` output
                if row_ok:
                    tol = cap + 1e-9
                    if shared_flag[k]:
                        row_ok = (s0 + s1) + s2 <= tol
                    else:
                        row_ok = s0 <= tol and s1 <= tol and s2 <= tol
            cap_l.append(cap_row)
            sz_l.append(sz_row)
            if not row_ok:
                # gated: the row keeps its identity/zero padding (supplied
                # by the preallocated arrays below) and scores inf on read
                continue
        packed_idx.append(b)
        if w_lat:
            tables = {lam: operand_transfer_table(mp, layer, arch, lam, ctx)
                      for lam in OPERANDS}
            slots = analyze_slots(mp, layer, arch, tables)
            off = S - len(slots)
            nf_l.append([1.0] * off + [float(s.n) for s in slots])
            t_l.append([pad3] * off
                       + [[s.transfer[lam] for lam in OPERANDS]
                          for s in slots])
            dbl_l.append([[False] * 3] * off
                         + [[s.double[lam] for lam in OPERANDS]
                            for s in slots])
            row = [[0.0] * 3 for _ in range(L)]
            for j, lam in enumerate(OPERANDS):
                h = 0
                for trig, cyc in operand_fill_hops(mp, layer, arch, lam,
                                                   tables[lam]):
                    if not trig:
                        row[h][j] = cyc
                        h += 1
            fill_l.append(row)
        if w_en:
            row = [[0.0] * 3 for _ in range(L)]
            for j, lam in enumerate(OPERANDS):
                for h, (tb, e) in enumerate(
                        operand_energy_hops(mp, layer, arch, lam, ctx)):
                    row[h][j] = tb * e
            e_l.append(row)
        if w_id:
            comp, terms = idealized_terms(mp, layer, arch, ctx)
            comp_l.append(float(comp))
            num_l.append([n for n, _ in terms] + [0.0] * (K - len(terms)))
            bw_l.append([w for _, w in terms] + [1.0] * (K - len(terms)))

    # preallocate identity padding; scatter the packed rows into place
    idx = np.array(packed_idx, dtype=np.intp)
    nf = np.ones((B, S))
    t = np.zeros((B, S, 3))
    dbl = np.zeros((B, S, 3), dtype=bool)
    fill_c = np.zeros((B, L, 3))
    e_term = np.zeros((B, L, 3))
    ideal_num = np.zeros((B, K))
    ideal_bw = np.ones((B, K))
    compute = np.zeros(B)
    sizes = np.zeros((B, Lc, 3))
    caps = np.full((B, Lc), np.inf)
    if len(idx):
        if w_lat:
            nf[idx] = nf_l
            t[idx] = t_l
            dbl[idx] = dbl_l
            fill_c[idx] = fill_l
        if w_en:
            e_term[idx] = e_l
        if w_id:
            ideal_num[idx] = num_l
            ideal_bw[idx] = bw_l
            compute[idx] = comp_l
    if w_fe and B:
        sizes[:] = np.array(sz_l).reshape(B, Lc, 3)
        caps[:] = np.array(cap_l).reshape(B, Lc)

    return PackedBatch(mappings=mappings, layer=layer, arch=arch, need=need,
                       nf=nf, t=t, dbl=dbl, fill_c=fill_c, e_term=e_term,
                       ideal_num=ideal_num, ideal_bw=ideal_bw,
                       compute=compute, sizes=sizes, caps=caps,
                       shared=shared, gated=bool(w_fe))


# ---------------------------------------------------------------------------
# Evaluation backends — identical IEEE-754 op sequences
# ---------------------------------------------------------------------------

#: Operand classes of the Table III rows, in OPERANDS order: I and W share
#: the single/double-buffered rows; O has its own pair.
_IS_IW = (True, True, False)


def _recursion_step(xp, carry, nf_i, t_i, dbl_i):
    """One slot of the Table III recursion, operands unrolled in scalar
    order. ``xp`` is ``numpy`` or `_TorchOps`; shapes (B,) / (B,3)."""
    l_next, n_next, p_next = carry
    combined = xp.zeros_like(l_next)
    for j in range(3):
        tj, pj, dj = t_i[:, j], p_next[:, j], dbl_i[:, j]
        br = xp.where(tj == 0.0, pj,
                      xp.where(dj, xp.maximum(tj, pj), tj + pj))
        combined = xp.maximum(combined, br)
    l_i = xp.maximum(l_next * n_next, combined)
    ps = []
    for j, iw in enumerate(_IS_IW):
        tj, pj, dj = t_i[:, j], p_next[:, j], dbl_i[:, j]
        no_t = l_i * xp.maximum(nf_i - 1.0, 0.0) + pj
        if iw:
            single = l_i * xp.maximum(nf_i - 2.0, 0.0) + 2.0 * tj + pj
            double = xp.maximum(
                l_i * xp.maximum(nf_i - 3.0, 0.0) + 2.0 * tj
                + xp.maximum(tj, pj), tj * nf_i)
        else:
            single = l_i * xp.maximum(nf_i - 1.0, 0.0) + 2.0 * tj + pj
            double = l_i * xp.maximum(nf_i - 2.0, 0.0) + tj \
                + xp.maximum(tj, l_i) + xp.maximum(tj, pj)
        ps.append(xp.where(tj == 0.0, no_t, xp.where(dj, double, single)))
    return l_i, nf_i, xp.stack(ps, axis=1)


def _aggregate(xp, p_final, fill_c, e_term, ideal_num, ideal_bw,
               compute, sizes, caps, shared, mac_pj):
    """Post-recursion left-folds, all in the scalar evaluation order."""
    p_max = xp.maximum(xp.maximum(p_final[:, 0], p_final[:, 1]),
                       p_final[:, 2])
    one_time = xp.zeros_like(p_max)
    for j in range(3):
        s = xp.zeros_like(p_max)
        for h in range(fill_c.shape[1]):
            s = s + fill_c[:, h, j]
        one_time = one_time + s
    cycles = p_max + one_time

    traffic = xp.zeros_like(p_max)
    for j in range(3):
        s = xp.zeros_like(p_max)
        for h in range(e_term.shape[1]):
            s = s + e_term[:, h, j]
        traffic = traffic + s
    energy = traffic + mac_pj
    edp = energy * cycles

    ideal = compute
    for k in range(ideal_num.shape[1]):
        ideal = xp.maximum(ideal, ideal_num[:, k] / ideal_bw[:, k])

    tol = caps + 1e-9
    ssum = xp.zeros_like(caps)
    ok_each = xp.ones(caps.shape, dtype=bool)
    for j in range(3):
        ssum = ssum + sizes[:, :, j]
        ok_each = ok_each & (sizes[:, :, j] <= tol)
    ok = xp.where(shared[None, :], ssum <= tol, ok_each)
    feasible = xp.all(ok, axis=1)
    return cycles, energy, edp, ideal, feasible


def _eval_numpy(pb: PackedBatch) -> tuple:
    """Reference backend: the scalar op sequence, vectorized over B."""
    B = pb.batch
    l_mvm = float(pb.arch.l_mvm_cycles)
    carry = (np.full(B, l_mvm), np.ones(B), np.full((B, 3), l_mvm))
    for i in range(pb.nf.shape[1] - 1, -1, -1):
        carry = _recursion_step(np, carry, pb.nf[:, i], pb.t[:, i, :],
                                pb.dbl[:, i, :])
    mac_pj = pb.layer.macs * pb.arch.mac_energy_pj
    return _aggregate(np, carry[2], pb.fill_c, pb.e_term,
                      pb.ideal_num, pb.ideal_bw, pb.compute, pb.sizes,
                      pb.caps, pb.shared, mac_pj)


#: The batched backends. ``None`` is the NumPy loop.
BACKENDS = ("numpy", "torch")


class _TorchOps:
    """The array namespace `_recursion_step` and `_aggregate` are written
    against, over float64 tensors on ``device``. Every call is one eager
    PyTorch op, so a product and the sum after it round twice, as in the
    scalar model: no fused multiply-add, no compiled graph. NumPy's
    ``maximum(x, 0.0)`` becomes ``clamp_min(0.0)``, which rounds alike
    (``torch.maximum`` takes no Python scalar), and the folds stay the
    explicit left folds of `_aggregate`, never a tree-ordered ``sum``."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device

    def zeros_like(self, x):
        return self.torch.zeros_like(x)

    def ones(self, shape, dtype):
        dtype = self.torch.bool if dtype is bool else dtype
        return self.torch.ones(shape, dtype=dtype, device=self.device)

    def where(self, cond, a, b):
        return self.torch.where(cond, a, b)

    def maximum(self, a, b):
        if isinstance(b, float):
            return a.clamp_min(b)
        return self.torch.maximum(a, b)

    def stack(self, xs, axis):
        return self.torch.stack(xs, dim=axis)

    def all(self, x, axis):
        return x.all(dim=axis)


def _check_backend(backend: str | None, device) -> None:
    """Refuse an unknown backend, and a card that is not there, before any
    packing or evaluation is done."""
    if backend == "jax":
        raise ValueError('the port has no "jax" backend: use "torch" '
                         '(float64 on a device) or "numpy"')
    if backend not in (None,) + BACKENDS:
        raise ValueError(f"batched backend {backend!r} is not one of "
                         f"{BACKENDS}")
    if backend == "torch":
        import torch
        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError(f"backend 'torch' on {device!r}: no CUDA "
                               f"device (pass device='cpu' to score on the "
                               f"host)")


def _eval_torch(pb: PackedBatch, device) -> tuple:
    """The NumPy backend's op sequence on float64 tensors on ``device``;
    returns host arrays."""
    import torch
    dev = torch.device(device)
    xp = _TorchOps(torch, dev)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    B = pb.batch
    l_mvm = float(pb.arch.l_mvm_cycles)
    f64 = dict(dtype=torch.float64, device=dev)
    carry = (torch.full((B,), l_mvm, **f64), torch.ones(B, **f64),
             torch.full((B, 3), l_mvm, **f64))
    nf, t, dbl = put(pb.nf), put(pb.t), put(pb.dbl)
    for i in range(pb.nf.shape[1] - 1, -1, -1):
        carry = _recursion_step(xp, carry, nf[:, i], t[:, i, :],
                                dbl[:, i, :])
    mac_pj = pb.layer.macs * pb.arch.mac_energy_pj
    out = _aggregate(xp, carry[2], put(pb.fill_c), put(pb.e_term),
                     put(pb.ideal_num), put(pb.ideal_bw), put(pb.compute),
                     put(pb.sizes), put(pb.caps), put(pb.shared), mac_pj)
    return tuple(x.cpu().numpy() for x in out)


def evaluate_batch(pb: PackedBatch, backend: str | None = None, *,
                   device="cuda") -> BatchScores:
    """Evaluate a packed batch. ``backend``: "numpy", "torch" (float64 on
    ``device``) or None, the NumPy loop. Both return bit-identical arrays.

    None never picks the device by itself, as the reference's auto choice
    picks jax by what is importable: the optimizer is host code, and a
    device chosen by what the machine happens to have would be a hidden
    fallback. The caller asks for ``"torch"`` and names the device; on
    ``"cuda"`` without a card that raises before any work."""
    _check_backend(backend, device)
    if backend == "torch":
        cyc, en, edp, ideal, feas = _eval_torch(pb, device)
    else:
        cyc, en, edp, ideal, feas = _eval_numpy(pb)
    if pb.gated:
        # gated packs hold identity padding in infeasible rows
        bad = ~np.asarray(feas)
        cyc, en, edp, ideal = (np.where(bad, np.inf, np.asarray(x))
                               for x in (cyc, en, edp, ideal))
    has = pb.need
    return BatchScores(
        cycles=cyc if "latency" in has else None,
        energy_pj=en if "energy" in has else None,
        edp=edp if ("latency" in has and "energy" in has) else None,
        idealized=ideal if "ideal" in has else None,
        feasible=np.asarray(feas) if "feasible" in has else None)


def score_mappings(mappings: Sequence[Mapping], layer: wl.Layer,
                   arch: CimArch, *, need: Sequence[str] = ALL_NEEDS,
                   backend: str | None = None,
                   device="cuda") -> BatchScores:
    """Pack + evaluate in one call — the enumerate-then-score entry point
    used by `baselines.heuristic_search`, `dse.screen_arch` and the MIP
    warm-start incumbent pools. ``backend`` and ``device`` as in
    `evaluate_batch`; both are checked before the pool is packed."""
    _check_backend(backend, device)
    if not mappings:
        z = np.zeros(0)
        return BatchScores(cycles=z, energy_pj=z, edp=z, idealized=z,
                           feasible=np.zeros(0, dtype=bool))
    return evaluate_batch(pack(mappings, layer, arch, need=need),
                          backend=backend, device=device)
