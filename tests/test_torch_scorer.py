"""The batched scorer's torch backend (`repro_torch.core.latency_batched`,
``backend="torch"``) on the CPU: bit-equal to the port's NumPy loop and to
the reference's ``evaluate_batch`` on its ``jax`` backend where that
imports, else on its NumPy backend, which its own tests hold bit-equal to
the ``jax`` one (jax 0.9 has no ``jax.experimental.enable_x64``, so the
reference's ``HAVE_JAX`` is false here and its jax backend cannot run).
The sweeps are those of the reference's own batched-scorer tests
(gated and ungated packs, mixed slot counts, empty and singleton pools);
cycles ``==`` the reference's scalar
oracle and the energy's ulp gap no larger than the NumPy loop's own;
`heuristic_search(backend="torch", device="cpu")` against the reference's
winner; and the backend's refusals.

The batched energy is not held bit-equal to the scalar oracle: it is 1 ulp
off in the reference itself (ROADMAP Queue C, item 1), so the gap is
reported against the NumPy loop's, never assumed zero."""

import math
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings, strategies as st

from repro.core import arch as rarch
from repro.core import baselines as rbaselines
from repro.core import latency_batched as rlb
from repro.core import workload as rwl
from repro.core.energy import evaluate_edp as revaluate_edp
from repro.core.latency import evaluate as revaluate
from repro_torch.core import arch, baselines
from repro_torch.core import latency_batched as lb
from repro_torch.core import workload as wl
from repro_torch.core.factorization import factorize_layer_dims

#: The reference backend the port is held against (see the docstring).
RBACKEND = "jax" if rlb.HAVE_JAX else "numpy"
FIELDS = ("cycles", "energy_pj", "edp", "idealized", "feasible")
#: The reference tests' arch grid (core count, macro geometry, buffer
#: capacities, the double-buffering policy), on both sides.
ARCH_KW = (dict(),
           dict(n_cores=2, macro_rows=64, macro_cols=16, gbuf_kb=2.0,
                lbuf_kb=8.0, name="lb-tiny"),
           dict(double_buffered=False, name="lb-single-buf"),
           dict(n_cores=4, macro_rows=256, macro_cols=64, lbuf_kb=16.0,
                reg_bytes=512, name="lb-wide"))
DIM_CHOICES = (3, 8, 24, 100, 128, 360)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _layer(mod, kind, a, b, c):
    if kind == 0:
        return mod.gemm("lb.gemm", a, b, c)
    return mod.conv("lb.conv", 1, a, c, min(b, 28), min(b, 28), 3, 3)


def _pools(kind, a, b, c, ai, n, seed):
    """The same pool on both sides: greedy plus raw samples (mixed slot
    counts, mostly capacity-infeasible), drawn from one seed each."""
    out = []
    for mod, amod, bmod in ((wl, arch, baselines),
                            (rwl, rarch, rbaselines)):
        layer = _layer(mod, kind, a, b, c)
        ar = amod.default_arch(**ARCH_KW[ai])
        rng = random.Random(seed)
        factors = factorize_layer_dims({d: layer.bound(d) for d in wl.DIMS})
        pool = [bmod.greedy_mapping(layer, ar)] + [
            bmod.sample_mapping_raw(layer, ar, rng, factors)
            for _ in range(n)]
        out.append((layer, ar, pool))
    return out


def _equal(a, b, where):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, (where, f)
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y), (where, f)


def _ulps(a: float, b: float) -> int:
    return abs(int(np.float64(a).view(np.int64)) -
               int(np.float64(b).view(np.int64)))


def _hold(kind, a, b, c, ai, n, seed, needs=(lb.ALL_NEEDS,
                                            ("latency", "energy", "ideal"))):
    (layer, ar, pool), (rlayer, rar, rpool) = _pools(kind, a, b, c, ai, n,
                                                     seed)
    for need in needs:
        ours = lb.score_mappings(pool, layer, ar, need=need,
                                 backend="torch", device="cpu")
        host = lb.score_mappings(pool, layer, ar, need=need, backend="numpy")
        ref = rlb.score_mappings(rpool, rlayer, rar, need=need,
                                 backend=RBACKEND)
        _equal(ours, host, ("numpy", need))
        _equal(ours, ref, (RBACKEND, need))
        for i, mp in enumerate(rpool):
            if not math.isfinite(float(ours.cycles[i])):
                continue
            scalar = revaluate_edp(mp, rlayer, rar)
            assert float(ours.cycles[i]) == \
                revaluate(mp, rlayer, rar).total_cycles, i
            assert float(ours.cycles[i]) == scalar.latency.total_cycles, i
            assert _ulps(ours.energy_pj[i], scalar.energy.total_pj) <= \
                _ulps(host.energy_pj[i], scalar.energy.total_pj), i
    return ours


@given(st.integers(0, 1), st.sampled_from(DIM_CHOICES),
       st.sampled_from(DIM_CHOICES), st.sampled_from(DIM_CHOICES),
       st.integers(0, len(ARCH_KW) - 1), st.integers(0, 10_000))
@settings(max_examples=8, deadline=None)
def test_differential_sweep_bit_equal(kind, a, b, c, ai, seed):
    _hold(kind, a, b, c, ai, 24, seed)


def test_mixed_slot_counts_padding_inert():
    """A mapping scores the same alone as in a pool of other slot counts,
    on the torch backend too."""
    (layer, ar, pool), _ = _pools(0, 32, 512, 512, 0, 40, 3)
    assert len({mp.n_slots() for mp in pool}) > 1
    together = lb.score_mappings(pool, layer, ar, backend="torch",
                                 device="cpu")
    for i in (0, len(pool) // 2, len(pool) - 1):
        alone = lb.score_mappings([pool[i]], layer, ar, backend="torch",
                                  device="cpu")
        for f in FIELDS:
            t, s = getattr(together, f)[i], getattr(alone, f)[0]
            assert t == s or (math.isinf(t) and math.isinf(s)), (i, f)
    _hold(0, 32, 512, 512, 0, 40, 3)


def test_ungated_pack_scores_infeasible_rows():
    """An ungated pack runs the recursion on every row, the capacity-
    infeasible ones included: cycles equal the scalar oracle's."""
    ours = _hold(0, 32, 512, 512, 1, 30, 5,
                 needs=(("latency", "energy"),))
    assert np.isfinite(ours.cycles).all()


def test_empty_and_singleton_pools():
    (layer, ar, pool), (rlayer, rar, rpool) = _pools(0, 8, 64, 64, 0, 0, 0)
    empty = lb.score_mappings([], layer, ar, backend="torch", device="cpu")
    assert len(empty.cycles) == 0 and len(empty.feasible) == 0
    one = lb.score_mappings(pool, layer, ar, backend="torch", device="cpu")
    assert bool(one.feasible[0])
    assert float(one.cycles[0]) == \
        revaluate_edp(rpool[0], rlayer, rar).latency.total_cycles
    _equal(one, rlb.score_mappings(rpool, rlayer, rar, backend=RBACKEND),
           "singleton")


@pytest.mark.parametrize("accurate", [False, True])
def test_heuristic_search_winner_matches_reference(accurate):
    layer = wl.gemm("lb.hs", 32, 512, 512)
    rlayer = rwl.gemm("lb.hs", 32, 512, 512)
    ar, rar = arch.default_arch(), rarch.default_arch()
    ours = baselines.heuristic_search(layer, ar, budget=400, seed=2,
                                      accurate=accurate, backend="torch",
                                      device="cpu")
    ref = rbaselines.heuristic_search(rlayer, rar, budget=400, seed=2,
                                      accurate=accurate, backend=RBACKEND)
    assert ours.n_feasible == ref.n_feasible > 0
    assert ours.chosen_by_cost == ref.chosen_by_cost
    assert ours.eval_latency == ref.eval_latency
    assert ours.mapping.temporal == ref.mapping.temporal
    assert dict(ours.mapping.level_of) == dict(ref.mapping.level_of)


@pytest.mark.parametrize("accurate", [False, True])
def test_pick_winner_from_the_gated_pack_is_the_search(accurate):
    """`baselines.pick_winner` over the torch backend's scores of the gated
    pack (every field, as `chip_smoke.py` path L scores it) chooses what
    `heuristic_search` chooses from its own narrower pack."""
    layer, ar = wl.gemm("lb.hs", 32, 512, 512), arch.default_arch()
    pool = baselines.candidate_pool(layer, ar, budget=400, seed=2)
    sc = lb.evaluate_batch(lb.pack(pool, layer, ar), backend="torch",
                           device="cpu")
    got = baselines.pick_winner(pool, sc, layer, ar, accurate=accurate)
    want = baselines.heuristic_search(layer, ar, budget=400, seed=2,
                                      accurate=accurate)
    assert got.n_feasible == want.n_feasible > 0
    assert got == want


def test_backend_refusals():
    (layer, ar, pool), _ = _pools(0, 8, 64, 64, 0, 3, 0)
    with pytest.raises(ValueError, match="torch"):
        lb.score_mappings(pool, layer, ar, backend="jax")
    with pytest.raises(ValueError, match="torch"):
        lb.evaluate_batch(lb.pack(pool, layer, ar), backend="jax")
    with pytest.raises(ValueError):
        lb.score_mappings(pool, layer, ar, backend="cupy")
    if not torch.cuda.is_available():
        calls = []
        real = lb.pack
        lb.pack = lambda *a, **k: calls.append(1) or real(*a, **k)
        try:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                lb.score_mappings(pool, layer, ar, backend="torch")
            with pytest.raises(RuntimeError, match="no CUDA device"):
                baselines.heuristic_search(layer, ar, budget=10,
                                           backend="torch")
        finally:
            lb.pack = real
        assert not calls, "packed before refusing"
    # the default stays the host loop, whatever the machine has
    assert lb.score_mappings(pool, layer, ar).cycles.dtype == np.float64
