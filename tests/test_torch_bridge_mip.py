"""The bridge MIP over the H100 (`repro_torch.core.gpu_bridge.
select_matmul_blocks`): for ragged shapes, M = 1, random shapes and path
A's GEMMs at reduced width, the pick equals a brute-force minimum of the
same objective over the kernel's tile set, is a tile the kernel takes,
fits the shared-memory budget with its whole ring, and its estimate is the
model's time there. The reference's ``tpu_bridge.select_matmul_blocks``
is the formulation ported; its TPU candidates and constants are not the
port's, so the hold is the objective, and the reference's MIP is run at
the H100's rates on the shapes where its candidates are the port's pick
(m = n = 128), its traffic and tensor-core terms held to the port's."""

import math

import pytest

pytest.importorskip("torch")

from hypothesis import given, settings, strategies as st

from repro.core import tpu_bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.core import gpu_bridge as gb
from repro_torch.core.frontend import extract_workload
from repro_torch.kernels.matmul_int8 import kernel as mm_kernel

SHAPES_MKN = [(1, 4096, 4096), (1, 1, 1), (1, 128, 64), (128, 1, 64),
              (100, 200, 360), (130, 24, 1000), (8, 72, 100),
              (128, 4096, 27392), (128, 13696, 4096), (1, 4096, 151552),
              (33, 31, 65), (257, 129, 127)]


def _path_a_gemms():
    """Path A's GEMMs (glm4-9b decode_32k) at reduced width."""
    work = extract_workload(get_config("glm4-9b").reduced(),
                            SHAPES["decode_32k"])
    return sorted({(l.bound("N"), l.bound("C"), l.bound("K"))
                   for l in work.layers if l.is_gemm})


def _brute(m, k, n, budget):
    fits = [t for t in gb.tile_order(m, k, n)
            if mm_kernel.smem_bytes(*t) <= budget]
    return min(fits, key=lambda t: gb.matmul_objective(m, k, n, *t))


def _hold(m, k, n, budget=gb.SMEM_BYTES):
    c = gb.select_matmul_blocks(m, k, n, smem_bytes=budget)
    pick = (c.bm, c.bk, c.bn)
    assert c.status == "OPTIMAL", (m, k, n, c)
    assert pick == _brute(m, k, n, budget), (m, k, n, pick)
    # legal for the wrapper's check (kernel.py): in the tile set
    assert c.bm in mm_kernel.BM_TILES and c.bk in mm_kernel.BK_TILES and \
        c.bn in mm_kernel.BN_TILES
    assert c.smem_bytes == mm_kernel.smem_bytes(*pick) <= budget
    assert c.double_buffered
    assert c.est_seconds == pytest.approx(
        gb.matmul_seconds(m, k, n, c.bm, c.bn), rel=1e-7)
    best_t = min(gb.matmul_seconds(m, k, n, t[0], t[2])
                 for t in gb.tile_order(m, k, n)
                 if mm_kernel.smem_bytes(*t) <= budget)
    # the tie order moves the time by less than its whole weight
    unit = (m * k + k * n + 4 * m * n) / gb.HBM_BW
    assert c.est_seconds <= best_t + 36 * gb.TIE_WEIGHT * unit * (1 + 1e-9)
    return c


@pytest.mark.parametrize("m,k,n", SHAPES_MKN)
def test_pick_is_the_brute_force_minimum(m, k, n):
    _hold(m, k, n)


def test_path_a_gemms_at_reduced_width():
    gemms = _path_a_gemms()
    assert len(gemms) >= 4
    for m, k, n in gemms:
        _hold(m, k, n)


@pytest.mark.parametrize("budget", [3 * (16 * 32 + 32 * 32),
                                    3 * (64 * 64 + 64 * 64), 40_000])
def test_capacity_binds_under_a_small_budget(budget):
    """eq. 9 at budgets below the set's largest ring: every pick fits."""
    for m, k, n in ((128, 4096, 4096), (1, 4096, 151552), (100, 200, 360)):
        c = _hold(m, k, n, budget)
        assert c.smem_bytes <= budget


@given(st.integers(1, 6000), st.integers(1, 6000), st.integers(1, 6000))
@settings(max_examples=15, deadline=None)
def test_random_shapes(m, k, n):
    _hold(m, k, n)


def test_infeasible_budget_falls_back_to_a_legal_tile():
    c = gb.select_matmul_blocks(64, 64, 64, smem_bytes=100)
    assert c.status == "fallback" and math.isnan(c.est_seconds)
    assert (c.bm, c.bk, c.bn) == (min(mm_kernel.BM_TILES),
                                  min(mm_kernel.BK_TILES),
                                  min(mm_kernel.BN_TILES))


@pytest.mark.parametrize("k", [128, 384, 4096, 13696, 151552])
def test_traffic_is_the_reference_weight_reload_model(monkeypatch, k):
    """The reference's own MIP (`tpu_bridge.select_matmul_blocks`) at the
    H100's rates, on m = n = 128, where its candidate sets reduce to
    bm = bn = 128: its time is the port's traffic over ``HBM_BW`` and
    2mnk over ``PEAK_INT8_OPS``, combined by the Table III row it reports,
    and the port picks the same bm and bn at the overlapped row's time.

    The reference's rates are patched in per microsecond: its solver's
    tolerances are absolute, and with times in seconds it returns T = 0
    for these problems. It reports the single-buffered row here although
    the overlapped one fits (ROADMAP Queue C); the port fixes the row to
    the overlapped one, so the hold takes the row from the reference's
    answer rather than assuming it."""
    per_us = 1e-6
    monkeypatch.setattr(tpu_bridge, "HBM_BW", gb.HBM_BW * per_us)
    monkeypatch.setattr(tpu_bridge, "MXU_FLOPS", gb.PEAK_INT8_OPS * per_us)
    m = n = 128
    ref = tpu_bridge.select_matmul_blocks(m, k, n)
    assert ref.status == "OPTIMAL" and (ref.bm, ref.bn) == (128, 128)
    t_mem = gb.matmul_traffic(m, k, n, ref.bm, ref.bn) / gb.HBM_BW
    t_tc = 2.0 * m * n * k / gb.PEAK_INT8_OPS
    row = max(t_mem, t_tc) if ref.double_buffered else t_mem + t_tc
    assert ref.est_seconds * per_us == pytest.approx(row, rel=1e-9)
    c = _hold(m, k, n)
    assert (c.bm, c.bn) == (ref.bm, ref.bn)
    assert c.est_seconds == pytest.approx(max(t_mem, t_tc), rel=1e-12)


def test_traffic_over_the_tile_set():
    """`matmul_traffic` at every (bm, bn) of the set: x re-read once per
    column of tiles, w once per row, the 4-byte output written once (the
    reference's expression at int8 inputs)."""
    for m, k, n in SHAPES_MKN:
        for bm in mm_kernel.BM_TILES:
            for bn in mm_kernel.BN_TILES:
                want = m * n * 4 + (m * k) * math.ceil(n / bn) + \
                    (k * n) * math.ceil(m / bm)
                assert gb.matmul_traffic(m, k, n, bm, bn) == want
