"""The flash_attention prefill kernel's design on the CPU: the arithmetic
its tensor-core fragments do, emulated in plain PyTorch against the f32
oracle; the shared-memory layout `kernel.smem_bytes` states against the
CUDA source; and the bridge's occupancy-aware prefill pick. The kernel
itself runs only on the card (`tests/test_torch_cuda.py`, marked gpu).
Inputs are made with numpy from a seed."""

import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.gpu_bridge import (PREFILL_MAX_BK, SMEM_BYTES, SMS,
                                         select_flash_blocks)
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

PREFILL_TILES = [(bq, bk) for bq in fa_kernel.BQ_TILES if bq > 1
                 for bk in fa_kernel.BK_TILES]


# ---------------------------------------------------------------------------
# the kernel's roundings, emulated
# ---------------------------------------------------------------------------

def _bits(x):
    return x.contiguous().view(torch.int32)


def _tf32(x):
    """Round to TF32, to nearest with ties away from zero, as the kernel's
    ``tf32()`` (cvt.rna.tf32.f32)."""
    return ((_bits(x) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_cut(x):
    """The top 10 mantissa bits: the kernel's ``split_tf32`` hi part, and
    what a TF32 MMA reads of an operand that is not rounded (its lo)."""
    return (_bits(x) & ~0x1FFF).view(torch.float32)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _scores(a, b):
    return torch.einsum("bqhd,bkhd->bhqk", a, b)


def _emulate(q, k, v, causal, mode):
    """The prefill kernel's arithmetic on float32 tensors holding the
    operands' values, in f32 sums; ``mode`` names the design:
    ``tf32x3`` the float32 kernel (3xTF32 q.K^T, one TF32 pass for P.V),
    ``tf32`` single-pass TF32 for both, ``bf16_hilo`` the bfloat16 kernel
    (exact q.K^T, p = bf16 hi + bf16 lo against V), ``bf16_p`` the
    textbook bf16 design (p rounded to bf16)."""
    if mode == "tf32x3":
        qh, kh = _tf32_cut(q), _tf32_cut(k)
        ql, kl = _tf32_cut(q - qh), _tf32_cut(k - kh)
        s = _scores(ql, kh) + _scores(qh, kl) + _scores(qh, kh)
    elif mode == "tf32":
        s = _scores(_tf32(q), _tf32(k))
    else:
        s = _scores(q, k)
    s = s / math.sqrt(q.shape[-1])
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        keep = torch.arange(lk)[None, :] <= torch.arange(lq)[:, None]
        s = torch.where(keep[None, None], s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    if mode in ("tf32x3", "tf32"):
        p, v = _tf32(p), _tf32(v)
    elif mode == "bf16_hilo":
        hi = _bf16(p)
        p = hi + _bf16(p - hi)
    elif mode == "bf16_p":
        p = _bf16(p)
    return torch.einsum("bhqk,bkhd->bqhd", p / l, v)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _inputs(seed, lq, lk, h, hd, q_scale=1.0):
    rng = np.random.default_rng(seed)
    mk = lambda l: torch.from_numpy(
        rng.standard_normal((1, l, h, hd)).astype(np.float32))
    return mk(lq) * q_scale, mk(lk), mk(lk)


SHAPES = [(256, 256, 4, 128, True), (200, 200, 4, 100, False),
          (256, 256, 8, 64, True)]


@pytest.mark.parametrize("q_scale", [1.0, 30.0])
@pytest.mark.parametrize("lq,lk,h,hd,causal", SHAPES)
def test_float32_design_within_half_the_tolerance(lq, lk, h, hd, causal,
                                                  q_scale):
    """float32: 3xTF32 q.K^T and a TF32 P.V stay at or under 1e-3 of the
    oracle, also with scores spread by x30; single-pass TF32 q.K^T does
    not at x30, which is why the kernel splits it."""
    q, k, v = _inputs(30, lq, lk, h, hd, q_scale)
    ref = attention_ref(q, k, v, causal=causal)
    assert _rel(_emulate(q, k, v, causal, "tf32x3"), ref) <= 1e-3
    single = _rel(_emulate(q, k, v, causal, "tf32"), ref)
    assert single > 1e-3 if q_scale == 30.0 else single <= 1e-3


@pytest.mark.parametrize("lq,lk,h,hd,causal", SHAPES)
def test_bfloat16_design_within_half_the_tolerance(lq, lk, h, hd, causal):
    """bfloat16 in, bfloat16 out, measured as the card's rows are (the
    oracle's output rounded to bf16 too): p split into bf16 hi + lo stays
    at or under 1e-3, p rounded to bf16 alone reads above 1.5e-3."""
    q, k, v = (_bf16(t) for t in _inputs(31, lq, lk, h, hd))
    ref = attention_ref(*(t.to(torch.bfloat16) for t in (q, k, v)),
                        causal=causal)
    out = lambda mode: _emulate(q, k, v, causal, mode).to(torch.bfloat16)
    assert _rel(out("bf16_hilo"), ref) <= 1e-3
    assert _rel(out("bf16_p"), ref) > 1.5e-3


# ---------------------------------------------------------------------------
# shared memory: kernel.smem_bytes against the source's layout
# ---------------------------------------------------------------------------

def test_smem_bytes_is_the_sources_layout():
    """The prefill CTA holds q [bq][hd'] and kSlots KV slots [bk][hd'] in
    the input type, hd' the smallest head-dim instance covering hd;
    `kernel.py` states the same."""
    src = _build.source_path("flash_attention").read_text()
    slots = int(re.search(r"constexpr int kSlots = (\d+);", src).group(1))
    assert slots == fa_kernel.STAGES == 2
    assert "sizeof(T) * (size_t)HD * (BQ + kSlots * BK)" in src
    instances = sorted({int(x) for x in re.findall(
        r"flash_prefill_kernel<BQ, BK, (\d+), T>", src)})
    assert tuple(instances) == fa_kernel.HEAD_DIM_TILES
    for bq, bk in PREFILL_TILES:
        for hd in (1, 8, 16, 63, 64, 65, 100, 128):
            hdp = 64 if hd <= 64 else 128
            for el in (4, 2):
                assert fa_kernel.smem_bytes(bq, bk, hd, el) == \
                    el * hdp * (bq + slots * bk)
    # the largest CTA fits one H100 SM's opt-in
    assert fa_kernel.smem_bytes(64, 128, 128, 4) == 163_840 <= SMEM_BYTES


# ---------------------------------------------------------------------------
# the bridge's prefill pick
# ---------------------------------------------------------------------------

def _steps(tile, lq, lk):
    nq, nk = math.ceil(lq / tile[0]), math.ceil(lk / tile[1])
    return nq * nk, nq * tile[0] + nk * tile[1]


@pytest.mark.parametrize("budget", [SMEM_BYTES, 120_000, 60_000, 48 * 1024])
@pytest.mark.parametrize("lq,lk,hd,bytes_el", [
    (4096, 4096, 128, 4), (4096, 4096, 128, 2), (512, 512, 64, 4),
    (264, 264, 128, 4), (64, 64, 64, 4), (17, 17, 64, 4),
    (20, 300, 100, 2)])
def test_prefill_pick_is_occupancy_aware(lq, lk, hd, bytes_el, budget):
    """The pick's CTA (`kernel.smem_bytes`, q tile and KV ring) fits the
    budget, its bk is at most PREFILL_MAX_BK, and no other such tile takes
    fewer (q-tile, KV-tile) steps or, at as many, a shorter masked tail.
    B * H = the SM count, so every grid fills the card."""
    pick = select_flash_blocks(lq, lk, hd, bytes_el=bytes_el,
                               smem_bytes=budget, batch_heads=SMS, n_sms=SMS)
    fits = [t for t in PREFILL_TILES if t[1] <= PREFILL_MAX_BK and
            fa_kernel.smem_bytes(*t, hd, bytes_el) <= budget]
    assert pick in fits
    assert all(_steps(pick, lq, lk) <= _steps(t, lq, lk) for t in fits)


def test_prefill_pick_refuses_a_budget_no_tile_fits():
    with pytest.raises(ValueError, match="no flash tile fits"):
        select_flash_blocks(512, 512, 128, bytes_el=4, smem_bytes=8_000,
                            batch_heads=SMS, n_sms=SMS)


@pytest.mark.parametrize("given", [{}, {"batch_heads": 36}, {"n_sms": SMS}])
def test_prefill_pick_needs_the_grid_and_the_sms(given):
    """A prefill pick depends on B * H and the card's SMs, so both are
    required; a decode pick needs neither."""
    with pytest.raises(ValueError, match="batch_heads"):
        select_flash_blocks(512, 512, 64, bytes_el=4, **given)
    assert select_flash_blocks(1, 512, 64, bytes_el=4, **given)[0] == 1


@pytest.mark.parametrize("lq,h,hd,bytes_el,blocks", [
    (64, 36, 64, 4, (32, 64)), (64, 36, 64, 2, (32, 64)),
    (128, 36, 64, 4, (64, 64)), (264, 16, 128, 4, (64, 64)),
    (512, 36, 64, 4, (64, 64)), (64, 1, 64, 4, (64, 64))])
def test_prefill_pick_fills_half_the_sms(lq, h, hd, bytes_el, blocks):
    """A grid of 64-row tiles that fills less than half of the H100's 132
    SMs (path C's exec_train: 36 CTAs) takes the largest block_q that
    fills half; 72 or 80 CTAs keep 64 x 64, and a grid no tile can widen
    to half (one head of 64 rows) keeps it too. On a card of as many SMs
    as the 64-row grid has CTAs, every shape keeps 64 x 64."""
    assert select_flash_blocks(lq, lq, hd, bytes_el=bytes_el,
                               batch_heads=h, n_sms=SMS) == blocks
    assert select_flash_blocks(lq, lq, hd, bytes_el=bytes_el, batch_heads=h,
                               n_sms=h * math.ceil(lq / 64)) == (64, 64)
