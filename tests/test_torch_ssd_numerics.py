"""The ssd_scan kernel's design on the CPU: the arithmetic its
tensor-core fragments do, emulated in plain PyTorch against the f32
oracle; the shared-memory layout `kernel.smem_bytes` states against the
CUDA source; and the bridge's query-tile pick. The kernel itself runs
only on the card (`tests/test_torch_cuda.py`, marked gpu). Inputs are made
with numpy from a seed, drawn as the executor draws them."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.executor import NUMERICS_TOL
from repro_torch.core.gpu_bridge import SMEM_BYTES, SMS, select_ssd_block
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref

#: Half of the executor's tolerance: the margin a design must keep.
HALF_TOL = NUMERICS_TOL["ssd_scan"] / 2


# ---------------------------------------------------------------------------
# the kernel's roundings, emulated
# ---------------------------------------------------------------------------

def _tf32(x):
    """Round to TF32, to nearest with ties away from zero, as the kernel's
    ``tf32()``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _emulate(c, b, s, dt, x, mode):
    """One cell through the kernel's arithmetic: c, b (Q, N); s, dt (Q,);
    x (Q, P), float32 tensors holding the operands' values. The MMAs sum
    exact products in f32 (here in f64, then rounded). ``mode`` names the
    design: ``tf32`` the float32 kernel (C, B, W and X rounded to TF32,
    one pass per product), ``bf16_hilo`` the bfloat16 kernel (exact C.B^T,
    W = bf16 hi + bf16 lo against X), ``bf16_w`` W rounded to bf16 once."""
    q = s.shape[0]
    if mode == "tf32":
        c, b = _tf32(c), _tf32(b)
    scores = (c.double() @ b.double().T).float()
    decay = torch.exp(torch.clamp_min(s[:, None] - s[None, :], -60.0))
    w = scores * decay * dt[None, :]
    w = torch.where(torch.ones(q, q, dtype=torch.bool).tril(), w, 0.0)
    if mode == "tf32":
        return (_tf32(w).double() @ _tf32(x).double()).float()
    if mode == "bf16_hilo":
        hi = _bf16(w)
        return (hi.double() @ x.double() +
                _bf16(w - hi).double() @ x.double()).float()
    assert mode == "bf16_w"
    return (_bf16(w).double() @ x.double()).float()


def _cell(q, n, p, seed):
    """(c, b, s, dt, x) of one cell, as `executor._run_ssd` draws them."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((q, n)).astype(np.float32)
    b = rng.standard_normal((q, n)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, q).astype(np.float32)
    a = -rng.uniform(0.5, 4.0)
    s = np.cumsum(dt * a).astype(np.float32)
    x = rng.standard_normal((q, p)).astype(np.float32)
    return [torch.from_numpy(v) for v in (c, b, s, dt, x)]


def _rel_err(mode, q, n, p, seed=0):
    """Relative Frobenius error of the emulated kernel against the oracle
    on the same operands (rounded to bf16 first for the bf16 designs,
    outputs in the operands' dtype, as the card compares them)."""
    args = _cell(q, n, p, seed)
    if mode != "tf32":
        args = [_bf16(t) for t in args]
    out = _emulate(*args, mode)
    ref = ssd_intra_chunk_ref(*(t[None, None, :, None] for t in args))
    ref = ref[0, 0, :, 0]
    if mode != "tf32":
        out, ref = _bf16(out), _bf16(ref)
    return float((out.double() - ref.double()).norm() / ref.double().norm())


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -11             # halfway between two TF32 values
    x = torch.tensor([one, -one, one - 2.0 ** -23, 1.0 + 2.0 ** -10],
                     dtype=torch.float32)
    assert _tf32(x).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                                 1.0 + 2.0 ** -10]


@pytest.mark.parametrize("mode", ["tf32", "bf16_hilo"])
@pytest.mark.parametrize("q,n,p", [(256, 128, 64), (64, 128, 64),
                                   (24, 8, 8)], ids=["path_B", "path_C",
                                                     "odd_q"])
def test_kernel_roundings_within_half_the_tolerance(mode, q, n, p):
    """Both dtypes' designs at path B's cell (Q 256, N 128, P 64), path
    C's exec_train cell (Q 64) and odd Q keep within half of the
    executor's 2e-3. Single-pass TF32 reads ~4.2e-4 there (the header of
    `csrc/ssd_scan.cu` states it), well above f32 sums alone, so the
    emulation does round; the bf16 design ~1.3e-4 at Q 256."""
    errs = [_rel_err(mode, q, n, p, seed) for seed in range(2)]
    assert max(errs) <= HALF_TOL, errs
    if mode == "tf32":
        assert min(errs) > 1e-4, errs


def test_bf16_w_rounded_once_misses_the_tolerance():
    """Why the bf16 kernel splits W: rounded to bf16 once it reads ~2.6e-3
    at path B's cell, over the executor's tolerance itself."""
    assert _rel_err("bf16_w", 256, 128, 64) > NUMERICS_TOL["ssd_scan"]


# ---------------------------------------------------------------------------
# shared memory: kernel.smem_bytes against the source's layout
# ---------------------------------------------------------------------------

INSTANCES = [(np_, pp, el) for np_ in ssd_kernel.DIM_TILES
             for pp in ssd_kernel.DIM_TILES for el in (4, 2)]


def test_smem_bytes_is_the_sources_ring():
    """A CTA's dynamic shared memory is kSlots slots of KT keys (B and X
    rows in the input type, s and dt in f32), whatever bt; N and P pad to
    the source's instances; `kernel.py` states the same."""
    src = _build.source_path("ssd_scan").read_text()
    slots = int(re.search(r"constexpr int kSlots = (\d+);", src).group(1))
    kt = int(re.search(r"constexpr int KT = (\d+);", src).group(1))
    assert (slots, kt) == (ssd_kernel.STAGES, ssd_kernel.KEY_TILE) == (2, 64)
    assert "KT * (NP + PP) * (int)sizeof(T) + 2 * KT * (int)sizeof(float)" \
        in src
    dims = sorted({int(v) for v in re.findall(
        r"ssd_scan_kernel<BT, (\d+), \d+, T>", src)})
    assert tuple(dims) == ssd_kernel.DIM_TILES
    bts = sorted({int(v) for v in re.findall(r"case (\d+): return pick_np",
                                             src)})
    assert tuple(bts) == ssd_kernel.BT_TILES
    for n in (1, 8, 33, 64, 65, 128):
        for p in (1, 17, 64, 100, 128):
            for el in (4, 2):
                np_, pp = (64 if d <= 64 else 128 for d in (n, p))
                assert ssd_kernel.smem_bytes(n, p, el) == \
                    slots * (kt * (np_ + pp) * el + 2 * kt * 4)


# ---------------------------------------------------------------------------
# the bridge's query-tile pick
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,nc,q,h,bt", [
    (1, 1, 256, 1, 16), (1, 1, 64, 1, 16), (1, 4, 256, 3, 32),
    (1, 128, 256, 64, 64)], ids=str)
def test_ssd_pick_at_the_sweep_shapes(b, nc, q, h, bt):
    """The shapes of `chip_smoke.py`'s ssd sweep on an H100's 132 SMs: the
    one-cell ops of paths B (4 CTAs at bt 64) and C (Q 64: one CTA) take
    16, 12 cells (48 CTAs at 64, 96 at 32) 32, one prefill_32k layer of
    one sequence (32,768 CTAs) 64."""
    assert select_ssd_block(b * nc * h, q, n_sms=SMS) == bt


def test_ssd_pick_needs_the_sms():
    """The pick depends on the card's SMs; it never reads the card."""
    with pytest.raises(TypeError):
        select_ssd_block(1, 256)
    with pytest.raises(ValueError):
        select_ssd_block(1, 256, n_sms=0)


@pytest.mark.parametrize("n_sms", [SMS, 114, 16])
@pytest.mark.parametrize("cells", [1, 2, 5, 12, 33, 64, 8192])
@pytest.mark.parametrize("q", [1, 24, 64, 65, 128, 256, 1000])
def test_ssd_pick_fills_half_the_sms(q, cells, n_sms):
    """The pick is the largest tile whose grid fills half the SMs, the
    smallest when none does."""
    bt = select_ssd_block(cells, q, n_sms=n_sms)
    grid = lambda t: cells * -(-q // t)
    assert bt in ssd_kernel.BT_TILES
    if grid(bt) >= n_sms / 2:
        assert all(grid(t) < n_sms / 2 for t in ssd_kernel.BT_TILES
                   if t > bt)
    else:
        assert bt == min(ssd_kernel.BT_TILES)


def test_every_instance_fits_and_the_main_one_twice():
    """Every instance's ring fits an H100 CTA's opt-in; path B's float32
    instance (N 128, P 64) fits two CTAs in an SM's 228 KB (1 KB of each
    CTA reserved), and only bf16 at N, P <= 64 stays under the 48 KB that
    needs no opt-in."""
    sizes = {i: ssd_kernel.smem_bytes(*i) for i in INSTANCES}
    assert max(sizes.values()) == sizes[128, 128, 4] == 132_096 <= SMEM_BYTES
    assert 2 * (sizes[128, 64, 4] + 1024) <= 228 * 1024
    assert [i for i, v in sizes.items() if v <= 48 * 1024] == [(64, 64, 2)]
