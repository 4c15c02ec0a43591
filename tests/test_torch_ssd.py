"""The port's SSD intra-chunk package (`repro_torch.kernels.ssd_scan`)
against the JAX reference on the CPU: the plain versions and the public
op (which runs its plain version on CPU tensors) against the reference's
oracle and its Pallas kernel in interpret mode, at the shapes of
`tests/test_kernels.py`, plus the sequential recurrence oracle. Inputs are
made with numpy from a seed and handed to both packages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.ssd_scan.kernel import ssd_intra_chunk_bh as jax_bh
from repro.kernels.ssd_scan.ops import ssd_intra_chunk as jax_ssd
from repro.kernels.ssd_scan.ops import ssd_intra_chunk_and_ref as jax_pair
from repro.kernels.ssd_scan.ref import ssd_intra_chunk_ref as jax_ref
from repro.kernels.ssd_scan.ref import ssd_sequential_ref as jax_seq
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.kernel import ssd_intra_chunk_bh
from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk, \
    ssd_intra_chunk_and_ref
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref, \
    ssd_sequential_ref

T = torch.from_numpy
#: The reference's own tolerance for its kernel vs its oracle
#: (tests/test_kernels.py): f32 sums taken in another order.
TOL = 2e-4


def _inputs(rng, b, nc, q, h, n, p):
    """numpy (c, b, s, dt, x) as the reference's tests draw them."""
    c = rng.standard_normal((b, nc, q, h, n)).astype(np.float32)
    bb = rng.standard_normal((b, nc, q, h, n)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (b, nc, q, h)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, (h,)).astype(np.float32)
    s = np.cumsum(dt * a, axis=2).astype(np.float32)
    x = rng.standard_normal((b, nc, q, h, p)).astype(np.float32)
    return c, bb, s, dt, x


@pytest.mark.parametrize("q,h,n,p", [(32, 2, 16, 16), (64, 4, 32, 32),
                                     (128, 2, 64, 64), (24, 2, 8, 8)])
@pytest.mark.parametrize("fn", ["ref", "op"])
def test_ssd_intra_chunk_vs_jax(fn, q, h, n, p):
    """The plain version and the public op against both the JAX oracle and
    the JAX kernel in interpret mode, odd Q = 24 included."""
    args = _inputs(np.random.default_rng(5), 2, 2, q, h, n, p)
    port = ssd_intra_chunk_ref if fn == "ref" else ssd_intra_chunk
    out = port(*map(T, args)).numpy()
    jargs = [jnp.asarray(a) for a in args]
    np.testing.assert_allclose(out, np.asarray(jax_ref(*jargs)), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(
        out, np.asarray(jax_ssd(*jargs, interpret=True)), rtol=TOL,
        atol=TOL)


def test_ssd_masked_entries_are_exactly_zero():
    """Row t = 0 sees only tau = 0: pushing s_0 - s_tau past the -60 clip
    and scaling x_tau by 1e6 for every tau > 0 leaves y[0] bit for bit
    unchanged, so the masked entries add exactly nothing."""
    c, bb, s, dt, x = _inputs(np.random.default_rng(7), 1, 1, 16, 2, 4, 3)
    y = ssd_intra_chunk_ref(*map(T, (c, bb, s, dt, x)))
    s2, x2 = s.copy(), x.copy()
    s2[:, :, 1:] = 80.0
    x2[:, :, 1:] *= 1e6
    y2 = ssd_intra_chunk_ref(*map(T, (c, bb, s2, dt, x2)))
    assert torch.equal(y[:, :, 0], y2[:, :, 0])
    assert not torch.equal(y[:, :, 1:], y2[:, :, 1:])


def test_ssd_intra_chunk_bf16_matches_jax_kernel():
    """bf16 inputs: float32 arithmetic, the output in x's dtype, within one
    bf16 ulp (2**-7 relative) of the JAX kernel on the same bf16 values."""
    args = _inputs(np.random.default_rng(8), 1, 2, 64, 2, 32, 16)
    tb = [T(a).to(torch.bfloat16) for a in args]
    out = ssd_intra_chunk(*tb)
    assert out.dtype == torch.bfloat16
    jargs = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in tb]
    ref = jax_ssd(*jargs, interpret=True)
    assert ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2 ** -7, atol=2 ** -7)


def test_ssd_intra_chunk_and_ref_odd_q():
    """The executor's fused check (`ssd_intra_chunk_and_ref`) at Q = 24:
    both halves against the JAX pair."""
    args = _inputs(np.random.default_rng(12), 1, 1, 24, 1, 8, 8)
    out, ref = ssd_intra_chunk_and_ref(*map(T, args))
    jout, jref = jax_pair(*map(jnp.asarray, args), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=TOL, atol=TOL)


def test_ssd_intra_chunk_bh_flattened_layout():
    """The flattened (BCH, Q, .) entry point against the JAX Pallas kernel
    on the reference's fold of the same inputs."""
    b, nc, q, h, n, p = 2, 2, 40, 3, 16, 8
    c, bb, s, dt, x = _inputs(np.random.default_rng(9), b, nc, q, h, n, p)
    f5 = lambda t: np.ascontiguousarray(
        t.transpose(0, 1, 3, 2, 4).reshape(b * nc * h, q, t.shape[-1]))
    f4 = lambda t: np.ascontiguousarray(
        t.transpose(0, 1, 3, 2).reshape(b * nc * h, q))
    flat = (f5(c), f5(bb), f4(s), f4(dt), f5(x))
    out = ssd_intra_chunk_bh(*map(T, flat))
    assert out.shape == (b * nc * h, q, p)
    ref = jax_bh(*map(jnp.asarray, flat), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_ssd_sequential_ref_matches_jax_with_groups():
    """The step-by-step recurrence oracle, with G = 2 groups over H = 4
    heads so the group repeat is exercised; output and final state."""
    rng = np.random.default_rng(6)
    bsz, l, h, p, g, n = 2, 24, 4, 8, 2, 16
    x = rng.standard_normal((bsz, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (bsz, l, h)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, (h,)).astype(np.float32)
    b = rng.standard_normal((bsz, l, g, n)).astype(np.float32)
    c = rng.standard_normal((bsz, l, g, n)).astype(np.float32)
    d = rng.standard_normal((h,)).astype(np.float32)
    y, state = ssd_sequential_ref(*map(T, (x, dt, a, b, c, d)))
    jy, jstate = jax_seq(*map(jnp.asarray, (x, dt, a, b, c, d)))
    assert y.shape == (bsz, l, h, p) and state.shape == (bsz, h, p, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), rtol=TOL,
                               atol=TOL)


def _small():
    return [T(a) for a in _inputs(np.random.default_rng(1), 1, 1, 8, 2, 4, 4)]


@pytest.mark.parametrize("case,exc", [
    ("b_shape", ValueError), ("s_shape", ValueError), ("x_rank", ValueError),
    ("float64", TypeError), ("mixed_dtype", TypeError),
    ("mixed_device", ValueError), ("meta_device", ValueError),
    ("block_t", ValueError)])
def test_wrapper_rejects(case, exc):
    c, b, s, dt, x = _small()
    kw = {"block_t": 48} if case == "block_t" else {}
    if case == "b_shape":
        b = b[:, :, :-1]
    elif case == "s_shape":
        s = s[..., :1]
    elif case == "x_rank":
        x = x[0]
    elif case == "float64":
        c, b, s, dt, x = (t.double() for t in (c, b, s, dt, x))
    elif case == "mixed_dtype":
        x = x.to(torch.bfloat16)
    elif case == "mixed_device":
        c = c.to("meta")
    elif case == "meta_device":
        c, b, s, dt, x = (t.to("meta") for t in (c, b, s, dt, x))
    with pytest.raises(exc):
        ssd_intra_chunk(c, b, s, dt, x, **kw)


def test_flattened_wrapper_rejects_wrong_rank():
    c, b, s, dt, x = _small()
    with pytest.raises(ValueError):
        ssd_intra_chunk_bh(c, b, s, dt, x)


def test_cpu_call_takes_plain_version_without_launch():
    before = ssd_kernel.launches
    c, b, s, dt, x = _small()
    out, ref = ssd_intra_chunk_and_ref(c, b, s, dt, x)
    assert ssd_kernel.launches == before
    assert torch.equal(out, ref)


def test_build_lists_three_kernels_and_ssd_tiles_fit():
    """`_build` compiles one source per kernel, ssd_scan included; its
    largest CTA (N = P = 128, float32: the ring of two 64-key slots) fits
    the H100's 227 KB of shared memory per block, the executor's cell
    (N 128, P 64, float32) needs the opt-in above 48 KB that the launch
    sets wherever ``smem_bytes`` exceeds it, and a bfloat16 cell of
    N, P <= 64 needs none."""
    from repro_torch.kernels import _build
    assert set(_build.SOURCES) == {"matmul_int8", "flash_attention",
                                   "ssd_scan"}
    assert all(_build.source_path(k).is_file() for k in _build.SOURCES)
    assert ssd_kernel.smem_bytes(128, 128, 4) <= 232448
    assert ssd_kernel.smem_bytes(128, 64, 4) > 48 * 1024
    assert ssd_kernel.smem_bytes(8, 8, 2) <= 48 * 1024
    src = _build.source_path("ssd_scan").read_text()
    assert "if (p.bytes <= 48 * 1024) return cudaSuccess;" in src
