"""The port's kernel packages (`repro_torch.kernels`) against the JAX
reference on the CPU: oracles bit for bit where the arithmetic is exact,
and the public ops (which run their plain versions on CPU tensors) against
the reference's Pallas kernels in interpret mode, at the shapes of
`tests/test_kernels.py`. Inputs are made with numpy from a seed and handed
to both packages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
from repro.kernels.matmul_int8.ops import quantized_matmul as jax_qmm
from repro.kernels.matmul_int8.ref import matmul_int8_ref as jax_mm_ref
from repro.kernels.matmul_int8.ref import quantize_rowwise as jax_quant
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention, \
    legal_block
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.matmul_int8 import kernel as mm_kernel
from repro_torch.kernels.matmul_int8.ops import default_blocks, \
    quantized_matmul, quantized_matmul_and_ref
from repro_torch.kernels.matmul_int8.ref import matmul_int8_ref, \
    quantize_rowwise

T = torch.from_numpy


# ---------------------------------------------------------------------------
# matmul_int8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axis", [((16, 32), 1), ((64, 128), 0),
                                        ((100, 200), 1), ((200, 360), 0)])
def test_quantize_rowwise_bit_equal(shape, axis):
    """Same int8 codes and scales, bit for bit, including an all-zero row
    (scale floor 1e-8) and exact .5 ties (both round half to even)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    line = lambda i: (slice(None), i) if axis == 0 else (i, slice(None))
    x[line(3)] = 0.0
    # a line whose amax is 127 has scale exactly 1, so .5 values are ties
    ties = np.resize(np.array([2.5, -0.5, 3.5, -1.5], np.float32),
                     x[line(2)].shape)
    ties[0] = 127.0
    x[line(2)] = ties
    q, s = quantize_rowwise(T(x), axis=axis)
    jq, js = jax_quant(jnp.asarray(x), axis=axis)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8
    assert s[2] == 1.0 and q[line(2)][1:4].tolist() == [0, 4, -2]


def test_quantize_rowwise_bf16_input_bit_equal():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((32, 64)).astype(np.float32)
    xt = T(x).to(torch.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)
    q, s = quantize_rowwise(xt, axis=1)
    jq, js = jax_quant(xj, axis=1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("m,k,n", [(32, 64, 32), (128, 256, 128),
                                   (100, 200, 360), (8, 1024, 24)])
def test_matmul_int8_ref_matches_jax(m, k, n):
    """The int32 sums are exact on both sides (float64 here, int32 in the
    reference), so unit scales give equal outputs; with random scales the
    f32 epilogue rounds the same way (rtol 1e-6 leaves room for none)."""
    rng = np.random.default_rng(2)
    x_q = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w_q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    ones_m, ones_n = np.ones(m, np.float32), np.ones(n, np.float32)
    acc = matmul_int8_ref(T(x_q), T(w_q), T(ones_m), T(ones_n),
                          torch.float32)
    exact = x_q.astype(np.int64) @ w_q.astype(np.int64)
    np.testing.assert_array_equal(acc.numpy().astype(np.int64), exact)
    sx = rng.uniform(0.01, 0.1, m).astype(np.float32)
    sw = rng.uniform(0.01, 0.1, n).astype(np.float32)
    out = matmul_int8_ref(T(x_q), T(w_q), T(sx), T(sw), torch.float32)
    ref = jax_mm_ref(x_q, w_q, sx, sw, jnp.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("m,k,n", [(32, 64, 32), (64, 128, 64),
                                   (128, 256, 128), (32, 512, 16),
                                   (100, 200, 360), (8, 72, 100),
                                   (130, 24, 1000), (64, 128, 96)])
def test_quantized_matmul_matches_jax_kernel(m, k, n):
    """The port's op on CPU tensors vs the reference's Pallas kernel in
    interpret mode: identical quantization and exact int32 sums, so the
    executor's matmul tolerance (1e-4) is ample. The padded dims 100, 200
    and 360 run unpadded here (the CUDA kernel masks ragged edges)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    out = quantized_matmul(T(x), T(w), out_dtype=torch.float32)
    ref = jax_qmm(jnp.asarray(x), jnp.asarray(w), use_kernel=True,
                  interpret=True, out_dtype=jnp.float32)
    assert out.shape == (m, n)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_quantized_matmul_and_ref_bf16_default():
    rng = np.random.default_rng(4)
    x = T(rng.standard_normal((64, 128)).astype(np.float32))
    w = T((rng.standard_normal((128, 96)) * 0.1).astype(np.float32))
    out, ref = quantized_matmul_and_ref(x, w)
    assert out.dtype == ref.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert quantized_matmul(x, w).dtype == torch.bfloat16


def test_default_blocks_in_tile_set():
    for dims in [(128, 4096, 151552), (8, 72, 100), (100, 200, 360),
                 (1, 1, 1)]:
        bm, bk, bn = default_blocks(*dims)
        assert bm in mm_kernel.BM_TILES and bk in mm_kernel.BK_TILES and \
            bn in mm_kernel.BN_TILES


def test_matmul_wrapper_rejects_blocks_outside_tile_set():
    x = torch.zeros((8, 8), dtype=torch.int8)
    s = torch.ones(8)
    with pytest.raises(ValueError, match="tile set"):
        mm_kernel.matmul_int8(x, x, s, s, bm=8, bk=32, bn=32)


def test_matmul_wrapper_cpu_is_plain_and_not_counted():
    before = mm_kernel.launches
    x = torch.ones((16, 32), dtype=torch.int8)
    s = torch.ones(16)
    out = mm_kernel.matmul_int8(x, x.T.contiguous(), s, s, bm=16, bk=32,
                                bn=32, out_dtype=torch.float32)
    assert torch.equal(out, torch.full((16, 16), 32.0))
    assert mm_kernel.launches == before


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _qkv(rng, b, lq, lk, h, hd):
    return (rng.standard_normal((b, lq, h, hd)).astype(np.float32),
            rng.standard_normal((b, lk, h, hd)).astype(np.float32),
            rng.standard_normal((b, lk, h, hd)).astype(np.float32))


# f32: both sides sum in float32 in different orders (einsum here, the
# blockwise online softmax in the Pallas kernel) — 1e-5 covers that.
F32_TOL = 1e-5


@pytest.mark.parametrize("l,hd,bq,bk", [(128, 64, 32, 32), (256, 64, 64, 64),
                                        (128, 128, 64, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax_kernel(l, hd, bq, bk, causal):
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 2, l, l, 2, hd)
    out = flash_attention(T(q), T(k), T(v), causal=causal, block_q=bq,
                          block_k=bk)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, block_q=bq, block_k=bk, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_jax_ref(causal):
    rng = np.random.default_rng(6)
    q, k, v = _qkv(rng, 2, 64, 64, 3, 32)
    out = attention_ref(T(q), T(k), T(v), causal=causal)
    ref = jax_attn_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=F32_TOL,
                               atol=F32_TOL)


def test_flash_attention_bf16_matches_jax():
    """bf16 in and out: each side rounds its f32 result to bf16 once, and
    the f32 sums differ in order, so outputs may differ by one bf16 ulp
    (2**-8 relative) — 2e-3 of the values' scale, the executor's
    attention tolerance, with an ulp-sized absolute floor."""
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 1, 128, 128, 2, 64)
    tq, tk, tv = (T(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=True, block_q=64, block_k=64)
    ref = jax_flash(jq, jk, jv, causal=True, block_q=64, block_k=64,
                    interpret=True)
    assert out.dtype == torch.bfloat16
    a = out.to(torch.float32).numpy()
    b = np.asarray(ref, np.float32)
    assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 2e-3
    np.testing.assert_allclose(a, b, rtol=2e-2, atol=2e-2)


def test_flash_attention_l264_and_legal_block():
    """L = 264 (no power-of-two tile divides it) runs on a tile from the
    set; the kernel masks the ragged tail instead of needing a divisor."""
    assert legal_block(264, 256) == 64
    assert legal_block(264, 256, fa_kernel.BK_TILES) == 128
    assert legal_block(1, 128) == 1              # decode step (lq = 1)
    assert legal_block(7, 256) == 16
    assert legal_block(96, 32) == 32
    rng = np.random.default_rng(10)
    q, k, v = _qkv(rng, 1, 264, 264, 2, 16)
    out = flash_attention(T(q), T(k), T(v), causal=True)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=True, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=F32_TOL,
                               atol=F32_TOL)


def test_flash_attention_decode_step_vs_cache():
    """The executor's decode dispatch: one query step (lq = 1) against a
    256-entry KV cache, non-causal."""
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, 4, 1, 256, 2, 16)
    out = flash_attention(T(q), T(k), T(v), causal=False)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=False, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=F32_TOL,
                               atol=F32_TOL)


def test_flash_wrapper_rejects_bad_inputs():
    q = torch.zeros((1, 4, 1, 8))
    with pytest.raises(ValueError, match="tile set"):
        fa_kernel.flash_attention_blhd(q, q, q, block_q=8, block_k=32)
    with pytest.raises(ValueError, match="do not match"):
        fa_kernel.flash_attention_blhd(q, torch.zeros((1, 4, 2, 8)), q,
                                       block_q=1, block_k=32)
    before = fa_kernel.launches
    fa_kernel.flash_attention_blhd(q, q, q, block_q=1, block_k=32)
    assert fa_kernel.launches == before
