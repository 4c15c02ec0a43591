"""The CUDA kernels against their plain versions on the card. Every test
is marked ``gpu`` and skips without a CUDA device; on the card run

    python -m pytest -m gpu tests/test_torch_cuda.py

The card decides inside each test, never at import, so every worker of a
parallel run collects the same tests."""

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("m,k,n", [(128, 1024, 256), (100, 200, 360),
                                   (8, 72, 100), (130, 24, 1000)])
def test_matmul_int8_integer_exact(cuda, m, k, n):
    """Unit scales and K <= 1024: every |acc| <= 127**2 * 1024 < 2**24, so
    the f32 output holds the int32 sum exactly — kernel == plain, for every
    tile of the set, with ragged M, N and K edges."""
    from repro_torch.kernels.matmul_int8 import kernel
    from repro_torch.kernels.matmul_int8.ref import matmul_int8_ref
    g = _gen(0)
    x = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=cuda,
                      generator=g)
    w = torch.randint(-127, 128, (k, n), dtype=torch.int8, device=cuda,
                      generator=g)
    ones_m, ones_n = torch.ones(m, device=cuda), torch.ones(n, device=cuda)
    ref = matmul_int8_ref(x, w, ones_m, ones_n, torch.float32)
    for bm in kernel.BM_TILES:
        for bn in kernel.BN_TILES:
            for bk in kernel.BK_TILES:
                out = kernel.matmul_int8(x, w, ones_m, ones_n, bm=bm, bk=bk,
                                         bn=bn, out_dtype=torch.float32)
                assert torch.equal(out, ref), (bm, bk, bn)


@pytest.mark.parametrize("offset", [1, 8])
def test_matmul_int8_misaligned_views(cuda, offset):
    """Contiguous views that start off a 16-byte boundary, with K and N
    multiples of 16: the kernel must take its masked scalar loads there,
    not fault on a misaligned 16-byte load."""
    from repro_torch.kernels.matmul_int8 import kernel
    from repro_torch.kernels.matmul_int8.ref import matmul_int8_ref
    m, k, n = 64, 256, 128
    g = _gen(3)
    xbuf = torch.randint(-127, 128, (offset + m * k,), dtype=torch.int8,
                         device=cuda, generator=g)
    wbuf = torch.randint(-127, 128, (offset + k * n,), dtype=torch.int8,
                         device=cuda, generator=g)
    x, w = xbuf[offset:].view(m, k), wbuf[offset:].view(k, n)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    ones_m, ones_n = torch.ones(m, device=cuda), torch.ones(n, device=cuda)
    out = kernel.matmul_int8(x, w, ones_m, ones_n, bm=64, bk=64, bn=64,
                             out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(out, matmul_int8_ref(x, w, ones_m, ones_n,
                                            torch.float32))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_quantized_matmul_kernel_vs_plain(cuda, out_dtype):
    from repro_torch.kernels.matmul_int8 import kernel
    from repro_torch.kernels.matmul_int8.ops import quantized_matmul_and_ref
    g = _gen(1)
    x = torch.randn((128, 4096), device=cuda, generator=g)
    w = torch.randn((4096, 256), device=cuda, generator=g) * 0.1
    before = kernel.launches
    out, ref = quantized_matmul_and_ref(x, w, block_shapes=(64, 128, 64),
                                        out_dtype=getattr(torch, out_dtype))
    assert kernel.launches == before + 1
    rel = (out.double() - ref.double()).norm() / ref.double().norm()
    assert rel <= 1e-4 if out_dtype == "float32" else rel <= 4e-3


@pytest.mark.parametrize("b,lq,lk,h,hd,causal,dtype", [
    (2, 128, 128, 2, 64, True, "float32"),
    (2, 128, 128, 2, 64, False, "float32"),
    (1, 264, 264, 2, 16, True, "float32"),
    (1, 1024, 1024, 2, 128, True, "bfloat16"),
    (16, 1, 512, 8, 128, False, "float32"),
    (4, 1, 256, 2, 16, False, "bfloat16")])
def test_flash_attention_kernel_vs_plain(cuda, b, lq, lk, h, hd, causal,
                                         dtype):
    """Kernel vs the oracle at the executor's attention tolerance (2e-3)."""
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = _gen(2)
    dt = getattr(torch, dtype)
    q = torch.randn((b, lq, h, hd), device=cuda, generator=g).to(dt)
    k = torch.randn((b, lk, h, hd), device=cuda, generator=g).to(dt)
    v = torch.randn((b, lk, h, hd), device=cuda, generator=g).to(dt)
    before = kernel.launches
    out = flash_attention(q, k, v, causal=causal)
    assert kernel.launches == before + 1 and out.dtype == dt
    ref = attention_ref(q, k, v, causal=causal)
    rel = (out.double() - ref.double()).norm() / ref.double().norm()
    assert rel <= 2e-3


def test_executor_reduced_plan_runs_on_kernels(cuda, tmp_path, monkeypatch):
    from repro_torch import serve_lm
    monkeypatch.setenv("MIREDO_CACHE", str(tmp_path))
    rep = serve_lm.main(["--reduced", "--mode", "greedy"])
    assert rep.numerics_ok
    assert {op.path for op in rep.plan.ops} == {"cuda"}
