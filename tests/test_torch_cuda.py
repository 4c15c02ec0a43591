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


@pytest.mark.parametrize("m,k,n", [(128, 1, 64), (1, 128, 64),
                                   (16, 1, 64), (1, 1, 1)])
def test_matmul_int8_k1_m1_exact(cuda, m, k, n):
    """The plans' K = 1 (SSD state update) and M = 1 (readout, LM head)
    shapes take the kernel's masked scalar loads: integer-exact for every
    tile of the set."""
    from repro_torch.kernels.matmul_int8 import kernel
    from repro_torch.kernels.matmul_int8.ref import matmul_int8_ref
    g = _gen(4)
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


def _int8_case(m, k, n, seed):
    g = _gen(seed)
    x = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda",
                      generator=g)
    w = torch.randint(-127, 128, (k, n), dtype=torch.int8, device="cuda",
                      generator=g)
    return x, w, torch.ones(m, device="cuda"), torch.ones(n, device="cuda")


def _splits(m, k, n, bm, bk, bn):
    """1, a few others and the rule's split for this card, all legal."""
    from repro_torch.kernels.matmul_int8 import kernel
    steps = -(-k // bk)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rule = kernel.split_k(m, n, k, bm, bk, bn, sms)
    return sorted({s for s in (1, 2, 3, 7, steps, rule) if s <= steps})


@pytest.mark.parametrize("m,k,n,bm,bk,bn", [
    (128, 4096 + 24, 256, 128, 128, 128),  # K ragged, the last step short
    (128, 13696, 4096, 128, 128, 128),     # path A's ffn_down, 107 steps
    (100, 1000, 360, 64, 32, 64),          # ragged M, N and K, small tiles
    (1, 4096 + 24, 256, 16, 128, 128)],    # M = 1
    ids=str)
def test_matmul_int8_split_k_exact(cuda, m, k, n, bm, bk, bn):
    """Split-K sums the int32 partials exactly: under unit scales every
    split, the rule's included, equals the plain version bit for bit (also
    past |acc| = 2**24, where both round the same sum to float32), with
    one launch per call."""
    from repro_torch.kernels.matmul_int8 import kernel
    from repro_torch.kernels.matmul_int8.ref import matmul_int8_ref
    x, w, ones_m, ones_n = _int8_case(m, k, n, 12)
    ref = matmul_int8_ref(x, w, ones_m, ones_n, torch.float32)
    for split in _splits(m, k, n, bm, bk, bn):
        before = kernel.launches
        out = kernel.matmul_int8(x, w, ones_m, ones_n, bm=bm, bk=bk, bn=bn,
                                 out_dtype=torch.float32, split_k=split)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert torch.equal(out, ref), split


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (128, 1, 64), (1, 128, 64),
                                   (1, 200, 100)])
def test_matmul_int8_k1_m1_under_splits(cuda, m, k, n):
    """M = 1, K = 1 and (1, 1, 1) at every tile of the set and every split
    its K steps allow (K = 1 has one step, so only split 1)."""
    from repro_torch.kernels.matmul_int8 import kernel
    from repro_torch.kernels.matmul_int8.ref import matmul_int8_ref
    x, w, ones_m, ones_n = _int8_case(m, k, n, 13)
    ref = matmul_int8_ref(x, w, ones_m, ones_n, torch.float32)
    for bm in kernel.BM_TILES:
        for bn in kernel.BN_TILES:
            for bk in kernel.BK_TILES:
                for split in _splits(m, k, n, bm, bk, bn):
                    out = kernel.matmul_int8(
                        x, w, ones_m, ones_n, bm=bm, bk=bk, bn=bn,
                        out_dtype=torch.float32, split_k=split)
                    assert torch.equal(out, ref), (bm, bk, bn, split)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_matmul_int8_split_k_scaled_outputs(cuda, out_dtype):
    """With real scales the epilogue multiplies in the plain version's order
    and rounds once to the output type, so float32 and bfloat16 outputs
    equal the plain version's bit for bit, split or not."""
    from repro_torch.kernels.matmul_int8 import kernel
    from repro_torch.kernels.matmul_int8.ref import matmul_int8_ref
    m, k, n = 128, 4096 + 24, 256
    x, w, _, _ = _int8_case(m, k, n, 14)
    g = _gen(15)
    xs = torch.rand(m, device=cuda, generator=g) / 127
    ws = torch.rand(n, device=cuda, generator=g) / 127
    dt = getattr(torch, out_dtype)
    ref = matmul_int8_ref(x, w, xs, ws, dt)
    for split in _splits(m, k, n, 128, 128, 128):
        out = kernel.matmul_int8(x, w, xs, ws, bm=128, bk=128, bn=128,
                                 out_dtype=dt, split_k=split)
        assert out.dtype == dt and torch.equal(out, ref), split


def test_matmul_int8_split_k_deterministic(cuda):
    """Two calls under the rule's split give the same bits: the reduce pass
    sums the int32 partials in split order."""
    from repro_torch.kernels.matmul_int8 import kernel
    m, k, n = 128, 4096, 256
    x, w, _, _ = _int8_case(m, k, n, 16)
    g = _gen(17)
    xs = torch.rand(m, device=cuda, generator=g)
    ws = torch.rand(n, device=cuda, generator=g)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert kernel.split_k(m, n, k, 128, 128, 128, sms) > 1
    a = kernel.matmul_int8(x, w, xs, ws, out_dtype=torch.float32)
    b = kernel.matmul_int8(x, w, xs, ws, out_dtype=torch.float32)
    assert torch.equal(a, b)


def test_matmul_smem_bytes_match_the_launch(cuda):
    """`kernel.smem_bytes` (the whole ring) is what every launch of the tile
    set passes (static plus dynamic shared memory, as the CUDA runtime
    reports it); no tile spills to local memory and the card holds at
    least one CTA of each."""
    from repro_torch.kernels.matmul_int8 import kernel
    for bm in kernel.BM_TILES:
        for bn in kernel.BN_TILES:
            for bk in kernel.BK_TILES:
                occ = kernel.occupancy(bm, bk, bn)
                want = kernel.smem_bytes(bm, bk, bn)
                assert occ["smem_bytes"] == want, (bm, bk, bn)
                assert occ["local_bytes"] == 0, (bm, bk, bn)
                assert occ["ctas_per_sm"] >= 1 and occ["regs"] > 0


def _ssd_inputs(shape, dtype, g):
    b, nc, q, h, n, p = shape
    c = torch.randn((b, nc, q, h, n), device="cuda", generator=g)
    bb = torch.randn((b, nc, q, h, n), device="cuda", generator=g)
    dt = 0.001 + 0.099 * torch.rand((b, nc, q, h), device="cuda",
                                    generator=g)
    a = -(0.5 + 3.5 * torch.rand((h,), device="cuda", generator=g))
    s = torch.cumsum(dt * a, dim=2)
    x = torch.randn((b, nc, q, h, p), device="cuda", generator=g)
    return [t.to(dtype) for t in (c, bb, s, dt, x)]


@pytest.mark.parametrize("shape", [
    (1, 1, 256, 1, 128, 64), (1, 1, 64, 1, 128, 64), (1, 1, 24, 1, 8, 8),
    (2, 2, 24, 2, 16, 16), (1, 3, 100, 4, 33, 17), (1, 2, 256, 4, 128, 128),
    (2, 1, 130, 3, 1, 1)], ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_kernel_vs_plain(cuda, shape, dtype):
    """Kernel vs the oracle at the executor's SSD tolerance (2e-3): the
    executor's one-cell ops (Q = 256, 64), odd Q, ragged N and P, and
    several cells read in place from the (B, NC, Q, H, .) layout."""
    from repro_torch.kernels.ssd_scan import kernel
    from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref
    dt_ = getattr(torch, dtype)
    args = _ssd_inputs(shape, dt_, _gen(5))
    before = kernel.launches
    out = ssd_intra_chunk(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert out.dtype == dt_ and out.shape == args[4].shape
    ref = ssd_intra_chunk_ref(*args)
    rel = (out.double() - ref.double()).norm() / ref.double().norm()
    assert rel <= 2e-3


def test_ssd_scan_flattened_and_strided_views(cuda):
    """The reference's flattened (BCH, Q, .) entry point, and a
    non-contiguous (B, NC, Q, H, .) view, agree with the oracle."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_intra_chunk_bh
    from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref
    b, nc, q, h, n, p = 2, 3, 80, 2, 32, 24
    c, bb, s, dt, x = _ssd_inputs((b, nc, q, h, n, p), torch.float32,
                                  _gen(6))
    ref = ssd_intra_chunk_ref(c, bb, s, dt, x)
    f5 = lambda t: t.permute(0, 1, 3, 2, 4).reshape(b * nc * h, q, -1)
    f4 = lambda t: t.permute(0, 1, 3, 2).reshape(b * nc * h, q)
    out = ssd_intra_chunk_bh(f5(c), f5(bb), f4(s), f4(dt), f5(x))
    torch.cuda.synchronize()
    assert (out - f5(ref)).abs().max() <= 2e-3 * ref.abs().max()
    # every other chunk: strided along NC, the kernel reads in place
    view = lambda t: t[:, ::2]
    out = ssd_intra_chunk(*(view(t) for t in (c, bb, s, dt, x)))
    ref = ssd_intra_chunk_ref(*(view(t) for t in (c, bb, s, dt, x)))
    rel = (out.double() - ref.double()).norm() / ref.double().norm()
    assert rel <= 2e-3


def _ssd_rel(out, ref):
    return float((out.double() - ref.double()).norm() / ref.double().norm())


@pytest.mark.parametrize("n,p", [(8, 8), (64, 64), (128, 128), (128, 64),
                                 (8, 128)], ids=str)
@pytest.mark.parametrize("q", [24, 200])
@pytest.mark.parametrize("bt", [16, 32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_every_tile(cuda, dtype, bt, q, n, p):
    """Every query tile (1, 2 or 4 key groups) at ragged Q, with N and P
    at and under both padded instances, against the oracle at the
    executor's 2e-3, and two launches bit-equal (the key groups' partial
    sums meet in a fixed order)."""
    from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref
    dt_ = getattr(torch, dtype)
    args = _ssd_inputs((1, 2, q, 2, n, p), dt_, _gen(7))
    out = ssd_intra_chunk(*args, block_t=bt)
    again = ssd_intra_chunk(*args, block_t=bt)
    torch.cuda.synchronize()
    assert out.dtype == dt_ and out.shape == args[4].shape
    assert torch.equal(out, again)
    assert _ssd_rel(out, ssd_intra_chunk_ref(*args)) <= 2e-3


@pytest.mark.parametrize("bt", [16, 32, 64])
def test_ssd_scan_views_take_the_masked_loads(cuda, bt):
    """Strided views along NC and H (16-byte aligned: cp.async) and views
    one element off a 16-byte boundary, or with N * 4 not a multiple of
    16 (the masked element loads), agree with the oracle at every tile;
    masked entries stay exactly 0 (y[0] sees only tau = 0)."""
    from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref
    c, bb, s, dt, x = _ssd_inputs((2, 4, 130, 4, 64, 64), torch.float32,
                                  _gen(8))
    for view in (lambda t: t[:, ::2], lambda t: t[:, :, :, 1::2],
                 lambda t: t[..., 1:] if t.dim() == 5 else t,
                 lambda t: t[..., :58] if t.dim() == 5 else t):
        args = [view(t) for t in (c, bb, s, dt, x)]
        out = ssd_intra_chunk(*args, block_t=bt)
        assert _ssd_rel(out, ssd_intra_chunk_ref(*args)) <= 2e-3
    # row 0 sees only key 0: s and x of every later key cannot reach it
    args = [t[:1, :1] for t in (c, bb, s, dt, x)]
    y0 = ssd_intra_chunk(*args, block_t=bt)[:, :, 0]
    s2, x2 = args[2].clone(), args[4].clone()
    s2[:, :, 1:] = 80.0
    x2[:, :, 1:] *= 1e6
    y2 = ssd_intra_chunk(args[0], args[1], s2, args[3], x2,
                         block_t=bt)[:, :, 0]
    assert torch.equal(y0, y2)


def test_ssd_scan_instances_launch_as_stated(cuda):
    """Every instance launches with `kernel.smem_bytes` of shared memory
    (the opt-in set where it exceeds 48 KB, so at least one CTA fits an
    SM) and no local memory."""
    from repro_torch.kernels.ssd_scan import kernel
    for bt in kernel.BT_TILES:
        for n in kernel.DIM_TILES:
            for p in kernel.DIM_TILES:
                for dt_, el in ((torch.float32, 4), (torch.bfloat16, 2)):
                    o = kernel.occupancy(bt, n, p, dt_)
                    assert o["smem_bytes"] == kernel.smem_bytes(n, p, el)
                    assert o["local_bytes"] == 0 and o["ctas_per_sm"] >= 1


def test_executor_reduced_ssd_plan_runs_on_kernels(cuda, tmp_path,
                                                   monkeypatch):
    from repro_torch import serve_lm
    monkeypatch.setenv("MIREDO_CACHE", str(tmp_path))
    rep = serve_lm.main(["--reduced", "--mode", "greedy", "--arch",
                         "mamba2-1.3b", "--shape", "prefill_32k"])
    assert rep.numerics_ok
    assert {op.path for op in rep.plan.ops} == {"cuda"}
    assert "ssd_scan" in {op.kernel for op in rep.plan.ops}


def test_executor_reduced_plan_runs_on_kernels(cuda, tmp_path, monkeypatch):
    from repro_torch import serve_lm
    monkeypatch.setenv("MIREDO_CACHE", str(tmp_path))
    rep = serve_lm.main(["--reduced", "--mode", "greedy"])
    assert rep.numerics_ok
    assert {op.path for op in rep.plan.ops} == {"cuda"}


def _decode_case(b, lq, lk, h, hd, dtype, seed, q_scale=1.0):
    g = _gen(seed)
    mk = lambda l: torch.randn((b, l, h, hd), device="cuda", generator=g)
    q = (mk(lq) * q_scale).to(dtype)
    return q, mk(lk).to(dtype), mk(lk).to(dtype)


def _decode_check(q, k, v, causal):
    """The decode kernel (block_q = 1) at every block_k of the set: one
    launch per call, the input dtype out, within the executor's attention
    tolerance (2e-3) of the oracle."""
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref
    ref = attention_ref(q, k, v, causal=causal)
    for bk in kernel.BK_TILES:
        before = kernel.launches
        out = kernel.flash_attention_blhd(q, k, v, causal=causal,
                                          block_q=1, block_k=bk)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert out.dtype == q.dtype and out.shape == q.shape
        assert bool(torch.isfinite(out).all()), bk
        rel = (out.double() - ref.double()).norm() / ref.double().norm()
        assert rel <= 2e-3, (bk, float(rel))


@pytest.mark.parametrize("lk", [1, 3, 7, 33, 511, 512, 513])
@pytest.mark.parametrize("hd", [8, 16, 64, 100, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel_lengths_and_head_dims(cuda, lk, hd, dtype):
    """Caches shorter than a chunk per warp (Lk = 1, 3: warps with no key),
    ragged tails, and head dims that leave lanes without a column."""
    q, k, v = _decode_case(2, 1, lk, 3, hd, getattr(torch, dtype), 7)
    _decode_check(q, k, v, causal=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel_path_a_shape(cuda, dtype):
    """glm4-9b decode_32k's attention step (b 128, Lk 512, 32 heads of 128)
    with only b cut, to 8."""
    q, k, v = _decode_case(8, 1, 512, 32, 128, getattr(torch, dtype), 8)
    _decode_check(q, k, v, causal=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel_causal_rows(cuda, dtype):
    """block_q = 1 over Lq = 17 causal rows: row 0 sees one key, so three
    warps of its CTA see none; later rows stop mid-chunk."""
    q, k, v = _decode_case(2, 17, 17, 2, 64, getattr(torch, dtype), 9)
    _decode_check(q, k, v, causal=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel_large_scores(cuda, dtype):
    """q scaled by 30: scores far apart, so each warp's max differs and the
    cross-warp merge decides the result."""
    q, k, v = _decode_case(4, 1, 512, 4, 128, getattr(torch, dtype), 10,
                           q_scale=30.0)
    _decode_check(q, k, v, causal=False)


@pytest.mark.parametrize("offset_bytes", [1, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel_misaligned_views(cuda, offset_bytes, dtype):
    """Contiguous views that start off a 16-byte boundary, 1 and 8 bytes
    in (1 byte rounds up to one element, the smallest offset a float32 or
    bfloat16 view can have). Off its vector's alignment (16 bytes in
    float32, 8 in bfloat16) the kernel must take its masked scalar loads,
    not fault; a bfloat16 view 8 bytes in keeps the vector loads."""
    dt = getattr(torch, dtype)
    el = torch.tensor([], dtype=dt).element_size()
    off = max(offset_bytes, el) // el
    b, lk, h, hd = 2, 100, 3, 64
    g = _gen(11)
    view = lambda l: torch.randn((off + b * l * h * hd,), device=cuda,
                                 generator=g).to(dt)[off:].view(b, l, h, hd)
    q, k, v = view(1), view(lk), view(lk)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    _decode_check(q, k, v, causal=False)


def test_flash_smem_bytes_match_the_launch(cuda):
    """`kernel.smem_bytes` is what every launch of the tile set passes
    (static plus dynamic shared memory, as the CUDA runtime reports it),
    and the card can hold at least one CTA of each."""
    from repro_torch.kernels.flash_attention import kernel
    for dt, el in ((torch.float32, 4), (torch.bfloat16, 2)):
        for bq in kernel.BQ_TILES:
            for bk in kernel.BK_TILES:
                for hd in (8, 64, 100, 128):
                    occ = kernel.occupancy(bq, bk, hd, dt)
                    assert occ["smem_bytes"] == \
                        kernel.smem_bytes(bq, bk, hd, el), (bq, bk, hd, dt)
                    assert occ["ctas_per_sm"] >= 1 and occ["regs"] > 0


def _prefill_case(b, lq, lk, h, hd, dtype, seed, q_scale=1.0):
    g = _gen(seed)
    mk = lambda l: torch.randn((b, l, h, hd), device="cuda", generator=g)
    q = (mk(lq) * q_scale).to(dtype)
    return q, mk(lk).to(dtype), mk(lk).to(dtype)


def _prefill_check(q, k, v, causal, tiles=None):
    """The prefill kernel at every (block_q >= 16, block_k) of the set (or
    ``tiles``): one launch per call, the input dtype out, finite, within
    1e-3 of the oracle (half the executor's attention tolerance, the
    design's contract: 3xTF32 q.K^T in float32, hi/lo P in bfloat16)."""
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref
    ref = attention_ref(q, k, v, causal=causal)
    tiles = tiles or [(bq, bk) for bq in kernel.BQ_TILES if bq > 1
                      for bk in kernel.BK_TILES]
    for bq, bk in tiles:
        before = kernel.launches
        out = kernel.flash_attention_blhd(q, k, v, causal=causal,
                                          block_q=bq, block_k=bk)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert out.dtype == q.dtype and out.shape == q.shape
        assert bool(torch.isfinite(out).all()), (bq, bk)
        rel = (out.double() - ref.double()).norm() / ref.double().norm()
        assert rel <= 1e-3, (bq, bk, float(rel))


@pytest.mark.parametrize("bq", [16, 32, 64])
@pytest.mark.parametrize("bk", [32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_prefill_kernel_every_tile(cuda, bq, bk, dtype):
    """Each (block_q, block_k) of the prefill set, causal and not, at
    lengths no tile divides."""
    q, k, v = _prefill_case(2, 200, 200, 3, 64, getattr(torch, dtype), 20)
    for causal in (True, False):
        _prefill_check(q, k, v, causal, tiles=[(bq, bk)])


@pytest.mark.parametrize("lq,lk,causal", [(131, 131, True), (77, 300, False),
                                          (300, 77, False), (1, 40, True),
                                          (300, 77, True), (5, 5, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_prefill_kernel_ragged_lengths(cuda, lq, lk, causal, dtype):
    """Ragged Lq and Lk, Lq != Lk both ways, and lengths under one tile."""
    q, k, v = _prefill_case(1, lq, lk, 2, 64, getattr(torch, dtype), 21)
    _prefill_check(q, k, v, causal)


@pytest.mark.parametrize("hd", [8, 16, 64, 100, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_prefill_kernel_head_dims(cuda, hd, dtype):
    """Head dims padded with zeros up to the MMA's k and the 64 / 128
    instance; bfloat16 hd 100 (200-byte rows) takes the masked loads."""
    q, k, v = _prefill_case(2, 96, 96, 3, hd, getattr(torch, dtype), 22)
    _prefill_check(q, k, v, causal=True)


@pytest.mark.parametrize("offset_bytes", [1, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_prefill_kernel_misaligned_views(cuda, offset_bytes, dtype):
    """Contiguous views that start off a 16-byte boundary (1 byte rounds
    up to one element): the prefill kernel must take its masked loads, not
    fault on a misaligned cp.async."""
    dt = getattr(torch, dtype)
    el = torch.tensor([], dtype=dt).element_size()
    off = max(offset_bytes, el) // el
    b, l, h, hd = 2, 100, 3, 64
    g = _gen(23)
    view = lambda: torch.randn((off + b * l * h * hd,), device=cuda,
                               generator=g).to(dt)[off:].view(b, l, h, hd)
    q, k, v = view(), view(), view()
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    _prefill_check(q, k, v, causal=True)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_prefill_kernel_large_scores(cuda, causal, dtype):
    """q scaled by 30: scores far apart, where single-pass TF32 q.K^T would
    miss 1e-3; causal row 0 sees one key and every later tile of a warp's
    first rows is masked, with no NaN."""
    q, k, v = _prefill_case(2, 160, 160, 4, 128, getattr(torch, dtype), 24,
                            q_scale=30.0)
    _prefill_check(q, k, v, causal)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_prefill_kernel_path_c_shape(cuda, dtype):
    """minicpm-2b exec_prefill's attention op (1, 512, 36 heads of 64,
    causal) at every tile."""
    q, k, v = _prefill_case(1, 512, 512, 36, 64, getattr(torch, dtype), 25)
    _prefill_check(q, k, v, causal=True)


# ---------------------------------------------------------------------------
# The live model (`repro_torch.models`) driving the kernels on the card
# ---------------------------------------------------------------------------

def _reduced_model(cuda, arch, seed=0):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    cfg = get_config(arch).reduced()
    return cfg, init_model(cfg, _gen(seed), torch.float32, cuda)


def _prefill(cfg, model, tokens, use_flash):
    from repro_torch.train.steps import StepConfig, make_prefill_step
    return make_prefill_step(cfg, StepConfig(
        use_flash=use_flash, compute_dtype=torch.float32))(
            model, {"tokens": tokens})


def test_model_prefill_flash_vs_plain(cuda):
    """Reduced-width glm4-9b, 2 prompts of 512 tokens (the shortest
    causal prefill on the flash branch): the prefill with use_flash=True
    (each layer's attention on the kernel) against use_flash=False (all
    plain PyTorch) on the same weights. Last-token logits within
    flash_attention's NUMERICS_TOL (2e-3 relative); the first layer's K
    and V are made before any attention, so they are equal."""
    from repro_torch.core.executor import NUMERICS_TOL
    cfg, model = _reduced_model(cuda, "glm4-9b")
    tokens = torch.randint(0, cfg.vocab_size, (2, 512), device=cuda,
                           generator=_gen(1))
    lf, cf = _prefill(cfg, model, tokens, True)
    lp, cp = _prefill(cfg, model, tokens, False)
    assert torch.isfinite(lf).all() and lf.shape == lp.shape
    rel = float((lf.double() - lp.double()).norm() / lp.double().norm())
    assert rel <= NUMERICS_TOL["flash_attention"], rel
    assert torch.equal(cf.k[0], cp.k[0]) and torch.equal(cf.v[0], cp.v[0])
    assert torch.equal(cf.length, cp.length)


def test_forward_launches_flash_once_per_layer(cuda):
    """On CUDA tensors a causal prefill of L >= 512 launches
    flash_attention once per layer; L 511 and a decode step launch it
    never."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models import transformer
    cfg, model = _reduced_model(cuda, "glm4-9b", seed=2)
    launches = []
    for l in (512, 511):
        tokens = torch.randint(0, cfg.vocab_size, (1, l), device=cuda,
                               generator=_gen(3))
        before = fa_kernel.launches
        out = transformer.forward(model, cfg, tokens, mode="prefill",
                                  use_flash=True,
                                  compute_dtype=torch.float32)
        launches.append(fa_kernel.launches - before)
    before = fa_kernel.launches
    transformer.forward(model, cfg, tokens[:, :1], mode="decode",
                        caches=out.caches, use_flash=True,
                        compute_dtype=torch.float32)
    launches.append(fa_kernel.launches - before)
    assert launches == [cfg.n_layers, 0, 0]


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("chunk", [32, 256])
def test_ssd_chunked_kernel_vs_plain(cuda, groups, chunk):
    """``models.ssm.ssd_chunked(use_kernel=True)`` (the intra-chunk product
    on ssd_scan, one launch) against ``use_kernel=False`` on the card,
    within NUMERICS_TOL["ssd_scan"] (2e-3 relative); with 2 groups the
    B and C operands are repeated over the heads of each group before the
    kernel reads them. The final state does not pass through the kernel."""
    from repro_torch.core.executor import NUMERICS_TOL
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.models.ssm import ssd_chunked
    b, l, h, p, n = 2, 512, 4, 32, 64
    g = _gen(4 + groups)
    x = torch.randn((b, l, h, p), device=cuda, generator=g)
    dt = 0.001 + 0.199 * torch.rand((b, l, h), device=cuda, generator=g)
    a = -(0.5 + 3.5 * torch.rand((h,), device=cuda, generator=g))
    bm = torch.randn((b, l, groups, n), device=cuda, generator=g)
    cm = torch.randn((b, l, groups, n), device=cuda, generator=g)
    d = torch.randn((h,), device=cuda, generator=g)
    before = ssd_kernel.launches
    y1, h1 = ssd_chunked(x, dt, a, bm, cm, d, chunk=chunk, use_kernel=True)
    assert ssd_kernel.launches - before == 1
    y0, h0 = ssd_chunked(x, dt, a, bm, cm, d, chunk=chunk, use_kernel=False)
    rel = float((y1.double() - y0.double()).norm() / y0.double().norm())
    assert torch.isfinite(y1).all()
    assert rel <= NUMERICS_TOL["ssd_scan"], rel
    assert torch.equal(h1, h0)


#: The other families, reduced but served a 512-token prompt (the vlm's 8
#: stub patch positions in front of it) so that the prefill reaches
#: flash_attention: (arch, n_layers or None for the reduced count,
#: flash_attention launches a prefill). zamba2 at 5 layers is 2 groups
#: of 2 Mamba2 blocks and a tail of 1: one launch a group.
FAMILIES = (("qwen2-moe-a2.7b", None, 2), ("arctic-480b", None, 2),
            ("pixtral-12b", None, 2), ("zamba2-1.2b", 5, 2),
            ("seamless-m4t-large-v2", None, 2))


@pytest.mark.parametrize("arch,layers,want", FAMILIES)
def test_family_prefill_flash_vs_plain_and_greedy(cuda, arch, layers, want):
    """Each family's prefill with use_flash=True launches flash_attention
    ``want`` times, and decode steps never; its last-token logits lie
    within flash_attention's NUMERICS_TOL (2e-3 relative) of the
    use_flash=False prefill on the same weights, tokens and frontend
    embeddings; 4 greedy decode steps from both give the same tokens."""
    import dataclasses

    from repro_torch import serve_lm
    from repro_torch.configs import get_config
    from repro_torch.core.executor import NUMERICS_TOL
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models.transformer import init_model
    from repro_torch.train.steps import StepConfig, make_decode_step, \
        make_prefill_step
    cfg = get_config(arch).reduced()
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    g = _gen(7)
    model = init_model(cfg, g, torch.float32, cuda)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 512),
                                     device=cuda, generator=g)}
    if cfg.family in ("vlm", "encdec"):
        batch["frontend"] = torch.randn((2, cfg.frontend_seq, cfg.d_model),
                                        device=cuda, generator=g)
    max_seq = 512 + 4 + (cfg.frontend_seq if cfg.family == "vlm" else 0)
    tokens, last = {}, {}
    for use_flash in (True, False):
        step_cfg = StepConfig(use_flash=use_flash,
                              compute_dtype=torch.float32)
        before = fa_kernel.launches
        logits, caches = make_prefill_step(cfg, step_cfg)(model, batch)
        assert fa_kernel.launches - before == (want if use_flash else 0)
        last[use_flash] = logits
        caches = serve_lm.pad_caches(caches, max_seq, cfg.family)
        decode = make_decode_step(cfg, step_cfg)
        toks = [logits.argmax(-1)[:, None]]
        before = fa_kernel.launches
        for _ in range(4):
            logits, caches = decode(model, {"tokens": toks[-1]}, caches)
            toks.append(logits.argmax(-1)[:, None])
        assert fa_kernel.launches == before
        tokens[use_flash] = torch.cat(toks, 1)
    lf, lp = last[True], last[False]
    assert torch.isfinite(lf).all() and lf.shape == lp.shape
    rel = float((lf.double() - lp.double()).norm() / lp.double().norm())
    assert rel <= NUMERICS_TOL["flash_attention"], rel
    assert torch.equal(tokens[True], tokens[False])


# ---------------------------------------------------------------------------
# The train step on the card (`repro_torch.train`)
# ---------------------------------------------------------------------------

#: lr 1e-3 under a 4-step warmup: 2.5e-4 at the first step.
TRAIN_OPT = dict(lr=1e-3, warmup_steps=4, total_steps=20, schedule="wsd")


def _train_pair(cuda, arch, seq, seed=11):
    """The reduced ``arch`` drawn on the host and copied to the card, and
    a batch of 2 x ``seq`` tokens with next-token labels (and frontend
    embeddings where the family takes them): (cfg, host model, card
    model, host batch, card batch)."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    cfg = get_config(arch).reduced()
    g = torch.Generator().manual_seed(seed)
    host = init_model(cfg, g, torch.float32)
    card = copy.deepcopy(host).to(cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, seq), generator=g)
    batch = {"tokens": toks, "labels": torch.cat(
        [toks[:, 1:], torch.full((2, 1), -1)], dim=1)}
    if cfg.family in ("vlm", "encdec"):
        batch["frontend"] = torch.randn((2, cfg.frontend_seq, cfg.d_model),
                                        generator=g)
    return cfg, host, card, batch, {k: v.to(cuda) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["glm4-9b", "qwen2-moe-a2.7b",
                                  "zamba2-1.2b"])
def test_train_step_card_vs_host(cuda, arch):
    """One float32 train step on the card against the same step on the
    host from the same weights and batch: loss and grad norm within
    1e-4 relative; m and v within 1e-4 of their leaf's largest entry;
    each weight within lr * 1e-3 (plus 2 ulp) where its gradient is
    above 1e-6, else within 2 * lr (a first Adam step moves a weight by
    about lr * sign(g), and a near-zero gradient's sign is not
    stable); and no kernel launched."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.matmul_int8 import kernel as mm_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.train import optimizer, steps
    cfg, host, card, hb, cb = _train_pair(cuda, arch, 32)
    opt = optimizer.OptimizerConfig(**TRAIN_OPT)
    sc = steps.StepConfig(compute_dtype=torch.float32)
    states = {}
    before = [m.launches for m in (fa_kernel, mm_kernel, ssd_kernel)]
    for name, model, batch in (("host", host, hb), ("card", card, cb)):
        params = dict(model.named_parameters())
        st = steps.TrainState(model, optimizer.init_adamw(params), None, 0)
        states[name] = steps.make_train_step(cfg, opt, sc)(st, batch)
    assert [m.launches for m in (fa_kernel, mm_kernel, ssd_kernel)] == before
    (hs, hm), (cs, cm) = states["host"], states["card"]
    for key in ("loss", "grad_norm", "aux_loss"):
        assert float(cm[key]) == pytest.approx(float(hm[key]), rel=1e-4,
                                               abs=1e-6), key
    lr = float(hm["lr"])
    b1 = opt.betas[0]
    for name, p in hs.params.named_parameters():
        got = dict(cs.params.named_parameters())[name].cpu()
        for ours, theirs in ((cs.opt.m[name].cpu(), hs.opt.m[name]),
                             (cs.opt.v[name].cpu(), hs.opt.v[name])):
            top = float(theirs.abs().max())
            assert float((ours - theirs).abs().max()) <= 1e-4 * top, name
        g = hs.opt.m[name] / (1 - b1)
        tight = lr * 1e-3 + 2 * torch.finfo(torch.float32).eps * p.abs()
        allowed = torch.where(g.abs() > 1e-6, tight,
                              torch.full_like(p, 2 * lr * (1 + 1e-3)))
        assert bool(((got - p).abs() <= allowed).all()), name


def test_train_step_microbatches_on_the_card(cuda):
    """On the card, 2 microbatches give the one-batch loss and gradients
    within 1e-5 of the largest gradient of each leaf."""
    from repro_torch.train import steps
    cfg, _, card, _, cb = _train_pair(cuda, "glm4-9b", 32, seed=12)
    out = {mb: steps.loss_and_grads(card, cfg, steps.StepConfig(
        compute_dtype=torch.float32, microbatches=mb), cb) for mb in (1, 2)}
    assert float(out[2][1]) == pytest.approx(float(out[1][1]), rel=1e-5)
    for name, g in out[1][0].items():
        err = float((out[2][0][name] - g).abs().max())
        assert err <= 1e-5 * float(g.abs().max()) + 1e-12, name


def test_compression_card_vs_host_bit_equal(cuda):
    """The int8 compression with error feedback on the card gives the
    host's codes, decompressed gradients and residuals bit for bit (the
    scale is a correctly rounded division, the codes round half to even
    on both), over two steps, with layers grouped into stacked leaves."""
    from repro_torch.runtime.compression import \
        compress_grads_with_feedback, init_residuals
    g = torch.Generator().manual_seed(13)
    shapes = {"blocks.0.w": (64, 96), "blocks.1.w": (64, 96),
              "ln_f.scale": (96,), "embed.table": (300, 64)}
    host_res = init_residuals({k: torch.empty(s) for k, s in shapes.items()})
    card_res = {k: v.to(cuda) for k, v in host_res.items()}
    for step in range(2):
        grads = {k: torch.randn(s, generator=g) * 10.0 ** (step - 3)
                 for k, s in shapes.items()}
        h_out, host_res = compress_grads_with_feedback(grads, host_res)
        c_out, card_res = compress_grads_with_feedback(
            {k: v.to(cuda) for k, v in grads.items()}, card_res)
        for k in shapes:
            assert torch.equal(c_out[k].cpu(), h_out[k]), k
            assert torch.equal(card_res[k].cpu(), host_res[k]), k


def _card_state(cuda, seed):
    """A reduced minicpm-2b TrainState on the card with residuals and
    every moment and residual filled with its own numbers."""
    from repro_torch.configs import get_config
    from repro_torch.train import steps
    cfg = get_config("minicpm-2b").reduced()
    st = steps.init_train_state(seed, cfg, steps.StepConfig(
        compute_dtype=torch.float32, compress_pod_grads=True), device=cuda)
    g = _gen(seed)
    with torch.no_grad():
        for tree in (st.opt.m, st.opt.v, st.residuals):
            for t in tree.values():
                t.copy_(torch.randn(t.shape, device=cuda, generator=g))
        st.opt.step.fill_(seed)
    return cfg, st


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """Path K's checkpoint on the card: a TrainState saved leaf by leaf
    from the card equals the file (`differing_leaves`), and loads into
    another state on the card in place, every tensor bit-equal and still
    on the card, the seed read back."""
    from repro_torch.checkpoint import checkpoint as ckpt
    _, st = _card_state(cuda, 3)
    ckpt.save_checkpoint(str(tmp_path), 3, st)
    assert ckpt.differing_leaves(str(tmp_path), st, 3) == []
    _, other = _card_state(cuda, 4)
    assert ckpt.differing_leaves(str(tmp_path), other, 3)
    got, step, _ = ckpt.load_checkpoint(str(tmp_path), other)
    assert step == 3 and got.rng == 3 and got.params is other.params
    assert int(got.opt.step) == 3
    pairs = [(st.params.named_parameters(), got.params.named_parameters())]
    pairs += [(getattr(st.opt, k).items(), getattr(got.opt, k).items())
              for k in ("m", "v")]
    pairs.append((st.residuals.items(), got.residuals.items()))
    for want, have in pairs:
        for (n, a), (_, b) in zip(want, have):
            assert b.device.type == "cuda" and torch.equal(a, b), n


def test_train_lm_restart_on_card(cuda, tmp_path, capsys):
    """Path K at reduced widths: ``train_lm`` on the card through a
    restart; the resumed run's first loss is the train step's loss of
    the replayed batch on the saved state."""
    from repro_torch import train_lm
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.train import steps
    base = ["--reduced", "--batch", "4", "--seq", "32", "--ckpt-dir",
            str(tmp_path)]
    losses1, state = train_lm.run(base + ["--steps", "4", "--ckpt-every",
                                          "3"])
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert ckpt.differing_leaves(str(tmp_path), state, 3) == []
    args = train_lm.build_parser().parse_args(base + ["--steps", "6"])
    cfg, _, step_cfg, data = train_lm.configure(args)
    _, l_star, _ = steps.loss_and_grads(
        state.params, cfg, step_cfg, train_lm.to_device(data.batch(3), cuda))
    del state
    losses2, state = train_lm.run(base + ["--steps", "6", "--ckpt-every",
                                          "100"])
    assert "[restore] resumed from step 3" in capsys.readouterr().out
    assert len(losses2) == 3 and int(state.opt.step) == 7
    assert losses2[0] == pytest.approx(float(l_star), rel=1e-6, abs=0)


@pytest.mark.parametrize("ungated", [False, True])
def test_batched_scorer_torch_backend_on_card(cuda, ungated):
    """The batched scorer's torch backend on the card (float64, eager, no
    fused ops) is bit-equal to the NumPy loop on a pool of raw samples,
    gated (mostly inf) and ungated (the recursion on every row)."""
    import numpy as np

    from repro_torch.core import baselines
    from repro_torch.core import latency_batched as lb
    from repro_torch.core import workload as wl
    from repro_torch.core.arch import default_arch
    layer, arch = wl.gemm("card.lb", 32, 512, 512), default_arch(
        n_cores=2, macro_rows=64, macro_cols=16, gbuf_kb=2.0, lbuf_kb=8.0,
        name="lb-tiny")
    pool = baselines.candidate_pool(layer, arch, budget=4096, seed=3)
    need = ("latency", "energy", "ideal") if ungated else lb.ALL_NEEDS
    pb = lb.pack(pool, layer, arch, need=need)
    host = lb.evaluate_batch(pb, backend="numpy")
    card = lb.evaluate_batch(pb, backend="torch", device="cuda")
    for f in ("cycles", "energy_pj", "edp", "idealized", "feasible"):
        a, b = getattr(host, f), getattr(card, f)
        assert (a is None and b is None) or (
            a.dtype == b.dtype and np.array_equal(a, b)), f
    if ungated:
        assert np.isfinite(card.cycles).all()


@pytest.mark.parametrize("m,k,n", [(128, 4096, 4096), (1, 4096, 1000),
                                   (100, 200, 360), (130, 24, 1000),
                                   (257, 1000, 65)])
def test_matmul_int8_at_bridge_mip_picks(cuda, m, k, n):
    """matmul_int8 at `gpu_bridge.select_matmul_blocks`' pick: bit-equal
    to the plain version at unit scales, within NUMERICS_TOL scaled."""
    from repro_torch.core.executor import NUMERICS_TOL
    from repro_torch.core.gpu_bridge import select_matmul_blocks
    from repro_torch.kernels.matmul_int8 import kernel
    from repro_torch.kernels.matmul_int8.ref import matmul_int8_ref
    c = select_matmul_blocks(m, k, n)
    assert c.status != "fallback"
    g = _gen(7)
    x = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=cuda,
                      generator=g)
    w = torch.randint(-127, 128, (k, n), dtype=torch.int8, device=cuda,
                      generator=g)
    ones_m, ones_n = torch.ones(m, device=cuda), torch.ones(n, device=cuda)
    run = lambda a, b: kernel.matmul_int8(x, w, a, b, bm=c.bm, bk=c.bk,
                                          bn=c.bn, out_dtype=torch.float32)
    assert torch.equal(run(ones_m, ones_n),
                       matmul_int8_ref(x, w, ones_m, ones_n, torch.float32))
    xs = torch.rand(m, device=cuda, generator=g) / 127
    ws = torch.rand(n, device=cuda, generator=g) / 127
    out, ref = run(xs, ws).double(), matmul_int8_ref(
        x, w, xs, ws, torch.float32).double()
    assert float((out - ref).norm() / ref.norm()) <= \
        NUMERICS_TOL["matmul_int8"]
