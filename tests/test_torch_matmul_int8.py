"""The matmul_int8 wrapper's split-K rule (`kernel.split_k`) and its
argument checks, on the CPU. The kernel itself is held against its plain
version on the card in `tests/test_torch_cuda.py`."""

import itertools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.matmul_int8 import kernel as mm_kernel
from repro_torch.kernels.matmul_int8.ref import matmul_int8_ref

H100_SMS = 132


@pytest.mark.parametrize("m,k,n,want", [
    (128, 4096, 4096, 4),      # wq / wo: 32 tiles
    (128, 4096, 256, 16),      # wk / wv: 2 tiles, 2 of 32 K steps each
    (128, 4096, 27392, 1),     # ffn_up: 214 tiles fill the card
    (128, 13696, 4096, 4),     # ffn_down: 32 tiles, 107 K steps
    (128, 4096, 151552, 1)])   # lm_head: 1,184 tiles
def test_split_k_at_path_a_shapes(m, k, n, want):
    """glm4-9b decode_32k's GEMMs at the blocks its plan runs (128^3) on
    an H100's 132 SMs."""
    assert mm_kernel.split_k(m, n, k, 128, 128, 128, H100_SMS) == want


DIMS_M = (1, 16, 100, 128, 4096, 32768)
DIMS_K = (1, 24, 128, 4120, 13696)
DIMS_N = (1, 256, 4096, 151552)


@pytest.mark.parametrize("sms", [1, 8, H100_SMS])
def test_split_k_bounds(sms):
    """1 <= split <= ceil(K / bk); 1 once the tiles give every SM one; a
    split grid never holds more CTAs than there are SMs; a split never
    loads fewer operand bytes than the int32 partial it writes; and one
    split more would break one of those."""
    for m, k, n in itertools.product(DIMS_M, DIMS_K, DIMS_N):
        for bm, bk, bn in itertools.product(mm_kernel.BM_TILES,
                                            mm_kernel.BK_TILES,
                                            mm_kernel.BN_TILES):
            s = mm_kernel.split_k(m, n, k, bm, bk, bn, sms)
            tiles = -(-m // bm) * -(-n // bn)
            steps = -(-k // bk)
            case = (m, k, n, bm, bk, bn, sms, s)
            assert 1 <= s <= steps, case
            if tiles >= sms:
                assert s == 1, case
                continue
            assert tiles * s <= sms, case
            loads = lambda splits: (steps // splits) * bk * (bm + bn)
            assert s == 1 or loads(s) >= 4 * bm * bn, case
            assert tiles * (s + 1) > sms or s + 1 > steps or \
                loads(s + 1) < 4 * bm * bn, case


def test_matmul_wrapper_rejects_split_outside_k_steps():
    x = torch.zeros((16, 100), dtype=torch.int8)
    w = torch.zeros((100, 32), dtype=torch.int8)
    sm, sn = torch.ones(16), torch.ones(32)
    for bad in (0, -1, 5):                 # ceil(100 / 32) = 4 K steps
        with pytest.raises(ValueError, match="split_k"):
            mm_kernel.matmul_int8(x, w, sm, sn, bm=16, bk=32, bn=32,
                                  split_k=bad)


def test_matmul_wrapper_cpu_split_is_plain():
    """On CPU tensors any legal split takes the plain version, uncounted."""
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-127, 128, (5, 70), dtype=torch.int8, generator=g)
    w = torch.randint(-127, 128, (70, 9), dtype=torch.int8, generator=g)
    sm, sn = torch.rand(5, generator=g), torch.rand(9, generator=g)
    want = matmul_int8_ref(x, w, sm, sn, torch.float32)
    before = mm_kernel.launches
    for split in (None, 1, 2, 3):
        out = mm_kernel.matmul_int8(x, w, sm, sn, bm=16, bk=32, bn=32,
                                    out_dtype=torch.float32, split_k=split)
        assert torch.equal(out, want)
    assert mm_kernel.launches == before
