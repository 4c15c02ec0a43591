"""The port's GPU bridge (`repro_torch/core/gpu_bridge.py`): blocks derived
from solved mappings are legal for the CUDA kernels — in their tile sets,
within the executor's block cap, and within one CTA's shared memory times
the kernel's stage count (eq. 9)."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import workload as wl
from repro_torch.core.arch import default_arch
from repro_torch.core.baselines import greedy_mapping
from repro_torch.core.executor import EXEC_BLOCK_CAP
from repro_torch.core.frontend import extract_workload
from repro_torch.core.gpu_bridge import (SMEM_BYTES, device_smem_bytes,
                                         select_blocks_from_mapping,
                                         select_flash_blocks)
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.matmul_int8 import kernel as mm_kernel

ARCH = default_arch()
DECODE = ShapeSpec("t_decode", seq_len=64, global_batch=4, kind="decode")
PREFILL = ShapeSpec("t_prefill", seq_len=64, global_batch=1, kind="prefill")


def _zoo_gemms():
    seen, out = set(), []
    for aid in ARCH_IDS:
        cfg = get_config(aid).reduced()
        for spec in (DECODE, PREFILL):
            for layer in extract_workload(cfg, spec).layers:
                key = (layer.bound("N"), layer.bound("C"), layer.bound("K"))
                if layer.is_gemm and key not in seen:
                    seen.add(key)
                    out.append(layer)
    return out


def test_mapped_blocks_legal_across_reduced_zoo():
    layers = _zoo_gemms()
    assert len(layers) >= 10
    for layer in layers:
        bm, bk, bn = select_blocks_from_mapping(
            greedy_mapping(layer, ARCH), layer, ARCH, cap=EXEC_BLOCK_CAP)
        assert bm in mm_kernel.BM_TILES, (layer.name, bm)
        assert bk in mm_kernel.BK_TILES, (layer.name, bk)
        assert bn in mm_kernel.BN_TILES, (layer.name, bn)
        assert max(bm, bk, bn) <= EXEC_BLOCK_CAP
        assert mm_kernel.STAGES * mm_kernel.smem_bytes(bm, bk, bn) <= \
            min(SMEM_BYTES, mm_kernel.SMEM_LIMIT)


def test_mapped_blocks_shrink_to_fit_a_small_budget():
    """eq. 9: a shared-memory budget below the snapped tile's need halves
    the blocks (largest first) until stages x bytes fit."""
    layer = wl.gemm("t.g", 128, 4096, 4096)
    mp = greedy_mapping(layer, ARCH)
    big = select_blocks_from_mapping(mp, layer, ARCH)
    budget = mm_kernel.smem_bytes(*big) // 2
    small = select_blocks_from_mapping(mp, layer, ARCH, smem_bytes=budget)
    assert mm_kernel.STAGES * mm_kernel.smem_bytes(*small) <= budget
    assert small != big


def test_mapped_blocks_do_not_exceed_the_dims_needlessly():
    """A block past the smallest tile that covers its dim only adds masked
    work, so small dims keep small blocks whatever the mapping asks."""
    for m, n, k in [(8, 24, 72), (96, 360, 200), (1, 1, 1), (20, 40, 40)]:
        layer = wl.gemm("t.g", m, n, k)         # (m x k) @ (k x n)
        bm, bk, bn = select_blocks_from_mapping(
            greedy_mapping(layer, ARCH), layer, ARCH)
        for b, d, tiles in ((bm, m, mm_kernel.BM_TILES),
                            (bk, k, mm_kernel.BK_TILES),
                            (bn, n, mm_kernel.BN_TILES)):
            assert b <= min([t for t in tiles if t >= d] or [max(tiles)])


@pytest.mark.parametrize("lq,lk,hd,bytes_el", [
    (1, 512, 128, 4), (1, 512, 128, 2), (1, 64, 64, 4), (512, 512, 64, 4),
    (264, 264, 16, 4), (4096, 4096, 128, 2), (1, 8, 128, 4)])
def test_flash_blocks_fit(lq, lk, hd, bytes_el):
    bq, bk = select_flash_blocks(lq, lk, hd, bytes_el=bytes_el)
    assert bq in fa_kernel.BQ_TILES and bk in fa_kernel.BK_TILES
    assert fa_kernel.STAGES * fa_kernel.smem_bytes(bq, bk, hd, bytes_el) \
        <= SMEM_BYTES
    if lq == 1:
        assert bq == 1                   # decode wastes no query rows


def test_flash_blocks_count_the_dtype():
    """f32 K/V tiles take twice the bytes of bf16 ones, so a budget that
    holds the bf16 pick must not hold it in f32."""
    bf16 = select_flash_blocks(1, 512, 128, bytes_el=2)
    need = fa_kernel.smem_bytes(*bf16, 128, 2)
    f32 = select_flash_blocks(1, 512, 128, bytes_el=4, smem_bytes=need)
    assert fa_kernel.smem_bytes(*f32, 128, 4) <= need
    assert f32 != bf16


def test_flash_blocks_reject_head_dim_past_kernel():
    with pytest.raises(ValueError, match="head dim"):
        select_flash_blocks(1, 512, 256)


def test_device_smem_bytes_defaults_to_h100_without_cuda():
    if torch.cuda.is_available():
        assert device_smem_bytes() >= 48 * 1024
    else:
        assert device_smem_bytes() == SMEM_BYTES == 232_448
