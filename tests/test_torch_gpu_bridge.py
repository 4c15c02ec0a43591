"""The port's GPU bridge (`repro_torch/core/gpu_bridge.py`): blocks derived
from solved mappings are legal for the CUDA kernels — in their tile sets,
within the executor's block cap, and within one CTA's shared memory times
the kernel's stage count (eq. 9)."""

import itertools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import workload as wl
from repro_torch.core.arch import default_arch
from repro_torch.core.baselines import greedy_mapping
from repro_torch.core.executor import EXEC_BLOCK_CAP
from repro_torch.core.frontend import extract_workload
from repro_torch.core.gpu_bridge import (DECODE_BLOCK_K, SMEM_BYTES, SMS,
                                         device_smem_bytes, fit_blocks,
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
        assert mm_kernel.smem_bytes(bm, bk, bn) <= \
            min(SMEM_BYTES, mm_kernel.SMEM_LIMIT)


def test_mapped_blocks_shrink_to_fit_a_small_budget():
    """eq. 9: a shared-memory budget below the snapped tile's need halves
    the blocks (largest first) until the whole ring fits."""
    layer = wl.gemm("t.g", 128, 4096, 4096)
    mp = greedy_mapping(layer, ARCH)
    big = select_blocks_from_mapping(mp, layer, ARCH)
    budget = mm_kernel.smem_bytes(*big) // 2
    small = select_blocks_from_mapping(mp, layer, ARCH, smem_bytes=budget)
    assert mm_kernel.smem_bytes(*small) <= budget
    assert small != big


def test_every_matmul_tile_fits_the_default_budget():
    """The kernel's whole ring (``smem_bytes``) fits the H100's opt-in
    shared memory at every tile of the set, 128^3 included, so eq. 9 halves
    nothing unless a caller asks for less."""
    budget = min(mm_kernel.SMEM_LIMIT, device_smem_bytes())
    for blocks in itertools.product(mm_kernel.BM_TILES, mm_kernel.BK_TILES,
                                    mm_kernel.BN_TILES):
        assert mm_kernel.smem_bytes(*blocks) <= \
            min(SMEM_BYTES, mm_kernel.SMEM_LIMIT), blocks
        assert fit_blocks(*blocks, budget) == blocks


# The blocks the MIREDO solves of the main paths chose on the card
# (chip_smoke.py's matmul rows): glm4-9b decode_32k (path A) and
# mamba2-1.3b prefill_32k (path B)
CHIP_RUN_BLOCKS = {"A every GEMM": (128, 128, 128),
                   "B in_proj, out_proj": (128, 128, 128),
                   "B ssd_s_chunk": (128, 64, 64),
                   "B ssd_y_inter": (128, 128, 64),
                   "B lm_head": (16, 128, 128)}


@pytest.mark.parametrize("blocks", CHIP_RUN_BLOCKS.values(),
                         ids=CHIP_RUN_BLOCKS)
def test_chip_run_blocks_fit_unhalved(blocks):
    """The five block tuples the card's MIREDO plans of paths A and B ran
    pass eq. 9 as they are: at the default budget none is halved."""
    budget = min(mm_kernel.SMEM_LIMIT, device_smem_bytes())
    assert mm_kernel.smem_bytes(*blocks) <= budget
    assert fit_blocks(*blocks, budget) == blocks


# Paths A and B of chip_smoke.py at their published widths
MAIN_PATHS = {"A": ("glm4-9b", "decode_32k"), "B": ("mamba2-1.3b",
                                                     "prefill_32k")}


@pytest.mark.parametrize("path", MAIN_PATHS)
def test_path_blocks_unchanged(path, monkeypatch):
    """Lowering path A's and path B's plans (greedy solves, so the test is
    deterministic) gives every matmul op the blocks its mapping snaps to
    before eq. 9: the bridge halves nothing, and each op's ring fits the
    default budget. Every GEMM of path A runs at 128^3."""
    from repro_torch.configs import SHAPES
    from repro_torch.core import gpu_bridge
    from repro_torch.core.cache import mapping_from_json
    from repro_torch.core.executor import lower_plan
    from repro_torch.core.network import optimize_network
    aid, shape = MAIN_PATHS[path]
    cfg, spec = get_config(aid), SHAPES[shape]
    work = extract_workload(cfg, spec)
    net = optimize_network(list(work.layers), ARCH, "greedy",
                           counts=list(work.counts), use_cache=False,
                           workers=1)
    budget = min(mm_kernel.SMEM_LIMIT, device_smem_bytes())
    ops = [op for op in lower_plan(cfg, spec, net, ARCH).ops
           if op.kernel == "matmul_int8"]
    assert ops
    # the blocks each mapping snaps to, with eq. 9's halving taken out
    monkeypatch.setattr(gpu_bridge, "fit_blocks", lambda *b: b[:3])
    for op in ops:
        lr = net.layers[op.layer_indices[0]]
        blocks = (op.spec["bm"], op.spec["bk"], op.spec["bn"])
        assert blocks == select_blocks_from_mapping(
            mapping_from_json(lr.record["mapping"]), lr.layer, ARCH,
            cap=EXEC_BLOCK_CAP), op.name
        assert mm_kernel.smem_bytes(*blocks) <= budget
        if path == "A":
            assert blocks == (128, 128, 128), op.name


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
    bq, bk = select_flash_blocks(lq, lk, hd, bytes_el=bytes_el,
                                 batch_heads=32, n_sms=SMS)
    assert bq in fa_kernel.BQ_TILES and bk in fa_kernel.BK_TILES
    assert fa_kernel.smem_bytes(bq, bk, hd, bytes_el) <= SMEM_BYTES
    if lq == 1:
        assert bq == 1                   # decode wastes no query rows


@pytest.mark.parametrize("lk,hd,bytes_el", [
    (512, 128, 4), (512, 128, 2), (256, 64, 4), (1, 8, 2), (4096, 100, 4)])
def test_flash_decode_pick_is_the_measured_rule(lk, hd, bytes_el):
    """A decode step (seq_q = 1) runs the decode kernel at the block_k
    measured fastest for its dtype (``DECODE_BLOCK_K``), whatever the
    cache length and head dim. Its CTA stages no K or V, so its shared
    memory is the merge's few KB, the same in float32 and bfloat16; a
    budget below that is refused."""
    bk = DECODE_BLOCK_K[bytes_el]
    assert bk in fa_kernel.BK_TILES
    assert select_flash_blocks(1, lk, hd, bytes_el=bytes_el) == (1, bk)
    need = fa_kernel.smem_bytes(1, bk, hd, bytes_el)
    assert need == fa_kernel.smem_bytes(1, bk, hd, 6 - bytes_el)
    assert need <= 4 * 1024
    assert select_flash_blocks(1, lk, hd, bytes_el=bytes_el,
                               smem_bytes=need) == (1, bk)
    with pytest.raises(ValueError, match="decode kernel"):
        select_flash_blocks(1, lk, hd, bytes_el=bytes_el,
                            smem_bytes=need - 1)


def test_flash_decode_pick_rejects_other_widths():
    with pytest.raises(ValueError, match="decode kernel"):
        select_flash_blocks(1, 512, 128, bytes_el=1)


@pytest.mark.parametrize("lq,lk,hd,bytes_el,bh,blocks", [
    (512, 512, 64, 4, 36, (64, 64)), (264, 264, 16, 4, 16, (64, 64)),
    (4096, 4096, 128, 2, 32, (64, 64)), (17, 17, 64, 4, 128, (32, 32)),
    (64, 64, 128, 2, 128, (64, 64))])
def test_flash_prefill_picks_the_measured_tile(lq, lk, hd, bytes_el, bh,
                                               blocks):
    """Prefill, given B * H (``bh``) and the H100's SMs, takes the fewest
    steps among tiles of bk <= 64: 64 x 64 from 33 rows on, the tile the
    chip's sweep measured fastest at L 4096 and L 264 (PERF.md's sweep
    table lists the cells where another tile beat it by 1-6 %); shorter
    prompts the least masked tile. These grids fill half the SMs."""
    assert select_flash_blocks(lq, lk, hd, bytes_el=bytes_el,
                               batch_heads=bh, n_sms=SMS) == blocks


def test_flash_blocks_reject_head_dim_past_kernel():
    with pytest.raises(ValueError, match="head dim"):
        select_flash_blocks(1, 512, 256)


def test_device_smem_bytes_defaults_to_h100_without_cuda():
    if torch.cuda.is_available():
        assert device_smem_bytes() >= 48 * 1024
    else:
        assert device_smem_bytes() == SMEM_BYTES == 232_448
