"""The bridge bench over the port: the bridge MIP's matmul_int8 tile
(`core.gpu_bridge.select_matmul_blocks`) for each arch's dominant
per-device GEMM, its shared-memory fit, the model's time at the pick
beside the largest tile's, and the flash_attention pick at 32k. The
counterpart of the reference's ``benchmarks/tpu_bridge_bench.py``, over
the H100's hierarchy in place of the TPU's VMEM.

    PYTHONPATH=src python -m repro_torch.gpu_bridge_bench --out DIR

Host only, as the reference's: it solves and prices, it launches nothing.
On a machine with a CUDA device the budgets are the card's own
(`gpu_bridge.device_smem_bytes`, `gpu_bridge.device_sms`), else the
H100's. The card's half is ``chip_smoke.py``'s path N, which runs
matmul_int8 at each pick and at every tile of the kernel's set. The record
goes to ``DIR/gpu_bridge.json`` and nowhere else.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.core import gpu_bridge
from repro_torch.kernels.matmul_int8 import kernel as mm_kernel

#: The largest tile of the kernel's set, the reference's "naive maximal
#: blocks".
LARGEST = (max(mm_kernel.BM_TILES), max(mm_kernel.BK_TILES),
           max(mm_kernel.BN_TILES))
#: The flash pick's cell: 32k queries and keys at head dim 128 in
#: bfloat16 (the reference's call), over ``prefill_32k``'s batch times
#: glm4-9b's query heads.
FLASH_SEQ, FLASH_HEAD_DIM, FLASH_BYTES_EL = 32768, 128, 2
FLASH_SHAPE, FLASH_ARCH = "prefill_32k", "glm4-9b"


def dominant_gemm(cfg) -> tuple[int, int, int]:
    """Per-device FFN up-projection GEMM under the production sharding
    (TP=16 on d_ff, tokens/device for train_4k), as the reference's."""
    tokens = 256 * 4096 // 16           # per data-rank
    ff = (cfg.moe_d_ff or cfg.d_ff or cfg.ssm_expand * cfg.d_model)
    return tokens, cfg.d_model, max(ff // 16, 128)


def bench_rows() -> list[dict]:
    """One row per arch of `ARCH_IDS`: its dominant GEMM, the MIP's pick
    with its status and solve seconds, the ring's shared memory and
    whether it fits the card's opt-in budget
    (`gpu_bridge.device_smem_bytes`), and the model's time
    (`gpu_bridge.matmul_seconds`) at the pick and at `LARGEST`."""
    budget = gpu_bridge.device_smem_bytes()
    rows = []
    for arch_id in ARCH_IDS:
        m, k, n = dominant_gemm(get_config(arch_id))
        t = time.perf_counter()
        c = gpu_bridge.select_matmul_blocks(m, k, n, smem_bytes=budget)
        solve_s = time.perf_counter() - t
        rows.append({
            "arch": arch_id, "gemm": [m, k, n], "pick": [c.bm, c.bk, c.bn],
            "buffering": "ring" if c.double_buffered else "single",
            "smem_bytes": c.smem_bytes, "fits": c.smem_bytes <= budget,
            "est_ms": c.est_seconds * 1e3,
            "largest_ms": gpu_bridge.matmul_seconds(
                m, k, n, LARGEST[0], LARGEST[2]) * 1e3,
            "status": c.status, "solve_s": solve_s})
    return rows


def flash_pick() -> tuple[int, int]:
    """`gpu_bridge.select_flash_blocks` at the bench's flash cell (see
    ``FLASH_*``) on the card's SMs (`gpu_bridge.device_sms`)."""
    heads = get_config(FLASH_ARCH).n_heads
    return gpu_bridge.select_flash_blocks(
        FLASH_SEQ, FLASH_SEQ, FLASH_HEAD_DIM, bytes_el=FLASH_BYTES_EL,
        batch_heads=SHAPES[FLASH_SHAPE].global_batch * heads,
        n_sms=gpu_bridge.device_sms())


def md_table(headers: list[str], rows: list[list]) -> str:
    out = ["| " + " | ".join(headers) + " |", "|" + "---|" * len(headers)]
    for r in rows:
        out.append("| " + " | ".join(
            f"{x:.4g}" if isinstance(x, float) else str(x) for x in r) +
            " |")
    return "\n".join(out)


def run(out_dir: str) -> dict:
    """The bench: writes ``out_dir/gpu_bridge.json``, prints the table and
    the flash pick, and returns the record."""
    rows = bench_rows()
    bq, bk = flash_pick()
    payload = {"smem_bytes": gpu_bridge.device_smem_bytes(), "sms": gpu_bridge.device_sms(),
               "largest_tile": list(LARGEST), "rows": rows,
               "flash_blocks_32k": [bq, bk],
               "flash_cell": {"seq": FLASH_SEQ, "head_dim": FLASH_HEAD_DIM,
                              "bytes_el": FLASH_BYTES_EL,
                              "batch_heads": SHAPES[FLASH_SHAPE]
                              .global_batch * get_config(FLASH_ARCH)
                              .n_heads}}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "gpu_bridge.json"), "w") as f:
        json.dump(payload, f, indent=1)
    print(md_table(
        ["arch", "GEMM m*k*n", "blocks", "buf", "smem", "fit", "est ms",
         f"{'x'.join(map(str, LARGEST))} ms", "solver"],
        [[r["arch"], "x".join(map(str, r["gemm"])),
          "(" + ",".join(map(str, r["pick"])) + ")", r["buffering"],
          f"{r['smem_bytes'] / 1024:.1f}KiB",
          "OK" if r["fits"] else "OVER", r["est_ms"], r["largest_ms"],
          r["status"]] for r in rows]))
    print(f"\nflash-attention blocks @32k/hd{FLASH_HEAD_DIM} "
          f"(bytes_el {FLASH_BYTES_EL}, {payload['flash_cell']['batch_heads']}"
          f" batch x heads, {payload['sms']} SMs): block_q={bq}, "
          f"block_k={bk}")
    return payload


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="matmul_int8 tiles from the bridge MIP for each arch's "
                    "dominant GEMM, and the 32k flash pick (host only).")
    ap.add_argument("--out", required=True,
                    help="directory for gpu_bridge.json")
    a = ap.parse_args(argv)
    rows = run(a.out)["rows"]
    return 0 if all(r["status"] != "fallback" and r["fits"]
                    for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
