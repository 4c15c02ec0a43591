"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card, from the root of a checkout:

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:

  1. device — the card's name and power limit (``nvidia-smi``), torch and
     CUDA versions;
  2. build — the three CUDA kernels from the sources in the checkout, one
     ``nvcc`` per source, started together; registers, shared memory and
     spills of every instantiation (``-Xptxas -v``; a spill in any kernel
     fails the run); every matmul_int8 and flash_attention launch's shared
     memory, as the library reports it, against ``kernel.smem_bytes``
     (each kernel's whole ring included); matmul_int8's threads, registers
     and resident CTAs per SM at every tile, the flash prefill kernel's
     registers, shared memory and resident CTAs per SM at every tile for
     hd 128 and 64 in both dtypes, the decode kernel's (the CUDA occupancy
     API); every ssd_scan instance's registers, resident CTAs per SM and
     key groups, its shared memory against ``kernel.smem_bytes`` and no
     local memory; HMMA (tensor-core) instructions in the SASS of every
     flash prefill and every ssd_scan instance (``cuobjdump -sass``), or
     the run fails;
  3. main paths, each with a cold solve cache and every launch counter
     zeroed just before it and read just after; every op must run on its
     kernel (``path == "cuda"``) and pass its oracle:
     A. ``repro_torch.serve_lm`` for glm4-9b at its published widths under
        ``decode_32k`` (matmul_int8, flash_attention);
     B. ``repro_torch.serve_lm`` for mamba2-1.3b at its published widths
        under ``prefill_32k``, the prompt pass of 32 sequences of 32k
        tokens (matmul_int8, ssd_scan);
     C. ``repro_torch.exec_lm`` at published widths, quick solves, over
        minicpm-2b and mamba2-1.3b x the three execution scenarios: all
        three kernel families and both models' wGrad GEMMs;
     D. ``repro_torch.serve_lm --live`` for glm4-9b at its published
        widths (random float32 weights from the seed, 37.6 GB): 4 prompts
        of 512 tokens prefilled, the attention of each of the 40 layers
        on flash_attention (exactly 40 launches), then 16 greedy decode
        steps on the plain product (no launch); then the same prefill
        with ``use_flash=False``, all plain PyTorch: last-token logits,
        and the logits of every decode step whose inputs still agree,
        within flash_attention's tolerance, the first greedy token that
        differs printed with its logit gap, and warm prefill times of
        both in turns; a profile of decode steps (device busy against
        wall time). It runs after E, as the first of the families' loop
        (``LIVE_FAMILIES``), and is freed before F;
     E. ``repro_torch.serve_lm --live`` for mamba2-1.3b at its published
        widths, same traffic; its forward runs the plain SSD product, as
        the reference's does, and beside it the path runs
        ``models.ssm.ssd_chunked(use_kernel=True)`` on layer 0's SSD
        operands of that prefill (one ssd_scan launch at b 4, nc 2, Q 256,
        h 64, N 128, P 64) against ``use_kernel=False``; a profile of
        decode steps as in D.
     F-I. ``repro_torch.serve_lm --live`` for the other families at
        their published widths, float32, the traffic of D, one path at a
        time, each model freed before the next: F qwen2-moe-a2.7b (moe,
        57.3 GB), G zamba2-1.2b (hybrid), H pixtral-12b (vlm, 1024 stub
        patch embeddings in front of each prompt: prefills of 1536
        positions), I seamless-m4t-large-v2 (encdec, an encoder over 1024
        stub frames). Exactly 24 / 6 / 40 / 24 flash_attention launches a
        prefill (the hybrid's one a group; the encoder and the
        cross-attention run the plain product, as the reference's) and
        none a decode step; the all-plain prefill and its greedy decode
        on the same weights and inputs as in D, one warm prefill of each.
        F's router is discontinuous (top-k with a capacity): its plain
        prefill runs free first, the tokens whose experts part printed
        layer by layer; up to the first MoE layer where they part, the
        router probabilities must hold the tolerance, and each parted
        decision there must be a near-tie (or, with none parted, the
        logits hold the tolerance); then the plain prefill runs along
        the flash run's recorded routing for the held comparison and the
        greedy decode; a profile of decode steps as in D;
     D-I pass the demo's checks: cache length exactly the prefilled +
     generated positions and the last position written (D, F-I), the SSM
     states' shapes (E, G), the cross K/V and memory (I); their lines
     print the card's name and power limit. Then ``[traffic]``:
     ``serve_lm --traffic``, the request-level simulator (host only),
     continuous batching no slower than serial;
  4. kernels vs plain — each kernel against its plain PyTorch version on
     the same inputs on the card: matmul_int8 integer-exact with unit
     scales at K <= 1024 and at K = 1 and M = 1 for every tile, bit-equal
     under split-K (K ragged across the splits, M = 1, float32 and
     bfloat16, two calls alike), then at every shape and block of paths A
     and B with its split, CTAs, achieved GB/s and share of the bound;
     flash_attention at path A's decode step and path C's minicpm-2b
     decode step (both at every block_k, with achieved GB/s beside the
     bound), path C's prefill attention ops at their plan shapes and
     blocks, path D's prefill attention (4 x 32 heads, L 512, hd 128)
     and paths F-I's (float32),
     causal prefill (L = 1024, 4096), bidirectional and L = 264 at
     the bridge's blocks, and the prefill sweep (`PREFILL_SWEEP`, every
     tile, the bridge's prefill rule's evidence), in float32 and bfloat16;
     ssd_scan at every one-cell shape the
     plans run, at odd Q = 24 and at the full grid of one mamba2-1.3b
     ``prefill_32k`` layer for one sequence at the bridge's query tile
     (with its key groups, CTAs, GB/s and share of the bound), path E's
     layer-0 grid (4, 2, 256, 64, 128, 64), and the
     ssd sweep (`SSD_SWEEP`, every bt, the bridge's ssd rule's evidence),
     in float32 and bfloat16.
     Each is timed (CUDA events, L2 flushed before every launch, median)
     beside the plain version, one PyTorch library call computing the
     same function where there is one (timed here only, never used by
     the port) and the least time the card could take (bound). Paths A
     and B already hold every op of theirs against its oracle, and path
     C every op of its plans;
  5. path J, after the kernels' timings, so that its ~50 GB of state
     and its minute of full load on the card touch none of them:
     ``repro_torch.train.steps.make_train_step`` for minicpm-2b at its
     published widths (random float32 weights from the seed, 10.9 GB;
     bf16 compute, remat, the config's WSD schedule), once every served
     model is freed: 6 steps on one batch of 4 x 1,024 tokens, every
     loss finite, the first beside ln V, the last TRAIN_MARGIN below the
     first, none of the three kernels launched (no kernel has a
     backward; the train step runs the plain products); step ms,
     tokens/s, peak bytes and a profiled step's busy share. Then
     ``[train holds]`` at published widths and 2 layers, float32: one
     step on the card against the same step on the host (loss, grad
     norm, weights, both moments), 2 microbatches against 1, and the
     int8 compression of the card's gradients (residuals within half a
     scale, bit-equal to the host function's);
  6. path K, after J's state is freed: ``repro_torch.train_lm.run`` for
     minicpm-2b at its published widths through a checkpoint restart
     (bf16, remat, J's batch, sequence and lr, the driver's data stream
     and schedule), into a fresh temporary directory that needs 1.5x the
     checkpoint (about 32.7 GB) free and is deleted at the end: run 1
     takes steps 0-3 and saves the final state; every leaf on disk
     bit-equal to that state on the card; the train step's loss of batch
     3 on it (L*); run 2 resumes from the checkpoint (it must say so) and
     its first loss equals L* within 1e-6 relative; every loss finite,
     L* below batch 3's loss in run 1 (one update earlier), batch 3's
     loss after run 2's first step (its replay) below L*, none of the
     three kernels launched; step ms, tokens/s, peak bytes, the
     checkpoint's bytes, save and restore seconds and GB/s and the free
     disk;
  7. path M, after K: K's two runs (the same flags, data stream and
     schedule) through ``repro_torch.train_lm`` on a one-rank mesh over
     ``nccl`` (``WORLD_SIZE=1`` in a process of its own, `path_m_child`):
     the state drawn onto the sharding plan as DTensors, each batch on
     the plan's batch spec, ``shard_fn`` inside the forward, the sharded
     checkpoint saved at step RESTART_K and resumed from; its losses and
     grad norms within TRAIN_TOL relative of K's, the checkpoint's leaves
     equal to the sharded state, run 2 resumed with its first loss L*
     and the replay below it, every parameter a DTensor, none of the
     three kernels launched; step ms beside J's and K's, tokens/s, peak
     bytes, the seconds to draw and place the state, save and restore
     seconds;
  8. path L, after M: ``[scorer]`` the batched scorer
     (`core.latency_batched`) over `baselines.heuristic_search`'s pools of
     SCORER_POOL mappings (SCORER_POOLS: path A's ffn_up ungated, path
     B's ssd_s_chunk gated), the NumPy loop on the host against
     ``backend="torch"`` (float64) on the card: cycles, energy, EDP,
     idealized time and feasibility bit-equal, ms of each; the search's
     winner and cost from each backend's scores of the gated pool equal
     and chosen among its feasible rows; ``[bridge mip]`` every unique GEMM shape of paths A and B
     through `gpu_bridge.select_matmul_blocks` (a ``fallback`` fails the
     run), one matmul_int8 launch at each pick bit-equal to the plain
     version at unit scales (these are L's counted launches), then within
     NUMERICS_TOL with real scales, timed beside phase 4's mapping-
     derived pick, and the Spearman of the MIP's estimates against the
     times (a finding); ``[plan]`` / ``[dryrun]`` ``python -m
     repro_torch.launch.dryrun`` for glm4-9b ``decode_32k`` on the
     single-pod mesh in a subprocess (the fake process group): exit 0,
     status ok, flops counted (no op without a meta kernel), per-device parameter and KV-cache GB against the card's
     80 GB, the collective bytes per device by kind (the plan inside the
     forward on the fake mesh; null fails the run) and the roofline
     terms, the collective one among them;
  9. path N, after L: the bridge bench on the card. ``repro_torch.
     gpu_bridge_bench.bench_rows`` gives the bridge MIP's matmul_int8 pick
     for each arch's dominant GEMM at published widths (65,536 x d_model
     x max(ff / 16, 128), up to 65536 x 7168 x 304 and 65536 x 6144 x
     1024); one launch at each pick, bit-equal to the plain version at
     unit scales, is N's counted main path (10 launches). Then each pick
     within NUMERICS_TOL at real scales, timed beside every one of the
     kernel's 36 tiles (each bit-equal first): ``[bridge bench]`` lines
     with the fastest tile, the pick's gap to it, the Spearman of the
     model's time against the measured over the tiles, the model over the
     measured at the pick and the share of the int8 tensor-core bound
     (findings, not holds); where n is not a multiple of 16, the pick
     also timed with w's columns zero-padded to the next one (its first
     n columns bit-equal);
  10. ``[hillclimb]``, after N: ``python -m repro_torch.perf_hillclimb``
     for HILLCLIMB_CELLS at published widths (glm4-9b ``decode_32k``
     kv-int8, minicpm-2b ``train_4k`` no-remat, qwen2-moe-a2.7b
     ``train_4k`` moe-scatter against a baseline the dry run lowers with
     the einsum dispatch), host only, the three cells at once, each in
     its own processes with a time limit: every record status ok with
     its memory counts (bytes accessed, peak and temporaries per device)
     non-null, the deltas printed;
  11. the ``kernels`` line: matmul_int8 and flash_attention count-weighted
     over path A's plan (one decode step), ssd_scan over path B's (one
     prompt pass); launches are summed over the main paths A-N;
  12. the last line: ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the repository beside it, it exits
non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: H100 SXM data-sheet rates (NVIDIA, dense, no sparsity): device memory,
#: dense int8 and bf16 tensor cores, and for float32 the TF32 tensor cores
#: (495e12): the executor's tolerances admit TF32, and a bound must not
#: depend on the unit a kernel picks (at the 67e12 FMA peak a TF32 kernel
#: would read over 100 % of its bound). That holds for every float32 row,
#: ssd_scan's included.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bfloat16": 989e12, "float32": 495e12}
REPLACES = {
    "matmul_int8": "src/repro/kernels/matmul_int8/kernel.py:61",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:85",
    "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:52",
}
SOURCES = {
    "matmul_int8": "src/repro_torch/kernels/matmul_int8/csrc/matmul_int8.cu",
    "flash_attention":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "ssd_scan": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
}
KERNELS = tuple(SOURCES)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {msg}")


def bound_ms(n_bytes: float, n_ops: float, op_type: str) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = n_ops / PEAK_OPS_S[op_type]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Timer:
    """Median time of one call in ms: CUDA events around each call, with
    a 256 MB write before it so the 50 MB L2 holds none of its inputs."""

    def __init__(self, torch, reps: int = 10):
        self.torch, self.reps = torch, reps
        self.flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(self.reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi}
    print(smi)
    print(f"[device] {info['kind']} x{info['count']}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    return info


def _short_names(mangled: list[str]) -> list[str]:
    """``name_kernel<...>`` for each mangled kernel name (c++filt, where
    the toolkit has it; the mangled name otherwise)."""
    demangle = shutil.which("c++filt")
    if not demangle or not mangled:
        return list(mangled)
    full = subprocess.run([demangle], input="\n".join(mangled),
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.splitlines()
    out = []
    for m, f in zip(mangled, full):
        found = re.search(r"\w+_kernel(<[^>]*>)?", f)
        out.append(found.group(0) if found else m)
    return out


def _tensor_core_counts(lib: Path) -> dict[str, int]:
    """HMMA (tensor-core) instructions per kernel in a built library's
    SASS (``cuobjdump -sass``)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    names, counts = [], []
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            names.append(found.group(1))
            counts.append(0)
        elif names and "HMMA" in line:
            counts[-1] += 1
    return dict(zip(_short_names(names), counts))


def phase_build(torch) -> None:
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    _build.build_all()
    print(f"[build] {len(_build.SOURCES)} kernels in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    spills = []
    for name in _build.SOURCES:
        lines = _build.log_path(name).read_text().splitlines()
        mangled = [line.split("'")[1] for line in lines
                   if "Compiling entry function" in line]
        short = iter(_short_names(mangled))
        entry = None
        for line in lines:
            if "Compiling entry function" in line:
                entry = next(short)
            elif "Used" in line and "registers" in line and entry:
                print(f"[build] {entry}: {line.split(':', 1)[1].strip()}")
            elif "spill" in line and entry and " 0 bytes spill" not in line:
                print(f"[build] {entry}: {line.strip()}")
                spills.append(entry)
        _build.load(name)
    require(not spills, f"register spills in {spills}")
    from repro_torch.kernels.matmul_int8 import kernel as mm_kernel
    occ = {}
    for bm in mm_kernel.BM_TILES:
        for bk in mm_kernel.BK_TILES:
            for bn in mm_kernel.BN_TILES:
                o = mm_kernel.occupancy(bm, bk, bn)
                want = mm_kernel.smem_bytes(bm, bk, bn)
                require(o["smem_bytes"] == want and o["local_bytes"] == 0,
                        f"matmul_int8 {(bm, bk, bn)} launches with "
                        f"{o['smem_bytes']} bytes of shared memory "
                        f"(kernel.smem_bytes = {want}) and "
                        f"{o['local_bytes']} bytes of local memory")
                occ[f"{bm}x{bk}x{bn}"] = (o["threads"], o["regs"],
                                          o["ctas_per_sm"])
    print(f"[build] matmul_int8 (bm x bk x bn): (threads, registers, "
          f"resident CTAs per SM), no spill, shared memory = "
          f"kernel.smem_bytes at every tile: {occ}", flush=True)
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    prefill = [(bq, bk) for bq in fa_kernel.BQ_TILES if bq > 1
               for bk in fa_kernel.BK_TILES]
    for dt, el in (("float32", 4), ("bfloat16", 2)):
        # what each launch really passes, from the library itself
        for bq in fa_kernel.BQ_TILES:
            for bk in fa_kernel.BK_TILES:
                for hd in (8, 64, 100, 128):
                    got = fa_kernel.occupancy(bq, bk, hd, getattr(torch, dt))
                    want = fa_kernel.smem_bytes(bq, bk, hd, el)
                    require(got["smem_bytes"] == want,
                            f"flash_attention {(bq, bk, hd, dt)} launches "
                            f"with {got['smem_bytes']} bytes of shared "
                            f"memory, kernel.smem_bytes says {want}")
        for hd in (128, 64):
            occ = {}
            for bq, bk in prefill:
                o = fa_kernel.occupancy(bq, bk, hd, getattr(torch, dt))
                occ[f"{bq}x{bk}"] = (o["regs"], o["smem_bytes"],
                                     o["ctas_per_sm"])
            print(f"[build] flash prefill kernel (bq / 16 warps) at hd={hd}, "
                  f"{dt} (bq x bk): (registers, shared memory bytes, "
                  f"resident CTAs per SM): {occ}")
            parts = []
            for bk in fa_kernel.BK_TILES:
                o = fa_kernel.occupancy(1, bk, hd, getattr(torch, dt))
                warps = fa_kernel.DECODE_WARPS * o["ctas_per_sm"]
                parts.append(f"bk {bk}: {o['regs']} registers, "
                             f"{o['smem_bytes']} B smem, {o['ctas_per_sm']} "
                             f"resident CTAs ({warps} warps) per SM")
            print(f"[build] flash decode kernel (bq=1) at hd={hd}, {dt}: "
                  + "; ".join(parts), flush=True)
    # the prefill tiles run on the tensor cores: every instance carries
    # HMMA instructions
    hmma = {f: n for f, n in _tensor_core_counts(
        _build.library_path("flash_attention")).items()
        if f.startswith("flash_prefill_kernel")}
    want = 2 * len(prefill) * len(fa_kernel.HEAD_DIM_TILES)
    require(len(hmma) == want and all(hmma.values()),
            f"flash prefill tensor-core instructions: {len(hmma)} of {want} "
            f"instances found, counts {hmma}")
    print(f"[build] flash prefill kernel: HMMA in the SASS of all {want} "
          f"instances ({min(hmma.values())}..{max(hmma.values())} each)",
          flush=True)
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    for dt, el in (("float32", 4), ("bfloat16", 2)):
        occ = {}
        for bt in ssd_kernel.BT_TILES:
            for n in ssd_kernel.DIM_TILES:
                for p in ssd_kernel.DIM_TILES:
                    o = ssd_kernel.occupancy(bt, n, p, getattr(torch, dt))
                    want = ssd_kernel.smem_bytes(n, p, el)
                    require(o["smem_bytes"] == want and o["local_bytes"] == 0
                            and o["ctas_per_sm"] >= 1,
                            f"ssd_scan {(bt, n, p, dt)} launches with "
                            f"{o['smem_bytes']} bytes of shared memory "
                            f"(kernel.smem_bytes = {want}), "
                            f"{o['local_bytes']} bytes of local memory, "
                            f"{o['ctas_per_sm']} CTAs per SM")
                    occ[f"{bt}x{n}x{p}"] = (o["regs"], o["smem_bytes"],
                                            o["ctas_per_sm"],
                                            ssd_kernel.key_groups(bt))
        print(f"[build] ssd_scan kernel ({ssd_kernel.WARPS} warps), {dt} "
              f"(bt x N' x P'): (registers, shared memory bytes, resident "
              f"CTAs per SM, key groups), no local memory, shared memory = "
              f"kernel.smem_bytes at every instance: {occ}")
    # both products run on the tensor cores: every instance carries HMMA
    hmma = {f: n for f, n in _tensor_core_counts(
        _build.library_path("ssd_scan")).items()
        if f.startswith("ssd_scan_kernel")}
    want = 2 * len(ssd_kernel.BT_TILES) * len(ssd_kernel.DIM_TILES) ** 2
    require(len(hmma) == want and all(hmma.values()),
            f"ssd_scan tensor-core instructions: {len(hmma)} of {want} "
            f"instances found, counts {hmma}")
    print(f"[build] ssd_scan kernel: HMMA in the SASS of all {want} "
          f"instances ({min(hmma.values())}..{max(hmma.values())} each)",
          flush=True)


def _counters() -> dict:
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.matmul_int8 import kernel as mm_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    return {"matmul_int8": mm_kernel, "flash_attention": fa_kernel,
            "ssd_scan": ssd_kernel}


def drive(torch, label: str, fn):
    """Run one main path with a cold solve cache, its launch counters
    zeroed just before and read just after; returns (result, launches)."""
    mods = _counters()
    with tempfile.TemporaryDirectory(prefix="miredo-cache-") as cache:
        os.environ["MIREDO_CACHE"] = cache        # cold: the MIP solves
        for m in mods.values():
            m.launches = 0
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        launches = {k: m.launches for k, m in mods.items()}
        wall = time.monotonic() - t0
    print(f"[main {label}] {wall:.1f} s wall; launches {launches}",
          flush=True)
    return out, launches


def check_plan(label: str, rep, kernels: set[str], launches: dict) -> None:
    plan = rep.plan
    require(rep.numerics_ok,
            f"{label}: numerics (max rel err {rep.max_rel_err})")
    require(all(math.isfinite(op.measured_s) and op.measured_s > 0
                for op in plan.ops), f"{label}: every op timed")
    for op in plan.ops:
        require(op.path == "cuda", f"{label}: {op.name} ran on {op.path}")
    require({op.kernel for op in plan.ops} == kernels,
            f"{label}: the plan reaches {sorted(kernels)}")
    for name in kernels:
        require(launches[name] > 0,
                f"{label}: {name} never launched on the main path")
    for name in set(KERNELS) - kernels:
        require(launches[name] == 0, f"{label}: {name} launched off-plan")
    rank = rep.rank_corr
    print(f"[main {label}] {plan.model} {plan.scenario}: {rep.n_ops} ops, "
          f"{rep.n_unique} unique, {rep.measured_total_s * 1e3:.4f} ms "
          f"count-weighted, rank corr "
          f"{rank if rank is None else round(rank, 4)}, max rel err "
          f"{rep.max_rel_err:.3e}", flush=True)
    for op in plan.ops:
        print(f"[main {label}]   {op.kernel:>15} {op.name} x{op.count}: "
              f"{op.measured_s * 1e3:.4f} ms, x count "
              f"{op.count * op.measured_s * 1e3:.4f} ms", flush=True)


def phase_path_a(torch) -> tuple:
    from repro_torch import serve_lm
    rep, launches = drive(torch, "A", lambda: serve_lm.main(
        ["--arch", "glm4-9b", "--shape", "decode_32k", "--device", "cuda"]))
    check_plan("A", rep, {"matmul_int8", "flash_attention"}, launches)
    return rep, launches


def phase_path_b(torch) -> tuple:
    from repro_torch import serve_lm
    rep, launches = drive(torch, "B", lambda: serve_lm.main(
        ["--arch", "mamba2-1.3b", "--shape", "prefill_32k", "--device",
         "cuda"]))
    check_plan("B", rep, {"matmul_int8", "ssd_scan"}, launches)
    return rep, launches


def phase_path_c(torch) -> tuple:
    from repro_torch import exec_lm
    out, launches = drive(torch, "C", lambda: exec_lm.run(
        quick=True, archs=exec_lm.REDUCED_ARCHS, device="cuda"))
    for r in out["rows"]:
        require(r["numerics_ok"], f"C: {r['model']}/{r['scenario']} "
                f"numerics (max rel err {r['max_rel_err']})")
        require(r["paths"] == ["cuda"],
                f"C: {r['model']}/{r['scenario']} ran on {r['paths']}")
    require(len(out["rows"]) == len(exec_lm.REDUCED_ARCHS) *
            len(exec_lm.EXEC_SHAPES), "C: every (model, scenario) row")
    require(set(out["kernels"]) == set(KERNELS),
            f"C: kernel families {out['kernels']}")
    require(set(out["wgrad_covered"]) == set(exec_lm.REDUCED_ARCHS),
            f"C: wGrad covered for {out['wgrad_covered']}")
    for name in KERNELS:
        require(launches[name] > 0, f"C: {name} never launched")
    rank = out["pooled_rank_corr"]
    # not gated: RANK_FLOOR was set on interpret-mode CPU times
    print(f"[main C] exec_lm: {len(out['rows'])} rows, pooled spearman "
          f"{rank} over {out['n_rank_points']} points (floor "
          f"{exec_lm.RANK_FLOOR}, not gated on the card)", flush=True)
    return out, launches


#: Paths D and E serve the live model through ``serve_lm --live``: 4
#: prompts of 512 tokens (the shortest causal prefill that runs on
#: flash_attention) and 16 greedy tokens each.
LIVE_BATCH, LIVE_PROMPT, LIVE_GEN = 4, 512, 16


def _live_args(arch: str) -> list[str]:
    return ["--live", "--arch", arch, "--batch", str(LIVE_BATCH),
            "--prompt-len", str(LIVE_PROMPT), "--gen-len", str(LIVE_GEN),
            "--device", "cuda"]


def _rel(out, ref) -> float:
    return float((out.double() - ref.double()).norm() / ref.double().norm())


def _sync_ms(torch, fn) -> float:
    """Wall ms of ``fn()`` between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    fn()
    torch.cuda.synchronize()
    return (time.monotonic() - t0) * 1e3


def _live_summary(label: str, rep, info: dict) -> dict:
    """Prefill ms, decode ms per step (median), tokens/s and peak memory
    of one live run, printed beside the card's name and power limit."""
    out = {"prefill_ms": rep.prefill_ms, "decode_ms": rep.decode_ms,
           "decode_ms_median": statistics.median(rep.decode_ms),
           "tokens_per_s": rep.tokens_per_s, "peak_bytes": rep.peak_bytes,
           "init_s": rep.init_s}
    print(f"[main {label}] {rep.arch} live, {rep.batch} x {rep.prompt_len} "
          f"prompt + {rep.gen_len} greedy tokens: prefill "
          f"{rep.prefill_ms:.4f} ms (first call), decode "
          f"{sum(rep.decode_ms):.4f} ms (median {out['decode_ms_median']:.4f}"
          f" ms a step), {rep.tokens_per_s:.4f} tokens/s, peak "
          f"{rep.peak_bytes:,} bytes allocated; card {info['nvidia_smi']}",
          flush=True)
    return out


def _device_profile(torch, step, steps: int) -> dict:
    """``step()`` run ``steps`` times under ``torch.profiler``: the CUDA
    kernels' summed device time per step against the step's wall time
    (profiled, so both include the profiler's own cost), the device's
    idle share, the kernels launched a step and the four costliest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3 / steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev = lambda e: e.self_device_time_total / 1e3 / steps     # ms a step
    busy = sum(dev(e) for e in kernels)
    top = sorted(kernels, key=dev, reverse=True)[:4]
    return {"wall_ms": wall, "device_ms": busy,
            "idle_share": 1 - busy / wall,
            "kernels_per_step": sum(e.count for e in kernels) / steps,
            "top": [(e.key[:60], dev(e)) for e in top]}


def _profile_decode(torch, label: str, info: dict, decode, model, tok,
                    caches, steps: int = 4) -> dict:
    """Where a decode step's time goes: ``steps`` greedy steps profiled
    (`_device_profile`) after one warm step of the same shapes."""
    decode(model, {"tokens": tok}, caches)          # warm, same shapes
    greedy = {"tok": tok, "caches": caches}

    def step():
        logits, greedy["caches"] = decode(model, {"tokens": greedy["tok"]},
                                          greedy["caches"])
        greedy["tok"] = logits.argmax(dim=-1)[:, None]
    out = _device_profile(torch, step, steps)
    wall, busy = out["wall_ms"], out["device_ms"]
    print(f"[main {label}] decode step profiled ({steps} steps): wall "
          f"{wall:.4f} ms, device busy {busy:.4f} ms, idle share "
          f"{out['idle_share']:.4f}, {out['kernels_per_step']:.0f} kernels "
          f"a step; costliest {out['top']}; card {info['nvidia_smi']}",
          flush=True)
    return out


def _free(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


class RouteLog:
    """The experts every MoE layer's router picks, in call order
    (``models.moe.top_k_experts`` wrapped while a mode is on): ``record``
    keeps each call's probabilities and experts; ``compare`` holds this
    run's against the record's call by call (one call a layer): the
    tokens whose experts part, the router probabilities' relative error,
    and for each parted token the gap between the swapped experts' (the
    largest probability this run picked that the record did not, less the
    smallest the record picked that this run did not) against ``2 * tol *
    max(probs)``, the most a change of ``tol`` of the largest probability
    can swap; ``replay`` hands the recorded experts back (their gates are
    this run's probabilities, renormalised as usual). A top-k router is
    discontinuous: a near-tie that the flash and the plain attention
    resolve apart moves a token by a whole expert, and each such move
    shifts the capacity slots of the tokens behind it."""

    def __init__(self, tol: float):
        from repro_torch.models import moe as moe_mod
        self.moe, self.orig = moe_mod, moe_mod.top_k_experts
        self.tol, self.calls, self.kind, self.i = tol, [], None, 0
        self.layers = []

    @contextlib.contextmanager
    def mode(self, kind: str):
        self.kind, self.i, self.layers = kind, 0, []
        self.moe.top_k_experts = self
        try:
            yield self
        finally:
            self.moe.top_k_experts, self.kind = self.orig, None

    def __call__(self, probs, k):
        values, idx = self.orig(probs, k)
        if self.kind == "record":
            self.calls.append((probs, idx))
            return values, idx
        want_p, want = self.calls[self.i]
        self.i += 1
        if self.kind == "replay":
            return probs.gather(-1, want), want
        parted = (idx.sort(dim=-1).values !=
                  want.sort(dim=-1).values).any(dim=-1)
        mine = probs.new_zeros(probs.shape, dtype=bool).scatter_(-1, idx,
                                                                 True)
        theirs = probs.new_zeros(probs.shape, dtype=bool).scatter_(
            -1, want, True)
        gap = (probs.masked_fill(~(mine & ~theirs), -1.0).amax(dim=-1) -
               probs.masked_fill(~(theirs & ~mine), 2.0).amin(dim=-1))
        bound = 2 * self.tol * probs.amax(dim=-1)
        n = int(parted.sum())
        self.layers.append({
            "tokens": probs.shape[0], "parted": n,
            "probs_rel_err": _rel(probs, want_p),
            "max_gap": float(gap[parted].max()) if n else 0.0,
            "max_bound": float(bound[parted].max()) if n else 0.0,
            "near_ties": int((gap <= bound)[parted].sum())})
        return values, idx


def _flash_vs_plain(torch, label: str, rep, info: dict,
                    turns: tuple[str, ...],
                    routes: RouteLog | None = None) -> tuple:
    """The live run's prefill again with ``use_flash=False``, all plain
    PyTorch, on the same weights, prompts and frontend embeddings:
    last-token logits within flash_attention's tolerance; the greedy
    decode from it, the logits of every step whose inputs still agree
    within the tolerance and the first greedy token that differs printed
    with its logit gap; then warm prefills of both kinds in ``turns``.
    With ``routes`` (a MoE model, its live run recorded), the plain
    prefill runs free first: the tokens whose experts part from the flash
    run's are printed layer by layer; up to the first layer where they
    part the router probabilities hold the tolerance and each parted
    decision there is a near-tie (with none parted, the logits hold the
    tolerance); the held prefill and decode then replay the flash run's
    routing. Returns (summary fields, the plain decode step, its
    last token, its caches)."""
    from repro_torch import serve_lm
    from repro_torch.core.executor import NUMERICS_TOL
    from repro_torch.train.steps import StepConfig, make_decode_step, \
        make_prefill_step
    cfg = rep.model.cfg
    tol = NUMERICS_TOL["flash_attention"]
    plain_cfg = StepConfig(use_flash=False, compute_dtype=torch.float32)
    prefill = {"flash": make_prefill_step(cfg, StepConfig(
        use_flash=True, compute_dtype=torch.float32)),
        "plain": make_prefill_step(cfg, plain_cfg)}
    batch = {"tokens": rep.prompt}
    if rep.frontend is not None:
        batch["frontend"] = rep.frontend
    fields = {}
    if routes is not None:
        with routes.mode("compare"):
            free, _ = prefill["plain"](rep.model, batch)
        rel_free = _rel(rep.step_logits[0], free)
        layers = routes.layers
        parted = [lay["parted"] for lay in layers]
        at = next((i for i, n in enumerate(parted) if n), None)
        decisions = sum(lay["tokens"] for lay in layers)
        fields.update(free_prefill_rel_err=rel_free, routing_parted=parted,
                      routing_decisions=decisions)
        print(f"[main {label}] last-token logits, flash_attention prefill "
              f"vs the free-running plain prefill: rel err {rel_free:.3e}; "
              f"tokens whose experts part, layer by layer: {parted} "
              f"({sum(parted)} of {decisions} (token, layer) decisions)",
              flush=True)
        if at is None:
            require(rel_free <= tol, f"{label}: free plain prefill rel err "
                    f"{rel_free} > {tol} with the routing equal")
        else:
            # up to the first parting both runs route alike: the router
            # probabilities hold the kernel's tolerance there, and each
            # parted decision is a near-tie that such a change can swap
            lay = layers[at]
            held = max(x["probs_rel_err"] for x in layers[:at + 1])
            fields.update(first_parted_layer=at, first_parted=lay,
                          probs_rel_err_to_first=held)
            print(f"[main {label}] first parting at MoE layer {at}: "
                  f"{lay['parted']} tokens, {lay['near_ties']} of them "
                  f"near-ties (the swapped experts' probability gap, max "
                  f"{lay['max_gap']:.3e}, within 2 x {tol} x the token's "
                  f"largest probability, max {lay['max_bound']:.3e}); "
                  f"router probabilities rel err up to it max {held:.3e}",
                  flush=True)
            require(held <= tol, f"{label}: router probabilities rel err "
                    f"{held} > {tol} before the routing parts")
            require(lay["near_ties"] == lay["parted"],
                    f"{label}: MoE layer {at}: a parted decision is no "
                    f"near-tie: {lay}")
        del free
    replay = routes.mode("replay") if routes is not None else \
        contextlib.nullcontext()
    with replay:
        logits, caches = prefill["plain"](rep.model, batch)
        along = " along the flash run's routing" if routes else ""
        rel = _rel(rep.step_logits[0], logits)
        print(f"[main {label}] last-token logits, flash_attention prefill "
              f"vs plain{along}: rel err {rel:.3e} (tolerance {tol}), max "
              f"abs err "
              f"{float((rep.step_logits[0] - logits).abs().max()):.3e}",
              flush=True)
        require(rel <= tol,
                f"{label}: prefill logits rel err {rel} > {tol}")
        # the greedy decode from the plain prefill: the steps whose
        # inputs agree (every token before them equal) must agree
        # within tol
        decode = make_decode_step(cfg, plain_cfg)
        caches = serve_lm.pad_caches(caches, rep.max_seq, cfg.family)
        toks, step_logits = [logits.argmax(dim=-1)[:, None]], [logits]
        for _ in range(rep.gen_len):
            logits, caches = decode(rep.model, {"tokens": toks[-1]}, caches)
            toks.append(logits.argmax(dim=-1)[:, None])
            step_logits.append(logits)
    plain_tokens = torch.cat(toks, dim=1)
    differ = (plain_tokens != rep.tokens).any(dim=0).nonzero()
    first = int(differ[0]) if len(differ) else rep.gen_len + 1
    rels = [_rel(rep.step_logits[s], step_logits[s])
            for s in range(min(first + 1, rep.gen_len + 1))]
    require(max(rels) <= tol,
            f"{label}: step logits rel err {rels} > {tol}")
    if first <= rep.gen_len:
        row = int((plain_tokens[:, first] != rep.tokens[:, first])
                  .nonzero()[0])
        tp, tf = int(plain_tokens[row, first]), int(rep.tokens[row, first])
        lp, lf = step_logits[first][row], rep.step_logits[first][row]
        print(f"[main {label}] greedy tokens agree for {first} of "
              f"{rep.gen_len + 1} steps; step {first} row {row}: plain "
              f"{tp}, flash {tf}; gap plain {float(lp[tp] - lp[tf]):.3e}, "
              f"flash {float(lf[tf] - lf[tp]):.3e}", flush=True)
    else:
        print(f"[main {label}] greedy tokens equal at all "
              f"{rep.gen_len + 1} steps (prefill + {rep.gen_len} decode)",
              flush=True)
    print(f"[main {label}] step logits rel err, flash vs plain prefill, "
          f"steps 0..{len(rels) - 1}: max {max(rels):.3e}", flush=True)
    warm = {"flash": [], "plain": []}
    for kind in turns:
        warm[kind].append(_sync_ms(torch, lambda: prefill[kind](
            rep.model, batch)))
    print(f"[main {label}] warm prefill ms, flash {warm['flash']}, plain "
          f"{warm['plain']}; card {info['nvidia_smi']}", flush=True)
    fields.update(prefill_rel_err=rel, step_rel_err_max=max(rels),
                  tokens_agree_steps=first, warm_prefill_ms=warm)
    return fields, decode, toks[-1], caches


#: Paths D and F-I: every family but ssm (path E) served live at
#: published widths: (label, arch, flash_attention launches a prefill,
#: the warm prefills' turns). The dense model launches once a layer, as
#: do the MoE and the vlm; the hybrid once a group (its shared attention
#: block), not once a layer; the encoder-decoder once a decoder layer
#: (its encoder and cross-attention run the plain product, as the
#: reference's).
LIVE_FAMILIES = (("D", "glm4-9b", 40, ("plain", "flash", "flash", "plain")),
                 ("F", "qwen2-moe-a2.7b", 24, ("plain", "flash")),
                 ("G", "zamba2-1.2b", 6, ("plain", "flash")),
                 ("H", "pixtral-12b", 40, ("plain", "flash")),
                 ("I", "seamless-m4t-large-v2", 24, ("plain", "flash")))


def phase_path_family(torch, info: dict, label: str, arch: str, want: int,
                      turns: tuple[str, ...]) -> tuple:
    """``arch`` served live at its published widths (float32, 4 prompts
    of 512 tokens behind the vlm's 1024 stub patch embeddings, 16 greedy
    tokens): the prefill's attention on flash_attention, exactly ``want``
    launches, and none in a decode step (the plain product). Then the
    all-plain prefill (``use_flash=False``) on the same weights and
    inputs: last-token logits within the kernel's tolerance (for a MoE
    model along the live run's recorded routing, and free-running with
    its first parting held to near-ties, `RouteLog`), the greedy decode
    from it; warm prefills in ``turns``; a profile of decode steps. The
    model is freed before the next path."""
    from repro_torch import serve_lm
    from repro_torch.configs import get_config
    from repro_torch.core.executor import NUMERICS_TOL
    routes = RouteLog(NUMERICS_TOL["flash_attention"]) \
        if get_config(arch).family == "moe" else None
    with routes.mode("record") if routes else contextlib.nullcontext():
        rep, launches = drive(torch, label, lambda: serve_lm.main(
            _live_args(arch)))
    none = {"flash_attention": 0, "ssd_scan": 0}
    require(rep.launches["prefill"] == dict(none, flash_attention=want),
            f"{label}: prefill launches {rep.launches['prefill']}, want "
            f"{want} flash_attention")
    require(all(d == none for d in rep.launches["decode"]),
            f"{label}: decode launches {rep.launches['decode']}")
    require(launches == {"matmul_int8": 0, "flash_attention": want,
                         "ssd_scan": 0}, f"{label}: launches {launches}")
    summary = _live_summary(label, rep, info)
    fields, decode, tok, caches = _flash_vs_plain(
        torch, label, rep, info, turns, routes)
    profiled = _profile_decode(torch, label, info, decode, rep.model, tok,
                               serve_lm.pad_caches(caches, rep.max_seq + 8,
                                                   rep.model.cfg.family))
    summary.update(fields, family=rep.model.cfg.family,
                   n_params=sum(p.numel() for p in rep.model.parameters()),
                   prefill_positions=rep.prefix + rep.prompt_len,
                   decode_profile=profiled)
    del rep, fields, routes, decode, tok, caches
    _free(torch)
    return summary, launches


def phase_traffic(info: dict) -> dict:
    """``serve_lm --traffic`` once: the request-level simulator over
    reduced glm4-9b, continuous batching against the serial baseline (the
    demo raises unless batching is no slower). Host code only."""
    from repro_torch import serve_lm
    t0 = time.monotonic()
    rep, ser = serve_lm.main(["--traffic"])
    s, ss = rep.summary(), ser.summary()
    require(rep.makespan_cycles <= ser.makespan_cycles and
            s["n_finished"] == 16, f"traffic: {s} vs serial {ss}")
    out = {"batched": s, "serial": ss, "wall_s": time.monotonic() - t0}
    print(f"[traffic] {s['n_finished']} requests served: makespan "
          f"{s['makespan_cycles']:.6g} cycles batched vs "
          f"{ss['makespan_cycles']:.6g} serial, {s['tokens_per_sec']:.6g} "
          f"vs {ss['tokens_per_sec']:.6g} tokens/s (simulated at 1 GHz), "
          f"{s['n_merged_iterations']} merged iterations; host "
          f"{out['wall_s']:.2f} s; card {info['nvidia_smi']}", flush=True)
    return out


#: Path J: minicpm-2b trained at its published widths (40 layers, d 2304,
#: 36 heads, d_ff 5,760, vocab 122,753 tied: 2.72 B parameters, 10.9 GB
#: in float32, drawn on the card from the seed), `StepConfig`'s defaults
#: (bf16 compute, remat on), the config's WSD schedule with a peak lr of
#: TRAIN_LR after TRAIN_WARMUP steps over TRAIN_STEPS (the last step in
#: the decay, at a tenth of the peak); one fixed batch of 4 x 1,024
#: tokens with next-token labels, TRAIN_STEPS times; the last loss must
#: lie TRAIN_MARGIN nats below the first.
TRAIN_ARCH, TRAIN_SEED = "minicpm-2b", 0
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 6
TRAIN_LR, TRAIN_WARMUP, TRAIN_MARGIN = 3e-4, 2, 1.0
#: The holds beside J: published widths at 2 layers (two copies of the
#: state fit, and the host takes its step in seconds), float32 compute,
#: 2 x 128 tokens. Loss and grad norm within TRAIN_TOL relative, m and v
#: within TRAIN_TOL of their leaf's largest entry; a weight within
#: lr * 1e-3 (plus 2 ulp) where its gradient is above TRAIN_G_FLOOR, else
#: within 2 * lr (a first Adam step moves it by about lr * sign(g)).
TRAIN_HOLD_LAYERS, TRAIN_HOLD_BATCH, TRAIN_HOLD_SEQ = 2, 2, 128
TRAIN_TOL, TRAIN_G_FLOOR = 1e-4, 1e-6


def _train_batch(torch, cfg, batch: int, seq: int, gen, device) -> dict:
    """Tokens from ``gen`` and their next-token labels (the last position
    -1, masked)."""
    toks = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                         device=device)
    return {"tokens": toks, "labels": torch.cat(
        [toks[:, 1:], torch.full((batch, 1), -1, device=device)], dim=1)}


def phase_path_j(torch, info: dict) -> tuple:
    """minicpm-2b trained TRAIN_STEPS steps at its published widths on the
    card: every loss finite, the first beside ln V, the last
    TRAIN_MARGIN below the first, and none of the three kernels launched
    (the train step runs the plain products: no kernel has a backward).
    Prints step ms (the median of steps 2 on), tokens/s, peak bytes, and
    a profiled step's device busy share and kernels. The state is freed
    before the holds."""
    from repro_torch.configs import get_config
    from repro_torch.configs.minicpm_2b import TRAIN_SCHEDULE
    from repro_torch.train import optimizer, steps
    cfg = get_config(TRAIN_ARCH)
    step_cfg = steps.StepConfig()
    require(step_cfg.remat and step_cfg.compute_dtype == torch.bfloat16 and
            step_cfg.microbatches == 1 and not step_cfg.use_flash,
            f"J: StepConfig defaults {step_cfg}")
    opt_cfg = optimizer.OptimizerConfig(
        lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS,
        schedule=TRAIN_SCHEDULE)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    state = steps.init_train_state(TRAIN_SEED, cfg, step_cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(p.numel() for p in state.params.parameters())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(TRAIN_SEED + 1)
    batch = _train_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, gen, "cuda")
    step = steps.make_train_step(cfg, opt_cfg, step_cfg)
    held = {"state": state}
    del state

    def run():
        rows = []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t = time.monotonic()
            held["state"], met = step(held["state"], batch)
            met = {k: float(v) for k, v in met.items()}
            torch.cuda.synchronize()
            rows.append(dict(met, ms=(time.monotonic() - t) * 1e3))
        return rows
    rows, launches = drive(torch, "J", run)
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in rows]
    step_ms = statistics.median(r["ms"] for r in rows[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ln_v = math.log(cfg.vocab_size)
    require(all(math.isfinite(v) for r in rows for v in r.values()),
            f"J: a non-finite metric: {rows}")
    require(launches == dict.fromkeys(KERNELS, 0), f"J: launches {launches}")
    require(losses[-1] <= losses[0] - TRAIN_MARGIN,
            f"J: loss {losses[0]} -> {losses[-1]}, not {TRAIN_MARGIN} lower")
    print(f"[main J] {TRAIN_ARCH} trained at published widths ({n_params:,} "
          f"parameters, drawn in {init_s:.2f} s), {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens, bf16 compute, remat, {TRAIN_SCHEDULE} lr "
          f"{[r['lr'] for r in rows]}: losses {losses} (first beside ln V = "
          f"{ln_v:.4f}; the last {losses[0] - losses[-1]:.4f} below the "
          f"first, margin {TRAIN_MARGIN}), grad norms "
          f"{[round(r['grad_norm'], 4) for r in rows]}", flush=True)
    print(f"[main J] step ms {[round(r['ms'], 3) for r in rows]}: median of "
          f"steps 2-{TRAIN_STEPS} {step_ms:.4f} ms, {tokens / step_ms * 1e3:.1f}"
          f" tokens/s; peak {peak:,} bytes allocated ({before:,} held "
          f"before J); kernel launches a step {launches} over "
          f"{TRAIN_STEPS} steps; card {info['nvidia_smi']}", flush=True)

    def one():
        held["state"], _ = step(held["state"], batch)
    counters = _counters()
    n0 = {k: m.launches for k, m in counters.items()}
    profiled = _device_profile(torch, one, 1)
    require(all(m.launches == n0[k] for k, m in counters.items()),
            "J: the profiled step launched a kernel")
    print(f"[main J] train step profiled: wall {profiled['wall_ms']:.4f} ms, "
          f"device busy {profiled['device_ms']:.4f} ms, busy share "
          f"{1 - profiled['idle_share']:.4f}, "
          f"{profiled['kernels_per_step']:.0f} kernels a step; costliest "
          f"{profiled['top']}; card {info['nvidia_smi']}", flush=True)
    summary = {"n_params": n_params, "init_s": init_s, "steps": rows,
               "step_ms_median": step_ms,
               "tokens_per_s": tokens / step_ms * 1e3, "peak_bytes": peak,
               "held_before_bytes": before, "ln_v": ln_v,
               "profile": profiled}
    del held, batch, step
    _free(torch)
    summary["holds"] = _train_holds(torch, info, cfg)
    return summary, launches


def _state_errors(torch, host, card, lr: float, b1: float) -> dict:
    """The card's updated state against the host's after one step from
    the same weights: the largest error of m and v over their leaf's
    largest entry, and the largest excess of a weight's error over what
    TRAIN_G_FLOOR allows it (<= 0 holds), with the count of weights
    under the floor, how many of them lie beyond the tight allowance and
    the largest error among them over lr."""
    out = {"m": 0.0, "v": 0.0, "param_excess": -math.inf, "loose": 0,
           "loose_beyond_tight": 0, "loose_max_err_over_lr": 0.0}
    card_p = dict(card.params.named_parameters())
    for name, p in host.params.named_parameters():
        for key in ("m", "v"):
            ours = getattr(card.opt, key)[name].cpu()
            theirs = getattr(host.opt, key)[name]
            err = float((ours - theirs).abs().max() /
                        theirs.abs().max().clamp_min(1e-30))
            out[key] = max(out[key], err)
        g = host.opt.m[name] / (1 - b1)
        loose = g.abs() <= TRAIN_G_FLOOR
        tight = lr * 1e-3 + 2 * torch.finfo(torch.float32).eps * p.abs()
        allowed = torch.where(loose, torch.full_like(p, 2 * lr * (1 + 1e-3)),
                              tight)
        err = (card_p[name].cpu() - p).abs()
        out["param_excess"] = max(out["param_excess"],
                                  float((err - allowed).max()))
        out["loose"] += int(loose.sum())
        out["loose_beyond_tight"] += int((loose & (err > tight)).sum())
        if loose.any():
            out["loose_max_err_over_lr"] = max(
                out["loose_max_err_over_lr"], float(err[loose].max()) / lr)
    return out


def _train_holds(torch, info: dict, cfg) -> dict:
    """minicpm-2b at published widths and TRAIN_HOLD_LAYERS layers, float32
    compute: one train step on the card against the same step on the
    host from the same weights and batch; 2 microbatches against 1 on
    the card (loss and grads); and the int8 compression on the card's
    gradients: |residual| <= scale / 2 (plus the float32 rounding of the
    division and the product at |code| <= 127, 2 * 127 * 2**-24 <
    2**-16 of the scale) and the decompressed gradients and residuals
    equal, bit for bit, to the host function's on the same input. No
    kernel launches in any of them."""
    import copy
    import dataclasses

    from repro_torch.models.transformer import init_model
    from repro_torch.param_names import reference_leaf
    from repro_torch.runtime import compression
    from repro_torch.train import optimizer, steps
    hcfg = dataclasses.replace(cfg, n_layers=TRAIN_HOLD_LAYERS)
    gen = torch.Generator().manual_seed(TRAIN_SEED + 2)
    host = init_model(hcfg, gen, torch.float32)
    card = copy.deepcopy(host).to("cuda")
    hb = _train_batch(torch, hcfg, TRAIN_HOLD_BATCH, TRAIN_HOLD_SEQ, gen,
                      "cpu")
    cb = {k: v.to("cuda") for k, v in hb.items()}
    f32 = steps.StepConfig(compute_dtype=torch.float32)
    opt_cfg = optimizer.OptimizerConfig(lr=TRAIN_LR,
                                        warmup_steps=TRAIN_WARMUP)
    counters = _counters()
    n0 = {k: m.launches for k, m in counters.items()}
    out, ms = {}, {}
    for side, model, batch in (("host", host, hb), ("card", card, cb)):
        state = steps.TrainState(model, optimizer.init_adamw(
            dict(model.named_parameters())), None, 0)
        t = time.monotonic()
        out[side] = steps.make_train_step(hcfg, opt_cfg, f32)(state, batch)
        float(out[side][1]["loss"])
        ms[side] = (time.monotonic() - t) * 1e3
    (hs, hm), (cs, cm) = out["host"], out["card"]
    del state
    rel = {k: abs(float(cm[k]) - float(hm[k])) / abs(float(hm[k]))
           for k in ("loss", "grad_norm")}
    errs = _state_errors(torch, hs, cs, float(hm["lr"]), opt_cfg.betas[0])
    print(f"[train holds] {TRAIN_ARCH} at {TRAIN_HOLD_LAYERS} layers, "
          f"{TRAIN_HOLD_BATCH} x {TRAIN_HOLD_SEQ} tokens, float32: card vs "
          f"host step: loss {float(cm['loss']):.6f} / {float(hm['loss']):.6f}"
          f" (rel {rel['loss']:.3e}), grad norm rel {rel['grad_norm']:.3e}, "
          f"m {errs['m']:.3e}, v {errs['v']:.3e} of their leaf's largest "
          f"(tolerance {TRAIN_TOL}); weights: largest excess over the "
          f"allowance {errs['param_excess']:.3e} (<= 0 holds); "
          f"{errs['loose']:,} under the gradient floor, "
          f"{errs['loose_beyond_tight']:,} of them beyond the tight "
          f"allowance, their largest error "
          f"{errs['loose_max_err_over_lr']:.3e} lr; step ms card "
          f"{ms['card']:.1f}, host {ms['host']:.1f}", flush=True)
    require(max(rel.values()) <= TRAIN_TOL and errs["m"] <= TRAIN_TOL and
            errs["v"] <= TRAIN_TOL and errs["param_excess"] <= 0,
            f"train holds: card vs host {rel} {errs}")
    del host, hs, out, hb

    grads = {mb: steps.loss_and_grads(card, hcfg, dataclasses.replace(
        f32, microbatches=mb), cb) for mb in (1, 2)}
    mb_loss = abs(float(grads[2][1]) - float(grads[1][1])) / \
        abs(float(grads[1][1]))
    mb_grad = max(float((grads[2][0][n] - g).abs().max() /
                        g.abs().max().clamp_min(1e-30))
                  for n, g in grads[1][0].items())
    print(f"[train holds] microbatches 2 vs 1 on the card: loss rel "
          f"{mb_loss:.3e}, grads {mb_grad:.3e} of their leaf's largest "
          f"(tolerance {TRAIN_TOL})", flush=True)
    require(mb_loss <= TRAIN_TOL and mb_grad <= TRAIN_TOL,
            f"train holds: microbatches {mb_loss} {mb_grad}")

    g = grads[1][0]
    del grads
    res0 = compression.init_residuals(g)
    deq, res = compression.compress_grads_with_feedback(g, res0)
    worst = 0.0
    leaves: dict[str, list[str]] = {}
    for n in g:
        leaves.setdefault(reference_leaf(n), []).append(n)
    for names in leaves.values():
        scale = max(float(g[n].abs().max()) for n in names) / 127.0
        scale = max(scale, 1e-8 / 127.0)
        worst = max(worst, max(float(res[n].abs().max()) for n in names) /
                    scale)
    hdeq, hres = compression.compress_grads_with_feedback(
        {n: t.cpu() for n, t in g.items()},
        {n: t.cpu() for n, t in res0.items()})
    equal = all(torch.equal(deq[n].cpu(), hdeq[n]) and
                torch.equal(res[n].cpu(), hres[n]) for n in g)
    print(f"[train holds] int8 compression on the card's gradients "
          f"({len(leaves)} leaves): largest |residual| "
          f"{worst:.6f} of its leaf's scale (<= 0.5 + 2**-16), decompressed "
          f"grads and residuals bit-equal to the host's: {equal}; card "
          f"{info['nvidia_smi']}", flush=True)
    require(worst <= 0.5 + 2 ** -16 and equal,
            f"train holds: compression {worst} {equal}")
    require(all(m.launches == n0[k] for k, m in counters.items()),
            "train holds: a kernel launched")
    summary = {"card_vs_host": dict(rel, **errs), "step_ms": ms,
               "microbatches": {"loss": mb_loss, "grads": mb_grad},
               "compression": {"residual_of_scale": worst, "equal": equal}}
    del card, cs, g, deq, res, res0, cb
    _free(torch)
    return summary


#: Path K: minicpm-2b trained through a checkpoint restart at published
#: widths by ``repro_torch.train_lm`` (bf16 compute, remat, the driver's
#: WSD rule, J's batch, sequence and lr, its own data stream): run 1 takes
#: steps 0..RESTART_K and saves once, the final state (``--ckpt-every
#: RESTART_K``); run 2 (``--steps RESTART_K + 3``) resumes from it and
#: replays batch RESTART_K, whose loss must equal the one the train step
#: computes on run 1's final state (L*) within RESTART_TOL relative, and
#: lie below that batch's loss in run 1, one update earlier; after run
#: 2's replayed update the same batch's loss must lie below L*: the same
#: data before and after a step, once in each run. (Every step draws a fresh batch of the
#: Markov stream, whose 122,753-token transition 6 steps at lr <= 3e-4
#: do not learn: run 2's last loss against run 1's first is a coin flip
#: of +-0.01 nats, printed, not held.) The checkpoint (params, m and v
#: in float32: about 32.7 GB) needs RESTART_ROOM times its bytes free on
#: the temporary directory's disk.
RESTART_K, RESTART_TOL, RESTART_ROOM = 3, 1e-6, 1.5


class _Tee:
    """Standard output copied into a buffer, for the lines a run prints."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, text):
        self.lines.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def phase_path_k(torch, info: dict) -> tuple:
    """minicpm-2b through ``train_lm.run`` at published widths: run 1
    saves its final state; every leaf on disk bit-equal to that state on
    the card (Hold 1); the train step's loss of batch RESTART_K on it,
    L* (Hold 2); run 2 resumes from the checkpoint, says so, and its
    first loss is L* (Hold 3); every loss finite, L* below the same
    batch's loss in run 1, the batch's loss on run 2's state after its
    first step below L*, no kernel launched (Hold 4). Prints step ms,
    tokens/s, peak bytes, the checkpoint's bytes, save and restore
    seconds and GB/s (the machine's disk and host link, not the card's
    memory) and the free disk before the save. Returns (summary, launches), the
    summary's ``seconds`` split by part."""
    from repro_torch import train_lm
    from repro_torch.checkpoint import checkpoint as ckpt_mod
    from repro_torch.models.transformer import init_model
    from repro_torch.train import steps
    cfg = train_lm.configure(train_lm.build_parser().parse_args(
        ["--arch", TRAIN_ARCH]))[0]
    meta = init_model(cfg, None, device="meta")
    n_params = sum(p.numel() for p in meta.parameters())
    want = 3 * 4 * n_params            # params, m and v in float32
    secs, io_s = {}, {"save": [], "load": []}
    save, load = ckpt_mod.save_checkpoint, ckpt_mod.load_checkpoint

    def timed_save(*a, **k):
        t = time.monotonic()
        out = save(*a, **k)
        io_s["save"].append(time.monotonic() - t)
        return out

    def timed_load(*a, **k):
        t = time.monotonic()
        out = load(*a, **k)
        torch.cuda.synchronize()
        io_s["load"].append(time.monotonic() - t)
        return out

    ckpt_dir = tempfile.mkdtemp(prefix="miredo-ckpt-")
    ckpt_mod.save_checkpoint, ckpt_mod.load_checkpoint = timed_save, \
        timed_load
    try:
        free = shutil.disk_usage(ckpt_dir).free
        require(free >= RESTART_ROOM * want,
                f"K: {free:,} bytes free under {ckpt_dir}, the checkpoint "
                f"needs {RESTART_ROOM} x {want:,}")
        base = ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq",
                str(TRAIN_SEQ), "--lr", str(TRAIN_LR), "--seed",
                str(TRAIN_SEED), "--device", "cuda", "--log-every", "1",
                "--ckpt-dir", ckpt_dir]
        argv1 = base + ["--steps", str(RESTART_K + 1), "--ckpt-every",
                        str(RESTART_K)]
        argv2 = base + ["--steps", str(RESTART_K + 3), "--ckpt-every",
                        str(100 * RESTART_K)]
        ms = {1: [], 2: []}
        peak = {}
        torch.cuda.reset_peak_memory_stats()
        t = time.monotonic()
        rec = {1: {}, 2: {}}
        (losses1, state), launches1 = drive(
            torch, "K run 1", lambda: train_lm.run(
                argv1, on_step=lambda s, loss, dt, st: ms[1].append(
                    dt * 1e3), record=rec[1]))
        secs["run1"] = time.monotonic() - t
        peak[1] = torch.cuda.max_memory_allocated()
        saved = ckpt_mod.latest_step(ckpt_dir)
        require(saved == RESTART_K and len(io_s["save"]) == 1,
                f"K: saved {saved}, {len(io_s['save'])} saves")
        n_bytes = ckpt_mod.checkpoint_bytes(ckpt_dir, saved)

        t = time.monotonic()
        differ = ckpt_mod.differing_leaves(ckpt_dir, state, saved)
        n_leaves = len(ckpt_mod.reference_leaves(state))
        secs["hold1"] = time.monotonic() - t
        print(f"[main K] run 1: checkpoint of step {saved}, {n_leaves} "
              f"leaves, {n_bytes:,} bytes; leaves differing from the live "
              f"state on the card: {differ}", flush=True)
        require(not differ, f"K: leaves on disk differ from the state: "
                            f"{differ}")

        t = time.monotonic()
        args = train_lm.build_parser().parse_args(argv2)
        _, _, step_cfg, data = train_lm.configure(args)
        batch = train_lm.to_device(data.batch(RESTART_K), "cuda")

        def batch_loss(st) -> float:
            """The train step's loss of batch RESTART_K on ``st``."""
            grads, loss, _ = steps.loss_and_grads(st.params, cfg, step_cfg,
                                                  batch)
            del grads
            _free(torch)
            return float(loss)

        l_star = batch_loss(state)
        del state
        _free(torch)
        secs["hold2"] = time.monotonic() - t

        after = []                   # batch RESTART_K after its replay

        def on_step2(s, loss, dt, st):
            ms[2].append(dt * 1e3)
            if s == RESTART_K:
                t4 = time.monotonic()
                after.append(batch_loss(st))
                secs["hold4"] = time.monotonic() - t4

        tee = _Tee(sys.stdout)
        torch.cuda.reset_peak_memory_stats()
        t = time.monotonic()
        with contextlib.redirect_stdout(tee):
            (losses2, state), launches2 = drive(
                torch, "K run 2", lambda: train_lm.run(
                    argv2, on_step=on_step2, record=rec[2]))
        secs["run2"] = time.monotonic() - t - secs.get("hold4", 0.0)
        peak[2] = torch.cuda.max_memory_allocated()
        del state
        _free(torch)
    finally:
        ckpt_mod.save_checkpoint, ckpt_mod.load_checkpoint = save, load
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    resumed = f"[restore] resumed from step {RESTART_K}" in "".join(
        tee.lines)
    gap = abs(losses2[0] - l_star) / abs(l_star)
    learned = losses1[RESTART_K] - l_star
    replayed = l_star - after[0] if after else float("nan")
    launches = {k: launches1[k] + launches2[k] for k in KERNELS}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_ms = {r: statistics.median(v[1:]) for r, v in ms.items()}
    save_s, load_s = io_s["save"][0], io_s["load"][0]
    print(f"[main K] {TRAIN_ARCH} through a restart at published widths "
          f"({n_params:,} parameters), {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
          f"bf16, remat, lr {TRAIN_LR}: run 1 losses {losses1}; run 2 "
          f"resumed from step {RESTART_K}: {resumed}, losses {losses2}; "
          f"L* {l_star!r} against run 2's first {losses2[0]!r}, rel gap "
          f"{gap:.3e} (tolerance {RESTART_TOL}); batch {RESTART_K} "
          f"{learned:.4f} nats below its run-1 loss after its update, "
          f"{after[0] if after else None!r} after run 2's replay of it, "
          f"{replayed:.4f} nats below L*; run 2's last {losses2[-1] - losses1[0]:+.4f} from run 1's "
          f"first (not held); launches {launches}", flush=True)
    print(f"[main K] step ms run 1 {[round(v, 3) for v in ms[1]]}, run 2 "
          f"{[round(v, 3) for v in ms[2]]}: median from the second step "
          f"{step_ms[1]:.4f} / {step_ms[2]:.4f} ms, "
          f"{tokens / step_ms[1] * 1e3:.1f} / {tokens / step_ms[2] * 1e3:.1f}"
          f" tokens/s; peak {peak[1]:,} / {peak[2]:,} bytes allocated; card "
          f"{info['nvidia_smi']}", flush=True)
    print(f"[main K] checkpoint {n_bytes:,} bytes: save {save_s:.3f} s "
          f"({n_bytes / save_s / 1e9:.3f} GB/s), restore {load_s:.3f} s "
          f"({n_bytes / load_s / 1e9:.3f} GB/s): the machine's disk and "
          f"host link, not the card; {free:,} bytes free before the save "
          f"({free / n_bytes:.2f} x the checkpoint)", flush=True)
    require(resumed and len(losses2) == 3,
            f"K: run 2 did not resume from step {RESTART_K}")
    require(gap <= RESTART_TOL,
            f"K: run 2's first loss {losses2[0]} against L* {l_star}")
    require(all(math.isfinite(v) for v in losses1 + losses2 + [l_star]),
            f"K: a non-finite loss: {losses1} {losses2} {l_star}")
    require(learned > 0,
            f"K: batch {RESTART_K}'s loss {losses1[RESTART_K]} -> {l_star} "
            f"after its update, not lower")
    require(replayed > 0 and math.isfinite(after[0]),
            f"K: batch {RESTART_K}'s loss {l_star} -> {after} after run 2's "
            f"replay of it, not lower")
    require(launches == dict.fromkeys(KERNELS, 0), f"K: launches {launches}")
    summary = {"n_params": n_params, "losses_run1": losses1,
               "losses_run2": losses2,
               "grad_norms": {r: [m["grad_norm"] for m in rec[r]["steps"]]
                              for r in rec},
               "l_star": l_star, "rel_gap": gap,
               "learned_nats": learned, "after_replay": after[0],
               "replayed_nats": replayed,
               "step_ms": ms, "step_ms_median": step_ms,
               "tokens_per_s": {r: tokens / v * 1e3
                                for r, v in step_ms.items()},
               "peak_bytes": peak, "checkpoint_bytes": n_bytes,
               "n_leaves": n_leaves, "save_s": save_s, "restore_s": load_s,
               "save_gb_s": n_bytes / save_s / 1e9,
               "restore_gb_s": n_bytes / load_s / 1e9,
               "free_bytes_before": free,
               "seconds": dict(secs, save=save_s, restore=load_s)}
    return summary, launches


#: Path M: K's runs (the same flags, data stream and schedule) through
#: `train_lm` on a one-rank mesh over ``nccl``, in a process of its own
#: (``WORLD_SIZE=1``): the DTensor path end to end. Its losses and grad
#: norms hold K's within TRAIN_TOL relative (K runs the same driver on
#: one device; J's fixed batch is not train_lm's data stream, so J's step
#: time is printed beside M's, and J's numbers are not held).
MESH_TIMEOUT_S = 600


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _path_m_argv(ckpt_dir: str) -> tuple[list[str], list[str]]:
    """K's two runs' flags: run 1 to RESTART_K with a save there, run 2
    resumed to RESTART_K + 2."""
    base = ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--lr", str(TRAIN_LR), "--seed", str(TRAIN_SEED),
            "--device", "cuda", "--log-every", "1", "--ckpt-dir", ckpt_dir]
    return (base + ["--steps", str(RESTART_K + 1), "--ckpt-every",
                    str(RESTART_K)],
            base + ["--steps", str(RESTART_K + 3), "--ckpt-every",
                    str(100 * RESTART_K)])


def path_m_child(out_path: str) -> int:
    """The body of path M, in the process that ``WORLD_SIZE=1`` makes a
    one-rank mesh: K's two runs through ``train_lm.run``, the sharded
    checkpoint against the state, L* and the replay as K holds them, the
    launch counters from zero; everything measured goes to ``out_path``
    as JSON."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import train_lm
    from repro_torch.checkpoint import checkpoint as ckpt_mod
    from repro_torch.sharding.rules import is_dtensor
    from repro_torch.train import steps
    io_s = {"save": [], "load": []}
    save, load = ckpt_mod.save_checkpoint, ckpt_mod.load_checkpoint

    def timed_save(*a, **k):
        t = time.monotonic()
        out = save(*a, **k)
        io_s["save"].append(time.monotonic() - t)
        return out

    def timed_load(*a, **k):
        t = time.monotonic()
        out = load(*a, **k)
        torch.cuda.synchronize()
        io_s["load"].append(time.monotonic() - t)
        return out

    counters = _counters()
    for m in counters.values():
        m.launches = 0
    ckpt_dir = tempfile.mkdtemp(prefix="miredo-ckpt-mesh-")
    ckpt_mod.save_checkpoint, ckpt_mod.load_checkpoint = timed_save, \
        timed_load
    out = {"ms": {1: [], 2: []}, "peak": {}}
    try:
        argv1, argv2 = _path_m_argv(ckpt_dir)
        rec = {1: {}, 2: {}}
        torch.cuda.reset_peak_memory_stats()
        losses1, state = train_lm.run(
            argv1, record=rec[1], on_step=lambda s, loss, dt, st:
            out["ms"][1].append(dt * 1e3))
        out["peak"][1] = torch.cuda.max_memory_allocated()
        saved = ckpt_mod.latest_step(ckpt_dir)
        out["saved"] = saved
        out["checkpoint_bytes"] = ckpt_mod.checkpoint_bytes(ckpt_dir, saved)
        out["differ"] = ckpt_mod.differing_leaves(ckpt_dir, state, saved)
        out["dtensor_params"] = all(
            is_dtensor(p) for p in state.params.parameters())
        plan = rec[1]["plan"]
        args = train_lm.build_parser().parse_args(argv2)
        cfg, _, step_cfg, data = train_lm.configure(args)
        batch = train_lm.to_device(data.batch(RESTART_K),
                                   state.opt.step.device, plan)

        def batch_loss(st) -> float:
            _, loss, _ = steps.loss_and_grads(st.params, cfg, step_cfg,
                                              batch, plan.shard_fn())
            return float(loss.full_tensor() if is_dtensor(loss) else loss)

        out["l_star"] = batch_loss(state)
        del state
        _free(torch)
        after = []

        def on_step2(s, loss, dt, st):
            out["ms"][2].append(dt * 1e3)
            if s == RESTART_K:
                after.append(batch_loss(st))

        torch.cuda.reset_peak_memory_stats()
        losses2, state = train_lm.run(argv2, record=rec[2],
                                      on_step=on_step2)
        out["peak"][2] = torch.cuda.max_memory_allocated()
        # one more step under the profiler, as J's: the card's busy share
        # of a mesh step, where the host's DTensor dispatch would show
        _, opt_cfg, _, _ = train_lm.configure(args)
        step = steps.make_train_step(cfg, opt_cfg, step_cfg,
                                     rec[2]["plan"].shard_fn())
        held = {"state": state}
        batch = train_lm.to_device(data.batch(RESTART_K + 3),
                                   state.opt.step.device, rec[2]["plan"])
        del state

        def one():
            held["state"], _ = step(held["state"], batch)
        out["profile"] = _device_profile(torch, one, 1)
        del held, batch
        out.update(losses1=losses1, losses2=losses2, after=after,
                   metrics={r: rec[r]["steps"] for r in rec},
                   init_s={r: rec[r]["init_s"] for r in rec},
                   start_step={r: rec[r]["start_step"] for r in rec},
                   mesh=rec[1]["mesh"], save_s=io_s["save"],
                   restore_s=io_s["load"],
                   launches={k: m.launches for k, m in counters.items()})
    finally:
        ckpt_mod.save_checkpoint, ckpt_mod.load_checkpoint = save, load
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    Path(out_path).write_text(json.dumps(out))
    return 0


def phase_path_m(torch, info: dict, j: dict, k: dict) -> tuple:
    """Path M: `path_m_child` in a process with ``WORLD_SIZE=1`` on
    ``nccl`` (K's runs on a one-rank mesh); holds its losses and grad
    norms against K's (TRAIN_TOL relative), K's restart holds (resumed,
    run 2's first loss L*, the replay lowers it), the sharded checkpoint
    equal to the state, no kernel launched. Prints step ms beside J's and
    K's, tokens/s, peak bytes, the seconds to draw and place the state,
    save and restore seconds. Returns (summary, launches)."""
    _free(torch)
    with tempfile.TemporaryDirectory(prefix="miredo-mesh-") as tmp:
        out_path = os.path.join(tmp, "m.json")
        env = dict(os.environ, WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                   PYTHONPATH=str(ROOT / "src"))
        t = time.monotonic()
        res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                              "--path-m", out_path], env=env,
                             capture_output=True, text=True,
                             timeout=MESH_TIMEOUT_S)
        wall = time.monotonic() - t
        print(res.stdout[-4000:], end="", flush=True)
        require(res.returncode == 0, f"M: exit {res.returncode}: "
                f"{res.stderr[-3000:]}")
        m = json.loads(Path(out_path).read_text())
    losses = m["losses1"] + m["losses2"]
    gnorms = [r["grad_norm"] for r in m["metrics"]["1"] + m["metrics"]["2"]]
    k_losses = k["losses_run1"] + k["losses_run2"]
    k_gnorms = k["grad_norms"][1] + k["grad_norms"][2]
    gap = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(a, b))
    loss_gap, gnorm_gap = gap(losses, k_losses), gap(gnorms, k_gnorms)
    l_star = m["l_star"]
    restart_gap = abs(m["losses2"][0] - l_star) / abs(l_star)
    replayed = l_star - m["after"][0] if m["after"] else float("nan")
    step_ms = {r: statistics.median(v[1:]) for r, v in m["ms"].items()}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_bytes = m["checkpoint_bytes"]
    print(f"[main M] {TRAIN_ARCH} through train_lm on the mesh {m['mesh']} "
          f"(nccl, one rank; every parameter a DTensor: "
          f"{m['dtensor_params']}), K's flags: run 1 losses {m['losses1']}, "
          f"run 2 (resumed from step {m['start_step']['2']}) losses "
          f"{m['losses2']}; grad norms {gnorms}; against K (one device): "
          f"largest loss gap {loss_gap:.3e}, grad norm gap {gnorm_gap:.3e} "
          f"relative (tolerance {TRAIN_TOL}); L* {l_star!r} against run "
          f"2's first {m['losses2'][0]!r}, rel gap {restart_gap:.3e}; the "
          f"replay {replayed:.4f} nats below L*; checkpoint leaves "
          f"differing from the sharded state {m['differ']}; launches "
          f"{m['launches']}", flush=True)
    print(f"[main M] step ms run 1 {[round(v, 3) for v in m['ms']['1']]}, "
          f"run 2 {[round(v, 3) for v in m['ms']['2']]}: median from the "
          f"second step {step_ms['1']:.4f} / {step_ms['2']:.4f} ms "
          f"({tokens / step_ms['1'] * 1e3:.1f} tokens/s) beside J's "
          f"{j['step_ms_median']:.4f} ms and K's "
          f"{k['step_ms_median'][1]:.4f} / {k['step_ms_median'][2]:.4f} ms; "
          f"peak {m['peak']['1']:,} / {m['peak']['2']:,} bytes allocated "
          f"(J {j['peak_bytes']:,}); state drawn and placed in "
          f"{m['init_s']['1']:.3f} / {m['init_s']['2']:.3f} s; checkpoint "
          f"{n_bytes:,} bytes: save {m['save_s'][0]:.3f} s, restore "
          f"{m['restore_s'][0]:.3f} s; {wall:.1f} s wall in all; card "
          f"{info['nvidia_smi']}", flush=True)
    prof = m["profile"]
    print(f"[main M] train step on the mesh profiled: wall "
          f"{prof['wall_ms']:.4f} ms, device busy {prof['device_ms']:.4f} "
          f"ms, busy share {1 - prof['idle_share']:.4f} (J "
          f"{1 - j['profile']['idle_share']:.4f}), "
          f"{prof['kernels_per_step']:.0f} kernels a step (J "
          f"{j['profile']['kernels_per_step']:.0f}); costliest "
          f"{prof['top']}", flush=True)
    require(m["dtensor_params"], "M: the state is not on the mesh")
    require(m["saved"] == RESTART_K and not m["differ"],
            f"M: checkpoint of step {m['saved']}, differing {m['differ']}")
    require(m["start_step"]["2"] == RESTART_K and len(m["losses2"]) == 3,
            f"M: run 2 did not resume from step {RESTART_K}")
    require(all(math.isfinite(v) for v in losses + gnorms + [l_star]),
            f"M: a non-finite metric: {losses} {gnorms} {l_star}")
    require(loss_gap <= TRAIN_TOL and gnorm_gap <= TRAIN_TOL,
            f"M: against K, loss gap {loss_gap}, grad norm gap {gnorm_gap}")
    require(restart_gap <= RESTART_TOL,
            f"M: run 2's first loss {m['losses2'][0]} against L* {l_star}")
    require(replayed > 0, f"M: the replay of batch {RESTART_K} did not "
                          f"lower L* {l_star}: {m['after']}")
    launches = m["launches"]
    require(launches == dict.fromkeys(KERNELS, 0), f"M: launches {launches}")
    summary = {"mesh": m["mesh"], "losses": losses, "grad_norms": gnorms,
               "loss_gap_vs_k": loss_gap, "grad_norm_gap_vs_k": gnorm_gap,
               "l_star": l_star, "restart_gap": restart_gap,
               "replayed_nats": replayed, "step_ms": m["ms"],
               "step_ms_median": step_ms,
               "tokens_per_s": tokens / step_ms["1"] * 1e3,
               "peak_bytes": m["peak"], "init_s": m["init_s"],
               "checkpoint_bytes": n_bytes, "save_s": m["save_s"][0],
               "restore_s": m["restore_s"][0], "profile": prof,
               "seconds": wall}
    return summary, launches


#: Path L's scorer pools: `baselines.heuristic_search`'s candidates at
#: this budget for (pack, arch, shape, op). No row of path A's ffn_up pool
#: passes eq. 9, so only the ungated pack runs the recursion on it; about
#: a quarter of path B's ssd_s_chunk pool is feasible, so its gated pack
#: (the scorer's default) scores real rows and decides the search's
#: winner.
SCORER_POOL = 65_536
SCORER_POOLS = (("ungated", "glm4-9b", "decode_32k", "ffn_up"),
                ("gated", "mamba2-1.3b", "prefill_32k", "ssd_s_chunk"))
SCORE_FIELDS = ("cycles", "energy_pj", "edp", "idealized", "feasible")


def _median_ms(fn, reps: int) -> float:
    """Median wall time of ``fn`` in ms; ``fn`` returns host arrays (the
    torch backend copies its results back, so each call has synchronised
    with the card before it returns)."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _path_l_scorer(torch, info: dict) -> dict:
    """``[scorer]``: the batched scorer's NumPy loop on the host against its
    torch backend (float64) on the card, over heuristic_search's pools of
    SCORER_POOL mappings (`SCORER_POOLS`): cycles, energy, EDP, idealized
    time and feasibility bit-equal; then the search's choice
    (`baselines.pick_winner`, ranked by the idealized time and by the
    cycles) from each backend's scores of the gated pool: equal, and from
    its feasible rows, not the greedy fallback."""
    import numpy as np

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core import baselines
    from repro_torch.core import latency_batched as lb
    from repro_torch.core.arch import default_arch
    from repro_torch.core.frontend import extract_workload
    arch = default_arch()
    out = {}
    for label, arch_id, shape, op in SCORER_POOLS:
        gated = label == "gated"
        layer = next(l for l in extract_workload(
            get_config(arch_id), SHAPES[shape]).layers
            if l.name.rsplit(".", 1)[-1] == op)
        t = time.monotonic()
        pool = baselines.candidate_pool(layer, arch, budget=SCORER_POOL)
        sample_s = time.monotonic() - t
        require(len(pool) >= 65_536, f"L: pool of {len(pool)}")
        t = time.monotonic()
        pb = lb.pack(pool, layer, arch, need=lb.ALL_NEEDS if gated
                     else ("latency", "energy", "ideal"))
        pack_s = time.monotonic() - t
        scores = {"numpy": lb.evaluate_batch(pb, backend="numpy"),
                  "torch": lb.evaluate_batch(pb, backend="torch",
                                             device="cuda")}
        host, card = scores["numpy"], scores["torch"]
        for f in SCORE_FIELDS:
            a, b = getattr(host, f), getattr(card, f)
            require((a is None and b is None) or (
                a.dtype == b.dtype and np.array_equal(a, b)),
                f"L: scorer {label} {f} differs between numpy and torch")
        finite = int(np.isfinite(host.cycles).sum())
        ms = {"numpy": _median_ms(lambda: lb.evaluate_batch(
                  pb, backend="numpy"), 3),
              "torch": _median_ms(lambda: lb.evaluate_batch(
                  pb, backend="torch", device="cuda"), 5)}
        row = {"layer": layer.name, "pool": len(pool), "sample_s": sample_s,
               "pack_s": pack_s, "ms": ms, "slots": pb.nf.shape[1],
               "feasible": int(host.feasible.sum())
               if host.feasible is not None else None,
               "finite_cycles": finite}
        print(f"[scorer] {layer.name} pool {len(pool)} ({label}, "
              f"{row['slots']} slots, {finite} finite cycles, "
              f"{row['feasible']} feasible): numpy {ms['numpy']:.3f} ms, "
              f"torch on the card {ms['torch']:.3f} ms; cycles, energy, "
              f"EDP, idealized and feasibility bit-equal; sampling "
              f"{sample_s:.1f} s, packing {pack_s:.1f} s; card "
              f"{info['nvidia_smi']}", flush=True)
        if gated:
            row["winner"] = {}
            for accurate in (False, True):
                a, b = (baselines.pick_winner(pool, scores[k], layer, arch,
                                              accurate=accurate)
                        for k in ("numpy", "torch"))
                by = "cycles" if accurate else "idealized"
                require(a == b, f"L: heuristic_search winners by {by} "
                        f"differ: {a} vs {b}")
                require(a.n_feasible > 0, f"L: no feasible row in "
                        f"{layer.name}'s pool")
                row["winner"][by] = {
                    "chosen_by_cost": a.chosen_by_cost,
                    "eval_latency": a.eval_latency,
                    "n_feasible": a.n_feasible, "n_sampled": a.n_sampled}
                print(f"[scorer] heuristic_search winner by {by} equal on "
                      f"both backends: cost {a.chosen_by_cost}, latency "
                      f"{a.eval_latency}, {a.n_feasible} of {a.n_sampled} "
                      f"feasible", flush=True)
        out[label] = row
    return out


def _path_l_bridge(torch, info: dict, mm_rows: list[dict], timer) -> tuple:
    """``[bridge mip]``: every unique GEMM shape of paths A and B (phase 4's
    matmul rows) through `gpu_bridge.select_matmul_blocks`, then
    matmul_int8 at the pick. The picks and one launch each are path L's
    main path (counters zeroed around them); each launch is held
    bit-equal to the plain version at unit scales there. Then, outside
    the count, a launch with real scales within NUMERICS_TOL and the
    pick's time beside the mapping-derived pick's from phase 4."""
    from repro_torch.core.executor import NUMERICS_TOL, spearman
    from repro_torch.core.gpu_bridge import select_matmul_blocks
    from repro_torch.kernels.matmul_int8 import kernel as mm_kernel
    from repro_torch.kernels.matmul_int8.ref import matmul_int8_ref
    mapped: dict = {}
    for r in mm_rows:
        if r["path"] in ("A", "B"):
            mapped.setdefault(tuple(r["shape"]), r)
    g = torch.Generator(device="cuda")
    g.manual_seed(1)

    def main_path():
        picks = {}
        for shape in mapped:
            m, k, n = shape
            t = time.perf_counter()
            c = select_matmul_blocks(m, k, n)
            solve_ms = (time.perf_counter() - t) * 1e3
            require(c.status != "fallback", f"L: the bridge MIP fell back "
                    f"at {shape}: {c}")
            x = torch.randint(-127, 128, (m, k), dtype=torch.int8,
                              device="cuda", generator=g)
            w = torch.randint(-127, 128, (k, n), dtype=torch.int8,
                              device="cuda", generator=g)
            one_m = torch.ones(m, device="cuda")
            one_n = torch.ones(n, device="cuda")
            out = mm_kernel.matmul_int8(x, w, one_m, one_n, bm=c.bm,
                                        bk=c.bk, bn=c.bn,
                                        out_dtype=torch.float32)
            require(torch.equal(out, matmul_int8_ref(
                x, w, one_m, one_n, torch.float32)),
                f"L: matmul_int8 at the MIP's pick {(c.bm, c.bk, c.bn)} "
                f"differs from the plain version at {shape}")
            picks[shape] = (c, solve_ms, x, w)
            del out
        return picks

    picks, launches = drive(torch, "L", main_path)
    rows = []
    for shape, (c, solve_ms, x, w) in picks.items():
        m, k, n = shape
        xs = torch.rand(m, device="cuda", generator=g) / 127
        ws = torch.rand(n, device="cuda", generator=g) / 127
        kern = lambda: mm_kernel.matmul_int8(x, w, xs, ws, bm=c.bm, bk=c.bk,
                                             bn=c.bn,
                                             out_dtype=torch.float32)
        out, ref = kern(), matmul_int8_ref(x, w, xs, ws, torch.float32)
        rel = float((out.double() - ref.double()).norm() /
                    ref.double().norm())
        require(rel <= NUMERICS_TOL["matmul_int8"],
                f"L: matmul_int8 at {shape} pick rel err {rel}")
        mrow = mapped[shape]
        row = {"shape": shape, "pick": (c.bm, c.bk, c.bn),
               "status": c.status, "smem_bytes": c.smem_bytes,
               "est_ms": c.est_seconds * 1e3, "solve_ms": solve_ms,
               "rel_err": rel, "ms": timer(kern),
               "mapping_path": mrow["path"], "mapping_op": mrow["op"],
               "mapping_blocks": tuple(mrow["blocks"]),
               "mapping_ms": mrow["ms"]}
        rows.append(row)
        print(f"[bridge mip] {json.dumps(row)}", flush=True)
        del out, ref
    picks.clear()
    torch.cuda.empty_cache()
    rho = spearman([r["est_ms"] for r in rows], [r["ms"] for r in rows])
    print(f"[bridge mip] {len(rows)} shapes; spearman of the MIP's "
          f"estimate against the measured time at its pick {rho} (a "
          f"finding, not a hold); card {info['nvidia_smi']}", flush=True)
    return {"rows": rows, "spearman": rho}, launches


def _path_l_dryrun(info: dict) -> dict:
    """``[plan]`` / ``[dryrun]``: `launch.dryrun` for glm4-9b decode_32k on
    the single-pod mesh, in a subprocess (the fake process group is
    process-wide): exit 0 and status ok; per-device parameter and cache
    GB against the card's memory; `roofline_terms`."""
    from repro_torch.launch.mesh import HBM_BYTES
    from repro_torch.launch.roofline import roofline_terms
    with tempfile.TemporaryDirectory(prefix="miredo-dryrun-") as out:
        t = time.monotonic()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "glm4-9b", "--shape", "decode_32k", "--out", out],
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            capture_output=True, text=True, timeout=600)
        secs = time.monotonic() - t
        require(res.returncode == 0, f"L: dryrun exit {res.returncode}: "
                f"{res.stdout[-1500:]} {res.stderr[-1500:]}")
        rec = json.loads((Path(out) / "glm4-9b__decode_32k__single.json")
                         .read_text())
    require(rec["status"] == "ok", f"L: dryrun status {rec['status']}")
    require(rec["flops_error"] is None and rec["flops_global"] > 0,
            f"L: dryrun counted no flops: {rec['flops_error']}")
    by = rec["bytes_per_device_by_kind"]
    per_dev = rec["bytes_per_device"]
    terms = roofline_terms(rec)
    summary = {"seconds": secs, "mesh": rec["mesh"],
               "params_gb": by["params"] / 1e9,
               "caches_gb": by["caches"] / 1e9,
               "inputs_bytes": by["inputs"], "total_gb": per_dev / 1e9,
               "fits_hbm": per_dev <= HBM_BYTES,
               "flops_per_device": rec["flops_per_device"],
               "flops_global": rec["flops_global"],
               "roofline": {k: terms[k] for k in (
                   "t_compute_s", "t_memory_s", "t_collective_s",
                   "dominant", "useful_compute_ratio", "roofline_fraction",
                   "hbm_gb_per_device")}}
    print(f"[plan] glm4-9b decode_32k on {rec['mesh']}: per device "
          f"{summary['params_gb']:.4f} GB of parameters, "
          f"{summary['caches_gb']:.4f} GB of KV cache, {by['inputs']} bytes "
          f"of inputs; {summary['total_gb']:.4f} GB in all, "
          f"{'fits' if summary['fits_hbm'] else 'does not fit'} the "
          f"card's {HBM_BYTES / 1e9:.0f} GB", flush=True)
    summary["record_seconds"] = rec["seconds"]
    summary["seconds_counting_flops"] = rec["seconds_counting_flops"]
    print(f"[dryrun] exit 0, status ok in {secs:.1f} s (the cell "
          f"{rec['seconds']} s, of it counting flops "
          f"{rec['seconds_counting_flops']} s); flops global "
          f"{rec['flops_global']}, per device {rec['flops_per_device']} "
          f"(global/devices); "
          f"roofline {json.dumps(summary['roofline'])}", flush=True)
    coll = rec["collective_bytes_per_device"]
    require(coll is not None and terms["t_collective_s"] is not None,
            f"L: no collective bytes: {rec.get('collective_reason')}")
    summary["collective_bytes_per_device"] = coll
    summary["seconds_counting_collectives"] = \
        rec["seconds_counting_collectives"]
    print(f"[dryrun] collective bytes per device by kind {json.dumps(coll)}"
          f" (counted in {rec['seconds_counting_collectives']} s): "
          f"t_collective {terms['t_collective_s']!r} s at one card's "
          f"NVLink rate, beside t_compute {terms['t_compute_s']!r} s and "
          f"t_memory {terms['t_memory_s']!r} s", flush=True)
    return summary


def phase_path_l(torch, info: dict, mm_rows: list[dict], timer) -> tuple:
    """Path L: the batched scorer on the card, the bridge MIP's picks on
    matmul_int8 (the path's launches), and the sharding plan's dry run.
    Returns (summary, launches)."""
    t = time.monotonic()
    scorer = _path_l_scorer(torch, info)
    t_scorer = time.monotonic() - t
    bridge, launches = _path_l_bridge(torch, info, mm_rows, timer)
    t_bridge = time.monotonic() - t - t_scorer
    dry = _path_l_dryrun(info)
    require(launches["matmul_int8"] == len(bridge["rows"]) and
            launches["flash_attention"] == 0 and launches["ssd_scan"] == 0,
            f"L: launches {launches}")
    return {"scorer": scorer, "bridge": bridge, "dryrun": dry,
            "seconds": {"scorer": t_scorer, "bridge": t_bridge,
                        "dryrun": dry["seconds"]}}, launches


def phase_path_n(torch, info: dict, timer) -> tuple:
    """Path N, the bridge bench on the card: `gpu_bridge_bench.bench_rows`
    (the MIP's matmul_int8 pick for each arch's dominant GEMM at published
    widths: 65,536 tokens x d_model x max(ff / 16, 128)), then one
    launch at each pick, bit-equal to the plain version at unit scales
    (int32 sums, exact in float32 at these K): the path's counted
    launches. Outside the count: the pick within NUMERICS_TOL at real
    scales, then timed at the pick and at every tile of the kernel's set
    (each tile's output bit-equal first); per shape the fastest tile,
    the pick's gap to it, the Spearman of the model's time
    (`gpu_bridge.matmul_seconds`) against the measured over the tiles,
    the model over the measured at the pick and the pick's share of the
    int8 tensor-core bound; where n is not a multiple of 16, the pick
    also timed with w's columns zero-padded to the next one (first n
    columns bit-equal), its share of the unpadded GEMM's bound beside.
    No hold on the gap, the Spearman or the padded time: they are
    findings."""
    from repro_torch import gpu_bridge_bench
    from repro_torch.core.executor import NUMERICS_TOL, spearman
    from repro_torch.core.gpu_bridge import matmul_seconds
    from repro_torch.kernels.matmul_int8 import kernel as mm_kernel
    from repro_torch.kernels.matmul_int8.ref import matmul_int8_ref
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    tiles = [(bm, bk, bn) for bm in mm_kernel.BM_TILES
             for bk in mm_kernel.BK_TILES for bn in mm_kernel.BN_TILES]

    def main_path():
        t = time.monotonic()
        rows = gpu_bridge_bench.bench_rows()
        solve_s = time.monotonic() - t
        picks = []
        for r in rows:
            require(r["status"] != "fallback" and r["fits"],
                    f"N: the bridge MIP's pick for {r['arch']}: {r}")
            (m, k, n), (bm, bk, bn) = r["gemm"], r["pick"]
            x = torch.randint(-127, 128, (m, k), dtype=torch.int8,
                              device="cuda", generator=g)
            w = torch.randint(-127, 128, (k, n), dtype=torch.int8,
                              device="cuda", generator=g)
            one_m = torch.ones(m, device="cuda")
            one_n = torch.ones(n, device="cuda")
            out = mm_kernel.matmul_int8(x, w, one_m, one_n, bm=bm, bk=bk,
                                        bn=bn, out_dtype=torch.float32)
            ref = matmul_int8_ref(x, w, one_m, one_n, torch.float32)
            require(torch.equal(out, ref),
                    f"N: matmul_int8 at the pick {(bm, bk, bn)} differs from "
                    f"the plain version at {(m, k, n)} ({r['arch']})")
            picks.append((r, x, w))
            del out, ref
        return picks, solve_s

    (picks, solve_s), launches = drive(torch, "N", main_path)
    require(launches["matmul_int8"] == len(picks) == 10 and
            launches["flash_attention"] == 0 and launches["ssd_scan"] == 0,
            f"N: launches {launches}")
    rows = []
    for r, x, w in picks:
        (m, k, n), pick = r["gemm"], tuple(r["pick"])
        one_m = torch.ones(m, device="cuda")
        one_n = torch.ones(n, device="cuda")
        xs = torch.rand(m, device="cuda", generator=g) / 127
        ws = torch.rand(n, device="cuda", generator=g) / 127
        call = lambda t, a, b: mm_kernel.matmul_int8(
            x, w, a, b, bm=t[0], bk=t[1], bn=t[2], out_dtype=torch.float32)
        out, ref = call(pick, xs, ws), matmul_int8_ref(x, w, xs, ws,
                                                        torch.float32)
        rel = float((out.double() - ref.double()).norm() /
                    ref.double().norm())
        max_abs = float((out - ref).abs().max())
        require(rel <= NUMERICS_TOL["matmul_int8"],
                f"N: matmul_int8 at {(m, k, n)} pick rel err {rel}")
        del out, ref
        exact = matmul_int8_ref(x, w, one_m, one_n, torch.float32)
        ms = {}
        for t in tiles:
            require(torch.equal(call(t, one_m, one_n), exact),
                    f"N: matmul_int8 at tile {t} differs from the plain "
                    f"version at {(m, k, n)}")
            ms[t] = timer(lambda: call(t, xs, ws))
        pick_ms = timer(lambda: call(pick, xs, ws))
        # n not a multiple of 16: the same GEMM with w's columns padded
        # with zeros to the next one, at the pick, its first n columns
        # bit-equal (the alignment hypothesis of PERF.md §7)
        n_pad, pad_ms = -(-n // 16) * 16, None
        if n_pad != n:
            w_pad = torch.nn.functional.pad(w, (0, n_pad - n))
            ws_pad = torch.nn.functional.pad(ws, (0, n_pad - n))
            one_pad = torch.ones(n_pad, device="cuda")
            pad = lambda a, b: mm_kernel.matmul_int8(
                x, w_pad, a, b, bm=pick[0], bk=pick[1], bn=pick[2],
                out_dtype=torch.float32)
            require(torch.equal(pad(one_m, one_pad)[:, :n], exact),
                    f"N: matmul_int8 with n padded to {n_pad} differs from "
                    f"the plain version at {(m, k, n)}")
            pad_ms = timer(lambda: pad(xs, ws_pad))
            del w_pad
        del exact
        fastest = min(ms, key=ms.get)
        model = [matmul_seconds(m, k, n, t[0], t[2]) * 1e3 for t in tiles]
        tc_ms = 2.0 * m * n * k / PEAK_OPS_S["int8"] * 1e3
        b_ms, b_by = bound_ms(m * k + k * n + 4 * (m + n) + 4 * m * n,
                              2.0 * m * n * k, "int8")
        row = {"arch": r["arch"], "gemm": [m, k, n], "pick": list(pick),
               "status": r["status"], "est_ms": r["est_ms"],
               "pick_ms": pick_ms, "fastest": list(fastest),
               "fastest_ms": ms[fastest],
               "gap_to_fastest": pick_ms / ms[fastest] - 1.0,
               "spearman_model_vs_time": spearman(model, [ms[t]
                                                          for t in tiles]),
               "model_over_measured": r["est_ms"] / pick_ms,
               "int8_tc_bound_ms": tc_ms, "tc_share": tc_ms / pick_ms,
               "bound_ms": b_ms, "bound_by": b_by,
               "largest_ms": ms[(128, 128, 128)], "n_padded": n_pad,
               "padded_ms": pad_ms, "padded_tc_share":
                   None if pad_ms is None else tc_ms / pad_ms,
               "rel_err": rel,
               "max_abs_err": max_abs}
        rows.append(row)
        print(f"[bridge bench] {json.dumps(row)}", flush=True)
        print(f"[bridge bench] {r['arch']} ms by tile (bm x bk x bn): "
              + ", ".join(f"{a}x{b}x{c} {v:.4f}"
                          for (a, b, c), v in ms.items()), flush=True)
    picks.clear()
    torch.cuda.empty_cache()
    at_fastest = sum(tuple(r["pick"]) == tuple(r["fastest"]) for r in rows)
    print(f"[bridge bench] {len(rows)} shapes, the pick the fastest tile at "
          f"{at_fastest}; gap to the fastest "
          f"{min(r['gap_to_fastest'] for r in rows):.4f}.."
          f"{max(r['gap_to_fastest'] for r in rows):.4f}; model over "
          f"measured at the pick "
          f"{min(r['model_over_measured'] for r in rows):.4f}.."
          f"{max(r['model_over_measured'] for r in rows):.4f}; bench "
          f"solves {solve_s:.2f} s; card {info['nvidia_smi']}", flush=True)
    return {"rows": rows, "solve_s": solve_s}, launches


#: ``[hillclimb]``'s cells: (cell, variant, the MoE dispatch its baseline is
#: lowered with, or None for the module defaults in the variant's
#: process).
HILLCLIMB_CELLS = (("glm4-9b:decode_32k:single", "kv-int8", None),
                   ("minicpm-2b:train_4k:single", "no-remat", None),
                   ("qwen2-moe-a2.7b:train_4k:single", "moe-scatter",
                    "einsum"))
HILLCLIMB_TIMEOUT_S = 600
#: Lowers a dry-run cell under a MoE dispatch: argv the dispatch, then the
#: dry run's own.
_BASELINE = ("import sys\n"
             "from repro_torch.models import moe\n"
             "moe.MOE_DISPATCH = sys.argv[1]\n"
             "from repro_torch.launch import dryrun\n"
             "sys.exit(dryrun.main(sys.argv[2:]))\n")


def _hillclimb_cell(cell: str, variant: str, dispatch, work: Path) -> dict:
    """One ``[hillclimb]`` cell, its baseline first when it has one, each
    command a process of its own; requires the record's baseline to be
    the dry run's record written by the baseline process (or the module
    defaults when there is none) and returns the variant's record, the
    module's delta lines and the seconds."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    arch, shape, mesh = cell.split(":")
    out, base = work / "out", work / "base"
    cmds = []
    if dispatch:
        cmds.append([sys.executable, "-c", _BASELINE, dispatch, "--arch",
                     arch, "--shape", shape, "--out", str(base)])
    cmds.append([sys.executable, "-m", "repro_torch.perf_hillclimb",
                 "--cell", cell, "--variant", variant, "--out", str(out)] +
                (["--baseline", str(base)] if dispatch else []))
    t = time.monotonic()
    stdout = ""
    for cmd in cmds:
        res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=HILLCLIMB_TIMEOUT_S)
        require(res.returncode == 0, f"hillclimb {cell} {variant}: exit "
                f"{res.returncode}: {res.stdout[-1500:]} "
                f"{res.stderr[-1500:]}")
        stdout = res.stdout
    rec = json.loads((out / f"{arch}__{shape}__{mesh}__{variant}.json")
                     .read_text())
    want = (str(base / f"{arch}__{shape}__{mesh}.json") if dispatch
            else "lowered at the module defaults")
    require(rec["baseline"] == want, f"hillclimb {cell} {variant}: "
            f"baseline {rec['baseline']!r}, expected {want!r}")
    return {"record": rec, "seconds": time.monotonic() - t,
            "lines": [l for l in stdout.splitlines() if l.startswith("   ")]}


def phase_hillclimb(info: dict) -> dict:
    """``[hillclimb]``: `repro_torch.perf_hillclimb` over HILLCLIMB_CELLS at
    published widths (meta tensors on the fake process group, host only),
    the cells at once, each in its own processes with a time limit. Each
    must exit 0 with the variant's and the baseline's records ok and
    their memory counts (bytes accessed, peak, temporaries per device and
    over the mesh) non-null. The deltas are findings, not holds."""
    from concurrent.futures import ThreadPoolExecutor
    with tempfile.TemporaryDirectory(prefix="miredo-hillclimb-") as tmp:
        with ThreadPoolExecutor(len(HILLCLIMB_CELLS)) as pool:
            futures = [pool.submit(_hillclimb_cell, cell, variant, dispatch,
                                   Path(tmp) / str(i))
                       for i, (cell, variant, dispatch)
                       in enumerate(HILLCLIMB_CELLS)]
            done = [f.result() for f in futures]
    out = {}
    keys = ("flops_per_device", "bytes_per_device",
            "bytes_accessed_per_device")
    mem_keys = ("peak_bytes", "temp_bytes_per_device", "temp_bytes")
    for (cell, variant, dispatch), d in zip(HILLCLIMB_CELLS, done):
        rec = d["record"]
        for side in ("after_raw", "before_raw"):
            raw = rec[side]
            require(raw["status"] == "ok", f"hillclimb {cell} {variant}: "
                    f"{side} status {raw['status']}: {raw.get('error')}")
            require(raw["bytes_accessed_per_device"] is not None and
                    all(raw["memory"][k] is not None for k in mem_keys),
                    f"hillclimb {cell} {variant}: {side} memory counts "
                    f"null: {raw['memory']}")
        summary = {"cell": cell, "variant": variant,
                   "baseline": rec["baseline"],
                   "baseline_dispatch": dispatch, "seconds": d["seconds"]}
        for side, tag in (("before_raw", "before"), ("after_raw", "after")):
            raw = rec[side]
            summary[tag] = {**{k: raw[k] for k in keys},
                            **{k: raw["memory"][k] for k in mem_keys},
                            "hbm_gb_per_device":
                                rec[tag]["hbm_gb_per_device"]}
        out[f"{cell} {variant}"] = summary
        print(f"[hillclimb] {json.dumps(summary)}", flush=True)
        for line in d["lines"]:
            print(f"[hillclimb] {cell} {variant} {line.strip()}", flush=True)
    print(f"[hillclimb] {len(out)} records, status ok, memory counted; "
          f"card {info['nvidia_smi']}", flush=True)
    return out


def phase_path_e(torch, info: dict) -> tuple:
    """mamba2-1.3b served at its published widths. Its forward runs the
    plain SSD product, as the reference's does; beside it the path runs
    ``ssd_chunked(use_kernel=True)`` on layer 0's SSD operands of this
    prefill, (b 4, nc 2, Q 256, h 64, N 128, P 64), and holds it against
    ``use_kernel=False``."""
    from repro_torch import serve_lm
    from repro_torch.core.executor import NUMERICS_TOL
    from repro_torch.models.layers import embed, rms_norm
    from repro_torch.models.ssm import ssd_chunked, ssd_inputs
    from repro_torch.train.steps import StepConfig, make_decode_step

    def run():
        rep = serve_lm.main(_live_args("mamba2-1.3b"))
        cfg, blk = rep.model.cfg, rep.model.blocks[0]
        with torch.no_grad():
            x = rms_norm(blk.ln, embed(rep.model.embed, rep.prompt,
                                       torch.float32), cfg.norm_eps)
            _, xs, dt, a, bm, cm, _ = ssd_inputs(blk.mamba, x, cfg)
            args = (xs, dt, a, bm, cm, blk.mamba.d_skip)
            return rep, args, ssd_chunked(*args, use_kernel=True)
    (rep, args, (y, h)), launches = drive(torch, "E", run)
    none = {"flash_attention": 0, "ssd_scan": 0}
    require(rep.launches["prefill"] == none and
            all(d == none for d in rep.launches["decode"]),
            f"E: the forward launched {rep.launches}")
    require(launches == {"matmul_int8": 0, "flash_attention": 0,
                         "ssd_scan": 1}, f"E: launches {launches}")
    summary = _live_summary("E", rep, info)
    with torch.no_grad():
        y_ref, h_ref = ssd_chunked(*args, use_kernel=False)
    tol = NUMERICS_TOL["ssd_scan"]
    rel_y, rel_h = _rel(y, y_ref), _rel(h, h_ref)
    xs, bm = args[0], args[3]
    shape = (xs.shape[0], xs.shape[1] // 256, 256, xs.shape[2], bm.shape[3],
             xs.shape[3])
    print(f"[main E] ssd_chunked(use_kernel=True) on layer 0's operands "
          f"{shape} (b, nc, Q, h, N, P) vs use_kernel=False: y rel err "
          f"{rel_y:.3e}, max abs err {float((y - y_ref).abs().max()):.3e}, "
          f"final state rel err {rel_h:.3e} (tolerance {tol})", flush=True)
    require(rel_y <= tol and rel_h <= tol,
            f"E: ssd_chunked kernel vs plain rel err {rel_y}, {rel_h}")
    decode = make_decode_step(rep.model.cfg, StepConfig(
        compute_dtype=torch.float32))
    profiled = _profile_decode(torch, "E", info, decode, rep.model,
                               rep.tokens[:, -1:], rep.caches)
    summary.update(ssd_shape=shape, ssd_rel_err=rel_y,
                   decode_profile=profiled)
    del rep, args, y, h, y_ref, h_ref, decode
    _free(torch)
    return summary, launches


def unique_ops(plan, kernel: str) -> list[tuple]:
    """(first op, instances in the plan) per structurally unique op."""
    first: dict = {}
    for op in plan.ops:
        if op.kernel == kernel:
            first.setdefault(op.key, op)
    return [(op, sum(o.count for o in plan.ops if o.key == key))
            for key, op in first.items()]


def matmul_rows(torch, plans, timer) -> list[dict]:
    """``plans``: (path label, plan) of the main paths whose shapes are
    held and timed here."""
    from repro_torch.kernels.matmul_int8 import kernel as mm_kernel
    from repro_torch.kernels.matmul_int8.ref import matmul_int8_ref
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    # integer-exact: unit scales, |acc| <= 127**2 * 1024 < 2**24
    # K = 1 (SSD state update) and M = 1 (readout, LM head) take the
    # masked scalar loads
    for m, k, n in [(128, 1024, 256), (100, 200, 360), (8, 72, 100),
                    (130, 24, 1000), (128, 1, 64), (1, 128, 64),
                    (16, 1, 64)]:
        x = torch.randint(-127, 128, (m, k), dtype=torch.int8,
                          device="cuda", generator=g)
        w = torch.randint(-127, 128, (k, n), dtype=torch.int8,
                          device="cuda", generator=g)
        one_m = torch.ones(m, device="cuda")
        one_n = torch.ones(n, device="cuda")
        ref = matmul_int8_ref(x, w, one_m, one_n, torch.float32)
        for bm in mm_kernel.BM_TILES:
            for bn in mm_kernel.BN_TILES:
                for bk in mm_kernel.BK_TILES:
                    out = mm_kernel.matmul_int8(
                        x, w, one_m, one_n, bm=bm, bk=bk, bn=bn,
                        out_dtype=torch.float32)
                    require(torch.equal(out, ref),
                            f"matmul_int8 exact at {(m, k, n)} "
                            f"blocks {(bm, bk, bn)}")
        print(f"[matmul_int8] integer-exact at {(m, k, n)} for every tile",
              flush=True)
    # contiguous views off a 16-byte boundary take the masked scalar loads
    m, k, n = 64, 256, 128
    xbuf = torch.randint(-127, 128, (8 + m * k,), dtype=torch.int8,
                         device="cuda", generator=g)
    wbuf = torch.randint(-127, 128, (8 + k * n,), dtype=torch.int8,
                         device="cuda", generator=g)
    x, w = xbuf[8:].view(m, k), wbuf[8:].view(k, n)
    one_m, one_n = torch.ones(m, device="cuda"), torch.ones(n, device="cuda")
    out = mm_kernel.matmul_int8(x, w, one_m, one_n, bm=64, bk=64, bn=64,
                                out_dtype=torch.float32)
    require(torch.equal(out, matmul_int8_ref(x, w, one_m, one_n,
                                             torch.float32)),
            "matmul_int8 exact on views off a 16-byte boundary")
    print("[matmul_int8] integer-exact on views off a 16-byte boundary",
          flush=True)
    # split-K: every split the K steps allow among a few, the rule's
    # included, bit-equal under unit scales (K ragged across the splits,
    # M = 1) and with real scales in float32 and bfloat16; two calls under
    # the rule's split give the same bits
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (m, k, n), (bm, bk, bn) in [((128, 4096 + 24, 256), (128, 128, 128)),
                                    ((1, 4096 + 24, 256), (16, 128, 128)),
                                    ((100, 1000, 360), (64, 32, 64))]:
        x = torch.randint(-127, 128, (m, k), dtype=torch.int8,
                          device="cuda", generator=g)
        w = torch.randint(-127, 128, (k, n), dtype=torch.int8,
                          device="cuda", generator=g)
        xs = torch.rand(m, device="cuda", generator=g) / 127
        ws = torch.rand(n, device="cuda", generator=g) / 127
        one_m = torch.ones(m, device="cuda")
        one_n = torch.ones(n, device="cuda")
        steps = -(-k // bk)
        rule = mm_kernel.split_k(m, n, k, bm, bk, bn, sms)
        splits = sorted({s for s in (1, 2, 3, 7, steps, rule) if s <= steps})
        for split in splits:
            call = lambda a, b, dt: mm_kernel.matmul_int8(
                x, w, a, b, bm=bm, bk=bk, bn=bn, out_dtype=dt,
                split_k=split)
            require(torch.equal(call(one_m, one_n, torch.float32),
                                matmul_int8_ref(x, w, one_m, one_n,
                                                torch.float32)),
                    f"matmul_int8 exact at {(m, k, n)} split {split}")
            for dt in (torch.float32, torch.bfloat16):
                require(torch.equal(call(xs, ws, dt),
                                    matmul_int8_ref(x, w, xs, ws, dt)),
                        f"matmul_int8 bit-equal {dt} at {(m, k, n)} "
                        f"split {split}")
        first = mm_kernel.matmul_int8(x, w, xs, ws, bm=bm, bk=bk, bn=bn,
                                      out_dtype=torch.float32)
        require(torch.equal(first, mm_kernel.matmul_int8(
            x, w, xs, ws, bm=bm, bk=bk, bn=bn, out_dtype=torch.float32)),
            f"matmul_int8 deterministic at {(m, k, n)} split {rule}")
        print(f"[matmul_int8] bit-equal at {(m, k, n)} blocks "
              f"{(bm, bk, bn)} for splits {splits} (rule {rule}), float32 "
              f"and bfloat16", flush=True)
    rows = []
    for label, plan in plans:
        rows += _matmul_plan_rows(torch, label, plan, timer, g)
    return rows


def _matmul_plan_rows(torch, label, plan, timer, g) -> list[dict]:
    from repro_torch.core.executor import NUMERICS_TOL
    from repro_torch.kernels.matmul_int8 import kernel as mm_kernel
    from repro_torch.kernels.matmul_int8.ref import (matmul_int8_ref,
                                                     quantize_rowwise)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for op, count in unique_ops(plan, "matmul_int8"):
        s = op.spec
        m, k, n = s["m"], s["k"], s["n"]
        x = torch.randn((m, k), device="cuda", generator=g)
        w = torch.randn((k, n), device="cuda", generator=g) * 0.1
        xq, xs = quantize_rowwise(x, axis=1)
        wq, ws = quantize_rowwise(w, axis=0)
        del x, w
        kern = lambda: mm_kernel.matmul_int8(
            xq, wq, xs, ws, bm=s["bm"], bk=s["bk"], bn=s["bn"],
            out_dtype=torch.float32)
        plain = lambda: matmul_int8_ref(xq, wq, xs, ws, torch.float32)
        # torch._int_mm takes M > 16 and K, N multiples of 8 only
        lib = (lambda: torch._int_mm(xq, wq).to(torch.float32) *
               xs[:, None] * ws[None, :]) \
            if m > 16 and k % 8 == 0 and n % 8 == 0 else None
        out, ref = kern(), plain()
        rel = float((out.double() - ref.double()).norm() /
                    ref.double().norm())
        require(bool(torch.isfinite(out).all()), f"{op.name} finite")
        require(rel <= NUMERICS_TOL["matmul_int8"],
                f"{op.name} rel err {rel}")
        # the bound counts what the function must move: x, w, the scales
        # and the float32 output. The split-K workspace (one int32 partial
        # per split, written once and read once) is this design's own
        # traffic: its size is reported beside the bound, not counted in it
        split = mm_kernel.split_k(m, n, k, s["bm"], s["bk"], s["bn"], sms)
        n_bytes = m * k + k * n + 4 * (m + n) + 4 * m * n
        b_ms, b_by = bound_ms(n_bytes, 2.0 * m * n * k, "int8")
        ms = timer(kern)
        row = {"path": label, "op": op.name, "shape": (m, k, n),
               "blocks": (s["bm"], s["bk"], s["bn"]), "count": count,
               "split_k": split,
               "ctas": -(-m // s["bm"]) * -(-n // s["bn"]) * split,
               "workspace_bytes": 4 * split * m * n if split > 1 else 0,
               "rel_err": rel,
               "max_abs_err": float((out - ref).abs().max()),
               "ms": ms, "plain_ms": timer(plain),
               "library_ms": timer(lib) if lib else None, "bound_ms": b_ms,
               "bound_by": b_by, "bound_share": b_ms / ms,
               "gb_s": n_bytes / ms / 1e6, "bound_gb_s": HBM_BYTES_S / 1e9,
               "op_ms": op.measured_s * 1e3}
        rows.append(row)
        print(f"[matmul_int8] {json.dumps(row)}", flush=True)
        del xq, wq, out, ref
        torch.cuda.empty_cache()
    return rows


#: Shapes of the prefill sweep, every (block_q >= 16, block_k) tile in
#: both dtypes: (b, L, h, hd), causal. Long causal prefill, path C's
#: minicpm-2b exec_prefill (L 512) and exec_train (L 64) with two lengths
#: between, and L 264 (no tile divides it; 16 (b, h) rows).
#: `gpu_bridge.select_flash_blocks`' prefill rule is read from it.
PREFILL_SWEEP = ((1, 4096, 32, 128), (1, 512, 36, 64), (1, 256, 36, 64),
                 (1, 128, 36, 64), (1, 64, 36, 64), (2, 264, 8, 128))


def flash_rows(torch, plan, out_c, timer) -> list[dict]:
    """``plan``: path A's; ``out_c``: path C's report, whose prefill
    attention ops (``flash_ops``) are held and timed at their plan shapes
    and blocks."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core.executor import NUMERICS_TOL
    from repro_torch.core.gpu_bridge import select_flash_blocks
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # (path, count in that path's plan, op ms there, name, (b, lq, lk, h,
    # hd, causal, dtype, block_q, block_k)); the executor runs float32 at
    # the bridge's blocks, so only that row of a plan op counts for its
    # path. A decode op (block_q = 1) is also run at every block_k of the
    # set, in both dtypes: the sweep the bridge's decode pick
    # (`gpu_bridge.DECODE_BLOCK_K`) is read from
    cases = []
    for op, count in unique_ops(plan, "flash_attention"):
        s = op.spec
        shape = (s["b"], s["lq"], s["lk"], s["h"], s["hd"], s["causal"])
        bks = fa_kernel.BK_TILES if s["bq"] == 1 else (s["bk"],)
        for dt in ("float32", "bfloat16"):
            for bk in bks:
                main = dt == "float32" and bk == s["bk"]
                cases.append(("A" if main else None, count if main else 0,
                              op.measured_s * 1e3 if main else None,
                              op.name if main else f"{op.name} sweep",
                              shape + (dt, s["bq"], bk)))
    # path C's prefill attention ops (exec_prefill, exec_train) as it ran
    # them, float32 at the bridge's blocks
    seen = set()
    for r in out_c["rows"]:
        for op in r["flash_ops"]:
            s = op["spec"]
            shape = (s["b"], s["lq"], s["lk"], s["h"], s["hd"], s["causal"],
                     "float32", s["bq"], s["bk"])
            if s["lq"] > 1 and shape not in seen:
                seen.add(shape)
                cases.append(("C", op["count"], op["measured_s"] * 1e3,
                              f"{r['model']} {r['scenario']} {op['name']}",
                              shape))
    for dt in ("float32", "bfloat16"):
        el = 4 if dt == "float32" else 2
        # paths D and F-I's prefill attention (4 prompts; the vlm's 1024
        # stub patch positions in front of the prompt; causal, one launch
        # a layer, the hybrid's one a group) at the bridge's blocks, as
        # the models run it: float32, the dtype they serve in; glm4-9b's
        # in bfloat16 too
        main = dt == "float32"
        for label, arch, want, _ in LIVE_FAMILIES:
            if not main and label != "D":
                continue
            fcfg = get_config(arch)
            fl = LIVE_PROMPT + (fcfg.frontend_seq
                                if fcfg.family == "vlm" else 0)
            fh, fhd = fcfg.n_heads, fcfg.resolved_head_dim
            cases.append((label if main else None, want if main else 0,
                          None, f"{arch} live prefill attention",
                          (LIVE_BATCH, fl, fl, fh, fhd, True, dt) +
                          select_flash_blocks(
                              fl, fl, fhd, bytes_el=el,
                              batch_heads=LIVE_BATCH * fh, n_sms=sms)))
        # path C's minicpm-2b exec_decode step (16 sequences against a
        # 256-entry cache, 36 heads of 64), at every block_k
        cases += [(None, 0, None, "minicpm-2b exec_decode",
                   (16, 1, 256, 36, 64, False, dt, 1, bk))
                  for bk in fa_kernel.BK_TILES]
        # (b, lq, lk, h, hd, causal) at the bridge's blocks
        cases += [(None, 0, None, "mode", shape + (dt,) + select_flash_blocks(
            shape[1], shape[2], shape[4], bytes_el=el,
            batch_heads=shape[0] * shape[3], n_sms=sms)) for shape in (
            (1, 1024, 1024, 32, 128, True), (1, 4096, 4096, 32, 128, True),
            (1, 1024, 1024, 32, 128, False), (2, 264, 264, 8, 128, True))]
        cases += [(None, 0, None, "prefill sweep",
                   (b, l, l, h, hd, True, dt, bq, bk))
                  for b, l, h, hd in PREFILL_SWEEP
                  for bq in fa_kernel.BQ_TILES if bq > 1
                  for bk in fa_kernel.BK_TILES]
    rows, plain_ms, occ = [], {}, {}
    for path, count, op_ms, name, (b, lq, lk, h, hd, causal, dt, bq, bk) \
            in cases:
        dtype = getattr(torch, dt)
        mk = lambda l: torch.randn((b, l, h, hd), device="cuda",
                                   generator=g).to(dtype)
        q, k, v = mk(lq), mk(lk), mk(lk)
        kern = lambda: flash_attention(q, k, v, causal=causal, block_q=bq,
                                       block_k=bk)
        plain = lambda: attention_ref(q, k, v, causal=causal)
        lib = lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal)
        out, ref = kern(), plain()
        rel = float((out.double() - ref.double()).norm() /
                    ref.double().norm())
        require(bool(torch.isfinite(out).all()) and out.shape == q.shape,
                f"flash {name} finite, shaped")
        require(rel <= NUMERICS_TOL["flash_attention"],
                f"flash {(b, lq, lk, h, hd, causal, dt, bq, bk)} rel err "
                f"{rel}")
        el = 4 if dt == "float32" else 2
        pairs = (sum(min(i + 1, lk) for i in range(lq)) if causal
                 else lq * lk)
        n_bytes = el * (2 * b * lq * h * hd + 2 * b * lk * h * hd)
        b_ms, b_by = bound_ms(n_bytes, 4.0 * b * h * pairs * hd, dt)
        ms = timer(kern)
        # the plain version and SDPA once per shape (not per tile)
        key = (b, lq, lk, h, hd, causal, dt)
        if key not in plain_ms:
            plain_ms[key] = (timer(plain), timer(lib))
        if (bq, bk, hd, dt) not in occ:
            occ[bq, bk, hd, dt] = fa_kernel.occupancy(bq, bk, hd, dtype)
        o = occ[bq, bk, hd, dt]
        row = {"path": path, "op": name,
               "b": b, "lq": lq, "lk": lk, "h": h, "hd": hd,
               "causal": causal, "dtype": dt, "blocks": (bq, bk),
               "count": count, "rel_err": rel,
               "max_abs_err": float((out.float() - ref.float()).abs().max()),
               "ms": ms, "plain_ms": plain_ms[key][0],
               "library_ms": plain_ms[key][1], "bound_ms": b_ms,
               "bound_by": b_by, "bound_share": b_ms / ms,
               "gb_s": n_bytes / ms / 1e6, "bound_gb_s": HBM_BYTES_S / 1e9,
               "regs": o["regs"], "ctas_per_sm": o["ctas_per_sm"],
               "op_ms": op_ms}
        rows.append(row)
        print(f"[flash_attention] {json.dumps(row)}", flush=True)
        del q, k, v, out, ref
    for b, l, h, hd in PREFILL_SWEEP:
        for dt in ("float32", "bfloat16"):
            sweep = {r["blocks"]: r["ms"] for r in rows
                     if r["op"] == "prefill sweep" and r["dtype"] == dt and
                     (r["b"], r["lq"], r["h"], r["hd"]) == (b, l, h, hd)}
            fastest = min(sweep, key=sweep.get)
            pick = select_flash_blocks(l, l, hd, bytes_el=4 if dt ==
                                       "float32" else 2, batch_heads=b * h,
                                       n_sms=sms)
            print(f"[flash sweep] {(b, l, h, hd)} causal {dt}: fastest "
                  f"{fastest} {sweep[fastest]:.4f} ms; bridge pick {pick} "
                  f"{sweep[pick]:.4f} ms "
                  f"(+{100 * (sweep[pick] / sweep[fastest] - 1):.1f} %)",
                  flush=True)
    return rows


#: (b, nc, q, h, n, p) of the ssd sweep (every bt, both dtypes): path B's
#: one-cell op, path C's Q 64 cell, 12 cells, and one mamba2-1.3b
#: prefill_32k layer of one sequence; `gpu_bridge.select_ssd_block` is
#: read from it.
SSD_SWEEP = ((1, 1, 256, 1, 128, 64), (1, 1, 64, 1, 128, 64),
             (1, 4, 256, 3, 128, 64), (1, 128, 256, 64, 128, 64))


def ssd_rows(torch, plans, timer) -> list[dict]:
    """ssd_scan against its plain version: every one-cell shape of the
    plans' ``ssd_intra`` ops (as the executor runs them, at the bridge's
    query tile), odd Q = 24, and the full grid of one mamba2-1.3b
    ``prefill_32k`` layer for one sequence, each in float32 and bfloat16,
    then the sweep (`SSD_SWEEP`, every bt). Only path B's float32 op counts
    toward the main-path total."""
    from repro_torch.configs import get_config
    from repro_torch.core.executor import NUMERICS_TOL
    from repro_torch.core.gpu_bridge import select_ssd_block
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # (label, op or None, count, (b, nc, q, h, n, p), bt or None: the pick)
    cases, seen = [], set()
    for label, plan in plans:
        for op, count in unique_ops(plan, "ssd_scan"):
            s = op.spec
            shape = (1, 1, s["q"], 1, s["n"], s["p"])
            if label == "B" or shape not in seen:
                cases.append((label, op, count if label == "B" else 0,
                              shape, None))
                seen.add(shape)
    # path C's exec_train cell (q 64; its exec_prefill cell is path B's),
    # odd Q, and one prefill_32k layer of one sequence: B=1, NC=128, Q=256,
    # H=64, N=128, P=64
    extra = [(1, 1, 64, 1, 128, 64), (1, 1, 24, 1, 8, 8),
             (2, 2, 24, 2, 16, 16), (1, 128, 256, 64, 128, 64)]
    cases += [(None, None, 0, shape, None) for shape in extra
              if shape not in seen]
    # path E's ssd_chunked(use_kernel=True) on layer 0 of the live
    # prefill: chunks of 256, d_inner / head_dim heads
    mamba = get_config("mamba2-1.3b")
    cases.append(("E", None, 0, (
        LIVE_BATCH, LIVE_PROMPT // 256, 256,
        mamba.ssm_expand * mamba.d_model // mamba.ssm_head_dim,
        mamba.ssm_state, mamba.ssm_head_dim), None))
    cases += [("sweep", None, 0, shape, bt) for shape in SSD_SWEEP
              for bt in ssd_kernel.BT_TILES]
    rows, plain_ms, occ = [], {}, {}
    for label, op, count, (b, nc, q, h, n, p), bt in cases:
        cells = b * nc * h
        pick = select_ssd_block(cells, q, n_sms=sms)
        bt = pick if bt is None else bt
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            c = torch.randn((b, nc, q, h, n), device="cuda", generator=g)
            bb = torch.randn((b, nc, q, h, n), device="cuda", generator=g)
            dtv = 0.001 + 0.099 * torch.rand((b, nc, q, h), device="cuda",
                                             generator=g)
            a = -(0.5 + 3.5 * torch.rand((h,), device="cuda", generator=g))
            args = [v.to(dtype) for v in
                    (c, bb, torch.cumsum(dtv * a, dim=2), dtv,
                     torch.randn((b, nc, q, h, p), device="cuda",
                                 generator=g))]
            del c, bb, dtv
            kern = lambda: ssd_intra_chunk(*args, block_t=bt)
            plain = lambda: ssd_intra_chunk_ref(*args)
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            rel = float((out.double() - ref.double()).norm() /
                        ref.double().norm())
            name = op.name if op is not None else \
                "ssd sweep" if label == "sweep" else \
                "mamba2-1.3b live layer 0" if label == "E" else "shape"
            require(bool(torch.isfinite(out).all()) and
                    out.shape == args[4].shape and out.dtype == dtype,
                    f"ssd_scan {name} finite, shaped, typed")
            require(rel <= NUMERICS_TOL["ssd_scan"],
                    f"ssd_scan {(b, nc, q, h, n, p, dt, bt)} rel err {rel}")
            el = 4 if dt == "float32" else 2
            n_bytes = cells * (2 * q * n + 2 * q + 2 * q * p) * el
            b_ms, b_by = bound_ms(n_bytes,
                                  cells * 2.0 * (n + p) * q * (q + 1) / 2, dt)
            main = dt == "float32" and count > 0
            ms = timer(kern)
            # the plain version once per shape and dtype (not per bt)
            key = (b, nc, q, h, n, p, dt)
            if key not in plain_ms:
                plain_ms[key] = timer(plain)
            inst = (bt, ssd_kernel.padded_dim(n), ssd_kernel.padded_dim(p),
                    dt)
            if inst not in occ:
                occ[inst] = ssd_kernel.occupancy(bt, n, p, dtype)
            row = {"path": label if dt == "float32" and label != "sweep"
                   else None, "op": name,
                   "shape": (b, nc, q, h, n, p), "dtype": dt, "bt": bt,
                   "pick": pick, "key_groups": ssd_kernel.key_groups(bt),
                   "ctas": cells * math.ceil(q / bt),
                   "count": count if main else 0, "rel_err": rel,
                   "max_abs_err": float((out.float() - ref.float())
                                        .abs().max()),
                   "ms": ms, "plain_ms": plain_ms[key], "library_ms": None,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "bound_share": b_ms / ms, "gb_s": n_bytes / ms / 1e6,
                   "bound_gb_s": HBM_BYTES_S / 1e9,
                   "regs": occ[inst]["regs"],
                   "ctas_per_sm": occ[inst]["ctas_per_sm"],
                   "op_ms": op.measured_s * 1e3
                   if op is not None and dt == "float32" else None}
            rows.append(row)
            print(f"[ssd_scan] {json.dumps(row)}", flush=True)
            del args, out, ref
            torch.cuda.empty_cache()
    for shape in SSD_SWEEP:
        for dt in ("float32", "bfloat16"):
            sweep = {r["bt"]: r["ms"] for r in rows
                     if r["op"] == "ssd sweep" and r["dtype"] == dt and
                     tuple(r["shape"]) == shape}
            fastest = min(sweep, key=sweep.get)
            pick = next(r["pick"] for r in rows if r["op"] == "ssd sweep"
                        and tuple(r["shape"]) == shape)
            print(f"[ssd sweep] {shape} {dt}: " + ", ".join(
                f"bt {bt} {ms:.4f} ms" for bt, ms in sorted(sweep.items())) +
                f"; fastest {fastest}; bridge pick {pick} "
                f"(+{100 * (sweep[pick] / sweep[fastest] - 1):.1f} %)",
                flush=True)
    return rows


def kernel_entry(name: str, rows: list[dict], path: str,
                 launches: dict[str, dict]) -> dict:
    """One kernel's line entry: times are count-weighted sums over the ops
    of main path ``path`` it ran (one step of that plan), errors the
    largest over every shape it was held at, launches the sum over every
    main path's run."""
    main = [r for r in rows if r["count"] > 0 and r["path"] == path]
    tot = lambda key: sum(r["count"] * r[key] for r in main)
    by_bytes = sum(r["count"] * r["bound_ms"] for r in main
                   if r["bound_by"] == "bytes")
    library = None if any(r["library_ms"] is None for r in main) \
        else tot("library_ms")
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(l[name] for l in launches.values()),
            "launches_by_path": {k: l[name] for k, l in launches.items()},
            "weighted_over": path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bound_ms"),
            "bound_by": "bytes" if by_bytes >= tot("bound_ms") / 2
            else "operations",
            "library_ms": library}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip smoke: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()

    seconds = {}

    def timed(name, fn, *args):
        t = time.monotonic()
        out = fn(*args)
        seconds[name] = round(time.monotonic() - t, 1)
        return out

    info = timed("device", phase_device, torch)
    timed("build", phase_build, torch)
    rep_a, launch_a = timed("A", phase_path_a, torch)
    rep_b, launch_b = timed("B", phase_path_b, torch)
    out_c, launch_c = timed("C", phase_path_c, torch)
    live_e, launch_e = timed("E", phase_path_e, torch, info)
    launches = {"A": launch_a, "B": launch_b, "C": launch_c, "E": launch_e}
    lives = {"E": live_e}
    for label, arch, want, turns in LIVE_FAMILIES:
        lives[label], launches[label] = timed(
            label, phase_path_family, torch, info, label, arch, want, turns)
    traffic = timed("traffic", phase_traffic, info)
    plans = [("A", rep_a.plan), ("B", rep_b.plan)]
    timer = Timer(torch)
    mm = timed("matmul rows", matmul_rows, torch, plans, timer)
    fa = timed("flash rows", flash_rows, torch, rep_a.plan, out_c, timer)
    ssd = timed("ssd rows", ssd_rows, torch, plans, timer)
    # the training path runs after the kernels' timings, so that its
    # ~50 GB of state and minute of full load on the card touch none of
    # the kernels line's times; its launches (none) join the line
    _free(torch)
    lives["J"], launches["J"] = timed("J", phase_path_j, torch, info)
    lives["K"], launches["K"] = timed("K", phase_path_k, torch, info)
    lives["M"], launches["M"] = timed("M", phase_path_m, torch, info,
                                      lives["J"], lives["K"])
    lives["L"], launches["L"] = timed("L", phase_path_l, torch, info, mm,
                                      timer)
    lives["N"], launches["N"] = timed("N", phase_path_n, torch, info, timer)
    hillclimb = timed("hillclimb", phase_hillclimb, info)
    seconds.update({f"K {k}": round(v, 1)
                    for k, v in lives["K"]["seconds"].items()})
    kernels = [kernel_entry("matmul_int8", mm, "A", launches),
               kernel_entry("flash_attention", fa, "A", launches),
               kernel_entry("ssd_scan", ssd, "B", launches)]
    for label, rep in (("A", rep_a), ("B", rep_b)):
        rank = rep.rank_corr
        print(f"[main {label}] report: {rep.plan.model} {rep.plan.scenario}"
              f", {rep.n_ops} ops, {rep.n_unique} unique, "
              f"{rep.measured_total_s * 1e3:.4f} ms count-weighted, rank "
              f"corr {rank if rank is None else round(rank, 4)}, max rel "
              f"err {rep.max_rel_err:.3e}; card {info['nvidia_smi']}")
    print(f"[main C] report: pooled spearman {out_c['pooled_rank_corr']} "
          f"over {out_c['n_rank_points']} points; card {info['nvidia_smi']}")
    for label, live in lives.items():
        print(f"[main {label}] report: {json.dumps(live)}; card "
              f"{info['nvidia_smi']}")
    print(f"[traffic] report: {json.dumps(traffic)}")
    print(f"[hillclimb] report: {json.dumps(hillclimb)}")
    print(f"[smoke] seconds by phase: {json.dumps(seconds)}")
    print(f"[smoke] all phases passed in {time.monotonic() - t0:.1f} s",
          flush=True)
    print(info["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--path-m"]:
        sys.exit(path_m_child(sys.argv[2]))
    sys.exit(main())
