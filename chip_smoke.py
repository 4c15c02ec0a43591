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
  4. kernels vs plain — each kernel against its plain PyTorch version on
     the same inputs on the card: matmul_int8 integer-exact with unit
     scales at K <= 1024 and at K = 1 and M = 1 for every tile, bit-equal
     under split-K (K ragged across the splits, M = 1, float32 and
     bfloat16, two calls alike), then at every shape and block of paths A
     and B with its split, CTAs, achieved GB/s and share of the bound;
     flash_attention at path A's decode step and path C's minicpm-2b
     decode step (both at every block_k, with achieved GB/s beside the
     bound), path C's prefill attention ops at their plan shapes and
     blocks, causal prefill (L = 1024, 4096), bidirectional and L = 264 at
     the bridge's blocks, and the prefill sweep (`PREFILL_SWEEP`, every
     tile, the bridge's prefill rule's evidence), in float32 and bfloat16;
     ssd_scan at every one-cell shape the
     plans run, at odd Q = 24 and at the full grid of one mamba2-1.3b
     ``prefill_32k`` layer for one sequence at the bridge's query tile
     (with its key groups, CTAs, GB/s and share of the bound), and the
     ssd sweep (`SSD_SWEEP`, every bt, the bridge's ssd rule's evidence),
     in float32 and bfloat16.
     Each is timed (CUDA events, L2 flushed before every launch, median)
     beside the plain version, one PyTorch library call computing the
     same function where there is one (timed here only, never used by
     the port) and the least time the card could take (bound). Paths A
     and B already hold every op of theirs against its oracle, and path
     C every op of its plans;
  5. the ``kernels`` line: matmul_int8 and flash_attention count-weighted
     over path A's plan (one decode step), ssd_scan over path B's (one
     prompt pass); launches are summed over the three paths;
  6. the last line: ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the repository beside it, it exits
non-zero before printing any result.
"""

from __future__ import annotations

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
                "ssd sweep" if label == "sweep" else "shape"
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

    info = phase_device(torch)
    phase_build(torch)
    rep_a, launch_a = phase_path_a(torch)
    rep_b, launch_b = phase_path_b(torch)
    out_c, launch_c = phase_path_c(torch)
    launches = {"A": launch_a, "B": launch_b, "C": launch_c}
    plans = [("A", rep_a.plan), ("B", rep_b.plan)]
    timer = Timer(torch)
    mm = matmul_rows(torch, plans, timer)
    fa = flash_rows(torch, rep_a.plan, out_c, timer)
    ssd = ssd_rows(torch, plans, timer)
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
    print(f"[smoke] all phases passed in {time.monotonic() - t0:.1f} s",
          flush=True)
    print(info["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
