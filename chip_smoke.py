"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card, from the root of a checkout:

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:

  1. device — the card's name and power limit (``nvidia-smi``), torch and
     CUDA versions;
  2. build — both CUDA kernels from the sources in the checkout, one
     ``nvcc`` per source, started together; registers, shared memory and
     spills of every instantiation (``-Xptxas -v``);
  3. main path — ``repro_torch.serve_lm`` for glm4-9b at its published
     widths under ``decode_32k``, with a cold solve cache: the MIREDO
     solve, the lowered plan, every op on its kernel and checked against
     its oracle. The launch counters are zeroed just before and read just
     after; every op must have run on its kernel (``path == "cuda"``);
  4. kernels vs plain — each kernel against its plain PyTorch version on
     the same inputs on the card: matmul_int8 integer-exact with unit
     scales at K <= 1024 for every tile, then at every main-path shape and
     block; flash_attention in causal prefill (L = 1024, 4096),
     bidirectional, L = 264 and the main path's decode step, in float32
     and bfloat16. Each is timed (CUDA events, L2 flushed before every
     launch, median) beside the plain version, one PyTorch library call
     computing the same function (timed here only, never used by the
     port) and the least time the card could take (bound);
  5. the last line: ``{"ok": true, "device": {...}}``.

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
#: dense int8 and bf16 tensor cores, float32 outside the tensor cores.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bfloat16": 989e12, "float32": 67e12}
REPLACES = {
    "matmul_int8": "src/repro/kernels/matmul_int8/kernel.py:61",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:85",
}
SOURCES = {
    "matmul_int8": "src/repro_torch/kernels/matmul_int8/csrc/matmul_int8.cu",
    "flash_attention":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
}


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


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    _build.build_all()
    print(f"[build] {len(_build.SOURCES)} kernels in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    demangle = shutil.which("c++filt")
    for name in _build.SOURCES:
        entry = None
        for line in _build.log_path(name).read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
                if demangle:
                    full = subprocess.run(
                        [demangle, entry], capture_output=True, text=True,
                        timeout=60).stdout
                    found = re.search(r"\w+_kernel<[^>]*>", full)
                    entry = found.group(0) if found else entry
            elif "Used" in line and "registers" in line and entry:
                print(f"[build] {entry}: {line.split(':', 1)[1].strip()}")
            elif "spill" in line and entry and " 0 bytes spill" not in line:
                print(f"[build] {entry}: {line.strip()}")
        _build.load(name)
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    for dt, el in (("float32", 4), ("bfloat16", 2)):
        sizes = {f"{bq}x{bk}": fa_kernel.smem_bytes(bq, bk, 128, el)
                 for bq in fa_kernel.BQ_TILES for bk in fa_kernel.BK_TILES}
        print(f"[build] flash_attention dynamic smem bytes at hd=128, {dt} "
              f"(bq x bk): {sizes}")


def phase_main_path(torch) -> tuple:
    from repro_torch import serve_lm
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.matmul_int8 import kernel as mm_kernel
    with tempfile.TemporaryDirectory(prefix="miredo-cache-") as cache:
        os.environ["MIREDO_CACHE"] = cache        # cold: the MIP solves
        mm_kernel.launches = fa_kernel.launches = 0
        t0 = time.monotonic()
        rep = serve_lm.main(["--arch", "glm4-9b", "--shape", "decode_32k",
                             "--device", "cuda"])
        torch.cuda.synchronize()
        launches = {"matmul_int8": mm_kernel.launches,
                    "flash_attention": fa_kernel.launches}
        wall = time.monotonic() - t0
    plan = rep.plan
    print(f"[main] glm4-9b decode_32k: {wall:.1f} s wall; launches "
          f"{launches}", flush=True)
    require(rep.numerics_ok, f"numerics (max rel err {rep.max_rel_err})")
    require(all(math.isfinite(op.measured_s) and op.measured_s > 0
                for op in plan.ops), "every op timed")
    for op in plan.ops:
        require(op.path == "cuda", f"{op.name} ran on {op.path}")
    require({op.kernel for op in plan.ops} == set(launches),
            "the plan reaches both kernels")
    for name, n in launches.items():
        require(n > 0, f"{name} never launched on the main path")
    return plan, rep, launches


def unique_ops(plan, kernel: str) -> list[tuple]:
    """(first op, instances in the plan) per structurally unique op."""
    first: dict = {}
    for op in plan.ops:
        if op.kernel == kernel:
            first.setdefault(op.key, op)
    return [(op, sum(o.count for o in plan.ops if o.key == key))
            for key, op in first.items()]


def matmul_rows(torch, plan, timer) -> list[dict]:
    from repro_torch.core.executor import NUMERICS_TOL
    from repro_torch.kernels.matmul_int8 import kernel as mm_kernel
    from repro_torch.kernels.matmul_int8.ref import (matmul_int8_ref,
                                                     quantize_rowwise)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    # integer-exact: unit scales, |acc| <= 127**2 * 1024 < 2**24
    for m, k, n in [(128, 1024, 256), (100, 200, 360), (8, 72, 100),
                    (130, 24, 1000)]:
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
        lib = lambda: torch._int_mm(xq, wq).to(torch.float32) * \
            xs[:, None] * ws[None, :]
        out, ref = kern(), plain()
        rel = float((out.double() - ref.double()).norm() /
                    ref.double().norm())
        require(bool(torch.isfinite(out).all()), f"{op.name} finite")
        require(rel <= NUMERICS_TOL["matmul_int8"],
                f"{op.name} rel err {rel}")
        b_ms, b_by = bound_ms(m * k + k * n + 4 * (m + n) + 4 * m * n,
                              2.0 * m * n * k, "int8")
        row = {"op": op.name, "shape": (m, k, n),
               "blocks": (s["bm"], s["bk"], s["bn"]), "count": count,
               "rel_err": rel,
               "max_abs_err": float((out - ref).abs().max()),
               "ms": timer(kern), "plain_ms": timer(plain),
               "library_ms": timer(lib), "bound_ms": b_ms, "bound_by": b_by,
               "op_ms": op.measured_s * 1e3}
        rows.append(row)
        print(f"[matmul_int8] {json.dumps(row)}", flush=True)
        del xq, wq, out, ref
    return rows


def flash_rows(torch, plan, timer) -> list[dict]:
    import torch.nn.functional as F
    from repro_torch.core.executor import NUMERICS_TOL
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    # (plan op or None, count in the plan, (b, lq, lk, h, hd, causal,
    # dtype, block_q, block_k)); the executor runs float32, so the
    # bfloat16 twin of a plan op counts no launches of the main path
    cases = []
    for op, count in unique_ops(plan, "flash_attention"):
        s = op.spec
        shape = (s["b"], s["lq"], s["lk"], s["h"], s["hd"], s["causal"])
        cases += [(op, count, shape + ("float32", s["bq"], s["bk"])),
                  (None, 0, shape + ("bfloat16", s["bq"], s["bk"]))]
    for dt in ("float32", "bfloat16"):
        # (b, lq, lk, h, hd, causal, dtype, block_q, block_k)
        cases += [(None, 0, (1, 1024, 1024, 32, 128, True, dt, 64, 64)),
                  (None, 0, (1, 4096, 4096, 32, 128, True, dt, 64, 64)),
                  (None, 0, (1, 1024, 1024, 32, 128, False, dt, 64, 64)),
                  (None, 0, (2, 264, 264, 8, 128, True, dt, 64, 128))]
    rows = []
    for op, count, (b, lq, lk, h, hd, causal, dt, bq, bk) in cases:
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
        name = op.name if op is not None else "mode"
        require(bool(torch.isfinite(out).all()) and out.shape == q.shape,
                f"flash {name} finite, shaped")
        require(rel <= NUMERICS_TOL["flash_attention"],
                f"flash {(b, lq, lk, h, hd, causal, dt)} rel err {rel}")
        el = 4 if dt == "float32" else 2
        pairs = (sum(min(i + 1, lk) for i in range(lq)) if causal
                 else lq * lk)
        b_ms, b_by = bound_ms(el * (2 * b * lq * h * hd + 2 * b * lk * h * hd),
                              4.0 * b * h * pairs * hd, dt)
        row = {"op": name, "b": b, "lq": lq, "lk": lk, "h": h, "hd": hd,
               "causal": causal, "dtype": dt, "blocks": (bq, bk),
               "count": count, "rel_err": rel,
               "max_abs_err": float((out.float() - ref.float()).abs().max()),
               "ms": timer(kern), "plain_ms": timer(plain),
               "library_ms": timer(lib), "bound_ms": b_ms, "bound_by": b_by,
               "op_ms": op.measured_s * 1e3 if op is not None else None}
        rows.append(row)
        print(f"[flash_attention] {json.dumps(row)}", flush=True)
        del q, k, v, out, ref
    return rows


def kernel_entry(name: str, rows: list[dict], launches: int) -> dict:
    """One kernel's line entry: times are count-weighted sums over the
    main-path ops it ran (one decode step of the plan), errors the largest
    over every shape it was held at."""
    main = [r for r in rows if r["count"] > 0]
    tot = lambda key: sum(r["count"] * r[key] for r in main)
    by_bytes = sum(r["count"] * r["bound_ms"] for r in main
                   if r["bound_by"] == "bytes")
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bound_ms"),
            "bound_by": "bytes" if by_bytes >= tot("bound_ms") / 2
            else "operations",
            "library_ms": tot("library_ms")}


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
    phase_build()
    plan, rep, launches = phase_main_path(torch)
    timer = Timer(torch)
    mm = matmul_rows(torch, plan, timer)
    fa = flash_rows(torch, plan, timer)
    kernels = [kernel_entry("matmul_int8", mm, launches["matmul_int8"]),
               kernel_entry("flash_attention", fa,
                            launches["flash_attention"])]
    rank = rep.rank_corr
    print(f"[main] report: {rep.n_ops} ops, {rep.n_unique} unique, "
          f"{rep.measured_total_s * 1e3:.4f} ms count-weighted, rank corr "
          f"{rank if rank is None else round(rank, 4)}, max rel err "
          f"{rep.max_rel_err:.3e}; card {info['nvidia_smi']}")
    print(f"[smoke] all phases passed in {time.monotonic() - t0:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
