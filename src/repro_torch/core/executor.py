"""Measured-execution backend: run an optimized plan on the port's CUDA
kernels and validate predicted vs measured (the reference's DESIGN.md
§Executor, on an H100 in place of a TPU).

Everything upstream of this module *predicts*: the MIP, the analytical
latency model and the event simulator agree with each other, but none of
them executes a kernel. This module closes that loop:

  1. **Lowering.** A solved ``NetworkResult`` (plus its scheduler
     ``Schedule``) for one (model, scenario) pair is lowered to an
     ``ExecPlan``: every frontend layer, tagged with its op kind in
     `core/lm_workloads.py` (``workload.OP_GEMM`` / ``OP_ATTENTION`` /
     ``OP_SSD``), becomes an ``ExecOp`` dispatched to the kernel family
     that executes it —

       * weight GEMMs (projections, FFN/MoE mats, SSD state GEMMs, the LM
         head) -> `kernels/matmul_int8`, block shapes derived from the
         layer's *optimized mapping* by the GPU bridge
         (`gpu_bridge.select_blocks_from_mapping`);
       * one score/AV stage per attention block -> `kernels/
         flash_attention` (`gpu_bridge.select_flash_blocks`); decode runs
         the step against a synthetic KV cache, prefill the full causal
         square. Score matmuls are deliberately *not* workload layers (they
         run on the attention unit, not the CIM macro), so these ops carry
         no predicted cycles and are excluded from the rank statistic, but
         are still timed and numerics-checked;
       * the SSD intra-chunk pair (scores + y_intra) -> one fused
         `ssd_scan` op. Its kernel is not ported yet: running such an op
         raises (ROADMAP B.3).

     Plan order is stream order, i.e. schedule order — each op is annotated
     with the segment that will execute it (`Schedule.stage_segment_ids`).
  2. **Execution.** Each structurally unique op runs once with warm-up plus
     timed repeats (operand *values* are synthetic, drawn from a seeded
     ``torch.Generator`` on the op's device; shapes, dtypes and block shapes
     are exactly the plan's). ``device="cuda"`` (the default) launches the
     CUDA kernels and times them with CUDA events; ``device="cpu"`` runs
     each kernel's plain version, as the CPU tests do. Each op records the
     ``path`` that ran: "cuda" when its kernel's launch counter moved,
     "plain" otherwise.
  3. **Validation.** Every kernel output is checked against its package's
     ``ref.py`` oracle (`quantized_matmul_and_ref`, `attention_ref`), and
     measured time is *ranked* against predicted cycles (`spearman`) — the
     Fig. 4(a) discipline, model-vs-execution. Absolute agreement is not
     expected (GPU milliseconds are not CIM cycles); monotonicity is: a
     layer the model calls heavier should measure heavier.

Entry points: ``execute_model`` (extract -> optimize -> lower -> execute),
``lower_plan`` / ``execute_plan`` for pre-solved results, and
`repro_torch/serve_lm.py` for the served decode step. Solver pools must
start before the first CUDA call (forking after CUDA initialises breaks
the children), so torch work stays inside the runners.
"""

from __future__ import annotations

import dataclasses
import math
import time
import zlib
from typing import Sequence

from repro_torch.core import workload as wl
from repro_torch.core.arch import CimArch
from repro_torch.core.cache import mapping_from_json
from repro_torch.core.gpu_bridge import select_blocks_from_mapping, \
    select_flash_blocks

#: Decode attention replays the step against a synthetic KV cache of the
#: scenario's sequence length, capped as in the reference (a 32k-entry
#: cache is a prediction-side scenario, not an execution target).
DECODE_KV_CAP = 512

#: Frobenius relative-error floor per kernel family vs its ref.py oracle.
#: matmul shares the oracle's int32 accumulation exactly (only the final
#: f32 scale multiply can round differently); attention/SSD re-associate
#: f32 reductions blockwise.
NUMERICS_TOL = {"matmul_int8": 1e-4, "flash_attention": 2e-3,
                "ssd_scan": 2e-3}

#: Block-size cap for executed matmuls, kept from the reference: each op
#: spans several CTAs rather than one mapping-sized block. The kernel's
#: largest tile is 128 as well.
EXEC_BLOCK_CAP = 128


# ---------------------------------------------------------------------------
# Plan dataclasses
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ExecOp:
    """One kernel invocation of the plan (one or more workload layers)."""

    name: str
    kernel: str                    # matmul_int8 | flash_attention | ssd_scan
    spec: dict                     # kernel-family shape/block parameters
    count: int                     # network multiplicity (instances)
    layer_indices: tuple[int, ...]  # workload layers this op covers
    segment: int | None = None     # schedule segment executing this op
    #: Per-instance predicted cycles (sum of covered layers' records);
    #: ``None`` for ops with no workload layer (attention score stage).
    predicted_cycles: float | None = None
    measured_s: float | None = None        # per-invocation time
    path: str | None = None                # "cuda" (kernel) | "plain"
    rel_err: float | None = None           # vs the kernel's ref.py oracle
    numerics_ok: bool | None = None

    @property
    def key(self) -> tuple:
        """Structural execution identity: equal keys run identical kernels
        on identical shapes/blocks, so measurement and numerics memoize."""
        return (self.kernel,) + tuple(sorted(self.spec.items()))


@dataclasses.dataclass
class ExecPlan:
    model: str
    scenario: str
    arch_name: str
    ops: list[ExecOp]
    predicted_serial_cycles: float
    predicted_scheduled_cycles: float | None
    n_segments: int

    @property
    def n_unique(self) -> int:
        return len({op.key for op in self.ops})


@dataclasses.dataclass
class ExecReport:
    plan: ExecPlan
    #: Count-weighted measured time — the executed analogue of the
    #: serial-sum predicted cycles (unique ops run once; instances scale).
    measured_total_s: float
    #: Spearman rank correlation of per-op predicted cycles vs measured
    #: seconds over the plan's unique predicted ops (None under 3 points).
    rank_corr: float | None
    numerics_ok: bool
    max_rel_err: float
    n_ops: int
    n_unique: int
    n_checked: int

    def rank_points(self) -> list[tuple[float, float]]:
        """(predicted cycles, measured seconds) per unique predicted op —
        poolable across reports for a fleet-level rank statistic."""
        seen, pts = set(), []
        for op in self.plan.ops:
            if op.predicted_cycles is None or op.measured_s is None or \
                    op.key in seen:
                continue
            seen.add(op.key)
            pts.append((op.predicted_cycles, op.measured_s))
        return pts


# ---------------------------------------------------------------------------
# Rank statistic
# ---------------------------------------------------------------------------

def spearman(xs: Sequence[float], ys: Sequence[float]) -> float | None:
    """Spearman rank correlation (scipy, average ranks for ties); ``None``
    when fewer than 3 points or either side is constant."""
    from scipy.stats import spearmanr
    assert len(xs) == len(ys)
    if len(xs) < 3 or len(set(xs)) == 1 or len(set(ys)) == 1:
        return None
    rho = float(spearmanr(xs, ys)[0])
    return None if math.isnan(rho) else rho


# ---------------------------------------------------------------------------
# Lowering: NetworkResult -> ExecPlan
# ---------------------------------------------------------------------------

def _gemm_mkn(layer: wl.Layer) -> tuple[int, int, int]:
    """GEMM-speak (M x K) @ (K x N) from the canonical loop nest."""
    assert layer.is_gemm, layer.name
    return layer.bound("N"), layer.bound("C"), layer.bound("K")


def _matmul_op(idx: int, lr, arch: CimArch) -> ExecOp:
    m, k, n = _gemm_mkn(lr.layer)
    mapping = mapping_from_json(lr.record["mapping"])
    bm, bk, bn = select_blocks_from_mapping(mapping, lr.layer, arch,
                                            cap=EXEC_BLOCK_CAP)
    return ExecOp(
        name=lr.layer.name, kernel="matmul_int8",
        spec={"m": m, "k": k, "n": n, "bm": bm, "bk": bk, "bn": bn},
        count=lr.count, layer_indices=(idx,),
        predicted_cycles=lr.record["cycles"])


def _flash_op(prefix: str, group: dict, cfg, spec) -> ExecOp | None:
    """The score/AV stage of one attention block (no workload layer — no
    predicted cycles; see module docstring)."""
    if "wq" not in group:
        return None
    qi, qlr = group["wq"]
    lq = qlr.layer.bound("N")
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    idxs = tuple(i for i, _ in group.values())
    if spec.is_decode:
        # one decode step against the (synthetic) KV cache: every cached
        # position is visible, sequences batch on the leading dim. The
        # cache is the decoder's own stream for self-attention; cached
        # cross-attention (kv_m=0 — no wk/wv at decode) attends the
        # encoder memory instead.
        cache = (cfg.frontend_seq or spec.seq_len) \
            if prefix.endswith(".xattn") else spec.seq_len
        lk = min(int(cache), DECODE_KV_CAP)
        b, lq, causal = lq, 1, False
    elif "wk" not in group:
        return None                 # defensive: prefill group without K/V
    else:
        lk = group["wk"][1].layer.bound("N")
        # cross-attention and the encoder's bidirectional self-attention
        # (the frontend's `.xattn` / `.enc` groups) see every position;
        # decoder/self streams are causal
        bidi = prefix.endswith(".xattn") or prefix.endswith(".enc")
        b, causal = 1, not bidi
    # the runner draws float32 operands (`_run_flash`)
    bq, bk = select_flash_blocks(lq, lk, hd, bytes_el=4)
    return ExecOp(
        name=f"{prefix}.attention", kernel="flash_attention",
        spec={"b": b, "lq": lq, "lk": lk, "h": h, "hd": hd,
              "causal": causal, "bq": bq, "bk": bk},
        count=qlr.count, layer_indices=idxs)


def lower_plan(cfg, spec, net, arch: CimArch) -> ExecPlan:
    """Lower a solved ``NetworkResult`` for ``(cfg, spec)`` into an
    executable plan. ``net.layers`` must be the workload extracted by
    `frontend.extract_workload(cfg, spec)` in order (op-kind tags intact).
    """
    layers = net.layers
    seg_ids = net.schedule.stage_segment_ids() if net.schedule else None
    ops: list[ExecOp] = []
    i = 0
    while i < len(layers):
        lr = layers[i]
        kind = lr.layer.op
        prefix, _, leaf = lr.layer.name.rpartition(".")
        if kind == wl.OP_ATTENTION:
            # contiguous projection run of one block: wq/wo[/wk/wv]
            group: dict[str, tuple[int, object]] = {}
            j = i
            while j < len(layers) and layers[j].layer.op == wl.OP_ATTENTION \
                    and layers[j].layer.name.rpartition(".")[0] == prefix:
                group[layers[j].layer.name.rpartition(".")[2]] = \
                    (j, layers[j])
                ops.append(_matmul_op(j, layers[j], arch))
                j += 1
            fo = _flash_op(prefix, group, cfg, spec)
            if fo is not None:
                ops.append(fo)
            i = j
            continue
        if kind == wl.OP_SSD and leaf == "ssd_scores" and \
                i + 1 < len(layers) and \
                layers[i + 1].layer.name == f"{prefix}.ssd_y_intra":
            # fused intra-chunk pair: scores (C B^T) + y_intra (scores X)
            sc, yi = lr, layers[i + 1]
            assert sc.count == yi.count, (sc.count, yi.count)
            q = sc.layer.bound("N")
            ops.append(ExecOp(
                name=f"{prefix}.ssd_intra", kernel="ssd_scan",
                spec={"q": q, "n": sc.layer.bound("C"),
                      "p": yi.layer.bound("K")},
                count=sc.count, layer_indices=(i, i + 1),
                predicted_cycles=sc.record["cycles"] + yi.record["cycles"]))
            i += 2
            continue
        # plain weight GEMM (FFN/MoE/LM head/projections) or SSD state GEMM
        ops.append(_matmul_op(i, lr, arch))
        i += 1
    if seg_ids is not None:
        for op in ops:
            op.segment = seg_ids[op.layer_indices[0]]
    sched = net.scheduled
    return ExecPlan(
        model=cfg.name, scenario=spec.name, arch_name=net.arch_name,
        ops=ops, predicted_serial_cycles=net.totals["cycles"],
        predicted_scheduled_cycles=sched["cycles"] if sched else None,
        n_segments=len(net.schedule.segments) if net.schedule else 0)


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------

def _rel_err(out, ref) -> float:
    import torch
    a = out.to(torch.float64)
    b = ref.to(torch.float64)
    return float(torch.linalg.vector_norm(a - b) /
                 max(float(torch.linalg.vector_norm(b)), 1e-12))


def check_device(device: str) -> None:
    """Raise unless ``device`` is "cpu" or a present CUDA device."""
    import torch
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the executor runs on the card "
                           "unless device='cpu' is passed")
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")


def _time_call(fn, warmup: int, repeats: int, device) -> float:
    """min-of-repeats time of ``fn()`` in seconds after ``warmup`` extra
    calls: CUDA events around each call on the card, the host clock on the
    CPU. Callers count their numerics invocation as the first warm-up, so
    they pass ``warmup - 1``."""
    import torch
    cuda = torch.device(device).type == "cuda"
    for _ in range(max(warmup, 0)):
        fn()
    if cuda:
        torch.cuda.synchronize(device)
    best = math.inf
    for _ in range(max(repeats, 1)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def _run_matmul(op: ExecOp, gen, device, warmup: int,
                repeats: int) -> tuple[float, float, str]:
    import torch
    from repro_torch.kernels.matmul_int8 import kernel
    from repro_torch.kernels.matmul_int8.ops import (quantized_matmul,
                                                     quantized_matmul_and_ref)
    s = op.spec
    x = torch.randn((s["m"], s["k"]), generator=gen, device=device)
    w = torch.randn((s["k"], s["n"]), generator=gen, device=device) * 0.1
    blocks = (s["bm"], s["bk"], s["bn"])
    before = kernel.launches
    out, ref = quantized_matmul_and_ref(x, w, block_shapes=blocks)
    path = "cuda" if kernel.launches > before else "plain"
    t = _time_call(
        lambda: quantized_matmul(x, w, block_shapes=blocks,
                                 out_dtype=torch.float32),
        warmup - 1, repeats, device)
    return t, _rel_err(out, ref), path


def _run_flash(op: ExecOp, gen, device, warmup: int,
               repeats: int) -> tuple[float, float, str]:
    import torch
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    s = op.spec
    mk = lambda l: torch.randn((s["b"], l, s["h"], s["hd"]), generator=gen,
                               device=device)
    q, k, v = mk(s["lq"]), mk(s["lk"]), mk(s["lk"])
    call = lambda: flash_attention(q, k, v, causal=s["causal"],
                                   block_q=s["bq"], block_k=s["bk"])
    before = kernel.launches
    out = call()
    path = "cuda" if kernel.launches > before else "plain"
    ref = attention_ref(q, k, v, causal=s["causal"])
    return (_time_call(call, warmup - 1, repeats, device),
            _rel_err(out, ref), path)


def _run_ssd(op: ExecOp, gen, device, warmup: int,
             repeats: int) -> tuple[float, float, str]:
    raise NotImplementedError(
        f"{op.name}: the ssd_scan kernel is not ported yet (ROADMAP B.3)")


_RUNNERS = {"matmul_int8": _run_matmul, "flash_attention": _run_flash,
            "ssd_scan": _run_ssd}


def execute_plan(plan: ExecPlan, *, device: str = "cuda", warmup: int = 1,
                 repeats: int = 2, seed: int = 0, verbose: bool = False,
                 memo: dict | None = None) -> ExecReport:
    """Execute every structurally unique op of ``plan`` (memoized by
    ``ExecOp.key``) with warm-up + timed repeats, numerics-check each kernel
    against its ``ref.py`` oracle, and fill the per-op measurement fields
    in place. Deterministic operands for a fixed ``seed``.

    ``device`` is "cuda" (the default; raises without a CUDA device) or
    "cpu", where every op runs its kernel's plain version. ``memo`` can be
    shared across plans executed with identical (device, warmup, repeats,
    seed) settings — a structurally identical op measures once."""
    import torch

    check_device(device)
    memo = {} if memo is None else memo
    for op in plan.ops:
        if op.key not in memo:
            # crc32 over the structural key: stable across processes
            # (tuple hash() is salted), so reruns draw identical operands
            gen = torch.Generator(device=device)
            gen.manual_seed((seed << 32) | zlib.crc32(repr(op.key).encode()))
            memo[op.key] = _RUNNERS[op.kernel](op, gen, device, warmup,
                                               repeats)
            if verbose:
                t, e, path = memo[op.key]
                blocks = {k: v for k, v in op.spec.items()
                          if k in ("bm", "bk", "bn", "bq")}
                shape = {k: v for k, v in op.spec.items() if k not in blocks}
                print(f"[exec] {op.kernel:>15} {op.name} shape {shape} "
                      f"blocks {blocks} path {path} {t * 1e3:.4f} ms "
                      f"rel_err {e:.2e}", flush=True)
        op.measured_s, op.rel_err, op.path = memo[op.key]
        op.numerics_ok = op.rel_err <= NUMERICS_TOL[op.kernel]
    report = ExecReport(
        plan=plan,
        measured_total_s=sum(op.count * op.measured_s for op in plan.ops),
        rank_corr=None, numerics_ok=all(op.numerics_ok for op in plan.ops),
        max_rel_err=max(op.rel_err for op in plan.ops),
        n_ops=len(plan.ops), n_unique=plan.n_unique,
        n_checked=len({op.key for op in plan.ops}))
    pts = report.rank_points()
    report.rank_corr = spearman([p for p, _ in pts], [m for _, m in pts])
    return report


def execute_model(cfg, spec, arch: CimArch | None = None, *,
                  mode: str = "miredo", per_layer_cap_s: float = 2.0,
                  total_budget_s: float | None = None,
                  workers: int | None = 1, net=None,
                  device: str = "cuda", warmup: int = 1, repeats: int = 2,
                  seed: int = 0, verbose: bool = False) -> ExecReport:
    """Extract -> optimize -> lower -> execute for one (model, scenario).

    ``net`` short-circuits the solve with a pre-computed ``NetworkResult``
    for exactly this workload. ``workers`` defaults to 1, as in the
    reference; a solver pool (spawned) must start before the first CUDA
    call in this process."""
    from repro_torch.core.arch import default_arch
    from repro_torch.core.frontend import extract_workload
    from repro_torch.core.network import optimize_network

    check_device(device)
    arch = arch or default_arch()
    if net is None:
        work = extract_workload(cfg, spec)
        net = optimize_network(list(work.layers), arch, mode,
                               counts=list(work.counts),
                               per_layer_cap_s=per_layer_cap_s,
                               total_budget_s=total_budget_s,
                               workers=workers, verbose=verbose)
    plan = lower_plan(cfg, spec, net, arch)
    return execute_plan(plan, device=device, warmup=warmup,
                        repeats=repeats, seed=seed, verbose=verbose)
