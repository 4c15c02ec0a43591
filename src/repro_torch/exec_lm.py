"""Measured execution across the LM zoo on the card: optimized plans on the
port's CUDA kernels, predicted cycles vs measured time
(`core/executor.py`).

The counterpart of the reference's ``benchmarks/exec_lm.py``. Each
(model, scenario) row extracts its workload, solves it through the network
pipeline, lowers the result to an ``ExecPlan`` (GEMMs on
`kernels/matmul_int8` with mapping-derived blocks, attention score/AV on
`kernels/flash_attention`, the SSD intra-chunk pair fused on
`kernels/ssd_scan`) and executes it on ``--device`` (``cuda`` by default:
the kernels, timed with CUDA events; ``cpu``: their plain versions).
Every kernel invocation is checked against its ``ref.py`` oracle, and
per-op predicted cycles are *ranked* against measured seconds — the
Fig. 4(a) discipline, model-vs-execution. Every row is solved before the
first CUDA call, so a solver pool may start.

Scenarios are the reference's execution-sized cells (`EXEC_SHAPES`).

    PYTHONPATH=src python -m repro_torch.exec_lm --quick
    PYTHONPATH=src python -m repro_torch.exec_lm --reduced --device cpu

``--reduced`` is the acceptance path: every executed kernel output must
match its reference, the pooled rank correlation must clear
``RANK_FLOOR``, all three kernel families must have run, and every model
must have executed at least one wGrad GEMM (``exec_train`` lowers a
training step, so the backward pass is on that path too). The floor was
set on the reference's interpret-mode CPU times. Without a CUDA device
the default ``--device cuda`` fails before solving. The report goes to
``$MIREDO_REPORTS/torch_exec_lm.json`` (default ``reports/``).
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.arch import default_arch
from repro_torch.core.executor import check_device, execute_plan, \
    lower_plan, spearman
from repro_torch.core.frontend import extract_workload
from repro_torch.core.network import optimize_network

#: Execution-sized scenario cells, the reference's.
EXEC_SHAPES = {
    "exec_prefill": ShapeSpec("exec_prefill", seq_len=512, global_batch=1,
                              kind="prefill"),
    "exec_decode": ShapeSpec("exec_decode", seq_len=256, global_batch=16,
                             kind="decode"),
    # one training step: the backward pass (dGrad/wGrad, transposed-
    # operand block selection) reaches matmul_int8 and the numerics oracle
    "exec_train": ShapeSpec("exec_train", seq_len=64, global_batch=1,
                            kind="train"),
}
#: Reduced-mode model subset: one attention family + one SSD family keeps
#: every kernel dispatch path on the acceptance path.
REDUCED_ARCHS = ("minicpm-2b", "mamba2-1.3b")
#: Acceptance floor on the pooled per-op Spearman (predicted cycles vs
#: measured seconds), the reference's, set on interpret-mode CPU times.
RANK_FLOOR = 0.5
MIN_RANK_POINTS = 8
#: Quick-mode solver knobs.
QUICK_CAP_S = 2.0
QUICK_AVG_S = 1.0
KERNELS = ("matmul_int8", "flash_attention", "ssd_scan")


def md_table(headers: list[str], rows: list[list]) -> str:
    out = ["| " + " | ".join(headers) + " |",
           "|" + "---|" * len(headers)]
    for r in rows:
        out.append("| " + " | ".join(
            f"{x:.3g}" if isinstance(x, float) else str(x) for x in r) +
            " |")
    return "\n".join(out)


def write_report(name: str, payload) -> str:
    report_dir = os.environ.get("MIREDO_REPORTS", "reports")
    os.makedirs(report_dir, exist_ok=True)
    path = os.path.join(report_dir, name + ".json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return path


def _device_name(device: str) -> str:
    import torch
    if torch.device(device).type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(torch.device(device))


def run(budget_s: float = 45.0, quick: bool = False, reduced: bool = False,
        archs: tuple[str, ...] | None = None,
        scenarios: tuple[str, ...] | None = None,
        mode: str = "miredo", repeats: int = 3, seed: int = 0,
        device: str = "cuda", workers: int | None = 1) -> dict:
    check_device(device)               # fail before the solves, not after
    quick = quick or reduced
    arch = default_arch()
    arch_ids = tuple(archs) if archs else (
        REDUCED_ARCHS if reduced else ARCH_IDS)
    scen = tuple(scenarios) if scenarios else tuple(EXEC_SHAPES)
    unknown = set(scen) - set(EXEC_SHAPES)
    if unknown:
        raise KeyError(f"unknown exec scenario(s) {sorted(unknown)}; "
                       f"known: {sorted(EXEC_SHAPES)}")

    # every solve before the first CUDA call (a solver pool may start)
    solved = []
    for aid in arch_ids:
        cfg = get_config(aid)
        if reduced:
            cfg = cfg.reduced()
        for sname in scen:
            spec = EXEC_SHAPES[sname]
            work = extract_workload(cfg, spec)
            cap = min(QUICK_CAP_S, budget_s) if quick else budget_s
            total = QUICK_AVG_S * work.n_unique if quick else None
            net = optimize_network(list(work.layers), arch, mode,
                                   counts=list(work.counts),
                                   per_layer_cap_s=cap,
                                   total_budget_s=total, workers=workers)
            solved.append((aid, sname, cfg, spec, net))

    import torch
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 oracles
    rows, table, pooled = [], [], []
    kernels_seen: set[str] = set()
    wgrad_covered: set[str] = set()   # models that executed a wGrad GEMM
    pool_seen: set = set()     # structural op keys: unique ACROSS rows too
    exec_memo: dict = {}       # shared measurements (same settings per run)
    for aid, sname, cfg, spec, net in solved:
        plan = lower_plan(cfg, spec, net, arch)
        rep = execute_plan(plan, device=device, repeats=repeats, seed=seed,
                           memo=exec_memo)
        # pool per-op rank points, structurally unique across ALL rows
        # (reduced configs share shapes; a duplicated op would enter
        # identical predicted cycles twice and pad the gates)
        for op in plan.ops:
            if op.predicted_cycles is None or op.measured_s is None \
                    or op.key in pool_seen:
                continue
            pool_seen.add(op.key)
            pooled.append((op.predicted_cycles, op.measured_s))
        kernels_seen |= {op.kernel for op in plan.ops}
        if any(op.name.endswith(".wgrad") for op in plan.ops):
            wgrad_covered.add(aid)
        rows.append({
            "model": aid, "scenario": sname, "ops": rep.n_ops,
            "unique": rep.n_unique,
            "predicted_serial_cycles": plan.predicted_serial_cycles,
            "predicted_scheduled_cycles": plan.predicted_scheduled_cycles,
            "measured_s": rep.measured_total_s,
            "rank_corr": rep.rank_corr,
            "numerics_ok": rep.numerics_ok,
            "max_rel_err": rep.max_rel_err,
            "paths": sorted({op.path for op in plan.ops}),
            "kernels": sorted({op.kernel for op in plan.ops}),
            # the attention ops as run: shape, bridge blocks, count, time
            "flash_ops": [{"name": op.name, "spec": op.spec,
                           "count": op.count, "measured_s": op.measured_s}
                          for op in plan.ops
                          if op.kernel == "flash_attention"],
        })
        table.append([
            aid, sname, rep.n_ops, rep.n_unique,
            f"{plan.predicted_serial_cycles:.4g}",
            f"{plan.predicted_scheduled_cycles:.4g}"
            if plan.predicted_scheduled_cycles else "-",
            f"{rep.measured_total_s * 1e3:.4f}",
            f"{rep.rank_corr:.2f}" if rep.rank_corr is not None else "-",
            f"{rep.max_rel_err:.1e}",
            "ok" if rep.numerics_ok else "FAIL"])

    headers = ["model", "scenario", "ops", "unique", "pred serial cyc",
               "pred sched cyc", "measured ms", "rank", "max rel err",
               "numerics"]
    print(md_table(headers, table))
    pooled_rank = spearman([p for p, _ in pooled], [m for _, m in pooled])
    n_bad = sum(not r["numerics_ok"] for r in rows)
    print(f"[exec/{mode}] {len(rows)} (model, scenario) rows on {device}, "
          f"{len(pooled)} pooled rank points, pooled spearman "
          f"{pooled_rank if pooled_rank is None else round(pooled_rank, 3)}"
          f", kernels {sorted(kernels_seen)}, "
          f"{n_bad} rows failed numerics", flush=True)

    payload = {"mode": mode, "device": device,
               "device_name": _device_name(device), "rows": rows,
               "pooled_rank_corr": pooled_rank,
               "n_rank_points": len(pooled),
               "kernels": sorted(kernels_seen),
               "wgrad_covered": sorted(wgrad_covered)}
    write_report("torch_exec_lm", payload)

    # --reduced is the acceptance path: enforce the executor's contract
    # instead of warning, so regressions fail the run.
    if reduced:
        for r in rows:
            if not r["numerics_ok"]:
                raise RuntimeError(
                    f"{r['model']}/{r['scenario']}: kernel output diverged "
                    f"from its ref.py oracle (max rel err "
                    f"{r['max_rel_err']:.2e})")
        # pool-level gates (rank statistic, kernel coverage) are calibrated
        # for the full reduced pool — user-narrowed --archs/--scenarios
        # subsets keep the per-row numerics gate only
        full_pool = not archs and not scenarios
        if full_pool and len(pooled) < MIN_RANK_POINTS:
            raise RuntimeError(
                f"only {len(pooled)} rank points — the reduced run must "
                f"exercise >= {MIN_RANK_POINTS} predicted ops")
        if full_pool and pooled_rank is None:
            raise RuntimeError(
                "pooled rank correlation undefined: predicted or measured "
                "side is constant across all ops")
        if full_pool and pooled_rank is not None and \
                pooled_rank < RANK_FLOOR:
            raise RuntimeError(
                f"pooled predicted-vs-measured rank correlation "
                f"{pooled_rank:.3f} < {RANK_FLOOR} (Fig. 4(a) discipline, "
                f"model-vs-execution)")
        missing = set(KERNELS) - kernels_seen
        if full_pool and missing:
            raise RuntimeError(f"kernel families never dispatched: "
                               f"{sorted(missing)}")
        no_wgrad = set(arch_ids) - wgrad_covered
        if full_pool and no_wgrad:
            raise RuntimeError(
                f"models that never executed a wGrad GEMM: "
                f"{sorted(no_wgrad)} — the exec_train scenario must cover "
                f"a backward kernel per model")
    return payload


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="quick solver caps (implied by --reduced)")
    ap.add_argument("--reduced", action="store_true",
                    help="the configs' reduced widths + quick caps + "
                         "acceptance gates")
    ap.add_argument("--budget", type=float, default=45.0,
                    help="per-layer MIP cap (seconds; quick mode clamps)")
    ap.add_argument("--archs", default="",
                    help=f"comma list of arch ids (default: "
                         f"{', '.join(REDUCED_ARCHS)} reduced, else all of "
                         f"{', '.join(ARCH_IDS)})")
    ap.add_argument("--scenarios", default="",
                    help="comma list of exec scenario names (default: "
                         + ",".join(EXEC_SHAPES) + ")")
    ap.add_argument("--mode", default="miredo")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed repeats per unique op (min is reported)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--workers", type=int, default=1,
                    help="solver processes (spawned before any CUDA call)")
    args = ap.parse_args(argv)
    run(budget_s=args.budget, quick=args.quick, reduced=args.reduced,
        archs=tuple(a for a in args.archs.split(",") if a) or None,
        scenarios=tuple(s for s in args.scenarios.split(",") if s) or None,
        mode=args.mode, repeats=args.repeats, seed=args.seed,
        device=args.device, workers=args.workers)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
