"""Executed serving step on the card: the optimized CIM dataflow plan of
one served model under one registry scenario (``--shape``), run on the
port's CUDA kernels.

The counterpart of the reference's executed decode in
``examples/serve_lm.py`` (``report_cim_dataflow``) and of
``benchmarks/exec_lm.py`` (whose zoo is `repro_torch/exec_lm.py`). It
lowers the served step (a decode step, or the prompt pass of a prefill
scenario) to its workload, solves it with the MIREDO optimizer (cached
under ``MIREDO_CACHE``), lowers the result to an execution plan, and runs
every op on its kernel: each weight GEMM on matmul_int8 with blocks
derived from its optimized mapping, attention on flash_attention, the
fused SSD intra-chunk pair on ssd_scan. Every output is checked against
its oracle, and measured times are ranked against predicted cycles.

    PYTHONPATH=src python -m repro_torch.serve_lm --arch glm4-9b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.serve_lm --arch mamba2-1.3b --shape prefill_32k

The second is the prompt pass of 32 sequences of 32k tokens through
mamba2-1.3b at its published widths. Without a CUDA device the default
``--device cuda`` fails before solving; ``--device cpu --reduced`` runs
the plain versions at reduced widths. The solve runs before the first
CUDA call, and torch is imported only after the arguments are parsed.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    """Solve, lower and execute; returns the ``ExecReport``."""
    from repro_torch.configs import ARCH_IDS, SHAPES, get_config
    from repro_torch.core.cache import MIP_MODES

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="glm4-9b", choices=ARCH_IDS)
    ap.add_argument("--shape", default="decode_32k", choices=sorted(SHAPES))
    ap.add_argument("--mode", default="miredo",
                    choices=MIP_MODES + ("greedy", "heuristic", "random"))
    ap.add_argument("--per-layer-cap-s", type=float, default=2.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced widths (ModelConfig.reduced), "
                         "small enough for a CPU run")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core.arch import default_arch
    from repro_torch.core.executor import check_device, execute_plan, \
        lower_plan
    from repro_torch.core.frontend import extract_workload
    from repro_torch.core.network import optimize_network

    check_device(args.device)          # fail before the solve, not after

    cfg, spec, arch = get_config(args.arch), SHAPES[args.shape], \
        default_arch()
    if args.reduced:
        cfg = cfg.reduced()
    work = extract_workload(cfg, spec)
    net = optimize_network(list(work.layers), arch, args.mode,
                           counts=list(work.counts),
                           per_layer_cap_s=args.per_layer_cap_s, workers=1)
    print(f"[solve] {cfg.name} {spec.name} ({args.mode}): {len(work)} "
          f"layers, {net.n_unique} unique, {net.n_solved} solved, "
          f"{net.cache_hits} cache hits in {net.wall_s:.1f} s; "
          f"{net.totals['cycles']:.6g} cycles serial-sum, "
          f"EDP {net.totals['edp']:.6g}", flush=True)

    if torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 oracles
    plan = lower_plan(cfg, spec, net, arch)
    rep = execute_plan(plan, device=args.device, repeats=3, seed=args.seed,
                       verbose=True)
    rank = f"{rep.rank_corr:.4f}" if rep.rank_corr is not None else "n/a"
    print(f"[report] {rep.n_ops} ops ({rep.n_unique} unique) on "
          f"{args.device}: {rep.measured_total_s * 1e3:.4f} ms "
          f"count-weighted vs {plan.predicted_serial_cycles:.6g} predicted "
          f"cycles; rank corr {rank} over {len(rep.rank_points())} points; "
          f"numerics {'OK' if rep.numerics_ok else 'FAILED'} "
          f"(max rel err {rep.max_rel_err:.3e})", flush=True)
    return rep


if __name__ == "__main__":
    raise SystemExit(0 if main().numerics_ok else 1)
