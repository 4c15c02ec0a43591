"""Co-design: which CIM accelerator should serve this LM config?

The serving question ``serve_lm`` answers for ONE hand-picked
architecture — "what dataflow should a CIM accelerator use for this
model's decode step" — becomes a co-design question here: sweep an
architecture grid (`core/dse.py`), let cheap incumbent screening prune it,
run warm-started MIPs on the survivors, and pick from the Pareto frontier
the best-EDP arch that fits an area budget. The counterpart of the
reference's ``examples/codesign.py``, with the same flags. It runs on the
host only (the optimizer); solves are cached under ``MIREDO_CACHE``.

    PYTHONPATH=src python -m repro_torch.codesign --area-kbit 512
"""

from __future__ import annotations

import argparse


def main(argv=None):
    """Run the DSE and print the frontier and the best arch under the
    area budget; returns the `dse.DseResult`."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.dse import ArchSpace, run_dse
    from repro_torch.core.frontend import extract_workload

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="glm4-9b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--area-kbit", type=float, default=512.0,
                    help="area budget in kilobits of CIM crossbar cells")
    ap.add_argument("--budget", type=float, default=2.0,
                    help="per-layer MIP cap (seconds)")
    args = ap.parse_args(argv)

    # The same reduced serving config serve_lm runs on the CPU.
    cfg = get_config(args.model).reduced()
    spec = ShapeSpec("serve_decode", seq_len=1, global_batch=args.batch,
                     kind="decode")
    work = extract_workload(cfg, spec)
    print(f"workload: {cfg.name} decode (batch={args.batch}) -> "
          f"{len(work)} weight GEMMs, {work.n_unique} unique")

    space = ArchSpace(macro=((64, 32), (128, 32), (256, 64)),
                      n_cores=(4, 8, 16), lbuf_kb=(16.0, 256.0))
    res = run_dse(list(work.layers), list(work.counts), space,
                  per_layer_cap_s=args.budget, verbose=True)

    print(f"\nPareto frontier ({len(res.frontier)} archs, "
          f"{100 * res.prune_fraction:.0f}% of the grid screened out):")
    for p in res.frontier:
        errs = res.validation.get(p.arch_name, [])
        print(f"  {p.arch_name:<42} area {p.area_bits / 1024:>6.0f} kbit  "
              f"{p.cycles:>10,.0f} cyc  {p.energy_pj:>12,.0f} pJ"
              f"{'  INVALID: ' + errs[0] if errs else ''}")

    budget_bits = args.area_kbit * 1024
    best = res.best_under_area(budget_bits)
    if best is None:
        print(f"\nno frontier arch fits {args.area_kbit:g} kbit")
        return res
    net = res.networks[best.arch_name]
    print(f"\nbest EDP under {args.area_kbit:g} kbit: {best.arch_name}")
    print(f"  EDP {best.edp:.3e}  ({best.cycles:,.0f} cycles, "
          f"{best.energy_pj:,.0f} pJ, area {best.area_bits / 1024:.0f} kbit)")
    top = max(net.layers, key=lambda lr: lr.edp * lr.count)
    print(f"  heaviest GEMM {top.layer.name}: "
          f"spatial {top.record['mapping']['spatial']}")
    return res


if __name__ == "__main__":
    main()
