"""Readings for the limits of a cell's check, many seeds in one process.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 [--faults half_batch] --seconds 2 \
        [--out FILE]

For each seed, one run of the cell through `harness.run_cell`, as
`run.py` makes it (set-up, a window of ``--seconds`` at the cell's load,
the program's state freed, the check, ``correct`` judged there); on the
control seeds the same call also reads the control's numbers (the
reference one precision below the configuration's, in the program's
place) and those of each named fault that the driver's ``check`` can
plant in the reference. One JSON line a seed, on standard output and
appended to ``--out``. The benchmark's own runs never run the
control."""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload)
    os.environ["MIREDO_CACHE"] = str(harness.CACHE / "miredo")
    os.environ["MIREDO_REPORTS"] = str(harness.CACHE / "reports")
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    ints = lambda s: [int(x) for x in s.split(",") if x]
    controls = set(ints(args.control_seeds))
    faults = [f for f in args.faults.split(",") if f]
    for seed in ints(args.seeds):
        t0 = time.monotonic()
        run = harness.Run(cell=cell, seed=seed, seconds=args.seconds,
                          device="cuda", t_start=t0)
        res = harness.run_cell(run, ["control", *faults]
                               if seed in controls else [])
        row = {"workload": cell.name, "seed": seed,
               "e2e": {k: v["value"] for k, v in res["metrics"].items()},
               "peak": res["device"]["memory_peak_bytes"],
               "program": {k: v["value"] for k, v in res["checks"].items()},
               **res.get("readings", {}), "correct": res["correct"],
               "s": time.monotonic() - t0}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
        del res
        harness.free(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
