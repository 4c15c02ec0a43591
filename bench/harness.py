"""The benchmark's core: a cell's files found by name, the device
checked, the cell's driver run through set-up, the measured window and
the comparison with the plain reference, the per-layer metrics read from
the traced window, and the result line printed.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``,
which names its driver, ``drivers/<driver>.py``) and the limit of each
number its check compares. A per-layer metric is ``metrics/<name>.py``,
whose ``read(ctx)`` returns the metric or None where it finds nothing to
read. A driver module has ``E2E`` and ``UNIT`` (its end-to-end metric),
``setup(run)``, ``window(run, state, seconds)``, ``traced(run, state,
profiler)`` (which runs its steps in ``profiler.window``), ``release(run, state)`` and ``check(run, state, source)``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import os
import re
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
#: Caches the program writes and reads again in later runs of a
#: checkout, at fixed paths inside it: the MIP's solves.
CACHE = BENCH / ".cache"
#: Top-level modules that may not be loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _path(kind: str, name: str, suffix: str) -> Path:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    path = BENCH / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return path


def load_json(kind: str, name: str) -> dict:
    return json.loads(_path(kind, name, ".json").read_text())


def load_module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = _path(kind, name, ".py")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    driver: object

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def find_cell(name: str) -> Cell:
    """The cell ``name`` from its files alone."""
    wl = load_json("workloads", name)
    traffic = load_json("traffic", wl["traffic"])
    return Cell(name=name, workload=wl, config=load_json("configs",
                                                          wl["config"]),
                traffic=traffic,
                driver=load_module("drivers", traffic["driver"]))


def metric_names() -> list[str]:
    return sorted(p.stem for p in (BENCH / "metrics").glob("*.py")
                  if NAME.match(p.stem))


def forbidden_loaded() -> list[str]:
    """The forbidden top-level modules loaded in ``sys.modules``,
    compared as whole names (an entry of None is a blocked import)."""
    loaded = {m.partition(".")[0] for m, mod in list(sys.modules.items())
              if mod is not None}
    return sorted(loaded & set(FORBIDDEN))


def worst(values) -> float:
    """The largest of ``values``; infinite where any is not a number."""
    values = list(values)
    return math.inf if any(v != v for v in values) else max(values)


def percentile(values, q: float) -> float:
    """The ``q`` quantile (0..1) of ``values``, linear between ranks."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    x = q * (len(v) - 1)
    lo = int(math.floor(x))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


@dataclasses.dataclass
class Run:
    """One run of one cell: what its driver reads. ``model`` and
    ``traffic`` are the cell's configuration sizes and traffic parameters
    with ``overrides`` laid over them (the CPU tests shrink them);
    ``spans`` collects host-clock spans of set-up (``solve_s``)."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool = False
    device: str = "cuda"
    t_start: float = dataclasses.field(default_factory=time.monotonic)
    overrides: dict = dataclasses.field(default_factory=dict)
    spans: dict = dataclasses.field(default_factory=dict)

    @property
    def model(self) -> dict:
        return {**self.cell.config["model"],
                **self.overrides.get("model", {})}

    @property
    def traffic(self) -> dict:
        return {**self.cell.traffic, **self.overrides.get("traffic", {})}

    @property
    def on_card(self) -> bool:
        return self.device.startswith("cuda")

    def port_config(self):
        """The program's configuration at the cell's sizes: the port's
        registry entry with every size of the cell's file laid over it."""
        from repro_torch.configs import get_config
        m = self.model
        fields = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab_size", "gated_mlp", "tie_embeddings",
                  "rope_theta", "norm_eps")
        cfg = dataclasses.replace(get_config(self.cell.config["arch"]),
                                  **{f: m[f] for f in fields})
        if cfg.family != self.cell.config["family"] or \
                cfg.resolved_head_dim != m["head_dim"] or \
                cfg.padded_vocab() != m["padded_vocab"]:
            raise ValueError(f"the port's {cfg.name} is not the cell's "
                             f"configuration: family {cfg.family}, head dim "
                             f"{cfg.resolved_head_dim}, padded vocab "
                             f"{cfg.padded_vocab()}")
        return cfg

    def phase(self, label: str) -> None:
        """A progress line: ``label`` and the seconds since the process
        started (where set-up's time goes)."""
        note(f"{label} at {time.monotonic() - self.t_start:.3f} s")

    def sync(self) -> None:
        if self.on_card:
            import torch
            torch.cuda.synchronize()


class Stamps:
    """Marks between steps: CUDA events on the card (device timestamps,
    no host synchronisation), the host clock on the CPU."""

    def __init__(self, torch, on_card: bool):
        self.torch, self.on_card, self.marks = torch, on_card, []

    def mark(self) -> None:
        if self.on_card:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.monotonic())

    def gaps_ms(self) -> list[float]:
        """The time between consecutive marks; call after a
        synchronisation."""
        m = self.marks
        if self.on_card:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


@dataclasses.dataclass
class Context:
    """What a per-layer metric reads: the cell's end-to-end metric, the
    traced window, the work the driver did in it (operations and bytes
    worked out from shapes) and set-up's host spans."""
    e2e: str
    trace: object
    work: dict
    spans: dict


def read_metrics(ctx: Context) -> dict:
    out = {}
    for name in metric_names():
        mod = load_module("metrics", name)
        value = mod.read(ctx)
        if value is not None:
            out[name] = {"value": value, "unit": mod.UNIT}
    return out


def free(torch) -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def note(msg: str) -> None:
    """A progress line on standard error."""
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def run_cell(run: Run, sources=()) -> dict:
    """Set-up, the window (traced or not), the peak read, the program's
    state freed, the check: the result line as a dict. ``sources``:
    further sources the driver's ``check`` reads after the program's
    (the control, named faults), under ``readings``; the benchmark's own
    runs give none."""
    import torch
    from bench.reference.precision import exact_f32
    drv = run.cell.driver
    limits = run.cell.workload["limits"]
    run.phase(f"{run.cell.name} seed {run.seed}: set-up starts")
    with exact_f32():
        state = drv.setup(run)
        note(f"{run.cell.name} seed {run.seed}: set up at "
             f"{time.monotonic() - run.t_start:.3f} s {run.spans}")
        out = {}
        if run.on_card:                 # the peak of the window's work
            torch.cuda.reset_peak_memory_stats()
        if run.trace:
            from bench.trace import Profiler
            prof = Profiler(torch)
            work, attempted, failed = drv.traced(run, state, prof)
            tr = prof.trace()
            metrics = read_metrics(Context(drv.E2E, tr, work, run.spans))
            extra = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
            out["breakdown"] = {"device_ops": tr.top_ops(),
                                "idle_gaps": tr.idle_gaps()}
        else:
            setup_s = time.monotonic() - run.t_start
            e2e, attempted, failed = drv.window(run, state, run.seconds)
            metrics = {k: {"value": v, "unit": drv.UNIT} for k, v in
                       e2e.items()}
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            extra = {}
        peak = torch.cuda.max_memory_allocated() if run.on_card else 0
        note(f"window closed at {time.monotonic() - run.t_start:.3f} s: "
             f"{ {k: v['value'] for k, v in metrics.items()} } attempted "
             f"{attempted}, peak {peak:,} bytes")
        drv.release(run, state)
        free(torch)
        checks = drv.check(run, state, "program")
        if sources:
            out["readings"] = {s: drv.check(run, state, s) for s in sources}
    note(f"checked at {time.monotonic() - run.t_start:.3f} s: {checks}")
    kind = torch.cuda.get_device_name(0) if run.on_card else "cpu"
    device = {"platform": "gpu" if run.on_card else "cpu", "kind": kind,
              "count": run.cell.chips, "memory_peak_bytes": int(peak),
              **extra}
    return {"correct": judge(checks, limits), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device,
            **out, "checks": verdicts(checks, limits)}


def verdicts(checks: dict, limits: dict) -> dict:
    """Each number the check compared beside its limit."""
    return {k: {"value": v if math.isfinite(v) else None,
                "limit": limits.get(k)} for k, v in checks.items()}


def judge(checks: dict, limits: dict) -> bool:
    """``correct``: the check compared exactly the numbers the cell has
    limits for, and each is a number within its limit."""
    return set(checks) == set(limits) and all(
        _holds(v) for v in verdicts(checks, limits).values())


def _holds(v: dict) -> bool:
    return v["value"] is not None and v["limit"] is not None and \
        v["value"] <= v["limit"]


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = find_cell(args.workload)
    os.environ["MIREDO_CACHE"] = str(CACHE / "miredo")
    os.environ["MIREDO_REPORTS"] = str(CACHE / "reports")
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" found", file=sys.stderr)
        return 2
    run = Run(cell=cell, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), device="cuda", t_start=t_start)
    result = run_cell(run)
    leaked = forbidden_loaded()         # the window has closed
    if leaked:
        print(f"loaded: {leaked}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r} "
              f"{'ok' if _holds(v) else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
