"""The measured-execution backend's plan, step after step.

Set-up solves the cell's scenario through the port's optimizer (its
solve cache under ``bench/.cache``), lowers it with
`core/executor.py:lower_plan` and prints the plan's fingerprint. Every
matmul instance gets its own activation and weight, and every attention
instance its own queries and one of ``kv_sets`` sets of K/V, all drawn
from the seed, so no instance finds its operands in L2. A step launches
every op of the plan ``count`` times in plan order through the
executor's own op calls (`quantized_matmul` with the op's blocks into
float32, `flash_attention` with its blocks), enqueued with no
synchronisation. ``exec_step_ms`` is
the window over the steps completed.

The check draws the operands again and compares sampled instances of the
window's first and last step with `bench/reference/ops.py`."""

from __future__ import annotations

import functools
import json
import time
import zlib

E2E, UNIT = "exec_step_ms", "ms"
KERNELS = ("matmul_int8", "flash_attention")


def _layout(plan, kv_sets: int):
    out = []
    for i, op in enumerate(plan.ops):
        s = op.spec
        if op.kernel == "matmul_int8":
            for j in range(op.count):
                out += [(f"{i}.x.{j}", (s["m"], s["k"]), "normal"),
                        (f"{i}.w.{j}", (s["k"], s["n"]), "operand")]
        elif op.kernel == "flash_attention":
            out += [(f"{i}.q.{j}", (s["b"], s["lq"], s["h"], s["hd"]),
                     "normal") for j in range(op.count)]
            for j in range(min(kv_sets, op.count)):
                shape = (s["b"], s["lk"], s["h"], s["hd"])
                out += [(f"{i}.k.{j}", shape, "normal"),
                        (f"{i}.v.{j}", shape, "normal")]
        else:
            raise ValueError(f"{op.name}: the exec_plan driver runs "
                             f"{KERNELS}, not {op.kernel}")
    return out


def fingerprint(plan) -> str:
    rows = [[op.name, op.kernel, op.count, sorted(op.spec.items())]
            for op in plan.ops]
    return f"{zlib.crc32(json.dumps(rows).encode()):08x} {json.dumps(rows)}"


def _sample(plan, seed: int, kv_sets: int):
    """(op index, instance) pairs the check compares: one instance of
    each op, drawn from the seed, and an attention instance of a second
    K/V set."""
    import random
    rng = random.Random(seed)
    out = []
    for i, op in enumerate(plan.ops):
        j = rng.randrange(op.count)
        out.append((i, j))
        if op.kernel == "flash_attention" and min(kv_sets, op.count) > 1:
            out.append((i, (j + 1) % op.count))
    return out


def setup(run):
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.core.arch import default_arch
    from repro_torch.core.executor import lower_plan
    from repro_torch.core.frontend import extract_workload
    from repro_torch.core.network import optimize_network
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.matmul_int8.ops import quantized_matmul

    from bench.weights import draw
    tr = run.traffic
    if run.on_card:
        from repro_torch.kernels import _build
        _build.build_all(KERNELS)
        run.phase("kernels built or loaded")
    cfg, spec, arch = run.port_config(), SHAPES[tr["shape"]], default_arch()
    t0 = time.monotonic()
    work = extract_workload(cfg, spec)
    net = optimize_network(list(work.layers), arch, tr["mode"],
                           counts=list(work.counts),
                           per_layer_cap_s=tr["per_layer_cap_s"], workers=1)
    run.spans["solve_s"] = time.monotonic() - t0
    plan = lower_plan(cfg, spec, net, arch)
    run.phase("plan solved and lowered")
    print(f"[plan] fingerprint {fingerprint(plan)}", flush=True)
    layout = _layout(plan, tr["kv_sets"])
    flat, views = draw(torch, layout, run.seed, run.device, "operands")
    run.sync()
    run.phase("operands drawn")
    calls, shapes = [], {"matmul_int8": [], "flash": []}
    for i, op in enumerate(plan.ops):
        s = op.spec
        for j in range(op.count):
            if op.kernel == "matmul_int8":
                calls.append(functools.partial(
                    quantized_matmul, views[f"{i}.x.{j}"],
                    views[f"{i}.w.{j}"],
                    block_shapes=(s["bm"], s["bk"], s["bn"]),
                    out_dtype=torch.float32))
                shapes["matmul_int8"].append((s["m"], s["k"], s["n"]))
            else:
                kv = j % min(tr["kv_sets"], op.count)
                calls.append(functools.partial(
                    flash_attention, views[f"{i}.q.{j}"],
                    views[f"{i}.k.{kv}"], views[f"{i}.v.{kv}"],
                    causal=s["causal"], block_q=s["bq"], block_k=s["bk"]))
                shapes["flash"].append((s["b"], s["lq"], s["lk"], s["h"],
                                        s["hd"], s["causal"]))
    starts, n = [], 0
    for op in plan.ops:
        starts.append(n)
        n += op.count
    sampled = {starts[i] + j: (i, j) for i, j in
               _sample(plan, run.seed, tr["kv_sets"])}
    state = {"plan": plan, "flat": flat, "views": views, "calls": calls,
             "layout": layout, "sampled": sampled, "shapes": shapes,
             "first": {}, "last": {}}
    _step(state, None)                  # warm: every shape of the plan
    run.sync()
    return state


def _step(state, keep) -> None:
    sampled = state["sampled"]
    for idx, call in enumerate(state["calls"]):
        out = call()
        if keep is not None and idx in sampled:
            keep[idx] = out


def window(run, state, seconds):
    run.sync()
    t0 = time.monotonic()
    n = 0
    while True:
        _step(state, state["first"] if n == 0 else state["last"])
        n += 1
        if time.monotonic() - t0 >= seconds:
            break
    run.sync()
    elapsed = time.monotonic() - t0
    return {E2E: elapsed / n * 1e3}, n * len(state["calls"]), 0


def traced(run, state, prof):
    n = run.traffic["trace_steps"]
    _step(state, None)
    with prof.window(n):
        for k in range(n):
            _step(state, state["first"] if k == 0 else state["last"])
    return {"steps": n, **state["shapes"]}, n * len(state["calls"]), 0


def release(run, state):
    for k in ("flat", "views", "calls"):
        state.pop(k, None)


def check(run, state, source: str = "program"):
    """The widest error, as a share of the reference's largest magnitude,
    of the sampled matmul instances (``matmul_err``) and attention
    instances (``flash_err``). ``source`` "control": the reference at
    int4 and TF32 in the program's place."""
    import torch

    from bench.harness import worst
    from bench.reference.ops import attention, quantized_matmul
    from bench.weights import draw
    plan = state["plan"]
    flat, views = draw(torch, state["layout"], run.seed, run.device,
                       "operands")
    errs = {"matmul_err": 0.0, "flash_err": 0.0}
    for idx, (i, j) in state["sampled"].items():
        op, s = plan.ops[i], plan.ops[i].spec
        if op.kernel == "matmul_int8":
            args = (views[f"{i}.x.{j}"], views[f"{i}.w.{j}"])
            ref = quantized_matmul(*args)
            outs = [quantized_matmul(*args, bits=4)] if source == "control" \
                else [state["first"].get(idx), state["last"].get(idx)]
            key = "matmul_err"
        else:
            kv = j % min(run.traffic["kv_sets"], op.count)
            args = (views[f"{i}.q.{j}"], views[f"{i}.k.{kv}"],
                    views[f"{i}.v.{kv}"])
            ref = attention(*args, causal=s["causal"])
            outs = [attention(*args, causal=s["causal"], precision="tf32")] \
                if source == "control" else [state["first"].get(idx),
                                             state["last"].get(idx)]
            key = "flash_err"
        top = float(ref.abs().max())
        for out in outs:
            if out is None:
                continue
            e = float((out.to(torch.float32) - ref).abs().max()) / top
            errs[key] = worst([errs[key], e])
    del flat, views
    return errs
