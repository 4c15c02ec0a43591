"""Dry run of one (arch x shape x mesh) cell on the production mesh: the
shapes and per-device bytes of every input, parameter and state or cache
under the sharding plan, and the step's flops. Nothing is allocated and
no device is touched:

  * the mesh is `launch.mesh.make_production_mesh` laid over the
    ``"fake"`` process group at world size 256 (512 with
    ``--multi-pod``), this process standing for rank 0;
  * the model, its state and caches are built on ``torch.device("meta")``
    and distributed as DTensors with the plan's placements
    (`sharding.rules`), so each local shape is the largest shard's;
  * flops are counted by ``torch.utils.flop_counter.FlopCounterMode`` over
    the step on meta tensors, at 1 and 2 layer units, and extrapolated to
    the full depth with the reference's clamp. An op without a meta
    kernel makes them null, the op named in ``flops_error``; any other
    error fails the cell.

What the record holds that the reference's does not, and why:

  * ``flops_basis: "global/devices"``: no partitioned program is lowered,
    so ``flops_per_device`` is the global count over the mesh size, and
    only the ops FlopCounterMode knows are counted (matmuls, convolutions,
    attention), not elementwise work;
  * ``collective_bytes_per_device`` is null, with
    ``collective_reason``: without a partitioned program there are no
    collectives to read; `roofline.roofline_terms` leaves that term out;
  * ``bytes_per_device`` is the step's inputs, parameters, state and
    caches, each read or written once (``bytes_basis``): a lower bound on
    the memory term; temporaries are not measured (``memory.temp_bytes``
    null);
  * the plan does not reach the model's forward here (no ``shard_fn``
    inside it): the shapes come from the placements alone.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
        --shape decode_32k --out DIR

Run each cell in its own process: the fake process group is process-wide.
A record is written to ``DIR/<arch>__<shape>__<single|multi>.json`` and
nowhere else.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes, \
    get_config
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.param_names import reference_leaf
from repro_torch.sharding import rules

META = torch.device("meta")
COLLECTIVE_REASON = ("no partitioned program is lowered: the forward runs "
                     "on meta tensors without shard_fn, so there are no "
                     "collectives to count")
BYTES_BASIS = ("inputs, parameters, optimizer state and caches per device, "
               "each read or written once; temporaries not measured")


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                dtype=torch.bfloat16) -> dict:
    """Meta stand-ins for every model input (the reference's
    ``input_specs``)."""
    b = shape.global_batch
    l = 1 if shape.is_decode else shape.seq_len
    specs = {"tokens": torch.empty((b, l), dtype=torch.int32, device=META)}
    if shape.kind == "train":
        specs["labels"] = torch.empty((b, l), dtype=torch.int32, device=META)
    if cfg.modality in ("audio", "vision") and not shape.is_decode:
        specs["frontend"] = torch.empty((b, cfg.frontend_seq, cfg.d_model),
                                        dtype=dtype, device=META)
    return specs


def sanitize(spec: tuple, shape, mesh) -> tuple:
    """Drop mesh axes from any dim they do not evenly divide (decode steps
    have degenerate length-1 axes, batch=1 long-context cells, etc.), as
    the reference's ``_sanitize`` does: the whole entry when it divides,
    else its longest dividing prefix."""
    axes = rules.mesh_axes(mesh)
    dims = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for d, size in zip(dims, shape):
        if d is None:
            out.append(None)
            continue
        names = rules.spec_axes(d)
        keep, n = [], 1
        if size % math.prod(axes[a] for a in names) == 0:
            keep = list(names)
        else:
            for a in names:
                if size % (n * axes[a]) == 0:
                    keep.append(a)
                    n *= axes[a]
                else:
                    break
        out.append(tuple(keep) if len(keep) > 1 else
                   (keep[0] if keep else None))
    return tuple(out)


def _entry(t: torch.Tensor, spec: tuple, mesh, layers: int = 1) -> dict:
    """One tensor's record: its global shape (``layers`` stacked in front
    when > 1, as the reference's tree holds it), dtype, spec, the local
    shape of its DTensor on ``mesh`` and the bytes of that shard."""
    from torch.distributed.tensor import distribute_tensor
    local = list(distribute_tensor(t, mesh, rules.placements(spec, mesh))
                 .to_local().shape)
    shape = list(t.shape)
    if layers > 1:
        shape, local = [layers] + shape, [layers] + local
    return {"shape": shape, "dtype": str(t.dtype).replace("torch.", ""),
            "spec": list(spec), "local_shape": local,
            "bytes_per_device": math.prod(local) * t.element_size()}


def param_entries(named, plan, mesh) -> dict:
    """One entry per leaf of the reference's parameter tree, from the
    port's (name, tensor) pairs (parameters, or an optimizer moment by
    its parameter's name): the per-layer tensors of a stack are one leaf
    with a leading layer axis, whose spec is the reference's (that axis
    never sharded)."""
    groups: dict[str, list] = {}
    for name, p in named:
        groups.setdefault(reference_leaf(name), []).append((name, p))
    out = {}
    for leaf, members in groups.items():
        name, p = members[0]
        spec = plan.param_spec_for(name, p)
        e = _entry(p, spec, mesh, layers=len(members)
                   if leaf != name else 1)
        e["spec"] = list(plan.param_spec(tuple(leaf.split(".")),
                                         p.ndim + (leaf != name)))
        out[leaf] = e
    return out


def _leaves(tree, prefix: str = ""):
    """(name, tensor) of a cache tree: NamedTuple fields by name, tuple
    items by index, None skipped."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    fields = getattr(tree, "_fields", None)
    keys = fields if fields is not None else range(len(tree))
    for k, sub in zip(keys, tree):
        yield from _leaves(sub, f"{prefix}.{k}" if prefix else str(k))


def cache_entries(caches, plan, mesh) -> dict:
    """The reference's cache shardings (``_cache_shardings``): by rank and
    dtype, a 5-d float32 tensor is an SSM state, another 5-d one a KV
    cache, 4-d an SSM conv state, 2-d the KV lengths, 3-d (the encoder's
    memory) the batch spec as it is, anything else replicated; a cache
    spec is cut to the tensor's rank and sanitized."""
    out = {}
    for name, t in _leaves(caches):
        nd = t.ndim
        kind = {5: "ssm_h" if t.dtype == torch.float32 else "kv",
                4: "ssm_conv", 2: "kv_len"}.get(nd)
        if kind is not None:
            spec = sanitize(plan.cache_spec(kind)[:nd], t.shape, mesh)
        else:
            spec = plan.batch_spec() if nd == 3 else ()
        out[name] = _entry(t, spec, mesh)
    return out


STEP_CFG = dict(remat=True, microbatches=1)


def _step_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Global flops of one step of ``cfg`` on meta tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import transformer
    from repro_torch.train import optimizer, steps

    step_cfg = steps.StepConfig(**STEP_CFG)
    model = transformer.init_model(cfg, None, torch.float32, META)
    batch = input_specs(cfg, shape)
    with FlopCounterMode(display=False) as counter:
        if shape.kind == "train":
            params = dict(model.named_parameters())
            state = steps.TrainState(params=model,
                                     opt=optimizer.init_adamw(params),
                                     residuals=None, rng=0)
            steps.make_train_step(cfg, optimizer.OptimizerConfig(),
                                  step_cfg)(state, batch)
        elif shape.kind == "prefill":
            steps.make_prefill_step(cfg, step_cfg)(model, batch)
        else:
            caches = steps.init_caches(cfg, shape.global_batch,
                                       shape.seq_len, device=META)
            steps.make_decode_step(cfg, step_cfg)(model, batch, caches)
    return float(counter.get_total_flops())


def lower_cell(arch_id: str, shape_name: str, *, multi_pod: bool, mesh,
               cfg: ModelConfig | None = None) -> dict:
    """The record of one cell on ``mesh`` (the production mesh)."""
    t0 = time.monotonic()
    cfg = cfg or get_config(arch_id)
    shape = SHAPES[shape_name]
    if applicable_shapes(cfg)[shape_name] is None:
        return {"arch": arch_id, "shape": shape_name,
                "multi_pod": multi_pod, "status": "skipped",
                "reason": "quadratic attention at 512k seq "
                          "(assignment rule)"}
    from repro_torch.models import transformer
    from repro_torch.train import optimizer, steps

    plan = rules.make_plan(mesh, cfg, shape)
    n_dev = math.prod(rules.mesh_axes(mesh).values())

    # cost slope from two small exact counts, as the reference's
    unit = cfg.attn_every if cfg.family == "hybrid" else 1
    if cfg.family == "encdec":
        c1 = dataclasses.replace(cfg, encoder_layers=1, n_layers=1)
        c2 = dataclasses.replace(cfg, encoder_layers=2, n_layers=2)
        n_units = float(cfg.n_layers)   # enc and dec depths are equal (24)
    else:
        c1 = dataclasses.replace(cfg, n_layers=unit)
        c2 = dataclasses.replace(cfg, n_layers=2 * unit)
        n_units = cfg.n_layers / unit
    flops = f1 = f2 = flops_error = None
    t_flops = time.monotonic()
    try:
        f1 = _step_flops(c1, shape)
        f2 = _step_flops(c2, shape)
        # clamp: one-time (depth-independent) costs can make f2 < f1;
        # never extrapolate below the measured floor
        flops = max(f1 + (n_units - 1.0) * (f2 - f1), min(f1, f2), 0.0)
    except NotImplementedError as e:        # an op with no meta kernel
        frame = traceback.extract_tb(e.__traceback__)[-1]
        flops_error = (f"{type(e).__name__} at {frame.name} "
                       f"({os.path.basename(frame.filename)}:"
                       f"{frame.lineno}): {e}")[:500]
    t_flops = time.monotonic() - t_flops

    model = transformer.init_model(cfg, None, torch.float32, META)
    # the decode step's input caches; the prefill's are its output
    caches = None
    if shape.is_decode:
        caches = steps.init_caches(cfg, shape.global_batch, shape.seq_len,
                                   device=META)
    elif shape.kind == "prefill" and flops_error is None:
        _, caches = steps.make_prefill_step(cfg, steps.StepConfig(
            **STEP_CFG))(model, input_specs(cfg, shape))
    params = param_entries(model.named_parameters(), plan, mesh)
    inputs = {k: _entry(v, sanitize(plan.batch_spec(), v.shape, mesh)
                        if v.ndim >= 2 else (), mesh)
              for k, v in input_specs(cfg, shape).items()}
    state = {}
    if shape.kind == "train":
        opt = optimizer.init_adamw(dict(model.named_parameters()))
        for moment in ("m", "v"):
            for leaf, e in param_entries(getattr(opt, moment).items(), plan,
                                         mesh).items():
                state[f"opt.{moment}.{leaf}"] = e
        state["opt.step"] = _entry(opt.step, (), mesh)
    cache = cache_entries(caches, plan, mesh) if caches is not None else {}
    by_kind = {kind: sum(e["bytes_per_device"] for e in group.values())
               for kind, group in (("inputs", inputs), ("params", params),
                                   ("state", state), ("caches", cache))}
    argument = by_kind["inputs"] + by_kind["params"] + by_kind["state"] + \
        (by_kind["caches"] if shape.is_decode else 0)
    return {
        "arch": arch_id,
        "shape": shape_name,
        "multi_pod": multi_pod,
        "status": "ok",
        "mesh": rules.mesh_axes(mesh),
        "flops_per_device": None if flops is None else flops / n_dev,
        "flops_basis": "global/devices",
        "flops_global": flops,
        "flops_error": flops_error,
        "bytes_per_device": sum(by_kind.values()),
        "bytes_basis": BYTES_BASIS,
        "bytes_per_device_by_kind": by_kind,
        "collective_bytes_per_device": None,
        "collective_reason": COLLECTIVE_REASON,
        "flops_rolled_module": None,
        "memory": {"argument_bytes": argument,
                   "output_bytes": 0 if shape.is_decode
                   else by_kind["caches"],
                   "temp_bytes": None, "peak_bytes": None},
        "seconds": round(time.monotonic() - t0, 1),
        "seconds_counting_flops": round(t_flops, 1),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "cost_extrapolation": {"unit_layers": unit, "n_units": n_units,
                               "f1": f1, "f2": f2},
        "shapes": {"inputs": inputs, "params": params, "state": state,
                   "caches": cache},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Dry run of one (arch x shape x mesh) cell on the fake "
                    "process group: per-device shapes and bytes under the "
                    "sharding plan, and the step's flops.")
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (pod=2, data=16, model=16) mesh of 512 ranks")
    ap.add_argument("--out", required=True,
                    help="directory for the JSON record")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh

    world = 512 if args.multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    tag = f"{args.arch}__{args.shape}__" \
          f"{'multi' if args.multi_pod else 'single'}"
    try:
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device_type="cpu")
        rec = lower_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                         mesh=mesh)
    except Exception as e:                  # the record says what failed
        rec = {"arch": args.arch, "shape": args.shape,
               "multi_pod": args.multi_pod, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
    finally:
        dist.destroy_process_group()
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, tag + ".json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[dryrun] {tag}: {rec['status']} ({rec.get('seconds', '-')} s) "
          f"-> {path}", flush=True)
    return 0 if rec["status"] in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
