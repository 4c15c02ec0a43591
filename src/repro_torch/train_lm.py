"""End-to-end training driver: the counterpart of the reference's
``launch/train.py``, on one device or on a device mesh.

    PYTHONPATH=src python -m repro_torch.train_lm --arch minicpm-2b --steps 200 --batch 8 --seq 64
    PYTHONPATH=src python -m repro_torch.train_lm --reduced --device cpu --steps 20
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.train_lm --reduced --device cpu --steps 20

Wires together: config registry -> model init on the device (from
``--seed``) -> deterministic data pipeline (`data.pipeline`, numpy
batches moved to the device) -> train step (`train.steps`) ->
checkpoint manager with restart (`checkpoint`, the reference's layout on
disk) -> heartbeat / straggler policies (`runtime.fault_tolerance`).
Under ``--reduced`` the step computes in float32, otherwise in bfloat16;
remat is on either way. minicpm trains with the WSD schedule, every other
model with cosine, warmed up over ``max(steps // 20, 5)`` steps. The vlm
and encdec models read the stream's frontend embeddings.

It runs on the card unless ``--device cpu`` is passed; ``--device cuda``
without a card fails before the model is drawn.

On a mesh: when ``WORLD_SIZE`` is in the environment (``torchrun`` sets
it, with ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) or a default
process group exists, the run trains on a mesh, as the reference's always
does. It starts the group itself if there is none (``nccl`` for ``--device
cuda``, one card per rank by ``LOCAL_RANK``; ``gloo`` for ``--device
cpu``), lays `launch.mesh.make_host_mesh` over it (data 1, model = the
ranks), or `launch.mesh.make_production_mesh` under ``--production-mesh``
(256 ranks; with another count it raises, naming the ranks it needs),
builds the plan for ``ShapeSpec("cli", seq, batch, "train")``, draws the
state onto the plan (`sharding.state.init_sharded_train_state`: the
one-device state's values), places each batch on the plan's batch spec
(every rank draws the same global batch) and runs the step with the
plan's ``shard_fn`` inside the forward. Checkpoints keep the one-device
layout (`checkpoint`), so either run resumes from the other's. Only rank
0 prints. Without ``WORLD_SIZE`` and without a group the run is the
one-device run, unchanged.

Restart: with ``--ckpt-dir`` the run resumes from the newest checkpoint
there, as the reference's does: a checkpoint of step s holds the state
after update s, and the resumed run starts with ``data.batch(s)``, so
batch s is applied twice (ROADMAP Queue C, reference fault 8).

Two checks ride along, those of the reference's ``examples/train_lm.py``:

    PYTHONPATH=src python -m repro_torch.train_lm --restart-demo --reduced --device cpu --steps 100 --batch 16
    PYTHONPATH=src python -m repro_torch.train_lm --dataflow --reduced --device cpu --steps 10 --batch 16

``--restart-demo`` trains to 60 % of ``--steps``, checkpointing, then
restarts from the checkpoint and runs to the end; the last-10 mean loss
must be below 0.7 x the first-10 mean. ``--dataflow`` trains briefly,
then lowers the same training config through the CIM optimizer
(`core.training.optimize_training`) and asserts that the LM head's
lowered tokens are seq x batch and that the optimizer bill covers exactly
the live model's ``.w`` leaves plus the embedding table.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.configs import ARCH_IDS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="minicpm-2b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced widths, float32 compute")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true",
                    help="train on the production mesh (data 16 x model "
                         "16: 256 ranks)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="the model's init and the data stream")
    ap.add_argument("--restart-demo", action="store_true",
                    help="train to 60%% of --steps, restart from the "
                         "checkpoint, check the loss fell below 0.7x")
    ap.add_argument("--dataflow", action="store_true",
                    help="short run, then the optimized training dataflow "
                         "checked against the live model")
    return ap


def to_device(host_batch: dict, device, plan=None,
              microbatches: int = 1) -> dict:
    """numpy batch -> tensors on ``device``; token ids as int64. With a
    sharding ``plan``, ``DTensor``s on its mesh: those of rank >= 2 on
    the plan's batch spec, the others replicated, as the reference's
    driver places them (``launch/train.py:96-98``), the rows in the
    order that gives each rank its share of every one of
    ``microbatches`` (`sharding.state.place_batch`); every rank holds the
    same global batch and keeps its own shards."""
    import torch
    out = {}
    for k, v in host_batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
        if plan is not None:
            from repro_torch.sharding.state import place_batch
            out[k] = place_batch(out[k], plan, microbatches)
    return out


def on_mesh_requested() -> bool:
    """Whether the run trains on a mesh: ``WORLD_SIZE`` is set or a
    default process group exists."""
    import os

    import torch.distributed as dist
    return "WORLD_SIZE" in os.environ or (dist.is_available() and
                                          dist.is_initialized())


def rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def log(*args, **kwargs) -> None:
    """``print`` on rank 0 (and off a mesh)."""
    if rank() == 0:
        print(*args, **kwargs)


def start_group(device: str) -> bool:
    """The default process group from the environment (``torchrun``'s
    variables), unless one exists: ``nccl`` on the card, one card per
    rank by ``LOCAL_RANK``, ``gloo`` on the host. Returns whether it
    started one."""
    import os

    import torch
    import torch.distributed as dist
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device == "cuda" else "gloo")
    return True


def make_mesh(args, cfg, mesh=None):
    """(the mesh, the plan) of the parsed flags on the default process
    group: ``mesh`` when given, else the production mesh under
    ``--production-mesh``, else the host mesh (data 1, model = the
    ranks)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.sharding.rules import make_plan
    if mesh is None:
        mesh = make_production_mesh(device_type=args.device) \
            if args.production_mesh else \
            make_host_mesh(device_type=args.device)
    return mesh, make_plan(mesh, cfg, ShapeSpec("cli", args.seq, args.batch,
                                                "train"))


def configure(args):
    """(model config, optimizer config, step config, data stream) of the
    parsed flags, as ``launch/train.py:48-73`` makes them."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.steps import StepConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    # minicpm trains with the WSD schedule (its paper's contribution)
    schedule = "wsd" if args.arch.startswith("minicpm") else "cosine"
    opt_cfg = OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 20,
                                                           5),
                              total_steps=args.steps, schedule=schedule)
    step_cfg = StepConfig(microbatches=args.microbatches, remat=True,
                          compute_dtype=torch.float32 if args.reduced
                          else torch.bfloat16)
    data = SyntheticLMData(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed,
        frontend_seq=cfg.frontend_seq if cfg.modality != "text" else 0,
        d_model=cfg.d_model))
    return cfg, opt_cfg, step_cfg, data


def run(argv=None, *, on_step=None, record=None, mesh=None):
    """Train as ``launch/train.py`` does and return (losses, the final
    ``TrainState``). ``on_step(step, loss, seconds, state)``, when
    given, is called after every step with the step's wall seconds and
    the state after it. ``record``, a dict when given, receives the
    metrics of every step as floats (``steps``), the seconds the state
    took to draw (and place) (``init_s``), the step resumed from
    (``start_step``) and, on a mesh, its axes and the plan (``mesh``,
    ``plan``). ``mesh``: a ``DeviceMesh`` with ``data`` and ``model``
    axes to train on in place of the host or production mesh."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.executor import check_device
    from repro_torch.runtime.fault_tolerance import HeartbeatMonitor, \
        StragglerPolicy
    from repro_torch.sharding.rules import mesh_axes
    from repro_torch.sharding.state import StateShardings, \
        init_sharded_train_state
    from repro_torch.train.steps import init_train_state, make_train_step

    args = build_parser().parse_args(argv)
    check_device(args.device)
    cfg, opt_cfg, step_cfg, data = configure(args)
    record = {} if record is None else record
    plan = shardings = None
    if mesh is not None or args.production_mesh or on_mesh_requested():
        start_group(args.device)
        mesh, plan = make_mesh(args, cfg, mesh)
        shardings = StateShardings(plan, mesh)
        record.update(mesh=mesh_axes(mesh), plan=plan)
    device = torch.device(args.device, torch.cuda.current_device()) \
        if plan is not None and args.device == "cuda" else \
        torch.device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else \
        (lambda: None)

    t0 = time.monotonic()
    if plan is None:
        state = init_train_state(args.seed, cfg, step_cfg, device=device)
        step = make_train_step(cfg, opt_cfg, step_cfg)
    else:
        state = init_sharded_train_state(args.seed, cfg, step_cfg, plan,
                                         plan.mesh, device=device)
        step = make_train_step(cfg, opt_cfg, step_cfg, plan.shard_fn())
        log(f"[mesh] {record['mesh']} ({mesh.device_type}), the state "
            f"placed by the plan")
    sync()
    record["init_s"] = time.monotonic() - t0

    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
        state, start_step, _ = ckpt.restore_or_init(state, shardings)
        if start_step:
            log(f"[restore] resumed from step {start_step}")
    record.update(start_step=start_step, steps=[])

    hb = HeartbeatMonitor(n_hosts=1)
    straggler = StragglerPolicy()
    losses = []
    for s in range(start_step, args.steps):
        sync()
        t0 = time.monotonic()
        batch = to_device(data.batch(s), device, plan,
                          step_cfg.microbatches)
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.monotonic() - t0
        record["steps"].append({k: float(v) for k, v in metrics.items()})
        hb.beat(0)
        straggler.record(0, dt)
        if on_step is not None:
            on_step(s, loss, dt, state)
        if s % args.log_every == 0 or s == args.steps - 1:
            log(f"step {s:5d} loss {loss:.4f} "
                f"lr {float(metrics['lr']):.2e} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"{dt*1e3:.0f}ms", flush=True)
        if ckpt:
            ckpt.maybe_save(s, state, {"loss": loss})
    log(f"[done] first-10 mean loss {np.mean(losses[:10]):.4f} -> "
        f"last-10 mean loss {np.mean(losses[-10:]):.4f}")
    return losses, state


def _with(argv: list[str], **flags) -> list[str]:
    """``argv`` with each ``--flag value`` set (replacing any given)."""
    out, skip = [], False
    names = {"--" + k.replace("_", "-") for k in flags}
    for a in argv:
        if skip:
            skip = False
        elif a in names:
            skip = True
        elif a.split("=")[0] not in names:
            out.append(a)
    for k, v in flags.items():
        out += ["--" + k.replace("_", "-"), str(v)]
    return out


def restart_demo(argv: list[str], args) -> tuple[list[float], list[float]]:
    """Train to 60 % of the steps with checkpoints, restart from the
    newest one and run to the end; the loss must fall below 0.7x."""
    import torch.distributed as dist
    argv = [a for a in argv if a != "--restart-demo"]
    ckpt_dir = args.ckpt_dir
    if not ckpt_dir:
        ckpt_dir = [tempfile.mkdtemp(prefix="repro_ckpt_") if rank() == 0
                    else None]
        if dist.is_initialized():           # one directory for every rank
            dist.broadcast_object_list(ckpt_dir, src=0)
        ckpt_dir = ckpt_dir[0]
    try:
        mid = int(args.steps * 0.6)
        losses1, _ = run(_with(argv, steps=mid, ckpt_dir=ckpt_dir))
        log(f"\n--- simulating failure + restart from {ckpt_dir} ---\n")
        losses2, _ = run(_with(argv, ckpt_dir=ckpt_dir))
    finally:
        if not args.ckpt_dir and rank() == 0:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    first = sum(losses1[:10]) / len(losses1[:10])
    last = sum(losses2[-10:]) / len(losses2[-10:])
    log(f"\nloss {first:.3f} -> {last:.3f}")
    if not last < first * 0.7:
        raise RuntimeError(f"training did not converge: {first:.4f} -> "
                           f"{last:.4f}, not below 0.7x")
    log("OK: loss decreased through a checkpoint restart.")
    return losses1, losses2


def live_matmul_params(state) -> int:
    """The live model's trainable matmul parameters: every ``.w`` leaf
    plus the embedding table (tied LM head)."""
    return sum(p.numel() for n, p in state.params.named_parameters()
               if n.endswith(".w") or ("embed" in n and "table" in n))


def dataflow_demo(argv: list[str], args, budget_s: float = 2.0):
    """Train briefly, then report the optimized training dataflow of this
    exact config (fwd / dGrad / wGrad), checked against the live model:
    the LM head's training GEMMs carry exactly one step's tokens, and the
    optimizer bill covers exactly the live matmul parameters."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.arch import default_arch
    from repro_torch.core.training import backward_dataflow_diffs, \
        optimize_training, phase_of

    argv = [a for a in argv if a != "--dataflow"]
    steps = max(10, min(args.steps, 40))
    losses, state = run(_with(argv, steps=steps))
    cfg = configure(args)[0]
    spec = ShapeSpec("train_demo", args.seq, args.batch, kind="train")
    res = optimize_training(cfg, spec, default_arch(),
                            per_layer_cap_s=budget_s, workers=1)
    net, update = res.net, res.update

    (head,) = [lr for lr in net.layers
               if lr.layer.name == f"{cfg.name}.lm_head"
               and phase_of(lr.layer) == "fwd"]
    lowered_tokens = head.layer.bound("N") * head.count
    live = live_matmul_params(state)
    if lowered_tokens != args.seq * args.batch or update.n_params != live:
        raise RuntimeError(
            f"lowered LM-head tokens {lowered_tokens} (seq x batch = "
            f"{args.seq * args.batch}), optimizer bill {update.n_params} "
            f"params (live {live})")

    s = net.scheduled
    log(f"\nCIM training dataflow for {cfg.name} "
          f"(seq={args.seq}, batch={args.batch}): {len(net.layers)} GEMMs, "
          f"{net.n_unique} unique solves")
    log(f"lowered LM-head tokens {lowered_tokens} = seq x batch; "
          f"optimizer bill {update.n_params} params = the live model's")
    log(f"cycle split: fwd {res.splits['fwd']:.3g} / "
          f"dgrad {res.splits['dgrad']:.3g} / "
          f"wgrad {res.splits['wgrad']:.3g}; optimizer update "
          f"{update.total_cycles:.3g} cycles over {update.n_params} params")
    log(f"multi-core schedule: {s['cycles']:.3g} cycles end-to-end "
          f"({s['serial_cycles'] / max(s['cycles'], 1.0):.2f}x vs serial); "
          f"one step = {res.step_cycles:.3g} cycles")
    top = max((lr for lr in net.layers if phase_of(lr.layer) == "fwd"),
              key=lambda lr: lr.edp * lr.count)
    by_name = {lr.layer.name: lr for lr in net.layers}
    log(f"heaviest forward GEMM {top.layer.name} "
          f"(M={top.layer.bound('N')}, N={top.layer.bound('K')}, "
          f"K={top.layer.bound('C')}) x{top.count}:")
    for suffix in ("", ".dgrad", ".wgrad"):
        lr = by_name[top.layer.name + suffix]
        mp = lr.record["mapping"]
        log(f"  {suffix or '.fwd':7s} spatial {mp['spatial']} "
              f"temporal {mp['temporal']}")
    diffs = backward_dataflow_diffs(net)
    differing = [d["layer"] for d in diffs if d["differs"]]
    log(f"wGrad dataflow differs from forward on {len(differing)}/"
          f"{len(diffs)} layers: {differing}")
    log("OK: training dataflow report matches the live model.")
    return {"tokens": lowered_tokens, "n_params": update.n_params,
            "live_params": live, "result": res}


def main(argv=None):
    """Train and return the losses; with ``--restart-demo`` the losses
    of both runs, with ``--dataflow`` the report's counts."""
    import sys

    import torch.distributed as dist
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    started = start_group(args.device)
    try:
        if args.restart_demo:
            return restart_demo(argv, args)
        if args.dataflow:
            return dataflow_demo(argv, args)
        return run(argv)[0]
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
