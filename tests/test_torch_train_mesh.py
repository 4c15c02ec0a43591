"""The train step and the driver on a device mesh (`repro_torch.sharding`,
`train.steps` with ``shard=plan.shard_fn()``, `sharding.state`,
`checkpoint` on DTensors, `train_lm` under a process group), on the CPU
over two ``gloo`` ranks, against the reference's jitted step without a
mesh and against the port's one-device driver.

Two mesh layouts, each one pair of rank processes started once for the
whole module, both pairs at the same time, torch on one thread a rank;
every case runs inside them and rank 0 hands the results back:

- ``host``: `launch.mesh.make_host_mesh(device_type="cpu")`, (data 1,
  model 2): tensor parallelism (heads, FFN hidden, vocab, experts);
- ``fsdp``: ``init_device_mesh`` (data 2, model 1): parameters and the
  batch sharded over ``data``;
- ``both``: (data 2, model 2), four ranks, both axes split, for
  qwen2-moe-a2.7b only: its dispatch on each rank's own tokens.

The ranks are plain processes started with ``torchrun``'s variables
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), with
different string hashes (`HASH_SEEDS`). The two pairs run together,
then the four ranks of ``both``, and all share one deadline
(`MESH_TIMEOUT_S`): a collective that waits for ever fails the
module, with every rank's stacks in the message, instead of holding the
suite.

Cases, each its own test id:
- (a) one sharded train step of one reduced config of every family,
  from the reference's initial state (`convert.params_from_numpy`), the
  updated state gathered back (``full_tensor``), against the reference's
  jitted ``make_train_step`` without ``shard_fn`` at the tolerances of
  `test_torch_train` (`test_sharded_step_matches_jax`);
- (b) the int8 compression's per-leaf scales, decompressed gradients
  and residuals of the one-device gradients laid on the mesh, bit-equal
  to the one-device ones (`test_compression_on_sharded_grads_bit_equal`);
- (c) ``train_lm`` through a save and a resume on the mesh against the
  one-device ``train_lm`` with the same flags, the mesh's checkpoint read
  by the reference's ``load_checkpoint``, the one-device checkpoint
  restored onto the mesh, the sharded initial state equal to the
  one-device one (`test_train_lm_on_a_mesh_through_restart`);
- (d) every shard point's output on ``plan.act_spec`` of its name
  (`test_shard_points_take_the_plan_specs`);
- (e) the embedding gather's rows on ``act_spec("hidden")``
  (`test_embedding_gather_placements`);
- (f) a decode step's attention over a cache split along its sequence
  over the model axis, which stays there, against the plain attention
  (`test_decode_attention_on_key_shards`);
- (g) a step of two microbatches of qwen2-moe-a2.7b, each rank's local
  chunks (`sharding.state.place_batch`), against the reference's step
  with the same microbatches (`test_microbatch_step_matches_jax`);
- (h) on ``both``: a qwen2-moe-a2.7b step
  (`test_moe_step_on_both_axes_matches_jax`) and its routing's positions
  and ``keep``, bit-equal to one device's
  (`test_moe_positions_on_both_axes_bit_equal`).

Tolerances. Sharding moves float32 sums into another order (partial sums
over the model axis, the batch over data): losses, norms, learning rates
and the decode attention within `test_torch_train.F32`; one step's state
by `test_torch_train._check_state`. A state after n driver updates (6 at
the end, 4 in the checkpoint) is held as one step's is, with each
update's allowance taken n times: m and v within n * MOMENT_REL of their
leaf's largest entry, a weight within n * (lr * 1e-3 + 2 ulp), or where
a gradient is small enough to flip its sign, n * 2 * lr. The mesh's
checkpoint holds the mesh run's own state bit for bit.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config as jax_config
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch import train_lm
from repro_torch.configs import get_config
from repro_torch.models.convert import flatten

from test_torch_train import MOMENT_REL, OPT, _batch, _check_state, close

ROOT = Path(__file__).resolve().parents[1]
#: One reduced config of every family (the ssm and hybrid at 4 tokens,
#: as `test_torch_train.seq_of` says).
ARCHS = ("minicpm-2b", "mamba2-1.3b", "qwen2-moe-a2.7b", "zamba2-1.2b",
         "pixtral-12b", "seamless-m4t-large-v2")
LAYOUTS = {"host": (1, 2), "fsdp": (2, 1)}
#: The layout with both axes split; its four ranks run (g) and (h) only.
BOTH = (2, 2)
MOE_ARCH = "qwen2-moe-a2.7b"
#: (g)'s microbatches and batch rows: two rows of each microbatch a rank
#: on ``both``.
MB, MB_BATCH = 2, 8
#: The shard points of the reference's forward.
SHARD_POINTS = {"hidden", "logits", "attn_q", "attn_out", "ffn_hidden",
                "moe_expert_in", "moe_expert_out", "ssm_x"}
#: The step run 1 saves: the state after its CKPT_STEP + 1 updates.
CKPT_STEP = 3
#: train_lm's flags (c): run 1 saves at CKPT_STEP, run 2 resumes to 6.
DRIVER = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "16",
          "--lr", "1e-3", "--log-every", "100"]
RUN1, RUN2 = ["--steps", "4", "--ckpt-every", str(CKPT_STEP)], \
    ["--steps", "6", "--ckpt-every", "100"]
DRIVER_STEPS = 6
#: Seconds every layout's ranks may take together, every case included;
#: a rank that is still running some seconds before it prints its stacks
#: and exits.
MESH_TIMEOUT_S = 420
#: Each rank's string hashes (``PYTHONHASHSEED``), different on the two
#: ranks as on two processes started apart: a layout that DTensor chose
#: by a set's order would differ between the ranks and show here.
HASH_SEEDS = ("20", "21")

_WORKER = """
import faulthandler, os, pickle, sys, traceback
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
layout, io, stacks_after = sys.argv[1], sys.argv[2], float(sys.argv[3])
faulthandler.dump_traceback_later(stacks_after, exit=True)
dist.init_process_group("gloo")
rank = dist.get_rank()
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import train_lm
from repro_torch.checkpoint.checkpoint import load_checkpoint
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import compression
from repro_torch.models.attention import attend
from repro_torch.sharding.rules import PlanShard, embedding_rows, \\
    is_dtensor, make_plan, placements
from repro_torch.sharding.state import StateShardings, distribute_state, \\
    init_sharded_train_state, place, place_batch
from repro_torch.train import optimizer, steps

mesh = make_host_mesh(device_type="cpu") if layout == "host" else \\
    init_device_mesh("cpu", (2, 2) if layout == "both" else (2, 1),
                     mesh_dim_names=("data", "model"))
with open(os.path.join(io, "in.pkl"), "rb") as f:
    inp = pickle.load(f)
out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "errors": {}}


def plain(named):
    return {n: (t.full_tensor() if is_dtensor(t) else t).detach().clone()
            for n, t in named}


def batch_of(arrays, plan, microbatches=1):
    return {k: place_batch(torch.from_numpy(v).long() if v.dtype == np.int32
                           else torch.from_numpy(v), plan, microbatches)
            for k, v in arrays.items()}


def case(name, fn):
    print(f"[rank {rank}] {name}", flush=True)
    try:
        out[name] = fn()
    except Exception:
        out["errors"][name] = traceback.format_exc()[-3000:]


def sharded_step(arch, c):
    cfg = get_config(arch).reduced()
    b, l = c["batch"]["tokens"].shape
    plan = make_plan(mesh, cfg, ShapeSpec("t", l, b, "train"))
    model = params_from_numpy(cfg, c["params"])
    params = dict(model.named_parameters())
    state = distribute_state(
        steps.TrainState(model, optimizer.init_adamw(params), None, 0),
        StateShardings(plan, mesh))
    seen = {}

    class Recording(PlanShard):
        def __call__(self, name, x):
            y = super().__call__(name, x)
            seen.setdefault(name, (tuple(str(p) for p in y.placements),
                                   tuple(str(p) for p in placements(
                                       plan.act_spec(name), mesh))))
            return y

    mb = c.get("microbatches", 1)
    step = steps.make_train_step(
        cfg, optimizer.OptimizerConfig(**c["opt"]),
        steps.StepConfig(compute_dtype=torch.float32, microbatches=mb),
        Recording(plan))
    new, met = step(state, batch_of(c["batch"], plan, mb))
    return {"metrics": {k: float(v) for k, v in met.items()},
            "metrics_plain": all(not is_dtensor(v) for v in met.values()),
            "params": plain(new.params.named_parameters()),
            "m": plain(new.opt.m.items()), "v": plain(new.opt.v.items()),
            "step": int(new.opt.step), "seen": seen,
            "sharded": all(is_dtensor(p) for p in new.params.parameters())}


def compression_case():
    arch, c = "minicpm-2b", inp["steps"]["minicpm-2b"]
    cfg = get_config(arch).reduced()
    b, l = c["batch"]["tokens"].shape
    plan = make_plan(mesh, cfg, ShapeSpec("t", l, b, "train"))
    model = params_from_numpy(cfg, c["params"])
    arrays = {k: torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v) for k, v in c["batch"].items()}
    grads, _, _ = steps.loss_and_grads(
        model, cfg, steps.StepConfig(compute_dtype=torch.float32), arrays)
    res = {n: torch.full_like(g, 1e-3) for n, g in grads.items()}
    shard = StateShardings(plan, mesh)
    dgrads = {n: place(g, mesh, shard.spec("params." + n, g))
              for n, g in grads.items()}
    dres = {n: place(r, mesh, shard.spec("params." + n, r))
            for n, r in res.items()}
    want = compression.leaf_scales(grads, res)
    got = compression.leaf_scales(dgrads, dres)
    deq, new_res = compression.compress_grads_with_feedback(grads, res)
    ddeq, dnew_res = compression.compress_grads_with_feedback(dgrads, dres)
    return {"sharded": all(is_dtensor(g) for g in dgrads.values()),
            "scales_equal": {k: bool(torch.equal(
                got[k].full_tensor() if is_dtensor(got[k]) else got[k],
                want[k])) for k in want},
            "deq_equal": all(torch.equal(ddeq[n].full_tensor(), deq[n])
                             for n in deq),
            "res_equal": all(torch.equal(dnew_res[n].full_tensor(),
                                         new_res[n]) for n in new_res)}


def driver_case():
    ckpt = os.path.join(io, "mesh_ckpt")
    argv = inp["driver"] + ["--ckpt-dir", ckpt]
    rec1, rec2, saved = {}, {}, {}

    def keep_saved(s, loss, dt, st):
        if s == inp["ckpt_step"]:               # the state it saves
            saved.update(params=plain(st.params.named_parameters()),
                         m=plain(st.opt.m.items()), v=plain(st.opt.v.items()))

    losses1, _ = train_lm.run(argv + inp["run1"], record=rec1, mesh=mesh,
                              on_step=keep_saved)
    losses2, st = train_lm.run(argv + inp["run2"], record=rec2, mesh=mesh)
    final = {"params": plain(st.params.named_parameters()),
             "m": plain(st.opt.m.items()), "v": plain(st.opt.v.items())}
    args = train_lm.build_parser().parse_args(argv + inp["run2"])
    cfg, _, step_cfg, _ = train_lm.configure(args)
    plan = rec2["plan"]
    one = steps.init_train_state(args.seed, cfg, step_cfg)
    sharded = init_sharded_train_state(args.seed, cfg, step_cfg, plan, mesh)
    init_equal = all(torch.equal(p, q.full_tensor()) for p, q in zip(
        one.params.parameters(), sharded.params.parameters()))
    # the one-device run's checkpoint onto the mesh, and onto one device
    onto_mesh, s_mesh, _ = load_checkpoint(inp["one_ckpt"], sharded)
    onto_one, s_one, _ = load_checkpoint(inp["one_ckpt"], one)
    restored_equal = s_mesh == s_one and all(
        torch.equal(a, b) for a, b in zip(
            plain(onto_mesh.params.named_parameters()).values(),
            onto_one.params.parameters())) and all(
        torch.equal(onto_mesh.opt.m[n].full_tensor(), onto_one.opt.m[n])
        for n in onto_one.opt.m)
    return {"losses1": losses1, "losses2": losses2,
            "metrics": rec1["steps"] + rec2["steps"],
            "resumed_from": rec2["start_step"], "mesh": rec2["mesh"],
            "final": final, "saved": saved, "init_equal": init_equal,
            "restored_equal": restored_equal}


def embedding_case():
    cfg = get_config("minicpm-2b").reduced()
    plan = make_plan(mesh, cfg, ShapeSpec("t", 16, 4, "train"))
    g = torch.Generator().manual_seed(3)
    table = torch.randn(cfg.padded_vocab(), cfg.d_model, generator=g)
    ids = torch.randint(0, cfg.vocab_size, (4, 16), generator=g)
    dtable = place(table, mesh, plan.param_spec_for("embed.table", table))
    rows = embedding_rows(dtable, place(ids, mesh, plan.batch_spec()))
    return {"table": [str(p) for p in dtable.placements],
            "rows": [str(p) for p in rows.placements],
            "hidden": [str(p) for p in placements(plan.act_spec("hidden"),
                                                  mesh)],
            "values_equal": bool(torch.equal(rows.full_tensor(),
                                             table[ids]))}


def decode_case():
    # one decode step's attention over a cache laid as the plan lays one
    # whose heads do not divide the model axis: batch over data, the
    # sequence (11 rows, in uneven shards) over model
    cfg = get_config("minicpm-2b").reduced()
    plan = make_plan(mesh, cfg, ShapeSpec("t", 11, 2, "decode"))
    g = torch.Generator().manual_seed(5)
    q = torch.randn(2, 1, 4, 8, generator=g)
    k, v = (torch.randn(2, 11, 4, 8, generator=g) for _ in range(2))
    length = torch.tensor([7, 11])
    want = attend(q, k, v, causal=False, kv_length=length)
    dk, dv = (place(t, mesh, ("data", "model", None, None)) for t in (k, v))
    got = attend(place(q, mesh, ("data", None, "model", None)), dk, dv,
                 causal=False, kv_length=length, shard=plan.shard_fn())
    return {"keys": [str(p) for p in dk.placements],
            "out": [str(p) for p in got.placements],
            "got": got.full_tensor(), "want": want}


def routing_case():
    # the dispatch of 4 x 16 tokens on the mesh, at a capacity that drops
    # slots, against one device's routing of the same tokens
    import functools, types
    from repro_torch.models import moe
    cfg = get_config(inp["moe_arch"]).reduced()
    b, l, e, k = 4, 16, cfg.n_experts, cfg.top_k
    plan = make_plan(mesh, cfg, ShapeSpec("t", l, b, "train"))
    g = torch.Generator().manual_seed(7)
    x = torch.randn(b, l, cfg.d_model, generator=g)
    w = torch.randn(cfg.d_model, e, generator=g)
    router = types.SimpleNamespace(router=types.SimpleNamespace(w=w))
    want = moe.route(router, x.reshape(b * l, -1), n_experts=e, top_k=k,
                     capacity_factor=0.5)
    fn = functools.partial(moe._dispatch, n_experts=e, top_k=k,
                           capacity=want[-1], scatter=True)
    _, (gate, idx, slot), aux = plan.shard_fn().moe_dispatch(
        fn, place(x, mesh, plan.act_spec("hidden")), place(w, mesh, ()))
    return {"idx": idx.full_tensor(), "slot": slot.full_tensor(),
            "gate": gate.full_tensor(), "aux": float(aux.full_tensor()),
            "want": list(want[:5]), "capacity": want[-1],
            "tokens": [str(p) for p in idx.placements]}


if layout == "both":
    c = inp["steps"][inp["moe_arch"]]
    case("step/" + inp["moe_arch"], lambda: sharded_step(inp["moe_arch"], c))
    case("routing", routing_case)
else:
    for arch, c in inp["steps"].items():
        case("step/" + arch, lambda: sharded_step(arch, c))
    case("compression", compression_case)
    case("driver", driver_case)
    case("embedding", embedding_case)
    case("decode", decode_case)
case("step_mb2/" + inp["moe_arch"],
     lambda: sharded_step(inp["moe_arch"], inp["mb2"]))
if rank == 0:
    with open(os.path.join(io, "out.pkl"), "wb") as f:
        pickle.dump(out, f)
dist.barrier()
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _reference_step(arch, microbatches=1, batch=None):
    """The reference's jitted step of the reduced ``arch`` from its
    initial state, with ``microbatches`` on ``batch`` rows (default
    `test_torch_train`'s): (its initial parameters as numpy, the batch's
    arrays, the new state, the metrics)."""
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    jstep_cfg = jsteps.StepConfig(remat=False, compute_dtype=jnp.float32,
                                  microbatches=microbatches)
    state = jsteps.init_train_state(jax.random.PRNGKey(0), jcfg, jstep_cfg)
    _, jbatch = _batch(cfg, **({"batch": batch} if batch else {}))
    jnew, jmet = jax.jit(jsteps.make_train_step(
        jcfg, jopt.OptimizerConfig(**OPT), jstep_cfg))(state, jbatch)
    return (jax.tree.map(np.asarray, state.params),
            {k: np.asarray(v) for k, v in jbatch.items()}, jnew, jmet)


def _launch(layout: str, io: Path, ranks: int, stacks_after: float) -> list:
    port = _free_port()
    code = textwrap.dedent(_WORKER)
    procs = []
    for rank in range(ranks):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(ranks),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONHASHSEED=HASH_SEEDS[rank % 2],
                   PYTHONPATH=str(ROOT / "src"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, layout, str(io),
             str(stacks_after)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


@pytest.fixture(scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_thread):
    """The reference's steps, the one-device driver through its restart,
    then every layout's ranks at once: {"reference": ..., "mb2": (g)'s
    reference step, "one": ..., layout: the results rank 0 handed
    back}."""
    base = tmp_path_factory.mktemp("mesh")
    reference = {arch: _reference_step(arch) for arch in ARCHS}
    mb2 = _reference_step(MOE_ARCH, MB, MB_BATCH)
    one_ckpt = base / "one_ckpt"
    argv = DRIVER + ["--ckpt-dir", str(one_ckpt)]
    rec1, rec2 = {}, {}
    losses1, _ = train_lm.run(argv + RUN1, record=rec1)
    losses2, st = train_lm.run(argv + RUN2, record=rec2)
    one = {"losses1": losses1, "losses2": losses2,
           "metrics": rec1["steps"] + rec2["steps"], "state": st,
           "ckpt": one_ckpt}
    inp = {"steps": {arch: {"params": ref[0], "batch": ref[1], "opt": OPT}
                     for arch, ref in reference.items()},
           "driver": DRIVER, "run1": RUN1, "run2": RUN2,
           "ckpt_step": CKPT_STEP, "one_ckpt": str(one_ckpt),
           "moe_arch": MOE_ARCH,
           "mb2": {"params": mb2[0], "batch": mb2[1], "opt": OPT,
                   "microbatches": MB}}
    procs, logs = {}, {}
    deadline = time.monotonic() + MESH_TIMEOUT_S
    try:
        # the two pairs together, then the four ranks of ``both``: never
        # more than four ranks at once beside the rest of the suite
        for wave in (LAYOUTS, {"both": BOTH}):
            for layout, (data, model) in wave.items():
                io = base / layout
                io.mkdir()
                with open(io / "in.pkl", "wb") as f:
                    pickle.dump(inp, f)
                procs[layout] = _launch(
                    layout, io, data * model,
                    max(1.0, deadline - time.monotonic() - 30))
            for layout in wave:
                logs[layout] = [p.communicate(timeout=max(
                    1.0, deadline - time.monotonic()))[0]
                    for p in procs[layout]]
    finally:
        for pair in procs.values():
            for p in pair:
                p.kill()
    out = {"reference": reference, "mb2": mb2, "one": one}
    for layout, pair in procs.items():
        assert [p.returncode for p in pair] == [0] * len(pair), \
            (layout, [log[-3000:] for log in logs[layout]])
        with open(base / layout / "out.pkl", "rb") as f:
            out[layout] = pickle.load(f)
        out[layout]["ckpt"] = base / layout / "mesh_ckpt"
    return out


def _result(runs, layout, name):
    res = runs[layout]
    assert name not in res["errors"], res["errors"][name]
    assert res["mesh"] == dict(zip(("data", "model"),
                                   {**LAYOUTS, "both": BOTH}[layout]))
    return res[name]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_jax(runs, layout, arch):
    """(a) One step on the mesh: loss, aux loss, lr and grad norm (plain
    tensors on every rank), the updated parameters and both moments."""
    _check_step(_result(runs, layout, "step/" + arch), arch,
                runs["reference"][arch])


def _check_step(got, arch, reference):
    """A sharded step's metrics (plain on every rank) and new state
    against the reference's (`test_torch_train`'s tolerances)."""
    _, _, jnew, jmet = reference
    assert got["sharded"] and got["metrics_plain"]
    for key in ("loss", "aux_loss", "lr", "grad_norm"):
        close(got["metrics"][key], float(jmet[key]))
    pnew = types.SimpleNamespace(
        params=got["params"],
        opt=types.SimpleNamespace(m=got["m"], v=got["v"],
                                  step=torch.tensor(got["step"])))
    _check_state(get_config(arch).reduced(), pnew, jnew, float(jmet["lr"]))


@pytest.mark.parametrize("layout", [*LAYOUTS, "both"])
def test_microbatch_step_matches_jax(runs, layout):
    """(g) Two microbatches of qwen2-moe-a2.7b on 8 rows: each rank's
    local chunks are the reference's global microbatches (their MoE
    capacity and positions those of the microbatch), so the step holds
    the reference's step with the same microbatches."""
    _check_step(_result(runs, layout, "step_mb2/" + MOE_ARCH), MOE_ARCH,
                runs["mb2"])


def test_moe_step_on_both_axes_matches_jax(runs):
    """(h) qwen2-moe-a2.7b's step on (data 2, model 2): each rank routes
    and dispatches its own tokens, the experts' slots summed over
    ``data``."""
    _check_step(_result(runs, "both", "step/" + MOE_ARCH), MOE_ARCH,
                runs["reference"][MOE_ARCH])


def test_moe_positions_on_both_axes_bit_equal(runs):
    """(h) The dispatch on (data 2, model 2) at a capacity that drops
    slots: each token's experts, and each slot's position (the capacity
    where it is dropped), bit-equal to one device's routing of the same
    tokens; the gates and the aux loss within float32 sums."""
    got = _result(runs, "both", "routing")
    from torch.distributed.tensor import Replicate, Shard
    assert got["tokens"] == [str(Shard(0)), str(Replicate())]
    probs, idx, gate, pos, keep = got["want"]
    assert keep.any() and not keep.all()
    assert torch.equal(got["idx"], idx)
    assert torch.equal(got["slot"], torch.where(keep, pos, got["capacity"]))
    close(got["gate"], gate)
    e = probs.shape[1]
    ce = torch.nn.functional.one_hot(idx[:, 0], e).float().mean(dim=0)
    close(got["aux"], float(e * torch.sum(probs.mean(dim=0) * ce)))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_shard_points_take_the_plan_specs(runs, layout):
    """(d) Every shard point the families' forwards pass, on the
    placements of ``plan.act_spec`` of its name; together they reach all
    eight of the reference's points."""
    seen = set()
    for arch in ARCHS:
        for name, (got, want) in _result(runs, layout,
                                         "step/" + arch)["seen"].items():
            assert got == want, (arch, name, got, want)
            seen.add(name)
    assert seen == SHARD_POINTS


@pytest.mark.parametrize("layout", LAYOUTS)
def test_embedding_gather_placements(runs, layout):
    """(e) The table's data shards are gathered before the lookup; the
    rows come out on ``act_spec("hidden")``, equal to ``table[ids]``."""
    got = _result(runs, layout, "embedding")
    assert got["rows"] == got["hidden"] and got["values_equal"]
    from torch.distributed.tensor import Replicate, Shard
    assert got["table"] == [str(Shard(1)), str(Shard(0))]
    assert got["hidden"] == [str(Shard(0)), str(Replicate())]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_decode_attention_on_key_shards(runs, layout):
    """(f) The keys stay on their sequence shards and the output lies on
    q's layout with the model axis replicated; the values are the plain
    attention's."""
    got = _result(runs, layout, "decode")
    from torch.distributed.tensor import Replicate, Shard
    assert got["keys"] == [str(Shard(0)), str(Shard(1))]
    assert got["out"] == [str(Shard(0)), str(Replicate())]
    close(got["got"], got["want"])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_compression_on_sharded_grads_bit_equal(runs, layout):
    """(b) One scale per leaf, the global amax over every shard: the
    scales, the decompressed gradients and the residuals equal the
    one-device ones bit for bit."""
    got = _result(runs, layout, "compression")
    assert got["sharded"]
    assert got["scales_equal"] and all(got["scales_equal"].values())
    assert got["deq_equal"] and got["res_equal"]


def _flat_state(cfg, params, m, v) -> dict:
    """A state's parameters and moments (each a mapping by the port's
    names) as the reference's flattened numpy leaves."""
    from repro_torch.models.convert import params_to_numpy
    return {key: flatten(params_to_numpy(cfg, dict(tree)))
            for key, tree in (("params", params), ("m", m), ("v", v))}


def _flat_tree(tree) -> dict:
    """The parameters and moments of a reference ``TrainState`` (as its
    ``load_checkpoint`` returns one) as flattened numpy leaves."""
    return {key: flatten(jax.tree.map(np.asarray, sub))
            for key, sub in (("params", tree.params), ("m", tree.opt.m),
                             ("v", tree.opt.v))}


def _hold_state(got: dict, want: dict, lr: float, steps: int) -> None:
    """A state after ``steps`` updates against another, both as
    `_flat_state` gives them: each update's allowance of
    `test_torch_train._check_state`, ``steps`` times."""
    b1 = 0.9
    for key in ("m", "v"):
        assert got[key].keys() == want[key].keys()
        for name, r in want[key].items():
            top = np.abs(r).max()
            assert (np.abs(got[key][name] - r) <=
                    steps * MOMENT_REL * top).all(), (key, name)
    assert got["params"].keys() == want["params"].keys()
    for name, r in want["params"].items():
        grad = want["m"][name] / (1 - b1)
        tight = steps * (lr * 1e-3 + 2 * np.spacing(np.abs(r)))
        allowed = np.where(np.abs(grad) > 1e-6, tight, steps * 2 * lr)
        assert (np.abs(got["params"][name] - r) <= allowed).all(), name


@pytest.mark.parametrize("layout", LAYOUTS)
def test_train_lm_on_a_mesh_through_restart(runs, layout):
    """(c) ``train_lm`` on the mesh through a save at step 3 and a resume
    to step 6 against the one-device driver with the same flags: the
    losses and metrics of every step, the final parameters and moments;
    the mesh's checkpoint in the reference's layout (its
    ``load_checkpoint`` reads it) and equal to the one-device run's
    within the same allowance; the one-device checkpoint restored onto
    the mesh bit for bit; the sharded initial state the one-device one."""
    got = _result(runs, layout, "driver")
    one = runs["one"]
    assert got["mesh"] == dict(zip(("data", "model"), LAYOUTS[layout]))
    assert got["resumed_from"] == 3
    assert got["init_equal"] and got["restored_equal"]
    close(got["losses1"], one["losses1"])
    close(got["losses2"], one["losses2"])
    for key in ("loss", "lr", "grad_norm"):
        close([m[key] for m in got["metrics"]],
              [m[key] for m in one["metrics"]])
    cfg = get_config("minicpm-2b").reduced()
    final = got["final"]
    _hold_state(_flat_state(cfg, final["params"], final["m"], final["v"]),
                _flat_state(cfg, one["state"].params.named_parameters(),
                            one["state"].opt.m, one["state"].opt.v),
                1e-3, DRIVER_STEPS)
    # the checkpoints of CKPT_STEP, read by the reference: the mesh's
    # holds the mesh run's own state at that step bit for bit, leaf for
    # leaf in the one-device run's names, shapes and dtypes, and within
    # the state's allowance of the one-device run's checkpoint
    state = jsteps.init_train_state(
        jax.random.PRNGKey(0), jax_config("minicpm-2b").reduced(),
        jsteps.StepConfig(compute_dtype=jnp.float32))
    mesh_tree, step, _ = jckpt.load_checkpoint(str(runs[layout]["ckpt"]),
                                               state, CKPT_STEP)
    one_tree, _, _ = jckpt.load_checkpoint(str(one["ckpt"]), state,
                                           CKPT_STEP)
    assert step == CKPT_STEP
    name = f"step_{CKPT_STEP:08d}"
    mesh_man = json.loads((runs[layout]["ckpt"] / name /
                           "manifest.json").read_text())
    one_man = json.loads((one["ckpt"] / name / "manifest.json").read_text())
    assert mesh_man["leaves"] == one_man["leaves"]
    written, saved = _flat_tree(mesh_tree), got["saved"]
    for key, leaves in _flat_state(cfg, saved["params"], saved["m"],
                                   saved["v"]).items():
        assert written[key].keys() == leaves.keys()
        for leaf, want in leaves.items():
            assert written[key][leaf].dtype == want.dtype, (key, leaf)
            assert np.array_equal(written[key][leaf], want), (key, leaf)
    _hold_state(written, _flat_tree(one_tree), 1e-3, CKPT_STEP + 1)
