"""The port's training driver and its peripherals against the JAX package
on the CPU: the data pipeline (`repro_torch.data`), the fault-tolerance
policies (`repro_torch.runtime.fault_tolerance`), the checkpoint layer
(`repro_torch.checkpoint`: the reference's layout on disk, read and
written both ways) and `repro_torch.train_lm` through a restart.

The reference's own driver (``repro.launch.train``) stops in its first
step on a one-device host mesh (ROADMAP Queue C, reference fault 7), so
`train_lm` is held against a *twin*: the loop of ``launch/train.py``
over the reference's own components (``SyntheticLMData``,
``init_train_state``, ``make_train_step`` with no ``shard_fn``, jitted,
and ``CheckpointManager``), without the mesh. Both start from the
reference's initial state: it is written as a checkpoint of step 0, which
both restore (a step-0 checkpoint resumes nothing and is not reported).

Tolerances: batches, policies and checkpoints are compared exactly
(bit for bit); the losses of the same float32 steps in XLA's order and
PyTorch's within ``LOSS_RTOL = 1e-5`` relative."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import checkpoint as jckpt
from repro.checkpoint import checkpoint as jckpt_mod
from repro.configs import get_config as jax_config
from repro.data import pipeline as jdata
from repro.runtime import fault_tolerance as jft
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch import train_lm
from repro_torch.checkpoint import CheckpointManager, load_checkpoint, \
    save_checkpoint
from repro_torch.checkpoint.checkpoint import checkpoint_bytes, latest_step
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.models.convert import params_to_numpy
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.train import steps

LOSS_RTOL = 1e-5
#: One config per parameter layout: the dense stack, the hybrid's tail
#: and shared block, the encoder-decoder's encoder stack, MoE expert banks.
LAYOUT_ARCHS = ("minicpm-2b", "zamba2-1.2b", "seamless-m4t-large-v2",
                "qwen2-moe-a2.7b")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread in this module, restored after: the suite runs
    several workers on the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("frontend_seq", [0, 6])
def test_batches_match_reference(seed, frontend_seq):
    """Every host's batch of two steps equal to the reference's, with a
    frontend stream too; the global shapes alike."""
    kw = dict(vocab_size=977, seq_len=16, global_batch=8, seed=seed,
              frontend_seq=frontend_seq, d_model=12 if frontend_seq else 0)
    for host in range(4):
        ours = SyntheticLMData(DataConfig(**kw), host_id=host, n_hosts=4)
        ref = jdata.SyntheticLMData(jdata.DataConfig(**kw), host_id=host,
                                    n_hosts=4)
        for step in (0, 17):
            a, b = ours.batch(step), ref.batch(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        assert ours.global_batch_shape() == ref.global_batch_shape()


def test_batches_are_step_indexed_and_shifted():
    data = SyntheticLMData(DataConfig(vocab_size=977, seq_len=32,
                                      global_batch=8, seed=3))
    b = data.batch(17)
    np.testing.assert_array_equal(b["tokens"], data.batch(17)["tokens"])
    assert not np.array_equal(data.batch(18)["tokens"], b["tokens"])
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# ---------------------------------------------------------------------------
# fault-tolerance policies: the reference's scenarios (tests/test_runtime.py)
# ---------------------------------------------------------------------------

def _heartbeat_trace(mod):
    hb = mod.HeartbeatMonitor(n_hosts=3, deadline_s=10)
    for h in range(3):
        hb.beat(h, now=100.0)
    out = [hb.dead_hosts(now=105.0), hb.dead_hosts(now=111.0)]
    hb.beat(1, now=112.0)
    out += [hb.dead_hosts(now=115.0), hb.all_alive(now=115.0),
            hb.all_alive(now=105.0)]
    return out


def _straggler_trace(mod):
    sp = mod.StragglerPolicy(threshold=1.5, patience=2)
    out = [sp.evictions()]
    for step in range(4):
        for h in range(4):
            sp.record(h, 1.0 if h != 3 else 3.0)
        out.append(sp.evictions())
    for h in range(4):                      # host 3 recovers
        sp.record(h, 1.0)
    out.append(sp.evictions())
    return out


@pytest.mark.parametrize("trace", [_heartbeat_trace, _straggler_trace])
def test_policies_decide_as_reference(trace):
    assert trace(ft) == trace(jft)


@pytest.mark.parametrize("alive", [512, 240, 64, 17, 8, 1])
@pytest.mark.parametrize("model_axis", [16, 4])
def test_elastic_plan_matches_reference(alive, model_axis):
    ours = ft.plan_elastic_mesh(alive, model_axis=model_axis)
    ref = jft.plan_elastic_mesh(alive, model_axis=model_axis)
    assert (ours.data, ours.model, ours.pod, ours.n_devices) == \
        (ref.data, ref.model, ref.pod, ref.n_devices)


def test_retry_backoff_matches_reference():
    for kw in ({}, dict(max_retries=4, base_s=1.0, cap_s=5.0)):
        assert list(ft.RetryPolicy(**kw).delays()) == \
            list(jft.RetryPolicy(**kw).delays())


# ---------------------------------------------------------------------------
# checkpoint: the reference's tests (tests/test_checkpoint_data.py)
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((2,), dtype=torch.int32)}}


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 5, t, {"cursor": 5})
    like = _zeros_like(t)
    restored, step, extra = load_checkpoint(str(tmp_path), like)
    assert step == 5 and extra == {"cursor": 5}
    assert restored is like                 # restored in place
    assert torch.equal(restored["a"], t["a"])
    assert torch.equal(restored["b"]["c"], t["b"]["c"])


def test_retention_and_latest(tmp_path):
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, _tree(), keep=2)
    assert sorted(os.listdir(str(tmp_path))) == ["step_00000004",
                                                 "step_00000005"]
    assert latest_step(str(tmp_path)) == 5
    assert latest_step(str(tmp_path / "absent")) is None


def test_atomicity_no_tmp_left(tmp_path):
    """A save publishes by renaming; a crash leaves a ``tmp.<step>`` that
    latest_step ignores and the next save of that step replaces."""
    save_checkpoint(str(tmp_path), 1, _tree())
    assert not [d for d in os.listdir(str(tmp_path))
                if d.startswith("tmp.")]
    (tmp_path / "tmp.2").mkdir()
    (tmp_path / "tmp.2" / "leaf_00000.npy").write_bytes(b"torn")
    assert latest_step(str(tmp_path)) == 1
    save_checkpoint(str(tmp_path), 2, _tree())
    assert sorted(os.listdir(str(tmp_path))) == ["step_00000001",
                                                 "step_00000002"]


def test_manager_restore_or_init(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=2)
    t = _tree()
    init = _zeros_like(t)
    assert mgr.restore_or_init(init) == (init, 0, {})
    assert mgr.maybe_save(1, t) is None
    assert mgr.maybe_save(0, t) is None
    assert mgr.maybe_save(2, t) is not None
    restored, step, _ = mgr.restore_or_init(_zeros_like(t))
    assert step == 2 and torch.equal(restored["a"], t["a"])


def test_load_refuses_a_mismatched_tree(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    with pytest.raises(ValueError, match="leaf count"):
        load_checkpoint(str(tmp_path), {"a": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match=r"\(3, 4\) vs \(4, 3\)"):
        load_checkpoint(str(tmp_path), {"a": torch.zeros(4, 3),
                                        "b": {"c": torch.zeros(2)}})
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "absent"), _tree())


def test_reference_reads_a_port_tree_and_back(tmp_path):
    """The generic layout: a nested mapping of tensors saved here loads
    in the reference into its like-tree, and the reference's save of it
    loads here, equal."""
    t = _tree()
    save_checkpoint(str(tmp_path / "port"), 3, t, {"cursor": 3})
    like = jax.tree.map(jnp.zeros_like,
                        {"a": jnp.zeros((3, 4)),
                         "b": {"c": jnp.zeros((2,), jnp.int32)}})
    got, step, extra = jckpt.load_checkpoint(str(tmp_path / "port"), like)
    assert step == 3 and extra == {"cursor": 3}
    np.testing.assert_array_equal(np.asarray(got["a"]), t["a"].numpy())
    np.testing.assert_array_equal(np.asarray(got["b"]["c"]),
                                  t["b"]["c"].numpy())
    jckpt.save_checkpoint(str(tmp_path / "ref"), 4, got)
    back, step, _ = load_checkpoint(str(tmp_path / "ref"), _zeros_like(t))
    assert step == 4 and torch.equal(back["a"], t["a"])


# ---------------------------------------------------------------------------
# checkpoint: a TrainState in the reference's layout, both ways
# ---------------------------------------------------------------------------

def _ref_state(arch, seed=11):
    """The reference's TrainState with residuals, every moment and
    residual leaf filled with its own numbers, the step and key moved on,
    so that any misordered leaf shows."""
    cfg = jax_config(arch).reduced()
    st = jsteps.init_train_state(
        jax.random.PRNGKey(0), cfg,
        jsteps.StepConfig(compute_dtype=jnp.float32, compress_pod_grads=True))
    rng = np.random.default_rng(seed)
    fill = lambda tree: jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32)), tree)
    return st._replace(
        opt=jopt.AdamWState(step=jnp.asarray(7, jnp.int32),
                            m=fill(st.params), v=fill(st.params)),
        residuals=fill(st.params),
        rng=jax.random.fold_in(st.rng, 3))


def _port_state(arch, seed=5):
    cfg = get_config(arch).reduced()
    st = steps.init_train_state(
        seed, cfg, steps.StepConfig(compute_dtype=torch.float32,
                                    compress_pod_grads=True))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for tree in (st.opt.m, st.opt.v, st.residuals):
            for t in tree.values():
                t.copy_(torch.randn(t.shape, generator=g))
        st.opt.step.fill_(3)
    return cfg, st._replace(rng=(5 << 32) + 9)


def _as_reference(cfg, st):
    """The port's TrainState as the reference's tree of numpy arrays."""
    return jsteps.TrainState(
        params=params_to_numpy(cfg, st.params),
        opt=jopt.AdamWState(step=st.opt.step.numpy(),
                            m=params_to_numpy(cfg, st.opt.m),
                            v=params_to_numpy(cfg, st.opt.v)),
        residuals=params_to_numpy(cfg, st.residuals),
        rng=np.array([st.rng >> 32, st.rng & 0xFFFFFFFF], np.uint32))


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("arch", LAYOUT_ARCHS)
def test_reference_checkpoint_loads_in_port(tmp_path, arch):
    """The reference's save of its TrainState loads into the port's,
    bit for bit (rng as the key's seed), and the port's save of it again
    writes the reference's files, leaf for leaf."""
    ref = _ref_state(arch)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 7, ref, {"loss": 1.5})
    cfg, like = _port_state(arch, seed=1)
    st, step, extra = load_checkpoint(str(tmp_path / "ref"), like)
    assert step == 7 and extra == {"loss": 1.5}
    assert st.params is like.params and st.opt.m is like.opt.m
    _leaves_equal(_as_reference(cfg, st), jax.tree.map(np.asarray, ref))
    save_checkpoint(str(tmp_path / "port"), 7, st)
    n = len(jax.tree.leaves(ref))
    assert len([f for f in os.listdir(tmp_path / "port" / "step_00000007")
                if f.endswith(".npy")]) == n
    for i in range(n):
        name = f"leaf_{i:05d}.npy"
        a = np.load(tmp_path / "ref" / "step_00000007" / name)
        b = np.load(tmp_path / "port" / "step_00000007" / name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", LAYOUT_ARCHS)
def test_port_checkpoint_loads_in_reference(tmp_path, arch):
    """The port's save of its TrainState loads in the reference's
    ``load_checkpoint`` into the reference's TrainState, bit for bit."""
    cfg, st = _port_state(arch)
    save_checkpoint(str(tmp_path), 2, st)
    like = jax.tree.map(jnp.zeros_like, _ref_state(arch))
    got, step, _ = jckpt_mod.load_checkpoint(str(tmp_path), like)
    assert step == 2
    _leaves_equal(got, _as_reference(cfg, st))
    assert np.asarray(got.rng).tolist() == [5, 9]
    assert checkpoint_bytes(str(tmp_path), 2) > sum(
        p.numel() * 4 * 4 for p in st.params.parameters())


def test_seed_written_as_the_reference_key(tmp_path):
    """The port's rng is a seed: written as ``PRNGKey(seed)``, read back
    as the seed."""
    cfg = get_config("minicpm-2b").reduced()
    st = steps.init_train_state(
        12345, cfg, steps.StepConfig(compute_dtype=torch.float32))
    save_checkpoint(str(tmp_path), 1, st)
    n = len(os.listdir(tmp_path / "step_00000001")) - 1
    key = np.load(tmp_path / "step_00000001" / f"leaf_{n - 1:05d}.npy")
    np.testing.assert_array_equal(key, np.asarray(jax.random.PRNGKey(12345)))
    fresh = steps.init_train_state(
        0, cfg, steps.StepConfig(compute_dtype=torch.float32))
    assert load_checkpoint(str(tmp_path), fresh)[0].rng == 12345


# ---------------------------------------------------------------------------
# train_lm through a restart, against the reference twin
# ---------------------------------------------------------------------------

ARGS = dict(batch=4, seq=16, lr=3e-3)


def _twin(ckpt_dir, n_steps, every):
    """``launch/train.py:48-115`` without the mesh: reduced minicpm-2b,
    float32, remat, the driver's schedule rule; returns the losses."""
    cfg = jax_config("minicpm-2b").reduced()
    opt = jopt.OptimizerConfig(lr=ARGS["lr"],
                               warmup_steps=max(n_steps // 20, 5),
                               total_steps=n_steps, schedule="wsd")
    sc = jsteps.StepConfig(microbatches=1, remat=True,
                           compute_dtype=jnp.float32)
    data = jdata.SyntheticLMData(jdata.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=ARGS["seq"],
        global_batch=ARGS["batch"], frontend_seq=0, d_model=cfg.d_model))
    state = jsteps.init_train_state(jax.random.PRNGKey(0), cfg, sc)
    step = jax.jit(jsteps.make_train_step(cfg, opt, sc))
    ckpt = jckpt.CheckpointManager(ckpt_dir, every=every)
    state, start, _ = ckpt.restore_or_init(state)
    losses = []
    for s in range(start, n_steps):
        batch = {k: jnp.asarray(v) for k, v in data.batch(s).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        ckpt.maybe_save(s, state, {"loss": losses[-1]})
    return losses


def _port(ckpt_dir, n_steps, every):
    return train_lm.run([
        "--arch", "minicpm-2b", "--reduced", "--device", "cpu",
        "--steps", str(n_steps), "--batch", str(ARGS["batch"]),
        "--seq", str(ARGS["seq"]), "--lr", str(ARGS["lr"]),
        "--ckpt-dir", ckpt_dir, "--ckpt-every", str(every)])


def test_train_lm_through_restart_matches_twin(tmp_path, capsys):
    """Both start from the reference's initial state (a step-0
    checkpoint), train 4 steps saving every 2, then restart with 6 steps:
    the resumed run replays batch 2 on the state after update 2, as the
    reference's (Queue C, fault 8). Every loss, the replayed one
    included, within LOSS_RTOL."""
    cfg = jax_config("minicpm-2b").reduced()
    init = jsteps.init_train_state(
        jax.random.PRNGKey(0), cfg,
        jsteps.StepConfig(compute_dtype=jnp.float32))
    dirs = {k: str(tmp_path / k) for k in ("port", "twin")}
    for d in dirs.values():
        jckpt.save_checkpoint(d, 0, init)
    twin1 = _twin(dirs["twin"], 4, 2)
    port1, _ = _port(dirs["port"], 4, 2)
    assert "[restore]" not in capsys.readouterr().out
    twin2 = _twin(dirs["twin"], 6, 2)
    port2, state = _port(dirs["port"], 6, 2)
    out = capsys.readouterr().out
    assert "[restore] resumed from step 2" in out
    assert "[done] first-10 mean loss" in out
    assert len(port1) == len(twin1) == 4 and len(port2) == len(twin2) == 4
    np.testing.assert_allclose(port1, twin1, rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(port2, twin2, rtol=LOSS_RTOL, atol=0)
    assert port2[0] != port1[2]             # batch 2 again, one update on
    assert int(state.opt.step) == 7 and state.rng == 7
    assert latest_step(dirs["port"]) == latest_step(dirs["twin"]) == 4


def test_on_step_sees_the_replayed_update(tmp_path):
    """Path K's holds at reduced widths: ``on_step`` gets the state after
    every step. Run 1 saves the state after update 3; the train step's
    loss of batch 3 on it (L*) is run 2's first loss, and on run 2's
    state after that step (the replay of batch 3, update 5 of the
    optimizer) the batch's loss lies below L*."""
    argv = ["--arch", "minicpm-2b", "--reduced", "--device", "cpu",
            "--batch", str(ARGS["batch"]), "--seq", str(ARGS["seq"]),
            "--lr", str(ARGS["lr"]), "--ckpt-dir", str(tmp_path),
            "--log-every", "100"]
    seen = []
    _, state = train_lm.run(
        argv + ["--steps", "4", "--ckpt-every", "3"],
        on_step=lambda s, loss, dt, st: seen.append((s, int(st.opt.step))))
    assert seen == [(s, s + 1) for s in range(4)]
    cfg, _, step_cfg, data = train_lm.configure(
        train_lm.build_parser().parse_args(argv + ["--steps", "6"]))
    batch = train_lm.to_device(data.batch(3), "cpu")

    def batch_loss(st):
        return float(steps.loss_and_grads(st.params, cfg, step_cfg,
                                          batch)[1])

    l_star = batch_loss(state)
    after, seen = [], []

    def on_step(s, loss, dt, st):
        seen.append((s, int(st.opt.step)))
        if s == 3:
            after.append(batch_loss(st))

    losses2, _ = train_lm.run(argv + ["--steps", "6", "--ckpt-every", "100"],
                              on_step=on_step)
    assert seen == [(s, s + 2) for s in range(3, 6)]
    assert abs(losses2[0] - l_star) <= 1e-6 * abs(l_star)
    assert after[0] < l_star, (l_star, after)


def test_loss_decreases_at_integration_size():
    """The reference's convergence check (`test_train_integration.py::
    test_loss_decreases`: reduced minicpm-2b, 8 x 32 tokens, lr 5e-3, 60
    steps) through the driver: the last-10 mean loss below 0.75x the
    first-5 mean."""
    losses = train_lm.main(["--reduced", "--device", "cpu", "--steps", "60",
                            "--batch", "8", "--seq", "32", "--lr", "5e-3",
                            "--log-every", "100"])
    assert len(losses) == 60
    assert np.mean(losses[-10:]) < 0.75 * np.mean(losses[:5]), \
        (losses[:5], losses[-10:])


def test_restart_demo_converges(capsys):
    """``--restart-demo`` at the integration test's widths and lr, 150
    steps (at 60 the reduced model sits at 0.79x of its first-10 mean,
    short of the demo's 0.7x): 90 steps saving every 50, a restart from
    step 50, 100 more; the loss falls below 0.7x through the restart."""
    losses1, losses2 = train_lm.main([
        "--restart-demo", "--reduced", "--device", "cpu", "--steps", "150",
        "--batch", "8", "--seq", "32", "--lr", "5e-3", "--ckpt-every", "50",
        "--log-every", "1000"])
    out = capsys.readouterr().out
    assert "[restore] resumed from step 50" in out
    assert "OK: loss decreased through a checkpoint restart." in out
    assert len(losses1) == 90 and len(losses2) == 100
    assert np.mean(losses2[-10:]) < 0.7 * np.mean(losses1[:10])


def test_dataflow_counts(monkeypatch, tmp_path, capsys):
    """``--dataflow``: the lowered LM-head tokens are seq x batch, and the
    optimizer bill's parameters are the live model's ``.w`` leaves plus
    the table, which are also the reference's (``examples/train_lm.py``
    counts them on its own tree). The optimizer runs its default MIP mode,
    as the reference's check does; neither count depends on what the
    capped solves find."""
    monkeypatch.setenv("MIREDO_CACHE", str(tmp_path))
    rep = train_lm.main(["--dataflow", "--reduced", "--device", "cpu",
                         "--steps", "10", "--batch", "4", "--seq", "16",
                         "--log-every", "100"])
    assert rep["tokens"] == 16 * 4
    assert rep["n_params"] == rep["live_params"]
    params = jsteps.init_train_state(
        jax.random.PRNGKey(0), jax_config("minicpm-2b").reduced(),
        jsteps.StepConfig(compute_dtype=jnp.float32)).params
    live = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if name.endswith("/w") or ("embed" in name and "table" in name):
            live += leaf.size
    assert rep["live_params"] == live
    assert "OK: training dataflow report matches the live model." in \
        capsys.readouterr().out


def test_driver_refuses_what_it_does_not_run():
    with pytest.raises(NotImplementedError, match="Queue A.4"):
        train_lm.run(["--production-mesh", "--reduced", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_lm.run(["--reduced", "--steps", "1"])


def test_differing_leaves_names_what_changed(tmp_path):
    """`differing_leaves` (path K's Hold 1): nothing differs right after a
    save; one changed layer of a stack names its stacked leaf, a changed
    seed names ``rng``."""
    from repro_torch.checkpoint.checkpoint import differing_leaves
    _, st = _port_state("minicpm-2b")
    save_checkpoint(str(tmp_path), 1, st)
    assert differing_leaves(str(tmp_path), st, 1) == []
    with torch.no_grad():
        st.params.blocks[1].attn.wq.w[0, 0] += 1.0
    assert differing_leaves(str(tmp_path), st._replace(rng=0), 1) == [
        "params.blocks.attn.wq.w", "rng"]
