"""The port's train step (`repro_torch.train.optimizer`,
`repro_torch.runtime.compression`, the train mode of
`repro_torch.models.transformer.forward`, `repro_torch.train.steps`)
against the JAX package on the CPU. Inputs are made with numpy from a
seed and handed to both; the weights are the reference's own
``init_train_state`` carried across by `convert.params_from_numpy`, and
the updated state comes back by `convert.params_to_numpy` to be compared
leaf by leaf. Each reference step is jitted once, in a module-scoped
fixture, with ``remat=False`` (``jax.checkpoint`` changes no value); the
port runs its default ``remat=True``, and `test_remat_gives_the_same_grads`
holds that remat changes none of its gradients. Batches are 2 x 16
tokens; the ssm and hybrid families take 2 x 4, because with one chunk
over the sequence (the SSD's chunk is min(256, L)) the reference's own
SSD gradient is NaN from 6 tokens on (`test_reference_ssd_grads_
overflow`, ROADMAP Queue C). `test_ssm_step_across_chunks_matches_jax`
holds them at 16 tokens in chunks of 4 on both sides, through the
inter-chunk recurrence.

Tolerances, float32 throughout:
- ``F32 = dict(rtol=1e-4, atol=1e-5)`` for losses, norms and the like:
  the same float32 arithmetic in another order (XLA's CPU kernels
  against PyTorch's) moves a result by a few ulp.
- The moments m and v after one step are (1 - beta) times the clipped
  gradient (squared): held within ``MOMENT_REL = 1e-4`` of the largest
  entry of their leaf, which holds the gradients.
- The parameters: a first Adam step moves each weight by about
  lr * g / (|g| + eps), i.e. lr * sign(g). Where the reference's clipped
  gradient is above ``G_FLOOR = 1e-6`` (100 * eps) that ratio is stable,
  and the weights agree within ``lr * 1e-3`` plus 2 ulp of the weight;
  where it is below, a gradient a few ulp off may even change sign, and
  the weight may move by up to 2 * lr the other way.
- The schedule within 2**-20 relative (one ulp or two of ``cos``); int8
  codes, scales, decompressed gradients and residuals bit-equal."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jax_config
from repro.models import transformer as jtf
from repro.runtime import compression as jcomp
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.models import moe, transformer
from repro_torch.models.convert import flatten, params_from_numpy, \
    params_to_numpy
from repro_torch.runtime import compression
from repro_torch.train import optimizer, steps

F32 = dict(rtol=1e-4, atol=1e-5)
MOMENT_REL = 1e-4
G_FLOOR = 1e-6
#: One reduced config per family (both MoE configs: Qwen's shared
#: experts, Arctic's dense residual).
ARCHS = ("glm4-9b", "mamba2-1.3b", "qwen2-moe-a2.7b", "arctic-480b",
         "zamba2-1.2b", "pixtral-12b", "seamless-m4t-large-v2")
#: lr 1e-3 under a 4-step warmup: 2.5e-4 at the first step.
OPT = dict(lr=1e-3, warmup_steps=4, total_steps=20, schedule="wsd")
BATCH, SEQ = 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's torch ops on one thread, restored after: the suite
    runs several workers on the machine's cores, and the reduced steps
    gain nothing from more threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), **(tol or F32))


def seq_of(cfg) -> int:
    """SEQ, or 4 for the families with Mamba2 blocks: from 6 tokens on
    the reference's own SSD gradient is NaN (`test_reference_ssd_grads_
    overflow`), so it can be held only below that."""
    return 4 if cfg.family in ("ssm", "hybrid") else SEQ


def _batch(cfg, seed=0, batch=BATCH, seq=None):
    """Tokens, their next-token labels (the last position -1, masked)
    and, for the vlm and encdec families, frontend embeddings: (the
    port's batch, the reference's)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size,
                        (batch, seq or seq_of(cfg))).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((batch, 1), -1, np.int32)],
                            axis=1)
    arrays = {"tokens": toks, "labels": labels}
    if cfg.family in ("vlm", "encdec"):
        arrays["frontend"] = rng.standard_normal(
            (batch, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    port = {k: T(v).long() if v.dtype == np.int32 else T(v)
            for k, v in arrays.items()}
    return port, {k: J(v) for k, v in arrays.items()}


def _run_both(arch, *, microbatches=1, compress=False, record=False,
              seq=None):
    """One train step of the reduced ``arch`` on both sides from the
    reference's initial state, on ``seq`` tokens (default `seq_of`):
    (port state, port metrics, reference state, reference metrics,
    routing records or None)."""
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    jcfg_step = jsteps.StepConfig(remat=False, compute_dtype=jnp.float32,
                                  microbatches=microbatches,
                                  compress_pod_grads=compress)
    state = jsteps.init_train_state(jax.random.PRNGKey(0), jcfg, jcfg_step)
    pbatch, jbatch = _batch(cfg, seq=seq)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, jopt.OptimizerConfig(**OPT), jcfg_step))
    jnew, jmet = jstep(state, jbatch)

    model = params_from_numpy(cfg, jax.tree.map(np.asarray, state.params))
    params = dict(model.named_parameters())
    pstate = steps.TrainState(
        model, optimizer.init_adamw(params),
        compression.init_residuals(params) if compress else None, 0)
    step = steps.make_train_step(
        cfg, optimizer.OptimizerConfig(**OPT), steps.StepConfig(
            compute_dtype=torch.float32, microbatches=microbatches,
            compress_pod_grads=compress))
    routes = None
    if record:
        routes, orig = [], moe.top_k_experts

        def rec(probs, k):
            vals, idx = orig(probs, k)
            routes.append(idx.clone())
            return vals, idx
        moe.top_k_experts = rec
    try:
        pnew, pmet = step(pstate, pbatch)
    finally:
        if record:
            moe.top_k_experts = orig
    return pnew, pmet, jnew, jmet, routes


def _reference_routes(arch):
    """The experts the reference's router picks in each MoE layer of a
    train-mode forward from the same state and batch (a debug callback
    on ``jax.lax.top_k`` inside its scan), in layer order."""
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    state = jsteps.init_train_state(
        jax.random.PRNGKey(0), jcfg,
        jsteps.StepConfig(remat=False, compute_dtype=jnp.float32))
    _, jbatch = _batch(cfg)
    seen, orig = [], jax.lax.top_k

    def top_k(x, k):
        vals, idx = orig(x, k)
        jax.debug.callback(lambda i: seen.append(np.asarray(i)), idx,
                           ordered=True)
        return vals, idx

    jax.lax.top_k = top_k
    try:
        logits = jax.jit(lambda p, t: jtf.forward(
            p, jcfg, t, mode="train", compute_dtype=jnp.float32).logits)(
            state.params, jbatch["tokens"])
        jax.block_until_ready(logits)
        jax.effects_barrier()
    finally:
        jax.lax.top_k = orig
    return seen


@pytest.fixture(scope="module", params=ARCHS)
def stepped(request):
    arch = request.param
    is_moe = get_config(arch).family == "moe"
    out = _run_both(arch, record=is_moe)
    return (arch,) + out + ((_reference_routes(arch) if is_moe else None),)


def _check_state(cfg, pnew, jnew, lr, codes=False):
    """m and v within MOMENT_REL of their leaf's largest entry, the
    parameters as the module docstring says; the tree's names and shapes
    the reference's. With ``codes`` (int8 compression on) a gradient a
    few ulp off may round to the next code: up to 1 % of a leaf's m may
    differ by one code step (its largest entry over 127), where v must
    still be m's square, (1 - b2) / (1 - b1)**2 * m**2, on each side, and
    the weight may move by up to 2 * lr the other way."""
    b1, b2 = optimizer.OptimizerConfig().betas
    got_p, ref_p = (flatten(params_to_numpy(cfg, pnew.params)),
                    flatten(jax.tree.map(np.asarray, jnew.params)))
    got_m, ref_m = (flatten(params_to_numpy(cfg, pnew.opt.m)),
                    flatten(jax.tree.map(np.asarray, jnew.opt.m)))
    got_v, ref_v = (flatten(params_to_numpy(cfg, pnew.opt.v)),
                    flatten(jax.tree.map(np.asarray, jnew.opt.v)))
    assert {k: v.shape for k, v in got_p.items()} == \
        {k: v.shape for k, v in ref_p.items()}
    assert int(pnew.opt.step) == int(jnew.opt.step) == 1
    for name in ref_p:
        dm = np.abs(got_m[name] - ref_m[name])
        top = np.abs(ref_m[name]).max()
        flipped = dm > MOMENT_REL * top
        if codes:
            assert flipped.mean() <= 0.01, (name, flipped.mean())
            assert (dm <= top / 127 * (1 + 1e-3)).all(), name
            for m, v in ((got_m[name], got_v[name]),
                         (ref_m[name], ref_v[name])):
                close(v[flipped], (1 - b2) / (1 - b1) ** 2 *
                      np.square(m[flipped]), rtol=1e-5, atol=0)
        else:
            assert not flipped.any(), name
        dv = np.abs(got_v[name] - ref_v[name])
        assert (dv[~flipped] <= MOMENT_REL * np.abs(ref_v[name]).max()).all()
        g = ref_m[name] / (1 - b1)            # the reference's clipped grad
        tight = lr * 1e-3 + 2 * np.spacing(np.abs(ref_p[name]))
        allowed = np.where((np.abs(g) > G_FLOOR) & ~flipped, tight,
                           2 * lr * (1 + 1e-3))
        over = np.abs(got_p[name] - ref_p[name]) - allowed
        assert over.max() <= 0, (name, over.max())


def test_train_step_matches_jax(stepped):
    """One step of every family: loss, aux loss, lr, grad norm, and the
    updated parameters with both moments. A MoE model's routers pick the
    same experts in every layer on both sides before anything else is
    compared."""
    arch, pnew, pmet, jnew, jmet, routes, jroutes = stepped
    cfg = get_config(arch).reduced()
    if routes is not None:
        n = len(jroutes)
        assert n == cfg.n_layers
        # under remat the port's forward routes once a layer, and the
        # backward's recomputation once more, last layer first, alike
        assert len(routes) == 2 * n
        for i in range(n):
            assert np.array_equal(routes[i].numpy(), jroutes[i]), i
            assert torch.equal(routes[2 * n - 1 - i], routes[i])
        assert float(pmet["aux_loss"]) > 0
    for key in ("loss", "aux_loss", "lr", "grad_norm"):
        close(float(pmet[key]), float(jmet[key]))
    _check_state(cfg, pnew, jnew, float(jmet["lr"]))
    assert pnew.rng == 1
    assert not any(p.requires_grad for p in pnew.params.parameters())


#: The SSD chunk of `test_ssm_step_across_chunks_matches_jax`: SEQ / CHUNK
#: chunks, each short enough that the reference's gradient stays finite.
CHUNK = 4


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_ssm_step_across_chunks_matches_jax(arch, monkeypatch):
    """One step of the ssm and hybrid families at SEQ tokens with
    ``mamba2_block`` in chunks of CHUNK on both sides: the gradient of
    the inter-chunk recurrence (each chunk's decay and summary state,
    the loop over chunks) held like `test_train_step_matches_jax`'s."""
    for mod in (jtf, transformer):
        monkeypatch.setattr(mod, "mamba2_block", functools.partial(
            mod.mamba2_block, chunk=CHUNK))
    pnew, pmet, jnew, jmet, _ = _run_both(arch, seq=SEQ)
    assert np.isfinite(float(jmet["grad_norm"]))
    for key in ("loss", "aux_loss", "lr", "grad_norm"):
        close(float(pmet[key]), float(jmet[key]))
    _check_state(get_config(arch).reduced(), pnew, jnew, float(jmet["lr"]))


@pytest.mark.parametrize("variant", ["microbatches=2", "compress"])
def test_glm4_variants_match_jax(variant):
    """glm4-9b reduced with 2 microbatches (the mean of the microbatch
    grads; the reported loss their mean and aux loss 0, as the
    reference's), and with the int8 compression on (the residuals after
    the step within one code step, the compression's scale, of the
    reference's: a gradient a few ulp off may round to the next code)."""
    compress = variant == "compress"
    pnew, pmet, jnew, jmet, _ = _run_both(
        "glm4-9b", microbatches=1 if compress else 2, compress=compress)
    cfg = get_config("glm4-9b").reduced()
    for key in ("loss", "aux_loss", "lr", "grad_norm"):
        close(float(pmet[key]), float(jmet[key]))
    _check_state(cfg, pnew, jnew, float(jmet["lr"]), codes=compress)
    if compress:
        # a residual is within half a code step (the tensor's scale) of 0
        # on each side, so two differ by at most one; where the codes
        # agree they differ as the gradients do. The scale is the
        # largest decompressed gradient over 127, read from the
        # reference's m = (1 - b1) * clip * deq
        got = flatten(params_to_numpy(cfg, pnew.residuals))
        ref = flatten(jax.tree.map(np.asarray, jnew.residuals))
        ref_m = flatten(jax.tree.map(np.asarray, jnew.opt.m))
        clip = min(1.0, 1.0 / (float(jmet["grad_norm"]) + 1e-9))
        for name in ref:
            scale = np.abs(ref_m[name]).max() / (0.1 * clip * 127)
            d = np.abs(got[name] - ref[name])
            assert (d <= scale * (1 + 1e-3)).all(), name
            assert np.mean(d > 1e-3 * scale) <= 0.01, name
    else:
        assert float(pmet["aux_loss"]) == 0.0


def test_microbatches_match_one_batch():
    """In the port, 2 microbatches give the one-batch gradients and loss
    (a dense model's loss is a mean over equal halves)."""
    cfg = get_config("glm4-9b").reduced()
    model = transformer.init_model(cfg, torch.Generator().manual_seed(1))
    batch, _ = _batch(cfg, seed=3, batch=4)
    out = {mb: steps.loss_and_grads(model, cfg, steps.StepConfig(
        compute_dtype=torch.float32, microbatches=mb), batch)
        for mb in (1, 2)}
    close(float(out[2][1]), float(out[1][1]))
    for name, g in out[1][0].items():
        close(out[2][0][name], g)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_grads(arch):
    """remat recomputes each wrapped block in the backward pass with the
    same operations on the same inputs: the gradients are bit-equal."""
    cfg = get_config(arch).reduced()
    model = transformer.init_model(cfg, torch.Generator().manual_seed(2))
    batch, _ = _batch(cfg, seed=4)
    grads = {remat: steps.loss_and_grads(model, cfg, steps.StepConfig(
        compute_dtype=torch.float32, remat=remat), batch)
        for remat in (False, True)}
    assert torch.equal(grads[True][1], grads[False][1])
    for name, g in grads[False][0].items():
        assert torch.equal(grads[True][0][name], g), name


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_schedule_lr_matches_jax(schedule):
    """Every step from 0 past the end, through the warmup, the stable
    phase and the decay."""
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=110, schedule=schedule,
              wsd_stable_frac=0.7)
    for s in range(0, 125):
        got = optimizer.schedule_lr(optimizer.OptimizerConfig(**kw),
                                    torch.tensor(s, dtype=torch.int32))
        ref = jopt.schedule_lr(jopt.OptimizerConfig(**kw),
                               jnp.asarray(s, jnp.int32))
        assert got.dtype == torch.float32
        close(float(got), float(ref), rtol=2 ** -20, atol=0)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((8, 16)) * scale).astype(np.float32),
            "b": (rng.standard_normal(16) * scale).astype(np.float32),
            "e": (rng.standard_normal((3, 4, 5)) * scale).astype(
                np.float32)}


@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_adamw_update_matches_jax(clip):
    """One update from step 5 with random moments, on 1-D, 2-D and 3-D
    leaves (decay on the 2-D and 3-D ones only): gradients whose global
    norm is ~18 (clipped to 1) or ~0.02 (not clipped)."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=50, grad_clip=1.0)
    params, grads = _tree(0), _tree(1, 3.0 if clip == "active" else 3e-3)
    m = _tree(2, 0.1)
    v = {k: np.abs(a) for k, a in _tree(3, 0.01).items()}
    jstate = jopt.AdamWState(step=jnp.asarray(5, jnp.int32),
                             m=jax.tree.map(J, m), v=jax.tree.map(J, v))
    jp, js, jmet = jopt.adamw_update(jopt.OptimizerConfig(**cfg),
                                     jax.tree.map(J, params),
                                     jax.tree.map(J, grads), jstate)
    pp = {k: T(a) for k, a in params.items()}
    pstate = optimizer.AdamWState(step=torch.tensor(5, dtype=torch.int32),
                                  m={k: T(a) for k, a in m.items()},
                                  v={k: T(a) for k, a in v.items()})
    pp, ps, pmet = optimizer.adamw_update(
        optimizer.OptimizerConfig(**cfg), pp,
        {k: T(a) for k, a in grads.items()}, pstate)
    gnorm = float(jmet["grad_norm"])
    assert (gnorm > 1.0) == (clip == "active")
    close(float(pmet["grad_norm"]), gnorm)
    close(float(pmet["lr"]), float(jmet["lr"]), rtol=2 ** -20, atol=0)
    assert int(ps.step) == int(js.step) == 6
    for k in params:
        close(pp[k], jp[k], rtol=1e-5, atol=1e-7)
        close(ps.m[k], js.m[k], rtol=1e-5, atol=1e-9)
        close(ps.v[k], js.v[k], rtol=1e-5, atol=1e-12)


def test_init_adamw_dtypes_match_jax():
    """Moments in OPT_STATE_DTYPE beside float32 parameters, in the
    parameter's own dtype otherwise; all zero, the step 0."""
    ps = {"f": torch.ones(3, 2), "h": torch.ones(4, dtype=torch.bfloat16)}
    js = jopt.init_adamw({"f": jnp.ones((3, 2)),
                          "h": jnp.ones(4, jnp.bfloat16)})
    st = optimizer.init_adamw(ps)
    assert int(st.step) == int(js.step) == 0
    for k in ps:
        for got, ref in ((st.m[k], js.m[k]), (st.v[k], js.v[k])):
            assert str(got.dtype).split(".")[1] == ref.dtype.name
            assert tuple(got.shape) == ref.shape and not got.any()


def test_quantize_int8_bit_equal():
    """Codes and scale bit-equal to the reference's: exact halves round
    to even (scale 1), a random tensor, and an all-zero one (scale
    1e-8 / 127)."""
    halves = np.array([127, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5],
                      np.float32)
    rand = np.random.default_rng(5).standard_normal((7, 9)).astype(
        np.float32)
    for x in (halves, rand, np.zeros(4, np.float32)):
        q, s = compression.quantize_int8(T(x))
        rq, rs = jcomp.quantize_int8(J(x))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(rq))
        assert np.float32(s) == np.asarray(rs)
        assert np.array_equal(compression.dequantize_int8(q, s).numpy(),
                              np.asarray(jcomp.dequantize_int8(rq, rs)))
    assert compression.quantize_int8(T(halves))[0].tolist() == \
        [127, 0, 2, 2, 0, -2, 4, -126]


def test_compress_two_steps_bit_equal():
    """Two successive compressed steps with error feedback: the
    decompressed gradients and the residuals equal the reference's bit
    for bit, and each residual is within half a code step (the scale,
    up to float32 rounding) of zero."""
    res = compression.init_residuals({k: T(a) for k, a in _tree(0).items()})
    jres = jcomp.init_residuals(jax.tree.map(J, _tree(0)))
    for seed in (6, 7):
        grads, before = _tree(seed, 0.01), res
        out, res = compression.compress_grads_with_feedback(
            {k: T(a) for k, a in grads.items()}, res)
        jout, jres = jcomp.compress_grads_with_feedback(
            jax.tree.map(J, grads), jres)
        for k in grads:
            assert np.array_equal(out[k].numpy(), np.asarray(jout[k]))
            assert np.array_equal(res[k].numpy(), np.asarray(jres[k]))
            # (g + r) / scale rounds to the nearest code: |residual| <=
            # scale / 2, plus the float32 rounding of the division and
            # the product at |code| <= 127 (2 * 127 * 2**-24 < 2**-16)
            _, scale = compression.quantize_int8(T(grads[k]) + before[k])
            assert float(res[k].abs().max()) <= \
                float(scale) * (0.5 + 2 ** -16)


def test_compress_scales_a_stacked_leaf_as_one():
    """The reference compresses each leaf of its stacked tree with one
    scale over all its layers; the port's layers are tensors of their
    own, grouped by `param_names.reference_leaf`: codes, decompressed
    gradients and residuals bit-equal to the stacked reference's, though
    the layers' magnitudes differ 100-fold."""
    rng = np.random.default_rng(8)
    stacked = rng.standard_normal((2, 4, 5)).astype(np.float32)
    stacked[1] *= 100
    ln = rng.standard_normal(5).astype(np.float32)
    jtree = {"blocks": {"w": J(stacked)}, "ln_f": {"scale": J(ln)}}
    jout, jres = jcomp.compress_grads_with_feedback(
        jtree, jcomp.init_residuals(jtree))
    grads = {"blocks.0.w": T(stacked[0]), "blocks.1.w": T(stacked[1]),
             "ln_f.scale": T(ln)}
    out, res = compression.compress_grads_with_feedback(
        grads, compression.init_residuals(grads))
    for i in range(2):
        assert np.array_equal(out[f"blocks.{i}.w"].numpy(),
                              np.asarray(jout["blocks"]["w"][i]))
        assert np.array_equal(res[f"blocks.{i}.w"].numpy(),
                              np.asarray(jres["blocks"]["w"][i]))
    assert np.array_equal(out["ln_f.scale"].numpy(),
                          np.asarray(jout["ln_f"]["scale"]))
    # on its own scale layer 0 would keep 100x finer codes
    alone = compression.dequantize_int8(*compression.quantize_int8(
        grads["blocks.0.w"]))
    assert not torch.equal(alone, out["blocks.0.w"])


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_reference_ssd_grads_overflow(arch):
    """A fault of the reference, recorded in ROADMAP Queue C: at 16
    tokens its SSD's where(tri, exp(seg), 0) overflows above the
    diagonal and its gradient there is 0 * inf = NaN, so its train step
    reports a NaN grad norm. The port masks seg before the exp: the same
    loss (within F32), finite gradients."""
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    jstep_cfg = jsteps.StepConfig(remat=False, compute_dtype=jnp.float32)
    state = jsteps.init_train_state(jax.random.PRNGKey(0), jcfg, jstep_cfg)
    pbatch, jbatch = _batch(cfg, seq=SEQ)
    (_, metrics), grads = jax.jit(jax.value_and_grad(lambda p: jsteps.lm_loss(
        p, jcfg, jbatch["tokens"], jbatch["labels"], shard=lambda n, x: x,
        step_cfg=jstep_cfg), has_aux=True))(state.params)
    loss = metrics["loss"]
    assert np.isnan(float(jopt.global_norm(grads)))
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, state.params))
    g, ploss, _ = steps.loss_and_grads(model, cfg, steps.StepConfig(
        compute_dtype=torch.float32), pbatch)
    close(float(ploss), float(loss))
    assert all(torch.isfinite(t).all() for t in g.values())
    assert float(optimizer.global_norm(g)) > 0


@pytest.mark.parametrize("arch", ARCHS + ("zamba2-1.2b@5",))
def test_params_to_numpy_inverts_params_from_numpy(arch):
    """The reference's initial tree goes across and comes back equal:
    the same names, the stacks stacked again (zamba2 at 5 layers has a
    tail), every leaf bit for bit."""
    name, _, layers = arch.partition("@")
    cfg, jcfg = get_config(name).reduced(), jax_config(name).reduced()
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=int(layers))
        jcfg = dataclasses.replace(jcfg, n_layers=int(layers))
    tree = jax.tree.map(np.asarray, jtf.init_model(jax.random.PRNGKey(5),
                                                   jcfg))
    back = flatten(params_to_numpy(cfg, params_from_numpy(cfg, tree)))
    want = flatten(tree)
    assert set(back) == set(want)
    for k, a in want.items():
        assert back[k].dtype == a.dtype and np.array_equal(back[k], a), k
    with pytest.raises(ValueError):
        params_to_numpy(cfg, {"embed.table": torch.zeros(2)})


@pytest.mark.parametrize("entry", ["make_train_step", "loss_and_grads",
                                   "forward"])
def test_use_flash_raises(entry):
    """Train mode refuses the flash kernel at every entry point: it has
    no backward, and its output would carry no gradient."""
    cfg = get_config("glm4-9b").reduced()
    step_cfg = steps.StepConfig(use_flash=True, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="no backward"):
        if entry == "make_train_step":
            steps.make_train_step(cfg, optimizer.OptimizerConfig(), step_cfg)
            return
        model = transformer.init_model(cfg, torch.Generator().manual_seed(6))
        batch, _ = _batch(cfg)
        if entry == "loss_and_grads":
            steps.loss_and_grads(model, cfg, step_cfg, batch)
        else:
            transformer.forward(model, cfg, batch["tokens"], mode="train",
                                use_flash=True, compute_dtype=torch.float32)


def test_serving_builds_no_graph_after_training():
    """After a train step the parameters require no gradient again, and
    a prefill of the trained model carries no autograd graph."""
    cfg = get_config("glm4-9b").reduced()
    state = steps.init_train_state(3, cfg, steps.StepConfig())
    batch, _ = _batch(cfg)
    state, met = steps.make_train_step(
        cfg, optimizer.OptimizerConfig(**OPT),
        steps.StepConfig(compute_dtype=torch.float32))(state, batch)
    assert torch.isfinite(met["loss"])
    assert not any(p.requires_grad for p in state.params.parameters())
    logits, caches = steps.make_prefill_step(cfg, steps.StepConfig(
        compute_dtype=torch.float32))(state.params, batch)
    assert logits.grad_fn is None and not logits.requires_grad
