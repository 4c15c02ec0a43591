"""The port's ``moe``, ``vlm``, ``hybrid`` and ``encdec`` families
(`repro_torch.models.moe`, `repro_torch.models.transformer`,
`repro_torch.train.steps`, `repro_torch.models.convert`, ``serve_lm
--live``) against the JAX package on the CPU, on ``.reduced()`` configs.
Inputs are made with numpy from a seed and handed to both; model weights
are the reference's own ``init_model`` carried across by
`convert.params_from_numpy`. The vlm and encdec models get the same
frontend embeddings on both sides.

Tolerances as in `tests/test_torch_models.py`: float32 throughout, the
same arithmetic in another order (XLA's CPU kernels against PyTorch's),
``F32 = dict(rtol=1e-4, atol=1e-5)``; routing choices, token ids, int8
codes and cache lengths are held with ``==``."""

import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jax_config
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.train import steps as jsteps
from repro_torch import serve_lm
from repro_torch.configs import get_config
from repro_torch.models import attention, moe, transformer
from repro_torch.models.convert import STACKS, flatten, load_numpy, \
    params_from_numpy
from repro_torch.train import steps

F32 = dict(rtol=1e-4, atol=1e-5)
#: The registry's configs of the four families, and zamba2 at 5 layers:
#: 2 groups of 2 Mamba2 blocks and a tail of 1 (the reduced config's 2
#: layers make one group and no tail; the published 38 make 6 groups and
#: a tail of 2).
ARCHS = ("qwen2-moe-a2.7b", "arctic-480b", "pixtral-12b", "zamba2-1.2b",
         "zamba2-1.2b@5", "seamless-m4t-large-v2")


def configs(arch):
    """(the port's reduced config, the reference's)."""
    name, _, layers = arch.partition("@")
    cfg, jcfg = get_config(name).reduced(), jax_config(name).reduced()
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=int(layers))
        jcfg = dataclasses.replace(jcfg, n_layers=int(layers))
    return cfg, jcfg


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **(tol or F32))


def _leaves(caches):
    return [t for t in torch.utils._pytree.tree_leaves(caches)
            if t is not None]


def _close_leaves(got, want):
    got, want = _leaves(got), jax.tree.leaves(want)
    assert [tuple(t.shape) for t in got] == [t.shape for t in want]
    for g, w in zip(got, want):
        if g.dtype in (torch.int32, torch.int8):
            assert np.array_equal(g.numpy(), np.asarray(w))
        else:
            close(g, w)


def _frontend(cfg, batch, seed):
    """Stub frontend embeddings (vlm, encdec), or None."""
    if cfg.family not in ("vlm", "encdec"):
        return None
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.frontend_seq, cfg.d_model)).astype(np.float32)


def _jpad(caches, family, max_seq):
    """``serve_lm.pad_caches`` on the reference's caches: only the
    self-attention KV grows."""
    def pad(kv):
        return jax.tree.map(lambda t: jnp.pad(t, [(0, 0), (0, 0), (
            0, max_seq - t.shape[2]), (0, 0), (0, 0)]) if t.ndim == 5 else t,
            kv)
    if family == "hybrid":
        return caches[0], pad(caches[1])
    if family == "encdec":
        return (pad(caches[0]),) + tuple(caches[1:])
    return pad(caches)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reduced config, the reference's config, its f32 params, the
    port's model holding them)."""
    cfg, jcfg = configs(request.param)
    tree = jtf.init_model(jax.random.PRNGKey(0), jcfg)
    return cfg, jcfg, tree, params_from_numpy(
        cfg, jax.tree.map(np.asarray, tree))


# ---------------------------------------------------------------------------
# moe
# ---------------------------------------------------------------------------

BANKS = {"shared": dict(n_shared=2, gated=True),
         "routed": dict(n_shared=0, gated=True),
         "ungated": dict(n_shared=0, gated=False)}


def _moe_pair(bank, seed=1):
    kw = BANKS[bank]
    tree = jmoe.init_moe(jax.random.PRNGKey(seed), 32, 24, 8, kw["n_shared"],
                         kw["gated"])
    port = load_numpy(moe.MoE(32, 24, 8, kw["n_shared"], kw["gated"]),
                      flatten(jax.tree.map(np.asarray, tree)))
    return tree, port


def _jax_route(tree, tokens, top_k):
    """The reference's routing lines (`repro/models/moe.py:61-63`)."""
    probs = jax.nn.softmax(J(tokens) @ tree["router"]["w"], axis=-1)
    return jax.lax.top_k(probs, top_k)


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
@pytest.mark.parametrize("bank", sorted(BANKS))
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_matches_jax(dispatch, bank, cf, monkeypatch):
    """Both dispatch modes on the reference's own init_moe weights, 2 x 12
    tokens routed top-2 over 8 experts: the chosen experts equal, output
    and aux loss at F32; at capacity factor 0.5 slots are dropped (checked
    here) into the sink row."""
    monkeypatch.setattr(moe, "MOE_DISPATCH", dispatch)
    monkeypatch.setattr(jmoe, "MOE_DISPATCH", dispatch)
    tree, port = _moe_pair(bank)
    x = np.random.default_rng(2).standard_normal((2, 12, 32)).astype(
        np.float32)
    kw = dict(n_experts=8, top_k=2, gated=BANKS[bank]["gated"],
              capacity_factor=cf)
    out, aux = moe.moe(port, T(x), **kw)
    rout, raux = jax.jit(partial(jmoe.moe, **kw))(tree, J(x))
    close(out, rout)
    close(aux, raux)
    _, idx, _, _, keep, cap = moe.route(port, T(x).reshape(24, 32),
                                        n_experts=8, top_k=2,
                                        capacity_factor=cf)
    assert np.array_equal(idx.numpy(),
                          np.asarray(_jax_route(tree, x.reshape(24, 32),
                                                2)[1]))
    assert cap == max(1, int(cf * 24 * 2 / 8))
    if cf < 1:
        assert not bool(keep.all())


def test_init_moe_draws_the_reference_bank():
    """``init_moe`` from a generator: the reference tree's names and
    shapes; the expert weights a plain (untruncated) normal of standard
    deviation d_in ** -0.5, as the reference's bank; the router a
    truncated one."""
    port = moe.init_moe(torch.Generator().manual_seed(0), 64, 48, 8, 2,
                        True)
    tree = flatten(jax.tree.map(np.asarray, jmoe.init_moe(
        jax.random.PRNGKey(0), 64, 48, 8, 2, True)))
    got = {k: tuple(v.shape) for k, v in port.named_parameters()}
    assert got == {k: v.shape for k, v in tree.items()}
    for name, d_in in (("experts.up.w", 64), ("shared.down.w", 48)):
        w = dict(port.named_parameters())[name]
        assert abs(float(w.std()) * d_in ** 0.5 - 1) < 0.03
        assert float(w.abs().max()) > 3 * d_in ** -0.5
    assert float(port.router.w.abs().max()) <= 2 * 64 ** -0.5


def test_top_k_matches_jax_on_ties():
    """The router's top-k against ``jax.lax.top_k`` on the same
    probabilities: rows with exact ties (the reference keeps the lower
    index first) and neighbours one float32 ulp apart; values and indices
    equal."""
    rng = np.random.default_rng(4)
    p = rng.uniform(0.0, 1.0, (64, 60)).astype(np.float32)
    p[::2] = np.round(p[::2] * 4) / 4                   # many exact ties
    p[1::4, 7] = np.nextafter(p[1::4, 3], np.float32(1.0))
    p[1::4, 11] = p[1::4, 3]
    p[3] = 0.25
    values, idx = moe.top_k_experts(T(p), 4)
    rvalues, ridx = jax.lax.top_k(J(p), 4)
    assert np.array_equal(idx.numpy(), np.asarray(ridx))
    assert np.array_equal(values.numpy(), np.asarray(rvalues))
    assert idx[3].tolist() == [0, 1, 2, 3]


def test_router_on_zero_tokens_picks_the_reference_experts():
    """Zero tokens give every expert the same logit (the product is
    exactly 0 on both sides): the router takes the reference's experts,
    the lowest indices, with equal gates."""
    tree, port = _moe_pair("routed", seed=3)
    tokens = np.random.default_rng(5).standard_normal((16, 32)).astype(
        np.float32)
    tokens[::2] = 0.0
    # a capacity no slot reaches: the gates are the renormalised top-k
    _, idx, gates, _, _, _ = moe.route(port, T(tokens), n_experts=8,
                                       top_k=4, capacity_factor=100.0)
    rgates, ridx = _jax_route(tree, tokens, 4)
    assert np.array_equal(idx.numpy(), np.asarray(ridx))
    assert idx[::2].tolist() == [[0, 1, 2, 3]] * 8
    close(gates, rgates / rgates.sum(-1, keepdims=True))


# ---------------------------------------------------------------------------
# the model and its serve steps
# ---------------------------------------------------------------------------

def test_forward_prefill_decode_match_jax(pair):
    """Prefill of 12 tokens (behind the vlm's frontend positions; the
    encdec's encoder over its frontend): logits, aux loss and every cache
    leaf; then one decode step from the caches padded to 16 positions
    more than the prompt: logits and caches."""
    cfg, jcfg, tree, model = pair
    toks = np.random.default_rng(17).integers(0, cfg.vocab_size, (2, 12))
    fe = _frontend(cfg, 2, 5)
    out = transformer.forward(model, cfg, T(toks), mode="prefill",
                              frontend_embeds=None if fe is None else T(fe),
                              compute_dtype=torch.float32)

    def fwd(mode):
        def run(params, tokens, caches=None, frontend=None):
            o = jtf.forward(params, jcfg, tokens, mode=mode, caches=caches,
                            frontend_embeds=frontend,
                            compute_dtype=jnp.float32)
            return o.logits, o.caches, o.aux_loss
        return jax.jit(run)

    rlogits, rcaches, raux = fwd("prefill")(
        tree, J(toks).astype(jnp.int32), None, None if fe is None else J(fe))
    assert tuple(out.logits.shape) == (2, 12, cfg.padded_vocab())
    close(out.logits, rlogits)
    close(out.aux_loss, raux)
    _close_leaves(out.caches, rcaches)
    max_seq = 16 + (cfg.frontend_seq if cfg.family == "vlm" else 0)
    caches = serve_lm.pad_caches(out.caches, max_seq, cfg.family)
    nxt = toks[:, -1:]
    out = transformer.forward(model, cfg, T(nxt), mode="decode",
                              caches=caches, compute_dtype=torch.float32)
    rlogits, rcaches, raux = fwd("decode")(
        tree, J(nxt).astype(jnp.int32), _jpad(rcaches, cfg.family, max_seq))
    close(out.logits, rlogits)
    close(out.aux_loss, raux)
    _close_leaves(out.caches, rcaches)


def test_greedy_decode_matches_jax_loop(pair):
    """The serve steps: prefill 4 prompts of 10 tokens (the same frontend
    embeddings on both sides), pad the self-attention caches to the
    prefill's positions + generated, decode 8 greedy tokens; the tokens
    equal the reference's jitted prefill / decode loop, and so do the
    final self-attention cache lengths."""
    cfg, jcfg, tree, model = pair
    prompt = np.random.default_rng(18).integers(0, cfg.vocab_size, (4, 10))
    fe = _frontend(cfg, 4, 6)
    gen = 8
    max_seq = 10 + gen + (cfg.frontend_seq if cfg.family == "vlm" else 0)
    step_cfg = steps.StepConfig(compute_dtype=torch.float32)
    prefill = steps.make_prefill_step(cfg, step_cfg)
    decode = steps.make_decode_step(cfg, step_cfg)
    batch = {"tokens": T(prompt)}
    jbatch = {"tokens": J(prompt).astype(jnp.int32)}
    if fe is not None:
        batch["frontend"], jbatch["frontend"] = T(fe), J(fe)
    logits, caches = prefill(model, batch)
    caches = serve_lm.pad_caches(caches, max_seq, cfg.family)
    toks = [logits.argmax(-1)[:, None]]
    for _ in range(gen):
        logits, caches = decode(model, {"tokens": toks[-1]}, caches)
        toks.append(logits.argmax(-1)[:, None])
    jstep = jsteps.StepConfig(remat=False, compute_dtype=jnp.float32)
    jprefill = jax.jit(jsteps.make_prefill_step(jcfg, jstep))
    jdecode = jax.jit(jsteps.make_decode_step(jcfg, jstep))
    rlogits, rcaches = jprefill(tree, jbatch)
    rcaches = _jpad(rcaches, cfg.family, max_seq)
    rtoks = [jnp.argmax(rlogits, -1).astype(jnp.int32)[:, None]]
    for _ in range(gen):
        rlogits, rcaches = jdecode(tree, {"tokens": rtoks[-1]}, rcaches)
        rtoks.append(jnp.argmax(rlogits, -1).astype(jnp.int32)[:, None])
    assert torch.cat(toks, 1).tolist() == \
        np.asarray(jnp.concatenate(rtoks, 1)).tolist()
    kv = serve_lm._self_kv(caches, cfg.family)
    rkv = rcaches[1] if cfg.family == "hybrid" else \
        rcaches[0] if cfg.family == "encdec" else rcaches
    assert kv.length.tolist() == np.asarray(rkv.length).tolist()
    assert int(kv.length.max()) == max_seq


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_match_jax(arch, quant, monkeypatch):
    """Shapes, dtypes and zeros of every leaf, in the reference's order;
    KV_QUANT makes the moe and vlm caches int8 and leaves the hybrid's
    and the encoder-decoder's in the compute dtype, as the reference."""
    monkeypatch.setattr(attention, "KV_QUANT", quant)
    monkeypatch.setattr(jattn, "KV_QUANT", quant)
    cfg, jcfg = configs(arch)
    got = _leaves(steps.init_caches(cfg, 3, 20, torch.float32))
    want = jax.tree.leaves(jsteps.init_caches(jcfg, 3, 20, jnp.float32))
    assert [(tuple(t.shape), str(t.dtype).split(".")[1]) for t in got] == \
        [(t.shape, t.dtype.name) for t in want]
    assert all(not t.any() for t in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_matches_jax_tree(arch):
    """The port's own init (from a generator) has the reference tree's
    names, shapes and dtypes (the hybrid's grouped ``blocks``, ``tail``
    and ``shared_attn``; the encoder-decoder's ``enc_blocks``, ``ln_enc``
    and cross-attention; the expert banks' expert axis), and one seed
    gives one model."""
    cfg, jcfg = configs(arch)
    ref = params_from_numpy(cfg, jax.tree.map(np.asarray, jtf.init_model(
        jax.random.PRNGKey(3), jcfg)))
    draw = lambda: transformer.init_model(
        cfg, torch.Generator().manual_seed(3))
    got = dict(draw().named_parameters())
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in ref.named_parameters()}
    assert all(torch.equal(v, got[k]) for k, v in draw().named_parameters())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_copies_exactly(arch, dtype):
    """Every leaf of the reference's tree lands in the parameter of the
    same name, each stack split by its own leading axis, bit for bit, in
    its own dtype."""
    cfg, jcfg = configs(arch)
    tree = jax.tree.map(np.asarray, jtf.init_model(
        jax.random.PRNGKey(1), jcfg, getattr(jnp, dtype)))
    params = dict(params_from_numpy(cfg, tree).named_parameters())
    n = 0
    for name, arr in flatten(tree).items():
        stack, _, rest = name.partition(".")
        parts = [(f"{stack}.{i}.{rest}", arr[i]) for i in range(len(arr))] \
            if stack in STACKS else [(name, arr)]
        for key, want in parts:
            got = params[key]
            assert str(got.dtype).split(".")[1] == want.dtype.name
            assert np.array_equal(got.float().numpy(),
                                  want.astype(np.float32))
            n += 1
    assert n == len(params)


def _tree(arch, seed=2):
    cfg, jcfg = configs(arch)
    return cfg, jax.tree.map(np.asarray, jtf.init_model(
        jax.random.PRNGKey(seed), jcfg))


@pytest.mark.parametrize("fault", ["hybrid_all_layers", "tail_length",
                                   "tail_on_dense", "enc_blocks_length",
                                   "shared_attn_missing", "expert_axis"])
def test_params_from_numpy_rejects_mismatch(fault):
    """The stacked names: the hybrid's blocks at n_layers (not the grouped
    count), a tail of the wrong length or on a model without one, an
    encoder of the wrong depth, a missing shared block, an expert bank
    with the wrong expert count."""
    if fault == "hybrid_all_layers":
        cfg, tree = _tree("zamba2-1.2b@5")
        tree["blocks"]["ln"]["scale"] = np.ones((5, cfg.d_model), np.float32)
    elif fault == "tail_length":
        cfg, tree = _tree("zamba2-1.2b@5")
        tree["tail"]["ln"]["scale"] = np.ones((2, cfg.d_model), np.float32)
    elif fault == "tail_on_dense":
        cfg, tree = _tree("pixtral-12b")
        tree["tail"] = tree["blocks"]
    elif fault == "enc_blocks_length":
        cfg, tree = _tree("seamless-m4t-large-v2")
        tree["enc_blocks"] = jax.tree.map(lambda t: t[:1], tree["enc_blocks"])
    elif fault == "shared_attn_missing":
        cfg, tree = _tree("zamba2-1.2b")
        del tree["shared_attn"]
    else:
        cfg, tree = _tree("qwen2-moe-a2.7b")
        up = tree["blocks"]["moe"]["experts"]["up"]
        up["w"] = up["w"][:, :-1]
    with pytest.raises(ValueError):
        params_from_numpy(cfg, tree)


@pytest.mark.parametrize("family", ["hybrid", "encdec", "moe"])
def test_pad_caches_grows_only_self_kv(family):
    """The demo's pad grows the self-attention KV (the hybrid's one a
    group, the encoder-decoder's one a layer) along its sequence axis and
    passes the SSM states, cross K/V and memory through unchanged."""
    arch = {"hybrid": "zamba2-1.2b@5", "encdec": "seamless-m4t-large-v2",
            "moe": "qwen2-moe-a2.7b"}[family]
    cfg, _ = configs(arch)
    caches = steps.init_caches(cfg, 2, 6, torch.float32)
    padded = serve_lm.pad_caches(caches, 11, cfg.family)
    kv = serve_lm._self_kv(padded, cfg.family)
    assert kv.k.shape[2] == kv.v.shape[2] == 11
    assert kv.k.shape[0] == (2 if family == "hybrid" else cfg.n_layers)
    if family != "moe":
        assert type(padded) is tuple and len(padded) == len(caches)
        rest = [t for t in padded if t is not kv]
        old = serve_lm._self_kv(caches, cfg.family)
        want = [t for t in caches if t is not old]
        assert all(a is b for a, b in zip(_leaves(rest), _leaves(want)))


def test_cache_layout_of_an_unknown_family_raises():
    """The self-attention KV is found by the family, never guessed from
    the caches' shape: a family without a known layout raises."""
    cfg, _ = configs("zamba2-1.2b@5")
    caches = steps.init_caches(cfg, 2, 6, torch.float32)
    with pytest.raises(ValueError, match="no cache layout"):
        serve_lm.pad_caches(caches, 11, "train")
    with pytest.raises(ValueError, match="no cache layout"):
        serve_lm._self_kv(caches, "retrieval")


def test_encdec_prefill_needs_frontend():
    cfg, _ = configs("seamless-m4t-large-v2")
    model = transformer.init_model(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="frontend"):
        transformer.forward(model, cfg, torch.zeros((1, 4), dtype=torch.long))


def test_forward_train_mode_raises_for_every_family():
    """The name is kept from when the train mode raised, before the train
    step was ported (`tests/test_torch_train.py` holds that step). On
    the same models the call now returns the (B, L, V) logits of the
    text (the vlm's frontend positions dropped), no caches, and a finite
    positive aux loss for the MoE model (zero otherwise); the
    encoder-decoder without frontend embeddings raises, as its prefill
    does."""
    for arch in ARCHS[:1] + ARCHS[2:4] + ARCHS[5:]:
        cfg, _ = configs(arch)
        model = transformer.init_model(cfg, torch.Generator().manual_seed(0))
        toks = torch.randint(0, cfg.vocab_size, (2, 6),
                             generator=torch.Generator().manual_seed(1))
        fr = _frontend(cfg, 2, 2)
        if cfg.family == "encdec":
            with pytest.raises(ValueError, match="frontend"):
                transformer.forward(model, cfg, toks, mode="train")
        out = transformer.forward(
            model, cfg, toks, mode="train",
            frontend_embeds=None if fr is None else T(fr))
        assert tuple(out.logits.shape) == (2, 6, cfg.padded_vocab()), arch
        assert out.caches is None and torch.isfinite(out.logits).all()
        aux = float(out.aux_loss)
        assert (aux > 0 and np.isfinite(aux)) if cfg.family == "moe" \
            else aux == 0.0


@pytest.mark.parametrize("arch", ARCHS[:4] + ARCHS[5:])
def test_serve_lm_live_on_cpu(arch):
    """``serve_lm --live --reduced --device cpu --arch <arch>``: the demo's
    checks hold for each family's caches (they raise otherwise), the CPU
    launches no kernel, the vlm's caches hold its frontend positions in
    front of the prompt, and the report carries every step's logits."""
    rep = serve_lm.main(["--live", "--reduced", "--device", "cpu", "--arch",
                         arch, "--batch", "2", "--prompt-len", "20",
                         "--gen-len", "5"])
    cfg, _ = configs(arch)
    assert isinstance(rep, serve_lm.LiveReport)
    assert tuple(rep.tokens.shape) == (2, 6)
    assert tuple(rep.step_logits.shape)[:2] == (6, 2)
    assert torch.equal(rep.step_logits.argmax(-1).T, rep.tokens)
    assert rep.launches["prefill"] == {"flash_attention": 0, "ssd_scan": 0}
    assert rep.prefix == (cfg.frontend_seq if cfg.family == "vlm" else 0)
    assert rep.max_seq == rep.prefix + 25
    assert (rep.frontend is None) == (cfg.family not in ("vlm", "encdec"))
    kv = serve_lm._self_kv(rep.caches, cfg.family)
    assert int(kv.length.min()) == rep.max_seq
    assert len(rep.decode_ms) == 5 and rep.peak_bytes is None
