"""The port's live model runtime (`repro_torch.models`,
`repro_torch.train.steps`, ``serve_lm --live``) against the JAX package on
the CPU. Inputs are made with numpy from a seed and handed to both; model
weights are the reference's own ``init_model`` carried across by
`convert.params_from_numpy`. Where the reference reaches a Pallas kernel
(the flash prefill at L 512, ``ssd_chunked(use_kernel=True)``) it runs in
interpret mode, and the port's op runs its kernel's plain version on
these CPU tensors.

Tolerances: float32 throughout unless a test says otherwise. The port and
the reference take the same float32 arithmetic in another order (XLA's
CPU kernels against PyTorch's), which moves a result by a few ulp, so
``F32 = dict(rtol=1e-4, atol=1e-5)``; a few results are exact (a gather,
int8 codes, token ids) and are held with ``==``."""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jax_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.train import steps as jsteps
from repro_torch import serve_lm
from repro_torch.configs import get_config
from repro_torch.models import attention, layers, ssm, transformer
from repro_torch.models.convert import flatten, load_numpy, \
    params_from_numpy
from repro_torch.train import steps

F32 = dict(rtol=1e-4, atol=1e-5)
ARCHS = ("glm4-9b", "mamba2-1.3b")


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **(tol or F32))


def _loaded(module, tree):
    """``module`` holding the reference's parameter dict ``tree``."""
    return load_numpy(module, flatten(jax.tree.map(np.asarray, tree)))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norms_match_jax(kind, dtype):
    """Statistics in float32, the result in x's dtype: float32 at F32,
    bfloat16 within one bf16 ulp (2**-7 relative)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32) * 3 + 1
    tree = {"scale": rng.uniform(0.5, 1.5, 32).astype(np.float32)}
    if kind == "layer":
        tree["bias"] = rng.standard_normal(32).astype(np.float32)
        port = _loaded(layers.LayerNorm(32), tree)
        fn, jfn = layers.layer_norm, jlayers.layer_norm
    else:
        port = _loaded(layers.RMSNorm(32), tree)
        fn, jfn = layers.rms_norm, jlayers.rms_norm
    tol = F32 if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -7)
    out = fn(port, T(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    ref = jfn(jax.tree.map(J, tree), J(x).astype(getattr(jnp, dtype)))
    close(out, ref.astype(jnp.float32), **tol)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_matches_jax(gated):
    """Gated (silu) and plain (tanh-approximate gelu, jax.nn.gelu's
    default) MLPs on the reference's own init_mlp weights."""
    tree = jlayers.init_mlp(jax.random.PRNGKey(1), 32, 64, gated)
    port = _loaded(layers.MLP(32, 64, gated), tree)
    x = np.random.default_rng(1).standard_normal((2, 7, 32)).astype(
        np.float32)
    close(layers.mlp(port, T(x), gated), jlayers.mlp(tree, J(x), gated))
    close(layers.dense(port.up, T(x)), jlayers.dense(tree["up"], J(x)))


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_apply_rope_matches_jax(mode):
    """float32 angles: a prefill's shared positions (L,), and a decode
    step's per-row positions (B, 1) out to position 4000."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9 if mode == "prefill" else 1, 4,
                             16)).astype(np.float32)
    pos = np.arange(9) if mode == "prefill" else np.array([[3], [4000]])
    close(layers.apply_rope(T(x), T(pos), 10_000.0),
          jlayers.apply_rope(J(x), J(pos), 10_000.0))


def test_embed_unembed_match_jax():
    """The gather is exact (float32 and cast to bfloat16); the unembed
    product at F32."""
    rng = np.random.default_rng(3)
    tree = {"table": rng.standard_normal((64, 16)).astype(np.float32)}
    port = _loaded(layers.Embedding(64, 16), tree)
    ids = rng.integers(0, 64, (2, 5))
    for dt in ("float32", "bfloat16"):
        out = layers.embed(port, T(ids), getattr(torch, dt))
        ref = jlayers.embed(jax.tree.map(J, tree), J(ids), getattr(jnp, dt))
        assert np.array_equal(out.float().numpy(),
                              np.asarray(ref.astype(jnp.float32)))
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    close(layers.unembed(port, T(x)),
          jlayers.unembed(jax.tree.map(J, tree), J(x)))


def test_truncated_normal_matches_jax_distribution():
    """Not the reference's numbers (another generator) but its law:
    within +-2 std, and mean and standard deviation of 200k draws within
    1 % of the reference's over as many."""
    std = 0.5
    port = layers.truncated_normal(torch.Generator().manual_seed(0),
                                   (200_000,), std).numpy()
    ref = np.asarray(jlayers.truncated_normal(jax.random.PRNGKey(0),
                                              (200_000,), std))
    assert np.abs(port).max() <= 2 * std
    assert abs(port.mean() - ref.mean()) < 0.01 * std
    assert abs(port.std() / ref.std() - 1) < 0.01
    again = layers.truncated_normal(torch.Generator().manual_seed(0),
                                    (200_000,), std).numpy()
    assert np.array_equal(port, again)
    bf = layers.truncated_normal(torch.Generator().manual_seed(0), (8,),
                                 std, dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

HEADS = dict(n_heads=4, n_kv_heads=2, head_dim=16, rope_theta=10_000.0)


def _attn_params(seed=4):
    tree = jattn.init_attention(jax.random.PRNGKey(seed), 64, 4, 2, 16)
    return tree, _loaded(attention.Attention(64, 4, 2, 16), tree)


@pytest.mark.parametrize("l,use_flash", [(16, False), (512, True)])
def test_attention_prefill_matches_jax(l, use_flash):
    """Prefill with RoPE and GQA; at L 512 with use_flash the reference
    runs its Pallas flash kernel in interpret mode and the port the flash
    op (its plain version on CPU tensors) at the bridge's tile."""
    tree, port = _attn_params()
    x = np.random.default_rng(5).standard_normal((1, l, 64)).astype(
        np.float32)
    out, cache = attention.attention(port, T(x), use_flash=use_flash,
                                     **HEADS)
    rout, rcache = jax.jit(partial(jattn.attention, use_flash=use_flash,
                                   **HEADS))(tree, J(x))
    close(out, rout)
    close(cache.k, rcache.k)
    close(cache.v, rcache.v)
    assert cache.length.tolist() == np.asarray(rcache.length).tolist()


@pytest.mark.parametrize("quant", [False, True])
def test_attention_decode_matches_jax(quant):
    """One decode token against caches of S 8 holding 2, 5 and 8 valid
    positions: the first two rows are written at their length, the third
    (length = max_seq) has its write dropped by the one-hot, as in the
    reference; every length grows by one. With an int8 cache the codes and
    scales of the write agree too."""
    tree, port = _attn_params(6)
    rng = np.random.default_rng(7)
    lengths = np.array([2, 5, 8], np.int32)
    kv = rng.standard_normal((2, 3, 8, 2, 16)).astype(np.float32)
    kv *= (np.arange(8)[None, None, :, None, None] <
           lengths[None, :, None, None, None])
    if quant:
        codes, scales = zip(*(jattn.quantize_kv(J(t)) for t in kv))
        rc = jattn.KVCache(k=codes[0], v=codes[1], length=J(lengths),
                           k_scale=scales[0], v_scale=scales[1])
    else:
        rc = jattn.KVCache(k=J(kv[0]), v=J(kv[1]), length=J(lengths))
    cache = attention.KVCache(*(None if t is None else T(t) for t in rc))
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    out, new = attention.attention(port, T(x), cache=cache, **HEADS)
    rout, rnew = jax.jit(partial(jattn.attention, **HEADS))(tree, J(x),
                                                            cache=rc)
    close(out, rout)
    assert new.length.tolist() == [3, 6, 9]
    assert torch.equal(new.k[2], cache.k[2])          # dropped write
    assert not torch.equal(new.k[0, 2], cache.k[0, 2])
    for got, want in zip(new, rnew):
        if got is None:
            assert want is None
        elif quant and got.dtype == torch.int8:
            assert np.array_equal(got.numpy(), np.asarray(want))
        elif got.dtype == torch.int32:
            assert got.tolist() == np.asarray(want).tolist()
        else:
            close(got, want)


def test_kv_quant_prefill_matches_jax(monkeypatch):
    """KV_QUANT (read at call time in both packages): the prefill's cache
    is int8 codes, equal to the reference's, with equal scales."""
    monkeypatch.setattr(attention, "KV_QUANT", True)
    monkeypatch.setattr(jattn, "KV_QUANT", True)
    tree, port = _attn_params(8)
    x = np.random.default_rng(9).standard_normal((2, 12, 64)).astype(
        np.float32)
    _, cache = attention.attention(port, T(x), **HEADS)
    _, rcache = jax.jit(partial(jattn.attention, **HEADS))(tree, J(x))
    assert cache.k.dtype == torch.int8
    assert np.array_equal(cache.k.numpy(), np.asarray(rcache.k))
    assert np.array_equal(cache.v.numpy(), np.asarray(rcache.v))
    close(cache.k_scale, rcache.k_scale, rtol=1e-6, atol=0)
    q, s = attention.quantize_kv(T(x))
    close(attention.dequantize_kv(q, s, torch.float32),
          jattn.dequantize_kv(*jattn.quantize_kv(J(x)), jnp.float32))


@pytest.mark.parametrize("causal,l,block_k", [(True, 2048, 1024),
                                              (False, 256, 64)])
def test_dot_attention_chunked_matches_jax(causal, l, block_k):
    """The online-softmax loop (the prefill branch for L >= 2048) against
    the reference's scan, and against the port's one-shot dot_attention;
    the bidirectional case with a kv_length mask."""
    rng = np.random.default_rng(10)
    q, k, v = (rng.standard_normal((2, l, 2, 16)).astype(np.float32)
               for _ in range(3))
    kv_len = None if causal else np.array([l, l // 3], np.int32)
    out = attention.dot_attention_chunked(
        T(q), T(k), T(v), causal=causal, block_k=block_k,
        kv_length=None if kv_len is None else T(kv_len))
    ref = jattn.dot_attention_chunked(
        J(q), J(k), J(v), causal=causal, block_k=block_k,
        kv_length=None if kv_len is None else J(kv_len))
    close(out, ref)
    close(out, attention.dot_attention(
        T(q), T(k), T(v), causal=causal,
        kv_length=None if kv_len is None else T(kv_len)))


# ---------------------------------------------------------------------------
# ssm
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, b, l, h, p, g, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, h, p)).astype(np.float32),
            rng.uniform(0.001, 0.2, (b, l, h)).astype(np.float32),
            -rng.uniform(0.5, 4.0, (h,)).astype(np.float32),
            rng.standard_normal((b, l, g, n)).astype(np.float32),
            rng.standard_normal((b, l, g, n)).astype(np.float32),
            rng.standard_normal((h,)).astype(np.float32))


@pytest.mark.parametrize("use_kernel,groups", [(False, 1), (True, 1),
                                               (False, 2), (True, 2)])
def test_ssd_chunked_matches_jax(use_kernel, groups):
    """Chunk 32 as in the reference's kernel test, two chunks and a
    non-zero initial state: use_kernel=True runs the reference's Pallas
    ssd_scan in interpret mode and the port's ssd op (its plain version
    here); with 2 groups B and C are repeated over the heads."""
    args = _ssd_inputs(11, 1, 64, 4, 16, groups, 16)
    h0 = np.random.default_rng(12).standard_normal((1, 4, 16, 16)).astype(
        np.float32)
    y, hf = ssm.ssd_chunked(*map(T, args), chunk=32, h0=T(h0),
                            use_kernel=use_kernel)
    ry, rh = jax.jit(partial(jssm.ssd_chunked, chunk=32,
                             use_kernel=use_kernel))(*map(J, args), h0=J(h0))
    close(y, ry)
    close(hf, rh)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssd_chunked_bf16_matches_jax(use_kernel):
    """bf16 x, B and C beside float32 dt and a, as the bf16 model makes
    them: the kernel path takes the five operands in float32 (the
    reference's kernel reads each in float32). y and the final state
    within 2**-8 of the reference in relative norm, under bf16's 2**-7
    relative precision."""
    x, dt, a, b, c, d = _ssd_inputs(19, 1, 64, 4, 16, 1, 16)
    bf = lambda t: T(t).to(torch.bfloat16)
    y, hf = ssm.ssd_chunked(bf(x), T(dt), T(a), bf(b), bf(c), T(d),
                            chunk=32, use_kernel=use_kernel)
    jbf = lambda t: J(t).astype(jnp.bfloat16)
    ry, rh = jax.jit(partial(jssm.ssd_chunked, chunk=32,
                             use_kernel=use_kernel))(
        jbf(x), J(dt), J(a), jbf(b), jbf(c), J(d))
    assert y.dtype == torch.bfloat16
    for got, want in ((y, ry), (hf, rh)):
        want = np.asarray(want.astype(jnp.float32))
        err = np.linalg.norm(got.float().numpy() - want)
        assert err <= 2 ** -8 * np.linalg.norm(want), err


def test_ssd_recurrent_step_matches_jax():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 4, 8)).astype(np.float32)
    dt = rng.uniform(0.001, 0.2, (2, 4)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, 4).astype(np.float32)
    b, c = (rng.standard_normal((2, 2, 16)).astype(np.float32)
            for _ in range(2))
    d = rng.standard_normal(4).astype(np.float32)
    h = rng.standard_normal((2, 4, 8, 16)).astype(np.float32)
    args = (x, dt, a, b, c, d, h)
    (y, hn), (ry, rhn) = (ssm.ssd_recurrent_step(*map(T, args)),
                          jssm.ssd_recurrent_step(*map(J, args)))
    close(y, ry)
    close(hn, rhn)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(14)
    xbc = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    bias = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_state else None
    out, new = ssm._causal_conv(T(xbc), T(w), T(bias),
                                None if st is None else T(st))
    rout, rnew = jssm._causal_conv(J(xbc), J(w), J(bias),
                                   None if st is None else J(st))
    close(out, rout)
    close(new, rnew)


def test_mamba2_block_matches_jax():
    """The reduced mamba2-1.3b block on the reference's init_mamba2
    weights: a prefill of 40 tokens (padded to one chunk of 256), then a
    decode step from its state."""
    cfg = get_config("mamba2-1.3b").reduced()
    kw = dict(expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
              groups=cfg.ssm_groups, state=cfg.ssm_state, conv=cfg.ssm_conv)
    tree = jssm.init_mamba2(jax.random.PRNGKey(15), cfg.d_model, **kw)
    port = _loaded(ssm.Mamba2(cfg.d_model, **kw), tree)
    rng = np.random.default_rng(16)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    block = jax.jit(partial(jssm.mamba2_block, cfg=cfg))
    out, st = ssm.mamba2_block(port, T(x), cfg)
    rout, rst = block(tree, J(x))
    close(out, rout)
    close(st.h, rst.h)
    close(st.conv, rst.conv)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    out, st = ssm.mamba2_block(port, T(x1), cfg, state=st)
    rout, rst = block(tree, J(x1), state=rst)
    close(out, rout)
    close(st.h, rst.h)
    close(st.conv, rst.conv)


# ---------------------------------------------------------------------------
# the model and its serve steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reduced config, the reference's f32 params, the port's model
    holding them) for one architecture."""
    cfg = get_config(request.param).reduced()
    tree = jtf.init_model(jax.random.PRNGKey(0),
                          jax_config(request.param).reduced())
    return cfg, tree, params_from_numpy(cfg, jax.tree.map(np.asarray, tree))


def _pad(caches, max_seq):
    """The reference demo's cache pad, on the reference's caches."""
    def pad(t):
        if t.ndim == 5 and t.shape[2] < max_seq and \
                isinstance(caches, jattn.KVCache):
            return jnp.pad(t, [(0, 0), (0, 0), (0, max_seq - t.shape[2]),
                               (0, 0), (0, 0)])
        return t
    return jax.tree.map(pad, caches)


def test_forward_prefill_decode_match_jax(pair):
    """Prefill of 12 tokens: logits and every cache leaf; then one decode
    step from the caches padded to 16: logits and caches."""
    cfg, tree, model = pair
    jcfg = jax_config(cfg.name).reduced()
    toks = np.random.default_rng(17).integers(0, cfg.vocab_size, (2, 12))
    out = transformer.forward(model, cfg, T(toks), mode="prefill",
                              compute_dtype=torch.float32)
    def fwd(mode):
        def run(params, tokens, caches=None):
            out = jtf.forward(params, jcfg, tokens, mode=mode, caches=caches,
                              compute_dtype=jnp.float32)
            return out.logits, out.caches
        return jax.jit(run)

    rlogits, rcaches = fwd("prefill")(tree, J(toks).astype(jnp.int32))
    close(out.logits, rlogits)
    for got, want in zip(out.caches, jax.tree.leaves(rcaches)):
        close(got, want)
    caches = serve_lm.pad_caches(out.caches, 16, cfg.family)
    nxt = toks[:, -1:]
    out = transformer.forward(model, cfg, T(nxt), mode="decode",
                              caches=caches, compute_dtype=torch.float32)
    rlogits, rcaches = fwd("decode")(tree, J(nxt).astype(jnp.int32),
                                     _pad(rcaches, 16))
    close(out.logits, rlogits)
    for got, want in zip(out.caches, jax.tree.leaves(rcaches)):
        close(got, want)


def test_greedy_decode_matches_jax_loop(pair):
    """The serve steps: prefill 4 prompts of 10 tokens, pad the caches to
    prompt + generated, decode 8 greedy tokens; the tokens equal the
    reference's jitted prefill / decode loop, the cache lengths too."""
    cfg, tree, model = pair
    jcfg = jax_config(cfg.name).reduced()
    prompt = np.random.default_rng(18).integers(0, cfg.vocab_size, (4, 10))
    gen, max_seq = 8, 18
    step_cfg = steps.StepConfig(compute_dtype=torch.float32)
    prefill = steps.make_prefill_step(cfg, step_cfg)
    decode = steps.make_decode_step(cfg, step_cfg)
    logits, caches = prefill(model, {"tokens": T(prompt)})
    caches = serve_lm.pad_caches(caches, max_seq, cfg.family)
    toks = [logits.argmax(-1)[:, None]]
    for _ in range(gen):
        logits, caches = decode(model, {"tokens": toks[-1]}, caches)
        toks.append(logits.argmax(-1)[:, None])
    jcfg_step = jsteps.StepConfig(remat=False, compute_dtype=jnp.float32)
    jprefill = jax.jit(jsteps.make_prefill_step(jcfg, jcfg_step))
    jdecode = jax.jit(jsteps.make_decode_step(jcfg, jcfg_step))
    rlogits, rcaches = jprefill(tree, {"tokens": J(prompt).astype(
        jnp.int32)})
    rcaches = _pad(rcaches, max_seq)
    rtoks = [jnp.argmax(rlogits, -1).astype(jnp.int32)[:, None]]
    for _ in range(gen):
        rlogits, rcaches = jdecode(tree, {"tokens": rtoks[-1]}, rcaches)
        rtoks.append(jnp.argmax(rlogits, -1).astype(jnp.int32)[:, None])
    assert torch.cat(toks, 1).tolist() == \
        np.asarray(jnp.concatenate(rtoks, 1)).tolist()
    if cfg.family == "dense":
        assert caches.length.tolist() == np.asarray(rcaches.length).tolist()
        assert int(caches.length.max()) == max_seq


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_copies_exactly(dtype):
    """Every leaf of the reference's tree lands in the parameter of the
    same name (the layer axis split across blocks), bit for bit, in its
    own dtype (the norms and SSM vectors stay float32 under a bfloat16
    init)."""
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        tree = jax.tree.map(np.asarray, jtf.init_model(
            jax.random.PRNGKey(1), jax_config(arch).reduced(),
            getattr(jnp, dtype)))
        params = dict(params_from_numpy(cfg, tree).named_parameters())
        n = 0
        for name, arr in flatten(tree).items():
            for i in range(cfg.n_layers if name.startswith("blocks.")
                           else 1):
                key = name.replace("blocks.", f"blocks.{i}.", 1)
                want = arr[i] if name.startswith("blocks.") else arr
                got = params[key]
                assert str(got.dtype).split(".")[1] == want.dtype.name
                assert np.array_equal(got.float().numpy(),
                                      want.astype(np.float32))
                n += 1
        assert n == len(params)


@pytest.mark.parametrize("fault", ["extra", "missing", "shape", "layers"])
def test_params_from_numpy_rejects_mismatch(fault):
    cfg = get_config("glm4-9b").reduced()
    tree = jax.tree.map(np.asarray, jtf.init_model(
        jax.random.PRNGKey(2), jax_config("glm4-9b").reduced()))
    if fault == "extra":
        tree["tail"] = {"w": np.zeros(3, np.float32)}
    elif fault == "missing":
        del tree["ln_f"]
    elif fault == "shape":
        tree["embed"]["table"] = tree["embed"]["table"][:, :-1]
    else:
        tree["blocks"]["ln1"]["scale"] = tree["blocks"]["ln1"]["scale"][:1]
    with pytest.raises(ValueError):
        params_from_numpy(cfg, tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_matches_jax_tree(arch):
    """The port's own init (from a generator) has the reference tree's
    names, shapes and dtypes, and one seed gives one model."""
    cfg = get_config(arch).reduced()
    ref = params_from_numpy(cfg, jax.tree.map(np.asarray, jtf.init_model(
        jax.random.PRNGKey(3), jax_config(arch).reduced())))
    draw = lambda: transformer.init_model(
        cfg, torch.Generator().manual_seed(3))
    got = dict(draw().named_parameters())
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in ref.named_parameters()}
    assert all(torch.equal(v, got[k]) for k, v in draw().named_parameters())


@pytest.mark.parametrize("quant", [False, True])
def test_init_caches_match_jax(quant, monkeypatch):
    monkeypatch.setattr(attention, "KV_QUANT", quant)
    monkeypatch.setattr(jattn, "KV_QUANT", quant)
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        got = steps.init_caches(cfg, 3, 20, torch.float32)
        want = jsteps.init_caches(jax_config(arch).reduced(), 3, 20,
                                  jnp.float32)
        leaves = [t for t in got if t is not None]
        assert [(tuple(t.shape), str(t.dtype).split(".")[1])
                for t in leaves] == \
            [(t.shape, t.dtype.name) for t in jax.tree.leaves(want)]
        assert all(not t.any() for t in leaves)


def test_forward_train_mode_raises():
    """The name is kept from when the train mode raised, before the train
    step was ported (`tests/test_torch_train.py` holds that step). The
    same call now returns the (B, L, V) logits of the whole sequence,
    equal to the prefill's, no caches and a zero aux loss, with remat on
    or off; a mode the reference does not have raises."""
    cfg = get_config("glm4-9b").reduced()
    model = transformer.init_model(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(1))
    pre = transformer.forward(model, cfg, toks, mode="prefill")
    for remat in (False, True):
        out = transformer.forward(model, cfg, toks, mode="train",
                                  remat=remat)
        assert tuple(out.logits.shape) == (2, 6, cfg.padded_vocab())
        assert out.caches is None and float(out.aux_loss) == 0.0
        assert torch.equal(out.logits, pre.logits)
    with pytest.raises(ValueError, match="mode"):
        transformer.forward(model, cfg, toks, mode="encode")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_live_on_cpu(arch):
    """``serve_lm --live --reduced --device cpu``: the demo's checks hold
    (they raise otherwise), the CPU launches no kernel, and the report
    carries every step's logits."""
    rep = serve_lm.main(["--live", "--reduced", "--device", "cpu", "--arch",
                         arch, "--batch", "2", "--prompt-len", "20",
                         "--gen-len", "5"])
    assert isinstance(rep, serve_lm.LiveReport)
    assert tuple(rep.tokens.shape) == (2, 6)
    assert tuple(rep.step_logits.shape)[:2] == (6, 2)
    assert torch.equal(rep.step_logits.argmax(-1).T, rep.tokens)
    assert rep.launches["prefill"] == {"flash_attention": 0, "ssd_scan": 0}
    assert len(rep.decode_ms) == 5 and rep.peak_bytes is None


def test_serve_lm_live_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(["--live", "--reduced"])
