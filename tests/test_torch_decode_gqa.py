"""The live decode step's attention over the KV cache's own heads
(`models.attention.grouped_decode_attention`): the decode branch of
`attention.attention` on plain tensors against the expanded form computed
here (`_repeat_kv` to every query head, then `dot_attention`), as the
branch ran before the grouped form. The new cache is bit-equal; the
output agrees to 1e-6 of its largest magnitude in float32; no tensor of
the expanded (B, S, H, hd) shape is built (`_repeat_kv` raises while the
branch runs, and a dispatch mode records every op's output shape).

The ``gpu`` test runs the same comparison at glm4-9b's widths on the card,
and holds the decode step's peak memory, at 2 layers, under the expanded
form's by at least one expanded K/V tensor."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models import attention
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import apply_rope, dense

THETA = 10000.0
KV_HEADS = 2
LENGTHS = {"ragged": lambda s: (3, 0, s - 1, s),     # s: the write dropped
           "uniform": lambda s: (s // 2,) * 4}


class _Shapes(TorchDispatchMode):
    """Every op's output shapes while it is on."""

    def __enter__(self):
        self.seen = set()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.seen.add(tuple(t.shape))
        return out


def _expanded(q, k, v, kv_length, rep, repeat):
    """The decode branch's attention as it was: the KV heads repeated to
    every query head, then `dot_attention`."""
    return attention.dot_attention(q, repeat(k, rep), repeat(v, rep),
                                   causal=False, kv_length=kv_length)


def _case(device, rep, quant, lengths, *, s=16, hd=8, seed=0):
    """A layer's parameters (the output projection the identity, so the
    layer's output is the attention's), a cache holding random keys and
    values in each row's first ``lengths`` positions, and one token."""
    h = KV_HEADS * rep
    d = h * hd
    g = torch.Generator(device).manual_seed(seed)
    p = attention.init_attention(g, d, h, KV_HEADS, hd, device=device)
    with torch.no_grad():
        p.wo.w.copy_(torch.eye(d, device=device))
    b = len(lengths)
    length = torch.tensor(lengths, dtype=torch.int32, device=device)
    live = (torch.arange(s, device=device)[None, :] <
            length[:, None])[:, :, None, None]
    k, v = (torch.randn(b, s, KV_HEADS, hd, generator=g, device=device) *
            live for _ in range(2))
    if quant:
        (qk, sk), (qv, sv) = attention.quantize_kv(k), attention.quantize_kv(v)
        cache = KVCache(k=qk, v=qv, length=length, k_scale=sk * live,
                        v_scale=sv * live)
    else:
        cache = KVCache(k=k, v=v, length=length)
    x = torch.randn(b, 1, d, generator=g, device=device)
    return p, cache, x, dict(n_heads=h, n_kv_heads=KV_HEADS, head_dim=hd,
                             rope_theta=THETA)


def _want(p, cache, x, kw, repeat):
    """The new cache (each row's new key and value written at its length
    unless the length is the cache's size) and the expanded form's
    output."""
    b = x.shape[0]
    h, kv, hd = kw["n_heads"], kw["n_kv_heads"], kw["head_dim"]
    pos = cache.length[:, None]
    q = apply_rope(dense(p.wq, x).reshape(b, 1, h, hd), pos, THETA)
    k = apply_rope(dense(p.wk, x).reshape(b, 1, kv, hd), pos, THETA)
    v = dense(p.wv, x).reshape(b, 1, kv, hd)
    fields = dict(k=cache.k.clone(), v=cache.v.clone(),
                  length=cache.length + 1)
    rows = [(i, n) for i, n in enumerate(cache.length.tolist())
            if n < cache.k.shape[1]]
    if cache.k_scale is None:
        new = {"k": k, "v": v}
    else:
        (qk, sk), (qv, sv) = attention.quantize_kv(k), attention.quantize_kv(v)
        new = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
        fields.update(k_scale=cache.k_scale.clone(),
                      v_scale=cache.v_scale.clone())
    for name, t in new.items():
        for i, n in rows:
            fields[name][i, n] = t[i, 0]
    want = KVCache(**fields)
    if cache.k_scale is None:
        kf, vf = want.k, want.v
    else:
        kf = attention.dequantize_kv(want.k, want.k_scale, x.dtype)
        vf = attention.dequantize_kv(want.v, want.v_scale, x.dtype)
    out = _expanded(q, kf, vf, want.length, h // kv, repeat)
    return out.reshape(b, 1, h * hd), want


def _hold(device, monkeypatch, rep, quant, lengths, **case):
    p, cache, x, kw = _case(device, rep, quant, lengths, **case)
    repeat = attention._repeat_kv

    def refuse(*_):
        raise AssertionError("the cache expanded to every query head")

    monkeypatch.setattr(attention, "_repeat_kv", refuse)
    calls = dict(attention.decode_attention_calls)
    with torch.no_grad(), _Shapes() as shapes:
        out, new = attention.attention(p, x, cache=cache, **kw)
    monkeypatch.setattr(attention, "_repeat_kv", repeat)
    assert attention.decode_attention_calls == {
        "grouped": calls["grouped"] + 1, "expanded": calls["expanded"]}
    b, s, _, hd = cache.k.shape
    if rep > 1:
        assert (b, s, kw["n_heads"], hd) not in shapes.seen
    with torch.no_grad():
        want_out, want = _want(p, cache, x, kw, repeat)
    for name, t in want._asdict().items():
        got = getattr(new, name)
        assert (got is None) == (t is None), name
        assert t is None or (got.dtype == t.dtype and torch.equal(got, t)), \
            name
    err = (out - want_out).abs().max().item()
    assert err <= 1e-6 * want_out.abs().max().item(), err


@pytest.mark.parametrize("lengths", sorted(LENGTHS))
@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("rep", [1, 4, 16])
def test_decode_grouped_matches_expanded(monkeypatch, rep, quant, lengths):
    """Query heads per KV head 1 (MHA: the product batched over the
    heads), 4 and 16 (glm4-9b's), the plain and the int8 cache, lengths
    ragged across the batch (one row empty, one at the cache's size) or
    equal."""
    _hold(torch.device("cpu"), monkeypatch, rep, quant,
          LENGTHS[lengths](16))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (cuBLAS's strided products and "
                    "the card's memory counters)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_decode_grouped_on_card(cuda, monkeypatch):
    """glm4-9b's attention widths (32 query heads over 2 KV heads of 128)
    at 8 sessions over a 2,048-position float32 cache: the comparison
    above on two layers' draws; then the decode step of glm4-9b cut to 2
    layers, whose peak memory stays under the expanded form's by at least
    one expanded K/V tensor, its logits within float32 rounding of it."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    from repro_torch.train import steps
    b, s = 8, 2048
    lengths = (1024, 0, s - 1, s, 1, 700, 1500, 2000)
    cfg = dataclasses.replace(get_config("glm4-9b"), n_layers=2)
    hd, h = cfg.resolved_head_dim, cfg.n_heads
    rep = h // cfg.n_kv_heads
    assert (cfg.n_kv_heads, rep, hd) == (KV_HEADS, 16, 128)
    for seed in range(2):
        _hold(cuda, monkeypatch, rep, False, lengths, s=s, hd=hd, seed=seed)

    g = torch.Generator(cuda).manual_seed(0)
    model = init_model(cfg, g, torch.float32, cuda)
    caches = steps.init_caches(cfg, b, s, torch.float32, cuda)
    length = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    live = (torch.arange(s, device=cuda)[None, :] <
            length[:, None])[None, :, :, None, None]
    caches = caches._replace(
        k=torch.randn(caches.k.shape, generator=g, device=cuda) * live,
        v=torch.randn(caches.v.shape, generator=g, device=cuda) * live,
        length=length.expand(cfg.n_layers, b).contiguous())
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, 1), device=cuda,
                                     generator=g)}
    step = steps.make_decode_step(cfg, steps.StepConfig(
        compute_dtype=torch.float32))

    def peak(calls):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = dict(attention.decode_attention_calls)
        logits, new = step(model, batch, caches)
        torch.cuda.synchronize()
        assert attention.decode_attention_calls[calls] == \
            before[calls] + cfg.n_layers
        return torch.cuda.max_memory_allocated() - base, logits, new

    grouped, logits, new = peak("grouped")
    repeat = attention._repeat_kv
    monkeypatch.setattr(
        attention, "grouped_decode_attention",
        lambda q, k, v, n: _expanded(q, k, v, n, rep, repeat))
    # the expanded form, counted as grouped: it runs in the grouped one's
    # place
    expanded, want_logits, want = peak("grouped")
    one = b * s * h * hd * 4
    assert grouped <= expanded - one, (grouped, expanded, one)
    assert torch.equal(new.k[0], want.k[0]) and torch.equal(new.v[0],
                                                            want.v[0])
    err = (logits - want_logits).abs().max().item()
    assert err <= 1e-5 * want_logits.abs().max().item(), err
