"""The port's spans (`repro_torch.runtime.spans`): off outside a profiler
session (nothing recorded, no CUDA call), on inside one (the spans of
the train and prefill steps, the LM head and the quantized matmul nest
with the right parents and roots, on the clock of the profiler's
events), no change to any number the steps compute, garbage collections
and the cap, and `align` against a trace's ``cudaEventRecord`` calls. A reduced
minicpm-2b (2 layers, d 64) on the CPU, torch on one thread; the
``gpu`` test aligns spans with a CUDA-only profile on the card."""

import gc

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.matmul_int8.ops import quantized_matmul
from repro_torch.runtime import spans
from repro_torch.serve_lm import pad_caches
from repro_torch.train import optimizer, steps

TRAIN = ("train.step", "train.forward", "train.backward", "train.optimizer")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def fresh():
    spans.reset()
    yield
    spans.reset()


def _state(compress=False):
    cfg = get_config("minicpm-2b").reduced()
    scfg = steps.StepConfig(compute_dtype=torch.float32, remat=True,
                            compress_pod_grads=compress)
    return cfg, scfg, steps.init_train_state(3, cfg, scfg)


def _batch(cfg, seed=5, b=2, l=8):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (b, l + 1), generator=g)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _work(compress=False):
    """One train step, a prefill, a decode step on its padded caches,
    a quantized matmul and a flash attention: every output and the
    updated state."""
    cfg, scfg, state = _state(compress)
    step = steps.make_train_step(cfg, optimizer.OptimizerConfig(
        warmup_steps=1, total_steps=10), scfg)
    batch = _batch(cfg)
    state, met = step(state, batch)
    prefill = steps.make_prefill_step(cfg, scfg)
    decode = steps.make_decode_step(cfg, scfg)
    logits, caches = prefill(state.params, {"tokens": batch["tokens"]})
    nxt, _ = decode(state.params, {"tokens": logits.argmax(-1)[:, None]},
                    pad_caches(caches, 12, cfg.family))
    g = torch.Generator().manual_seed(7)
    x, w = torch.randn(8, 32, generator=g), torch.randn(32, 16, generator=g)
    q, k, v = (torch.randn(1, 8, 2, 16, generator=g) for _ in range(3))
    out = {"met": met, "logits": logits, "next": nxt,
           "mm": quantized_matmul(x, w, out_dtype=torch.float32),
           "attn": flash_attention(q, k, v, causal=True)}
    out.update({f"p.{n}": p for n, p in state.params.named_parameters()})
    out.update({f"m.{n}": t for n, t in state.opt.m.items()})
    out.update({f"v.{n}": t for n, t in state.opt.v.items()})
    if compress:
        out.update({f"r.{n}": t for n, t in state.residuals.items()})
    return out


class _NoCuda:
    def __init__(self, *a, **k):
        raise AssertionError("a span made a CUDA call while off")


def test_off_records_nothing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _NoCuda)
    assert spans.span("train.step") is spans.OFF
    _work(compress=True)
    assert spans.records() == [] and spans.dropped() == 0
    assert spans.TRACER.anchors == []


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def test_on_spans_nest():
    with profile(activities=[ProfilerActivity.CPU]):
        _work(compress=True)
    recs = spans.records()
    by = _by_name(recs)
    assert [r.id for r in recs] == list(range(len(recs)))
    for r in recs:
        assert r.host_start <= r.host_end
    (st,) = by["train.step"]
    assert st.parent is None and st.root == st.id
    phases = [by[n][0] for n in TRAIN[1:]]
    for r in phases:
        assert (r.parent, r.root) == (st.id, st.id), r.name
        assert st.host_start <= r.host_start <= r.host_end <= st.host_end
    for a, b in zip(phases, phases[1:]):      # in the step's order
        assert a.host_end <= b.host_start, (a.name, b.name)
    fwd = by["train.forward"][0]
    heads = by["model.lm_head"]
    (pre,) = by["serve.prefill"]
    # the LM head inside the train step's forward and the prefill; the
    # decode step's its own outermost span
    assert [(h.parent, h.root) for h in heads] == \
        [(fwd.id, st.id), (pre.id, pre.id), (None, heads[2].id)]
    for h, outer in zip(heads, (fwd, pre)):
        assert outer.host_start <= h.host_start <= h.host_end <= \
            outer.host_end
    assert pre.host_end <= heads[2].host_start
    (qz,) = by["matmul_int8.quantize"]
    assert qz.parent is None and qz.root == qz.id
    assert set(by) - {"host.gc"} == {*TRAIN, "serve.prefill",
                                     "model.lm_head", "matmul_int8.quantize"}
    # on the CPU: no events, no anchors
    assert all(r.start_event is None for r in recs)
    assert spans.TRACER.anchors == []


def test_span_on_the_profilers_clock():
    x = torch.randn(64, 64)
    w = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        quantized_matmul(x, w, out_dtype=torch.float32)
    (qz,) = [r for r in spans.records() if r.name == "matmul_int8.quantize"]
    t0 = prof.profiler.kineto_results.trace_start_ns()
    inside = [e for e in prof.events() if e.name == "aten::abs"]
    assert len(inside) >= 2                 # one per operand at least
    for e in inside:
        start = t0 + e.time_range.start * 1e3
        end = t0 + e.time_range.end * 1e3
        # the events' times are whole microseconds
        assert qz.host_start - 1e3 <= start <= end <= qz.host_end + 1e3


def test_spans_change_no_number():
    plain = _work(compress=True)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _work(compress=True)
    assert spans.records()
    for key, a in plain.items():
        b = traced[key]
        if isinstance(a, dict):
            for k in a:
                assert torch.equal(a[k], b[k]), (key, k)
        else:
            assert torch.equal(a, b), key


def test_gc_pause_and_cap(monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("outer"):
            gc.collect()
    by = _by_name(spans.records())
    (outer,) = by["outer"]
    pauses = [r for r in by["host.gc"] if r.parent == outer.id]
    assert pauses and all(outer.host_start <= r.host_start <= r.host_end
                          <= outer.host_end for r in pauses)
    # past the cap, spans are counted and not kept
    monkeypatch.setattr(spans, "TRACER", spans.Tracer(cap=3))
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for i in range(5):
                with spans.span(f"s{i}"):
                    pass
    finally:
        gc.enable()
    assert [r.name for r in spans.records()] == ["s0", "s1", "s2"]
    assert spans.dropped() == 2


class _Event:
    """A timing event at ``t`` ms on the device."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def test_align_by_hand():
    """Two spans, the second inside the first, with anchors 5 s of host
    clock past their calls' trace times. The device runs the second
    event as its call is made (the stream idle), the others after
    theirs (the stream busy)."""
    tr = spans.Tracer()
    off = 5_000_000_000
    a, b = spans.Record("a", 0), spans.Record("b", 0)
    calls = [0.010, 0.012, 0.020, 0.030]         # trace s of the 4 calls
    evs = [_Event(t) for t in (11.0, 12.0, 21.5, 31.0)]     # device ms
    a.id, a.parent, a.root, b.id, b.parent, b.root = 0, None, 0, 1, 0, 0
    a.start_event, b.start_event, b.end_event, a.end_event = evs
    stamps = [off + round(c * 1e9) for c in calls]
    a.host_start, b.host_start, b.host_end, a.host_end = stamps
    tr.records = [a, b]
    tr.anchors = list(zip(stamps, evs))
    anchor = spans.ANCHORS[-1]
    host = [("cudaLaunchKernel", 0.005, 0.006)] + \
        [(anchor, c, c + 2e-6) for c in calls]
    got = {s.name: s for s in tr.align(host)}
    assert got["a"].host_start == pytest.approx(0.010, abs=1e-9)
    assert got["a"].host_end == pytest.approx(0.030, abs=1e-9)
    assert (got["b"].parent, got["b"].root) == (0, 0)
    # the latest (call - elapsed) bound is the second event's, run at its
    # call: the first ran 1 ms before it, the third 9.5 ms after it
    assert got["a"].device_start == pytest.approx(0.011)
    assert got["b"].device_start == pytest.approx(0.012)
    assert got["b"].device_end == pytest.approx(0.0215)
    assert got["a"].device_end == pytest.approx(0.031)
    # a count of anchor calls that differs aligns nothing
    assert tr.align(host[:-1]) is None
    assert tr.align(host + [(anchor, 0.04, 0.04)]) is None
    assert spans.Tracer().align(host) is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_spans_align_on_card(cuda):
    """In a CUDA-only profile every anchor is matched, each aligned
    anchor call lies within 10 us of its stamp (its first record, which
    creates the event, within 200 us), each span's device interval holds
    the product launched inside it, and an event adds no device
    operation."""
    from torch.autograd import DeviceType
    x = torch.randn(2048, 2048, device=cuda)
    x @ x
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        for i in range(20):
            with spans.span("outer"):
                with spans.span("inner"):
                    x @ x
                if i % 4 == 0:
                    torch.cuda.synchronize()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type in (DeviceType.CUDA, DeviceType.CPU)]
    w0 = min(e.time_range.start for e in events)
    at = lambda e: (e.name, (e.time_range.start - w0) / 1e6,
                    (e.time_range.end - w0) / 1e6)
    host = [at(e) for e in events if e.device_type == DeviceType.CPU]
    device = sorted((at(e) for e in events
                     if e.device_type == DeviceType.CUDA),
                    key=lambda d: d[1])
    assert len(device) == 20
    got = spans.align(host)
    tr = spans.TRACER
    assert got is not None and len(got) == 40 and len(tr.anchors) == 80
    calls = sorted(s for n, s, _ in host if n in spans.ANCHORS)
    shift = got[0].host_start - tr.records[0].host_start * 1e-9
    resid = sorted(abs(stamp * 1e-9 + shift - c)
                   for (stamp, _), c in zip(tr.anchors, calls))
    assert resid[-1] <= 2e-4 and resid[len(resid) // 2] <= 1e-5
    inner = [a for a in got if a.name == "inner"]
    for a, (_, s, e) in zip(inner, device):
        assert a.device_start - 2e-5 <= s <= e <= a.device_end + 2e-5
