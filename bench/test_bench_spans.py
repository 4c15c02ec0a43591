"""The readers of the program's spans against counts worked out by hand:
synthetic span records (timing events whose device times are given) and
a synthetic trace, each metric in its cell, and None outside it, where
the spans do not align with the trace's anchor calls and where some
were dropped."""

import pytest

from bench import harness, program_spans
from bench.trace import Trace

spans = pytest.importorskip("repro_torch.runtime.spans")

OFFSET_NS = 7_000_000_000
ANCHOR = spans.ANCHORS[-1]


class _Event:
    def __init__(self, t_s):
        self.t = t_s

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


def _setup(monkeypatch, spec, device, window_s, steps):
    """Span records of ``spec``: (name, parent index or None, host start
    s, host end s, device start s, device end s), on host stamps
    ``OFFSET_NS`` past the trace's clock, with an event at each device
    end (none for a span whose device times are None); the tracer is
    the process's. Returns the trace: ``device`` (start s, end s) and
    the anchors' calls at the host stamps."""
    tr = spans.Tracer()
    anchors = []
    for i, (name, parent, hs, he, ds, de) in enumerate(spec):
        r = spans.Record(name, OFFSET_NS + round(hs * 1e9))
        r.host_end = OFFSET_NS + round(he * 1e9)
        r.id, r.parent = i, parent
        r.root = i if parent is None else tr.records[parent].root
        if ds is not None:
            r.start_event, r.end_event = _Event(ds), _Event(de)
            anchors += [(r.host_start, r.start_event),
                        (r.host_end, r.end_event)]
        tr.records.append(r)
    tr.anchors = sorted(anchors, key=lambda a: a[0])
    monkeypatch.setattr(spans, "TRACER", tr)
    host = [(ANCHOR, (st - OFFSET_NS) * 1e-9, (st - OFFSET_NS) * 1e-9 + 1e-6)
            for st, _ in tr.anchors]
    return Trace(window_s, [("k", s, e) for s, e in device], host, steps)


def _read(name, e2e, trace):
    mod = harness.load_module("metrics", name)
    steps = trace.steps if trace is not None else 1
    return mod.read(harness.Context(e2e, trace, {"steps": steps}, {}))


def _faults(monkeypatch, name, e2e, trace):
    """None outside the cell, with one anchor call missing, with a span
    dropped, and with no spans at all."""
    assert _read(name, "no_such_metric", trace) is None
    assert _read(name, e2e, None) is None
    host = list(trace.host)
    host.remove(next(h for h in host if h[0] == ANCHOR))
    assert _read(name, e2e, Trace(trace.window_s, trace.device, host,
                                  trace.steps)) is None
    tr = spans.TRACER
    tr.dropped = 1
    assert _read(name, e2e, trace) is None
    tr.dropped = 0
    monkeypatch.setattr(spans, "TRACER", spans.Tracer())
    assert _read(name, e2e, trace) is None
    monkeypatch.setattr(spans, "TRACER", tr)


def test_quantize_readers(monkeypatch):
    # two plan steps of one matmul op each; the first quantization runs
    # 0-50 ms on the device (its pass ends after the span's host end)
    trace = _setup(monkeypatch, [
        ("matmul_int8.quantize", None, 0.00, 0.04, 0.000, 0.050),
        ("matmul_int8.quantize", None, 0.10, 0.14, 0.100, 0.140),
    ], [(0.010, 0.050), (0.050, 0.055), (0.120, 0.130), (0.145, 0.200)],
        0.25, 2)
    # 50 + 40 ms of device time over 2 steps
    assert _read("quantize_ms.exec", "exec_step_ms", trace) == \
        pytest.approx(45.0)
    # idle 0-10, 55-120, 130-145, 200-250 ms; inside the spans' host
    # times 0-10, 100-120, 130-140: 40 ms of 250
    assert _read("quantize_idle_share.exec", "exec_step_ms", trace) == \
        pytest.approx(100 * 0.04 / 0.25)
    for name in ("quantize_ms.exec", "quantize_idle_share.exec"):
        _faults(monkeypatch, name, "exec_step_ms", trace)


def test_train_readers(monkeypatch):
    trace = _setup(monkeypatch, [
        ("train.step", None, 0.0, 0.5, 0.0, 0.5),
        ("train.forward", 0, 0.0, 0.1, 0.0, 0.12),
        ("host.gc", 1, 0.05, 0.06, None, None),
        ("train.backward", 0, 0.1, 0.3, 0.12, 0.35),
        ("train.optimizer", 0, 0.3, 0.5, 0.35, 0.5),
        ("train.step", None, 0.6, 1.0, 0.6, 1.0),
        ("train.forward", 5, 0.6, 0.7, 0.6, 0.7),
        ("train.backward", 5, 0.7, 0.9, 0.7, 0.92),
        ("train.optimizer", 5, 0.9, 1.0, 0.92, 1.0),
    ], [(0.02, 0.12), (0.15, 0.45), (0.62, 0.70), (0.71, 1.0)], 1.1, 2)
    e2e = "train_tokens_per_s"
    # forward 120 + 100 ms, AdamW 150 + 80, of the steps' 500 + 400
    assert _read("forward_share.train", e2e, trace) == \
        pytest.approx(100 * 220 / 900)
    assert _read("optimizer_share.train", e2e, trace) == \
        pytest.approx(100 * 230 / 900)
    # idle 0-20, 120-150, 450-620, 700-710, 1000-1100 ms; inside the
    # steps' host times 0-20, 120-150, 450-500, 600-620, 700-710: 130 ms
    # of 1,100
    assert _read("step_idle_share.train", e2e, trace) == \
        pytest.approx(100 * 0.13 / 1.1)
    for name in ("forward_share.train", "optimizer_share.train",
                 "step_idle_share.train"):
        _faults(monkeypatch, name, e2e, trace)


def test_prefill_reader(monkeypatch):
    trace = _setup(monkeypatch, [
        ("serve.prefill", None, 0.0, 0.2, 0.0, 1.0),
        ("model.lm_head", 0, 0.1, 0.15, 0.9, 1.0),
        ("serve.prefill", None, 1.2, 1.4, 1.2, 2.8),
        ("model.lm_head", 2, 1.3, 1.35, 2.5, 2.8),
    ], [(0.0, 1.0), (1.2, 2.8)], 2.8, 2)
    # the heads 100 + 300 ms of the prefills' 1,000 + 1,600
    assert _read("lm_head_share.prefill", "ttft_ms_p95", trace) == \
        pytest.approx(100 * 400 / 2600)
    _faults(monkeypatch, "lm_head_share.prefill", "ttft_ms_p95", trace)


def test_readers_without_spans_in_the_program(monkeypatch):
    """A program without ``repro_torch.runtime.spans`` (one older than
    the module): every reader of spans returns None."""
    import builtins
    real = builtins.__import__

    def blocked(name, *a, **k):
        if name.startswith("repro_torch.runtime"):
            raise ModuleNotFoundError(name)
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", blocked)
    trace = Trace(1.0, [("k", 0.0, 1.0)], [], 1)
    for name, e2e in (("quantize_ms.exec", "exec_step_ms"),
                      ("quantize_idle_share.exec", "exec_step_ms"),
                      ("forward_share.train", "train_tokens_per_s"),
                      ("optimizer_share.train", "train_tokens_per_s"),
                      ("step_idle_share.train", "train_tokens_per_s"),
                      ("lm_head_share.prefill", "ttft_ms_p95")):
        assert _read(name, e2e, trace) is None, name


def test_overlap_by_hand():
    assert program_spans.overlap_s([(0, 2), (3, 4)], [(1, 3.5)]) == \
        pytest.approx(1.5)
    # overlapping intervals on one side count once
    assert program_spans.overlap_s([(0, 1), (0.5, 2)], [(0, 3)]) == \
        pytest.approx(2.0)
    assert program_spans.overlap_s([], [(0, 1)]) == 0.0
