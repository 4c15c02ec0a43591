"""Spans inside the port, on the profiler's clock.

``with span("train.forward"):`` marks a stretch of the program. A span
records only while a ``torch.profiler`` session runs (a benchmark's
traced window, or an operator's own profile); at any other time
``span`` reads one attribute and returns one shared no-op context: it
allocates nothing, makes no CUDA call and never synchronises.

While on, a span keeps its name, its id, the id of the span open around
it (``parent``), the id of its outermost span (``root``: the spans of
one step or call share it), and a host start and end from
``time.time_ns()``, the clock the profiler's events are converted to.
Once CUDA is up, a span also records a timing ``torch.cuda.Event`` at
each end, on the stream current when its outermost span opened (events
come from a pool reused across ``reset``). The event records are the
anchors: each is a ``cudaEventRecord`` call among the profiler's host
events, so `align` can put every span on the trace's clock. Device times
are read only once the window has been synchronised. Garbage collections
while on are spans of their own, ``host.gc``.

Spans accumulate until `reset`; at most ``CAP`` are kept and the rest
are counted in `dropped`. Spans are opened and closed on one thread.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

#: Spans kept in memory at most.
CAP = 1 << 16
#: The runtime calls an anchor appears as among the profiler's host
#: events (``cudaEventRecordWithFlags`` in PyTorch 2.11).
ANCHORS = ("cudaEventRecord", "cudaEventRecordWithFlags")


class Record:
    """One span as recorded: host times in ns of ``time.time_ns()``
    (``host_end`` None while it is open), the timing events at its ends
    on the card (None off it)."""

    __slots__ = ("name", "id", "parent", "root", "host_start", "host_end",
                 "start_event", "end_event")

    def __init__(self, name, host_start):
        self.name, self.host_start, self.host_end = name, host_start, None
        self.id = self.parent = self.root = None
        self.start_event = self.end_event = None


class Aligned(NamedTuple):
    """A span on the trace's clock: seconds from the trace window's
    start, the device times None for a span with no events."""
    name: str
    id: int
    parent: int | None
    root: int
    host_start: float
    host_end: float
    device_start: float | None
    device_end: float | None


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


OFF = _Off()


class _Open:
    __slots__ = ("tracer", "name", "rec")

    def __init__(self, tracer, name):
        self.tracer, self.name, self.rec = tracer, name, None

    def __enter__(self):
        self.rec = self.tracer.open(self.name)

    def __exit__(self, *exc):
        if self.rec is not None:
            self.tracer.close(self.rec)


def _current_stream(last):
    """The current CUDA stream (None before CUDA is up): ``last`` where
    it still is, without building another ``Stream``."""
    if last is not None and last.cuda_stream == \
            torch._C._cuda_getCurrentRawStream(last.device_index):
        return last
    return torch.cuda.current_stream() if torch.cuda.is_initialized() \
        else None


class Tracer:
    """The spans of one process: records, anchors and the event pool."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.pool: list = []
        self.gc_hooked = False
        self.reset()

    def reset(self) -> None:
        self.records: list[Record] = []
        #: (host stamp in ns, event) of each event record, in call order
        self.anchors: list = []
        self.dropped = 0
        self.stack: list[Record] = []
        self.stream = None              # of the last outermost span
        self.gc_start = None

    def _add(self, name: str, host_start: int) -> Record | None:
        if len(self.records) >= self.cap:
            self.dropped += 1
            return None
        rec = Record(name, host_start)
        # a collection may run while the record is allocated and add its
        # own: the id is taken only now, with nothing allocated before
        # the append
        rec.id = len(self.records)
        self.records.append(rec)
        top = self.stack[-1] if self.stack else None
        rec.parent = top.id if top is not None else None
        rec.root = top.root if top is not None else rec.id
        return rec

    def _record(self):
        n = len(self.anchors)
        if n == len(self.pool):
            self.pool.append(torch.cuda.Event(enable_timing=True))
        ev = self.pool[n]
        self.anchors.append((time.time_ns(), ev))
        ev.record(self.stream)
        return ev

    def open(self, name: str) -> Record | None:
        if not self.gc_hooked:
            gc.callbacks.append(self._on_gc)
            self.gc_hooked = True
        rec = self._add(name, time.time_ns())
        if rec is None:
            return None
        if not self.stack:
            self.stream = _current_stream(self.stream)
        if self.stream is not None:
            rec.start_event = self._record()
        self.stack.append(rec)
        return rec

    def close(self, rec: Record) -> None:
        if rec.start_event is not None:
            rec.end_event = self._record()
        rec.host_end = time.time_ns()
        if self.stack and self.stack[-1] is rec:
            self.stack.pop()

    def _on_gc(self, phase: str, info: dict) -> None:
        """A collection's pause as ``host.gc``, while the profiler runs
        (the hook stays installed and reads one attribute otherwise)."""
        if phase == "start":
            self.gc_start = time.time_ns() if \
                _profiler._is_profiler_enabled else None
        elif self.gc_start is not None:
            rec = self._add("host.gc", self.gc_start)
            if rec is not None:
                rec.host_end = time.time_ns()
            self.gc_start = None

    def align(self, host_events) -> list[Aligned] | None:
        """The closed spans on the clock of a trace whose host events
        ``host_events`` are (name, start s, end s) from its window's
        start, or None where the anchors and the trace's anchor calls
        differ in number (nothing is guessed).

        The n-th anchor is the n-th call; the host offset is the median
        of (stamp - call start). A device time is the first anchor's
        device time plus its elapsed time to that event; the first
        anchor's is the latest (call start - elapsed time) over the
        anchors, since no event runs before its call begins and one
        recorded on an idle stream runs at once."""
        calls = [s for n, s, _ in host_events if n in ANCHORS]
        if not self.anchors or len(calls) != len(self.anchors):
            return None
        offset = round(statistics.median(
            stamp - round(c * 1e9) for (stamp, _), c in
            zip(self.anchors, calls)))
        first = self.anchors[0][1]
        el = [first.elapsed_time(ev) * 1e-3 for _, ev in self.anchors]
        d0 = max(c - x for c, x in zip(calls, el))
        dev = {id(ev): d0 + x for (_, ev), x in zip(self.anchors, el)}
        out = []
        for r in self.records:
            if r.host_end is None:
                continue
            ds = de = None
            if r.end_event is not None:
                ds, de = dev[id(r.start_event)], dev[id(r.end_event)]
            out.append(Aligned(r.name, r.id, r.parent, r.root,
                               (r.host_start - offset) * 1e-9,
                               (r.host_end - offset) * 1e-9, ds, de))
        return out


TRACER = Tracer()


def span(name: str):
    """A context that records the block as the span ``name`` while a
    profiler session runs, and the shared no-op otherwise."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _Open(TRACER, name)


def records() -> list[Record]:
    """The spans kept, in the order they were opened."""
    return list(TRACER.records)


def dropped() -> int:
    """Spans not kept since the last `reset`, past ``CAP``."""
    return TRACER.dropped


def reset() -> None:
    TRACER.reset()


def align(host_events) -> list[Aligned] | None:
    """`Tracer.align` of the process's spans."""
    return TRACER.align(host_events)

