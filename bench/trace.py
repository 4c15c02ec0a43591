"""The traced window: ``torch.profiler`` events kept in memory, reduced
to the device's busy time, each kernel's time by name and the idle gaps
by the host's CUDA runtime call under way when each began (none: the
host was in Python or in PyTorch between calls). Nothing is written to
disk."""

from __future__ import annotations

import contextlib
import dataclasses


@dataclasses.dataclass
class Trace:
    """The device's operations (kernels, copies, fills) and the host's
    CUDA runtime calls inside the window, as (name, start s, end s) with
    times from the window's start; ``steps`` units of work ran in it."""
    window_s: float
    device: list
    host: list
    steps: int

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(e - s for s, e in _merged(self.device))

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s

    def device_s(self, match=lambda name: True) -> float:
        """Summed device time of the operations whose name ``match``es."""
        return sum(e - s for n, s, e in self.device if match(n))

    def count(self, match) -> int:
        return sum(1 for n, _, _ in self.device if match(n))

    def top_ops(self, k: int = 10) -> list:
        by = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s)
        return [[n[:160], t] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The idle time of the device summed by the host's call under
        way when each gap began, the largest ``k``."""
        gaps, t = [], 0.0
        for s, e in _merged(self.device):
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.window_s:
            gaps.append((t, self.window_s))
        host = sorted(self.host, key=lambda x: x[1])
        active, i, by = [], 0, {}
        for g0, g1 in gaps:
            while i < len(host) and host[i][1] <= g0:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[2] >= g0]
            # the innermost call under way: the latest start not ended
            inner = max(active, key=lambda h: h[1])[0] if active else \
                "(between runtime calls)"
            by[inner] = by.get(inner, 0.0) + (g1 - g0)
        return [[n[:160], t] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def _merged(events):
    out = []
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Profiler:
    """``with profiler.window(steps):`` profiles the block and nothing
    else: CUDA activity only (the device's operations and the host's CUDA
    runtime calls, no per-op host recording, which would slow a
    host-paced step), synchronised at both ends. ``trace()`` reads it
    after the block."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.steps = 0

    @contextlib.contextmanager
    def window(self, steps: int):
        from torch.profiler import ProfilerActivity, profile
        sync = self.torch.cuda.synchronize if \
            self.torch.cuda.is_available() else (lambda: None)
        self.steps = steps
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as self.prof:
            sync()
            yield
            sync()

    def trace(self) -> Trace:
        """The window spans the profiled events, from the first
        synchronisation's call to the last's return."""
        from torch.autograd import DeviceType
        events = [e for e in self.prof.events()
                  if e.device_type in (DeviceType.CUDA, DeviceType.CPU)]
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        if not device:
            raise RuntimeError("no device operation in the traced window")
        w0 = min(e.time_range.start for e in events)
        w1 = max(e.time_range.end for e in events)
        at = lambda e: (e.name, (e.time_range.start - w0) / 1e6,
                        (e.time_range.end - w0) / 1e6)
        return Trace(window_s=(w1 - w0) / 1e6,
                     device=[at(e) for e in device],
                     host=[at(e) for e in events
                           if e.device_type == DeviceType.CPU],
                     steps=self.steps)
