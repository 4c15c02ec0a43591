"""What the per-layer metrics read of the program's own spans
(`repro_torch.runtime.spans`): the spans on the traced window's clock,
their device time by name, and the device's idle time while the host
was inside them. Every reader returns None in another cell, without a
trace, for a program that records no spans, and where spans were
dropped or do not align with the trace."""

from bench.trace import _merged


def aligned(ctx, e2e: str):
    """The program's spans on ``ctx.trace``'s clock in a cell whose
    end-to-end metric is ``e2e``, or None."""
    if ctx.e2e != e2e or ctx.trace is None:
        return None
    try:
        from repro_torch.runtime import spans
    except ImportError:             # a program without spans
        return None
    return None if spans.dropped() else spans.align(ctx.trace.host)


def device_s(got, name: str) -> float:
    """The summed device time, start to end, of the spans ``name``."""
    return sum(s.device_end - s.device_start for s in got or ()
               if s.name == name and s.device_start is not None)


def device_share(ctx, e2e: str, part: str, whole: str):
    """The spans ``part``'s device time over the spans ``whole``'s, in
    %."""
    got = aligned(ctx, e2e)
    p, w = device_s(got, part), device_s(got, whole)
    return 100.0 * p / w if p and w else None


def idle_inside(ctx, e2e: str, name: str):
    """The share of the window, in %, in which the device sat idle while
    the host was inside a span ``name``."""
    host = [(s.host_start, s.host_end) for s in aligned(ctx, e2e) or ()
            if s.name == name]
    if not host:
        return None
    tr = ctx.trace
    gaps, t = [], 0.0
    for s, e in _merged(tr.device):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < tr.window_s:
        gaps.append((t, tr.window_s))
    return 100.0 * overlap_s(gaps, host) / tr.window_s


def overlap_s(a, b) -> float:
    """The length of the intersection of two sets of (start, end)
    intervals."""
    a = _merged(("", s, e) for s, e in a)
    b = _merged(("", s, e) for s, e in b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
