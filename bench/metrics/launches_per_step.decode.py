"""Kernels launched a decode step: the kernels (not copies or fills) of
the traced window over its steps."""

UNIT = "launches"


def read(ctx):
    if ctx.e2e != "itl_ms_p95" or ctx.trace is None:
        return None
    n = ctx.trace.count(lambda n: not n.startswith(("Memcpy", "Memset")))
    return n / ctx.work["steps"]
