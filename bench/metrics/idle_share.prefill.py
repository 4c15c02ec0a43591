"""The device's idle share of the traced window: one minus the union of
its operations' intervals over the window's length."""

UNIT = "%"


def read(ctx):
    if ctx.e2e != "ttft_ms_p95" or ctx.trace is None:
        return None
    return 100.0 * ctx.trace.idle_share()
