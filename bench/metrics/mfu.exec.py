"""The whole plan step's share of the int8 peak: every matmul instance's
2 m k n and every attention instance's operations (a causal one's over
the pairs its mask leaves), over the traced window, against 1,979
TOP/s."""

from bench.peaks import PEAK, flash_decode, flash_prefill

UNIT = "%"


def read(ctx):
    w = ctx.work
    if ctx.e2e != "exec_step_ms" or ctx.trace is None or \
            "matmul_int8" not in w:
        return None
    ops = sum(2.0 * m * k * n for m, k, n in w["matmul_int8"]) + sum(
        flash_prefill(b, lq, h, hd)[0] if causal else
        flash_decode(b, lq, lk, h, hd)[0]
        for b, lq, lk, h, hd, causal in w["flash"])
    return 100.0 * ops * w["steps"] / ctx.trace.window_s / PEAK["int8"]
