"""The prefill's share of the float32 peak: the operations each batch
needs (every block over every token, the causal attention, the LM head
over the last position only) over the traced window, against 67 TFLOP/s
(float32 with TF32 off)."""

from bench.peaks import PEAK

UNIT = "%"


def read(ctx):
    w = ctx.work
    if ctx.e2e != "ttft_ms_p95" or ctx.trace is None or \
            "prefill_ops" not in w:
        return None
    return 100.0 * w["prefill_ops"] / ctx.trace.window_s / \
        PEAK[w["precision"]]
