"""The train step's share of the bf16 peak: the forward's and the
backward's operations (three times the forward's; remat's recomputation
not counted) of the traced steps over the traced window."""

from bench.peaks import PEAK

UNIT = "%"


def read(ctx):
    w = ctx.work
    if ctx.e2e != "train_tokens_per_s" or ctx.trace is None or \
            "train_ops" not in w:
        return None
    return 100.0 * w["train_ops"] * w["steps"] / ctx.trace.window_s / \
        PEAK[w["precision"]]
