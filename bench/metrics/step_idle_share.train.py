"""The share of the traced window in which the device sat idle while the
host was inside a ``train.step`` span (on the trace's clock); the rest
of ``idle_share.train`` lies outside the step (the harness's loop, a
``host.gc`` pause between steps). None where the program records no such
spans, or they were dropped or do not align with the trace."""

from bench.program_spans import idle_inside

UNIT = "%"


def read(ctx):
    return idle_inside(ctx, "train_tokens_per_s", "train.step")
