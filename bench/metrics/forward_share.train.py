"""The share of the train step's device time in its ``train.forward``
spans: their device time (start to end on the trace's clock) over the
``train.step`` spans'. None where the program records no such spans, or
they were dropped or do not align with the trace."""

from bench.program_spans import device_share

UNIT = "%"


def read(ctx):
    return device_share(ctx, "train_tokens_per_s", "train.forward",
                        "train.step")
