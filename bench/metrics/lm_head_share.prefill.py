"""The share of the prefill's device time in the LM head: the
``model.lm_head`` spans' device time (start to end on the trace's clock)
over the ``serve.prefill`` spans'. None where the program records no
such spans, or they were dropped or do not align with the trace."""

from bench.program_spans import device_share

UNIT = "%"


def read(ctx):
    return device_share(ctx, "ttft_ms_p95", "model.lm_head",
                        "serve.prefill")
