"""Device ms a plan step inside the ``matmul_int8.quantize`` spans: each
span's device start to its device end on the trace's clock (the
quantization's passes and the idle between them), summed over the traced
steps and divided by their count. None where the program records no such
spans, or they were dropped or do not align with the trace."""

from bench.program_spans import aligned, device_s

UNIT = "ms"


def read(ctx):
    t = device_s(aligned(ctx, "exec_step_ms"), "matmul_int8.quantize")
    return 1e3 * t / ctx.work["steps"] if t else None
