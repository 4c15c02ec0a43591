"""The share of the traced window in which the device sat idle while the
host was inside a ``matmul_int8.quantize`` span (the spans' host times
on the trace's clock): the idle that the quantization's dispatch holds.
None where the program records no such spans, or they were dropped or
do not align with the trace."""

from bench.program_spans import idle_inside

UNIT = "%"


def read(ctx):
    return idle_inside(ctx, "exec_step_ms", "matmul_int8.quantize")
