"""matmul_int8's share of its roofline over the traced steps: the least
time of every instance (`bench/peaks.py:matmul_int8`, int8 peak or HBM)
over the device time of the matmul_int8 kernel and its split-K reduce."""

from bench.peaks import bound_s, matmul_int8

UNIT = "%"
NAMES = ("matmul_int8_kernel", "split_k_reduce_kernel")


def read(ctx):
    shapes = ctx.work.get("matmul_int8")
    if ctx.e2e != "exec_step_ms" or ctx.trace is None or not shapes:
        return None
    t = ctx.trace.device_s(lambda n: any(k in n for k in NAMES))
    if t <= 0:
        return None
    need = sum(bound_s(*matmul_int8(*s), "int8") for s in shapes)
    return 100.0 * need * ctx.work["steps"] / t
