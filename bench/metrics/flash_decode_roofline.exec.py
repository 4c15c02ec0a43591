"""The flash decode kernel's share of its roofline over the traced
steps: each instance's q, K, V and output at HBM rate (or its operations
at the TF32 peak, if larger) over the kernel's device time."""

from bench.peaks import bound_s, flash_decode

UNIT = "%"


def read(ctx):
    shapes = [s[:5] for s in ctx.work.get("flash", ()) if not s[5]]
    if ctx.e2e != "exec_step_ms" or ctx.trace is None or not shapes:
        return None
    t = ctx.trace.device_s(lambda n: "flash_decode_kernel" in n)
    if t <= 0:
        return None
    need = sum(bound_s(*flash_decode(b, lq, lk, h, hd), "tf32")
               for b, lq, lk, h, hd in shapes)
    return 100.0 * need * ctx.work["steps"] / t
