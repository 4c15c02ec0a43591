"""The flash prefill kernel's share of its roofline over the traced
batches: each causal attention's operations at the TF32 peak (the float32
path runs on the tensor cores in TF32) or its q, K, V and output at HBM
rate, whichever is larger, over the kernel's device time."""

from bench.peaks import bound_s, flash_prefill

UNIT = "%"


def read(ctx):
    shapes = ctx.work.get("flash_prefill")
    if ctx.e2e != "ttft_ms_p95" or ctx.trace is None or not shapes:
        return None
    t = ctx.trace.device_s(lambda n: "flash_prefill_kernel" in n)
    if t <= 0:
        return None
    need = sum(bound_s(*flash_prefill(b, l, h, hd), "tf32")
               for b, l, h, hd in shapes)
    return 100.0 * need / t
