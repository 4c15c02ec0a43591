"""The share of the plan step's device time outside the matmul_int8 and
flash_attention kernels: the quantization's elementwise passes inside
each matmul op."""

UNIT = "%"
KERNELS = ("matmul_int8_kernel", "split_k_reduce_kernel", "flash_decode_kernel",
           "flash_prefill_kernel")


def read(ctx):
    if ctx.e2e != "exec_step_ms" or ctx.trace is None:
        return None
    total = ctx.trace.device_s()
    other = ctx.trace.device_s(lambda n: not any(k in n for k in KERNELS))
    return 100.0 * other / total
