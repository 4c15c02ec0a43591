"""The share of the prefill's device time in the library's GEMM kernels
(cuBLAS and CUTLASS: names holding ``gemm``, ``xmma`` or ``cutlass``)."""

UNIT = "%"
MARKS = ("gemm", "xmma", "cutlass")


def is_gemm(name: str) -> bool:
    n = name.lower()
    return any(k in n for k in MARKS)


def read(ctx):
    if ctx.e2e != "ttft_ms_p95" or ctx.trace is None:
        return None
    return 100.0 * ctx.trace.device_s(is_gemm) / ctx.trace.device_s()
