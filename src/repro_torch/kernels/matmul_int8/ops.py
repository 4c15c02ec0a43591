"""Public op: quantize-and-matmul with MIREDO-selected block shapes."""

from __future__ import annotations

import torch

from repro_torch.kernels.matmul_int8.kernel import (BK_TILES, BM_TILES,
                                                    BN_TILES, matmul_int8)
from repro_torch.kernels.matmul_int8.ref import (matmul_int8_ref,
                                                 quantize_rowwise)
from repro_torch.runtime.spans import span


def quantized_matmul(x: torch.Tensor, w: torch.Tensor, *,
                     block_shapes: tuple[int, int, int] | None = None,
                     use_kernel: bool = True,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """bf16/f32 (M,K) @ (K,N) via INT8 quantization (CIM-style W8A8).

    ``block_shapes`` come from the GPU bridge
    (core/gpu_bridge.py:select_blocks_from_mapping) and must lie in the
    kernel's tile set; they need not divide the dims, since the kernel
    masks ragged edges. On CUDA tensors this launches the kernel, on CPU
    tensors the plain version runs."""
    m, k = x.shape
    _, n = w.shape
    with span("matmul_int8.quantize"):
        x_q, x_s = quantize_rowwise(x, axis=1)
        w_q, w_s = quantize_rowwise(w, axis=0)
    if not use_kernel:
        return matmul_int8_ref(x_q, w_q, x_s, w_s, out_dtype)
    bm, bk, bn = block_shapes or default_blocks(m, k, n)
    return matmul_int8(x_q, w_q, x_s, w_s, bm=bm, bk=bk, bn=bn,
                       out_dtype=out_dtype)


def quantized_matmul_and_ref(x: torch.Tensor, w: torch.Tensor, *,
                             block_shapes: tuple[int, int, int] | None = None,
                             out_dtype=torch.float32
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel and plain oracle on identical quantized operands.

    The measured-execution backend (`core/executor.py`) checks every kernel
    invocation against its ``ref.py``; both paths quantize the same way, so
    the int32 accumulations are identical and only the final scale
    multiply can differ by float rounding. Returns ``(kernel, ref)``."""
    out = quantized_matmul(x, w, block_shapes=block_shapes, use_kernel=True,
                           out_dtype=out_dtype)
    ref = quantized_matmul(x, w, use_kernel=False, out_dtype=out_dtype)
    return out, ref


def default_blocks(m: int, k: int, n: int) -> tuple[int, int, int]:
    """Per dim, the smallest tile that covers it, else the largest tile."""
    def pick(d, tiles):
        return min([t for t in tiles if t >= d] or [max(tiles)])
    return pick(m, BM_TILES), pick(k, BK_TILES), pick(n, BN_TILES)
