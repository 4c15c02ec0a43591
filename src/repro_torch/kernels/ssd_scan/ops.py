"""Public op: SSD intra-chunk over the (B, NC, Q, H, ...) layout.

The reference folds every operand to (B*NC*H, Q, .) with a transpose and
a full copy before its kernel; this kernel reads the (B, NC, Q, H, .)
layout in place through its strides and writes y in it, so the public op
is the kernel's wrapper itself."""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import \
    ssd_intra_chunk_bcqh as ssd_intra_chunk


def ssd_intra_chunk_and_ref(c: torch.Tensor, b: torch.Tensor,
                            s: torch.Tensor, dt: torch.Tensor,
                            x: torch.Tensor, *, block_t: int | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel (query tiles of ``block_t`` rows) and plain oracle on
    identical inputs — the executor's per-invocation numerics check
    (`core/executor.py`). Returns ``(kernel, ref)``."""
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref
    return (ssd_intra_chunk(c, b, s, dt, x, block_t=block_t),
            ssd_intra_chunk_ref(c, b, s, dt, x))
