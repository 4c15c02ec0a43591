"""Public flash-attention op over (B, L, H, hd) layout."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (BK_TILES, BQ_TILES,
                                                        flash_attention_blhd)


def legal_block(l: int, requested: int, tiles=BQ_TILES) -> int:
    """The kernel tile to use for a length-``l`` axis when ``requested`` is
    asked for: the smallest tile <= ``requested`` that covers ``l``, else
    the largest tile <= ``requested`` (the smallest tile if none is).
    Unlike the TPU kernel's exact-divisor blocks, a tile need not divide
    ``l`` (the kernel masks the ragged tail), so L = 264 or a decode step
    with l = 1 take a tile straight from the set."""
    fit = [t for t in tiles if t <= requested] or [min(tiles)]
    covering = [t for t in fit if t >= l]
    return min(covering) if covering else max(fit)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 256,
                    block_k: int = 256) -> torch.Tensor:
    """q, k, v: (B, L, H, hd) with H already GQA-expanded. The reference's
    (B, L, H, hd) -> (B*H, L, hd) fold is the kernel's row indexing; block
    sizes are clamped into the kernel's tile set (`legal_block`)."""
    return flash_attention_blhd(
        q, k, v, causal=causal,
        block_q=legal_block(q.shape[1], block_q, BQ_TILES),
        block_k=legal_block(k.shape[1], block_k, BK_TILES))
