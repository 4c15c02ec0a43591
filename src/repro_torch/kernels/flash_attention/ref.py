"""Plain PyTorch oracle for flash attention: what every kernel launch is
checked against, and what the wrapper runs on CPU tensors.

On CUDA the two products run in full float32: the oracle's callers leave
``torch.backends.cuda.matmul.allow_tf32`` at its default, False."""

import math

import torch


def attention_ref(q, k, v, causal=True):
    """q,k,v: (B, L, H, hd) -> (B, L, H, hd)."""
    hd = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(hd)
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        mask = torch.arange(lk, device=q.device)[None, :] <= \
            torch.arange(lq, device=q.device)[:, None]
        s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p,
                        v.to(torch.float32)).to(q.dtype)
