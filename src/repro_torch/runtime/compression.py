"""Gradient compression for the cross-pod hop: int8 quantization with
error feedback (the residual carried across steps). The reference uses it
when its mesh has a ``pod`` axis; here, on one device, it is simulated
faithfully: quantize, dequantize, and keep what was lost for the next
step. Gradients and residuals are mappings from the model's dotted
parameter names to tensors, as in `repro_torch.train.optimizer`.

The scale is one per tensor, ``max(amax, 1e-8) / 127``, and the codes
round half to even (``torch.round``, as ``jnp.round``), so they are the
reference's bit for bit.
"""

from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.param_names import reference_leaf


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(amax, 1e-8) / 127.0


def _codes(x32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor):
    """Returns (int8 codes in [-127, 127], the float32 scale, 0-d)."""
    x32 = x.to(torch.float32)
    scale = _scale(torch.amax(torch.abs(x32)))
    return _codes(x32, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def compress_grads_with_feedback(grads: Mapping[str, torch.Tensor],
                                 residuals: Mapping[str, torch.Tensor]):
    """Returns (the decompressed grads as they would arrive after the
    all-reduce, in each gradient's dtype; the new float32 residuals).
    Error feedback: residual = (g + r) - Q(g + r). The tensors that are
    slices of one leaf of the reference's tree share one scale, as the
    reference scales each stacked leaf of its layer stacks as one tensor
    (`param_names.reference_leaf`)."""
    leaves: dict[str, list[str]] = {}
    for name in grads:
        leaves.setdefault(reference_leaf(name), []).append(name)
    out, new_res = {}, {}
    for names in leaves.values():
        g32 = {n: grads[n].to(torch.float32) + residuals[n] for n in names}
        scale = _scale(torch.amax(torch.stack(
            [torch.amax(torch.abs(t)) for t in g32.values()])))
        for n, t in g32.items():
            deq = dequantize_int8(_codes(t, scale), scale)
            out[n] = deq.to(grads[n].dtype)
            new_res[n] = t - deq
    return out, new_res


def init_residuals(params: Mapping[str, torch.Tensor]) -> dict:
    return {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for name, p in params.items()}
