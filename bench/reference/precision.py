"""The products of the references in a stated precision.

``f32``: float32 products with TF32 off. The controls, one step below
what a configuration states: ``tf32`` (operands rounded to TF32's 10-bit
mantissa, float32 sums: what the tensor cores do with TF32 on),
``fp8`` (operands scaled per tensor into float8 e4m3 and rounded there,
float32 sums; the gradient passes the rounding unchanged), ``int4``
(the executor's rowwise symmetric quantization at 4 bits in place of
8). The roundings are worked out element by element, so a control reads
the same on the CPU as on the card."""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("f32", "tf32", "fp8")
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """TF32 off for the block, as every reference product runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (ties away from zero),
    as float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x scaled by its largest magnitude into e4m3's range, rounded to
    float8 e4m3 and scaled back; the rounding passes gradients through."""
    scale = (x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX)
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * \
        scale
    return x + (q - x).detach()


def rounder(precision: str):
    if precision == "f32":
        return lambda x: x
    if precision == "tf32":
        return tf32_round
    if precision == "fp8":
        return fp8_round
    raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "f32"):
    """``a @ b`` in float32 sums over operands rounded to ``precision``."""
    r = rounder(precision)
    return torch.matmul(r(a.to(torch.float32)), r(b.to(torch.float32)))
