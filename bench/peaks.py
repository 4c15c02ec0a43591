"""The yardstick's constants and counts: one NVIDIA H100 SXM's published
dense peaks (NVIDIA's data sheet, at its 700 W limit) and the operations
and bytes that each kernel and each step need, worked out from shapes.

A roofline share is the least time the chip could take (the larger of
operations over the peak of the precision the kernel computes in, and
bytes over the memory bandwidth) over the kernel's device time. Bytes
count each input read once and each output written once."""

from __future__ import annotations

PEAK = {"bf16": 989e12, "fp8": 1979e12, "int8": 1979e12, "tf32": 495e12,
        "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float, precision: str) -> float:
    """The least time for ``ops`` operations and ``nbytes`` of traffic."""
    return max(ops / PEAK[precision], nbytes / HBM_BYTES_PER_S)


def matmul_int8(m: int, k: int, n: int) -> tuple[float, float]:
    """(operations, bytes) of one int8 product with its scale epilogue:
    x and w in int8, both scale vectors and the float32 output."""
    return 2.0 * m * k * n, float(m * k + k * n + 4 * (m + n) + 4 * m * n)


def flash_decode(b: int, lq: int, lk: int, h: int, hd: int,
                 el: int = 4) -> tuple[float, float]:
    """One attention of lq query rows against lk keys (no mask): q, k, v
    read and the output written in an element of ``el`` bytes."""
    return 4.0 * b * h * lq * lk * hd, float(el * b * h * hd *
                                              (2 * lq + 2 * lk))


def flash_prefill(b: int, l: int, h: int, hd: int,
                  el: int = 4) -> tuple[float, float]:
    """One causal attention over l positions: the l (l + 1) / 2 pairs a
    causal mask leaves, q, k, v read and the output written."""
    return 4.0 * b * h * hd * l * (l + 1) / 2, float(el * b * h * hd * 4 * l)


def dense_matmul_params(c: dict) -> int:
    """Weights that every token multiplies in one pass through the
    blocks of a dense transformer (the LM head apart)."""
    d, h, kv, hd, ff = (c["d_model"], c["n_heads"], c["n_kv_heads"],
                        c["head_dim"], c["d_ff"])
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    mlp = (3 if c["gated_mlp"] else 2) * d * ff
    return c["n_layers"] * (attn + mlp)


def dense_forward_ops(c: dict, batch: int, seq: int, head_rows: int) -> float:
    """Operations of one forward pass over ``batch`` causal sequences of
    ``seq`` tokens: every block's products, the causal attention, and the
    LM head over ``head_rows`` rows (all tokens in training, the last
    position of each sequence in a prefill that serves one token)."""
    tokens = batch * seq
    attn = c["n_layers"] * flash_prefill(batch, seq, c["n_heads"],
                                         c["head_dim"])[0]
    head = 2.0 * c["d_model"] * c["padded_vocab"] * head_rows
    return 2.0 * dense_matmul_params(c) * tokens + attn + head
