"""Per-family GEMM emitters for the LM model frontend (DESIGN.md §Model
frontend).

Each helper lowers one sub-block of an LM architecture into ``(Layer,
count)`` pairs — the weight-bearing matmuls that a CIM macro executes as
MVMs. ``count`` is the multiplicity of the GEMM in the whole network
(depth x batch x chunks x heads, as applicable); the network pipeline
(`core/network.py`) dedups structurally identical entries to one solve and
scales aggregates by ``count``.

Conventions (see `frontend.extract_workload` for scenario plumbing):

* ``m`` is the token dimension of one GEMM *instance* — the scenario's
  contribution. Prefill/train pass the sequence length (batch goes into
  ``count``); decode passes the serving batch (one token per sequence,
  batched into a single MVM).
* Attention *score* matmuls (QK^T, AV) are activation-activation products
  with no resident weight operand — they run on the dedicated attention /
  SIMD unit, not the CIM macro, and are not extracted (the standard CIM
  split; DESIGN.md §Model frontend). SSD intra-chunk matmuls *are*
  extracted: the SSM archs have no attention unit and the state-space
  duality form is exactly the blocked matmul stack `models/ssm.py`
  implements.
* Embedding lookup is a gather (no MACs) and is skipped; the LM head is a
  full GEMM over the padded vocab.
"""

from __future__ import annotations

import math

from repro_torch.core import workload as wl

Emitted = list[tuple[wl.Layer, int]]


def attn_gemms(prefix: str, d_model: int, n_heads: int, n_kv_heads: int,
               head_dim: int, m: int, *, kv_m: int | None = None,
               count: int = 1) -> Emitted:
    """QKV/O projections with GQA head counts.

    Q/O are sized by ``n_heads``; K/V by ``n_kv_heads`` (grouped-query
    attention shrinks the KV projections, e.g. glm4's kv=2 of 32 heads).
    ``kv_m`` overrides the K/V token dim (enc-dec cross-attention projects
    the encoder memory instead of the decoder stream); ``kv_m=0`` skips
    K/V entirely (decode-time cross-attention reuses cached memory K/V).
    """
    kv_m = m if kv_m is None else kv_m
    att = wl.OP_ATTENTION    # executor: projections on matmul_int8, plus
    out: Emitted = [         # one flash_attention score/AV op per block
        (wl.gemm(f"{prefix}.wq", m, n_heads * head_dim, d_model, op=att),
         count),
        (wl.gemm(f"{prefix}.wo", m, d_model, n_heads * head_dim, op=att),
         count),
    ]
    if kv_m:
        out += [
            (wl.gemm(f"{prefix}.wk", kv_m, n_kv_heads * head_dim, d_model,
                     op=att), count),
            (wl.gemm(f"{prefix}.wv", kv_m, n_kv_heads * head_dim, d_model,
                     op=att), count),
        ]
    return out


def ffn_gemms(prefix: str, d_model: int, d_ff: int, m: int, *,
              gated: bool = True, count: int = 1) -> Emitted:
    """Dense MLP: fused up(+gate) projection and down projection."""
    if not d_ff:
        return []
    up = d_ff * (2 if gated else 1)
    return [
        (wl.gemm(f"{prefix}.ffn_up", m, up, d_model), count),
        (wl.gemm(f"{prefix}.ffn_down", m, d_model, d_ff), count),
    ]


def moe_gemms(prefix: str, d_model: int, moe_d_ff: int, n_experts: int,
              n_shared_experts: int, top_k: int, m: int, *,
              gated: bool = True, count: int = 1) -> Emitted:
    """Routed + shared expert GEMMs.

    Top-k routing sends ``m * top_k`` token-assignments to ``n_experts``
    experts; under the balanced-load assumption each expert sees
    ``ceil(m * top_k / n_experts)`` tokens (floored at 1 — an expert GEMM
    with zero rows is no GEMM at all). Total routed MACs therefore scale
    with ``top_k``, not with ``n_experts``: that is the MoE efficiency the
    dataflow has to serve. Shared experts process every token.
    """
    out: Emitted = []
    if n_experts and top_k:
        m_exp = max(1, math.ceil(m * top_k / n_experts))
        out += ffn_gemms(f"{prefix}.exp", d_model, moe_d_ff, m_exp,
                         gated=gated, count=count * n_experts)
    if n_shared_experts:
        out += ffn_gemms(f"{prefix}.shared", d_model, moe_d_ff, m,
                         gated=gated, count=count * n_shared_experts)
    return out


def ssd_gemms(prefix: str, d_model: int, *, expand: int, head_dim: int,
              groups: int, state: int, m: int, decode: bool,
              chunk: int = 256, count: int = 1) -> Emitted:
    """Mamba2 / SSD block matmuls (`models/ssm.py` semantics).

    Projections (weight GEMMs) plus the SSD state matmuls. Prefill/train
    uses the chunked duality form — per chunk and per head:

      scores  = C B^T            (Q x Q x N)
      y_intra = scores X         (Q x P x Q)
      s_chunk = B^T (w*X)        (N x P x Q)   chunk state summary
      y_inter = (C*decay) h      (Q x P x N)

    Decode is the O(1) recurrent update per token and head: a rank-1
    state write (N x P x 1) and a state readout (1 x P x N). Depthwise
    causal conv is SIMD work (not MVM-shaped) and is skipped, like
    depthwise convs in the conv zoo (DESIGN.md §Decisions).
    """
    d_inner = expand * d_model
    nh = d_inner // head_dim
    gn = groups * state
    d_proj = 2 * d_inner + 2 * gn + nh
    out: Emitted = [
        (wl.gemm(f"{prefix}.in_proj", m, d_proj, d_model), count),
        (wl.gemm(f"{prefix}.out_proj", m, d_model, d_inner), count),
    ]
    ssd = wl.OP_SSD          # executor: scores+y_intra fused on ssd_scan,
    if decode:               # state GEMMs on matmul_int8
        # m = batch of single-token sequences; state ops are per seq x head
        c = count * m * nh
        out += [
            (wl.gemm(f"{prefix}.ssd_state_upd", state, head_dim, 1, op=ssd),
             c),
            (wl.gemm(f"{prefix}.ssd_readout", 1, head_dim, state, op=ssd),
             c),
        ]
    else:
        q = min(chunk, m)
        nc = math.ceil(m / q)
        c = count * nc * nh
        out += [
            (wl.gemm(f"{prefix}.ssd_scores", q, q, state, op=ssd), c),
            (wl.gemm(f"{prefix}.ssd_y_intra", q, head_dim, q, op=ssd), c),
            (wl.gemm(f"{prefix}.ssd_s_chunk", state, head_dim, q, op=ssd),
             c),
            (wl.gemm(f"{prefix}.ssd_y_inter", q, head_dim, state, op=ssd),
             c),
        ]
    return out


def lm_head_gemm(prefix: str, d_model: int, padded_vocab: int, m: int, *,
                 count: int = 1) -> Emitted:
    """Final unembedding projection over the padded vocabulary."""
    return [(wl.gemm(f"{prefix}.lm_head", m, padded_vocab, d_model), count)]
