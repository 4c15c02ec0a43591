"""Model -> workload frontend: lower a ``ModelConfig`` under a ``ShapeSpec``
into the exact GEMM loop-nest list MIREDO optimizes (DESIGN.md §Model
frontend).

This is the bridge `workload.py` promises: every weight-bearing matmul of
every registry architecture — GQA attention projections, (gated) FFN mats,
top-k-routed MoE expert GEMMs, SSD block matmuls, the LM head — becomes a
`workload.Layer` with a network multiplicity, and the whole model flows
through the network pipeline (`core/network.py`): structurally identical
GEMMs across depth, batch and even scenarios dedup to one MIP solve each.

Scenario semantics (`configs.base.ShapeSpec`): prefill/train GEMMs carry
the sequence length as the M dim and the batch as multiplicity; a decode
step carries M = global_batch (one token per sequence, batched into one
MVM). Decode-vs-prefill GEMMs therefore differ only in M, and everything
downstream of the projections (weights, reduction dims) is shared.

    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.core.frontend import extract_workload, optimize_model

    work = extract_workload(get_config("glm4-9b"), SHAPES["decode_32k"])
    res = optimize_model(get_config("glm4-9b"), SHAPES["decode_32k"],
                         default_arch())          # -> NetworkResult
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (ModelConfig, ShapeSpec, SHAPES,
                                applicable_shapes)
from repro_torch.core import workload as wl
from repro_torch.core.lm_workloads import (Emitted, attn_gemms, ffn_gemms,
                                     lm_head_gemm, moe_gemms, ssd_gemms)


@dataclasses.dataclass(frozen=True)
class ModelWorkload:
    """One model under one scenario, lowered to (Layer, count) pairs."""

    model: str
    scenario: str
    layers: tuple[wl.Layer, ...]
    counts: tuple[int, ...]

    def __post_init__(self):
        assert len(self.layers) == len(self.counts)
        assert all(c >= 1 for c in self.counts), (self.model, self.scenario)

    def __len__(self) -> int:
        return len(self.layers)

    @property
    def total_macs(self) -> int:
        """Multiplicity-weighted MACs of the whole network."""
        return sum(l.macs * c for l, c in zip(self.layers, self.counts))

    @property
    def n_unique(self) -> int:
        from repro_torch.core.network import dedup_layers
        return len(dedup_layers(list(self.layers))[0])


def _attn_block(prefix: str, cfg: ModelConfig, m: int, *, count: int,
                kv_m: int | None = None) -> Emitted:
    return attn_gemms(prefix, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.resolved_head_dim, m, kv_m=kv_m, count=count)


def _mlp_block(prefix: str, cfg: ModelConfig, m: int, *,
               count: int) -> Emitted:
    """Dense FFN or MoE (routed + shared + arctic's dense residual)."""
    if cfg.n_experts:
        out = moe_gemms(prefix, cfg.d_model, cfg.moe_d_ff, cfg.n_experts,
                        cfg.n_shared_experts, cfg.top_k, m,
                        gated=cfg.gated_mlp, count=count)
        if cfg.dense_residual:
            out += ffn_gemms(prefix + ".res", cfg.d_model, cfg.d_ff, m,
                             gated=cfg.gated_mlp, count=count)
        return out
    return ffn_gemms(prefix, cfg.d_model, cfg.d_ff, m, gated=cfg.gated_mlp,
                     count=count)


def _ssd_block(prefix: str, cfg: ModelConfig, m: int, *, decode: bool,
               count: int) -> Emitted:
    return ssd_gemms(prefix, cfg.d_model, expand=cfg.ssm_expand,
                     head_dim=cfg.ssm_head_dim, groups=cfg.ssm_groups,
                     state=cfg.ssm_state, m=m, decode=decode, count=count)


def extract_workload(cfg: ModelConfig, spec: ShapeSpec) -> ModelWorkload:
    """Lower ``cfg`` under ``spec`` to the full weight-GEMM workload.

    Family lowering rules (DESIGN.md §Model frontend):

      dense      per layer: GQA attn projections + (gated) FFN
      moe        per layer: attn + top-k routed expert GEMMs (+ shared
                 experts, + arctic's dense-residual MLP)
      ssm        per layer: SSD block (projections + duality matmuls)
      hybrid     n_layers SSD blocks + ONE parameter-shared attention+MLP
                 block *executed* every ``attn_every`` layers (shared
                 params, repeated compute -> count = n_layers//attn_every)
      encdec     encoder self-attn+FFN over the frontend sequence, decoder
                 self-attn + cross-attn (K/V project the encoder memory;
                 cached at decode) + FFN
      vlm        dense decoder over text + prepended patch embeddings at
                 prefill/train; decode is text-only

    Plus the LM head for every family. Embedding lookups, norms, rotary,
    softmax, depthwise convs and attention score matmuls are non-MVM work
    (SIMD / attention unit) and are not extracted.

    ``kind="train"`` additionally appends the backward pass: one dGrad +
    one wGrad GEMM per forward GEMM in reversed order
    (`training.backward_gemms` — transposed dims, MoE wGrads scaled to
    the experts actually hit, LM head at M = every position).
    """
    m, inst = spec.m_tokens, spec.instance_count
    decode = spec.is_decode
    fam = cfg.family
    name = cfg.name
    out: Emitted = []

    if fam in ("dense", "moe", "vlm"):
        m_blk = m
        if fam == "vlm" and not decode and cfg.frontend_seq:
            m_blk = m + cfg.frontend_seq      # patch tokens prepended
        per = cfg.n_layers * inst
        out += _attn_block(f"{name}.blk", cfg, m_blk, count=per)
        out += _mlp_block(f"{name}.blk", cfg, m_blk, count=per)
    elif fam == "ssm":
        out += _ssd_block(f"{name}.blk", cfg, m, decode=decode,
                          count=cfg.n_layers * inst)
    elif fam == "hybrid":
        out += _ssd_block(f"{name}.blk", cfg, m, decode=decode,
                          count=cfg.n_layers * inst)
        n_apply = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
        if n_apply:
            out += _attn_block(f"{name}.shared", cfg, m,
                               count=n_apply * inst)
            out += ffn_gemms(f"{name}.shared", cfg.d_model, cfg.d_ff, m,
                             gated=cfg.gated_mlp, count=n_apply * inst)
    elif fam == "encdec":
        m_enc = cfg.frontend_seq or m
        if not decode:
            per_enc = cfg.encoder_layers * inst
            out += _attn_block(f"{name}.enc", cfg, m_enc, count=per_enc)
            out += ffn_gemms(f"{name}.enc", cfg.d_model, cfg.d_ff, m_enc,
                             gated=cfg.gated_mlp, count=per_enc)
        per = cfg.n_layers * inst
        out += _attn_block(f"{name}.dec", cfg, m, count=per)
        # cross-attention: K/V project the encoder memory (cached at
        # decode -> kv_m=0 skips them), Q/O project the decoder stream
        out += _attn_block(f"{name}.xattn", cfg, m,
                           kv_m=0 if decode else m_enc, count=per)
        out += ffn_gemms(f"{name}.dec", cfg.d_model, cfg.d_ff, m,
                         gated=cfg.gated_mlp, count=per)
    else:
        raise ValueError(fam)

    # LM head: training computes logits (and loss) at every position, but
    # a serving prefill only materializes the last position's logits
    # (`train/steps.make_prefill_step`); a decode step already has one
    # token per sequence in M.
    m_head = 1 if spec.kind == "prefill" else m
    out += lm_head_gemm(name, cfg.d_model, cfg.padded_vocab(), m_head,
                        count=inst)

    # Training expands every forward GEMM into its dGrad + wGrad pair
    # (reversed order, transposed dims, written-residency wGrads) — see
    # `core/training.py`; the optimizer-step traffic is priced separately
    # (`training.optimizer_update_cost`), not lowered as layers.
    if spec.kind == "train":
        from repro_torch.core.training import backward_gemms
        out += backward_gemms(out, cfg, spec)
    layers, counts = zip(*out)
    return ModelWorkload(model=name, scenario=spec.name, layers=layers,
                         counts=counts)


def extract_all(cfg: ModelConfig,
                scenarios: tuple[str | ShapeSpec, ...] | None = None
                ) -> dict[str, ModelWorkload]:
    """Every applicable scenario's workload (``None`` cells skipped).

    ``scenarios`` entries are ShapeSpec *names* (filtering the registered
    SHAPES cells; unknown names raise — a typo must not silently produce
    an empty, green benchmark run) or ad-hoc ``ShapeSpec`` objects, e.g.
    the serving engine's per-iteration batch compositions
    (``ShapeSpec.serving_iteration``), keyed by their own name."""
    names: set[str] = set()
    extra: list[ShapeSpec] = []
    if scenarios:
        for s in scenarios:
            (extra.append if isinstance(s, ShapeSpec) else names.add)(s)
        unknown = names - set(SHAPES)
        if unknown:
            raise KeyError(f"unknown scenario(s) {sorted(unknown)}; "
                           f"known: {sorted(SHAPES)}")
    out = {}
    for sname, spec in applicable_shapes(cfg).items():
        if spec is None or (scenarios and sname not in names):
            continue
        out[sname] = extract_workload(cfg, spec)
    for spec in extra:
        out[spec.name] = extract_workload(cfg, spec)
    return out


def optimize_model(cfg: ModelConfig, spec: ShapeSpec, arch,
                   mode: str = "miredo", **net_kwargs):
    """Extract + run the network pipeline; returns a ``NetworkResult``."""
    from repro_torch.core.network import optimize_network
    work = extract_workload(cfg, spec)
    return optimize_network(list(work.layers), arch, mode,
                            counts=list(work.counts), **net_kwargs)
