"""Config system: one frozen dataclass per architecture + input-shape sets.

Every assigned architecture (``--arch <id>``) is a ``ModelConfig``; input
shapes are ``ShapeSpec`` entries (train / prefill / decode / long-decode).
``reduced()`` derives the CPU smoke-test configuration of the same family.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                 # per-expert hidden dim
    dense_residual: bool = False      # arctic: dense MLP in parallel w/ MoE
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    # --- hybrid (zamba2) ---
    attn_every: int = 0               # shared attn block period (0 = none)
    # --- encoder-decoder (seamless) ---
    encoder_layers: int = 0           # 0 -> decoder-only
    # --- frontends (stubbed modalities) ---
    modality: str = "text"            # text | audio | vision
    frontend_seq: int = 0             # precomputed frame/patch positions
    # --- misc ---
    rope_theta: float = 10_000.0
    gated_mlp: bool = True
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- sharding hints (resolved by sharding/rules.py) ---
    moe_sharding: str = "auto"        # auto | ep | tp
    source: str = ""                  # provenance note

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def padded_vocab(self, multiple: int = 2048) -> int:
        return int(math.ceil(self.vocab_size / multiple) * multiple)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + \
            self.n_heads * hd * d
        mlp_mult = 3 if self.gated_mlp else 2
        dense_mlp = mlp_mult * d * self.d_ff if self.d_ff else 0
        moe = 0
        if self.n_experts:
            per = mlp_mult * d * self.moe_d_ff
            moe = (self.n_experts + self.n_shared_experts) * per
            if not self.dense_residual:
                dense_mlp = 0
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            d_in = self.ssm_expand * d
            ssm = d * (2 * d_in + 2 * self.ssm_groups * self.ssm_state) + \
                d_in * d + d_in * self.ssm_conv
        layers = self.n_layers * (attn + dense_mlp + moe + ssm)
        if self.family == "ssm":
            layers = self.n_layers * (ssm + dense_mlp)
        elif self.family == "hybrid":
            # mamba blocks per layer; ONE parameter-shared attention block
            # (with its MLP) reused every `attn_every` layers (Zamba2)
            layers = self.n_layers * ssm + (attn + dense_mlp)
        elif self.family == "encdec":
            layers = (self.n_layers + self.encoder_layers) * \
                (attn + dense_mlp) + self.n_layers * attn  # + cross-attn
        return emb + layers

    def active_param_count(self) -> int:
        """Active parameters per token (MoE top-k routing)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        mlp_mult = 3 if self.gated_mlp else 2
        per = mlp_mult * d * self.moe_d_ff
        active_moe = (self.top_k + self.n_shared_experts) * per
        total_moe = (self.n_experts + self.n_shared_experts) * per
        return self.param_count() - self.n_layers * (total_moe - active_moe)

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads else 0,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_experts=min(self.n_experts, 8),
            n_shared_experts=min(self.n_shared_experts, 2),
            top_k=min(self.top_k, 2),
            moe_d_ff=32 if self.n_experts else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            frontend_seq=8 if self.frontend_seq else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell.

    How the kinds lower (`core/frontend.py`; M = GEMM rows, mult =
    workload multiplicity, per instance of each weight-GEMM):

    ========  ==============  ============  =================================
    kind      M               mult          extras
    ========  ==============  ============  =================================
    train     seq_len         global_batch  + backward pass: one dGrad + one
                                            wGrad per forward GEMM (same
                                            multiplicities; MoE wGrads scale
                                            to experts hit by seq_len*top_k
                                            tokens), LM head at M = seq_len
                                            (loss at every position), plus a
                                            once-per-step optimizer bill
                                            (`training.optimizer_update_cost`)
    prefill   seq_len         global_batch  LM head at M = 1 (last position)
    decode    global_batch    1             one token per sequence, batched
                                            into a single MVM
    ========  ==============  ============  =================================
    """
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"

    # -- model-frontend lowering (core/frontend.py; DESIGN.md §Model
    # frontend). Scenarios differ only in where tokens land: prefill/train
    # GEMMs see the full sequence as the M dim with the batch as workload
    # multiplicity; a decode step sees one token per sequence, batched into
    # a single M = global_batch MVM.
    @property
    def m_tokens(self) -> int:
        """GEMM M dim of one extracted weight-GEMM instance."""
        return self.global_batch if self.is_decode else self.seq_len

    @property
    def instance_count(self) -> int:
        """Workload multiplicity contributed by the batch."""
        return 1 if self.is_decode else self.global_batch

    @classmethod
    def serving_iteration(cls, prefill_lens: "tuple[int, ...]",
                          n_decode: int, *, context_len: int = 4096,
                          name: str | None = None) -> "ShapeSpec":
        """One continuous-batching iteration as a scenario cell.

        The serving engine (`core/serving.py`) batches whole-prompt
        prefills with single-token decode steps into ONE forward pass; its
        GEMMs see the *total* token count as the M dim.  Lowered as a
        decode-kind cell so ``m_tokens = sum(prefill_lens) + n_decode``
        with ``instance_count = 1`` (one fused MVM batch, not a per-batch
        multiplicity), and ``seq_len = context_len`` bounds the attention
        / KV reach of the iteration."""
        m = int(sum(prefill_lens)) + int(n_decode)
        if m < 1:
            raise ValueError("a serving iteration must carry >= 1 token")
        return cls(name or f"serve_iter_m{m}", seq_len=int(context_len),
                   global_batch=m, kind="decode")


SHAPES = {
    "train_2k": ShapeSpec("train_2k", 2_048, 512, "train"),
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "train_8k": ShapeSpec("train_8k", 8_192, 128, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> dict[str, ShapeSpec | None]:
    """Shape cells for an arch; None = skipped (with reason in dryrun log).

    ``long_500k`` requires sub-quadratic sequence mixing: run for SSM/hybrid
    archs only (assignment rule; see DESIGN.md §Arch-applicability).
    """
    out: dict[str, ShapeSpec | None] = {}
    for name, spec in SHAPES.items():
        if name == "long_500k" and not cfg.supports_long_context:
            out[name] = None
        else:
            out[name] = spec
    return out
