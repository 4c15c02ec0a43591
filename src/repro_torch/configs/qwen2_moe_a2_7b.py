"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B] — 60 routed experts top-4
plus 4 shared experts, fine-grained (d_ff=1408 per expert)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,                 # no dense FFN; MoE in every layer
    moe_d_ff=1408,
    n_experts=60,
    n_shared_experts=4,
    top_k=4,
    vocab_size=151936,
    gated_mlp=True,
    moe_sharding="tp",      # 60 experts % 16 != 0 -> TP inside experts
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
