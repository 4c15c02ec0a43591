"""Snowflake Arctic (480B) [hf:Snowflake/snowflake-arctic-base] — 128 routed
experts top-2 with a dense-residual MLP in parallel (dense+MoE hybrid FFN)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,              # dense residual MLP path
    moe_d_ff=4864,
    n_experts=128,
    n_shared_experts=0,
    top_k=2,
    dense_residual=True,
    vocab_size=32000,
    gated_mlp=True,
    moe_sharding="ep",      # 128 % 16 == 0 -> expert parallel on model axis
    source="hf:Snowflake/snowflake-arctic-base",
)
