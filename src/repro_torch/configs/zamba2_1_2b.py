"""Zamba2-1.2B [arXiv:2411.15242; hf] — hybrid: Mamba2 backbone with a
shared full-attention block applied periodically (parameter-shared)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,              # shared attn block's MLP
    vocab_size=32000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,           # shared attention block every 6 mamba blocks
    source="arXiv:2411.15242; hf:Zyphra/Zamba2-1.2B",
)
