"""StarCoder2-7B [arXiv:2402.19173; hf] — dense GQA, RoPE."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    gated_mlp=False,        # starcoder2 uses plain GELU MLP
    source="arXiv:2402.19173; hf:bigcode/starcoder2-7b",
)
