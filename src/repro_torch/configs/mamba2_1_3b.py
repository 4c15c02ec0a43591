"""Mamba2-1.3B [arXiv:2405.21060] — attention-free SSM with SSD (state-space
duality) blocks; d_state=128, expand=2, head_dim=64."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                 # attention-free, MLP-free (Mamba2 pure stack)
    vocab_size=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    source="arXiv:2405.21060; hf:state-spaces/mamba2-1.3b",
)
