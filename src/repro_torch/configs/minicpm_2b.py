"""MiniCPM-2B [arXiv:2404.06395; hf] — llama-like dense (MHA), WSD schedule.

The WSD (warmup-stable-decay) learning-rate schedule the paper introduces is
implemented in repro_torch/train/optimizer.py (``schedule_lr``) and selected
by this config (``TRAIN_SCHEDULE``).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    gated_mlp=True,
    tie_embeddings=True,
    source="arXiv:2404.06395; hf:openbmb/MiniCPM-2B (WSD schedule)",
)

TRAIN_SCHEDULE = "wsd"
