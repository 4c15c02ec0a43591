"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409] — VLM: pixtral-ViT frontend
(STUBBED: input_specs() provides precomputed patch embeddings) feeding a
mistral-nemo-like dense GQA decoder backbone."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    gated_mlp=True,
    modality="vision",
    frontend_seq=1024,      # precomputed image patch embeddings
    rope_theta=1_000_000_000.0,
    source="hf:mistralai/Pixtral-12B-2409",
)
