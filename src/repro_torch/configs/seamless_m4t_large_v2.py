"""SeamlessM4T-large-v2 [arXiv:2308.11596] — encoder-decoder backbone.

The audio frontend (w2v-BERT conformer feature extractor) is a STUB per the
assignment: ``input_specs()`` provides precomputed frame embeddings of shape
(batch, frontend_seq, d_model); the transformer backbone (24L enc + 24L dec)
is fully implemented.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,            # decoder layers
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    gated_mlp=False,
    modality="audio",
    frontend_seq=1024,      # precomputed audio frame embeddings
    source="arXiv:2308.11596; hf:facebook/seamless-m4t-v2-large",
)
