"""musicgen-large [audio] — decoder-only over EnCodec tokens.
[arXiv:2306.05284]

A copy of the reference's config, field for field. The EnCodec encoder and
decoder are a stub: inputs are codec token ids over a 2048-entry
codebook."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    tie_embeddings=False,
)
