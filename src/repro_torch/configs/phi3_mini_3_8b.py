"""phi3-mini-3.8b [dense] — RoPE SwiGLU, 32 MHA heads of 96.
[arXiv:2404.14219]

A copy of the reference's config, field for field. Its head_dim of 96
(3072 / 32) runs flash attention and flash decoding at that width."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32_064,
    rope_theta=10_000.0,
    tie_embeddings=False,
)
