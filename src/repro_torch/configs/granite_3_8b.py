"""granite-3-8b [dense] — GQA. [hf:ibm-granite/granite-3.0-8b-base]

A copy of the reference's config, field for field. The published config
also carries µP-style multipliers (embedding, attention, residual and
logits scaling) that the reference leaves out; the port follows the
reference (ROADMAP §C8)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12_800,
    vocab_size=49_155,
    rope_theta=10_000.0,
    tie_embeddings=True,
)
