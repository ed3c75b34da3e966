"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]

A copy of the reference's config, field for field. Every layer is MoE
(``models/moe.py``) and every layer attends over a 4096-token window, so
its decode cache is a ring of 4096 slots."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16_384,
    vocab_size=32_768,
    sliding_window=4096,
    num_experts=8,
    num_experts_per_tok=2,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)
