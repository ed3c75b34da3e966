"""llama4-scout-17b-a16e [moe] — 16 experts top-1 plus a shared expert.
[hf:meta-llama/Llama-4-Scout-17B-16E]

A copy of the reference's config, field for field: the text backbone only
(the early-fusion multimodal frontend is outside it), full attention. Every
layer is MoE (``models/moe.py``) with an always-on shared expert, a dense
SwiGLU MLP of the experts' width."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    num_experts=16,
    num_experts_per_tok=1,
    shared_expert=True,
    rope_theta=500_000.0,
    tie_embeddings=False,
)
