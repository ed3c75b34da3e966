"""internvl2-2b [vlm] — InternViT frontend (a stub) + InternLM2 backbone.
[arXiv:2404.16821; hf]

A copy of the reference's config, field for field. The vision tower is a
stub: the backbone (this config) takes precomputed embeddings of shape
(batch, seq, d_model) as ``batch["embeds"]`` (``embed_inputs=False``), or
token ids; logits span the full text vocab."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92_553,
    embed_inputs=False,
    tie_embeddings=False,
)
