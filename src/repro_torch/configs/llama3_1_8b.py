"""llama3.1-8b [dense] — the paper's own evaluation model (Table 3, low-end
row). [arXiv:2407.21783; hf:meta-llama/Llama-3.1-8B]

A copy of the reference's config, field for field. The published config
also scales RoPE (``rope_scaling``: ``rope_type`` "llama3", factor 8),
which the reference leaves out; the port follows the reference (ROADMAP
§C15)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.1-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=128_256,
    rope_theta=500_000.0,
    tie_embeddings=False,
)
