"""gemma2-9b [dense] — local+global alternating attention, logit softcaps.

[arXiv:2408.00118; hf] head_dim fixed at 256 (not d_model/heads).

A copy of the reference's config, field for field. Its layers run in
(local, global) pairs: a 4096-token sliding window on the local layer,
full attention on the global one. The port runs it through the model API
only: the reference's engine cannot serve a local_global tree (ROADMAP
§C20), so the port's engine refuses it."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=256_000,
    head_dim=256,
    local_global=True,
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    tie_embeddings=True,
)
