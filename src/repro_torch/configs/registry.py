"""Architecture registry of the configs the port runs, plus reduced smoke
configs (``reduce_config`` is a copy of the reference's)."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.gemma2_9b import CONFIG as _gemma2
from repro_torch.configs.granite_3_8b import CONFIG as _granite
from repro_torch.configs.internvl2_2b import CONFIG as _internvl2
from repro_torch.configs.llama3_1_8b import CONFIG as _llama
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as _scout
from repro_torch.configs.mixtral_8x22b import CONFIG as _mixtral
from repro_torch.configs.musicgen_large import CONFIG as _musicgen
from repro_torch.configs.phi3_mini_3_8b import CONFIG as _phi3
from repro_torch.configs.qwen1_5_0_5b import CONFIG as _qwen

REGISTRY: Dict[str, ModelConfig] = {
    "qwen1.5-0.5b": _qwen,
    "granite-3-8b": _granite,
    "llama3.1-8b": _llama,
    "internvl2-2b": _internvl2,
    "musicgen-large": _musicgen,
    "mixtral-8x22b": _mixtral,
    "llama4-scout-17b-a16e": _scout,
    "phi3-mini-3.8b": _phi3,
    "gemma2-9b": _gemma2,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch]


def reduce_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a config to a CPU-smoke-testable size, same family/features.

    Keeps every structural feature (GQA ratio, softcaps, SWA, MoE top-k, SSD
    state) while cutting width/depth/vocab so a forward runs on one CPU core
    in seconds.
    """
    small = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=128,
        vocab_size=min(cfg.vocab_size, 512),
        hybrid_chunk=32,
        logits_chunk=64,
        ssm_chunk=16,
    )
    if cfg.num_heads:
        small["num_heads"] = 4
        small["num_kv_heads"] = max(1, 4 * cfg.num_kv_heads // cfg.num_heads)
        small["head_dim"] = 32
    if cfg.d_ff:
        small["d_ff"] = 256
    if cfg.sliding_window:
        small["sliding_window"] = 16
    if cfg.is_moe:
        small["num_experts"] = min(cfg.num_experts, 4)
        small["num_experts_per_tok"] = min(cfg.num_experts_per_tok, 2)
    if cfg.has_ssm:
        small["ssm_state"] = 16
        small["ssm_headdim"] = 16
    if cfg.attn_every:
        small["attn_every"] = 2
    if cfg.local_global:
        small["num_layers"] = 4  # two (local, global) pairs
    small.update(overrides)
    small["name"] = cfg.name + "-smoke"
    return dataclasses.replace(cfg, **small)
