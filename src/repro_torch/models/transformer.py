"""Decoder-only transformer, dense family: the PrefillOnly serving forwards.

Port of ``repro.models.transformer``'s ``head_weight``, ``forward_full``
(dense configs, with ``kv_keep``), ``prefill`` and ``prefill_with_prefix``.
Parameters keep the reference's stacked tree (``blocks/*`` with a leading
layer axis, ``embed/tok``, ``final_norm``; see ``models/params.py``), and
the layer scan becomes a Python loop over layers. The local_global (gemma2)
and fp8-weight branches come with later slices.

KV payloads keep the reference layout: (L, B, keep, KV, hd).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hybrid_prefill import last_token_logits
from repro_torch.models import layers as L


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.local_global or cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense, non-local_global configs; "
            f"other families come with later slices")


def head_weight(params: Dict, cfg: ModelConfig) -> torch.Tensor:
    """LM head as (D, V): the tied embedding's transpose, or ``lm_head``."""
    w = params["embed"]["tok"].T if cfg.tie_embeddings else params["lm_head"]
    dt = L.torch_dtype(cfg.dtype)
    return w.to(dt) if w.dtype != dt else w


def layer_params(blocks: Dict, layer: int) -> Dict:
    """Layer ``layer``'s slice of the stacked block tree (views)."""
    return {k: (layer_params(v, layer) if isinstance(v, dict) else v[layer])
            for k, v in blocks.items()}


def _block_full(bp: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, window: int, chunk: int):
    h = L.rms_norm(x, bp["ln1"])
    attn, k, v = L.attention_prefill(bp["attn"], h, cfg, positions=positions,
                                     window=window, chunk=chunk)
    x = x + attn
    h = L.rms_norm(x, bp["ln2"])
    return x + L.mlp_apply(bp["mlp"], h, chunk=chunk), (k, v)


def forward_full(params: Dict, cfg: ModelConfig, *,
                 tokens: torch.Tensor, kv_keep: int = 0
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (final-normed hidden (B, S, D), kv dict or None).

    ``kv_keep`` is the PrefillOnly prefix budget: only the first ``kv_keep``
    tokens' KV leave each layer (suffix KV discard — layer-wise: each
    layer's full-length K/V is dropped once its attention is done, and only
    its keep slice is copied into the preallocated (L, B, keep, KV, hd)
    output).
    """
    _check_dense(cfg)
    dtype = L.torch_dtype(cfg.dtype)
    x = L.embed_apply(params["embed"], tokens, dtype)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    chunk = cfg.hybrid_chunk
    keep = min(kv_keep, S)
    kv = None
    if keep > 0:
        shape = (cfg.num_layers, B, keep, cfg.num_kv_heads, cfg.head_dim)
        kv = {"k": torch.empty(shape, dtype=dtype, device=x.device),
              "v": torch.empty(shape, dtype=dtype, device=x.device)}
    for layer in range(cfg.num_layers):
        bp = layer_params(params["blocks"], layer)
        x, (k, v) = _block_full(bp, x, cfg, positions=positions,
                                window=cfg.sliding_window, chunk=chunk)
        if kv is not None:
            kv["k"][layer].copy_(k[:, :keep])
            kv["v"][layer].copy_(v[:, :keep])
    return L.rms_norm(x, params["final_norm"]), kv


def prefill(params: Dict, cfg: ModelConfig, batch: Dict, *,
            kv_keep: int = 0, last_index: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """PrefillOnly serving prefill: (last-token logits (B, V) f32, prefix
    KV)."""
    hidden, kv = forward_full(params, cfg, tokens=batch["tokens"],
                              kv_keep=kv_keep)
    logits = last_token_logits(hidden, head_weight(params, cfg),
                               last_index=last_index,
                               final_softcap=cfg.final_softcap)
    return logits, kv


def prefill_with_prefix(params: Dict, cfg: ModelConfig, batch: Dict,
                        prefix_kv: Dict, prefix_len: int, *,
                        kv_keep: int = 0,
                        last_index: Optional[torch.Tensor] = None):
    """Prefill of a SUFFIX given a cached prefix's KV (prefix-cache hit path).

    tokens cover positions [prefix_len, prefix_len+S); every layer attends
    over concat(prefix KV, fresh suffix KV) with causal attention offset by
    ``prefix_len``. ``prefix_kv`` holds (L, B, prefix_len, KV, hd) tensors.
    Returns last-token logits + the suffix KV to extend the cache with (up
    to ``kv_keep`` total tokens — suffix discard).
    """
    _check_dense(cfg)
    dtype = L.torch_dtype(cfg.dtype)
    x = L.embed_apply(params["embed"], batch["tokens"], dtype)
    B, S, _ = x.shape
    positions = (prefix_len + torch.arange(S, dtype=torch.int32,
                                           device=x.device)).expand(B, S)
    chunk = cfg.hybrid_chunk
    keep_new = max(0, min(kv_keep, prefix_len + S) - prefix_len)
    shape = (cfg.num_layers, B, keep_new, cfg.num_kv_heads, cfg.head_dim)
    kv = {"k": torch.empty(shape, dtype=dtype, device=x.device),
          "v": torch.empty(shape, dtype=dtype, device=x.device)}
    for layer in range(cfg.num_layers):
        bp = layer_params(params["blocks"], layer)
        h = L.rms_norm(x, bp["ln1"])
        q, k, v = L._qkv_project(bp["attn"], h, cfg, positions, chunk)
        k_full = torch.cat([prefix_kv["k"][layer].to(k.dtype), k], dim=1)
        v_full = torch.cat([prefix_kv["v"][layer].to(v.dtype), v], dim=1)
        out = L.attention(q, k_full, v_full, window=cfg.sliding_window,
                          softcap=cfg.attn_softcap, q_offset=prefix_len)
        out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
        x = x + out @ bp["attn"]["wo"]
        h = L.rms_norm(x, bp["ln2"])
        x = x + L.mlp_apply(bp["mlp"], h, chunk=chunk)
        kv["k"][layer].copy_(k[:, :keep_new])
        kv["v"][layer].copy_(v[:, :keep_new])
    hidden = L.rms_norm(x, params["final_norm"])
    logits = last_token_logits(hidden, head_weight(params, cfg),
                               last_index=last_index,
                               final_softcap=cfg.final_softcap)
    return logits, kv
