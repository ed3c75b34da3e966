"""Layer library, dense subset: RMSNorm, RoPE, attention, SwiGLU, embedding.

Port of ``repro.models.layers`` (``rms_norm``, ``rope_apply``,
``_qkv_project``, the non-mesh branches of ``attention_prefill``, dense and
segmented, ``decode_attention``, ``attention_decode``, ``mlp_apply``,
``embed_apply``). Parameters are plain dicts of tensors, activations run in
the config's dtype, softmax/norm internals in f32. RMSNorm, attention
(prefill and decode) and the MLP go through the kernel wrappers of
``repro_torch.kernels``: hand-written Hopper kernels on CUDA tensors, their
plain PyTorch versions on CPU tensors. Token-wise layers run under hybrid
prefilling (``core.hybrid_prefill.chunked_map``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hybrid_prefill import chunked_map
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_mlp as _mlp
from repro_torch.kernels import rmsnorm as _rms

NEG_INF = -1e30
# padding-kv position sentinel (the reference's PAD_POS): huge, so the
# positioned attention's causal mask kills padded prefix slots
PAD_POS = 1 << 30

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return TORCH_DTYPES[name]


# --------------------------------------------------------------------------
# norms / rope
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` (norm weights start at 0)."""
    return _rms.rmsnorm(x, weight, eps)


def rope_apply(x: torch.Tensor, positions: torch.Tensor, theta: float,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, S, H, d), positions: (B, S) int. Split-half RoPE, f32 inside,
    each half rounded once into ``out`` (x's shape and dtype; a new tensor
    by default, or x itself: both halves are computed before either is
    written)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs      # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    lo, hi = x1 * cos - x2 * sin, x1 * sin + x2 * cos
    if out is None:
        out = torch.empty_like(x)
    out[..., :half] = lo
    out[..., half:] = hi
    return out


# --------------------------------------------------------------------------
# attention block (projections + rope + attention)
# --------------------------------------------------------------------------

def _qkv_project(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, chunk: int):
    """Token-wise QKV projection + RoPE, chunked under hybrid prefilling.

    q, k and v are views of one (B, S, (H + 2 KV) hd) buffer; RoPE is
    applied in place a chunk at a time, so its f32 temporaries are bounded
    by the chunk, as the projections' are (the reference's XLA fuses them
    away)."""
    B, S, D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def proj(xc):
        q = xc @ p["wq"]
        k = xc @ p["wk"]
        v = xc @ p["wv"]
        if cfg.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        return torch.cat([q, k, v], dim=-1)

    qkv = chunked_map(proj, x, chunk)
    q, k, v = torch.split(qkv, [H * hd, KV * hd, KV * hd], dim=-1)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    step = chunk if 0 < chunk < S else S
    for lo in range(0, S, step):
        pos = positions[:, lo:lo + step]
        for t in (q, k):
            part = t[:, lo:lo + step]
            rope_apply(part, pos, cfg.rope_theta, out=part)
    return q, k, v


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              q_offset: int = 0, seg_q: Optional[torch.Tensor] = None,
              seg_k: Optional[torch.Tensor] = None,
              pos_q: Optional[torch.Tensor] = None,
              pos_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Sq, H, d), k/v: (B, Sk, KV, d) -> (B, Sq, H, d); query i sits
    at position ``q_offset + i`` (the reference's ``blocked_attention``),
    restricted to same-segment pairs by ``seg_*`` and masked by per-token
    positions ``pos_*`` when given."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, q_offset=q_offset,
                               seg_q=seg_q, seg_k=seg_k, pos_q=pos_q,
                               pos_k=pos_k)


def attention_prefill(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                      positions: torch.Tensor, window: int = 0,
                      chunk: int = 0, seg_ids: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence causal attention. Returns (out, k, v) — the caller
    decides how much of (k, v) to keep (suffix KV discard happens there).

    ``seg_ids`` (B, S) selects the prepacked path: the kernel's segmented
    mode restricts attention to same-segment pairs and skips
    cross-segment tiles."""
    B, S, D = x.shape
    q, k, v = _qkv_project(p, x, cfg, positions, chunk)
    out = attention(q, k, v, window=window, softcap=cfg.attn_softcap,
                    seg_q=seg_ids, seg_k=seg_ids)
    del q
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    out = chunked_map(lambda oc: oc @ p["wo"], out, chunk)
    return out, k, v


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len, *, softcap: float = 0.0,
                     ring: bool = False) -> torch.Tensor:
    """One-token attention. q: (B, 1, H, d); caches: (B, S, KV, d);
    ``kv_len``: a scalar or (B,) integer tensor on q's device.

    ``ring`` (a sliding-window ring buffer: every slot below
    ``min(kv_len, S)`` is live) is kept for the reference's signature only:
    the B6 kernel and its plain version already take ``kv_len > S`` as
    every slot live, so it changes nothing here. The reference's
    ``head_scale`` is not ported (no dense caller passes it). Unlike the
    reference, p stays f32 in P.V and q is scaled in f32 (the B6 kernel's
    order; ROADMAP §C6)."""
    kv_len = torch.as_tensor(kv_len, device=q.device).expand(q.shape[0])
    return _da.decode_attention(q, k_cache, v_cache, kv_len, softcap=softcap)


def attention_decode(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                     position: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, ring: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention step. x: (B, 1, D); position: (B,) ints on x's
    device. Writes the new token's k/v into ``k_cache``/``v_cache`` IN
    PLACE at slot ``position[0]`` (mod S when ``ring``; uniform decode: all
    rows share row 0's position, as in the reference), attends over slots
    below ``position[0] + 1``, and returns (out (B, 1, D), k_cache, v_cache)
    — the same cache tensors. The reference returns updated copies; in
    place, a decode step never holds a second cache."""
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    S = k_cache.shape[1]
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    pos2d = position.reshape(B, 1)
    q = rope_apply(q.reshape(B, 1, H, hd), pos2d, cfg.rope_theta)
    k = rope_apply(k.reshape(B, 1, KV, hd), pos2d, cfg.rope_theta)
    v = v.reshape(B, 1, KV, hd)
    # past the end of a plain cache the reference's dynamic_update_slice
    # clamps the slot to S - 1; clamp on the device too (no host sync)
    slot = (position[0] % S if ring else position[0].clamp(0, S - 1)
            ).long().reshape(1)
    k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
    out = decode_attention(q, k_cache, v_cache, position[0] + 1,
                           softcap=cfg.attn_softcap, ring=ring)
    out = out.reshape(B, 1, H * hd) @ p["wo"]
    return out.to(x.dtype), k_cache, v_cache


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------

def mlp_apply(p: Dict, x: torch.Tensor, chunk: int = 0) -> torch.Tensor:
    """SwiGLU MLP through the fused kernel (rounding: ``silu(g) * u`` cast
    to x's dtype, as the Pallas kernel does), chunked under hybrid
    prefilling."""
    return chunked_map(
        lambda xc: _mlp.fused_mlp(xc, p["w_gate"], p["w_up"], p["w_down"]),
        x, chunk)


# --------------------------------------------------------------------------
# embedding
# --------------------------------------------------------------------------

def embed_apply(p: Dict, tokens: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    return p["tok"][tokens].to(dtype)
