"""Blocked flash attention: dense (with a query offset), segmented and
positioned modes.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention`` in all three of its modes:

- dense (no ``seg_*``, no ``pos_*``), plus ``q_offset``: query row i sits at
  absolute position ``q_offset + i`` against keys at positions
  ``0..Sk-1`` (bottom-right causal alignment), which the prefix-cache-hit
  forward needs and the Pallas dense mode lacks;
- segmented (``seg_q``/``seg_k``, the packed miss): attention only where
  ``seg_q == seg_k`` and ``seg_k >= 0`` (negative ids are padding); the
  causal and window masks keep structural packed indices, valid because
  segments are contiguous;
- positioned (``seg_*`` plus ``pos_q``/``pos_k``, the packed hit): per-token
  absolute positions replace the structural indices in the causal and
  window masks, so the keys may be concat(gathered prefix KV, fresh KV).

Causal, sliding window, tanh softcap, GQA (query head h reads kv head
``h // (H // KV)``) and a ``kv_valid`` padded-key mask in every mode.

The Hopper kernel (``csrc/flash_attention.cu``) turns the Pallas grid's
sequential kv axis into a loop inside the block and keeps the f32 query row
and accumulator of each of its 32 query rows in registers. It skips whole
32-key tiles that cannot be live, as the Pallas kernel's range tests do
(structural causal/window range; segment-id ranges that do not meet; no
``seg_k >= 0``; position ranges that fail the causal or window test), with
the ranges taken over real tokens only, so a skipped tile is never loaded.
``tile_map`` (the Pallas ``debug_tile_map``'s counterpart) records which
tiles the kernel ran; the plain version runs no tiles and has no map. It is
bound by bytes at the main path's shapes (head_dim 64), but this first
version computes with f32 FMAs rather than tensor cores. A finite
``NEG_INF`` and explicit zero weights for masked keys keep fully masked rows
finite: they return 0 (the Pallas kernel and ``ref.packed_flash_attention_
ref`` give such padding rows a uniform average instead; see ROADMAP §C).

Layout at both functions: q (B, Sq, H, d), k/v (B, Sk, KV, d) -> (B, Sq, H,
d), the model layer's layout (``repro.kernels.ops.flash_attention``'s).
``flash_attention`` launches the kernel for CUDA tensors and uses
``flash_attention_plain`` for CPU tensors; ``mode_launches`` counts kernel
launches by mode, and ``launches`` is their sum.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64)                # instantiated in csrc/flash_attention.cu
BLOCK_Q = BLOCK_K = 32              # the kernel's query block and key tile
MODES = ("dense", "segmented", "positioned")

mode_launches = dict.fromkeys(MODES, 0)

_ARGTYPES = ([ctypes.c_void_p] * 10                          # q, k, v, o,
             # strides, seg_q, seg_k, pos_q, pos_k, tile_map
             + [ctypes.c_int] * 10                           # B..kv_valid
             + [ctypes.c_float, ctypes.c_float,              # scale, softcap
                ctypes.c_int, ctypes.c_void_p])              # dtype, stream


def __getattr__(name: str):
    if name == "launches":                  # the kernel's launches, all modes
        return sum(mode_launches.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def mode(seg_q=None, pos_q=None) -> str:
    return "positioned" if pos_q is not None else (
        "segmented" if seg_q is not None else "dense")


def _check_modes(B: int, Sq: int, Sk: int, q_offset: int, seg_q, seg_k,
                 pos_q, pos_k) -> None:
    if (seg_q is None) != (seg_k is None):
        raise ValueError("flash_attention: seg_q and seg_k come together")
    if (pos_q is None) != (pos_k is None):
        raise ValueError("flash_attention: pos_q and pos_k come together")
    if pos_q is not None and seg_q is None:
        raise ValueError("flash_attention: per-token positions (pos_q/pos_k) "
                         "require segment ids (seg_q/seg_k)")
    if pos_q is not None and q_offset:
        raise ValueError("flash_attention: q_offset is for the dense and "
                         "segmented modes; positions carry their own offsets")
    for name, t, S in (("seg_q", seg_q, Sq), ("seg_k", seg_k, Sk),
                       ("pos_q", pos_q, Sq), ("pos_k", pos_k, Sk)):
        if t is not None and tuple(t.shape) != (B, S):
            raise ValueError(f"flash_attention: {name} has shape "
                             f"{tuple(t.shape)}, expected {(B, S)}")


def _live_mask(Sq: int, Sk: int, *, causal: bool, window: int,
               q_offset: int, kv_valid: Optional[int], device,
               seg_q: Optional[torch.Tensor] = None,
               seg_k: Optional[torch.Tensor] = None,
               pos_q: Optional[torch.Tensor] = None,
               pos_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Sq, Sk) live mask, or (B, Sq, Sk) with segment ids."""
    if pos_q is not None:
        qpos = pos_q.long()[:, :, None]
        kpos = pos_k.long()[:, None, :]
    else:
        qpos = q_offset + torch.arange(Sq, device=device)[:, None]
        kpos = torch.arange(Sk, device=device)[None, :]
    n_valid = Sk if kv_valid is None else min(Sk, kv_valid)
    live = (torch.arange(Sk, device=device) < n_valid).expand(Sq, Sk)
    if causal:
        live = live & (qpos >= kpos)
    if window > 0:
        live = live & ((qpos - kpos) < window)
    if seg_q is not None:
        sq, sk = seg_q.long()[:, :, None], seg_k.long()[:, None, :]
        live = live & (sq == sk) & (sk >= 0)
    return live


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, q_offset: int = 0,
                          kv_valid: Optional[int] = None,
                          scale: Optional[float] = None,
                          seg_q: Optional[torch.Tensor] = None,
                          seg_k: Optional[torch.Tensor] = None,
                          pos_q: Optional[torch.Tensor] = None,
                          pos_k: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version: full softmax over live keys, f32 internals;
    a row with no live key gives 0."""
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    _check_modes(B, Sq, Sk, q_offset, seg_q, seg_k, pos_q, pos_k)
    G = H // KV
    if scale is None:
        scale = d ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(G, dim=2)           # (B, Sk, H, d)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    live = _live_mask(Sq, Sk, causal=causal, window=window,
                      q_offset=q_offset, kv_valid=kv_valid, device=q.device,
                      seg_q=seg_q, seg_k=seg_k, pos_q=pos_q, pos_k=pos_k)
    if live.dim() == 3:
        live = live[:, None]                             # (B, 1, Sq, Sk)
    s = s.masked_fill(~live, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * live
    out = torch.einsum("bhqk,bkhd->bhqd", p, vf)
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0,
                    kv_valid: Optional[int] = None,
                    scale: Optional[float] = None,
                    seg_q: Optional[torch.Tensor] = None,
                    seg_k: Optional[torch.Tensor] = None,
                    pos_q: Optional[torch.Tensor] = None,
                    pos_k: Optional[torch.Tensor] = None,
                    tile_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Sq, H, d); k, v: (B, Sk, KV, d) -> (B, Sq, H, d).

    ``seg_q``/``seg_k`` (B, Sq)/(B, Sk) int segment ids (negative =
    padding) select the segmented mode; ``pos_q``/``pos_k`` (same shapes)
    per-token absolute positions the positioned mode, which requires the
    segment ids. ``tile_map``, when given, is a (B, ceil(Sq/32),
    ceil(Sk/32)) int32 buffer on q's CUDA device that receives the kernel's
    executed-tile map (1 = the tile ran); CPU tensors take no map."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, d = q.shape
    _, Sk, KV, dk = k.shape
    _check_modes(B, Sq, Sk, q_offset, seg_q, seg_k, pos_q, pos_k)
    if tile_map is not None and tuple(tile_map.shape) != (
            B, -(-Sq // BLOCK_Q), -(-Sk // BLOCK_K)):
        raise ValueError(f"flash_attention: tile_map has shape "
                         f"{tuple(tile_map.shape)}")
    if q.device.type == "cpu":
        if tile_map is not None:
            raise ValueError("flash_attention: the executed-tile map is the "
                             "CUDA kernel's; the plain version runs no tiles")
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, q_offset=q_offset,
                                     kv_valid=kv_valid, scale=scale,
                                     seg_q=seg_q, seg_k=seg_k, pos_q=pos_q,
                                     pos_k=pos_k)
    ints = [t for t in (seg_q, seg_k, pos_q, pos_k, tile_map)
            if t is not None]
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in (k, v, *ints)):
        raise ValueError("flash_attention: q, k, v, ids, positions and the "
                         "tile map must share one CUDA device")
    if k.shape[0] != B or dk != d or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention: q, k, v dtypes differ")
    if tile_map is not None and (tile_map.dtype != torch.int32
                                 or not tile_map.is_contiguous()):
        raise ValueError("flash_attention: tile_map must be contiguous int32")
    code = _build.dtype_code(q.dtype)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    seg_q, seg_k, pos_q, pos_k = (
        None if t is None else t.to(torch.int32).contiguous()
        for t in (seg_q, seg_k, pos_q, pos_k))
    out = torch.empty((B, Sq, H, d), dtype=q.dtype, device=q.device)
    if tile_map is not None:
        tile_map.zero_()
    if B == 0 or Sq == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    fn = _build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 ctypes.addressof(strides), ptr(seg_q), ptr(seg_k),
                 ptr(pos_q), ptr(pos_k), ptr(tile_map), B, Sq, Sk, H, KV, d,
                 int(causal), int(window), int(q_offset),
                 Sk if kv_valid is None else int(kv_valid),
                 d ** -0.5 if scale is None else float(scale),
                 float(softcap), code,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention")
    mode_launches[mode(seg_q, pos_q)] += 1
    return out
