"""Blocked flash attention, dense mode with a query offset.

Replaces the dense mode of the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention`` (no ``seg_*``, no
``pos_*``), plus ``q_offset``: query row i sits at absolute position
``q_offset + i`` against keys at positions ``0..Sk-1`` (bottom-right causal
alignment), which the prefix-cache-hit forward needs and the Pallas dense
mode lacks. Causal, sliding window, tanh softcap, GQA (query head h reads kv
head ``h // (H // KV)``) and a ``kv_valid`` padded-key mask.

The Hopper kernel (``csrc/flash_attention.cu``) turns the Pallas grid's
sequential kv axis into a loop inside the block and keeps the f32 query row
and accumulator of each of its 32 query rows in registers; it visits only
the block's live key range, so wholly masked tiles are never loaded. It is
bound by bytes at the main path's shapes (head_dim 64, S <= 2K), but this
first version computes with f32 FMAs rather than tensor cores. A finite
``NEG_INF`` and explicit zero weights for masked keys keep fully masked
rows finite (they return 0).

Layout at both functions: q (B, Sq, H, d), k/v (B, Sk, KV, d) -> (B, Sq, H,
d), the model layer's layout (``repro.kernels.ops.flash_attention``'s).
``flash_attention`` launches the kernel for CUDA tensors and uses
``flash_attention_plain`` for CPU tensors; ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64)                # instantiated in csrc/flash_attention.cu

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 5                           # q, k, v, o, strides
             + [ctypes.c_int] * 10                           # B..kv_valid
             + [ctypes.c_float, ctypes.c_float,              # scale, softcap
                ctypes.c_int, ctypes.c_void_p])              # dtype, stream


def _live_mask(Sq: int, Sk: int, *, causal: bool, window: int,
               q_offset: int, kv_valid: Optional[int],
               device) -> torch.Tensor:
    qpos = q_offset + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    live = kpos < (Sk if kv_valid is None else min(Sk, kv_valid))
    if causal:
        live = live & (qpos >= kpos)
    if window > 0:
        live = live & ((qpos - kpos) < window)
    return live                                          # (Sq, Sk)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, q_offset: int = 0,
                          kv_valid: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version: full softmax over live keys, f32 internals."""
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
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
                      q_offset=q_offset, kv_valid=kv_valid, device=q.device)
    s = s.masked_fill(~live, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * live
    out = torch.einsum("bhqk,bkhd->bhqd", p, vf)
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0,
                    kv_valid: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, d); k, v: (B, Sk, KV, d) -> (B, Sq, H, d)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, q_offset=q_offset,
                                     kv_valid=kv_valid, scale=scale)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must share one CUDA device")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, d = q.shape
    _, Sk, KV, dk = k.shape
    if k.shape[0] != B or dk != d or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention: q, k, v dtypes differ")
    code = _build.dtype_code(q.dtype)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((B, Sq, H, d), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    fn = _build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 ctypes.addressof(strides), B, Sq, Sk, H, KV, d, int(causal),
                 int(window), int(q_offset),
                 Sk if kv_valid is None else int(kv_valid),
                 d ** -0.5 if scale is None else float(scale),
                 float(softcap), code,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention")
    global launches
    launches += 1
    return out
