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

The Hopper kernels (``csrc/flash_attention.cu``) turn the Pallas grid's
sequential kv axis into a loop inside the block, and are chosen by dtype:

- bf16, the model path: FlashAttention-2-style tiles on the tensor cores
  (``mma.sync`` m16n8k16): 4 warps own ``BLOCK_Q`` = 64 query rows, K/V
  tiles of ``BLOCK_K`` = 64 keys come through a 2-stage ``cp.async`` ring,
  the online softmax runs on the f32 accumulator fragments, and p is
  rounded to bf16 before P.V (the Pallas kernel and the plain version keep
  it in f32; ROADMAP §C4). Where ``ceil(Sq/64) * H * B`` blocks are fewer
  than the SMs, ``split_rule`` splits the key tiles into chunks whose f32
  partials a combine kernel merges. q, k and v rows must be 16-byte
  aligned (element strides multiples of 8); anything else raises.
- float32: the tensor cores take f32 only as TF32, so f32 keeps the
  CUDA-core kernel: one warp per block, one thread per query row of
  ``F32_BLOCK`` = 32, f32 FMAs.

Both skip whole key tiles that cannot be live, as the Pallas kernel's range
tests do (structural causal/window range; segment-id ranges that do not
meet; no ``seg_k >= 0``; position ranges that fail the causal or window
test), with the ranges taken over real tokens only, so a skipped tile is
never loaded. ``tile_map`` (the Pallas ``debug_tile_map``'s counterpart)
records which tiles the kernel ran, at the kernel's tile size
(``tile_shape(dtype)``); the plain version runs no tiles and has no map.
Masked keys get no weight, so fully masked rows return 0 (the Pallas
kernel and ``ref.packed_flash_attention_ref`` give such padding rows a
uniform average instead; see ROADMAP §C).

Layout at both functions: q (B, Sq, H, d), k/v (B, Sk, KV, d) -> (B, Sq, H,
d), the model layer's layout (``repro.kernels.ops.flash_attention``'s).
``flash_attention`` launches the kernel for CUDA tensors and uses
``flash_attention_plain`` for CPU tensors; ``mode_launches`` counts calls
that launched it, by mode (one per call, the combine included), and
``launches`` is their sum.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64)                # instantiated in csrc/flash_attention.cu
BLOCK_Q = BLOCK_K = 64              # the bf16 kernel's query block, key tile
F32_BLOCK = 32                      # the f32 kernel's query block and key tile
MODES = ("dense", "segmented", "positioned")

mode_launches = dict.fromkeys(MODES, 0)

_ARGTYPES = ([ctypes.c_void_p] * 10                          # q, k, v, o,
             # strides, seg_q, seg_k, pos_q, pos_k, tile_map
             + [ctypes.c_int] * 10                           # B..kv_valid
             + [ctypes.c_float, ctypes.c_float]              # scale, softcap
             + [ctypes.c_int, ctypes.c_int]                  # splits, chunk
             + [ctypes.c_void_p, ctypes.c_void_p]            # partials
             + [ctypes.c_int, ctypes.c_void_p])              # dtype, stream


def tile_shape(dtype) -> Tuple[int, int]:
    """(query block, key tile) of the kernel that takes ``dtype``: the
    granularity of its executed-tile map."""
    if dtype == torch.float32:
        return F32_BLOCK, F32_BLOCK
    return BLOCK_Q, BLOCK_K


def split_rule(B: int, Sq: int, H: int, Sk: int,
               n_sm: int) -> Tuple[int, int]:
    """(splits, chunk) of the bf16 kernel's key tiles on a card of
    ``n_sm`` SMs: no split when ``ceil(Sq/BLOCK_Q) * H * B`` blocks fill the
    SMs; else enough chunks of ``chunk`` whole ``BLOCK_K`` tiles to reach
    ``n_sm`` blocks; ``splits * chunk >= ceil(Sk/BLOCK_K) > (splits - 1) *
    chunk``. A rule of shapes: it reads no ids or positions, so the host
    never waits on the device."""
    nk = max(1, -(-Sk // BLOCK_K))
    blocks = -(-Sq // BLOCK_Q) * H * B
    if blocks == 0 or blocks >= n_sm:
        return 1, nk
    chunk = -(-nk // min(nk, -(-n_sm // blocks)))
    return -(-nk // chunk), chunk


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    Sk = k.shape[1]
    _check_modes(B, Sq, Sk, q_offset, seg_q, seg_k, pos_q, pos_k)
    live = _live_mask(Sq, Sk, causal=causal, window=window,
                      q_offset=q_offset, kv_valid=kv_valid, device=q.device,
                      seg_q=seg_q, seg_k=seg_k, pos_q=pos_q, pos_k=pos_k)
    return attend_plain(q, k, v, live, scale=scale, softcap=softcap)


def attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 live: torch.Tensor, *, scale: Optional[float] = None,
                 softcap: float = 0.0) -> torch.Tensor:
    """The plain version's arithmetic over an explicit (Sq, Sk) or (B, Sq,
    Sk) live mask (``_live_mask``'s)."""
    d = q.shape[-1]
    G = q.shape[2] // k.shape[2]
    if scale is None:
        scale = d ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(G, dim=2)           # (B, Sk, H, d)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
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
    segment ids. ``tile_map``, when given, is a (B, ceil(Sq/bq),
    ceil(Sk/bk)) int32 buffer on q's CUDA device, ``(bq, bk) =
    tile_shape(q.dtype)``, that receives the kernel's executed-tile map
    (1 = the tile ran); CPU tensors take no map."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, d = q.shape
    _, Sk, KV, dk = k.shape
    _check_modes(B, Sq, Sk, q_offset, seg_q, seg_k, pos_q, pos_k)
    bq, bk = tile_shape(q.dtype)
    if tile_map is not None and tuple(tile_map.shape) != (
            B, -(-Sq // bq), -(-Sk // bk)):
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
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
                raise ValueError(
                    f"flash_attention: {name} strides {t.stride()} must be "
                    f"multiples of 8 elements from a 16-byte aligned "
                    f"address (the bf16 kernel copies 16-byte rows)")
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
    splits, chunk, part_acc, part_ml = 1, max(1, -(-Sk // bk)), None, None
    if q.dtype == torch.bfloat16:
        splits, chunk = split_rule(B, Sq, H, Sk, _sm_count(q.device.index))
    if splits > 1:
        part_acc = torch.empty((splits, B, H, Sq, d), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((splits, B, H, Sq, 2), dtype=torch.float32,
                              device=q.device)
    fn = _build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 ctypes.addressof(strides), ptr(seg_q), ptr(seg_k),
                 ptr(pos_q), ptr(pos_k), ptr(tile_map), B, Sq, Sk, H, KV, d,
                 int(causal), int(window), int(q_offset),
                 Sk if kv_valid is None else int(kv_valid),
                 d ** -0.5 if scale is None else float(scale),
                 float(softcap), splits, chunk, ptr(part_acc), ptr(part_ml),
                 code, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention")
    mode_launches[mode(seg_q, pos_q)] += 1
    return out
