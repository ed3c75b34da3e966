"""Flash decoding: one query token per (batch row, query head) against a
deep KV cache, with a per-row ``kv_len`` mask and an optional tanh softcap.

Replaces the Pallas kernel ``repro/kernels/decode_attention.py::
decode_attention`` at the layout of its wrapper ``repro.kernels.ops.
decode_attention``: q (B, 1, H, d), caches (B, S, KV, d), ``kv_len`` (B,)
-> (B, 1, H, d). Query head h reads kv head ``h // (H // KV)``; slots
``>= kv_len[b]`` are masked (``kv_len >= S`` makes every slot live); the
scale is ``d ** -0.5``. Scores, softmax and P.V are f32, with p kept in f32
as the Pallas kernel keeps it; the result is cast to q's dtype. Any S is
taken: the cache is neither padded nor copied. Head dims are a rule of
dtype, width and group (``width_rule``): 32, 64, 96, 128 and 256 in both
dtypes (qwen1.5-0.5b's 64, phi3-mini-3.8b's 96, granite-3-8b's 128,
gemma2-9b's 256), but head_dim 96 only at G = 1 (the tensor-core kernel's
16-byte column pieces, 12 a row, do not tile its 128 threads; phi3 is
MHA); any other width raises before a launch (head_dim 80 comes with
ROADMAP §A6.4). At most ``MAX_GROUP`` query heads per kv
head.

The Pallas grid (B, KV, splits) walks the splits serially with an (m, l,
acc) carry. The Hopper kernels (``csrc/decode_attention.cu``) run the
splits in parallel, (B*KV, splits) blocks, each over one chunk of whole
``KEY_TILE``-slot tiles up to ``kv_len[b]`` (a chunk past it loads
nothing), and a combine kernel merges the splits' f32 partials. Which
kernel runs is a rule of dtype and group (``kernel_rule``): bf16 at G >= 2
takes the tensor-core kernel (K and V through a shared-memory ``cp.async``
ring, each tile's scores once per key on ``mma.sync``, P.V in f32), bf16 at
G = 1 and f32 the CUDA-core GEMV kernel. The number of splits is
``split_rule`` of (B*KV, S), the card's SM count and the resident blocks a
SM of the kernel that will run (``_blocks_per_sm``, a host query made once
per kernel): one wave of blocks where the rows fit one. It reads no
``kv_len`` on the host, so a decode step never waits on the device.

A row with ``kv_len = 0`` gives 0 (the reference's softmax over no live
slot gives the mean of V instead; see ROADMAP §C). ``decode_attention``
launches the kernel for CUDA tensors and uses ``decode_attention_plain`` for
CPU tensors; ``launches`` counts calls that launched it (one per call: the
split kernel and its combine).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import TO_COME

NEG_INF = -1e30
# head dims instantiated in csrc/decode_attention.cu, by dtype (width_rule)
HEAD_DIMS = {torch.bfloat16: (32, 64, 96, 128, 256),
             torch.float32: (32, 64, 96, 128, 256)}
# head dims built at G = 1 only, in both dtypes (width_rule)
SOLO_DIMS = (96,)
MAX_GROUP = 8                       # query heads per kv head
KEY_TILE = 64                       # slots a key tile; chunks are whole tiles
# split rule, where the rows alone fill a wave: a block's fixed cost (its
# prologue, the ring's first tiles in flight, the merge and its partial) in
# tiles' worth of streaming
BLOCK_OVERHEAD_TILES = 2
MAX_SPLITS = 65535                  # the grid's y dimension
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 7     # q, k, v, kv_len, out, ws, strides
             + [ctypes.c_int] * 7      # B, S, H, KV, d, splits, chunk
             + [ctypes.c_float, ctypes.c_float,         # scale, softcap
                ctypes.c_int, ctypes.c_int,             # dtype, tensor cores
                ctypes.c_void_p])                       # stream
_OCC_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p]  # dtype, d, G, tc, out


class Plan(NamedTuple):
    """A launch of the split kernel: which kernel (``kernel_rule``), the
    key split, the resident blocks a SM it was planned for, its blocks and
    the waves they make on the card."""
    kernel: str
    splits: int
    chunk: int
    per_sm: int
    blocks: int
    waves: float


def kernel_rule(G: int, dtype) -> str:
    """``"tc"``, the tensor-core kernel, for bf16 at G >= 2 (GQA: a key
    tile's scores are one mma per 16 keys for up to 8 heads); ``"gemv"``,
    the CUDA-core kernel, for bf16 at G = 1 (a GEMV, where the mma's 8
    head columns would be 7 of padding) and for f32 (no f32 mma that keeps
    f32 scores). A rule of dtype and group, held before every launch."""
    return "tc" if dtype == torch.bfloat16 and G >= 2 else "gemv"


@functools.lru_cache(maxsize=None)
def split_rule(rows: int, S: int, n_sm: int,
               per_sm: int) -> Tuple[int, int]:
    """(splits, chunk) for ``rows = B * KV`` (batch row, kv head) pairs over
    S slots on a card of ``n_sm`` SMs that holds ``per_sm`` blocks of the
    kernel at once (``slots = n_sm * per_sm``). Every chunk is a whole
    number of ``KEY_TILE`` slots and ``splits * chunk >= S > (splits - 1) *
    chunk`` for S > 0.

    The kernel is bound by bytes, so its time is the live slots' bytes over
    the card's rate while its resident blocks keep that rate, and a wave
    that leaves most slots empty (576 blocks of granite's decode on 528
    slots: a second wave of 48) runs at a fraction of it.
    Where the rows fit one wave, the grid is one wave: the most splits whose
    blocks the card holds at once. Where the rows alone fill a wave, the
    chunking whose waves times a block's work (its tiles plus
    ``BLOCK_OVERHEAD_TILES``) is least, the fewer splits on a tie, so the
    last wave's share is small. A pure function of shapes and the two card
    numbers."""
    tiles = max(1, -(-S // KEY_TILE))
    slots = max(1, n_sm * per_sm)
    if rows <= slots:
        chunk = -(-tiles // min(tiles, slots // max(rows, 1), MAX_SPLITS))
        return -(-tiles // chunk), chunk * KEY_TILE
    best = None
    for chunk in range(tiles, 0, -1):
        splits = -(-tiles // chunk)
        if splits > MAX_SPLITS:
            break
        if -(-tiles // splits) != chunk:       # not a distinct chunking
            continue
        cost = -(-rows * splits // slots) * (chunk + BLOCK_OVERHEAD_TILES)
        if best is None or cost < best[0]:
            best = (cost, splits, chunk)
    return best[1], best[2] * KEY_TILE


def launch_plan(B: int, S: int, H: int, KV: int, dtype, n_sm: int,
                per_sm: int) -> Plan:
    """The plan of a call at these shapes on a card of ``n_sm`` SMs that
    holds ``per_sm`` blocks of its kernel."""
    splits, chunk = split_rule(B * KV, S, n_sm, per_sm)
    blocks = B * KV * splits
    return Plan(kernel_rule(H // KV, dtype), splits, chunk, per_sm, blocks,
                blocks / (n_sm * per_sm))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(index: int, dtype_code: int, d: int, G: int,
                   tc: bool) -> int:
    """Resident blocks a SM of the split kernel for (dtype, d, G, kernel)
    on device ``index``: ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``,
    a host query that launches nothing; made once, at the first call (the
    eager warm-up, before any graph capture)."""
    fn = _build.function("decode_attention", "decode_attention_occupancy",
                         _OCC_ARGTYPES)
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = fn(dtype_code, d, G, int(tc), ctypes.addressof(out))
    _build.check(err, "decode_attention occupancy")
    if out.value < 1:
        raise RuntimeError(f"decode_attention: the kernel for d {d}, G {G} "
                           f"fits no block on an SM")
    return out.value


def _check(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           kv_len: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4 \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} (B, 1, H, d),"
                         f" caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} (B, S, KV, d)")
    B, _, H, d = q.shape
    _, _, KV, dk = k_cache.shape
    if k_cache.shape[0] != B or dk != d or KV == 0 or H % KV:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not fit "
                         f"caches {tuple(k_cache.shape)}")
    if tuple(kv_len.shape) != (B,) or kv_len.is_floating_point():
        raise ValueError(f"decode_attention: kv_len must be (B,) = ({B},) "
                         f"integers, got {tuple(kv_len.shape)} {kv_len.dtype}")


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                           softcap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version (``repro.kernels.ref.decode_attention_ref`` at
    the ``ops`` layout): f32 scores, softmax and P.V, cast to q's dtype; a
    row with no live slot gives 0."""
    _check(q, k_cache, v_cache, kv_len)
    B, _, H, d = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qf = q.reshape(B, KV, G, d).float() * d ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    live = (torch.arange(S, device=q.device)[None, :]
            < kv_len.to(q.device).reshape(B, 1))[:, None, None, :]
    s = s.masked_fill(~live, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * live
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, 1, H, d).to(q.dtype)


def width_rule(d: int, dtype, G: int = 1) -> None:
    """Raise unless the kernel for ``dtype`` is built for head_dim ``d`` at
    ``G`` query heads per kv head: a rule of dtype, width and group, held
    before every launch. Both dtypes take d in (32, 64, 96, 128, 256): the
    GEMV kernel reads a key row in 16-byte packs, LPK lanes of NP packs
    each (LPK divides the warp: 3 packs a lane at d = 96); the tensor-core
    kernel (bf16, G >= 2) needs d / 8 to divide its 128 threads, so d = 96
    (``SOLO_DIMS``) takes G = 1 only, in both dtypes. head_dim 80 names the
    ROADMAP item that brings it."""
    dims = HEAD_DIMS.get(dtype)
    if dims is None:
        raise TypeError(f"decode_attention: kernels take float32 or "
                        f"bfloat16, not {dtype}")
    if d not in dims:
        later = f"; head_dim {d} comes with {TO_COME[d]}" if d in TO_COME \
            else ""
        raise ValueError(
            f"decode_attention: head_dim {d} is not built for {dtype} (rule "
            f"of dtype and width: bfloat16 takes {HEAD_DIMS[torch.bfloat16]}"
            f", float32 {HEAD_DIMS[torch.float32]}{later})")
    if d in SOLO_DIMS and G > 1:
        raise ValueError(
            f"decode_attention: head_dim {d} takes one query head per kv "
            f"head, not {G} (rule of dtype and width: the tensor-core "
            f"kernel's 16-byte column pieces, {d // 8} a row, do not tile its "
            f"128 threads)")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                     softcap: float = 0.0) -> torch.Tensor:
    """q: (B, 1, H, d); k_cache, v_cache: (B, S, KV, d); kv_len: (B,) ints
    -> (B, 1, H, d).

    The caches may be strided views (a layer of a stacked cache, a slice of
    its slots or heads) with unit stride over d and 16-byte aligned rows;
    anything else raises rather than being copied."""
    _check(q, k_cache, v_cache, kv_len)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, kv_len,
                                      softcap=softcap)
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in (k_cache, v_cache, kv_len)):
        raise ValueError("decode_attention: q, the caches and kv_len must "
                         "share one CUDA device")
    B, _, H, d = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    width_rule(d, q.dtype, H // KV)
    if H // KV > MAX_GROUP:
        raise ValueError(f"decode_attention: {H // KV} query heads per kv "
                         f"head, the kernel takes at most {MAX_GROUP}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise ValueError("decode_attention: q and cache dtypes differ")
    code = _build.dtype_code(q.dtype)
    vec = 16 // q.element_size()             # elements per 16-byte load
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if (t.stride(-1) != 1 or any(st % vec for st in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(
                f"decode_attention: {name} strides {t.stride()} must be 1 "
                f"over d and multiples of {vec} elements, from a 16-byte "
                f"aligned address (the kernel reads 16-byte rows; it does "
                f"not copy the cache)")
    if q.stride(-1) != 1:
        q = q.contiguous()                   # one token: (B, H, d) is tiny
    kv_len = kv_len.to(torch.int32).contiguous()
    out = torch.empty((B, 1, H, d), dtype=q.dtype, device=q.device)
    if B == 0 or H == 0:
        return out
    G = H // KV
    tc = kernel_rule(G, q.dtype) == "tc"
    index = q.device.index
    splits, chunk = split_rule(B * KV, S, _sm_count(index),
                               _blocks_per_sm(index, code, d, G, tc))
    ws = torch.empty(B * KV * splits * G * (d + 2),
                     dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 8)(
        q.stride(0), q.stride(2), *k_cache.stride()[:3],
        *v_cache.stride()[:3])
    fn = _build.function("decode_attention", "decode_attention_fwd",
                         _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 kv_len.data_ptr(), out.data_ptr(), ws.data_ptr(),
                 ctypes.addressof(strides), B, S, H, KV, d, splits, chunk,
                 d ** -0.5, float(softcap), code, int(tc),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "decode_attention")
    global launches
    launches += 1
    return out
