"""Decoder-only transformer: the PrefillOnly serving forwards.

Port of ``repro.models.transformer``'s ``head_weight``, ``forward_full``
(with ``embeds``, ``kv_keep``, ``positions``, ``seg_ids`` and
``kv_indices``), ``prefill``, ``prefill_packed``, ``prefill_with_prefix``,
``prefill_packed_with_prefix``, and the dense and MoE branches of
``init_cache``, ``_block_decode`` and ``decode_step`` (one token against a
KV cache, ring caches for sliding windows), for the dense, vlm, audio and
moe families
(``configs.base.check_ported``). ``forward_full``, ``prefill`` and
``prefill_with_prefix`` take precomputed embeddings (``embeds`` (B, S, D),
cast to the model dtype) in place of token ids, as the reference's do; the
packed forwards and ``decode_step`` take token ids only, as there.
Parameters keep the reference's stacked tree (``blocks/*`` with a leading
layer axis, ``embed/tok``, ``final_norm``; see ``models/params.py``), and
the layer scan becomes a Python loop over layers (``_layers``). An moe
config's blocks run ``models.moe.moe_apply`` in place of the MLP
(``_ffn``): the prefill forwards dispatch ``hybrid_chunk`` tokens at a
time, decode all of a step's tokens at once, as the reference does.

A local_global config (gemma2) runs its layers in (local, global) pairs
from ``blocks_local`` and ``blocks_global``: the local layer with the
sliding window, the global one without; token embeddings are scaled by
sqrt(d_model) rounded to the model dtype first; the KV tree is
{local_k, local_v, global_k, global_v}, and the decode cache pairs a ring
of ``min(window, max_len)`` slots (local) with a full cache (global). As in
the reference, ``forward_full``, ``prefill``, ``prefill_packed``,
``init_cache`` and ``decode_step`` take it; the prefix-cache hit forwards
do not (the reference's scan ``params["blocks"]``): they raise, naming
ROADMAP §C20. The fp8-weight branch comes with a later slice.

KV payloads keep the reference layout: (L, B, keep, KV, hd). The packed
forwards return per-segment logits and the fresh KV gathered at
``kv_indices`` (L, 1, K, KV, hd). ``decode_step`` updates its (L, B, S, KV,
hd) cache in place, layer by layer, where the reference returns a new one.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import (ModelConfig, check_ported,
                                      refuse_local_global)
from repro_torch.core.hybrid_prefill import (chunked_map, last_token_logits,
                                             packed_last_logits)
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.runtime.device import DeviceLike, resolve_device


def _inputs(params: Dict, cfg: ModelConfig, tokens: Optional[torch.Tensor],
            embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """The first residual stream (B, S, D): the embedding of ``tokens``,
    or ``embeds`` (the vlm stub's precomputed patch embeddings) cast to the
    model dtype. Always a tensor of the forward's own: the forward adds to
    it in place, and must not write into the caller's ``embeds``."""
    dtype = L.torch_dtype(cfg.dtype)
    if embeds is None:
        return _embed(params, cfg, tokens)
    return embeds.to(dtype=dtype, copy=True)


def _embed(params: Dict, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    """The token embedding; a local_global config (gemma2) scales it by
    sqrt(d_model) rounded to the model dtype first (59.75 at gemma2-9b's
    3584 in bf16), as the reference's ``jnp.asarray(..., dtype)`` does."""
    dtype = L.torch_dtype(cfg.dtype)
    x = L.embed_apply(params["embed"], tokens, dtype)
    if cfg.local_global:
        x *= torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)
    return x


def head_weight(params: Dict, cfg: ModelConfig) -> torch.Tensor:
    """LM head as (D, V): the tied embedding's transpose, or ``lm_head``."""
    w = params["embed"]["tok"].T if cfg.tie_embeddings else params["lm_head"]
    dt = L.torch_dtype(cfg.dtype)
    return w.to(dt) if w.dtype != dt else w


def layer_params(blocks: Dict, layer: int) -> Dict:
    """Layer ``layer``'s slice of the stacked block tree (views)."""
    return {k: (layer_params(v, layer) if isinstance(v, dict) else v[layer])
            for k, v in blocks.items()}


def _layers(params: Dict, cfg: ModelConfig) -> Iterator[Tuple]:
    """Each layer in the reference's order: (its block's parameters, its
    attention window, its KV tree's name prefix, its index in that stack).
    A local_global config runs ``num_layers // 2`` (local, global) pairs:
    the local block with the sliding window, the global one with none."""
    if cfg.local_global:
        for i in range(cfg.num_layers // 2):
            yield (layer_params(params["blocks_local"], i),
                   cfg.sliding_window, "local_", i)
            yield layer_params(params["blocks_global"], i), 0, "global_", i
    else:
        for i in range(cfg.num_layers):
            yield (layer_params(params["blocks"], i), cfg.sliding_window,
                   "", i)


def mlp_layers(cfg: ModelConfig) -> int:
    """Layers whose block runs the MLP (``layers.mlp_apply``, the fused MLP
    kernel): every layer of a dense config; at an moe config the layers
    with a shared expert, every one or none (``_ffn``)."""
    return cfg.num_layers if not cfg.is_moe or cfg.shared_expert else 0


def _ffn(bp: Dict, h: torch.Tensor, cfg: ModelConfig,
         chunk: int) -> torch.Tensor:
    """The block's feed-forward: the mixture of experts of an moe config,
    else the MLP; both chunked under hybrid prefilling."""
    if cfg.is_moe:
        return M.moe_apply(bp["moe"], h, cfg, hybrid_chunk=chunk)
    return L.mlp_apply(bp["mlp"], h, chunk=chunk)


def _block_full(bp: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, window: int, chunk: int,
                seg_ids: Optional[torch.Tensor] = None):
    """One layer over the whole sequence. The residual stream ``x`` (a
    tensor of the forward's own) is updated in place, as XLA reuses the
    buffer in the reference's scan, so a layer holds one stream, not three;
    each temporary is dropped once consumed."""
    h = L.rms_norm(x, bp["ln1"])
    attn, k, v = L.attention_prefill(bp["attn"], h, cfg, positions=positions,
                                     window=window, chunk=chunk,
                                     seg_ids=seg_ids)
    del h
    x += attn
    del attn
    h = L.rms_norm(x, bp["ln2"])
    x += _ffn(bp, h, cfg, chunk)
    return x, (k, v)


def _kv_out(cfg: ModelConfig, B: int, keep: int, dtype, device) -> Dict:
    """Preallocated (L, B, keep, KV, hd) KV output (layer-wise discard:
    each layer copies only its kept tokens in); a local_global config's
    {local_k, local_v, global_k, global_v}, each of L // 2 layers."""
    rest = (B, keep, cfg.num_kv_heads, cfg.head_dim)
    if cfg.local_global:
        half = cfg.num_layers // 2
        return {f"{pre}{n}": torch.empty((half,) + rest, dtype=dtype,
                                         device=device)
                for pre in ("local_", "global_") for n in ("k", "v")}
    shape = (cfg.num_layers,) + rest
    return {"k": torch.empty(shape, dtype=dtype, device=device),
            "v": torch.empty(shape, dtype=dtype, device=device)}


def forward_full(params: Dict, cfg: ModelConfig, *,
                 tokens: Optional[torch.Tensor] = None,
                 embeds: Optional[torch.Tensor] = None, kv_keep: int = 0,
                 positions: Optional[torch.Tensor] = None,
                 seg_ids: Optional[torch.Tensor] = None,
                 kv_indices: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (final-normed hidden (B, S, D), kv dict or None). The input
    is ``tokens`` (B, S) or, in their place, ``embeds`` (B, S, D).

    ``kv_keep`` is the PrefillOnly prefix budget: only the first ``kv_keep``
    tokens' KV leave each layer (suffix KV discard — layer-wise: each
    layer's full-length K/V is dropped once its attention is done, and only
    its keep slice is copied into the preallocated (L, B, keep, KV, hd)
    output).

    Prepacked prefill: ``positions`` (B, S) overrides the default arange —
    packed batches restart RoPE positions at every segment boundary — and
    ``seg_ids`` (B, S) restricts attention to same-segment pairs.
    ``kv_indices`` (K,) replaces the prefix budget: each layer's kept KV is
    the gather of those token positions, so per-segment keep windows
    scattered through the packed sequence cost K tokens, not S.
    """
    check_ported(cfg)
    dtype = L.torch_dtype(cfg.dtype)
    x = _inputs(params, cfg, tokens, embeds)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    chunk = cfg.hybrid_chunk
    if kv_indices is not None:
        kv_indices = kv_indices.to(device=x.device, dtype=torch.long)
        keep = kv_indices.shape[0]
    else:
        keep = min(kv_keep, S)
    kv = _kv_out(cfg, B, keep, dtype, x.device) if keep > 0 else None
    for bp, window, pre, i in _layers(params, cfg):
        x, (k, v) = _block_full(bp, x, cfg, positions=positions,
                                window=window, chunk=chunk, seg_ids=seg_ids)
        if kv is not None and kv_indices is not None:
            kv[pre + "k"][i].copy_(k.index_select(1, kv_indices))
            kv[pre + "v"][i].copy_(v.index_select(1, kv_indices))
        elif kv is not None:
            kv[pre + "k"][i].copy_(k[:, :keep])
            kv[pre + "v"][i].copy_(v[:, :keep])
        del k, v            # this layer's full-length K/V: gone before the
                            # next layer runs (layer-wise discard)
    return L.rms_norm(x, params["final_norm"]), kv


def prefill(params: Dict, cfg: ModelConfig, batch: Dict, *,
            kv_keep: int = 0, last_index: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """PrefillOnly serving prefill: (last-token logits (B, V) f32, prefix
    KV) of ``batch["tokens"]`` or, in their place, ``batch["embeds"]``."""
    hidden, kv = forward_full(params, cfg, tokens=batch.get("tokens"),
                              embeds=batch.get("embeds"), kv_keep=kv_keep)
    logits = last_token_logits(hidden, head_weight(params, cfg),
                               last_index=last_index,
                               final_softcap=cfg.final_softcap)
    return logits, kv


def prefill_packed(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                   seg_ids: torch.Tensor, positions: torch.Tensor,
                   last_indices: torch.Tensor, *, kv_keep: int = 0,
                   kv_indices: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Prepacked prefill: N requests packed into ONE contiguous sequence.

    tokens/seg_ids/positions: (1, S) — the packed sequence, its per-token
    segment index (negative = padding slack), and per-token positions that
    restart at 0 on every segment boundary. ``last_indices``: (N,) packed
    index of each segment's last token. Returns (per-segment last-token
    logits (N, V) f32, KV: the first ``kv_keep`` packed tokens or, for
    per-segment suffix discard, the gather of ``kv_indices`` (K,) packed
    positions). Attention runs through the kernel's segmented mode, so the
    result matches N independent ``prefill`` calls.
    """
    hidden, kv = forward_full(params, cfg, tokens=tokens, kv_keep=kv_keep,
                              positions=positions, seg_ids=seg_ids,
                              kv_indices=kv_indices)
    logits = packed_last_logits(hidden, head_weight(params, cfg),
                                last_indices,
                                final_softcap=cfg.final_softcap)
    return logits, kv


def prefill_with_prefix(params: Dict, cfg: ModelConfig, batch: Dict,
                        prefix_kv: Dict, prefix_len: int, *,
                        kv_keep: int = 0,
                        last_index: Optional[torch.Tensor] = None):
    """Prefill of a SUFFIX given a cached prefix's KV (prefix-cache hit path).

    tokens (or embeds) cover positions [prefix_len, prefix_len+S); every
    layer attends over concat(prefix KV, fresh suffix KV) with causal
    attention offset by ``prefix_len``. ``prefix_kv`` holds (L, B,
    prefix_len, KV, hd) tensors. Returns last-token logits + the suffix KV
    to extend the cache with (up to ``kv_keep`` total tokens — suffix
    discard). A local_global config raises (ROADMAP §C20).
    """
    check_ported(cfg)
    refuse_local_global(cfg, "prefill_with_prefix")
    dtype = L.torch_dtype(cfg.dtype)
    x = _inputs(params, cfg, batch.get("tokens"), batch.get("embeds"))
    B, S, _ = x.shape
    positions = (prefix_len + torch.arange(S, dtype=torch.int32,
                                           device=x.device)).expand(B, S)
    chunk = cfg.hybrid_chunk
    keep_new = max(0, min(kv_keep, prefix_len + S) - prefix_len)
    kv = _kv_out(cfg, B, keep_new, dtype, x.device)
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
        x = x + _ffn(bp, h, cfg, chunk)
        kv["k"][layer].copy_(k[:, :keep_new])
        kv["v"][layer].copy_(v[:, :keep_new])
    hidden = L.rms_norm(x, params["final_norm"])
    logits = last_token_logits(hidden, head_weight(params, cfg),
                               last_index=last_index,
                               final_softcap=cfg.final_softcap)
    return logits, kv


def packed_layout(prefix_lens: Sequence[int], suffix_lens: Sequence[int],
                  S: int, *, rows: int = 0, smax: int = 0, pmax: int = 0
                  ) -> Dict[str, torch.Tensor]:
    """Index inputs of one packed step, on the CPU: segment n's
    ``suffix_lens[n]`` tokens sit back to back in S slots (the rest is
    slack), each over its own cached prefix of ``prefix_lens[n]`` tokens
    (0 for a miss).

    Returns ``seg_ids`` (1, S) int32 (slack -1); ``positions`` (1, S) int32,
    RoPE positions restarting at each segment's own prefix length;
    ``last_indices`` (N,) each segment's last packed index; ``seg_qidx``
    (max(rows, N), smax >= every suffix) packed index of segment n's j-th
    suffix token (-1 = padding); ``prefix_pos`` (N, pmax) int32 absolute prefix positions,
    padding ``PAD_POS``. ``prefill_packed`` takes the first three,
    ``prefill_packed_with_prefix`` the last four."""
    N = len(suffix_lens)
    seg_ids = torch.full((1, S), -1, dtype=torch.int32)
    positions = torch.zeros((1, S), dtype=torch.int32)
    last = torch.zeros((N,), dtype=torch.long)
    seg_qidx = torch.full((max(rows, N), smax), -1, dtype=torch.long)
    prefix_pos = torch.full((N, pmax), L.PAD_POS, dtype=torch.int32)
    off = 0
    for n, (plen, slen) in enumerate(zip(prefix_lens, suffix_lens)):
        seg_ids[0, off:off + slen] = n
        positions[0, off:off + slen] = plen + torch.arange(slen)
        last[n] = off + slen - 1
        seg_qidx[n, :slen] = off + torch.arange(slen)
        prefix_pos[n, :plen] = torch.arange(plen)
        off += slen
    return {"seg_ids": seg_ids, "positions": positions,
            "last_indices": last, "seg_qidx": seg_qidx,
            "prefix_pos": prefix_pos}


def packed_prefix_layout(positions: torch.Tensor, prefix_pos: torch.Tensor,
                         seg_qidx: torch.Tensor):
    """Flat-layout ids and positions of the packed-hit attention.

    Queries are the packed (1, S) suffix tokens: ``seg_q`` is each packed
    token's row in ``seg_qidx`` (-1 for slack), ``pos_q = positions``. Keys
    are the (R, pmax) prefix buffer viewed as (1, R*pmax), then the (1, S)
    fresh tokens: a prefix slot carries its row's id where
    ``prefix_pos < PAD_POS`` and -1 on padding, with ``pos_k =
    prefix_pos``; a fresh token carries ``seg_q`` and ``positions``.
    Returns ``(seg_q, seg_k, pos_k)``, each (1, .) int32."""
    S = positions.shape[1]
    R, pmax = prefix_pos.shape
    dev = positions.device
    seg_qidx = seg_qidx.to(device=dev, dtype=torch.long)
    rows = torch.arange(seg_qidx.shape[0], device=dev,
                        dtype=torch.int32)[:, None].expand_as(seg_qidx)
    # a scatter with no host sync (a CUDA graph captures it): padding
    # entries (-1) all land in an extra last slot, which is dropped
    slot = torch.where(seg_qidx >= 0, seg_qidx, S).reshape(-1)
    seg_q = torch.full((S + 1,), -1, dtype=torch.int32, device=dev)
    seg_q = seg_q.scatter(0, slot, rows.reshape(-1))[:S]
    ppos = prefix_pos.to(device=dev, dtype=torch.int32)
    seg_p = torch.where(ppos < L.PAD_POS,
                        torch.arange(R, device=dev, dtype=torch.int32)[:, None],
                        torch.full_like(ppos, -1))
    seg_k = torch.cat([seg_p.reshape(1, R * pmax), seg_q[None]], dim=1)
    pos_k = torch.cat([ppos.reshape(1, R * pmax),
                       positions.to(torch.int32)], dim=1)
    return seg_q[None], seg_k, pos_k


def prefill_packed_with_prefix(params: Dict, cfg: ModelConfig,
                               tokens: torch.Tensor, positions: torch.Tensor,
                               last_indices: torch.Tensor, prefix_kv: Dict,
                               prefix_pos: torch.Tensor,
                               seg_qidx: torch.Tensor,
                               inv_idx: Optional[torch.Tensor] = None, *,
                               kv_indices: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Prepacked prefill of N SUFFIXES, each over its own cached prefix KV
    (the packed cache-HIT path).

    The reference's signature: tokens (1, S) packed suffix tokens;
    ``positions`` (1, S) RoPE positions restarting at each segment's own
    prefix length; ``last_indices`` (N,); ``prefix_kv`` {"k","v"} (L, R,
    pmax, KV, hd), row n = segment n's cached prefix, zero-padded to pmax;
    ``prefix_pos`` (R, pmax) the prefix tokens' absolute positions, padding
    = ``PAD_POS``; ``seg_qidx`` (Nb, smax) packed index of segment n's j-th
    suffix token, -1 = padding; ``inv_idx`` (the reference's scatter-back
    map of its batched layout) is not needed by the flat layout and is
    accepted for the signature's sake. R may be Nb, or fewer when the
    caller leaves the ghost rows out.

    The reference computes this attention as a batched per-segment einsum.
    Here every layer runs the kernel's positioned mode over a flat layout
    (``packed_prefix_layout``): the packed queries against concat(prefix
    buffer viewed as (1, R*pmax), fresh (1, S) KV); a query block visits
    only its own segment's prefix tiles and its own fresh tiles. The result
    matches N independent ``prefill_with_prefix`` calls.

    Returns (per-segment last-token logits (N, V) f32, fresh KV gathered at
    ``kv_indices`` (L, 1, K, KV, hd), or None without ``kv_indices``). A
    local_global config raises (ROADMAP §C20).
    """
    check_ported(cfg)
    refuse_local_global(cfg, "prefill_packed_with_prefix")
    dtype = L.torch_dtype(cfg.dtype)
    x = L.embed_apply(params["embed"], tokens, dtype)
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    R, pmax = prefix_pos.shape
    chunk = cfg.hybrid_chunk
    positions = positions.to(device=x.device)
    seg_q, seg_k, pos_k = packed_prefix_layout(positions, prefix_pos,
                                               seg_qidx)
    kv = None
    if kv_indices is not None:
        kv_indices = kv_indices.to(device=x.device, dtype=torch.long)
        kv = _kv_out(cfg, B, kv_indices.shape[0], dtype, x.device)
    for layer in range(cfg.num_layers):
        bp = layer_params(params["blocks"], layer)
        h = L.rms_norm(x, bp["ln1"])
        q, k, v = L._qkv_project(bp["attn"], h, cfg, positions, chunk)
        pk = prefix_kv["k"][layer].reshape(1, R * pmax, KV, hd)
        pv = prefix_kv["v"][layer].reshape(1, R * pmax, KV, hd)
        k_full = torch.cat([pk.to(k.dtype), k], dim=1)
        v_full = torch.cat([pv.to(v.dtype), v], dim=1)
        out = L.attention(q, k_full, v_full, window=cfg.sliding_window,
                          softcap=cfg.attn_softcap, seg_q=seg_q, seg_k=seg_k,
                          pos_q=positions, pos_k=pos_k)
        out = out.reshape(B, S, H * hd)
        x = x + chunked_map(lambda oc: oc @ bp["attn"]["wo"], out, chunk)
        h = L.rms_norm(x, bp["ln2"])
        x = x + _ffn(bp, h, cfg, chunk)
        if kv is not None:
            kv["k"][layer].copy_(k.index_select(1, kv_indices))
            kv["v"][layer].copy_(v.index_select(1, kv_indices))
    hidden = L.rms_norm(x, params["final_norm"])
    logits = packed_last_logits(hidden, head_weight(params, cfg),
                                last_indices,
                                final_softcap=cfg.final_softcap)
    return logits, kv


# --------------------------------------------------------------------------
# decode (one token against a KV cache)
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Zeroed KV cache {"k", "v"}, each (L, batch, s, KV, hd) in
    ``cfg.dtype``: ``s = max_len``, or ``min(sliding_window, max_len)`` for
    a sliding-window config, whose cache is a ring buffer bounded by the
    window. A local_global config (gemma2) gets the reference's pair:
    {local_k, local_v} rings of ``min(sliding_window, max_len)`` slots and
    {global_k, global_v} of ``max_len``, each of L // 2 layers."""
    check_ported(cfg)
    dev = resolve_device(device)
    dtype = L.torch_dtype(cfg.dtype)
    rest = (batch, cfg.num_kv_heads, cfg.head_dim)

    def zeros(n: int, s: int) -> torch.Tensor:
        return torch.zeros((n, rest[0], s) + rest[1:], dtype=dtype,
                           device=dev)

    if cfg.local_global:
        half, w = cfg.num_layers // 2, min(cfg.sliding_window, max_len)
        return {"local_k": zeros(half, w), "local_v": zeros(half, w),
                "global_k": zeros(half, max_len),
                "global_v": zeros(half, max_len)}
    s = min(cfg.sliding_window, max_len) if cfg.sliding_window else max_len
    return {"k": zeros(cfg.num_layers, s), "v": zeros(cfg.num_layers, s)}


def _block_decode(bp: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                  position: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                  ring: bool) -> torch.Tensor:
    """One layer of a decode step; writes the token's k/v into ``kc``/``vc``
    in place."""
    h = L.rms_norm(x, bp["ln1"])
    attn, _, _ = L.attention_decode(bp["attn"], h, cfg, position=position,
                                    k_cache=kc, v_cache=vc, ring=ring)
    x = x + attn
    h = L.rms_norm(x, bp["ln2"])
    return x + _ffn(bp, h, cfg, 0)


def decode_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], position: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens: (B,) ints; position: (B,) ints (uniform: row 0's position is
    the step's) on the parameters' device. Returns (logits (B, V) f32,
    cache): ``cache`` is the same dict, its tensors updated in place with
    the token's k/v at slot ``position[0]`` (mod the window for a ring) in
    every layer. A local_global config's local layers write their rings,
    its global layers their full caches (the reference's pair scan)."""
    check_ported(cfg)
    x = _embed(params, cfg, tokens[:, None])
    for bp, window, pre, i in _layers(params, cfg):
        x = _block_decode(bp, x, cfg, position=position,
                          kc=cache[pre + "k"][i], vc=cache[pre + "v"][i],
                          ring=bool(window))
    hidden = L.rms_norm(x, params["final_norm"])
    logits = last_token_logits(hidden, head_weight(params, cfg),
                               final_softcap=cfg.final_softcap)
    return logits, cache
