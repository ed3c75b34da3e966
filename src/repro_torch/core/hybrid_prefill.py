"""Hybrid prefilling (paper §4) — chunk non-attention layers, not attention.

Port of ``repro.core.hybrid_prefill``'s ``chunked_map``,
``last_token_logits`` and ``packed_last_logits``. Chunking only the token-wise (linear) layers bounds
their intermediates at ``(chunk, d_ff)`` while attention still sees the
whole sequence, so a request finishes in ONE forward pass (the property
that makes suffix-KV discard possible).

The reference realizes the chunk loop as ``lax.map``, whose scan writes
each chunk's result into a preallocated stacked output; here it is a Python
loop that writes each chunk into a preallocated output tensor — the paper's
"output preallocation" optimization, stated explicitly.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

# bytes of the f32 copy of the head weight that _head_logits makes at a
# time: 16384 vocab columns at qwen1.5-0.5b's d_model of 1024, 4096 at
# granite-3-8b's 4096 (a 256 MiB copy there would take a segment of its own
# in every CUDA graph's capture)
HEAD_CHUNK_BYTES = 64 << 20


def chunked_map(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                chunk: int, axis: int = 1) -> torch.Tensor:
    """Apply a token-wise ``fn`` over ``axis`` in chunks of ``chunk``.

    ``fn`` must be position-independent along ``axis`` (true for every
    linear/MLP/norm layer) and keep that axis' length; its other output
    dims may differ from the input's. Peak live intermediates inside ``fn``
    are bounded by one chunk.
    """
    n = x.shape[axis]
    if chunk <= 0 or n <= chunk:
        return fn(x)
    out = None
    for lo in range(0, n, chunk):
        y = fn(x.narrow(axis, lo, min(chunk, n - lo)))
        if out is None:
            shape = list(y.shape)
            shape[axis] = n
            out = torch.empty(shape, dtype=y.dtype, device=y.device)
        out.narrow(axis, lo, y.shape[axis]).copy_(y)
    return out


def _head_logits(last: torch.Tensor, w_head: torch.Tensor,
                 final_softcap: float) -> torch.Tensor:
    """(N, D) rows -> (N, V) f32 logits; the f32 upcast of the head weight
    is made ``HEAD_CHUNK_BYTES`` at a time."""
    last = last.float()
    D, V = w_head.shape
    logits = torch.empty((last.shape[0], V), dtype=torch.float32,
                         device=last.device)
    step = max(1, HEAD_CHUNK_BYTES // (4 * D))      # vocab columns
    for lo in range(0, V, step):
        hi = min(V, lo + step)
        logits[:, lo:hi] = last @ w_head[:, lo:hi].float()
    if final_softcap:
        logits = final_softcap * torch.tanh(logits / final_softcap)
    return logits


def packed_last_logits(hidden: torch.Tensor, w_head: torch.Tensor,
                       last_indices: torch.Tensor,
                       final_softcap: float = 0.0) -> torch.Tensor:
    """Prefill-only LM head for a PREPACKED batch: one f32 logits row per
    packed segment. ``last_indices`` (N,) are flat indices into the
    flattened (B*S,) token axis — for the engine's B == 1 layout, each
    segment's last packed position. Projects only N rows."""
    B, S, D = hidden.shape
    last = hidden.reshape(B * S, D).index_select(
        0, last_indices.to(torch.long))
    return _head_logits(last, w_head, final_softcap)


def last_token_logits(hidden: torch.Tensor, w_head: torch.Tensor,
                      last_index: Optional[torch.Tensor] = None,
                      final_softcap: float = 0.0) -> torch.Tensor:
    """Prefill-only LM head: project ONLY the last position -> (B, V) f32.

    ``w_head`` is (D, V). Products of model-dtype operands accumulate in f32
    (the reference's ``preferred_element_type=float32``); the f32 upcast of
    the head weight is made ``HEAD_CHUNK_BYTES`` at a time.
    """
    B, S, D = hidden.shape
    if last_index is None:
        last = hidden[:, -1, :]
    else:
        idx = last_index.reshape(B, 1, 1).to(torch.long).expand(B, 1, D)
        last = torch.gather(hidden, 1, idx)[:, 0, :]
    return _head_logits(last, w_head, final_softcap)
