"""KV keep/discard policy (copy of ``repro.core.kv_policy``'s ``bucket`` and
``KVLifecycle``; the memory model comes with the offload slice)."""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


def bucket(n: int, sizes: Sequence[int]) -> int:
    """Smallest bucket >= n; grows geometrically past the table (clamping
    would truncate requests longer than the largest configured bucket)."""
    for s in sizes:
        if n <= s:
            return s
    s = sizes[-1]
    while s < n:
        s *= 2
    return s


@dataclasses.dataclass(frozen=True)
class KVLifecycle:
    """SINGLE OWNER of the KV keep/discard decision (paper §2.6/§4).

    The engine's forward paths discard suffix KV layer-by-layer (only the
    keep-slice of each layer is copied out in ``models/transformer.py`` —
    each layer's full-length K/V is dropped as soon as its attention has
    consumed it), and the prefix cache only ever receives whole blocks of
    the kept slice. Every keep-budget, residency and insert-bound decision
    of the engine asks this object, so the policy is stated (and tested)
    once.

    All methods are pure shape/token arithmetic — safe to call under the
    engine lock and from routing probes.
    """
    block_size: int = 16
    kv_keep_tokens: int = 10**9             # suffix-discard threshold
    buckets: Tuple[int, ...] = (64, 128, 256, 512, 1024, 2048)

    def keep(self, n_input: int) -> int:
        """Per-request KV budget in tokens (the kept prefix slice)."""
        return min(n_input, self.kv_keep_tokens)

    def keep_aligned(self, n_input: int) -> int:
        """Budget rounded DOWN to whole cache blocks — only full blocks are
        insertable, so this is the most KV a request can leave behind."""
        return (self.keep(n_input) // self.block_size) * self.block_size

    def resident(self, matched_blocks: int, n_input: int) -> bool:
        """Chain already resident past the keep bound: an insert would only
        re-slice and re-touch existing blocks, so callers skip it."""
        return matched_blocks * self.block_size >= self.keep_aligned(n_input)

    def keep_new(self, n_input: int, prefix_len: int,
                 matched_blocks: int) -> int:
        """Block-aligned NEW kept tokens beyond a reused prefix (packed
        path's per-segment kv gather length; 0 when already resident)."""
        if self.resident(matched_blocks, n_input):
            return 0
        return max(0, self.keep_aligned(n_input) - prefix_len)

    def suffix_keep_new(self, keep: int, prefix_len: int, n_fresh: int) -> int:
        """Fresh-KV tokens the suffix (cache-hit) forward must emit so the
        total kept window reaches ``keep`` (solo hit path)."""
        return max(0, min(keep, prefix_len + n_fresh) - prefix_len)

    def keep_pad(self, keep: int, S: int) -> int:
        """Jit-key bucketing of a keep budget: kv_keep only bounds how much
        KV leaves each layer (keeping more is safe, callers slice), and a
        raw per-request value would put every length in its own jit key."""
        return min(bucket(keep, self.buckets) if keep else 0, S)

    def insertable_tokens(self, keep: int, kv_from: int, n_new: int) -> int:
        """Tokens of fresh KV actually insertable after a forward that
        produced ``n_new`` kept tokens starting at offset ``kv_from``."""
        return max(0, min(keep, kv_from + n_new) - kv_from)
