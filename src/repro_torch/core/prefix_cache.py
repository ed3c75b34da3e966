"""Block-based radix prefix cache (vLLM-style hash chains) with LRU-leaf
eviction, reference pinning, and opaque per-block payloads.

Keys are precomputed *hash chains* (``token_chain``) rather than raw tokens:
continuous JCT calibration calls ``match_len`` for every waiting request on
every scheduling step, so the per-call cost must be O(matched blocks) with an
O(1) early exit on the first miss.

Copy of ``repro.core.prefix_cache``. In the port's engine a block payload
is a ``(k, v)`` pair of torch tensors of shape (L, 1, block, KV, hd) on the
engine's device; ``match_len`` is continuous JCT calibration's ``n_cached``
oracle.

Invariants (property-tested):
  * a block is resident only if its parent is resident (chains are prefixes)
  * eviction removes LRU *leaf* blocks only, never pinned ones
  * ``used_blocks <= capacity_blocks`` after any operation
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

ROOT = 0  # hash of the empty prefix

Chain = Tuple[int, ...]


def token_chain(tokens: Sequence[int], block_size: int) -> Chain:
    """Hash chain over full blocks of ``tokens`` (vLLM prefix hashing)."""
    out = []
    h = ROOT
    for i in range(0, len(tokens) - len(tokens) % block_size, block_size):
        h = hash((h, tuple(tokens[i:i + block_size])))
        out.append(h)
    return tuple(out)


@dataclasses.dataclass
class Block:
    hash: int
    parent: int
    payload: Any = None        # KV slab / SSM state / None (sim)
    ref_count: int = 0         # pinned by running requests
    children: int = 0          # resident child blocks
    last_used: float = 0.0


class PrefixCache:
    def __init__(self, capacity_blocks: int, block_size: int = 16):
        assert capacity_blocks >= 0 and block_size > 0
        self.capacity_blocks = capacity_blocks
        self.block_size = block_size
        self.blocks: Dict[int, Block] = {}
        self._leaf_lru: "OrderedDict[int, None]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- internals ----------------------------------------------------------

    def _touch(self, h: int, now: float):
        b = self.blocks[h]
        b.last_used = now
        if h in self._leaf_lru:
            self._leaf_lru.move_to_end(h)

    def _set_leaf(self, h: int, is_leaf: bool):
        if is_leaf:
            self._leaf_lru[h] = None
        else:
            self._leaf_lru.pop(h, None)

    def _evict_one(self, exclude: Optional[set] = None) -> bool:
        for h in self._leaf_lru:            # LRU order
            if self.blocks[h].ref_count == 0 and (
                    exclude is None or h not in exclude):
                self._remove(h)
                self.evictions += 1
                return True
        return False

    def _remove(self, h: int):
        b = self.blocks.pop(h)
        assert b.children == 0 and b.ref_count == 0
        self._set_leaf(h, False)
        if b.parent != ROOT and b.parent in self.blocks:
            parent = self.blocks[b.parent]
            parent.children -= 1
            if parent.children == 0 and parent.ref_count >= 0:
                self._set_leaf(b.parent, True)

    # -- public API ----------------------------------------------------------

    @property
    def used_blocks(self) -> int:
        return len(self.blocks)

    def match_blocks(self, chain: Chain, now: float = 0.0,
                     touch: bool = False) -> int:
        """Longest resident prefix, in blocks. O(1) exit on first miss."""
        n = 0
        for h in chain:
            if h not in self.blocks:
                break
            if touch:
                self._touch(h, now)
            n += 1
        return n

    def match_len(self, chain: Chain, now: float = 0.0,
                  touch: bool = False) -> int:
        """Longest resident prefix, in tokens."""
        return self.match_blocks(chain, now, touch) * self.block_size

    def probe_blocks(self, chain: Chain) -> int:
        """SERVEABLE prefix in blocks, side-effect free — what scheduling /
        routing / admission probes should price against. On the base cache
        this is just the resident run; the tiered cache extends it with the
        host-restorable continuation WITHOUT performing the restore (the
        restore happens on the execution path or via async prefetch)."""
        n = 0
        for h in chain:
            if h not in self.blocks:
                break
            n += 1
        return n

    def probe_len(self, chain: Chain) -> int:
        """``probe_blocks`` in tokens."""
        return self.probe_blocks(chain) * self.block_size

    def match_payloads(self, chain: Chain, now: float = 0.0) -> List[Any]:
        out = []
        for h in chain:
            if h not in self.blocks:
                break
            self._touch(h, now)
            out.append(self.blocks[h].payload)
        return out

    def pin(self, chain: Chain, n_blocks: int):
        for h in chain[:n_blocks]:
            if h not in self.blocks:
                break
            self.blocks[h].ref_count += 1

    def unpin(self, chain: Chain, n_blocks: int):
        for h in chain[:n_blocks]:
            if h not in self.blocks:
                break
            self.blocks[h].ref_count = max(0, self.blocks[h].ref_count - 1)

    def insert(self, chain: Chain, n_keep_tokens: int, now: float = 0.0,
               payloads: Optional[List[Any]] = None) -> int:
        """Insert blocks covering the first ``n_keep_tokens`` tokens
        (PrefillOnly suffix-KV discard: caller passes the prefix budget).
        Evicts LRU leaves as needed; stops early if the cache cannot grow
        (everything pinned). Returns resident blocks of this chain."""
        n_blocks = min(len(chain), n_keep_tokens // self.block_size)
        resident = 0
        parent = ROOT
        own = set()                          # never evict this chain's blocks
        for i in range(n_blocks):
            h = chain[i]
            if parent != ROOT and parent not in self.blocks:
                break                        # chain broken upstream: stop
            if h in self.blocks:
                self._touch(h, now)
            else:
                evicted_ok = True
                while self.used_blocks >= self.capacity_blocks:
                    if not self._evict_one(exclude=own):
                        evicted_ok = False
                        break
                if not evicted_ok:
                    return resident
                self.blocks[h] = Block(
                    hash=h, parent=parent, last_used=now,
                    payload=payloads[i] if payloads else None)
                self._set_leaf(h, True)
                if parent != ROOT and parent in self.blocks:
                    p = self.blocks[parent]
                    p.children += 1
                    self._set_leaf(parent, False)
            own.add(h)
            parent = h
            resident += 1
        return resident

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {
            "used_blocks": self.used_blocks,
            "capacity_blocks": self.capacity_blocks,
            "evictions": self.evictions,
            "hit_rate": self.hits / total if total else 0.0,
        }
