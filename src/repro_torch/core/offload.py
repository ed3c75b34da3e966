"""Host-memory KV offload tier — paper §9 "Offloading the KV caches to CPU".

Port of ``repro.core.offload``. The base engine discards evicted prefix
blocks outright; this tier gives the cache a second chance: blocks evicted
from the device-resident ``PrefixCache`` drop into a bounded LRU store in
host memory, and a later match restores them when
``OffloadPolicy.worth_restoring`` says the copy back beats recomputing.

A block's payload on the card is one device tensor (the engine stacks k
and v, ``core/engine.py`` ``_block_copy``). Demotion (``to_host``) copies it
into one pinned host tensor with a non-blocking copy on the current stream
and records a CUDA event after it: the payload becomes a ``HostKV``.
Whoever reads that host tensor waits on its event first; ``to_device``
does, on the stream it copies on. A CPU payload (the tests' engines run on
the CPU) stays as it is, as the reference leaves a numpy one.

Economics: restoring a block moves ``kv_bytes_per_token * block_size``
over the host link, while recomputing it costs ``2 * N_active *
block_size`` FLOPs. ``OffloadPolicy`` prices both for the chip its caller
passes (``runtime/hw.py``); the engine's ``profile()`` replaces the chip's
``host_bw`` by the rate it measures.
"""
from __future__ import annotations

import dataclasses
import sys
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.prefix_cache import Chain, PrefixCache
from repro_torch.runtime.hw import ChipSpec


class HostKV:
    """A demoted block's payload: the pinned host tensor ``kv``, written by
    a non-blocking device-to-host copy that the CUDA event ``ready``
    follows."""
    __slots__ = ("kv", "ready")

    def __init__(self, kv: torch.Tensor, ready: torch.cuda.Event):
        self.kv, self.ready = kv, ready

    @property
    def nbytes(self) -> int:
        return self.kv.nbytes


def _nbytes(payload: Any) -> int:
    total = 0
    for leaf in (payload if isinstance(payload, (tuple, list)) else [payload]):
        if hasattr(leaf, "nbytes"):
            total += int(leaf.nbytes)
        else:
            total += sys.getsizeof(leaf)
    return total


def to_host(payload: Any) -> Any:
    """Demote a payload: each CUDA tensor becomes a ``HostKV`` (one pinned
    tensor, filled by a non-blocking copy on the current stream, which its
    event follows); anything else, a CPU tensor or a ``HostKV``, stays."""
    if payload is None:
        return None
    if isinstance(payload, (tuple, list)):
        return tuple(to_host(p) for p in payload)
    if not (isinstance(payload, torch.Tensor) and payload.is_cuda):
        return payload
    host = torch.empty(payload.shape, dtype=payload.dtype, pin_memory=True)
    host.copy_(payload, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return HostKV(host, ready)


def to_device(payload: Any, device: torch.device,
              stream: Optional[torch.cuda.Stream] = None) -> Any:
    """A payload's device copy: a ``HostKV`` is copied into a new tensor on
    ``device`` by a non-blocking copy on ``stream`` (default: the current
    stream), after its demotion's event; anything else stays. A tensor
    copied on another stream than the current one is allocated there and
    recorded on the current stream, so the caching allocator hands its
    memory to no other stream while the current one may still read it."""
    if not isinstance(payload, HostKV):
        return payload
    user = torch.cuda.current_stream(device)
    stream = user if stream is None else stream
    with torch.cuda.stream(stream):
        stream.wait_event(payload.ready)
        out = torch.empty(payload.kv.shape, dtype=payload.kv.dtype,
                          device=device)
        out.copy_(payload.kv, non_blocking=True)
    if stream != user:
        out.record_stream(user)
    return out


@dataclasses.dataclass
class OffloadPolicy:
    """Transfer-vs-recompute break-even for the DRAM tier, priced for
    ``chip``: ``host_bw`` and ``peak_flops`` default to its link and bf16
    rates, and take explicit values (a measured link from ``profile()``)."""
    chip: ChipSpec
    host_bw: Optional[float] = None      # bytes/s device<->host
    peak_flops: Optional[float] = None   # FLOP/s
    efficiency: float = 0.5

    def __post_init__(self):
        if self.host_bw is None:
            self.host_bw = self.chip.host_bw
        if self.peak_flops is None:
            self.peak_flops = self.chip.peak_flops_bf16

    def restore_seconds(self, payload_bytes: int) -> float:
        return payload_bytes / self.host_bw

    def recompute_seconds(self, cfg: ModelConfig, n_tokens: int) -> float:
        return (2.0 * cfg.active_param_count() * n_tokens
                / (self.peak_flops * self.efficiency))

    def worth_restoring(self, cfg: ModelConfig, n_tokens: int,
                        payload_bytes: int) -> bool:
        return (self.restore_seconds(payload_bytes)
                < self.recompute_seconds(cfg, n_tokens))


class HostKVStore:
    """Bounded LRU store of per-block KV payloads in host memory."""

    def __init__(self, capacity_bytes: int = 1 << 30):
        self.capacity_bytes = capacity_bytes
        self._store: "OrderedDict[int, Any]" = OrderedDict()
        self._bytes: Dict[int, int] = {}
        self.used_bytes = 0
        self.offloads = 0
        self.restores = 0
        self.host_evictions = 0
        self.offload_bytes = 0
        self.restore_bytes = 0

    def put(self, block_hash: int, payload: Any):
        if payload is None:
            return
        if block_hash in self._store:
            self._store.move_to_end(block_hash)
            return
        # a tensor's bytes are its host copy's: size it before copying, so
        # a payload past the capacity costs no copy
        nb = _nbytes(payload)
        if nb > self.capacity_bytes:
            return
        while self.used_bytes + nb > self.capacity_bytes and self._store:
            h, _ = self._store.popitem(last=False)
            self.used_bytes -= self._bytes.pop(h)
            self.host_evictions += 1
        self._store[block_hash] = to_host(payload)
        self._bytes[block_hash] = nb
        self.used_bytes += nb
        self.offloads += 1
        self.offload_bytes += nb

    def get(self, block_hash: int) -> Optional[Any]:
        if block_hash not in self._store:
            return None
        self._store.move_to_end(block_hash)
        self.restores += 1
        self.restore_bytes += self._bytes[block_hash]
        return self._store[block_hash]

    def nbytes_of(self, block_hash: int) -> int:
        """Stored size of a block WITHOUT touching LRU order or counters."""
        return self._bytes.get(block_hash, 0)

    def __contains__(self, block_hash: int) -> bool:
        return block_hash in self._store

    def __len__(self) -> int:
        return len(self._store)

    def stats(self) -> Dict[str, float]:
        return {"used_bytes": self.used_bytes,
                "capacity_bytes": self.capacity_bytes,
                "blocks": len(self._store),
                "offloads": self.offloads, "restores": self.restores,
                "host_evictions": self.host_evictions,
                "offload_bytes": self.offload_bytes,
                "restore_bytes": self.restore_bytes}


class TieredPrefixCache(PrefixCache):
    """PrefixCache whose evictions offload to a HostKVStore and whose misses
    consult it — drop-in replacement for the engine's cache.

    Tier vocabulary: a block is ``device`` (resident in this cache),
    ``host`` (evicted into the DRAM store, restorable when the policy's
    ``worth_restoring`` wins), or absent (recompute). A restore puts the
    host payload back in the device tier as it is (a ``HostKV`` on the
    card): the engine copies it to the device before a forward reads it.
    ``policy`` has no default: the port has no default chip."""

    def __init__(self, capacity_blocks: int, block_size: int = 16,
                 host_store: Optional[HostKVStore] = None,
                 cfg: Optional[ModelConfig] = None, *,
                 policy: OffloadPolicy):
        super().__init__(capacity_blocks, block_size)
        # ``is not None``: an empty store is falsy (``__len__``), and the
        # reference's ``host_store or HostKVStore()`` drops it, and with it
        # the engine's host_cache_bytes (ROADMAP §C12)
        self.host = host_store if host_store is not None else HostKVStore()
        self.cfg = cfg
        self.policy = policy
        self.restored_blocks = 0

    def _remove(self, h: int):
        blk = self.blocks.get(h)
        if blk is not None and blk.payload is not None:
            self.host.put(h, blk.payload)          # offload, don't discard
        super()._remove(h)

    def _restorable(self, h: int) -> bool:
        if h not in self.host:
            return False
        if self.cfg is None:
            return True
        return self.policy.worth_restoring(
            self.cfg, self.block_size, self.host.nbytes_of(h))

    def match_tiers(self, chain: Chain) -> List[str]:
        """Per-block tier of the longest serveable prefix: ``device`` blocks
        first, then the ``host`` continuation that the policy would restore.
        Read-only — no LRU touch, no restore."""
        tiers: List[str] = []
        for h in chain:
            if h in self.blocks:
                tiers.append("device")
            else:
                break
        for h in chain[len(tiers):]:
            if not self._restorable(h):
                break
            tiers.append("host")
        return tiers

    def probe_blocks(self, chain: Chain) -> int:
        """Serveable prefix = device run + restorable host continuation,
        side-effect free (no LRU touch, no restore — see base docstring)."""
        return len(self.match_tiers(chain))

    def restore_estimate(self, chain: Chain) -> Dict[str, float]:
        """Restorable host continuation of ``chain``'s device run, priced at
        the policy's host bandwidth. Read-only; admission folds
        ``restore_s`` into a JCT estimate and a route-time prefetch starts
        only when ``blocks`` is positive."""
        n_dev = super().match_blocks(chain)
        blocks = 0
        nbytes = 0
        for h in chain[n_dev:]:
            if not self._restorable(h):
                break
            blocks += 1
            nbytes += self.host.nbytes_of(h)
        return {"device_blocks": n_dev, "blocks": blocks, "bytes": nbytes,
                "restore_s": self.policy.restore_seconds(nbytes)
                if nbytes else 0.0}

    def match_blocks(self, chain: Chain, now: float = 0.0,
                     touch: bool = False) -> int:
        """Device hits first; then extend the run with host-restorable
        blocks (restored into the device tier on the spot when worth it)."""
        n = super().match_blocks(chain, now, touch)
        restored = 0
        for h in chain[n:]:
            if not self._restorable(h):
                break
            payload = self.host.get(h)
            if payload is None:
                break
            # reinsert this block at the tail of the resident chain
            got = self.insert(chain[: n + restored + 1],
                              (n + restored + 1) * self.block_size,
                              now=now,
                              payloads=None)
            if got < n + restored + 1:
                break
            self.blocks[h].payload = payload
            restored += 1
        self.restored_blocks += restored
        return n + restored

    def stats(self) -> Dict[str, float]:
        out = super().stats()
        out["restored_blocks"] = self.restored_blocks
        out["host"] = self.host.stats()
        return out
