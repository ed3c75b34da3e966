"""PrefillOnly engine — the real-compute serving loop (paper §3).

Port of ``repro.core.engine``:

  profile run   -> JCT model fit (+ packing autotune)
  submit()      -> hash-chain the request, enqueue
  step()        -> Algorithm 1 pick (continuous JCT calibration) -> batch
                   formation (prepacking: shape-priced marginal-cost
                   backfill) -> hybrid prefill -> suffix-KV discard into the
                   block cache -> constrained single-token output (the
                   paper's P(Yes)/P(No) scoring)

A step runs one of four forwards: alone, ``tfm.prefill`` on a cache miss or
the cache-hit suffix path ``tfm.prefill_with_prefix``; packed, the misses'
``tfm.prefill_packed`` (segmented attention) or, when any member rides a
cached prefix, ``tfm.prefill_packed_with_prefix`` (positioned attention
over the members' gathered prefix KV). Each packed request's kept KV is
gathered out of the forward and inserted under its own chain.

Scheduler, JCT models, ``KVLifecycle`` and ``PrefixCache`` are the port's
own copies of the reference's. Shapes are bucketed so forwards run a
bounded set of shapes, and each shape key's forward is compiled once, as
the reference jits it: ``_fresh_fns``, ``_suffix_fns``, ``_packed_fns``
and ``_packed_hit_fns`` map a key to a ``CompiledForward``
(``core/compiled.py``), a CUDA graph on the card replayed on every later
step with that key, and the same forward run eagerly on the same static
buffers on the CPU. All of an engine's graphs share one memory pool, and
every hit forward reads its cached prefix from a view of the engine's
prefix buffer (``_prefix_views``). A graph's key is the shape of every
input, as ``jax.jit``'s is: as in the reference, a packed step's ``last``
is padded to ``max_pack_requests`` rows and the hit's prefix rows to the
pack's Nb, so no input's shape follows the number of packed requests N.
A step's outputs are consumed (logits copied to the host, kept KV blocks
copied out) before the next step replays. The compiled forwards' static
inputs and outputs are held under ``graph_memory_bytes``; the least
recently used forward goes first.
The first use of a shape key (warm-up and capture, which includes building
the CUDA kernels on a fresh checkout) is flagged ``_step_compiled`` and is
not a JCT sample, as a jit compile is not in the reference.

The DRAM offload tier (``offload=True``, paper §9; ``core/offload.py``):
prefix blocks evicted from the device cache demote to pinned host memory,
and a match restores them when the policy prices the copy back below a
recompute. The execution path copies every matched block still on the host
to the device on the engine's stream before a forward reads it
(``_match_restoring``); a route-time ``prefetch_prefix`` does the same
ahead of the step, on a side stream of a ``kv-prefetch`` thread that holds
``compiled.capture_lock`` so that it never runs beside a capture. The
engine pins its host tier's memory when it is made
(``_reserve_host_memory``), so that no step pays for growing it. The
engine's steps run on the device's default stream (the current stream of a
thread that set none).

Serving (``repro_torch.serving``): ``AsyncServer`` drives one engine per
worker thread through ``step()`` and probes it from other threads
(``pending_jct``, ``predict_jct``, ``cached_prefix_len``, ``probe``,
``inflight_snapshot``, ``restore_estimate``, ``prefetch_prefix``);
``bind_telemetry`` attaches the server's ``MetricsRegistry`` and
``SpanTracer``, which each step, restore and prefetch then feeds as the
reference's engine does. Several engines may share one card in one
process: every step, ``profile()``, construction and first use (warm-up
and capture) holds ``compiled.device_lock``, so the engines take turns on
the card and none runs beside another's capture. A step takes the lock
before it forms its batch: while it waits for another engine's step its
requests are still queued, nothing is in flight, and the watchdog
(``inflight_snapshot``) sees no batch to time, as it sees none during the
engine's own first use.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import compiled as _compiled
from repro_torch.core.compiled import CompiledForward, side_stream
from repro_torch.core.jct import LinearProxyJCT, PackedShapeJCT, Sample
from repro_torch.core.kv_policy import KVLifecycle, bucket as _bucket
from repro_torch.core.offload import (HostKV, HostKVStore, OffloadPolicy,
                                      TieredPrefixCache, to_device)
from repro_torch.core.prefix_cache import PrefixCache, token_chain
from repro_torch.core.scheduler import Request, Scheduler
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import PAD_POS, torch_dtype
from repro_torch.models.params import cast_params
from repro_torch.runtime.device import DeviceLike, resolve_device
from repro_torch.runtime.fault_tolerance import NaNGuard
from repro_torch.runtime.hw import H100_SXM
from repro_torch.serving.tracing import BatchRecord, JCTCalibrationMonitor


@dataclasses.dataclass
class EngineConfig:
    policy: str = "srjf_calibrated"
    lam: float = 0.05                 # starvation offset (JCT-sec per wait-sec)
    block_size: int = 16
    cache_capacity_tokens: int = 4096  # prefix-KV budget (profile run output)
    kv_keep_tokens: int = 10**9        # suffix discard threshold (per request)
    suffix_buckets: Tuple[int, ...] = (64, 128, 256, 512, 1024, 2048)
    prefix_bucket_blocks: int = 4      # reuse granularity: 4 blocks = 64 tok
    pack_token_budget: int = 2048      # prepacking: max COMPUTED tokens/step
    max_pack_requests: int = 16        # prepacking: max segments per step
                                       # (<=1 disables batch formation)
    pack_prefix_budget: int = 4096     # packed-hit path: max gathered prefix
                                       # tokens per step (attended, not
                                       # computed)
    prefix_buckets: Tuple[int, ...] = (128, 256, 384, 512, 1024, 2048, 4096)
                                       # per-segment gathered-prefix pad
                                       # ladder (the shape key is
                                       # (S, Nb, smax, pmax, K))
    autotune_pack: bool = True         # retune both from the profile() fit
    pack_inflation: float = 2.0        # max anchor-step slowdown autotune
                                       # accepts vs a typical solo step
    shape_cost_model: bool = True      # price batch formation with the
                                       # shape-aware PackedShapeJCT; False
                                       # falls back to the token-linear
                                       # proxy on the same marginal rule
    shape_pad_discount: float = 0.25   # unfitted-prior rent per padded slot,
                                       # as a fraction of the linear proxy's
                                       # per-computed-token rate
    graph_memory_bytes: int = 2 << 30  # device bytes the compiled
                                       # forwards may hold between steps
                                       # (static inputs and outputs); the
                                       # least recently used go past it
    offload: bool = False              # DRAM tier: evicted prefix blocks
                                       # demote to a HostKVStore instead of
                                       # being discarded (paper §9)
    host_cache_bytes: int = 256 << 20  # DRAM tier capacity per instance
    offload_host_bw: Optional[float] = None
                                       # override the OffloadPolicy's link
                                       # bandwidth (bytes/s). None = the
                                       # ChipSpec value, later replaced by
                                       # profile()'s measured bandwidth.
                                       # The worth_restoring economics are
                                       # priced for the TARGET chip, so CPU
                                       # runs of reduced models pass a large
                                       # value here to force the restore
                                       # path.


class PrefillOnlyEngine:
    """Single-instance engine over a dense model (real tensors on
    ``device``: ``"cuda"`` by default, ``"cpu"`` only when asked for)."""

    def __init__(self, cfg: ModelConfig, params: Dict,
                 ecfg: Optional[EngineConfig] = None,
                 device: DeviceLike = "cuda"):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r}: the port's engine runs dense models")
        self.cfg = cfg
        self.device = resolve_device(device)
        with _compiled.device_lock:
            self.params = cast_params(params, torch_dtype(cfg.dtype),
                                      self.device)
        self.ecfg = ecfg = EngineConfig() if ecfg is None else ecfg
        # Guards queue / cache / results / jct_model: a worker thread drives
        # step() while other threads submit, cancel, shed and probe; the
        # forward itself runs outside the lock.
        self.lock = threading.RLock()
        # KV keep/discard has ONE owner: every keep-budget / residency /
        # insert-bound decision in this file asks self.kv (kv_policy).
        self.kv = KVLifecycle(block_size=ecfg.block_size,
                              kv_keep_tokens=ecfg.kv_keep_tokens,
                              buckets=ecfg.suffix_buckets)
        if ecfg.offload:
            # hierarchical KV memory: device blocks demote to pinned host
            # memory on eviction, restore on match when cheaper than
            # recompute (priced for the H100)
            self.cache: PrefixCache = TieredPrefixCache(
                ecfg.cache_capacity_tokens // ecfg.block_size,
                ecfg.block_size,
                host_store=HostKVStore(ecfg.host_cache_bytes), cfg=cfg,
                policy=OffloadPolicy(H100_SXM, host_bw=ecfg.offload_host_bw))
        else:
            self.cache = PrefixCache(
                ecfg.cache_capacity_tokens // ecfg.block_size,
                ecfg.block_size)
        self.jct_model = LinearProxyJCT()
        # shape-aware step pricing: batch formation admits by marginal
        # padded-shape cost; routers/admission/Algorithm-1 keep the
        # per-request linear proxy on the miss-token axis
        self.shape_jct = PackedShapeJCT(
            fallback=self.jct_model, pad_discount=ecfg.shape_pad_discount)
        # usable_prefix hook: Algorithm-1 scores price requests against the
        # prefix a forward would actually reuse, matching the hit-aware
        # predict_jct/pending_jct/shed probes — not the raw token match
        self.scheduler = Scheduler(ecfg.policy, self.jct_model, ecfg.lam,
                                   usable_prefix=self._usable_prefix_len)
        self.queue: List[Request] = []
        self.results: Dict[int, Dict] = {}
        # the reference's per-shape jit caches: shape key -> compiled forward
        # (CUDA graphs sharing one pool on the card, eager on the CPU)
        self._fresh_fns: Dict[Tuple, CompiledForward] = {}
        self._suffix_fns: Dict[Tuple, CompiledForward] = {}
        self._packed_fns: Dict[Tuple, CompiledForward] = {}
        self._packed_hit_fns: Dict[Tuple, CompiledForward] = {}
        self._fns = {"fresh": self._fresh_fns, "suffix": self._suffix_fns,
                     "packed_miss": self._packed_fns,
                     "packed_hit": self._packed_hit_fns}
        # (path, key) of every live compiled forward, least recently used
        # first: their held bytes are kept under graph_memory_bytes
        self._fn_lru: "OrderedDict[Tuple[str, Tuple], None]" = OrderedDict()
        cuda = self.device.type == "cuda"
        self._graph_pool = torch.cuda.graph_pool_handle() if cuda else None
        self._graph_stream = side_stream(self.device.index) if cuda else None
        # the prefetch's host-to-device copies
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if cuda and ecfg.offload else None)
        if cuda and ecfg.offload:
            with _compiled.device_lock:
                self._reserve_host_memory()
        # the prefix buffer (k and v, flat) of every new hit forward: each
        # reads a view of its front, written just before its call
        self._prefix_store: Optional[Dict[str, torch.Tensor]] = None
        self._last_step_ids: List[int] = []    # all requests served by the
                                               # most recent step()
        self._inflight: List[int] = []         # popped by step(), not yet in
                                               # results (crash accounting)
        self._inflight_pred = 0.0              # predicted cost of that batch
        self._inflight_t0 = 0.0                # and when it started
        self.steps = 0
        self.forwards = 0                      # model forwards run (profile
                                               # runs included)
        self.hit_tokens = 0
        self.total_tokens = 0
        self.packed_steps = 0                  # steps that executed >1 request
        self.packed_requests = 0               # requests served via prepacking
        self.packed_hit_requests = 0           # ...of which rode a cached
                                               # prefix
        self.padded_slots = 0                  # bucketed forward slots paid
        self.pack_skew_splits = 0              # packs closed early because the
                                               # best remaining candidate's
                                               # padding externality exceeded
                                               # its benefit
        self._formed_cost = 0.0                # shape-priced cost of the pack
        self._step_compiled = False            # step hit a fresh shape key
        # result validation: non-finite logits are flagged "corrupt" instead
        # of delivered; consecutive corruption advises a reload
        self.result_guard = NaNGuard(limit=3)
        self.nonfinite_results = 0
        # brownout hook (serving): when degraded, cache-HIT requests skip
        # the batched gathered-prefix path and run the solo-suffix path
        self.degraded = False
        self.batch_records: "deque[BatchRecord]" = deque(maxlen=256)
        self.jct_monitor = JCTCalibrationMonitor(
            self.jct_model, buckets=ecfg.suffix_buckets,
            shape_model=self.shape_jct)
        self._last_path: Tuple[str, Tuple] = ("", ())
        self._last_shape: Dict[str, int] = {}
        # serving telemetry (bind_telemetry): None until a server binds one
        self.metrics = None
        self.instance_name = ""
        self.tracer = None

    def _sync(self) -> None:
        """Wait for the device: timestamps must see compute, not launches."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- profile run (paper §3.1) ------------------------------------------
    def profile(self, lengths: Sequence[int] = (64, 128, 256, 512)) -> float:
        """Measure jct(n_input, 0) on this device, fit the linear proxy."""
        with _compiled.device_lock:
            return self._profile(lengths)

    def _profile(self, lengths: Sequence[int]) -> float:
        samples: List[Sample] = []
        rng = np.random.default_rng(0)
        for n in lengths:
            toks = rng.integers(0, self.cfg.vocab_size, size=n).tolist()
            self._run_fresh(toks)            # warm-up: exclude first use
            for _ in range(2):               # steady-state samples
                self._sync()
                t0 = time.perf_counter()
                self._run_fresh(toks)
                self._sync()
                samples.append((n, 0, time.perf_counter() - t0))
        self.jct_model.fit(samples)
        if (isinstance(self.cache, TieredPrefixCache)
                and self.ecfg.offload_host_bw is None):
            # price restores at THIS link's measured copy rate, not the
            # ChipSpec constant; an explicit offload_host_bw wins
            self.cache.policy.host_bw = self._measure_host_bw()
        if self.ecfg.autotune_pack:
            self.autotune_packing(ref_len=max(lengths))
        return self.jct_model.pearson_r

    def _reserve_host_memory(self) -> None:
        """Pin host memory for as many block payloads as the host tier
        holds, and hand it back to PyTorch's caching host allocator at
        once: a demotion then takes a cached pinned block, where it would
        otherwise pay ``cudaHostAlloc`` inside the step that evicts (0.8 ms
        a block of qwen1.5-0.5b and 1.6 ms of granite-3-8b on an NVIDIA
        H100 80GB HBM3 host, against 0.06 ms for a cached one; PERF.md
        section 6)."""
        cfg = self.cfg
        shape = (2, cfg.num_layers, 1, self.ecfg.block_size,
                 cfg.num_kv_heads, cfg.head_dim)
        n = self.ecfg.host_cache_bytes // self.block_bytes()
        pinned = [torch.empty(shape, dtype=torch_dtype(cfg.dtype),
                              pin_memory=True) for _ in range(n)]
        del pinned

    def block_bytes(self) -> int:
        """Bytes of one cache block's payload (k and v, every layer)."""
        return self.ecfg.block_size * self.cfg.kv_bytes_per_token(
            torch_dtype(self.cfg.dtype).itemsize)

    def _measure_host_bw(self, reps: int = 9) -> float:
        """The host<->device rate (bytes/s) the tier pays: copies of one
        block's payload between pinned host memory and the device, each way
        ``reps`` times; two payloads over the sum of the two directions'
        medians. Timed with CUDA events (on the CPU, the host clock)."""
        n = self.block_bytes()
        cuda = self.device.type == "cuda"
        dev = torch.empty(n, dtype=torch.uint8, device=self.device)
        host = torch.empty(n, dtype=torch.uint8, pin_memory=cuda)
        medians = []
        for dst, src in ((host, dev), (dev, host)):
            times = []
            for _ in range(reps):
                if not cuda:
                    t0 = time.perf_counter()
                    dst.copy_(src)
                    times.append(time.perf_counter() - t0)
                    continue
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                dst.copy_(src, non_blocking=True)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) * 1e-3)
            medians.append(statistics.median(times))
        return 2.0 * n / max(sum(medians), 1e-9)

    def autotune_packing(self, ref_len: int) -> Tuple[int, int]:
        """Tune ``pack_token_budget`` / ``max_pack_requests`` from the fitted
        JCT curve: accept a packed step up to ``pack_inflation``x the cost
        of a typical solo step (a ``ref_len`` request). With jct = a*S + b
        the budget solves a*S + b <= inflation * (a*ref + b), so a large
        fixed cost b relative to the per-token cost a gives a larger
        budget; the request cap follows as budget / smallest bucket."""
        m, ecfg = self.jct_model, self.ecfg
        if m.a <= 0:
            return ecfg.pack_token_budget, ecfg.max_pack_requests
        max_step = ecfg.pack_inflation * m.predict(ref_len)
        floor = _bucket(ref_len, ecfg.suffix_buckets)
        budget = max([floor] + [s for s in ecfg.suffix_buckets
                                if m.predict(s) <= max_step])
        n_max = int(np.clip(budget // max(1, ecfg.suffix_buckets[0]), 1, 64))
        # gathered prefix tokens are attended, not computed: the hit path
        # carries a proportionally larger prefix buffer than its budget
        self.ecfg = dataclasses.replace(ecfg, pack_token_budget=budget,
                                        max_pack_requests=n_max,
                                        pack_prefix_budget=max(
                                            ecfg.pack_prefix_budget,
                                            2 * budget))
        return budget, n_max

    # ---- request lifecycle ---------------------------------------------------
    def submit(self, tokens: Sequence[int],
               allowed_tokens: Optional[Sequence[int]] = None,
               user_id: Optional[str] = None, now: Optional[float] = None,
               deadline: Optional[float] = None,
               chain: Optional[Tuple[int, ...]] = None) -> int:
        now = time.perf_counter() if now is None else now
        r = Request(n_input=len(tokens), arrival=now,
                    chain=(token_chain(tokens, self.ecfg.block_size)
                           if chain is None else chain),
                    tokens=list(tokens), user_id=user_id,
                    allowed_tokens=tuple(allowed_tokens) if allowed_tokens else None,
                    deadline=deadline)
        with self.lock:
            r.n_cached_at_arrival = self.cache.probe_len(r.chain)
            self.queue.append(r)
        return r.req_id

    def cancel(self, req_id: int) -> Optional[Request]:
        """Remove a QUEUED request (no effect once executing). Returns the
        removed request, or None if it was not waiting here."""
        with self.lock:
            for i, r in enumerate(self.queue):
                if r.req_id == req_id:
                    return self.queue.pop(i)
        return None

    def shed_expired(self, now: Optional[float] = None) -> List[Request]:
        """Pop queued requests that cannot meet their deadline anymore:
        even starting RIGHT NOW, now + predicted JCT > deadline."""
        now = time.perf_counter() if now is None else now
        shed: List[Request] = []
        with self.lock:
            keep = []
            for r in self.queue:
                if r.deadline is not None and (
                        now + self.jct_model.predict(
                            r.n_input, self._usable_prefix_len(
                                r.n_input,
                                self.cache.probe_blocks(r.chain)))
                        > r.deadline):
                    shed.append(r)
                else:
                    keep.append(r)
            if shed:
                self.queue[:] = keep
        return shed

    def pending_jct(self, now: Optional[float] = None) -> float:
        """Predicted seconds of queued work PLUS the predicted remainder of
        the step executing right now — the backlog signal JCT-aware routing
        ranks instances by. Queued requests are priced against their
        ARRIVAL-time cache match bucketed to the prefix a forward would
        reuse (conservative: the cache only warms for a queued request's
        own prefix)."""
        now = time.perf_counter() if now is None else now
        bs = self.ecfg.block_size
        with self.lock:
            queued = sum(
                self.jct_model.predict(
                    r.n_input, self._usable_prefix_len(
                        r.n_input, r.n_cached_at_arrival // bs))
                for r in self.queue)
            running = 0.0
            if self._inflight:
                running = max(0.0, self._inflight_pred
                              - (now - self._inflight_t0))
            return queued + running

    def predict_jct(self, n_input: int, chain: Tuple[int, ...] = ()) -> float:
        """Predicted JCT of a PROSPECTIVE request given this instance's
        cache state, against the prefix the engine would actually reuse."""
        with self.lock:
            return self.jct_model.predict(
                n_input, self._usable_prefix_len(
                    n_input, self.cache.probe_blocks(chain)))

    def cached_prefix_len(self, chain: Tuple[int, ...]) -> int:
        with self.lock:
            return self.cache.probe_len(chain)

    def probe(self, n_input: int,
              chain: Tuple[int, ...] = ()) -> Tuple[float, float, int]:
        """``(pending_jct, predict_jct, cached_prefix_len)`` in ONE lock
        acquisition (one consistent cache/queue state)."""
        with self.lock:
            return (self.pending_jct(), self.predict_jct(n_input, chain),
                    self.cache.probe_len(chain))

    @property
    def last_step_ids(self) -> List[int]:
        return list(self._last_step_ids)

    def inflight_snapshot(self) -> Tuple[List[int], float, float]:
        """(in-flight request ids, predicted batch JCT, start timestamp) —
        the serving watchdog's hang probe. A step on a shape key's first
        use (warm-up and capture) reports EMPTY, as the reference's does for
        a jit compile: its time is outside the JCT model. A step waiting
        for another engine's step has formed no batch yet (``step``
        takes ``compiled.device_lock`` first), so it reports empty too."""
        with self.lock:
            if self._step_compiled:
                return [], 0.0, 0.0
            return (list(self._inflight), self._inflight_pred,
                    self._inflight_t0)

    def bind_telemetry(self, metrics=None, instance: str = "",
                       tracer=None) -> None:
        """Attach the serving registry and/or a SpanTracer. The JCT monitor
        exports coefficient gauges immediately so a scrape before the first
        warm step still sees the profile() fit."""
        self.metrics = metrics
        self.instance_name = instance
        self.tracer = tracer
        self.jct_monitor.bind(metrics, instance)

    def set_degraded(self, flag: bool) -> None:
        """Brownout level >=2 hook: disable hit co-packing's batched
        gathered-prefix forward (hits run the solo-suffix path, misses
        still co-pack). Takes effect at the next batch formation."""
        with self.lock:
            self.degraded = bool(flag)

    # ---- DRAM offload tier (paper §9) ---------------------------------------
    def _match_restoring(self, chain: Tuple[int, ...],
                         rid: Optional[int] = None) -> int:
        """``match_blocks(touch=True)`` of the execution path. On the tiered
        cache the match may restore blocks from the host store; every
        matched block whose payload is still on the host (restored here or
        by a prefetch not yet through) is then copied to the device on the
        current stream, so the forward reads device tensors only. A restore
        is timed and counted and emits the ``restore`` span and series
        (``_note_tier``). Call under the engine lock."""
        c = self.cache
        if not isinstance(c, TieredPrefixCache):
            return c.match_blocks(chain, touch=True)
        r0, b0 = c.restored_blocks, c.host.restore_bytes
        t0 = time.perf_counter()
        matched = c.match_blocks(chain, now=t0, touch=True)
        for h in chain[:matched]:
            blk = c.blocks[h]
            blk.payload = to_device(blk.payload, self.device)
        blocks = c.restored_blocks - r0
        if blocks:
            self._note_tier("restore", rid, blocks,
                            c.host.restore_bytes - b0, t0,
                            time.perf_counter())
        return matched

    def _note_tier(self, kind: str, rid: Optional[int], blocks: int,
                   nbytes: int, t0: float, t1: float) -> None:
        """Export one restore/prefetch episode as Prometheus series and (when
        a request id is known) a SpanTracer phase."""
        m, inst = self.metrics, self.instance_name
        if m is not None:
            m.counter(f"kv_{kind}_blocks", inst,
                      help=f"KV blocks moved host->device by {kind}").inc(
                blocks)
            m.counter(f"kv_{kind}_bytes", inst).inc(nbytes)
            m.histogram(f"kv_{kind}_seconds", inst,
                        help=f"wall seconds per {kind} episode").observe(
                t1 - t0)
        tr = self.tracer
        if tr is not None and rid is not None:
            tr.span_rid(rid, kind, t0, t1, instance=inst,
                        blocks=blocks, bytes=int(nbytes))

    def restore_estimate(self, chain: Tuple[int, ...]) -> Dict[str, float]:
        """Restorable host-tier continuation of ``chain`` and its priced
        transfer time (admission folds ``restore_s`` into the JCT bound, a
        route-time prefetch starts on ``blocks``). Zeros on an un-tiered
        engine."""
        c = self.cache
        if not isinstance(c, TieredPrefixCache):
            return {"device_blocks": 0, "blocks": 0, "bytes": 0,
                    "restore_s": 0.0}
        with self.lock:
            return c.restore_estimate(chain)

    def prefetch_prefix(self, chain: Tuple[int, ...],
                        rid: Optional[int] = None) -> int:
        """Asynchronous restore of ``chain``'s restorable continuation,
        started at routing time (the router knows the usable prefix before
        the forward runs). Returns the blocks scheduled (0: nothing
        restorable, or no tier). A ``kv-prefetch`` daemon thread restores
        them into the device tier under the lock, then copies their
        payloads to the device outside it (``_prefetch_worker``); the
        episode emits the ``prefetch`` span (on ``rid``'s timeline) and
        series."""
        c = self.cache
        if not isinstance(c, TieredPrefixCache):
            return 0
        with self.lock:
            est = c.restore_estimate(chain)
        if not est["blocks"]:
            return 0
        threading.Thread(target=self._prefetch_worker,
                         args=(tuple(chain), rid),
                         daemon=True, name="kv-prefetch").start()
        return int(est["blocks"])

    def _prefetch_worker(self, chain: Tuple[int, ...],
                         rid: Optional[int]) -> None:
        """Restore ``chain`` under the lock, copy the restored payloads to
        the device on the copy stream outside it, wait for the copies, then
        swap each in under the lock where the block still holds the host
        payload copied (an execute-path match may have copied it first).
        The whole of it holds ``capture_lock``: the restore may demote
        (pinned allocations, device-to-host copies), and neither it nor the
        copies may run beside a capture. It may run beside a step."""
        c = self.cache
        with _compiled.capture_lock:
            t0 = time.perf_counter()
            with self.lock:
                r0, b0 = c.restored_blocks, c.host.restore_bytes
                matched = c.match_blocks(chain, now=t0, touch=True)
                blocks = c.restored_blocks - r0
                nbytes = c.host.restore_bytes - b0
                hs = chain[matched - blocks:matched] if blocks else ()
                host = [(h, c.blocks[h].payload) for h in hs
                        if isinstance(c.blocks[h].payload, HostKV)]
            if not blocks:
                return
            if host:
                dev = [(h, p, to_device(p, self.device, self._copy_stream))
                       for h, p in host]
                done = torch.cuda.Event()
                done.record(self._copy_stream)
                done.synchronize()
                with self.lock:
                    for h, p, payload in dev:
                        blk = c.blocks.get(h)
                        if blk is not None and blk.payload is p:
                            blk.payload = payload
            self._note_tier("prefetch", rid, blocks, nbytes, t0,
                            time.perf_counter())

    def step(self) -> Optional[int]:
        """One scheduling step: pick (Algorithm 1), form a batch, prefill,
        cache, score. Returns the anchor request's id. The step holds
        ``compiled.device_lock`` from before it forms its batch to its
        end."""
        with _compiled.device_lock:
            return self._step()

    def _step(self) -> Optional[int]:
        now = time.perf_counter()
        batch = self._form_batch(now)
        if batch is None:
            return None
        for r in batch:
            r.start_time = now
        with self.lock:
            self._inflight = [r.req_id for r in batch]
            # the shape-priced cost of the formed pack: BatchRecord's
            # predicted_jct is the number batch formation admitted against
            self._inflight_pred = self._formed_cost
            self._inflight_t0 = now
        self._step_compiled = False
        padded0 = self.padded_slots
        if len(batch) == 1:
            r = batch[0]
            logits = self._execute(r)
            # asynchronous launches: sync before timestamping, or the JCT
            # model observes launch latency instead of compute time
            self._sync()
            done = r.finish_time = time.perf_counter()
            with self.lock:
                self.results[r.req_id] = self._score(logits, r)
                # steps that ran a fresh shape (first use, kernel build) are
                # NOT JCT samples (profile() excludes them the same way)
                if not self._step_compiled:
                    self.jct_model.observe(r.n_input, r.n_cached_at_start,
                                           r.finish_time - now)
        else:
            logits = self._execute_packed(batch)
            self._sync()
            done = time.perf_counter()
            with self.lock:
                for n, r in enumerate(batch):
                    r.finish_time = done
                    self.results[r.req_id] = self._score(logits[n:n + 1], r)
                # packed cost is a function of COMPUTED tokens (misses all
                # their tokens, hits their suffixes): the same miss-token
                # axis Algorithm 1 scores with
                if not self._step_compiled:
                    self.jct_model.observe(
                        sum(r.n_input - r.n_cached_at_start for r in batch),
                        0, done - now)
            self.packed_steps += 1
            self.packed_requests += len(batch)
            self.packed_hit_requests += sum(
                1 for r in batch if r.n_cached_at_start > 0)
        self.steps += 1
        self._last_step_ids = [r.req_id for r in batch]
        self._record_step(batch, now, done, time.perf_counter(), padded0)
        with self.lock:
            self._inflight = []
            self._inflight_pred = 0.0
        return batch[0].req_id

    def _record_step(self, batch: List[Request], t0: float, t_done: float,
                     t_scored: float, padded0: int) -> None:
        """Observability epilogue of step(): BatchRecord into the ring, JCT
        calibration sample (warm steps only), the bound registry's series and
        the tracer's per-request spans."""
        pred = self._inflight_pred
        computed = sum(r.n_input - r.n_cached_at_start for r in batch)
        kind = ("solo" if len(batch) == 1
                else "hit" if any(r.n_cached_at_start for r in batch)
                else "miss")
        path, key = self._last_path
        shape = self._last_shape
        rec = BatchRecord(
            step=self.steps, ts=t_done, instance=self.instance_name,
            kind=kind, n_requests=len(batch),
            req_ids=tuple(r.req_id for r in batch),
            computed_tokens=computed,
            padded_tokens=self.padded_slots - padded0,
            S=shape.get("S", 0), Nb=shape.get("Nb", 0),
            smax=shape.get("smax", 0), pmax=shape.get("pmax", 0),
            K=shape.get("K", 0), jit_path=path, jit_key=key,
            compiled=self._step_compiled, predicted_jct=pred,
            wall=t_done - t0)
        self.batch_records.append(rec)
        # first-use steps are kept out of calibration, as out of the JCT fit
        if not self._step_compiled:
            self.jct_monitor.observe(pred, t_done - t0, computed, kind=kind)
            self.shape_jct.observe(computed, rec.S, rec.Nb, rec.smax,
                                   rec.pmax, rec.wall)
        m = self.metrics
        if m is not None:
            m.gauge("step_padding_waste", self.instance_name).set(
                rec.padding_waste)
            m.histogram("padding_waste", self.instance_name).observe(
                rec.padding_waste)
            m.counter("padded_slots", self.instance_name).inc(
                rec.padded_tokens)
            m.counter(f"pack_{kind}_steps", self.instance_name).inc()
            m.histogram("batch_wall_seconds", self.instance_name).observe(
                rec.wall)
            if isinstance(self.cache, TieredPrefixCache):
                hs = self.cache.host.stats()
                m.gauge("host_kv_used_bytes", self.instance_name,
                        help="DRAM offload tier occupancy").set(
                    hs["used_bytes"])
                m.gauge("host_kv_blocks", self.instance_name).set(
                    hs["blocks"])
                m.gauge("kv_offload_blocks", self.instance_name,
                        help="KV blocks demoted device->host (cumulative)"
                        ).set(hs["offloads"])
                m.gauge("kv_offload_bytes", self.instance_name).set(
                    hs["offload_bytes"])
        tr = self.tracer
        if tr is None:
            return
        tr.record_batch(rec)
        inst = self.instance_name
        peers = [r.req_id for r in batch]
        for r in batch:
            tr.span_rid(r.req_id, "queue", r.arrival, t0, instance=inst)
            tr.span_rid(r.req_id, "execute", t0, t_done, instance=inst,
                        pack=kind, compiled=self._step_compiled,
                        jit_path=path)
            tr.span_rid(r.req_id, "score", t_done, t_scored, instance=inst)
            tr.event_rid(r.req_id, "batch", kind=kind, step=self.steps,
                         peers=[p for p in peers if p != r.req_id],
                         predicted_jct=pred, computed_tokens=computed,
                         n_cached=r.n_cached_at_start)
            if self._step_compiled:
                tr.event_rid(r.req_id, "jit_compile", path=path,
                             key=list(key))

    # ---- batch formation -------------------------------------------------------
    def _usable_prefix_len(self, n_input: int, matched_blocks: int) -> int:
        """Bucketed prefix-reuse length given a raw cache match in blocks
        (granularity ``prefix_bucket_blocks``; >=1 fresh token guaranteed —
        the last token's logits must be computed)."""
        bs = self.ecfg.block_size
        gran = self.ecfg.prefix_bucket_blocks
        prefix_len = (matched_blocks // gran) * gran * bs
        if prefix_len >= n_input:
            prefix_len = max(0, ((n_input - 1) // (gran * bs)) * gran * bs)
        return prefix_len

    def _usable_prefix(self, r: Request) -> int:
        """Bucketed prefix-reuse length for ``r`` against the current cache,
        probed without touching the LRU (batch formation's pricing)."""
        return self._usable_prefix_len(r.n_input,
                                       self.cache.probe_blocks(r.chain))

    def _pack_shape(self, rows: List[Tuple[int, int]]) -> Tuple[
            int, int, int, int, int]:
        """Realized step shape ``(S, Nb, smax, pmax, pad_slots)`` for a pack
        of ``rows`` = [(suffix_tokens, usable_prefix), ...].

        Mirrors ``_execute_packed``'s layout arithmetic, so formation prices
        the shape execution pays. A single row prices the solo path: S =
        bucketed suffix, exact prefix buffer (Nb/smax = 0). ``pad_slots``
        counts the padded-but-dead slots a candidate is charged for:
        Σ(pmax−pref_i) + Σ(smax−suf_i) over the real rows, bucket slack
        solo. The pow2 ghost rows (Nb−N) are not charged here (the fitted
        model prices them from data: Nb is in its feature basis).
        """
        ecfg = self.ecfg
        if len(rows) == 1:
            suffix, pref = rows[0]
            S = _bucket(suffix, ecfg.suffix_buckets)
            return S, 0, 0, pref, S - suffix
        suffixes = [s for s, _ in rows]
        total = sum(suffixes)
        S = _bucket(total, ecfg.suffix_buckets)
        P_max = max(p for _, p in rows)
        pmax = _bucket(P_max, ecfg.prefix_buckets) if P_max else 0
        Nb = 1
        while Nb < len(rows):
            Nb *= 2
        smax = _bucket(max(suffixes), (32, 48) + ecfg.suffix_buckets)
        if not pmax:
            # an all-miss pack executes as ONE flat (1, S) sequence: only
            # the bucket slack is dead
            return S, Nb, smax, 0, S - total
        pad = (sum(pmax - p for _, p in rows)
               + sum(smax - s for s in suffixes))
        return S, Nb, smax, pmax, pad

    def _pack_cost(self, rows: List[Tuple[int, int]]) -> float:
        """Predicted wall seconds for one step over ``rows``
        (``shape_cost_model=False``: the token-linear proxy on bucketed
        computed tokens)."""
        computed = sum(s for s, _ in rows)
        if not self.ecfg.shape_cost_model:
            return self.jct_model.predict(
                _bucket(computed, self.ecfg.suffix_buckets))
        S, Nb, smax, pmax, pad = self._pack_shape(rows)
        return self.shape_jct.predict(computed, S, Nb, smax, pmax,
                                      pad_slots=pad)

    def _form_batch(self, now: float) -> Optional[List[Request]]:
        """Algorithm 1 pick + marginal-cost backfill (shape-priced).

        The anchor is exactly the scheduler's pick, so SRJF-calibrated order
        is preserved. Backfill grows the pack greedily: every queued
        candidate is priced by its marginal batch cost ``cost(pack + r) −
        cost(pack)`` against its solo cost, and ``pick_backfill`` admits
        the candidate with the largest benefit ``solo(r) − marginal(r)``.
        Misses contribute their full length, hits only their suffix. When
        the best remaining candidate's benefit is negative the pack closes
        (skew split, ``pack_skew_splits``).

        Hard gates: computed tokens <= ``pack_token_budget``; gathered
        prefix tokens <= ``pack_prefix_budget``; brownout skips hit
        gathers. Requests sharing a prefix root (first hash-chain block)
        co-pack only when both already hit the cache; a miss sharing a root
        runs sequentially, so the later request hits the earlier one's
        freshly inserted KV.
        """
        with self.lock:
            i = self.scheduler.pick(self.queue, self.cache, now)
            if i is None:
                return None
            anchor = self.queue.pop(i)
            batch = [anchor]
            ecfg = self.ecfg
            pref_a = self._usable_prefix(anchor)
            rows = [(anchor.n_input - pref_a, pref_a)]
            if (ecfg.max_pack_requests <= 1 or ecfg.pack_token_budget <= 0
                    or not self.queue or (self.degraded and pref_a)):
                self._formed_cost = self._pack_cost(rows)
                return batch
            total = rows[0][0]                     # computed suffix tokens
            pref_total = pref_a
            hit_roots = ({anchor.chain[0]: pref_a > 0} if anchor.chain
                         else {})
            cands = [(r, self._usable_prefix(r)) for r in self.queue]
            pack_cost = self._pack_cost(rows)

            def benefit(r: Request, pref: int) -> Optional[float]:
                if self.degraded and pref:
                    return None    # brownout: no batched hit gather
                suffix = r.n_input - pref
                if total + suffix > ecfg.pack_token_budget:
                    return None
                if pref and pref_total + pref > ecfg.pack_prefix_budget:
                    return None
                root = r.chain[0] if r.chain else None
                if root is not None and root in hit_roots and not (
                        hit_roots[root] and pref > 0):
                    return None
                marginal = self._pack_cost(rows + [(suffix, pref)]) - pack_cost
                return self._pack_cost([(suffix, pref)]) - marginal

            while len(batch) < ecfg.max_pack_requests and cands:
                j = self.scheduler.pick_backfill(cands, benefit)
                if j is None:
                    break
                r, pref = cands[j]
                if benefit(r, pref) < 0:
                    self.pack_skew_splits += 1
                    break
                cands.pop(j)
                batch.append(r)
                rows.append((r.n_input - pref, pref))
                total += r.n_input - pref
                pref_total += pref
                pack_cost = self._pack_cost(rows)
                root = r.chain[0] if r.chain else None
                if root is not None:
                    hit_roots.setdefault(root, pref > 0)
            self._formed_cost = pack_cost
            for r in batch[1:]:
                self.queue.remove(r)
            return batch

    def run_until_drained(self) -> List[int]:
        """Serve until the queue is empty; returns one id per served request
        in completion order (a packed step contributes its whole batch,
        anchor first)."""
        done = []
        while self.queue:
            if self.step() is not None:
                done.extend(self._last_step_ids)
        return done

    # ---- execution -----------------------------------------------------------
    def _execute(self, r: Request) -> torch.Tensor:
        bs = self.ecfg.block_size
        # cache probe + pin under the lock; the forward itself runs outside
        # it so router/admission probes never block on compute
        with self.lock:
            matched = self._match_restoring(r.chain, rid=r.req_id)
            prefix_len = self._usable_prefix_len(r.n_input, matched)
            use_blocks = prefix_len // bs
            r.n_cached_at_start = prefix_len
            self.hit_tokens += prefix_len
            self.total_tokens += r.n_input
            self.padded_slots += prefix_len + _bucket(
                r.n_input - prefix_len, self.ecfg.suffix_buckets)
            keep = self.kv.keep(r.n_input)
            # chain already resident past the keep bound: the insert below
            # would only re-slice and re-touch existing blocks — skip it
            resident = self.kv.resident(matched, r.n_input)
            if prefix_len:
                self.cache.pin(r.chain, use_blocks)
                payloads = self.cache.match_payloads(r.chain)[:use_blocks]
        if prefix_len == 0:
            logits, new_kv, n_new = self._run_fresh(r.tokens, keep)
            kv_from = 0
        else:
            # the pinned blocks stay put while the forward reads them
            logits, new_kv, n_new = self._run_suffix(
                r.tokens[prefix_len:], payloads, prefix_len, keep)
            kv_from = prefix_len
        # split fresh KV into block payloads and insert (suffix discard:
        # only up to ``keep`` tokens total). Each block is its own copy
        # (``_block_copy``), so an evicted block frees its memory rather
        # than pinning the whole kept-KV tensor it was sliced from.
        with self.lock:
            if prefix_len:
                self.cache.unpin(r.chain, use_blocks)
            if not resident:
                n_insertable = self.kv.insertable_tokens(keep, kv_from, n_new)
                n_blocks_new = n_insertable // bs
                payloads_all = self.cache.match_payloads(
                    r.chain)[:use_blocks]
                for b in range(n_blocks_new):
                    payloads_all.append(_block_copy(new_kv, b * bs, bs))
                self.cache.insert(r.chain, kv_from + n_blocks_new * bs,
                                  now=time.perf_counter(),
                                  payloads=payloads_all)
        return logits

    def _execute_packed(self, batch: List[Request]) -> torch.Tensor:
        """Run N requests (cache hits AND misses) as one prepacked forward;
        returns (N, V) logits, one row per request.

        Hit segments pack only their SUFFIX tokens; their cached prefix KV
        is assembled into a per-row prefix buffer that the positioned
        attention reads (``tfm.prefill_packed_with_prefix``). All-miss
        batches take ``tfm.prefill_packed``. Suffix discard is per segment:
        the forward gathers each request's keep window via ``kv_indices``
        (K kept tokens, the solo path's bound), and each window is inserted
        under the request's own chain.
        """
        bs = self.ecfg.block_size
        # cache probe + pin under the lock; the forward runs outside it
        prefs: List[Tuple[int, List, int]] = []
        with self.lock:
            for r in batch:
                matched = self._match_restoring(r.chain, rid=r.req_id)
                plen = self._usable_prefix_len(r.n_input, matched)
                r.n_cached_at_start = plen
                payloads = []
                if plen:
                    self.cache.pin(r.chain, plen // bs)
                    payloads = self.cache.match_payloads(
                        r.chain)[:plen // bs]
                prefs.append((plen, payloads, matched))
                self.hit_tokens += plen
                self.total_tokens += r.n_input
        # realized step shape: the SAME arithmetic formation priced with
        S, Nb, smax, pmax, _ = self._pack_shape(
            [(r.n_input - p, p) for r, (p, _, _) in zip(batch, prefs)])
        # block-aligned NEW keep per request; a chain already resident past
        # its keep bound needs no fresh KV at all
        keeps = [self.kv.keep_new(r.n_input, p, matched)
                 for r, (p, _, matched) in zip(batch, prefs)]
        # gather length padded to a bucket (bounded shape keys); on the hit
        # path tied to S outright (sum(keeps) <= packed suffix tokens)
        if not sum(keeps):
            K = 0
        elif pmax:
            K = S
        else:
            K = _bucket(sum(keeps), self.ecfg.suffix_buckets)
        plens = [p for p, _, _ in prefs]
        host = packed_inputs([r.tokens[p:] for r, p in zip(batch, plens)],
                             plens, keeps, S=S, Nb=Nb, smax=smax, pmax=pmax,
                             K=K, n_last=max(len(batch),
                                             self.ecfg.max_pack_requests))
        # paid forward slots: the flat packed sequence S plus, on the hit
        # path, the reference's padded batched area — Nb*pmax prefix slots
        # and the row slack Nb*smax − S — so padded_slots and BatchRecord
        # report the reference's numbers
        self.padded_slots += S + Nb * pmax + (
            max(0, Nb * smax - S) if pmax else 0)
        self._last_shape = {"S": S, "Nb": Nb if pmax else 0, "smax": smax,
                            "pmax": pmax, "K": K}
        if pmax:
            logits, kv = self._run_packed_hit(
                S, Nb, smax, pmax, K, host,
                [(p, pl) for p, pl, _ in prefs])
        else:
            logits, kv = self._run_packed_miss(S, K, host)
        logits = logits[:len(batch)]          # the padded rows' logits go
        now = time.perf_counter()
        cum = 0
        with self.lock:
            for n, r in enumerate(batch):
                plen = prefs[n][0]
                if plen:
                    self.cache.unpin(r.chain, plen // bs)
                # keeps[n] == 0: nothing insertable (or already resident)
                if kv is not None and keeps[n]:
                    payloads_all = (self.cache.match_payloads(
                        r.chain)[:plen // bs] if plen else [])
                    # each block its own copy: an evicted block frees its
                    # memory rather than pinning the whole gathered KV
                    for b in range(keeps[n] // bs):
                        payloads_all.append(_block_copy(kv, cum + b * bs, bs))
                    self.cache.insert(r.chain, plen + keeps[n], now=now,
                                      payloads=payloads_all)
                cum += keeps[n]
        return logits

    def _compiled(self, path: str, key: Tuple, fn, host,
                  device=None) -> CompiledForward:
        """The compiled forward of ``key`` in the ``path``'s jit cache, made
        on first use, or again when an input's shape changed (jit's rule:
        the key is the shape of every input): ``fn(**inputs)`` over static
        inputs of the ``host`` arrays' shapes and the ``device`` tensors.
        It becomes the most recently used."""
        self._last_path = (path, key)
        table, specs = self._fns[path], _specs(host)
        compiled = table.get(key)
        if compiled is None or compiled.host_specs != specs:
            self._step_compiled = True
            if compiled is not None:
                self._drop(path, key)
            compiled = table[key] = CompiledForward(
                fn, f"{path} {key}", specs, device, on=self.device,
                pool=self._graph_pool, stream=self._graph_stream)
        self._fn_lru[(path, key)] = None
        self._fn_lru.move_to_end((path, key))
        return compiled

    def _run(self, compiled: CompiledForward, host):
        """Call ``compiled``, then drop the least recently used other
        forwards while the live ones hold more than ``graph_memory_bytes``
        (after the call, so the pool always keeps a captured graph)."""
        self.forwards += 1
        out = compiled(host)
        while (self.graph_bytes() > self.ecfg.graph_memory_bytes
               and len(self._fn_lru) > 1):
            self._drop(*next(iter(self._fn_lru)))
        return out

    def _drop(self, path: str, key: Tuple) -> None:
        """Forget a compiled forward: its graph and static outputs go back
        to the pool for later captures. A pool left with no captured graph
        is released; the next capture opens a new one."""
        del self._fns[path][key]
        del self._fn_lru[(path, key)]
        if self._graph_pool is not None and all(
                f.graph is None for f in self.graphs()):
            self._graph_pool = torch.cuda.graph_pool_handle()

    def graph_bytes(self) -> int:
        """Bytes the live compiled forwards hold between steps (the prefix
        buffers are ``prefix_store_bytes``)."""
        return sum(f.held_bytes for f in self.graphs())

    def prefix_store_bytes(self) -> int:
        """Bytes of the prefix buffers alive: the engine's current one, and
        the smaller ones it grew from while hit forwards made before still
        read them (together less than the current one)."""
        views = [f.inputs[n] for f in self.graphs() for n in ("pk", "pv")
                 if n in f.inputs]
        views += list((self._prefix_store or {}).values())
        stores = {v.untyped_storage().data_ptr(): v.untyped_storage().nbytes()
                  for v in views}
        return sum(stores.values())

    def _prefix_views(self, rows: int, P: int) -> Dict[str, torch.Tensor]:
        """Static ``pk``/``pv`` inputs of a new hit forward: (L, rows, P,
        KV, hd) views of the front of the engine's prefix buffer, which
        grows to the next power of two of tokens when a forward needs more.
        A forward keeps the views it was made with (a graph reads fixed
        addresses), so one made before a growth reads the older buffer
        until it is dropped."""
        cfg = self.cfg
        shape = (cfg.num_layers, rows, P, cfg.num_kv_heads, cfg.head_dim)
        n = math.prod(shape)
        store = self._prefix_store
        if store is None or store["k"].numel() < n:
            size = (n // (rows * P)) * (1 << (rows * P - 1).bit_length())
            store = self._prefix_store = {
                name: torch.zeros(size, dtype=torch_dtype(cfg.dtype),
                                  device=self.device) for name in "kv"}
        return {"pk": store["k"][:n].view(shape),
                "pv": store["v"][:n].view(shape)}

    def _run_packed_miss(self, S: int, K: int, host):
        """Packed all-miss forward (``prefill_packed``); the key is (S, K),
        as the reference's: ``last`` is padded to ``max_pack_requests``."""
        params, cfg = self.params, self.cfg

        def fn(toks, seg_ids, positions, last, kv_idx=None):
            return tfm.prefill_packed(params, cfg, toks, seg_ids, positions,
                                      last, kv_indices=kv_idx)

        compiled = self._compiled("packed_miss", (S, K), fn, host)
        return self._run(compiled, host)

    def _run_packed_hit(self, S: int, Nb: int, smax: int, pmax: int, K: int,
                        host, rows):
        """Packed prefix-hit forward: assemble the pinned per-block prefix
        payloads into the (L, Nb, pmax, KV, hd) view of the prefix buffer
        (row n = segment n's prefix; every slot not filled, the ghost rows
        Nb − N included, is zeroed) and run ``prefill_packed_with_prefix``."""
        params, cfg = self.params, self.cfg

        def fn(toks, positions, last, prefix_pos, seg_qidx, pk, pv,
               kv_idx=None):
            return tfm.prefill_packed_with_prefix(
                params, cfg, toks, positions, last, {"k": pk, "v": pv},
                prefix_pos, seg_qidx, kv_indices=kv_idx)

        views = self._prefix_views(Nb, pmax)
        compiled = self._compiled("packed_hit", (S, Nb, smax, pmax, K), fn,
                                  host, views)
        for name, part in (("pk", 0), ("pv", 1)):
            buf = compiled.inputs[name]
            buf[:, len(rows):].zero_()
            for n, (plen, parts) in enumerate(rows):
                if parts:
                    buf[:, n, :plen].copy_(_cat_blocks(parts, part))
                if plen < pmax:
                    buf[:, n, plen:].zero_()
        return self._run(compiled, host)

    def _tokens(self, tokens: Sequence[int], S: int) -> Dict[str, np.ndarray]:
        """Host inputs of a solo forward: every slot of the (1, S) tokens
        written, padding 0, and the last token's index."""
        toks = np.zeros((1, S), np.int64)
        toks[0, :len(tokens)] = tokens
        return {"toks": toks,
                "last": np.array([len(tokens) - 1], np.int64)}

    def _run_fresh(self, tokens: Sequence[int], keep: int = 0):
        S = _bucket(len(tokens), self.ecfg.suffix_buckets)
        # shape-key bucketing of the keep budget is owned by KVLifecycle
        keep_pad = self.kv.keep_pad(keep, S)
        self._last_shape = {"S": S}
        params, cfg = self.params, self.cfg

        def fn(toks, last):
            return tfm.prefill(params, cfg, {"tokens": toks},
                               kv_keep=keep_pad, last_index=last)

        host = self._tokens(tokens, S)
        compiled = self._compiled("fresh", (S, keep_pad), fn, host)
        logits, kv = self._run(compiled, host)
        if kv is None:
            return logits, {"k": None, "v": None}, 0
        # kv: (L, 1, keep_pad, KV, hd); valid fresh tokens = len(tokens),
        # usable budget = the caller's keep (keep_pad only pads the key)
        n_new = min(keep, keep_pad, len(tokens))
        return logits, kv, n_new

    def _run_suffix(self, tokens, payloads, prefix_len: int, keep: int):
        """Cache-hit forward over ``prefix_len`` tokens of pinned block
        payloads, concatenated straight into the (L, 1, P, KV, hd) view of
        the prefix buffer."""
        S = _bucket(len(tokens), self.ecfg.suffix_buckets)
        P = prefix_len
        keep_new = self.kv.suffix_keep_new(keep, prefix_len, S)
        keep_pad = self.kv.keep_pad(keep_new, S)
        self._last_shape = {"S": S, "pmax": P}
        params, cfg = self.params, self.cfg

        def fn(toks, last, pk, pv):
            return tfm.prefill_with_prefix(
                params, cfg, {"tokens": toks}, {"k": pk, "v": pv},
                prefix_len=P, kv_keep=P + keep_pad, last_index=last)

        host = self._tokens(tokens, S)
        compiled = self._compiled("suffix", (S, P, keep_pad), fn, host,
                                  self._prefix_views(1, P))
        for name, part in (("pk", 0), ("pv", 1)):
            _cat_blocks(payloads, part, out=compiled.inputs[name][:, 0])
        logits, kv = self._run(compiled, host)
        n_new = min(keep_new, len(tokens))
        return logits, kv, n_new

    def graphs(self) -> List[CompiledForward]:
        """Every live compiled forward of this engine, in the four paths'
        order."""
        return [f for table in self._fns.values() for f in table.values()]

    # ---- output --------------------------------------------------------------
    def _score(self, logits: torch.Tensor, r: Request) -> Dict:
        """Constrained single-token output: renormalize over allowed ids
        (paper §2.3 — P(Yes)/P(No) without fine-tuning)."""
        out = {"req_id": r.req_id, "latency": r.latency,
               "n_cached": r.n_cached_at_start, "n_input": r.n_input,
               "deadline": r.deadline}
        logits = logits[0].double().cpu().numpy()
        # non-finite guard: constrained scoring needs every allowed logit
        # finite (renormalization); unconstrained argmax tolerates -inf
        # ("never this token") but not NaN or an all-non-finite row.
        if r.allowed_tokens:
            bad = not bool(np.isfinite(logits[list(r.allowed_tokens)]).all())
        else:
            bad = bool(np.isnan(logits).any()
                       or not np.isfinite(logits).any())
        if bad:
            self.nonfinite_results += 1
            self.result_guard.observe(float("nan"))
            out["corrupt"] = "nonfinite_logits"
            out["token"] = -1
            if r.allowed_tokens:
                out["scores"] = {}
            return out
        self.result_guard.observe(0.0)
        if r.allowed_tokens:
            sub = logits[list(r.allowed_tokens)]
            sub = np.exp(sub - sub.max())
            sub /= sub.sum()
            out["scores"] = {int(t): float(p)
                             for t, p in zip(r.allowed_tokens, sub)}
            out["token"] = int(r.allowed_tokens[int(np.argmax(sub))])
        else:
            out["token"] = int(np.argmax(logits))
        return out

    def stats(self) -> Dict:
        return {
            "steps": self.steps,
            "forwards": self.forwards,
            "hit_rate": self.hit_tokens / max(1, self.total_tokens),
            "packed_steps": self.packed_steps,
            "packed_requests": self.packed_requests,
            "packed_hit_requests": self.packed_hit_requests,
            "pack_skew_splits": self.pack_skew_splits,
            "nonfinite_results": self.nonfinite_results,
            # fraction of paid forward slots that were padding/cache slack
            "padding_waste": 1.0 - (self.total_tokens
                                    / max(1, self.padded_slots)),
            "cache": self.cache.stats(),
            "jct": self.jct_monitor.summary(),
        }


_DTYPES = {np.dtype(np.int64): torch.long, np.dtype(np.int32): torch.int32}


def _block_copy(kv: Dict, lo: int, bs: int) -> torch.Tensor:
    """One cache block's payload: a copy of kept tokens [lo, lo + bs) of a
    forward's (L, 1, keep, KV, hd) KV, k and v stacked as one (2, L, 1, bs,
    KV, hd) tensor (``payload[0]`` is k, ``payload[1]`` v) in one
    allocation and one launch, which the offload tier demotes and restores
    whole. The kept KV is a static output of the forward's graph, which the
    next replay overwrites, so blocks are copied out before the step
    ends."""
    return torch.stack([kv["k"][:, :, lo:lo + bs], kv["v"][:, :, lo:lo + bs]])


def _cat_blocks(payloads: Sequence, part: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block payloads' k (``part`` 0) or v (1), each (L, 1, bs, KV, hd),
    concatenated along tokens as one (L, P, KV, hd) tensor. The blocks go
    in as 4-D views: CUDA's ``cat`` copies inputs of more than four
    dimensions one launch each, and takes up to four in batched launches."""
    return torch.cat([p[part][:, 0] for p in payloads], dim=1, out=out)


def _specs(host: Dict[str, np.ndarray]) -> Dict[str, Tuple]:
    """(shape, dtype) of each host input."""
    return {n: (a.shape, _DTYPES[a.dtype]) for n, a in host.items()}


def packed_inputs(suffix_tokens: Sequence[Sequence[int]],
                  plens: Sequence[int], keeps: Sequence[int], *, S: int,
                  Nb: int, smax: int, pmax: int, K: int, n_last: int
                  ) -> Dict[str, np.ndarray]:
    """Host inputs of one packed step at its graph's shapes: segment n's
    ``suffix_tokens[n]`` back to back in (1, S) (the slack 0), over its
    cached prefix of ``plens[n]`` tokens, keeping its first ``keeps[n]``
    fresh tokens' KV (``kv_idx``, padded to K).

    No input's length follows N, as in the reference: ``last`` has
    ``n_last`` rows (the engine's ``max_pack_requests``, or N if more) and
    repeats the last segment's index past N (those logits are dropped);
    on the hit path (``pmax`` > 0) ``prefix_pos`` and ``seg_qidx`` have
    the pack's Nb rows, the ghost rows ``PAD_POS`` and -1, so their prefix
    slots carry id -1 and the tile skip passes them by. A
    miss pack takes ``toks``, ``seg_ids``, ``positions``, ``last`` (and
    ``kv_idx`` when K); a hit pack ``toks``, ``positions``, ``last``,
    ``prefix_pos``, ``seg_qidx`` (and ``kv_idx``)."""
    N = len(suffix_tokens)
    suffixes = [len(t) for t in suffix_tokens]
    lay = {k: t.numpy() for k, t in tfm.packed_layout(
        plens, suffixes, S, rows=Nb, smax=smax, pmax=pmax).items()}
    toks = np.zeros((1, S), np.int64)
    kv_idx = np.zeros((K,), np.int64)
    off = cum = 0
    for n, t in enumerate(suffix_tokens):
        toks[0, off:off + suffixes[n]] = t
        kv_idx[cum:cum + keeps[n]] = off + np.arange(keeps[n])
        off += suffixes[n]
        cum += keeps[n]
    last = np.empty((n_last,), np.int64)
    last[:N] = lay["last_indices"]
    last[N:] = last[N - 1]
    out = {"toks": toks, "positions": lay["positions"], "last": last}
    if pmax:
        ppos = np.full((Nb, pmax), PAD_POS, np.int32)
        ppos[:N] = lay["prefix_pos"]
        out["prefix_pos"] = ppos
        out["seg_qidx"] = lay["seg_qidx"]
    else:
        out["seg_ids"] = lay["seg_ids"]
    if K:
        out["kv_idx"] = kv_idx
    return out
