"""AsyncServer — non-blocking serving over a pool of PrefillOnly engines
(copy of ``repro.serving.server``).

One daemon worker thread per engine instance drives the existing ``step()``
loop (Algorithm-1 pick + prepacked batch formation + hybrid prefill), so
arrival handling, routing, and admission overlap with compute instead of the
old poll-submit-step loop that interleaved them in one thread.

  submit(user_id, tokens, ...) -> Future
      routes (pluggable policy), runs admission control, enqueues on the
      chosen engine, and returns immediately. The future resolves with the
      engine's scored result dict, or with a typed ``Rejected`` — never an
      exception — so callers branch on type, not try/except.

  deadlines
      a request may carry an absolute deadline. Admission rejects requests
      that are predicted dead on arrival; workers shed queued requests whose
      deadline becomes unreachable (``engine.shed_expired``) before every
      step, and ``cancel(req_id)`` removes a queued request on demand.

  drain / shutdown
      ``drain()`` blocks until every admitted request has resolved;
      ``shutdown(drain=True)`` then stops the workers. ``shutdown(False)``
      cancels all queued work with ``Rejected("shutdown")``.

  health
      ``mark_failed(name)`` routes a dead instance's queued requests to
      healthy peers via ``InstancePool`` (futures follow the request — the
      peer that eventually serves it resolves the same future);
      ``scale_to(names)`` grows/shrinks the pool and its worker threads.

Robustness (chaos-hardened serving)
-----------------------------------
Prefill-only requests are idempotent — one stateless forward, one token, no
side effects — so work lost mid-step is safe to re-run anywhere. The server
exploits that end to end:

  retry (``RetryPolicy``)
      a request lost to a mid-step crash, a watchdog trip, or a corrupted
      (non-finite) score is transparently re-submitted to a healthy peer:
      chain re-cut at the peer's block size, deadline feasibility
      re-checked, bounded attempts with per-request exponential backoff.
      Only when the budget or deadline is exhausted does the future resolve
      ``Rejected("error")``. Exactly-once delivery is enforced with
      confiscation tombstones: once a request is re-homed, a late result
      from the original (hung, recovered) instance is dropped, never
      double-delivered.

  watchdog (``runtime.fault_tolerance.JCTDeadlineWatchdog``)
      a maintenance thread compares every instance's in-flight batch age
      against ``factor x`` its *predicted* JCT (plus running-p95 and
      absolute floors). Because prefill-only JCT is precisely predictable,
      an overdue batch is provably wedged: the instance is failed (queued
      work re-homes) and the in-flight batch enters retry instead of
      hanging its futures. Completed steps feed the same watchdog —
      slower-than-deadline steps that still finished count as stragglers.

  brownout (``admission.BrownoutController``)
      backlog/shed-rate overload degrades service instead of collapsing it:
      level 1 tightens admission slack, level 2 disables hit co-packing's
      expensive gather paths on every engine, level 3 rejects new work
      (``Rejected("brownout")``). The level is exported as a gauge.

Telemetry lands in a ``MetricsRegistry`` (per-instance + global counters,
queue-depth/backlog gauges, latency and step-time histograms; see the
README's metric table for the robustness series).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import random
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.prefix_cache import token_chain
from repro_torch.runtime.fault_tolerance import InstancePool, JCTDeadlineWatchdog
from repro_torch.serving.admission import (AdmissionController, BrownoutController,
                                     Rejected)
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.router import UserHashRouter
from repro_torch.serving.tracing import SpanTracer


@dataclasses.dataclass
class RetryPolicy:
    """Idempotent-retry budget for work lost in flight.

    ``budget`` bounds re-submissions per request (0 disables retry: lost
    work resolves ``Rejected("error")`` immediately). ``backoff`` sizes a
    per-request FULL-JITTER exponential backoff before each re-submit:
    attempt k waits ``uniform(0, min(backoff_cap, backoff * 2**k))`` — full
    jitter decorrelates the retry herd after a correlated failure (one dead
    instance confiscates a whole batch at once), while the un-jittered
    ladder re-synchronized every retry onto the same peer at the same
    instant. ``backoff == 0`` retries immediately. ``jitter_seed`` makes
    the draw sequence deterministic for tests. When the server runs a
    maintenance thread, the wait is served by a delayed-resubmit queue
    drained there — the harvesting worker thread never sleeps a backoff
    inline. ``tombstone_ttl`` bounds how long a confiscated request's
    drop-late-result marker (and an unclaimed early-result orphan) is kept
    when nothing ever collects it."""
    budget: int = 2
    backoff: float = 0.02
    backoff_cap: float = 0.5
    tombstone_ttl: float = 300.0
    jitter_seed: Optional[int] = None


class _Tracked:
    """Server-side copy of a submission, kept while its future is open so a
    lost execution can be transparently re-submitted (the engine-side
    Request object is unreachable once a step pops it from the queue)."""

    __slots__ = ("user_id", "tokens", "allowed_tokens", "deadline",
                 "arrival", "attempts", "prior")

    def __init__(self, user_id, tokens, allowed_tokens, deadline, arrival):
        self.user_id = user_id
        self.tokens = tokens
        self.allowed_tokens = allowed_tokens
        self.deadline = deadline
        self.arrival = arrival
        self.attempts = 0
        self.prior: List[int] = []    # confiscated former req_ids


def _result_ok(res: Dict) -> bool:
    """Delivery gate: corrupted results are quarantined, never delivered.
    Checks both the engine's own non-finite flag and the scores themselves
    (defense in depth — corruption injected past the engine still stops
    here)."""
    if res.get("corrupt"):
        return False
    scores = res.get("scores")
    if scores and not all(math.isfinite(v) for v in scores.values()):
        return False
    return True


class AsyncServer:
    IDLE_WAIT = 0.02   # worker poll fallback when its queue is empty

    def __init__(self, pool: InstancePool, router=None,
                 admission: Optional[AdmissionController] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 retry: Optional[RetryPolicy] = None,
                 watchdog: Optional[JCTDeadlineWatchdog] = None,
                 brownout: Optional[BrownoutController] = None,
                 tracer: Optional[SpanTracer] = None):
        self.pool = pool
        self.router = router or UserHashRouter()
        self.admission = admission
        self.metrics = metrics or MetricsRegistry()
        if admission is not None and admission.metrics is None:
            admission.metrics = self.metrics   # feedback-loop telemetry
        self.retry = RetryPolicy() if retry is None else retry
        self.watchdog = watchdog
        self.brownout = brownout
        # request-lifecycle tracing (None = zero overhead). Every retry /
        # watchdog / brownout / re-home decision lands as an event on the
        # affected requests' timelines; engines bound via bind_telemetry
        # add queue/execute/score spans and BatchRecords.
        self.tracer = tracer
        if tracer is not None:
            pool.on_rehome = lambda rid, src, dst: tracer.event_rid(
                rid, "rehome", src=src, dst=dst)
        self._futures: Dict[int, Future] = {}
        self._early: Dict[int, object] = {}   # results that beat registration
        self._early_ts: Dict[int, float] = {}  # ... and when they parked
        self._tracked: Dict[int, _Tracked] = {}
        self._moved: Dict[int, float] = {}    # confiscated rid -> when
        # delayed-resubmit queue: (due, seq, rid, exclude, cause) — lost
        # work waiting out its jittered backoff, drained by maintenance
        self._delayed: List[Tuple[float, int, int, Optional[str], str]] = []
        self._delayed_seq = 0
        self._retry_rng = random.Random(self.retry.jitter_seed
                                        if self.retry is not None else None)
        self._rng_lock = threading.Lock()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._outstanding = 0
        self._events: Dict[str, threading.Event] = {}
        self._threads: Dict[str, threading.Thread] = {}
        self._maint_thread: Optional[threading.Thread] = None
        self._brownout_applied = 0
        self._stop = threading.Event()
        self._accepting = False

    # ---- lifecycle -------------------------------------------------------
    def _bind_engines(self) -> None:
        """Attach registry + tracer to every live engine (idempotent; test
        fakes without bind_telemetry are skipped). ChaosEngine proxies the
        call through to the wrapped engine."""
        for name in self.pool.live_names():
            bind = getattr(self.pool.engines.get(name), "bind_telemetry",
                           None)
            if bind is not None:
                bind(metrics=self.metrics, instance=name, tracer=self.tracer)

    def start(self) -> "AsyncServer":
        self._accepting = True
        self._bind_engines()
        for name in self.pool.live_names():
            self._start_worker(name)
        # the maintenance thread also serves the delayed-resubmit queue, so
        # it must run whenever backoff retries are possible — not only when
        # a watchdog/brownout is configured
        if (self.watchdog is not None or self.brownout is not None
                or (self.retry is not None and self.retry.budget > 0
                    and self.retry.backoff > 0)) \
                and self._maint_thread is None:
            self._maint_thread = threading.Thread(
                target=self._maintenance, name="serve-watchdog", daemon=True)
            self._maint_thread.start()
        return self

    def _start_worker(self, name: str) -> None:
        if name in self._threads and self._threads[name].is_alive():
            return
        if name not in self._events:     # keep the event stable per name:
            self._events[name] = threading.Event()   # workers hold a ref
        t = threading.Thread(target=self._worker, args=(name,),
                             name=f"engine-{name}", daemon=True)
        self._threads[name] = t
        t.start()

    def scale_to(self, names: List[str]) -> None:
        """Elastic rebalance hook: pool.scale_to redistributes queued work
        from removed instances; workers follow the instance set. Requests
        the pool could not re-home resolve as ``Rejected`` (mirroring
        ``mark_failed``) instead of hanging their futures."""
        dropped = self.pool.scale_to(names)
        self._bind_engines()
        for name in self.pool.live_names():
            self._start_worker(name)
        for r in dropped:
            self._reject(r.req_id, Rejected(
                "no_instances", "instance removed with no healthy peer",
                req_id=r.req_id, user_id=r.user_id))
        self._wake_all()

    def mark_failed(self, name: str) -> None:
        """Health hook: requeue the failed instance's waiting requests onto
        healthy peers (their futures stay valid) and retire its worker.
        With no healthy peer left the stranded requests resolve as
        ``Rejected`` rather than hanging their futures."""
        for r in self.pool.mark_failed(name):
            self._reject(r.req_id, Rejected(
                "no_instances", "instance failed with no healthy peer",
                req_id=r.req_id, user_id=r.user_id))
        self._wake_all()

    def _wake_all(self) -> None:
        # snapshot: submit() may insert an event concurrently (setdefault)
        for ev in list(self._events.values()):
            ev.set()

    # ---- submission ------------------------------------------------------
    def _cut_chains(self, tokens: Sequence[int],
                    live: Dict[str, object]) -> Dict[int, tuple]:
        """Chains are granular in the engine's block size: on a
        heterogeneous pool, routing/admission probes and the enqueue must
        each see the chain cut at THEIR engine's block size, or cache
        matching (and the cache inserts keyed on the chain) silently
        misfire."""
        chains: Dict[int, tuple] = {}
        for e in live.values():
            bs = e.ecfg.block_size
            if bs not in chains:
                chains[bs] = token_chain(tokens, bs)
        return chains

    def _enqueue(self, live: Dict[str, object], first: str,
                 tokens: Sequence[int], chains: Dict[int, tuple], *,
                 user_id, allowed_tokens, deadline,
                 arrival) -> Optional[Tuple[str, int]]:
        """Enqueue on ``first``, falling back to each remaining live peer
        on a (transient) submit failure. Returns (instance, req_id), or
        None when every live instance refused the enqueue."""
        order = [first] + [n for n in sorted(live) if n != first]
        for name in order:
            eng = live[name]
            try:
                rid = eng.submit(tokens, allowed_tokens, user_id=user_id,
                                 now=arrival, deadline=deadline,
                                 chain=chains[eng.ecfg.block_size])
                return name, rid
            except Exception:
                self.metrics.counter("submit_failures", name).inc()
        return None

    def submit(self, user_id: Optional[str], tokens: Sequence[int], *,
               allowed_tokens: Optional[Sequence[int]] = None,
               deadline: Optional[float] = None) -> "Future":
        """Non-blocking: route, admit, enqueue; resolves to a result dict or
        a typed ``Rejected``. A transient enqueue failure falls back to the
        next-best live instance (admission was checked against the routed
        instance — the fallback is best-effort by design: refusing outright
        because the preferred instance hiccuped would turn a transient
        fault into a hard rejection)."""
        fut = Future()
        fut.set_running_or_notify_cancel()
        sp = self.tracer
        ctx = (sp.begin(user_id=user_id, n_input=len(tokens),
                        deadline=deadline) if sp is not None else None)

        def _early_reject(rej: Rejected, count: bool = True) -> "Future":
            if count:
                self._count_rejection(rej)
            if sp is not None:
                sp.finish(ctx, f"rejected:{rej.reason}",
                          detail=rej.detail or "")
            fut.set_result(rej)
            return fut

        if not self._accepting:
            return _early_reject(Rejected("shutdown", "server not accepting",
                                          user_id=user_id), count=False)
        if self.brownout is not None and self.brownout.level >= 3:
            return _early_reject(Rejected(
                "brownout", "pool shedding load (brownout level 3)",
                user_id=user_id))
        live = {n: self.pool.engines[n] for n in self.pool.live_names()}
        if not live:
            return _early_reject(Rejected("no_instances", user_id=user_id))
        chains = self._cut_chains(tokens, live)
        routed = self.router.route(user_id=user_id, n_input=len(tokens),
                                   chain=next(iter(chains.values())),
                                   instances=live, chains=chains)
        eng = live[routed]
        arrival = time.perf_counter()
        # routed-instance probe values: admission consumes them, and the
        # route decision is only auditable with the numbers it was made on.
        # Probe only when someone needs them — the untraced/no-admission
        # fast path must not pay two extra engine-lock acquisitions.
        pending = predicted = None
        restore_s = 0.0
        if self.admission is not None or ctx is not None:
            pending = eng.pending_jct()
            predicted = eng.predict_jct(len(tokens),
                                        chains[eng.ecfg.block_size])
            # tiered engine: the JCT probe counts a host-restorable prefix
            # as cached, but restoring it costs a PCIe transfer first —
            # price that into the bound admission checks against
            est_fn = getattr(eng, "restore_estimate", None)
            if est_fn is not None:
                try:
                    restore_s = float(est_fn(
                        chains[eng.ecfg.block_size]).get("restore_s", 0.0))
                except Exception:
                    restore_s = 0.0
            predicted += restore_s
        if ctx is not None:
            sp.event(ctx, "route", instance=routed,
                     router=type(self.router).__name__,
                     pending_jct=pending, predicted_jct=predicted,
                     restore_s=restore_s)
        if self.admission is not None:
            rej = self.admission.check(len(tokens), deadline, arrival,
                                       pending, predicted, user_id=user_id)
            if ctx is not None:
                sp.event(ctx, "admission",
                         verdict="reject" if rej is not None else "admit",
                         reason=getattr(rej, "reason", None),
                         pending_jct=pending, predicted_jct=predicted)
            if rej is not None:
                return _early_reject(rej)
        got = self._enqueue(live, routed, tokens, chains, user_id=user_id,
                            allowed_tokens=allowed_tokens, deadline=deadline,
                            arrival=arrival)
        if got is None:
            return _early_reject(Rejected(
                "error", "enqueue failed on every live instance",
                user_id=user_id))
        name, rid = got
        if ctx is not None:
            sp.bind(ctx, rid)
            sp.event(ctx, "enqueue", instance=name, req_id=rid)
        # routing-time prefetch (paper §9): start the host->device transfer
        # of this request's restorable prefix NOW, so by the time Algorithm 1
        # picks it the KV is device-resident. ``name`` is the instance that
        # actually accepted the enqueue (fallback may differ from ``routed``).
        pf = getattr(live[name], "prefetch_prefix", None)
        if pf is not None:
            try:
                nblk = pf(chains[live[name].ecfg.block_size], rid=rid)
            except Exception:
                nblk = 0
            if nblk:
                self.metrics.counter(
                    "prefetches_triggered", name,
                    help="router-time host->device KV prefetches").inc()
                if ctx is not None:
                    sp.event(ctx, "prefetch", instance=name, blocks=nblk)
        with self._lock:
            early = self._early.pop(rid, None)
            self._early_ts.pop(rid, None)
            if early is None:
                self._futures[rid] = fut
                if self.retry is not None and self.retry.budget > 0:
                    self._tracked[rid] = _Tracked(
                        user_id, list(tokens),
                        tuple(allowed_tokens) if allowed_tokens else None,
                        deadline, arrival)
                self._outstanding += 1
        self.metrics.counter("requests_submitted", name).inc()
        # setdefault: the worker for an instance added via pool.scale_to()
        # directly (or racing server.scale_to) may not exist yet — the event
        # must, so _start_worker can hand it over
        self._events.setdefault(name, threading.Event()).set()
        if early is not None:        # worker finished before we registered
            if ctx is not None:
                sp.finish(ctx, f"rejected:{early.reason}"
                          if isinstance(early, Rejected) else "delivered")
            fut.set_result(early)
            return fut
        # close the enqueue-vs-failure race: if the instance was failed (or
        # the server stopped accepting) while we were enqueueing, the drain
        # may have run BEFORE our append — reclaim the orphan and re-home it
        # to a healthy peer through the retry machinery (the common case in
        # process mode, where submits race the ~100ms failure window), else
        # reject it. cancel() returning None means a worker/peer owns it.
        if not self.pool.healthy.get(name, False) or not self._accepting:
            if eng.cancel(rid) is not None:
                peers = [n for n in self.pool.live_names() if n != name]
                if (self._accepting and peers and self.retry is not None
                        and self.retry.budget > 0):
                    self._handle_lost(rid, name, "enqueue raced failure")
                else:
                    reason = ("shutdown" if not self._accepting
                              else "no_instances")
                    self._reject(rid, Rejected(reason, "instance lost after "
                                               "enqueue", req_id=rid,
                                               user_id=user_id))
        return fut

    def cancel(self, req_id: int) -> bool:
        """Cancel a QUEUED request (no effect once its forward started)."""
        for name in self.pool.live_names():
            r = self.pool.engines[name].cancel(req_id)
            if r is not None:
                self._reject(req_id, Rejected("cancelled", req_id=req_id,
                                              user_id=r.user_id))
                return True
        return False

    # ---- completion ------------------------------------------------------
    def _count_rejection(self, rej: Rejected) -> None:
        """Single site for the rejection counter pair — every rejection
        path must keep stats() in sync with actual outcomes."""
        self.metrics.counter("requests_rejected").inc()
        self.metrics.counter(f"rejected_{rej.reason}").inc()

    def _reject(self, rid: int, rej: Rejected) -> None:
        """Resolve an already-registered request as ``Rejected``."""
        if self._resolve(rid, rej) != "dropped":
            self._count_rejection(rej)

    def _resolve(self, rid: int, result) -> str:
        """Resolve ``rid``'s future with ``result``.

        Returns the delivery status:
          "delivered"  the open future was resolved
          "parked"     submit() hasn't registered the future yet — the
                       result waits in ``_early`` and resolves at
                       registration (counts as delivered for telemetry)
          "dropped"    ``rid`` was confiscated for retry (crash/watchdog/
                       quarantine) — a late result must NOT double-resolve
                       the future its replacement now owns
        """
        with self._lock:
            if self._moved.pop(rid, None) is not None:
                if self.tracer is not None:
                    self.tracer.postmortem_rid(rid, "tombstone_drop")
                return "dropped"
            fut = self._futures.pop(rid, None)
            if fut is None:
                # submit() hasn't registered the future yet — park the result
                # (submit finishes the trace at registration). Timestamped:
                # an orphan nobody ever claims (e.g. a dropped-response
                # submit the worker enqueued anyway) is GC'd by maintenance
                self._early[rid] = result
                self._early_ts[rid] = time.perf_counter()
                return "parked"
            self._tracked.pop(rid, None)
            self._outstanding -= 1
            self._cond.notify_all()
        if self.tracer is not None:
            self.tracer.finish_rid(
                rid, f"rejected:{result.reason}"
                if isinstance(result, Rejected) else "delivered")
        fut.set_result(result)
        return "delivered"

    # ---- idempotent retry ------------------------------------------------
    def _handle_lost(self, rid: int, exclude: Optional[str],
                     cause: str) -> None:
        """An in-flight execution of ``rid`` was lost (mid-step crash,
        watchdog trip, quarantined result): re-submit it to a healthy peer
        within the retry budget, else resolve ``Rejected("error")``.

        Single-owner per rid: the first caller confiscates (the future
        moves to the replacement req_id, the old rid becomes a tombstone
        that drops its late result); concurrent callers — the watchdog and
        a dying worker can race on the same batch — see the rid gone and
        return. Safe to call for rids that already resolved."""
        with self._lock:
            if rid in self._moved or rid not in self._futures:
                return                  # already resolved or confiscated
            tr = self._tracked.get(rid)
        sp = self.tracer
        if sp is not None:
            sp.event_rid(rid, "lost", cause=cause, instance=exclude)
        pol = self.retry
        if tr is None or pol is None or pol.budget <= 0:
            self._reject(rid, Rejected("error", cause, req_id=rid,
                                       user_id=getattr(tr, "user_id", None)))
            return
        if tr.attempts >= pol.budget:
            self._reject(rid, Rejected(
                "error", f"retry budget exhausted after {tr.attempts} "
                f"attempts ({cause})", req_id=rid, user_id=tr.user_id))
            return
        if not self._accepting:
            self._reject(rid, Rejected("error", f"lost during shutdown "
                                       f"({cause})", req_id=rid,
                                       user_id=tr.user_id))
            return
        delay = 0.0
        if pol.backoff > 0:
            cap = min(pol.backoff_cap, pol.backoff * (2 ** tr.attempts))
            with self._rng_lock:        # full jitter: uniform(0, ladder)
                delay = self._retry_rng.uniform(0.0, cap)
        if delay > 0 and self._maint_thread is not None:
            # park on the delayed-resubmit queue instead of sleeping HERE:
            # this path runs on the harvesting worker thread (and on the
            # watchdog scan), where an inline backoff stalls every other
            # request on the instance for the duration
            with self._lock:
                if rid in self._moved or rid not in self._futures:
                    return
                self._delayed_seq += 1
                heapq.heappush(self._delayed,
                               (time.perf_counter() + delay,
                                self._delayed_seq, rid, exclude, cause))
            self.metrics.counter("retries_delayed").inc()
            if sp is not None:
                sp.event_rid(rid, "retry_delayed", delay=delay)
            return
        if delay > 0:
            time.sleep(delay)     # no maintenance thread: legacy inline
        self._resubmit_lost(rid, exclude, cause)

    def _resubmit_lost(self, rid: int, exclude: Optional[str],
                       cause: str) -> None:
        """Route/enqueue/re-key tail of ``_handle_lost``, entered after the
        backoff wait (inline or from the delayed queue). Re-checks
        ownership: the rid may have resolved or been confiscated while it
        waited."""
        sp = self.tracer
        with self._lock:
            if rid in self._moved or rid not in self._futures:
                return
            tr = self._tracked.get(rid)
        if tr is None:
            self._reject(rid, Rejected("error", cause, req_id=rid))
            return
        if not self._accepting:
            self._reject(rid, Rejected("error", f"lost during shutdown "
                                       f"({cause})", req_id=rid,
                                       user_id=tr.user_id))
            return
        live = {n: self.pool.engines[n] for n in self.pool.live_names()
                if n != exclude}
        if not live:
            # no *peer*: fall back to the excluded instance if it is still
            # healthy (quarantine keeps the producer alive; a transient
            # corruption can succeed on re-run even there)
            live = {n: self.pool.engines[n]
                    for n in self.pool.live_names()}
        if not live:
            self._reject(rid, Rejected(
                "error", f"no healthy instance for retry ({cause})",
                req_id=rid, user_id=tr.user_id))
            return
        now = time.perf_counter()
        chains = self._cut_chains(tr.tokens, live)
        peer = self.router.route(user_id=tr.user_id,
                                 n_input=len(tr.tokens),
                                 chain=next(iter(chains.values())),
                                 instances=live, chains=chains)
        eng = live[peer]
        if tr.deadline is not None:
            predicted = (eng.pending_jct() + eng.predict_jct(
                len(tr.tokens), chains[eng.ecfg.block_size]))
            if now + predicted > tr.deadline:
                self._reject(rid, Rejected(
                    "error", f"deadline infeasible on retry ({cause})",
                    req_id=rid, user_id=tr.user_id,
                    predicted_jct=predicted))
                return
        got = self._enqueue(live, peer, tr.tokens, chains,
                            user_id=tr.user_id,
                            allowed_tokens=tr.allowed_tokens,
                            deadline=tr.deadline, arrival=tr.arrival)
        if got is None:
            self._reject(rid, Rejected(
                "error", f"retry enqueue failed on every live instance "
                f"({cause})", req_id=rid, user_id=tr.user_id))
            return
        new_name, new_rid = got
        with self._lock:
            fut = self._futures.pop(rid, None)
            if fut is not None:
                self._tracked.pop(rid, None)
                self._moved[rid] = now    # late result from the old run:
                tr.prior.append(rid)      # drop it, never double-deliver
                tr.attempts += 1
                early = self._early.pop(new_rid, None)
                self._early_ts.pop(new_rid, None)
                if early is None:
                    self._futures[new_rid] = fut
                    self._tracked[new_rid] = tr
        if fut is not None and sp is not None:
            # the replacement rid joins the original timeline; the old rid
            # stays mapped so the confiscated attempt's late result still
            # lands here (as a tombstone_drop event)
            sp.rebind(rid, new_rid)
            sp.event_rid(new_rid, "retry", attempt=tr.attempts,
                         from_rid=rid, instance=new_name, cause=cause)
        if fut is None:
            # rid resolved while we were re-submitting (a late result won
            # the race) — the replacement is a duplicate: reclaim it, and
            # if a worker already owns it, tombstone its result instead
            if live[new_name].cancel(new_rid) is None:
                with self._lock:
                    self._moved[new_rid] = now
            return
        self.metrics.counter("requests_retried", new_name).inc()
        self._events.setdefault(new_name, threading.Event()).set()
        if early is not None:            # peer served before the re-key
            with self._lock:
                self._outstanding -= 1
                self._cond.notify_all()
            fut.set_result(early)

    # ---- watchdog + brownout maintenance ---------------------------------
    def _maintenance(self) -> None:
        interval = (self.watchdog.interval if self.watchdog is not None
                    else 0.05)
        while not self._stop.wait(interval):
            if self.watchdog is not None:
                self._watchdog_scan()
            if self.brownout is not None:
                self._brownout_tick()
            self._drain_delayed()
            self._gc_tombstones()

    def _watchdog_scan(self) -> None:
        """Trip any instance whose in-flight batch is past ``factor x`` its
        predicted JCT: the batch is provably wedged (prefill-only JCT is
        precisely predictable), so fail the instance — queued work re-homes
        — and send the in-flight batch through retry instead of letting its
        futures hang."""
        wd = self.watchdog
        now = time.perf_counter()
        for name in self.pool.live_names():
            eng = self.pool.engines.get(name)
            snap = getattr(eng, "inflight_snapshot", None)
            if eng is None or snap is None:
                continue
            try:
                ids, pred, t0 = snap()
            except Exception:
                continue
            if not ids:
                continue
            elapsed = now - t0
            deadline = wd.batch_deadline(pred)
            if elapsed <= deadline:
                continue
            wd.trips += 1
            self.metrics.counter("watchdog_trips", name).inc()
            if self.tracer is not None:
                for rid in ids:
                    self.tracer.event_rid(rid, "watchdog_trip",
                                          instance=name, elapsed=elapsed,
                                          batch_deadline=deadline)
            self.mark_failed(name)
            for rid in ids:
                self._handle_lost(rid, exclude=name,
                                  cause=f"watchdog trip: batch "
                                        f"{elapsed:.2f}s past its "
                                        f"{deadline:.2f}s JCT deadline")

    def _brownout_tick(self) -> None:
        backlog = 0.0
        for name in self.pool.live_names():
            eng = self.pool.engines.get(name)
            if eng is None:
                continue
            try:
                backlog = max(backlog, eng.pending_jct())
            except Exception:
                continue
        shed = (self.admission.shed_rate()
                if self.admission is not None else 0.0)
        self._apply_brownout(self.brownout.evaluate(backlog, shed))

    def _apply_brownout(self, level: int) -> None:
        if level == self._brownout_applied:
            return
        prev, self._brownout_applied = self._brownout_applied, level
        if self.tracer is not None:
            # a brownout transition affects every in-flight request
            self.tracer.broadcast(
                "brownout", level=level, prev=prev,
                state=BrownoutController.LEVELS[level])
        m = self.metrics
        m.gauge("brownout_level").set(level)
        m.state_gauge("brownout_state", BrownoutController.LEVELS).set(level)
        m.counter("brownout_escalations" if level > prev
                  else "brownout_deescalations").inc()
        if self.admission is not None:
            self.admission.set_pressure(self.brownout.pressure())
        degraded = level >= 2
        for name in self.pool.live_names():
            set_deg = getattr(self.pool.engines.get(name),
                              "set_degraded", None)
            if set_deg is not None:
                set_deg(degraded)

    def _drain_delayed(self) -> None:
        """Re-submit lost work whose jittered backoff has elapsed (the
        delayed-resubmit queue ``_handle_lost`` parks on when a
        maintenance thread exists)."""
        now = time.perf_counter()
        ready = []
        with self._lock:
            while self._delayed and self._delayed[0][0] <= now:
                ready.append(heapq.heappop(self._delayed))
        for _, _, rid, exclude, cause in ready:
            self._resubmit_lost(rid, exclude, cause)

    def _gc_tombstones(self) -> None:
        """Drop confiscation tombstones whose late result never arrived
        (the crashed worker died before harvesting), and early-result
        orphans no submit() ever claimed (a dropped-response submit the
        worker enqueued and served anyway) — bounds both sets."""
        ttl = self.retry.tombstone_ttl if self.retry is not None else 300.0
        cutoff = time.perf_counter() - ttl
        with self._lock:
            stale = [rid for rid, t in self._moved.items() if t < cutoff]
            for rid in stale:
                del self._moved[rid]
            orphans = [rid for rid, t in self._early_ts.items()
                       if t < cutoff]
            for rid in orphans:
                self._early.pop(rid, None)
                del self._early_ts[rid]
        for _ in orphans:
            self.metrics.counter("early_orphans_gced").inc()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every admitted request has resolved."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._outstanding > 0:
                left = (None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
                if left == 0.0 or not self._cond.wait(timeout=left or 0.5):
                    if deadline is not None and time.monotonic() >= deadline:
                        return False
        return True

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        self._accepting = False
        drained = self.drain(timeout) if drain else False
        if not drained:
            # not draining, or drain timed out: every still-queued request
            # must resolve (``Rejected``) — never strand a future
            for name in list(self.pool.engines):
                eng = self.pool.engines[name]
                with eng.lock:
                    dropped = list(eng.queue)
                    eng.queue.clear()
                for r in dropped:
                    self._reject(r.req_id, Rejected(
                        "shutdown", req_id=r.req_id, user_id=r.user_id))
        self._stop.set()
        self._wake_all()
        # flush the delayed-resubmit queue: entries not yet due when the
        # maintenance thread stops must still resolve their futures
        with self._lock:
            flush, self._delayed = list(self._delayed), []
        for _, _, rid, _, cause in flush:
            self._reject(rid, Rejected(
                "shutdown", f"retry abandoned at shutdown ({cause})",
                req_id=rid))
        for t in self._threads.values():
            t.join(timeout=5.0)
        if self._maint_thread is not None:
            self._maint_thread.join(timeout=5.0)

    # ---- worker loop -----------------------------------------------------
    def _worker(self, name: str) -> None:
        ev = self._events[name]
        m = self.metrics
        while not self._stop.is_set():
            # re-fetch per iteration: scale_to may replace the engine object
            # behind a reused instance name while we were mid-step
            eng = self.pool.engines.get(name)
            if eng is None or not self.pool.healthy.get(name, False):
                # failed/removed: park instead of exiting. If the instance
                # is resurrected (scale_to remove + re-add), this thread
                # resumes as its worker — exiting here would race
                # _start_worker's is_alive() check and leave a revived
                # instance with no worker. A parked thread costs one idle
                # poll and exits at shutdown.
                if self._threads.get(name) is not threading.current_thread():
                    return                  # superseded by a newer worker
                ev.wait(timeout=self.IDLE_WAIT)
                ev.clear()
                continue
            for r in eng.shed_expired():
                # feedback: a shed request is one admission under-estimated
                if self.admission is not None:
                    self.admission.record_outcome(shed=True)
                self._reject(r.req_id, Rejected(
                    "shed", "deadline unreachable in queue",
                    req_id=r.req_id, user_id=r.user_id))
            t0 = time.perf_counter()
            try:
                rid = eng.step()
            except Exception:
                # a dying worker must not strand futures: fail the instance
                # FIRST (queued work re-homes to peers while they exclude
                # it), then send the mid-step batch through idempotent
                # retry — it resolves Rejected("error") only once the
                # budget, deadline, or pool is exhausted
                m.counter("engine_errors", name).inc()
                lost = list(getattr(eng, "_inflight", []))
                self.mark_failed(name)
                for rid2 in lost:
                    self._handle_lost(rid2, exclude=name,
                                      cause="instance crashed mid-step")
                continue                    # park above until resurrected
            if rid is None:
                ev.wait(timeout=self.IDLE_WAIT)
                ev.clear()
                continue
            step_s = time.perf_counter() - t0
            m.histogram("step_seconds", name).observe(step_s)
            # first-use steps are excluded from the watchdog history for the
            # same reason the engine excludes them from the JCT fit: a
            # capture of seconds is neither a straggler nor a sample
            # of normal step time, and one of them would drag the p95
            # fallback deadline past real hangs
            if (self.watchdog is not None
                    and not getattr(eng, "_step_compiled", False)
                    and self.watchdog.observe(step_s)):
                # finished, but past the p95 deadline: a straggler signal
                # worth counting even though nothing needed recovery
                m.counter("straggler_steps", name).inc()
            with eng.lock:
                # pop the future's delivery payload; default None — a result
                # can be legitimately absent (request cancelled or
                # confiscated between step completion and harvest), and a
                # KeyError here would misclassify the ENGINE as failed
                served = [(i, eng.results.pop(i, None))
                          for i in eng.last_step_ids]
                depth = len(eng.queue)
            m.gauge("queue_depth", name).set(depth)
            m.gauge("backlog_seconds", name).set(eng.pending_jct())
            for rid2, res in served:
                if res is None:
                    continue
                if not _result_ok(res):
                    # non-finite score: quarantine — never deliver NaN — and
                    # re-run on a peer (the forward is idempotent; transient
                    # corruption re-runs clean, persistent corruption
                    # exhausts the budget into Rejected("error"))
                    m.counter("results_quarantined", name).inc()
                    if self.tracer is not None:
                        self.tracer.event_rid(
                            rid2, "quarantine", instance=name,
                            corrupt=res.get("corrupt") or "nan in scores")
                    self._handle_lost(
                        rid2, exclude=name,
                        cause=f"non-finite score quarantined "
                              f"({res.get('corrupt') or 'nan in scores'})")
                    continue
                status = self._resolve(rid2, res)
                if status == "dropped":
                    # this batch was confiscated (watchdog trip) while the
                    # step dawdled — its replacement owns the future now
                    m.counter("late_results_dropped", name).inc()
                    continue
                m.counter("requests_served", name).inc()
                m.histogram("latency_seconds", name).observe(res["latency"])
                if (self.admission is not None
                        and res.get("deadline") is not None):
                    self.admission.record_outcome(shed=False)

    # ---- introspection ---------------------------------------------------
    def stats(self) -> Dict:
        return {
            "served": self.metrics.total("requests_served"),
            "rejected": self.metrics.total("requests_rejected"),
            "retried": self.metrics.total("requests_retried"),
            "watchdog_trips": self.metrics.total("watchdog_trips"),
            "quarantined": self.metrics.total("results_quarantined"),
            "brownout_level": (self.brownout.level
                               if self.brownout is not None else 0),
            "latency": self.metrics.merged_histogram(
                "latency_seconds").summary(),
            "tracer": (self.tracer.stats()
                       if self.tracer is not None else None),
            "per_instance": {n: self.pool.engines[n].stats()
                             for n in self.pool.live_names()},
        }
