"""Fault-tolerance machinery for 1000+-node deployments (copy of
``repro.runtime.fault_tolerance``).

Training side:
  * StepWatchdog — straggler/hang detection: per-step deadline derived from a
    running p95; on trip, the driver checkpoints and re-shards (drain-and-
    rejoin, synchronous-SPMD's answer to stragglers)
  * NaNGuard    — skip-and-reload policy on non-finite loss
  * Preemption  — SIGTERM -> checkpoint-then-exit hook

Serving side:
  * InstancePool — health-checked engine instances, rendezvous (HRW) user
    routing that minimally remaps users on scale-up/down (elastic), and
    automatic re-dispatch of requests from dead instances.
"""
from __future__ import annotations

import contextlib
import hashlib
import signal
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np


def _engine_lock(eng):
    """The engine's queue lock when it has one (AsyncServer-driven real
    engines), else a no-op context (simulator/test fakes)."""
    return getattr(eng, "lock", None) or contextlib.nullcontext()


def _block_size(eng) -> Optional[int]:
    return getattr(getattr(eng, "ecfg", None), "block_size", None)


def _rechain(req, old, peer) -> None:
    """Re-cut a re-homed request's block-hash chain at the RECEIVING
    engine's block size. Chains are granular in block size; on a
    heterogeneous pool a chain cut for ``old`` would silently miss (and,
    worse, corrupt inserts into) ``peer``'s prefix cache. No-op for test
    fakes without ``ecfg``/``tokens``."""
    bs_old, bs_new = _block_size(old), _block_size(peer)
    tokens = getattr(req, "tokens", None)
    if (bs_new is None or bs_new == bs_old or tokens is None
            or getattr(req, "chain", None) is None):
        return
    from repro_torch.core.prefix_cache import token_chain  # lazy
    req.chain = token_chain(tokens, bs_new)


class StepWatchdog:
    """Flags steps slower than ``factor`` x running p95 (straggler signal)."""

    def __init__(self, window: int = 50, factor: float = 3.0,
                 min_history: int = 10):
        self.times = deque(maxlen=window)
        self.factor = factor
        self.min_history = min_history
        self.trips = 0

    def observe(self, seconds: float) -> bool:
        tripped = False
        if len(self.times) >= self.min_history:
            deadline = float(np.percentile(self.times, 95)) * self.factor
            if seconds > deadline:
                self.trips += 1
                tripped = True
        self.times.append(seconds)
        return tripped

    def deadline(self) -> Optional[float]:
        if len(self.times) < self.min_history:
            return None
        return float(np.percentile(self.times, 95)) * self.factor


class JCTDeadlineWatchdog(StepWatchdog):
    """Serving-side hang detector over *predicted* batch JCT.

    Prefill-only serving has no token-by-token progress signal — a step
    either returns or it doesn't — but it has something better: the JCT of
    the in-flight batch is precisely predictable (paper §6.3). A batch that
    has run longer than ``factor x predicted JCT`` is therefore *provably*
    wedged (hung collective, dead accelerator, runaway recompile), not
    merely slow: hang detection becomes arithmetic, not heuristic.

    ``batch_deadline(predicted)`` is the per-batch wall-clock budget:
    ``factor x predicted``, floored by the running-p95 deadline the training
    watchdog uses (``StepWatchdog.deadline()`` — covers a cold or degenerate
    JCT fit, where ``predicted`` can be ~0) and by ``min_deadline``
    (absolute floor so jitter on near-zero predictions never trips).

    Callers also feed COMPLETED step durations through ``observe`` — slower-
    than-p95 steps that still finished are stragglers worth counting, and
    the history keeps the fallback deadline calibrated.
    """

    def __init__(self, factor: float = 4.0, min_deadline: float = 1.0,
                 window: int = 50, min_history: int = 10,
                 interval: float = 0.05):
        super().__init__(window=window, factor=factor,
                         min_history=min_history)
        self.min_deadline = min_deadline
        self.interval = interval     # scan period of the watchdog thread

    def observe(self, seconds: float) -> bool:
        """Like ``StepWatchdog.observe`` but a tripped sample is NOT folded
        into the history: a step flagged as a straggler/hang is exactly the
        outlier the p95 floor must stay calibrated against. One 6s hang in
        a 100ms-step history would otherwise drag the fallback deadline to
        ~18s and blind the scan to every subsequent hang."""
        tripped = False
        if len(self.times) >= self.min_history:
            d = float(np.percentile(self.times, 95)) * self.factor
            if seconds > d:
                self.trips += 1
                tripped = True
        if not tripped:
            self.times.append(seconds)
        return tripped

    def batch_deadline(self, predicted: float) -> float:
        deadline = self.factor * max(0.0, predicted)
        hist = self.deadline()
        if hist is not None:
            deadline = max(deadline, hist)
        return max(deadline, self.min_deadline)


class NaNGuard:
    """Counts consecutive non-finite losses; advises reload after ``limit``."""

    def __init__(self, limit: int = 3):
        self.limit = limit
        self.consecutive = 0
        self.total_skipped = 0

    def observe(self, loss: float) -> str:
        """Returns 'ok' | 'skip' | 'reload'."""
        if np.isfinite(loss):
            self.consecutive = 0
            return "ok"
        self.consecutive += 1
        self.total_skipped += 1
        return "reload" if self.consecutive >= self.limit else "skip"


class PreemptionHandler:
    """SIGTERM/SIGINT -> set a flag the train loop checks each step."""

    def __init__(self):
        self.requested = False
        self._prev = {}

    def install(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handle)
            except ValueError:
                pass  # not main thread (tests)
        return self

    def _handle(self, signum, frame):
        self.requested = True

    def uninstall(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


def rendezvous_hash(user_id: str, instances: List[str]) -> str:
    """Highest-random-weight routing: adding/removing an instance remaps only
    ~1/n of users (the elastic property user-id routing needs)."""
    best, best_w = instances[0], -1.0
    for inst in instances:
        h = hashlib.blake2b(f"{user_id}|{inst}".encode(),
                            digest_size=8).digest()
        w = int.from_bytes(h, "big")
        if w > best_w:
            best, best_w = inst, w
    return best


class InstancePool:
    """Elastic pool of serving engines with health checks + re-dispatch."""

    def __init__(self, make_engine: Callable[[str], object]):
        self.make_engine = make_engine
        self.engines: Dict[str, object] = {}
        self.healthy: Dict[str, bool] = {}
        self.redispatched = 0
        # observability hook: called as (req_id, src, dst) for every queued
        # request re-homed off a failed/removed instance (AsyncServer wires
        # this into the request's trace timeline)
        self.on_rehome: Optional[Callable[[int, str, str], None]] = None

    def scale_to(self, names: List[str]) -> List:
        """Grow/shrink the pool. Returns the requests that could NOT be
        re-homed from removed instances (no healthy peer) — the caller
        decides their fate (AsyncServer rejects their futures)."""
        for n in names:
            if n not in self.engines:
                self.engines[n] = self.make_engine(n)
                self.healthy[n] = True
        removed = [n for n in self.engines if n not in names]
        # mark every removed instance unhealthy BEFORE draining any of them:
        # route() must not re-home queued work onto an instance that is
        # itself about to be deleted (or back onto the one being drained)
        for n in removed:
            self.healthy[n] = False
        dropped = []
        for n in removed:
            dropped.extend(self._drain(n))
            del self.engines[n]
            del self.healthy[n]
        return dropped

    def mark_failed(self, name: str) -> List:
        """Node failure: re-dispatch its queued requests to healthy peers.
        Returns the requests that could NOT be re-homed (no healthy peer) —
        the caller decides their fate (AsyncServer rejects their futures)."""
        if name in self.engines:
            self.healthy[name] = False
            return self._drain(name)
        return []

    def _drain(self, name: str) -> List:
        eng = self.engines[name]
        # cross-process engines (serving.supervisor.RemoteEngine) expose
        # drain_queue/requeue hooks: the shadow queue must be handed over
        # atomically, and a re-home must actually cross the RPC boundary —
        # a bare peer.queue.append would only mutate the client-side mirror
        drain = getattr(eng, "drain_queue", None)
        if drain is not None:
            pending = drain()
        else:
            with _engine_lock(eng):
                pending = list(getattr(eng, "queue", []))
                eng.queue and eng.queue.clear()
        dropped = []
        for r in pending:
            target = self.route(r.user_id or str(r.req_id))
            if target is None:
                dropped.append(r)
                continue
            peer = self.engines[target]
            _rechain(r, eng, peer)
            requeue = getattr(peer, "requeue", None)
            try:
                if requeue is not None:
                    requeue([r])
                else:
                    with _engine_lock(peer):
                        peer.queue.append(r)
            except Exception:
                # the chosen peer refused (draining/dead mid-scan): the
                # caller decides the request's fate, same as no-peer
                dropped.append(r)
                continue
            self.redispatched += 1
            if self.on_rehome is not None:
                self.on_rehome(r.req_id, name, target)
        return dropped

    def live_names(self) -> List[str]:
        return [n for n, ok in self.healthy.items() if ok]

    def route(self, user_id: str) -> Optional[str]:
        live = self.live_names()
        if not live:
            return None
        return rendezvous_hash(user_id, live)

    def submit(self, user_id: str, *args, **kw):
        name = self.route(user_id)
        if name is None:
            raise RuntimeError("no healthy instances")
        return name, self.engines[name].submit(*args, user_id=user_id, **kw)

    def step_all(self) -> int:
        done = 0
        for n in self.live_names():
            if getattr(self.engines[n], "queue", None):
                self.engines[n].step()
                done += 1
        return done
