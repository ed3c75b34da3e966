"""Chaos harness — seeded, deterministic fault injection for the serving stack
(copy of ``repro.serving.chaos``, thread mode).

Prefill-only serving is uniquely testable under faults: every request is one
stateless, side-effect-free forward producing one token, so a lost request
can be re-run anywhere with no duplicate-output hazard, and "did every future
resolve exactly once" is a crisp invariant a chaos soak can assert. This
module provides the faults; ``AsyncServer`` (watchdog + retry + brownout)
provides the recovery the soak proves out.

``ChaosConfig`` declares per-operation fault *rates* plus an optional exact
``schedule``; ``FaultPlan`` turns that into deterministic per-instance draws
(seeded ``Philox``-free: one ``numpy`` generator per instance, seeded from
``(seed, instance name)``, so a run replays bit-identically given the same
request interleaving); ``ChaosEngine`` wraps a pool engine and injects:

  step_error   step() raises ``InjectedFault`` AFTER the forward completed,
               with the batch's results destroyed — the worst mid-step crash:
               work was in flight and is gone. The server's worker must
               retry the lost batch on a peer and fail the instance.
  hang         step() completes, then blocks for ``hang_seconds`` while
               still REPORTING the batch as in-flight — a wedged step from
               the outside. The JCT watchdog must trip, confiscate the
               batch onto a peer, and the late results must be dropped
               (exactly-once), not double-delivered.
  straggler    step() completes, then dawdles ``straggler_seconds`` with the
               batch still reported in-flight — slow, not dead. Below the
               watchdog deadline this must NOT trip; results deliver late.
  nan_score    the step's results are corrupted to non-finite scores (a
               NaN-logits failure that a benchmark can otherwise miss) —
               the server must quarantine and retry them, never deliver
               NaN.
  submit_error submit() raises ``InjectedFault`` — a transient enqueue
               failure; the server must fall back to a peer.

Process-mode faults (``kill``, ``freeze``, ``rpc_drop``, ``rpc_delay``) hit a
worker PROCESS of the cross-process serving plane, which the port does not
have yet: their kinds, rates and draw streams are kept (``FaultPlan.draw``
and ``rpc_fault`` consume the reference's sequence), and the injectors that
act on processes (``ProcessChaosEngine``, ``wrap_pool_processes``) come with
the process-mode slice.

Wrap a whole pool with ``wrap_pool(pool, plan)`` — live engines are wrapped
in place and ``pool.make_engine`` is chained so instances born later (scale-
up, resurrection) inherit the same plan.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

STEP_FAULTS = ("step_error", "hang", "straggler", "nan_score")
SUBMIT_FAULTS = ("submit_error",)
PROCESS_FAULTS = ("kill", "freeze")
RPC_FAULTS = ("rpc_drop", "rpc_delay")
FAULT_KINDS = STEP_FAULTS + SUBMIT_FAULTS + PROCESS_FAULTS + RPC_FAULTS

# which operation stream each fault kind draws from (see FaultPlan.draw)
_OP_OF = {**{k: "step" for k in STEP_FAULTS},
          **{k: "submit" for k in SUBMIT_FAULTS},
          **{k: "pstep" for k in PROCESS_FAULTS},
          **{k: "rpc" for k in RPC_FAULTS}}


class InjectedFault(RuntimeError):
    """Raised by injected step/submit failures (never by real code paths)."""


@dataclasses.dataclass
class ChaosConfig:
    """Per-operation fault rates + optional exact schedule, one seed.

    Rates are per *eligible* operation: step faults draw once per step that
    has work queued (an idle poll can't lose anything), submit faults once
    per submit. ``schedule`` entries ``(instance, op_index, kind)`` fire
    deterministically at that instance's ``op_index``-th eligible operation
    (steps and submits indexed separately) and override the rate draw.
    ``max_faults`` bounds TOTAL injected faults across the run so a chaos
    soak converges instead of grinding the pool to zero instances.
    """
    seed: int = 0
    step_error: float = 0.0
    hang: float = 0.0
    hang_seconds: float = 1.0
    straggler: float = 0.0
    straggler_seconds: float = 0.1
    nan_score: float = 0.0
    submit_error: float = 0.0
    kill: float = 0.0
    freeze: float = 0.0
    freeze_seconds: float = 1.0
    rpc_drop: float = 0.0
    rpc_delay: float = 0.0
    rpc_delay_seconds: float = 0.05
    schedule: Sequence[Tuple[str, int, str]] = ()
    max_faults: Optional[int] = None

    def __post_init__(self):
        for _, _, kind in self.schedule:
            assert kind in FAULT_KINDS, kind


class FaultPlan:
    """Deterministic fault oracle shared by every ChaosEngine of one run.

    Thread-safe: each serving worker draws for its own instance, and the
    global ``max_faults`` budget is decremented under one lock. Draws are a
    pure function of (seed, instance, operation index), so two runs with the
    same config and request interleaving inject identically.
    """

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self.injected: List[Tuple[str, int, str]] = []   # audit trail
        self._lock = threading.Lock()
        self._rngs: Dict[str, np.random.Generator] = {}
        self._ops: Dict[Tuple[str, str], int] = {}       # (instance, op) -> n
        self._sched = {(i, n, _OP_OF[k]): k for i, n, k in cfg.schedule}

    def _rng(self, instance: str) -> np.random.Generator:
        if instance not in self._rngs:
            # stable across processes (str hash() is salted per interpreter)
            import hashlib
            h = int.from_bytes(hashlib.blake2b(
                instance.encode(), digest_size=4).digest(), "big")
            self._rngs[instance] = np.random.default_rng([self.cfg.seed, h])
        return self._rngs[instance]

    def draw(self, instance: str, op: str) -> Optional[str]:
        """The fault to inject for this instance's next ``op`` — or None.

        ``op`` is "step", "submit", "pstep" (process-level step fault), or
        "rpc" (response fault). Consumes one operation index either way
        (rates stay per-operation, not per-call-that-faulted).
        """
        ladders = {"step": STEP_FAULTS, "submit": SUBMIT_FAULTS,
                   "pstep": PROCESS_FAULTS, "rpc": RPC_FAULTS}
        cfg = self.cfg
        with self._lock:
            n = self._ops.get((instance, op), 0)
            self._ops[(instance, op)] = n + 1
            kind = self._sched.get((instance, n, op))
            if kind is None:
                rates = [(k, getattr(cfg, k)) for k in ladders[op]]
                # one uniform draw walks the rate ladder: stable under
                # adding kinds, and each op costs exactly one rng call
                u = float(self._rng(instance).uniform())
                acc = 0.0
                for k, rate in rates:
                    acc += rate
                    if u < acc:
                        kind = k
                        break
            if kind is None:
                return None
            if (cfg.max_faults is not None
                    and len(self.injected) >= cfg.max_faults):
                return None
            self.injected.append((instance, n, kind))
            return kind

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for _, _, k in self.injected:
                out[k] = out.get(k, 0) + 1
            return out

    def rpc_fault(self, instance: str,
                  op: str) -> Optional[Tuple[str, float]]:
        """``RpcClient.fault_hook`` adapter: drop/delay the RESPONSE of a
        submit or step call (the worker already processed it — exactly the
        fault window where exactly-once is hardest). Other ops (heartbeat,
        probe, requeue) are left alone: randomly failing the failure
        DETECTOR itself would make every soak assertion about detection
        latency vacuous."""
        if op not in ("submit", "step"):
            return None
        kind = self.draw(instance, "rpc")
        if kind == "rpc_drop":
            return ("rpc_drop", 0.0)
        if kind == "rpc_delay":
            return ("rpc_delay", self.cfg.rpc_delay_seconds)
        return None


class ChaosEngine:
    """Transparent engine proxy that injects the plan's faults.

    Every attribute not intercepted here proxies to the wrapped engine
    (lock, queue, results, probes, stats, ...), so the server, routers, and
    ``InstancePool`` drive a ChaosEngine exactly like the real thing.

    Hang/straggler injection happens AFTER the inner step completed, while
    ``inflight_snapshot`` keeps reporting the served batch as in-flight —
    from the server's side the step simply hasn't returned, which is
    exactly what a wedged forward looks like, without reaching into the
    engine's internals (real engines wrap as cleanly as test fakes).
    """

    def __init__(self, inner, name: str, plan: FaultPlan):
        # object.__setattr__-free: plain attrs, __getattr__ only fires for
        # names NOT set here
        self._inner = inner
        self._name = name
        self._plan = plan
        self._shadow_lock = threading.Lock()
        self._shadow_ids: List[int] = []
        self._shadow_t0 = 0.0

    def __getattr__(self, attr):
        return getattr(self._inner, attr)

    # ---- intercepted surface ---------------------------------------------
    def submit(self, *args, **kw) -> int:
        if self._plan.draw(self._name, "submit") == "submit_error":
            raise InjectedFault(f"injected submit failure on {self._name}")
        return self._inner.submit(*args, **kw)

    def inflight_snapshot(self) -> Tuple[List[int], float, float]:
        with self._shadow_lock:
            if self._shadow_ids:
                # predicted JCT 0.0: the step already finished, there is no
                # honest prediction left — the watchdog's min_deadline /
                # p95-history floor governs when a shadowed hang trips
                return list(self._shadow_ids), 0.0, self._shadow_t0
        snap = getattr(self._inner, "inflight_snapshot", None)
        return snap() if snap is not None else ([], 0.0, 0.0)

    @property
    def _inflight(self) -> List[int]:
        """Crash accounting the server's worker reads after a step raised:
        a post-step injected crash lost the whole served batch."""
        with self._shadow_lock:
            if self._shadow_ids:
                return list(self._shadow_ids)
        return list(getattr(self._inner, "_inflight", []))

    def step(self) -> Optional[int]:
        if not getattr(self._inner, "queue", None):
            return self._inner.step()        # idle poll: nothing to lose
        kind = self._plan.draw(self._name, "step")
        t0 = time.perf_counter()
        rid = self._inner.step()
        if rid is None or kind is None:
            return rid
        served = list(self._inner.last_step_ids)
        if kind == "nan_score":
            with _lock_of(self._inner):
                for i in served:
                    res = self._inner.results.get(i)
                    if res is None:
                        continue
                    res["corrupt"] = "injected_nan"
                    if res.get("scores"):
                        res["scores"] = {t: float("nan")
                                         for t in res["scores"]}
            return rid
        if kind in ("hang", "straggler"):
            cfg = self._plan.cfg
            dwell = (cfg.hang_seconds if kind == "hang"
                     else cfg.straggler_seconds)
            with self._shadow_lock:
                self._shadow_ids = served
                # dwell start, NOT the real step's t0: whether an injected
                # dwell trips the watchdog must depend only on (dwell,
                # deadline), never on how long the honest forward happened
                # to take — otherwise a large packed batch plus a small
                # straggler crosses min_deadline and kills a healthy
                # instance nondeterministically
                self._shadow_t0 = time.perf_counter()
            try:
                time.sleep(dwell)
            finally:
                with self._shadow_lock:
                    self._shadow_ids = []
            return rid
        # step_error: the crash landed after the forward — results are gone,
        # the batch reads as in-flight, and step() dies like the chip did
        with _lock_of(self._inner):
            for i in served:
                self._inner.results.pop(i, None)
        with self._shadow_lock:
            self._shadow_ids = served        # never cleared: instance dies
            self._shadow_t0 = t0
        raise InjectedFault(f"injected step crash on {self._name}")


def _lock_of(eng):
    lock = getattr(eng, "lock", None)
    if lock is not None:
        return lock
    import contextlib
    return contextlib.nullcontext()


def wrap_pool(pool, plan: FaultPlan):
    """Wrap every live engine of ``pool`` in a ChaosEngine and chain
    ``pool.make_engine`` so later instances (scale-up, resurrection after a
    chaos kill) are wrapped under the same plan. Returns ``pool``."""
    inner_make = pool.make_engine

    def make(name: str):
        return ChaosEngine(inner_make(name), name, plan)

    pool.make_engine = make
    for name in list(pool.engines):
        eng = pool.engines[name]
        if not isinstance(eng, ChaosEngine):
            pool.engines[name] = ChaosEngine(eng, name, plan)
    return pool
