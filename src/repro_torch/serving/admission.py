"""Admission control — reject infeasible work up front, shed doomed work early
(copy of ``repro.serving.admission``).

Prefill-only JCT is precisely predictable (paper §6.3), which turns admission
control from a heuristic into arithmetic:

  * MIL check: a request longer than the engine's max input length (closed
    form from ``kv_policy.MemoryModel``) can NEVER be served — reject at the
    door instead of OOMing an instance.
  * Deadline check: predicted queue delay + predicted JCT past the deadline
    means the request is already doomed — reject it now (a typed ``Rejected``
    result) instead of letting it queue, blow out its own latency, and drag
    every request behind it into the tail.

The in-queue half of the same policy lives in
``PrefillOnlyEngine.shed_expired``: requests whose deadline becomes
unreachable AFTER admission (backlog grew, cache churned) are popped before
the next scheduling step.

Feedback loop: every admitted-with-deadline request eventually reports back
(``record_outcome``) whether it was served or shed in-queue. A shed request
is a request the admission predictor UNDER-estimated — it said feasible, the
queue said otherwise. When the shed rate over a sliding window exceeds
``shed_target``, ``deadline_slack`` is tightened (multiplied up, so the
deadline check turns pessimistic and rejects earlier); sustained zero-shed
windows relax it back toward the configured floor. Adjustments land in the
metrics registry so operators can see the controller hunting.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Optional

from repro_torch.core.kv_policy import MemoryModel


@dataclasses.dataclass
class Rejected:
    """Typed rejection — the resolve value of a request that was not served."""
    reason: str                 # infeasible | deadline | shed | cancelled |
                                # shutdown | no_instances | error | brownout
    detail: str = ""
    req_id: Optional[int] = None
    user_id: Optional[str] = None
    predicted_wait: float = 0.0
    predicted_jct: float = 0.0


class AdmissionController:
    """Submit-time feasibility gate.

    ``max_input_tokens`` defaults to the MIL of the paper's hybrid-prefill
    technique computed from ``memory_model`` — the same closed form the
    profile run uses to size the prefix-KV budget. ``deadline_slack``
    multiplies the predicted completion time before comparing against the
    deadline: >1 sheds earlier (conservative), <1 gambles on the predictor
    overestimating.

    ``adapt=True`` turns on the shed-rate feedback loop: callers report each
    admitted-with-deadline request's fate via ``record_outcome(shed=...)``;
    when the shed fraction over the last ``adapt_window`` outcomes exceeds
    ``shed_target``, ``deadline_slack`` is multiplied by ``adapt_rate`` (up
    to ``max_slack``), and a full window with zero sheds relaxes it by the
    same factor (down to the configured starting slack). The window resets
    after every adjustment so one burst is not counted twice.
    """

    def __init__(self, max_input_tokens: Optional[int] = None,
                 memory_model: Optional[MemoryModel] = None,
                 chunk: int = 2048, deadline_slack: float = 1.0,
                 adapt: bool = True, adapt_window: int = 64,
                 shed_target: float = 0.05, adapt_rate: float = 1.25,
                 max_slack: float = 4.0, metrics=None,
                 kv_keep: Optional[int] = None):
        if max_input_tokens is None and memory_model is not None:
            # kv_keep: price the engines' layer-wise discard (peak-layer
            # suffix KV + bounded kept slice, see MemoryModel.peak_bytes)
            # instead of the all-layers footprint — the MIL the gate
            # enforces matches what the engines can actually serve
            max_input_tokens = memory_model.max_input_length(
                "hybrid", chunk, kv_keep=kv_keep)
        self.max_input_tokens = max_input_tokens
        self.deadline_slack = deadline_slack
        self.rejected_infeasible = 0
        self.rejected_deadline = 0
        self.adapt = adapt
        self.adapt_window = adapt_window
        self.shed_target = shed_target
        self.adapt_rate = adapt_rate
        self.max_slack = max_slack
        self.min_slack = deadline_slack    # relax floor = configured slack
        self.slack_adjustments = 0
        self.metrics = metrics
        # brownout hook: a multiplier >1 applied ON TOP of deadline_slack,
        # so overload pressure tightens the gate without fighting the
        # shed-rate feedback loop's own slack hunting
        self.pressure = 1.0
        self._outcomes: deque = deque(maxlen=adapt_window)
        self._outcome_lock = threading.Lock()

    def set_pressure(self, pressure: float) -> None:
        """Brownout ladder hook: scale the effective deadline slack by
        ``pressure`` (1.0 = normal). Recorded as a gauge when metrics are
        attached, so operators can tell brownout tightening from the
        feedback loop's own adjustments."""
        self.pressure = max(1.0, float(pressure))
        if self.metrics is not None:
            self.metrics.gauge("admission_pressure").set(self.pressure)

    def shed_rate(self) -> float:
        """Shed fraction over the current outcome window (0.0 when empty) —
        one of the brownout controller's escalation signals."""
        with self._outcome_lock:
            if not self._outcomes:
                return 0.0
            return sum(self._outcomes) / len(self._outcomes)

    # ---- shed-rate feedback ----------------------------------------------
    def record_outcome(self, shed: bool) -> None:
        """Report the fate of one admitted-with-deadline request: served
        (``shed=False``) or shed in-queue after admission (``shed=True`` —
        the admission prediction under-estimated). Thread-safe: every
        serving worker reports here."""
        if not self.adapt:
            return
        with self._outcome_lock:
            self._outcomes.append(bool(shed))
            if len(self._outcomes) < self.adapt_window:
                return
            rate = sum(self._outcomes) / len(self._outcomes)
            if rate > self.shed_target and self.deadline_slack < self.max_slack:
                self.deadline_slack = min(
                    self.max_slack, self.deadline_slack * self.adapt_rate)
                self._note_adjustment("admission_slack_tightened")
            elif rate == 0.0 and self.deadline_slack > self.min_slack:
                self.deadline_slack = max(
                    self.min_slack, self.deadline_slack / self.adapt_rate)
                self._note_adjustment("admission_slack_relaxed")

    def _note_adjustment(self, counter: str) -> None:
        self.slack_adjustments += 1
        self._outcomes.clear()     # don't react to the same burst twice
        if self.metrics is not None:
            self.metrics.counter(counter).inc()
            self.metrics.gauge("admission_deadline_slack").set(
                self.deadline_slack)

    def check(self, n_input: int, deadline: Optional[float], now: float,
              predicted_wait: float, predicted_jct: float,
              user_id: Optional[str] = None) -> Optional[Rejected]:
        """None = admit; a ``Rejected`` explains why not."""
        if (self.max_input_tokens is not None
                and n_input > self.max_input_tokens):
            self.rejected_infeasible += 1
            return Rejected(
                "infeasible",
                f"n_input={n_input} exceeds MIL={self.max_input_tokens}",
                user_id=user_id, predicted_jct=predicted_jct)
        if deadline is not None:
            eta = now + (self.deadline_slack * self.pressure
                         * (predicted_wait + predicted_jct))
            if eta > deadline:
                self.rejected_deadline += 1
                return Rejected(
                    "deadline",
                    f"predicted finish {eta - now:.3f}s out, deadline in "
                    f"{deadline - now:.3f}s",
                    user_id=user_id, predicted_wait=predicted_wait,
                    predicted_jct=predicted_jct)
        return None


class BrownoutController:
    """Graceful-degradation ladder: overload trades quality for survival.

    Levels (typed, exported as the ``brownout_level`` gauge):

      0  normal    everything on
      1  tighten   admission deadline slack scaled by ``slack_factor`` —
                   doomed-looking work is rejected earlier, the queue stops
                   growing at the tail
      2  degrade   hit co-packing's expensive gather paths disabled on every
                   engine (``engine.set_degraded``) — cache hits run the
                   cheap solo-suffix path, misses still co-pack; per-step
                   cost variance collapses, shedding compute for latency
                   headroom
      3  shed      new work rejected at the door (``Rejected("brownout")``)
                   — existing backlog drains, the pool never collapses

    Signals: the pool's worst per-instance backlog in predicted-JCT seconds
    (trustworthy *because* prefill-only JCT is predictable) and the
    admission controller's shed rate (fraction of admitted-with-deadline
    requests later shed in-queue — admission under-estimating means the
    door is effectively open too wide). The shed rate maps onto the backlog
    axis via ``shed_to_seconds`` and the max of both drives the ladder.

    Hysteresis: escalation is immediate (overload hurts NOW); de-escalation
    requires the signal below the level's *exit* threshold (strictly less
    than its enter threshold) for ``hold`` consecutive evaluations, so the
    ladder doesn't flap across a noisy boundary.
    """

    LEVELS = ("normal", "tighten", "degrade", "shed")

    def __init__(self, enter=(2.0, 6.0, 12.0), exit=(1.0, 3.0, 6.0),
                 hold: int = 3, slack_factor: float = 1.5,
                 shed_to_seconds: float = 20.0):
        assert len(enter) == len(exit) == len(self.LEVELS) - 1
        assert all(x < e for x, e in zip(exit, enter)), \
            "exit thresholds must sit strictly below enter thresholds"
        self.enter = tuple(enter)
        self.exit = tuple(exit)
        self.hold = hold
        self.slack_factor = slack_factor
        self.shed_to_seconds = shed_to_seconds
        self.level = 0
        self.escalations = 0
        self.deescalations = 0
        self._calm = 0          # consecutive below-exit evaluations
        self._lock = threading.Lock()

    def signal(self, backlog_seconds: float, shed_rate: float) -> float:
        return max(backlog_seconds, shed_rate * self.shed_to_seconds)

    def evaluate(self, backlog_seconds: float,
                 shed_rate: float = 0.0) -> int:
        """Feed one observation; returns the (possibly new) level."""
        s = self.signal(backlog_seconds, shed_rate)
        with self._lock:
            target = 0
            for i, e in enumerate(self.enter):
                if s >= e:
                    target = i + 1
            if target > self.level:
                self.level = target
                self.escalations += 1
                self._calm = 0
            elif self.level > 0 and s < self.exit[self.level - 1]:
                self._calm += 1
                if self._calm >= self.hold:
                    self.level -= 1
                    self.deescalations += 1
                    self._calm = 0
            else:
                self._calm = 0
            return self.level

    def pressure(self) -> float:
        """Admission slack multiplier for the current level."""
        return self.slack_factor if self.level >= 1 else 1.0

    def state(self) -> str:
        return self.LEVELS[self.level]
