"""Request scheduling — paper §6, Algorithm 1 (copy of
``repro.core.scheduler``).

Policies:
  fifo             first-come-first-serve (PagedAttention baseline)
  srjf             shortest-remaining-job-first with JCT frozen at ARRIVAL
                   (the "traditional JCT-based scheduling" of §6.2)
  srjf_calibrated  PrefillOnly: JCT re-computed against the CURRENT prefix
                   cache before every scheduling decision, minus the
                   starvation offset λ·T_queue  (Algorithm 1)

PrefillOnly's baseline executes ONE request per step (§6.1: prefill is
compute-bound; naive batching adds latency without throughput). The engine's
prepacked path refines this: ``pick`` still chooses the single next request
by Algorithm 1 — preserving SRJF-calibrated order — and the engine then
*backfills* the chosen request's padding slack with further cache-miss
requests (segment-restricted attention keeps them independent), which adds
throughput without the latency cost §6.1 warns about because the packed
batch finishes in the same bucketed forward the anchor alone would have
paid for.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

_req_counter = itertools.count()


@dataclasses.dataclass
class Request:
    n_input: int
    arrival: float
    chain: Tuple[int, ...] = ()            # precomputed prefix hash chain
    tokens: Optional[Sequence[int]] = None  # real engine only
    req_id: int = dataclasses.field(default_factory=lambda: next(_req_counter))
    user_id: Optional[str] = None
    allowed_tokens: Optional[Tuple[int, ...]] = None   # e.g. (yes_id, no_id)
    deadline: Optional[float] = None       # absolute; None = best-effort
    # bookkeeping filled by the engine/simulator:
    n_cached_at_arrival: int = 0
    start_time: float = -1.0
    finish_time: float = -1.0
    n_cached_at_start: int = 0

    @property
    def latency(self) -> float:
        return self.finish_time - self.arrival


class Scheduler:
    def __init__(self, policy: str, jct_model, lam: float = 0.0,
                 usable_prefix=None):
        """``lam`` (λ) is the paper's fairness knob in JCT-seconds per second
        of queueing (paper default 500 — their jct unit is ms; ours is s, the
        ratio is what matters).

        ``usable_prefix(n_input, matched_blocks) -> tokens`` optionally maps
        a raw cache match onto the prefix a forward would actually REUSE
        (the engine's reuse-granularity bucketing, never the whole request)
        so Algorithm-1 scores price requests the same way execution and the
        shedding/routing probes do. ``None`` falls back to the raw match
        (simulator / standalone use)."""
        assert policy in ("fifo", "srjf", "srjf_calibrated"), policy
        self.policy = policy
        self.jct_model = jct_model
        self.lam = lam
        self.usable_prefix = usable_prefix

    def score(self, r: Request, cache, now: float) -> float:
        """Algorithm 1 priority of one request (lower runs sooner)."""
        if self.policy == "srjf":
            return self.jct_model.predict(r.n_input, r.n_cached_at_arrival)
        # side-effect-free probes: scoring walks every queued request each
        # step, and on the tiered cache a match_* call would eagerly restore
        # host blocks — probe_blocks prices the restorable tier read-only
        if cache is None:
            n_cached = 0
        elif self.usable_prefix is not None:
            n_cached = self.usable_prefix(
                r.n_input, cache.probe_blocks(r.chain)
                if hasattr(cache, "probe_blocks")
                else cache.match_blocks(r.chain))
        else:
            n_cached = (cache.probe_len(r.chain)
                        if hasattr(cache, "probe_len")
                        else cache.match_len(r.chain))
        jct = self.jct_model.predict(r.n_input, n_cached)
        return jct - self.lam * (now - r.arrival)

    def pick(self, queue: List[Request], cache, now: float) -> Optional[int]:
        """Returns the index into ``queue`` of the request to run next.

        srjf_calibrated implements Algorithm 1: for each waiting request
        recompute n_cached against the *current* cache (continuous JCT
        calibration), score = jct(n_input, n_cached) − λ·T_queue, run argmin.
        """
        if not queue:
            return None
        if self.policy == "fifo":
            return min(range(len(queue)), key=lambda i: (queue[i].arrival,
                                                         queue[i].req_id))
        best_i, best_score = None, None
        for i, r in enumerate(queue):
            key = (self.score(r, cache, now), r.arrival, r.req_id)
            if best_score is None or key < best_score:   # deterministic ties
                best_score, best_i = key, i
        return best_i

    def pick_backfill(self, cands: Sequence[Tuple[Request, int]],
                      benefit) -> Optional[int]:
        """Returns the index into ``cands`` of the best backfill admit.

        ``cands`` is the engine's (request, usable_prefix) candidate list;
        ``benefit(request, prefix) -> Optional[float]`` prices one candidate:
        None marks it hard-ineligible this round (budget/sharer/brownout
        gates), otherwise the co-packing benefit ``solo_cost − marginal_cost``
        in JCT-seconds. The pick is the eligible candidate with the largest
        benefit (ties broken by arrival then req_id — FIFO among equals), or
        None when no candidate is eligible. Callers admit the pick only when
        its benefit is non-negative; a negative best benefit means every
        remaining candidate's padding externality exceeds its co-packing
        gain, i.e. the pack should close (skew split).
        """
        best_i, best_key = None, None
        for i, (r, pref) in enumerate(cands):
            gain = benefit(r, pref)
            if gain is None:
                continue
            key = (-gain, r.arrival, r.req_id)
            if best_key is None or key < best_key:
                best_key, best_i = key, i
        return best_i
