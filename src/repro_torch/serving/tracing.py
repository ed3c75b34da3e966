"""Per-step records and JCT-calibration monitoring (copy of
``repro.serving.tracing``'s ``BatchRecord`` and ``JCTCalibrationMonitor``;
the span tracer and Prometheus export come with the serving-plane slice).

Clock discipline: everything is ``time.perf_counter`` (monotonic), the same
clock the engine stamps ``Request.arrival``/``start_time`` with.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Dict, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class BatchRecord:
    """Composition + cost of ONE engine step (solo or packed)."""
    step: int                    # engine step index
    ts: float                    # step end, perf_counter seconds
    instance: str = ""
    kind: str = "solo"           # solo | miss | hit (pack class)
    n_requests: int = 1
    req_ids: Tuple[int, ...] = ()
    computed_tokens: int = 0     # miss/suffix tokens actually computed
    padded_tokens: int = 0       # forward slots paid (incl. padding/prefix)
    S: int = 0                   # packed/bucketed sequence length
    Nb: int = 0                  # padded batch rows (packed-hit path)
    smax: int = 0                # per-segment suffix pad (packed-hit path)
    pmax: int = 0                # per-segment prefix pad
    K: int = 0                   # gathered fresh-KV length
    jit_path: str = ""           # forward path: fresh | suffix
    jit_key: Tuple = ()
    compiled: bool = False       # first use of this shape key (the port's
                                 # counterpart of a jit compile: kernel build)
    predicted_jct: float = 0.0   # model prediction made BEFORE execution
    wall: float = 0.0            # measured forward wall time

    @property
    def padding_waste(self) -> float:
        """Fraction of paid forward slots that were padding slack."""
        if self.padded_tokens <= 0:
            return 0.0
        return 1.0 - min(1.0, self.computed_tokens / self.padded_tokens)


class JCTCalibrationMonitor:
    """Online accuracy tracking for the JCT predictor.

    The engine reports every WARM (non-compile) step as ``observe(predicted,
    actual, tokens)``. The monitor keeps signed residuals per bucket class
    (the same suffix-bucket ladder the engine's shape keys use, so a misfit shows
    *which* shapes mispredict) and runs a drift detector: when the mean relative error over the recent window
    degrades past ``drift_threshold``, the predictor is refit immediately
    from its own sliding sample window (instead of waiting out
    ``refit_every``) and the forced refit is counted — mispredictions are
    corrected within a handful of steps instead of silently steering
    routing/admission/watchdog decisions. (The Prometheus export of the
    reference comes with the serving-plane slice.)
    """

    def __init__(self, model, buckets: Sequence[int] = (),
                 window: int = 32, per_bucket: int = 128,
                 drift_threshold: float = 0.5, drift_min: int = 8,
                 cooldown: int = 16, shape_model=None):
        self.model = model
        # optional PackedShapeJCT riding along: its residuals are tracked
        # per PACK CLASS (solo/miss/hit — the three step layouts it prices)
        # and a drift event refits it from its own shape-sample window too
        self.shape_model = shape_model
        self.buckets = tuple(sorted(buckets))
        self.window = window
        self.drift_threshold = drift_threshold
        self.drift_min = drift_min
        self.cooldown = cooldown
        self.drift_refits = 0
        self.observed = 0
        self._recent_rel: deque = deque(maxlen=window)
        self._by_bucket: Dict[int, deque] = {}
        self._by_class: Dict[str, deque] = {}
        self._per_bucket = per_bucket
        self._since_refit = 0
        self._lock = threading.Lock()

    def _bucket(self, tokens: int) -> int:
        for s in self.buckets:
            if tokens <= s:
                return s
        return self.buckets[-1] if self.buckets else tokens

    def observe(self, predicted: float, actual: float, tokens: int,
                kind: str = None) -> None:
        resid = actual - predicted
        rel = abs(resid) / max(abs(actual), 1e-9)
        bucket = self._bucket(tokens)
        drifted = False
        with self._lock:
            self.observed += 1
            dq = self._by_bucket.get(bucket)
            if dq is None:
                dq = self._by_bucket[bucket] = deque(maxlen=self._per_bucket)
            dq.append(resid)
            if kind is not None:
                cq = self._by_class.get(kind)
                if cq is None:
                    cq = self._by_class[kind] = deque(
                        maxlen=self._per_bucket)
                cq.append(resid)
            self._recent_rel.append(rel)
            self._since_refit += 1
            if (len(self._recent_rel) >= self.drift_min
                    and self._since_refit >= self.cooldown
                    and (sum(self._recent_rel) / len(self._recent_rel)
                         > self.drift_threshold)):
                drifted = True
                self.drift_refits += 1
                self._recent_rel.clear()
                self._since_refit = 0
        if drifted:
            # refit OUTSIDE the monitor lock (the model has its own state;
            # lstsq over <=256 samples is microseconds)
            recent = getattr(self.model, "_recent", None)
            if recent and len(recent) >= 4:
                self.model.fit(list(recent))
            if self.shape_model is not None:
                self.shape_model.refit_recent()

    def summary(self) -> Dict:
        """Coefficients, residual percentiles, refit counts — the JCT-fit
        block surfaced through ``engine.stats()``."""
        with self._lock:
            all_resid = [r for dq in self._by_bucket.values() for r in dq]
            by_bucket = {
                b: {"count": len(dq),
                    "mean_abs": float(np.mean(np.abs(dq))) if dq else 0.0,
                    "p95_abs": float(np.percentile(np.abs(list(dq)), 95))
                    if dq else 0.0}
                for b, dq in sorted(self._by_bucket.items())}
            by_class = {
                k: {"count": len(dq),
                    "mean_abs": float(np.mean(np.abs(dq))) if dq else 0.0,
                    "p95_abs": float(np.percentile(np.abs(list(dq)), 95))
                    if dq else 0.0}
                for k, dq in sorted(self._by_class.items())}
            drift = self.drift_refits
            observed = self.observed
        absr = np.abs(all_resid) if all_resid else None
        model = self.model
        out = {
            "a": float(getattr(model, "a", 0.0)),
            "b": float(getattr(model, "b", 0.0)),
            "pearson_r": float(getattr(model, "pearson_r", 0.0)),
            "observed": observed,
            "refits": int(getattr(model, "fits", 0)),
            "clamped_fits": int(getattr(model, "clamped_fits", 0)),
            "drift_refits": drift,
            "residual_p50": float(np.percentile(absr, 50))
            if absr is not None else 0.0,
            "residual_p95": float(np.percentile(absr, 95))
            if absr is not None else 0.0,
            "by_bucket": by_bucket,
            "by_class": by_class,
        }
        if self.shape_model is not None:
            sm = self.shape_model
            out["shape"] = {"coef": sm.coefficients(),
                            "pearson_r": float(sm.pearson_r),
                            "refits": int(sm.fits),
                            "fitted": bool(sm.fitted)}
        return out
