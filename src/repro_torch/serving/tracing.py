"""Request-lifecycle tracing + JCT-calibration observability plane (copy of
``repro.serving.tracing``).

Every load-bearing decision in this engine — SRJF routing, admission
feasibility, watchdog deadlines, brownout escalation — is derived from the
JCT predictor, yet until this module nothing measured how accurate those
predictions actually were, and no per-request record explained *where* a
slow request spent its time (queue vs batch-formation vs first use vs
compute vs retry). Three pieces close that gap:

  ``SpanTracer``
      a thread-safe, bounded (ring-buffer), monotonic-clock span tracer.
      One ``_Trace`` per request records the full timeline: submit ->
      admission verdict -> route decision (with probe values) -> queue
      dwell -> batch formation (pack kind solo/miss/hit, co-packed peers)
      -> first use of a shape key (flagged separately) -> execute -> score ->
      deliver/retry/shed/quarantine. The serving layer propagates trace
      context through the retry/watchdog/brownout paths, so trips,
      re-homes, tombstone drops and brownout transitions land as events on
      the affected requests' timelines. Finished traces live in a fixed
      ring (old ones fall off), so tracing is always-on-cheap: no
      allocation growth, one small lock, optional sampling.

  ``BatchRecord``
      per-engine-step pack composition: S/N/smax/pmax/K, padding-waste
      fraction, shape key + first use or replay, predicted JCT vs measured wall
      time — the hidden variables behind prefill throughput (Prepacking,
      arXiv 2404.09529) made observable per batch.

  ``JCTCalibrationMonitor``
      online residual tracking of the JCT predictor per bucket class, with
      error histograms and predictor coefficients exported as Prometheus
      gauges, plus a drift detector that forces a refit when the recent
      relative error degrades — closing the loop on the paper's core
      premise that prefill-only JCT is precisely predictable.

Exports: ``dump_jsonl`` (the ``--trace-dump`` endpoint payload, one JSON
object per line, request and batch records), ``chrome_trace`` (a
Chrome-trace/Perfetto-loadable JSON object), and Prometheus series through
the bound ``MetricsRegistry``.

Clock discipline: everything is ``time.perf_counter`` (monotonic), the same
clock the engine stamps ``Request.arrival``/``start_time`` with, so spans
computed across layers never go negative on wall-clock adjustment.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple


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
    jit_path: str = ""           # fresh | suffix | packed_miss | packed_hit
    jit_key: Tuple = ()
    compiled: bool = False       # first use of this shape key (warm-up and
                                 # capture of its CUDA graph)
    predicted_jct: float = 0.0   # model prediction made BEFORE execution
    wall: float = 0.0            # measured forward wall time

    @property
    def padding_waste(self) -> float:
        """Fraction of paid forward slots that were padding slack."""
        if self.padded_tokens <= 0:
            return 0.0
        return 1.0 - min(1.0, self.computed_tokens / self.padded_tokens)

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["type"] = "batch"
        d["req_ids"] = list(self.req_ids)
        d["jit_key"] = list(self.jit_key)
        d["padding_waste"] = self.padding_waste
        return d


class _Trace:
    """One request's timeline. Mutated only under the owning tracer's lock."""

    __slots__ = ("tid", "rids", "user_id", "n_input", "t0", "t1", "outcome",
                 "events", "spans", "attrs")

    def __init__(self, tid: int, t0: float, user_id, n_input, attrs):
        self.tid = tid
        self.rids: List[int] = []      # engine req_ids, attempt order
        self.user_id = user_id
        self.n_input = n_input
        self.t0 = t0
        self.t1: Optional[float] = None
        self.outcome: Optional[str] = None
        self.events: List[Tuple[float, str, Dict]] = [(t0, "submit", attrs)]
        self.spans: List[Tuple[str, float, float, Dict]] = []

    def to_dict(self) -> Dict:
        return {
            "type": "request",
            "trace_id": self.tid,
            "req_id": self.rids[0] if self.rids else None,
            "rids": list(self.rids),
            "user_id": self.user_id,
            "n_input": self.n_input,
            "t0": self.t0,
            "t1": self.t1,
            "outcome": self.outcome,
            "attempts": max(1, len(self.rids)),
            "events": [{"t": t, "name": n, **a} for t, n, a in self.events],
            "spans": [{"name": n, "t0": a, "t1": b, "dur": b - a, **at}
                      for n, a, b, at in sorted(
                          self.spans, key=lambda s: (s[1], -s[2]))],
        }


class SpanTracer:
    """Bounded, thread-safe request-lifecycle tracer.

    * ``begin()`` opens a trace (optionally pre-bound to an engine req_id)
      and returns a context id; ``bind(ctx, rid)`` attaches the engine's
      req_id once the enqueue assigned one, so layers that only know the
      rid (engine, watchdog, retry) can annotate the same timeline.
    * ``rebind(old_rid, new_rid)`` moves a retried request's trace onto its
      replacement req_id while KEEPING the old mapping — a late result from
      the confiscated attempt then lands on the same timeline (as the
      tombstone-drop event) instead of vanishing.
    * events emitted against a rid the tracer has not seen yet (the worker
      can execute a request before ``submit`` finishes binding it) are held
      in a small bounded orphan buffer and merged at bind time — never
      silently lost, never unbounded.
    * finished traces move to a ring (``capacity``); ``sample`` < 1.0
      drops a deterministic fraction of traces at ``begin`` (every call
      still returns instantly — unsampled contexts are no-ops throughout).

    All public methods are safe to call from any thread and are cheap
    no-ops when the request is unsampled/unknown.
    """

    _NOSAMPLE = -1

    def __init__(self, capacity: int = 2048, sample: float = 1.0,
                 batch_capacity: int = 2048, orphan_capacity: int = 512):
        assert capacity > 0 and 0.0 < sample <= 1.0
        self.capacity = capacity
        self.sample = sample
        self.epoch = time.perf_counter()   # chrome-trace time origin
        self._lock = threading.Lock()
        self._next = 0                     # trace-id counter
        self._seq = 0                      # sampling counter
        self._period = max(1, round(1.0 / sample))
        self._active: Dict[int, _Trace] = {}
        self._by_rid: Dict[int, _Trace] = {}
        self._done: deque = deque(maxlen=capacity)
        self._batches: deque = deque(maxlen=batch_capacity)
        self._orphans: "deque[Tuple[int, float, str, Dict]]" = deque(
            maxlen=orphan_capacity)
        self.begun = 0
        self.finished = 0
        self.sampled_out = 0

    # ---- lifecycle -------------------------------------------------------
    def begin(self, rid: Optional[int] = None, user_id: Optional[str] = None,
              n_input: Optional[int] = None, **attrs) -> int:
        """Open a trace; returns a context id (or a no-op sentinel when the
        trace was sampled out). ``rid`` pre-binds an engine req_id."""
        now = time.perf_counter()
        with self._lock:
            self._seq += 1
            if self.sample < 1.0 and (self._seq % self._period):
                self.sampled_out += 1
                return self._NOSAMPLE
            tid = self._next
            self._next += 1
            tr = _Trace(tid, now, user_id, n_input, attrs)
            self._active[tid] = tr
            self.begun += 1
            if rid is not None:
                self._bind_locked(tr, rid)
            return tid

    def bind(self, ctx: int, rid: int) -> None:
        """Attach engine req_id ``rid`` to trace ``ctx``; merges any events
        the engine emitted against ``rid`` before the bind landed."""
        if ctx == self._NOSAMPLE:
            return
        with self._lock:
            tr = self._active.get(ctx)
            if tr is not None:
                self._bind_locked(tr, rid)

    def _bind_locked(self, tr: _Trace, rid: int) -> None:
        tr.rids.append(rid)
        self._by_rid[rid] = tr
        if self._orphans:
            kept = deque(maxlen=self._orphans.maxlen)
            for orid, t, name, attrs in self._orphans:
                if orid == rid:
                    if name.startswith("span:"):
                        tr.spans.append((name[5:], attrs.pop("_t0", t), t,
                                         attrs))
                    else:
                        tr.events.append((t, name, attrs))
                else:
                    kept.append((orid, t, name, attrs))
            self._orphans = kept

    def rebind(self, old_rid: int, new_rid: int) -> None:
        """Retry re-key: the replacement ``new_rid`` joins ``old_rid``'s
        timeline. The old mapping survives so the confiscated attempt's
        late events still attach to the same trace."""
        with self._lock:
            tr = self._by_rid.get(old_rid)
            if tr is not None:
                tr.rids.append(new_rid)
                self._by_rid[new_rid] = tr

    def finish(self, ctx: int, outcome: str, **attrs) -> None:
        if ctx == self._NOSAMPLE:
            return
        with self._lock:
            tr = self._active.pop(ctx, None)
            if tr is not None:
                self._finish_locked(tr, outcome, attrs)

    def finish_rid(self, rid: int, outcome: str, **attrs) -> None:
        with self._lock:
            tr = self._by_rid.get(rid)
            if tr is not None and self._active.pop(tr.tid, None) is not None:
                self._finish_locked(tr, outcome, attrs)

    def _finish_locked(self, tr: _Trace, outcome: str, attrs: Dict) -> None:
        now = time.perf_counter()
        tr.t1 = now
        tr.outcome = outcome
        tr.events.append((now, "finish", {"outcome": outcome, **attrs}))
        for rid in tr.rids:
            self._by_rid.pop(rid, None)
        self._done.append(tr)
        self.finished += 1

    # ---- annotation ------------------------------------------------------
    def event(self, ctx: int, name: str, **attrs) -> None:
        if ctx == self._NOSAMPLE:
            return
        now = time.perf_counter()
        with self._lock:
            tr = self._active.get(ctx)
            if tr is not None:
                tr.events.append((now, name, attrs))

    def event_rid(self, rid: int, name: str, **attrs) -> None:
        now = time.perf_counter()
        with self._lock:
            tr = self._by_rid.get(rid)
            if tr is not None:
                tr.events.append((now, name, attrs))
            else:
                self._orphans.append((rid, now, name, attrs))

    def postmortem_rid(self, rid: int, name: str, **attrs) -> None:
        """Attach a post-mortem event to the trace that owned ``rid`` even
        after it finished (e.g. a confiscated attempt's late result being
        tombstone-dropped minutes after the replacement delivered). Scans
        the bounded done-ring when the live mapping is gone; falls back to
        the orphan buffer once the trace has fallen off the ring."""
        now = time.perf_counter()
        with self._lock:
            tr = self._by_rid.get(rid)
            if tr is None:
                tr = next((t for t in reversed(self._done)
                           if rid in t.rids), None)
            if tr is not None:
                tr.events.append((now, name, attrs))
            else:
                self._orphans.append((rid, now, name, attrs))

    def span_rid(self, rid: int, name: str, t0: float, t1: float,
                 **attrs) -> None:
        """Record a completed [t0, t1] phase (perf_counter seconds)."""
        with self._lock:
            tr = self._by_rid.get(rid)
            if tr is not None:
                tr.spans.append((name, t0, t1, attrs))
            else:
                attrs["_t0"] = t0
                self._orphans.append((rid, t1, "span:" + name, attrs))

    def broadcast(self, name: str, **attrs) -> None:
        """Attach an event to EVERY active trace (rare transitions only —
        e.g. brownout level changes affect all in-flight requests)."""
        now = time.perf_counter()
        with self._lock:
            for tr in self._active.values():
                tr.events.append((now, name, dict(attrs)))

    def record_batch(self, record: BatchRecord) -> None:
        with self._lock:
            self._batches.append(record)

    # ---- cross-process bridging ------------------------------------------
    def drain_orphans(self) -> List[Tuple[int, float, str, Dict]]:
        """Drain the orphan buffer: ``(rid, t, name, attrs)`` rows, spans
        encoded as ``span:<name>`` with ``attrs['_t0']``. A worker-side
        tracer (no request ever binds, so EVERY engine emission lands here)
        uses this as its export queue — the frontend replays the rows onto
        the real request timelines after mapping the worker clock."""
        with self._lock:
            rows = list(self._orphans)
            self._orphans.clear()
        return rows

    def drain_batches(self) -> List[BatchRecord]:
        """Drain the batch-record ring (worker-side export queue)."""
        with self._lock:
            rows = list(self._batches)
            self._batches.clear()
        return rows

    def ingest_event(self, rid: int, t: float, name: str, **attrs) -> None:
        """``event_rid`` with a caller-supplied timestamp — replaying a
        remote worker's event at its (clock-mapped) original time instead
        of the replay time."""
        with self._lock:
            tr = self._by_rid.get(rid)
            if tr is not None:
                tr.events.append((t, name, attrs))
            else:
                self._orphans.append((rid, t, name, attrs))

    def ingest_span(self, rid: int, name: str, t0: float, t1: float,
                    **attrs) -> None:
        """Like ``span_rid`` but for REMOTE spans whose times crossed a
        clock mapping: clamps the span into the trace's own window so a
        worker/frontend clock-offset estimate off by a transit time can
        never produce a span that starts before its request's submit (which
        would break Perfetto containment)."""
        with self._lock:
            tr = self._by_rid.get(rid)
            if tr is None:
                attrs["_t0"] = t0
                self._orphans.append((rid, t1, "span:" + name, attrs))
                return
            t0 = max(t0, tr.t0)
            tr.spans.append((name, t0, max(t1, t0), attrs))

    # ---- export ----------------------------------------------------------
    def snapshot(self, include_active: bool = False) -> List[Dict]:
        with self._lock:
            out = [tr.to_dict() for tr in self._done]
            if include_active:
                out.extend(tr.to_dict() for tr in self._active.values())
        return out

    def batch_snapshot(self) -> List[Dict]:
        with self._lock:
            return [b.to_dict() for b in self._batches]

    def dump_jsonl(self, include_batches: bool = True,
                   include_active: bool = False) -> str:
        """One JSON object per line: request records, then batch records."""
        rows = self.snapshot(include_active=include_active)
        if include_batches:
            rows.extend(self.batch_snapshot())
        return "\n".join(json.dumps(r, sort_keys=True) for r in rows) + (
            "\n" if rows else "")

    def chrome_trace(self, include_active: bool = False) -> Dict:
        """Chrome-trace (Perfetto-loadable) JSON object.

        pid = serving instance (named via metadata events), tid = trace id.
        Each request contributes one umbrella "request" X-span covering
        submit->finish, nested phase X-spans (queue/execute/score, properly
        contained), and "i" instant events for everything else (retry,
        watchdog_trip, brownout, ...). Batch records land on a dedicated
        "engine-steps" thread per instance so pack composition lines up
        against the requests it served.
        """
        us = 1e6
        pids: Dict[str, int] = {}
        events: List[Dict] = []

        def pid_of(instance: str) -> int:
            if instance not in pids:
                pids[instance] = len(pids) + 1
                events.append({"ph": "M", "name": "process_name",
                               "pid": pids[instance], "tid": 0,
                               "args": {"name": instance or "pool"}})
            return pids[instance]

        def ts(t: float) -> float:
            return max(0.0, (t - self.epoch) * us)

        with self._lock:
            traces = [tr.to_dict() for tr in self._done]
            if include_active:
                traces.extend(tr.to_dict() for tr in self._active.values())
            batches = [b.to_dict() for b in self._batches]
        for tr in traces:
            inst = next((s.get("instance") for s in tr["spans"]
                         if s.get("instance")), "") or next(
                (e.get("instance") for e in tr["events"]
                 if e.get("instance")), "")
            pid = pid_of(inst or "pool")
            tid = tr["trace_id"]
            t1 = tr["t1"] if tr["t1"] is not None else max(
                [tr["t0"]] + [s["t1"] for s in tr["spans"]]
                + [e["t"] for e in tr["events"]])
            events.append({
                "ph": "X", "name": f"request {tr['outcome'] or 'open'}",
                "pid": pid, "tid": tid, "ts": ts(tr["t0"]),
                "dur": max(1.0, (t1 - tr["t0"]) * us),
                "args": {"req_id": tr["req_id"], "user_id": tr["user_id"],
                         "n_input": tr["n_input"],
                         "attempts": tr["attempts"]}})
            for s in tr["spans"]:
                args = {k: v for k, v in s.items()
                        if k not in ("name", "t0", "t1", "dur")}
                events.append({"ph": "X", "name": s["name"], "pid": pid,
                               "tid": tid, "ts": ts(s["t0"]),
                               "dur": max(1.0, s["dur"] * us),
                               "args": args})
            for e in tr["events"]:
                args = {k: v for k, v in e.items() if k not in ("name", "t")}
                events.append({"ph": "i", "s": "t", "name": e["name"],
                               "pid": pid, "tid": tid, "ts": ts(e["t"]),
                               "args": args})
        for inst in sorted({b["instance"] for b in batches}):
            pid = pid_of(inst or "pool")
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": 0, "args": {"name": "engine-steps"}})
        for b in batches:
            pid = pid_of(b["instance"] or "pool")
            events.append({
                "ph": "X", "name": f"step {b['kind']}", "pid": pid,
                "tid": 0, "ts": ts(b["ts"] - b["wall"]),
                "dur": max(1.0, b["wall"] * us),
                "args": {k: b[k] for k in
                         ("step", "n_requests", "req_ids", "computed_tokens",
                          "padded_tokens", "padding_waste", "S", "Nb",
                          "smax", "pmax", "K", "jit_path", "jit_key",
                          "compiled", "predicted_jct", "wall")}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def stats(self) -> Dict:
        with self._lock:
            return {"begun": self.begun, "finished": self.finished,
                    "active": len(self._active),
                    "retained": len(self._done),
                    "batches": len(self._batches),
                    "sampled_out": self.sampled_out,
                    "orphaned": len(self._orphans)}


class JCTCalibrationMonitor:
    """Online accuracy tracking for the JCT predictor.

    The engine reports every WARM (non-compile) step as ``observe(predicted,
    actual, tokens)``. The monitor keeps signed residuals per bucket class
    (the same suffix-bucket ladder the engine's shape keys use, so a misfit shows
    *which* shapes mispredict), exports error histograms and the fitted
    coefficients as Prometheus series when a registry is bound, and runs a
    drift detector: when the mean relative error over the recent window
    degrades past ``drift_threshold``, the predictor is refit immediately
    from its own sliding sample window (instead of waiting out
    ``refit_every``) and the forced refit is counted — mispredictions are
    corrected within a handful of steps instead of silently steering
    routing/admission/watchdog decisions.
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
        self._metrics = None
        self._instance = ""

    def bind(self, metrics, instance: str = "") -> None:
        """Attach a MetricsRegistry; coefficient gauges are exported
        immediately (a scrape before the first warm step still sees the
        fit) and refreshed on every observation."""
        self._metrics = metrics
        self._instance = instance
        if metrics is not None:
            self._export_coefficients()

    def _bucket(self, tokens: int) -> int:
        for s in self.buckets:
            if tokens <= s:
                return s
        return self.buckets[-1] if self.buckets else tokens

    def _export_coefficients(self) -> None:
        m, inst = self._metrics, self._instance
        model = self.model
        m.gauge("jct_coef_a", inst).set(getattr(model, "a", 0.0))
        m.gauge("jct_coef_b", inst).set(getattr(model, "b", 0.0))
        m.gauge("jct_pearson_r", inst).set(getattr(model, "pearson_r", 0.0))
        m.gauge("jct_refits", inst).set(
            getattr(model, "fits", 0) + self.drift_refits)
        m.gauge("jct_fit_clamped", inst).set(
            getattr(model, "clamped_fits", 0))
        sm = self.shape_model
        if sm is not None:
            for name, c in sm.coefficients().items():
                m.gauge(f"jct_shape_{name}", inst).set(c)
            m.gauge("jct_shape_pearson_r", inst).set(sm.pearson_r)
            m.gauge("jct_shape_refits", inst).set(sm.fits)

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
        m = self._metrics
        if m is not None:
            inst = self._instance
            m.histogram("jct_residual_seconds", inst).observe(abs(resid))
            m.histogram("jct_relative_error", inst).observe(rel)
            if kind is not None:
                m.histogram(f"jct_residual_{kind}_seconds", inst).observe(
                    abs(resid))
            if drifted:
                m.counter("jct_drift_refits", inst).inc()
            self._export_coefficients()

    def summary(self) -> Dict:
        """Coefficients, residual percentiles, refit counts — the JCT-fit
        block surfaced through ``engine.stats()`` and serve results."""
        import numpy as np
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
