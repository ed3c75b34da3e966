"""Serving telemetry: counters, gauges, fixed-bucket latency histograms
(copy of ``repro.serving.metrics``).

Metrics carry one optional ``instance`` label so the registry can report both
per-instance and globally aggregated views (global = sum of counters, merge
of histogram buckets — exact, since every histogram of a given name shares
one fixed bucket table). Percentiles come from linear interpolation inside
the bucket that crosses the target rank, clamped to the observed min/max so
tiny samples don't report a bucket edge nobody hit.

Everything is thread-safe: the serving worker threads, the submitting
thread(s), and a stats reader may all touch the registry concurrently.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

# 1e-4s .. ~178s upper bounds, geometric x ~1.78 (10^(1/4)) — 26 buckets
# + overflow. Wide enough for CPU-scale JCTs and the card's latencies alike.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    1e-4 * 10 ** (i / 4) for i in range(26))


class Counter:
    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    def load(self, v: float) -> None:
        """Overwrite with an authoritative remote value (telemetry merge —
        the worker process owns the truth for its own series)."""
        with self._lock:
            self._v = float(v)

    @property
    def value(self) -> float:
        return self._v


class Gauge:
    """Settable value. Locked like ``Counter``: maintenance and worker
    threads both write gauges (queue depth, brownout level), and ``add()``
    is a read-modify-write that would tear without it."""

    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class StateGauge:
    """Typed-state gauge over a fixed set of named states (e.g. the brownout
    ladder). Holds the state INDEX; renders the name alongside it, and in
    Prometheus exposition emits one 0/1 series per state (label
    ``state="..."``) so dashboards alert on a name, not a magic integer."""

    def __init__(self, states: Sequence[str]):
        self.states = tuple(states)
        self._i = 0
        self._lock = threading.Lock()

    def set(self, index: int) -> None:
        with self._lock:
            self._i = int(index)

    @property
    def value(self) -> float:
        return float(self._i)

    @property
    def state(self) -> str:
        if 0 <= self._i < len(self.states):
            return self.states[self._i]
        return str(self._i)


class Histogram:
    """Fixed-bucket histogram; ``bounds[i]`` is the inclusive upper edge of
    bucket i, with one implicit overflow bucket past the last edge."""

    def __init__(self, bounds: Sequence[float] = DEFAULT_BUCKETS):
        self.bounds = tuple(bounds)
        assert self.bounds == tuple(sorted(self.bounds)) and self.bounds
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            i = 0
            while i < len(self.bounds) and v > self.bounds[i]:
                i += 1
            self.counts[i] += 1
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    def _snapshot(self):
        with self._lock:
            return (list(self.counts), self.count, self.sum, self.min,
                    self.max)

    def load(self, counts: Sequence[int], count: int, total: float,
             mn: float, mx: float) -> None:
        """Overwrite with an authoritative remote snapshot (same bucket
        table on both sides — DEFAULT_BUCKETS everywhere)."""
        assert len(counts) == len(self.counts), "bucket tables differ"
        with self._lock:
            self.counts = list(counts)
            self.count = count
            self.sum = total
            self.min = mn
            self.max = mx

    def merge(self, other: "Histogram") -> "Histogram":
        assert self.bounds == other.bounds, "histograms must share buckets"
        # snapshot under other's lock, apply under ours — never hold both
        # (a worker may be observe()-ing other concurrently; reading its
        # fields piecemeal could tear count vs counts)
        counts, count, total, mn, mx = other._snapshot()
        with self._lock:
            for i, c in enumerate(counts):
                self.counts[i] += c
            self.count += count
            self.sum += total
            self.min = min(self.min, mn)
            self.max = max(self.max, mx)
        return self

    def percentile(self, p: float) -> float:
        """p in [0, 1]; linear interpolation within the crossing bucket."""
        counts, count, _, mn, mx = self._snapshot()
        if count == 0:
            return float("nan")
        target = p * count
        cum = 0.0
        for i, c in enumerate(counts):
            if c and cum + c >= target:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else mx
                lo, hi = max(lo, mn if cum == 0 else lo), min(hi, mx)
                frac = max(0.0, min(1.0, (target - cum) / c))
                return lo + frac * max(hi - lo, 0.0)
            cum += c
        return mx

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def summary(self) -> Dict[str, float]:
        _, count, total, _, mx = self._snapshot()
        return {"count": count,
                "mean": total / count if count else float("nan"),
                "p50": self.percentile(0.50), "p95": self.percentile(0.95),
                "p99": self.percentile(0.99),
                "max": mx}


class MetricsRegistry:
    """Get-or-create metric store keyed by (kind, name, instance)."""

    GLOBAL = ""   # instance label of the aggregate view

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self._buckets = tuple(buckets)
        self._m: Dict[Tuple[str, str, str], object] = {}
        self._help: Dict[str, str] = {}
        self._lock = threading.Lock()

    def _get(self, kind: str, name: str, instance: str, factory,
             help: Optional[str] = None):
        key = (kind, name, instance)
        with self._lock:
            if help and name not in self._help:
                self._help[name] = help
            if key not in self._m:
                self._m[key] = factory()
            return self._m[key]

    def describe(self, name: str, help: str) -> None:
        """Attach a HELP string to a metric name (first writer wins)."""
        with self._lock:
            self._help.setdefault(name, help)

    def counter(self, name: str, instance: str = GLOBAL,
                help: Optional[str] = None) -> Counter:
        return self._get("counter", name, instance, Counter, help)

    def gauge(self, name: str, instance: str = GLOBAL,
              help: Optional[str] = None) -> Gauge:
        return self._get("gauge", name, instance, Gauge, help)

    def histogram(self, name: str, instance: str = GLOBAL,
                  help: Optional[str] = None) -> Histogram:
        return self._get("hist", name, instance,
                         lambda: Histogram(self._buckets), help)

    def state_gauge(self, name: str, states: Sequence[str],
                    instance: str = GLOBAL,
                    help: Optional[str] = None) -> StateGauge:
        return self._get("state", name, instance,
                         lambda: StateGauge(states), help)

    # ---- aggregation -----------------------------------------------------
    def _named(self, kind: str, name: str) -> List[Tuple[str, object]]:
        with self._lock:
            return [(k[2], v) for k, v in self._m.items()
                    if k[0] == kind and k[1] == name]

    def total(self, name: str) -> float:
        """Global value of a counter: sum across every instance label."""
        return sum(c.value for _, c in self._named("counter", name))

    def merged_histogram(self, name: str) -> Histogram:
        out = Histogram(self._buckets)
        for _, h in self._named("hist", name):
            out.merge(h)
        return out

    # ---- cross-process state transfer ------------------------------------
    def dump_state(self) -> List[Dict]:
        """JSON-able snapshot of every series — the worker side of the
        telemetry bridge (heartbeat responses carry this)."""
        with self._lock:
            items = list(self._m.items())
            help_texts = dict(self._help)
        rows: List[Dict] = []
        for (kind, name, inst), m in items:
            row: Dict = {"kind": kind, "name": name, "instance": inst,
                         "help": help_texts.get(name)}
            if kind in ("counter", "gauge"):
                row["value"] = m.value
            elif kind == "state":
                row["value"] = m.value
                row["states"] = list(m.states)
            else:
                counts, count, total, mn, mx = m._snapshot()
                row.update(counts=counts, count=count, sum=total,
                           min=(None if math.isinf(mn) else mn),
                           max=(None if math.isinf(mx) else mx))
            rows.append(row)
        return rows

    def merge_state(self, rows: Sequence[Dict],
                    instance: Optional[str] = None) -> None:
        """Load a worker's ``dump_state`` into this registry, overwriting
        per-series (the worker owns the truth for its own series; frontend-
        and worker-authored series are disjoint by name, so a blind
        overwrite never clobbers frontend counts). ``instance`` forces the
        instance label (a worker always reports as itself)."""
        for row in rows:
            kind = row["kind"]
            inst = instance if instance is not None else row["instance"]
            name = row["name"]
            if row.get("help"):
                self.describe(name, row["help"])
            if kind == "counter":
                self.counter(name, inst).load(row["value"])
            elif kind == "gauge":
                self.gauge(name, inst).set(row["value"])
            elif kind == "state":
                self.state_gauge(name, row["states"], inst).set(
                    int(row["value"]))
            else:
                self.histogram(name, inst).load(
                    row["counts"], row["count"], row["sum"],
                    math.inf if row["min"] is None else row["min"],
                    -math.inf if row["max"] is None else row["max"])

    # ---- text dump (benchmark output) ------------------------------------
    def render(self) -> str:
        with self._lock:
            items = sorted(self._m.items())
        lines = []
        hist_names = sorted({k[1] for k, _ in items if k[0] == "hist"})
        for (kind, name, inst), m in items:
            label = f"{name}{{{inst}}}" if inst else name
            if kind == "counter":
                lines.append(f"counter {label} {m.value:g}")
            elif kind == "gauge":
                lines.append(f"gauge {label} {m.value:g}")
            elif kind == "state":
                lines.append(f"state {label} {m.value:g} ({m.state})")
            else:
                s = m.summary()
                lines.append(
                    f"hist {label} count={s['count']} mean={s['mean']:.4f} "
                    f"p50={s['p50']:.4f} p95={s['p95']:.4f} "
                    f"p99={s['p99']:.4f} max={s['max']:.4f}")
        for name in hist_names:
            merged = self.merged_histogram(name)
            if merged.count:
                s = merged.summary()
                lines.append(
                    f"hist {name}{{ALL}} count={s['count']} "
                    f"mean={s['mean']:.4f} p50={s['p50']:.4f} "
                    f"p95={s['p95']:.4f} p99={s['p99']:.4f} "
                    f"max={s['max']:.4f}")
        return "\n".join(lines)

    # ---- Prometheus text exposition (0.0.4) -------------------------------
    @staticmethod
    def _escape_label(v: str) -> str:
        """Label-value escaping per the exposition spec: backslash, double
        quote, and newline (instance names are caller-supplied strings)."""
        return (v.replace("\\", r"\\").replace('"', r'\"')
                .replace("\n", r"\n"))

    @staticmethod
    def _escape_help(v: str) -> str:
        """HELP-text escaping per the spec: backslash and newline only."""
        return v.replace("\\", r"\\").replace("\n", r"\n")

    def render_prometheus(self, namespace: str = "prefillonly") -> str:
        """Prometheus text exposition format, scrape-ready.

        Counters/gauges become ``<ns>_<name>{instance="..."}``; histograms
        become the conventional cumulative ``_bucket{le=...}`` series plus
        ``_sum``/``_count`` — exact, because every histogram of a name
        shares one fixed bucket table. The empty (aggregate) instance label
        is omitted so global metrics scrape as unlabelled series.
        """
        with self._lock:
            items = sorted(self._m.items())
            help_texts = dict(self._help)
        by_name: Dict[Tuple[str, str], List[Tuple[str, object]]] = {}
        for (kind, name, inst), m in items:
            by_name.setdefault((kind, name), []).append((inst, m))
        out: List[str] = []
        for (kind, name), series in sorted(by_name.items()):
            full = f"{namespace}_{name}"
            ptype = {"counter": "counter", "gauge": "gauge",
                     "state": "gauge", "hist": "histogram"}[kind]
            htext = help_texts.get(name)
            if htext:
                out.append(f"# HELP {full} {self._escape_help(htext)}")
            out.append(f"# TYPE {full} {ptype}")
            for inst, m in series:
                esc = self._escape_label(inst)
                lbl = f'{{instance="{esc}"}}' if inst else ""
                if kind in ("counter", "gauge"):
                    out.append(f"{full}{lbl} {m.value:g}")
                    continue
                if kind == "state":
                    for i, st in enumerate(m.states):
                        stl = self._escape_label(st)
                        sep = (f'{{instance="{esc}",state="{stl}"}}'
                               if inst else f'{{state="{stl}"}}')
                        out.append(f"{full}{sep} "
                                   f"{1 if i == int(m.value) else 0}")
                    continue
                counts, count, total, _, _ = m._snapshot()
                cum = 0
                for i, bound in enumerate(m.bounds):
                    cum += counts[i]
                    le = f'le="{bound:g}"'
                    sep = f'{{instance="{esc}",{le}}}' if inst \
                        else f"{{{le}}}"
                    out.append(f"{full}_bucket{sep} {cum}")
                sep = (f'{{instance="{esc}",le="+Inf"}}' if inst
                       else '{le="+Inf"}')
                out.append(f"{full}_bucket{sep} {count}")
                out.append(f"{full}_sum{lbl} {total:g}")
                out.append(f"{full}_count{lbl} {count}")
        return "\n".join(out) + ("\n" if out else "")
