"""The port's observability plane against the JAX package's: ``SpanTracer``
(ring, sampling, orphans, rebind, broadcast, ``dump_jsonl``,
``chrome_trace``), ``BatchRecord``, ``JCTCalibrationMonitor``'s Prometheus
export, and ``MetricsRegistry``'s text and Prometheus renderings, each
driven with the same operations through both copies (twins of
``tests/test_tracing.py`` and ``tests/test_metrics_prometheus.py``).

A tracer stamps events with ``time.perf_counter``, so two tracers' dumps
are compared with every timestamp removed (``_untimed``); registries render
the same text outright.
"""
import json
import math
import threading
import time

import pytest

from repro.core import jct as jjct
from repro.launch import smoke as jsmoke
from repro.serving import metrics as jmetrics
from repro.serving import tracing as jtracing
from repro_torch.core import jct as tjct
from repro_torch.launch import smoke as tsmoke
from repro_torch.serving import metrics as tmetrics
from repro_torch.serving import tracing as ttracing

PAIR = pytest.mark.parametrize("tr_mod", [jtracing, ttracing],
                               ids=["reference", "port"])
_TIMES = {"t", "t0", "t1", "dur", "ts"}


def _untimed(obj):
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items() if k not in _TIMES}
    if isinstance(obj, list):
        return [_untimed(v) for v in obj]
    return obj


def _drive(mod):
    """One fixed sequence of every tracer operation; returns the tracer."""
    tr = mod.SpanTracer(capacity=6, batch_capacity=3, orphan_capacity=4)
    t = time.perf_counter()
    tr.event_rid(7, "batch", kind="miss")          # before its bind
    tr.span_rid(7, "execute", t, t + 0.002, pack="miss")
    for i in range(10):
        tr.event_rid(1000 + i, "stray")            # overflows the orphans
    ctx = tr.begin(rid=7, user_id="u7", n_input=40, deadline=None)
    tr.event(ctx, "route", instance="i0", predicted_jct=0.01)
    a = tr.begin(user_id="ua", n_input=12)
    tr.bind(a, 21)
    tr.rebind(21, 22)                              # a retry re-key
    tr.event_rid(22, "retry", attempt=1, from_rid=21)
    tr.broadcast("brownout", level=2, prev=0, state="degrade")
    tr.span_rid(22, "queue", t, t + 0.001, instance="i1")
    tr.finish_rid(22, "delivered")
    tr.postmortem_rid(21, "tombstone_drop")        # after it finished
    tr.finish(ctx, "delivered")
    for i in range(8):                             # ring overflow
        c = tr.begin(rid=100 + i, user_id=f"u{i}")
        tr.finish(c, "rejected:deadline" if i % 3 else "delivered",
                  detail="d")
    for k in range(5):
        tr.record_batch(mod.BatchRecord(
            step=k, ts=t + k, instance="i0", kind=("solo", "miss", "hit")[
                k % 3], n_requests=1 + k, req_ids=tuple(range(k + 1)),
            computed_tokens=40 * k, padded_tokens=64 * k, S=64, Nb=k,
            jit_path="fresh", jit_key=(64, k), compiled=k == 0,
            predicted_jct=0.01, wall=0.002))
    open_ = tr.begin(rid=300, user_id="open")
    tr.event(open_, "enqueue", instance="i2", req_id=300)
    tr.event_rid(555, "late")                      # orphaned
    return tr


def test_tracer_dumps_equal_reference_apart_from_timestamps():
    j, t = _drive(jtracing), _drive(ttracing)
    assert t.stats() == j.stats()
    for inc in (False, True):
        got = [json.loads(x) for x in t.dump_jsonl(
            include_active=inc).splitlines()]
        want = [json.loads(x) for x in j.dump_jsonl(
            include_active=inc).splitlines()]
        assert _untimed(got) == _untimed(want) and got
    assert _untimed(t.chrome_trace(include_active=True)) == \
        _untimed(j.chrome_trace(include_active=True))
    assert _untimed(t.snapshot()) == _untimed(j.snapshot())
    assert _untimed(t.batch_snapshot()) == _untimed(j.batch_snapshot())
    assert [(rid, name, _untimed(a)) for rid, _, name, a in
            t.drain_orphans()] == [(rid, name, _untimed(a)) for rid, _, name,
                                   a in j.drain_orphans()]
    assert _untimed([b.to_dict() for b in t.drain_batches()]) == \
        _untimed([b.to_dict() for b in j.drain_batches()])


@PAIR
def test_ring_bounds_and_counters(tr_mod):
    tr = tr_mod.SpanTracer(capacity=4)
    for i in range(10):
        tr.finish(tr.begin(rid=i, user_id=f"u{i}"), "delivered")
    s = tr.stats()
    assert s["begun"] == 10 and s["finished"] == 10
    assert s["retained"] == 4 and s["active"] == 0
    assert [r["req_id"] for r in tr.snapshot()] == [6, 7, 8, 9]


@PAIR
def test_sampling_is_deterministic_and_no_op(tr_mod):
    tr = tr_mod.SpanTracer(sample=0.25)
    ctxs = [tr.begin() for _ in range(20)]
    assert len([c for c in ctxs if c != tr_mod.SpanTracer._NOSAMPLE]) == 5
    dead = next(c for c in ctxs if c == tr_mod.SpanTracer._NOSAMPLE)
    tr.event(dead, "route")
    tr.bind(dead, 99)
    tr.finish(dead, "delivered")
    s = tr.stats()
    assert s["sampled_out"] == 15 and s["begun"] == 5
    assert s["finished"] == 0 and 99 not in tr._by_rid


@PAIR
def test_orphan_buffer_merges_at_bind_and_is_bounded(tr_mod):
    tr = tr_mod.SpanTracer(orphan_capacity=4)
    tr.event_rid(7, "batch", kind="miss")
    tr.span_rid(7, "execute", 1.0, 2.0, pack="miss")
    tr.event_rid(8, "batch")
    assert tr.stats()["orphaned"] == 3
    ctx = tr.begin(rid=7)
    assert tr.stats()["orphaned"] == 1
    tr.finish(ctx, "delivered")
    rec = tr.snapshot()[0]
    assert [e["name"] for e in rec["events"]] == ["submit", "batch",
                                                  "finish"]
    (sp,) = rec["spans"]
    assert (sp["name"], sp["t0"], sp["t1"], sp["pack"]) == \
        ("execute", 1.0, 2.0, "miss")
    for i in range(10):
        tr.event_rid(1000 + i, "batch")
    assert tr.stats()["orphaned"] == 4


@PAIR
def test_rebind_keeps_old_rid_on_same_timeline(tr_mod):
    tr = tr_mod.SpanTracer()
    tr.begin(rid=1, user_id="u")
    tr.rebind(1, 2)
    tr.event_rid(2, "retry", attempt=1)
    tr.event_rid(1, "tombstone_drop")
    tr.finish_rid(2, "delivered")
    (rec,) = tr.snapshot()
    assert rec["rids"] == [1, 2] and rec["attempts"] == 2
    assert [e["name"] for e in rec["events"]] == [
        "submit", "retry", "tombstone_drop", "finish"]
    tr.event_rid(1, "stale")
    assert tr.stats()["orphaned"] == 1


def _one_full_trace(tr, mod, rid=5, instance="i0"):
    ctx = tr.begin(rid=rid, user_id="u", n_input=40)
    t = time.perf_counter()
    tr.event(ctx, "route", instance=instance, predicted_jct=0.01)
    tr.event(ctx, "enqueue", instance=instance, req_id=rid)
    time.sleep(0.005)
    tr.span_rid(rid, "queue", t, t + 0.001, instance=instance)
    tr.span_rid(rid, "execute", t + 0.001, t + 0.003, instance=instance,
                pack="solo")
    tr.record_batch(mod.BatchRecord(
        step=0, ts=t + 0.003, instance=instance, kind="solo",
        req_ids=(rid,), computed_tokens=40, padded_tokens=64, S=64,
        jit_path="fresh", jit_key=(64, True), compiled=True,
        predicted_jct=0.01, wall=0.002))
    tr.finish(ctx, "delivered")


def test_exports_validate_under_both_packages_validators():
    """The port's dump and chrome trace pass the port's strict validators
    and the reference's, with the reference's results."""
    outs = []
    for mod in (jtracing, ttracing):
        tr = mod.SpanTracer()
        _one_full_trace(tr, mod)
        outs.append((tr.dump_jsonl(), tr.chrome_trace()))
    (jtext, jchrome), (ttext, tchrome) = outs
    for smoke in (jsmoke, tsmoke):
        rec = smoke.validate_trace_jsonl(ttext)
        assert rec["outcome"] == "delivered" and rec["req_id"] == 5
        assert smoke.validate_chrome(tchrome) == 2
    assert _untimed(tsmoke.validate_trace_jsonl(ttext)) == \
        _untimed(jsmoke.validate_trace_jsonl(jtext))
    rows = [json.loads(line) for line in ttext.splitlines()]
    assert [r["type"] for r in rows] == ["request", "batch"]
    assert rows[1]["padding_waste"] == pytest.approx(1 - 40 / 64)
    names = {e["name"] for e in tchrome["traceEvents"]}
    assert {"request delivered", "queue", "execute", "step solo",
            "process_name", "thread_name"} <= names
    with pytest.raises(ValueError):
        tsmoke.validate_chrome({"traceEvents": []})
    with pytest.raises(ValueError):
        tsmoke.validate_trace_jsonl(rows[1] and json.dumps(rows[1]))


def test_batch_record_fields_and_padding_waste_equal_reference():
    for kw in ({}, dict(computed_tokens=100, padded_tokens=80),
               dict(computed_tokens=30, padded_tokens=120, jit_key=(1, 2))):
        j = jtracing.BatchRecord(step=1, ts=0.5, **kw)
        t = ttracing.BatchRecord(step=1, ts=0.5, **kw)
        assert t.to_dict() == j.to_dict()
        assert t.padding_waste == j.padding_waste
    assert ttracing.BatchRecord(
        step=1, ts=0.0, computed_tokens=30,
        padded_tokens=120).to_dict()["padding_waste"] == 0.75


def _monitor_run(jct, tr_mod, met_mod):
    model = jct.LinearProxyJCT(a=1e-3, b=0.0, refit_every=10_000)
    model._recent = [(n, 0, 1e-4 * n) for n in range(50, 300, 10)]
    shape = jct.PackedShapeJCT(fallback=model)
    mon = tr_mod.JCTCalibrationMonitor(model, buckets=(64, 256), window=32,
                                       drift_threshold=0.5, drift_min=8,
                                       cooldown=16, shape_model=shape)
    reg = met_mod.MetricsRegistry()
    mon.bind(reg, "i0")
    for k in range(20):
        n = 40 + 37 * k
        mon.observe(model.predict(n), 1e-4 * n + 1e-5 * (k % 3), n,
                    kind=("solo", "miss", "hit")[k % 3])
    return mon, reg


def test_jct_monitor_export_equals_reference():
    (jm, jreg), (tm, treg) = (_monitor_run(jjct, jtracing, jmetrics),
                              _monitor_run(tjct, ttracing, tmetrics))
    assert tm.drift_refits == jm.drift_refits == 1
    assert treg.render_prometheus() == jreg.render_prometheus()
    assert treg.render() == jreg.render()
    assert tm.summary() == jm.summary()
    series = tsmoke.parse_prometheus(treg.render_prometheus())
    assert "prefillonly_jct_residual_seconds_bucket" in series
    assert "prefillonly_jct_residual_hit_seconds_bucket" in series
    assert series["prefillonly_jct_coef_a"][0]["value"] == \
        pytest.approx(1e-4)


# ---- MetricsRegistry: text and Prometheus renderings ------------------------

def _fill(met):
    reg = met.MetricsRegistry(buckets=(0.1, 1.0, 10.0))
    reg.counter("requests_served", help="Requests resolved with a result")
    reg.counter("requests_served", "a").inc(3)
    reg.counter("requests_served", "b").inc(2)
    reg.counter("requests_rejected").inc()
    reg.gauge("queue_depth", "i0", help="Queued requests per instance").set(5)
    reg.gauge("backlog_seconds", "i0").add(0.25)
    reg.describe("odd", "line1\nline2 with \\ backslash")
    reg.describe("odd", "a later, different help text")
    reg.counter("odd").inc()
    reg.counter("requests_served", 'in"st\\ance\nwith everything').inc(3)
    h = reg.histogram("jct_residual_seconds", "i0")
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
    reg.histogram("latency_seconds").observe(0.123)
    reg.state_gauge("brownout_state", ("normal", "tighten", "degrade",
                                       "shed"), "i0").set(2)
    return reg


def test_registry_renders_equal_reference():
    j, t = _fill(jmetrics), _fill(tmetrics)
    assert t.render_prometheus() == j.render_prometheus()
    assert t.render_prometheus("other") == j.render_prometheus("other")
    assert t.render() == j.render()
    assert t.dump_state() == j.dump_state()
    for name in ("jct_residual_seconds", "latency_seconds"):
        assert t.merged_histogram(name).summary() == \
            j.merged_histogram(name).summary()
    assert t.total("requests_served") == j.total("requests_served") == 8


def test_prometheus_text_parses_equal_under_both_parsers():
    text = _fill(tmetrics).render_prometheus()
    got, want = tsmoke.parse_prometheus(text), jsmoke.parse_prometheus(text)
    assert got == want
    assert tsmoke.validate_histograms(got) == \
        jsmoke.validate_histograms(want)
    buckets = got["prefillonly_jct_residual_seconds_bucket"]
    assert [b["value"] for b in buckets] == [1, 3, 4, 5]
    by_state = {r["labels"]["state"]: r["value"]
                for r in got["prefillonly_brownout_state"]}
    assert by_state == {"normal": 0, "tighten": 0, "degrade": 1, "shed": 0}
    assert r"# HELP prefillonly_odd line1\nline2 with \\ backslash" in text
    for bad in ("prefillonly_x 1", "# TYPE x bogus\nx 1",
                '# TYPE x gauge\nx{a=b} 1', "# TYPE x gauge\nx one"):
        for parser in (tsmoke, jsmoke):
            with pytest.raises(ValueError):
                parser.parse_prometheus(bad)


@pytest.mark.parametrize("met", [jmetrics, tmetrics],
                         ids=["reference", "port"])
def test_histogram_percentiles_and_merge(met):
    h = met.Histogram(bounds=(0.1, 1.0, 10.0))
    assert math.isnan(h.percentile(0.5))
    h.observe(0.35)
    assert h.percentile(0.5) == pytest.approx(0.35)
    reg = met.MetricsRegistry(buckets=(0.1, 1.0, 10.0))
    reg.histogram("lat", "a").observe(0.05)
    reg.histogram("lat", "b").observe(5.0)
    merged = reg.merged_histogram("lat")
    assert (merged.count, merged.min, merged.max) == (2, 0.05, 5.0)


def test_state_transfer_round_trips_into_the_reference_registry():
    """``dump_state`` of a port registry loads into both registries with
    the same result (the telemetry bridge's payload is shared)."""
    rows = _fill(tmetrics).dump_state()
    j, t = (m.MetricsRegistry(buckets=(0.1, 1.0, 10.0))
            for m in (jmetrics, tmetrics))
    j.merge_state(rows, instance="w")
    t.merge_state(rows, instance="w")
    assert t.render_prometheus() == j.render_prometheus()


def test_registry_readers_vs_writers_soak():
    """Writers on several instance labels while readers scrape: every
    scrape parses strictly and the final totals are exact."""
    reg = tmetrics.MetricsRegistry(buckets=(0.01, 0.1, 1.0))
    reg.describe("requests_served", "served")
    n_writers, per = 4, 1000
    errors = []
    stop = threading.Event()

    def writer(k):
        inst = f"i{k % 2}"
        for j in range(per):
            reg.counter("requests_served", inst).inc()
            reg.gauge("queue_depth", inst).add(1.0)
            reg.histogram("latency_seconds", inst).observe(0.001 * (j % 7))
            reg.state_gauge("brownout_state", ("normal", "shed"),
                            inst).set(j % 2)

    def reader():
        while not stop.is_set():
            try:
                tsmoke.validate_histograms(
                    tsmoke.parse_prometheus(reg.render_prometheus()))
                reg.render()
            except Exception as e:
                errors.append(e)
                return

    ws = [threading.Thread(target=writer, args=(k,))
          for k in range(n_writers)]
    rs = [threading.Thread(target=reader) for _ in range(2)]
    [t.start() for t in rs + ws]
    [t.join(timeout=60) for t in ws]
    stop.set()
    [t.join(timeout=60) for t in rs]
    assert not errors, errors
    assert reg.total("requests_served") == n_writers * per
    assert sum(g.value for _, g in reg._named("gauge", "queue_depth")) == \
        n_writers * per
    assert reg.merged_histogram("latency_seconds").count == n_writers * per
