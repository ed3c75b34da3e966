"""The port's thread-mode chaos harness and the server's recovery against the
JAX package's (twins of the thread-mode tests of ``tests/test_chaos.py`` and
of the chaos timelines of ``tests/test_tracing.py``).

``FaultPlan`` draws are compared outright: the same config draws the same
faults in both copies, the process-mode streams included. Each recovery
scenario runs on a pool of the same fake engines under each package's
``AsyncServer`` and must end with the same outcome, counters and timeline
events. The soak asserts exactly-once resolution and bounds its own time.
"""
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro.core.engine import PrefillOnlyEngine as JEngine
from repro.core.scheduler import Request
from repro.runtime import fault_tolerance as jft
from repro.runtime.fault_tolerance import NaNGuard
from repro.serving import admission as jadm
from repro.serving import chaos as jchaos
from repro.serving import server as jserver
from repro.serving import tracing as jtracing
from repro_torch.core.engine import PrefillOnlyEngine as TEngine
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.serving import admission as tadm
from repro_torch.serving import chaos as tchaos
from repro_torch.serving import server as tserver
from repro_torch.serving import tracing as ttracing
from test_chaos import FakeServingEngine, FirstRouter, VanishingResultEngine

REF = types.SimpleNamespace(ft=jft, adm=jadm, chaos=jchaos, server=jserver,
                            tracing=jtracing)
PORT = types.SimpleNamespace(ft=tft, adm=tadm, chaos=tchaos, server=tserver,
                             tracing=ttracing)


def _pool(pkg, n=2, plan=None, cls=FakeServingEngine, **kw):
    pool = pkg.ft.InstancePool(lambda name: cls(name, **kw))
    pool.scale_to([f"i{k}" for k in range(n)])
    if plan is not None:
        pkg.chaos.wrap_pool(pool, plan)
    return pool


def _server(pkg, pool, retry=None, **kw):
    return pkg.server.AsyncServer(
        pool, router=FirstRouter(),
        retry=retry if retry is not None
        else pkg.server.RetryPolicy(budget=2, backoff=0.0), **kw).start()


def _outcome(res):
    if isinstance(res, (jadm.Rejected, tadm.Rejected)):
        return ("rejected", res.reason)
    return ("served", res.get("n_input"), res.get("scores"))


def _counters(srv, names=("requests_served", "requests_rejected",
                          "requests_retried", "engine_errors",
                          "results_quarantined", "watchdog_trips",
                          "late_results_dropped", "submit_failures")):
    return {n: srv.metrics.total(n) for n in names}


def _twin(scenario):
    """Run ``scenario(pkg)`` for both packages; returns (port, reference)."""
    return scenario(PORT), scenario(REF)


# ---- fault plan ---------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_fault_plan_draws_equal_reference(seed):
    cfg = dict(seed=seed, step_error=0.1, hang=0.05, straggler=0.1,
               nan_score=0.1, submit_error=0.2, kill=0.1, freeze=0.1,
               rpc_drop=0.15, rpc_delay=0.15,
               schedule=[("a", 3, "hang"), ("b", 1, "rpc_drop"),
                         ("a", 0, "submit_error")])
    j, t = jchaos.FaultPlan(jchaos.ChaosConfig(**cfg)), \
        tchaos.FaultPlan(tchaos.ChaosConfig(**cfg))
    ops = [(inst, op) for _ in range(60) for inst in ("a", "b", "i0")
           for op in ("step", "submit", "pstep")]
    assert [t.draw(*o) for o in ops] == [j.draw(*o) for o in ops]
    rpc = [(inst, op) for _ in range(30) for inst in ("a", "b")
           for op in ("submit", "step", "heartbeat")]
    assert [t.rpc_fault(*o) for o in rpc] == [j.rpc_fault(*o) for o in rpc]
    assert t.counts() == j.counts() and t.injected == j.injected
    assert len(set(t.counts())) >= 6


def test_fault_plan_schedule_and_budget():
    p = tchaos.FaultPlan(tchaos.ChaosConfig(
        schedule=[("a", 2, "hang"), ("a", 0, "submit_error")]))
    assert p.draw("a", "submit") == "submit_error"
    assert [p.draw("a", "step") for _ in range(4)] == \
        [None, None, "hang", None]
    assert p.counts() == {"submit_error": 1, "hang": 1}
    p = tchaos.FaultPlan(tchaos.ChaosConfig(step_error=1.0, max_faults=2))
    assert [p.draw("a", "step") for _ in range(5)] == \
        ["step_error", "step_error", None, None, None]
    with pytest.raises(AssertionError):
        tchaos.ChaosConfig(schedule=[("a", 0, "meteor_strike")])


# ---- recovery scenarios, both packages ----------------------------------------

def _scheduled(pkg, schedule, req_kw=None, n=2, cfg=None, **srv_kw):
    plan = pkg.chaos.FaultPlan(pkg.chaos.ChaosConfig(schedule=schedule,
                                                     **(cfg or {})))
    pool = _pool(pkg, n, plan)
    srv = _server(pkg, pool, **srv_kw)
    res = srv.submit("u", list(range(40)), **(req_kw or {})).result(
        timeout=10)
    out = (_outcome(res), plan.counts(), dict(pool.healthy))
    return srv, pool, out


def test_step_crash_retries_on_peer_and_serves():
    def run(pkg):
        srv, pool, out = _scheduled(pkg, [("i0", 0, "step_error")],
                                    dict(allowed_tokens=(5, 9)))
        srv.shutdown(drain=True, timeout=5)
        return out, _counters(srv)
    got, want = _twin(run)
    assert got == want
    (outcome, counts, healthy), c = got
    assert outcome[0] == "served" and counts == {"step_error": 1}
    assert healthy == {"i0": False, "i1": True}
    assert c["requests_retried"] == 1 and c["engine_errors"] == 1


@pytest.mark.parametrize("schedule,retry", [
    ([("i0", 0, "step_error"), ("i1", 0, "step_error")], None),
    ([("i0", 0, "step_error")], 0)], ids=["budget_exhausted", "disabled"])
def test_lost_work_resolves_rejected_error(schedule, retry):
    def run(pkg):
        kw = ({} if retry is None
              else dict(retry=pkg.server.RetryPolicy(budget=retry)))
        srv, _, out = _scheduled(pkg, schedule, **kw)
        srv.shutdown(drain=True, timeout=5)
        return out, _counters(srv)
    got, want = _twin(run)
    assert got == want and got[0][0] == ("rejected", "error")


def test_transient_submit_failure_falls_back_to_peer():
    def run(pkg):
        srv, pool, out = _scheduled(pkg, [("i0", 0, "submit_error")])
        srv.shutdown(drain=True, timeout=5)
        return out, srv.metrics.counter("submit_failures", "i0").value, \
            pool.engines["i1"].steps
    got, want = _twin(run)
    assert got == want and got[1:] == (1, 1)


def test_nan_corruption_quarantined_and_retried():
    def run(pkg):
        srv, pool, out = _scheduled(pkg, [("i0", 0, "nan_score")],
                                    dict(allowed_tokens=(5, 9)))
        srv.shutdown(drain=True, timeout=5)
        return out, _counters(srv)
    got, want = _twin(run)
    assert got == want
    (outcome, _, healthy), c = got
    assert all(np.isfinite(v) for v in outcome[2].values())
    assert c["results_quarantined"] == 1 and c["requests_retried"] == 1
    assert healthy["i0"] is True


def _wait_for(cond, limit=5.0):
    deadline = time.monotonic() + limit
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)


def test_hang_trips_watchdog_and_late_result_is_dropped():
    def run(pkg):
        plan = pkg.chaos.FaultPlan(pkg.chaos.ChaosConfig(
            schedule=[("i0", 0, "hang")], hang_seconds=0.8))
        pool = _pool(pkg, 2, plan)
        wd = pkg.ft.JCTDeadlineWatchdog(factor=4.0, min_deadline=0.12,
                                        interval=0.02)
        tracer = pkg.tracing.SpanTracer()
        srv = _server(pkg, pool, watchdog=wd, tracer=tracer)
        fut = srv.submit("u", list(range(40)), allowed_tokens=(5, 9))
        t0 = time.perf_counter()
        res = fut.result(timeout=10)
        resolved_in = time.perf_counter() - t0
        _wait_for(lambda: srv.metrics.total("late_results_dropped") >= 1)
        srv.shutdown(drain=True, timeout=5)
        (rec,) = tracer.snapshot()
        names = [e["name"] for e in rec["events"]]
        key = [n for n in names if n in ("watchdog_trip", "lost", "retry",
                                         "tombstone_drop", "finish")]
        return (_outcome(res), _counters(srv), dict(pool.healthy), key,
                rec["attempts"], rec["outcome"]), resolved_in
    (got, t_port), (want, _) = _twin(run)
    assert got == want
    outcome, c, healthy, key, attempts, final = got
    assert outcome[0] == "served" and final == "delivered"
    assert t_port < 0.6, t_port        # resolved well before the hang ended
    assert c["watchdog_trips"] >= 1 and c["late_results_dropped"] == 1
    assert healthy["i0"] is False and attempts == 2
    assert key.index("watchdog_trip") < key.index("retry") \
        < key.index("tombstone_drop")


def test_straggler_below_deadline_does_not_trip():
    def run(pkg):
        wd = pkg.ft.JCTDeadlineWatchdog(factor=4.0, min_deadline=0.5,
                                        interval=0.02)
        srv, pool, out = _scheduled(pkg, [("i0", 0, "straggler")],
                                    cfg=dict(straggler_seconds=0.05),
                                    watchdog=wd)
        srv.shutdown(drain=True, timeout=5)
        return out, _counters(srv)
    got, want = _twin(run)
    assert got == want
    assert got[1]["watchdog_trips"] == got[1]["requests_retried"] == 0
    assert got[0][2]["i0"] is True


def test_retry_events_on_timeline_equal_reference():
    def run(pkg):
        tracer = pkg.tracing.SpanTracer()
        srv, _, out = _scheduled(pkg, [("i0", 0, "step_error")],
                                 tracer=tracer)
        srv.shutdown(drain=True, timeout=5)
        (rec,) = tracer.snapshot(include_active=True)
        retry = next(e for e in rec["events"] if e["name"] == "retry")
        return (out, [e["name"] for e in rec["events"]], rec["outcome"],
                rec["attempts"], retry["instance"],
                retry["from_rid"] in rec["rids"])
    got, want = _twin(run)
    assert got == want
    _, names, outcome, attempts, inst, linked = got
    assert outcome == "delivered" and attempts == 2 and inst == "i1"
    assert linked
    for needed in ("submit", "route", "enqueue", "lost", "retry", "finish"):
        assert needed in names, (needed, names)


# ---- races and harvest --------------------------------------------------------

def _until_inflight(eng):
    _wait_for(lambda: bool(eng._inflight))
    assert eng._inflight, "step never started"


def test_cancel_racing_inflight_step_still_serves_exactly_once():
    def run(pkg):
        pool = _pool(pkg, 1, sec_per_token=0.01)
        srv = _server(pkg, pool)
        fut = srv.submit("u", list(range(40)))
        n = []
        fut.add_done_callback(lambda f: n.append(1))
        eng = pool.engines["i0"]
        _until_inflight(eng)
        cancelled = srv.cancel(eng._inflight[0])
        res = fut.result(timeout=10)
        srv.shutdown(drain=True, timeout=5)
        return cancelled, _outcome(res)[0], len(n)
    got, want = _twin(run)
    assert got == want == (False, "served", 1)


def test_cancel_queued_behind_inflight_step():
    def run(pkg):
        pool = _pool(pkg, 1, sec_per_token=0.01)
        srv = _server(pkg, pool)
        futs = [srv.submit("u", list(range(40))) for _ in range(2)]
        eng = pool.engines["i0"]
        _until_inflight(eng)
        with eng.lock:
            queued = [r.req_id for r in eng.queue]
        ok = srv.cancel(queued[0])
        out = [_outcome(f.result(timeout=10))[:2] for f in futs]
        srv.shutdown(drain=True, timeout=5)
        return len(queued), ok, out
    got, want = _twin(run)
    assert got == want
    assert got == (1, True, [("served", 40), ("rejected", "cancelled")])


def test_worker_survives_missing_result_id():
    def run(pkg):
        pool = _pool(pkg, 1, cls=VanishingResultEngine)
        srv = _server(pkg, pool, retry=None)
        srv.submit("u", list(range(20)))     # result vanishes pre-harvest
        res2 = srv.submit("u", list(range(20))).result(timeout=10)
        srv.shutdown(drain=False)
        return _outcome(res2)[0], _counters(srv)["engine_errors"], \
            pool.healthy["i0"]
    got, want = _twin(run)
    assert got == want == ("served", 0, True)


def test_submit_races_mark_failed_under_injector():
    """Submitters race a thread that fails and resurrects instances while
    transient submit faults fire: every future resolves exactly once."""
    plan = tchaos.FaultPlan(tchaos.ChaosConfig(seed=3, submit_error=0.1))
    pool = _pool(PORT, 3, plan)
    srv = _server(PORT, pool, retry=tserver.RetryPolicy(budget=3,
                                                        backoff=0.0))
    futs, flock = [], threading.Lock()
    stop = threading.Event()

    def submitter(k):
        for j in range(40):
            f = srv.submit(f"u{k}-{j}", list(range(30)))
            with flock:
                futs.append(f)
            time.sleep(0.001)

    def monkey():
        names = ["i0", "i1", "i2"]
        k = 0
        while not stop.is_set():
            srv.mark_failed(names[k % 3])
            k += 1
            time.sleep(0.01)
            srv.scale_to([n for n in names if pool.healthy.get(n)])
            srv.scale_to(names)
            time.sleep(0.02)

    threads = [threading.Thread(target=submitter, args=(k,))
               for k in range(3)]
    mk = threading.Thread(target=monkey)
    [t.start() for t in threads]
    mk.start()
    [t.join(timeout=60) for t in threads]
    stop.set()
    mk.join(timeout=60)
    counts = _count_resolutions(futs)
    assert srv.drain(timeout=30), "futures hung after chaos"
    assert len(futs) == 120 and all(f.done() for f in futs)
    assert set(counts.values()) == {1}
    served = [f for f in futs if not isinstance(f.result(), tadm.Rejected)]
    assert len(served) >= 0.9 * len(futs)
    srv.shutdown(drain=True, timeout=5)


def _count_resolutions(futs):
    counts = {}
    lock = threading.Lock()
    for i, f in enumerate(futs):
        counts.setdefault(i, 0)

        def cb(_, i=i):
            with lock:
                counts[i] += 1
        f.add_done_callback(cb)
    return counts


# ---- the engine's non-finite guard --------------------------------------------

def _bare(cls):
    eng = object.__new__(cls)              # _score only touches the guard
    eng.result_guard = NaNGuard(3)
    eng.nonfinite_results = 0
    return eng


def test_engine_score_flags_nonfinite_logits_as_the_reference():
    j, t = _bare(JEngine), _bare(TEngine)
    r = Request(n_input=4, arrival=0.0, chain=(), tokens=[1, 2, 3, 4],
                allowed_tokens=(5, 9))
    r2 = Request(n_input=4, arrival=0.0, chain=(), tokens=[1, 2, 3, 4])
    r.finish_time = r2.finish_time = 1.0
    rng = np.random.default_rng(0)
    cases = [(r, rng.normal(size=(1, 16))), (r2, rng.normal(size=(1, 16)))]
    nan5 = rng.normal(size=(1, 16))
    nan5[0, 5] = np.nan
    ninf = np.zeros((1, 16))
    ninf[0, 3] = -np.inf
    nan7 = ninf.copy()
    nan7[0, 7] = np.nan
    cases += [(r, nan5), (r2, ninf), (r2, nan7), (r2, np.full((1, 16),
                                                              -np.inf))]
    for req, logits in cases:
        want = JEngine._score(j, logits, req)
        got = TEngine._score(t, torch.from_numpy(logits), req)
        assert got.keys() == want.keys()
        assert got["token"] == want["token"]
        assert got.get("corrupt") == want.get("corrupt")
        for k, v in want.get("scores", {}).items():
            assert got["scores"][k] == pytest.approx(v, abs=1e-12)
    assert t.nonfinite_results == j.nonfinite_results == 3
    assert (t.result_guard.consecutive, t.result_guard.total_skipped) == \
        (j.result_guard.consecutive, j.result_guard.total_skipped)


# ---- brownout -----------------------------------------------------------------

def test_brownout_ladder_equals_reference():
    kw = dict(enter=(2, 6, 12), exit=(1, 3, 6), hold=2)
    j, t = jadm.BrownoutController(**kw), tadm.BrownoutController(**kw)
    rng = np.random.default_rng(5)
    sig = [0.5, 13.0, 7.0, 4.0, 4.0, 2.5, 3.5, 2.5, 2.5] + \
        rng.uniform(0, 15, 200).tolist()
    shed = rng.uniform(0, 0.5, len(sig)).tolist()
    assert [t.evaluate(s, r) for s, r in zip(sig, shed)] == \
        [j.evaluate(s, r) for s, r in zip(sig, shed)]
    assert (t.escalations, t.deescalations, t.state(), t.pressure()) == \
        (j.escalations, j.deescalations, j.state(), j.pressure())
    b = tadm.BrownoutController(**kw)
    assert [b.evaluate(x) for x in sig[:9]] == [0, 3, 3, 3, 2, 2, 2, 2, 1]


def test_brownout_levels_apply_to_server_and_timelines():
    pool = _pool(PORT, 2, sec_per_token=0.004)   # 100 tokens ~0.4 s
    b = tadm.BrownoutController(enter=(0.2, 0.5, 1.0), exit=(0.05, 0.1, 0.2),
                                hold=2, slack_factor=1.5)
    ctrl = tadm.AdmissionController(adapt=False)
    tracer = ttracing.SpanTracer()
    srv = _server(PORT, pool, brownout=b, admission=ctrl, tracer=tracer)
    futs = [srv.submit(f"u{i}", list(range(100))) for i in range(12)]
    _wait_for(lambda: b.level >= 3)
    assert b.level == 3, "backlog never escalated the ladder"
    rej = srv.submit("u-late", list(range(100))).result(timeout=2)
    assert isinstance(rej, tadm.Rejected) and rej.reason == "brownout"
    assert ctrl.pressure == pytest.approx(1.5)
    assert any(pool.engines[n].degraded for n in pool.live_names())
    assert srv.metrics.gauge("brownout_level").value == 3
    assert srv.metrics.state_gauge(
        "brownout_state", tadm.BrownoutController.LEVELS).state == "shed"
    assert srv.drain(timeout=30)
    recs = tracer.snapshot()
    assert any(e["name"] == "brownout" for r in recs for e in r["events"])
    shed = [r for r in recs if r["outcome"] == "rejected:brownout"]
    assert len(shed) == 1 and shed[0]["user_id"] == "u-late"
    _wait_for(lambda: b.level == 0, 10.0)
    assert b.level == 0 and ctrl.pressure == pytest.approx(1.0)
    assert not any(pool.engines[n].degraded for n in pool.live_names())
    assert all(f.done() for f in futs)
    srv.shutdown(drain=True, timeout=5)


# ---- the soak -----------------------------------------------------------------

def _soak_round(seed):
    if seed == 0:
        cfg = tchaos.ChaosConfig(
            seed=0, hang_seconds=0.4, straggler_seconds=0.04,
            schedule=[("i0", 0, "submit_error"), ("i0", 1, "step_error"),
                      ("i1", 0, "nan_score"), ("i2", 0, "straggler"),
                      ("i1", 1, "hang")])
    else:
        cfg = tchaos.ChaosConfig(seed=seed, step_error=0.03, hang=0.02,
                                 hang_seconds=0.4, straggler=0.03,
                                 straggler_seconds=0.04, nan_score=0.04,
                                 submit_error=0.06, max_faults=8)
    plan = tchaos.FaultPlan(cfg)
    pool = _pool(PORT, 3, plan, sec_per_token=2e-4)
    wd = tft.JCTDeadlineWatchdog(factor=4.0, min_deadline=0.15,
                                 interval=0.02)
    srv = tserver.AsyncServer(pool, retry=tserver.RetryPolicy(
        budget=3, backoff=0.002), watchdog=wd).start()
    stop = threading.Event()

    def healer():
        names = ["i0", "i1", "i2"]
        while not stop.is_set():
            if any(not pool.healthy.get(n, False) for n in names):
                srv.scale_to([n for n in names if pool.healthy.get(n)])
                srv.scale_to(names)
            stop.wait(0.05)

    hl = threading.Thread(target=healer)
    hl.start()
    futs = []
    rng = np.random.default_rng(seed)
    for _ in range(40):
        futs.append(srv.submit(f"u{int(rng.integers(8))}",
                               list(range(30 + int(rng.integers(30)))),
                               allowed_tokens=(5, 9)))
        time.sleep(0.002)
    counts = _count_resolutions(futs)
    drained = srv.drain(timeout=30)
    stop.set()
    hl.join(timeout=30)
    srv.shutdown(drain=True, timeout=5)
    return plan, futs, counts, drained, srv


def test_chaos_soak_exactly_once_and_mostly_served():
    """Five fault kinds across seeded rounds, 240 futures: each resolves
    exactly once, none hangs past the drain bound, and >= 90% are served.
    The soak bounds its own wall time."""
    t0 = time.monotonic()
    kinds, total, served_total = set(), 0, 0
    for seed in range(6):
        plan, futs, counts, drained, srv = _soak_round(seed)
        assert drained, f"seed {seed}: futures hung past the drain bound"
        assert all(f.done() for f in futs)
        assert set(counts.values()) == {1}, f"seed {seed}: {counts}"
        outcomes = [f.result() for f in futs]
        for o in outcomes:
            if isinstance(o, tadm.Rejected):
                assert o.reason in ("error", "no_instances"), o
            else:
                assert all(np.isfinite(v) for v in o["scores"].values())
        served = sum(1 for o in outcomes if not isinstance(o, tadm.Rejected))
        total += len(outcomes)
        served_total += served
        kinds |= set(plan.counts())
    assert total == 240 and len(kinds) >= 5, kinds
    assert served_total >= 0.9 * total, (served_total, total)
    assert time.monotonic() - t0 < 120
