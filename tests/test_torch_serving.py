"""The port's serving plane against the JAX package's (twins of
``tests/test_serving.py``): histograms and the registry, the routers, the
admission gate and its feedback loop, ``AsyncServer`` over fake engines
(typed rejections, shedding, cancellation, failure, scaling, shutdown, a
concurrent soak) and over real engines, and the engine's serving probes.

Deterministic parts are compared outright: the same inputs give the same
percentiles, routes, admission verdicts and rendered text in both copies.
A server scenario runs on both packages' servers over the same fake
engines and must end with the same outcomes and counters. Real engines run
the reduced qwen1.5-0.5b config in float32 on bridged weights (the port's
on ``device="cpu"``), scores held to 1e-4.
"""
import dataclasses
import threading
import time
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.configs import reduce_config as j_reduce_config
from repro.core import engine as jengine
from repro.core.kv_policy import MemoryModel as JMemoryModel
from repro.core.prefix_cache import token_chain as j_token_chain
from repro.launch.serve import start_metrics_server as j_start_metrics
from repro.models.model import build
from repro.runtime import fault_tolerance as jft
from repro.runtime import hw as jhw
from repro.runtime.sharding import materialize
from repro.serving import admission as jadm
from repro.serving import metrics as jmetrics
from repro.serving import router as jrouter
from repro.serving import server as jserver
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import engine as tengine
from repro_torch.core.kv_policy import MemoryModel
from repro_torch.core.prefix_cache import token_chain
from repro_torch.launch.serve import start_metrics_server
from repro_torch.models.params import params_from_numpy
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.runtime.hw import H100_SXM
from repro_torch.serving import admission as tadm
from repro_torch.serving import metrics as tmetrics
from repro_torch.serving import router as trouter
from repro_torch.serving import server as tserver
from test_serving import FakeEngine, _BS8

REF = types.SimpleNamespace(ft=jft, adm=jadm, metrics=jmetrics,
                            router=jrouter, server=jserver)
PORT = types.SimpleNamespace(ft=tft, adm=tadm, metrics=tmetrics,
                             router=trouter, server=tserver)
F32_TOL = 1e-4
YES, NO = 5, 9


def _twin(scenario):
    return scenario(PORT), scenario(REF)


def _pool(pkg, n=2, **kw):
    pool = pkg.ft.InstancePool(lambda name: FakeEngine(name, **kw))
    pool.scale_to([f"i{k}" for k in range(n)])
    return pool


def _rejected(o):
    return isinstance(o, (jadm.Rejected, tadm.Rejected))


def _kinds(outcomes):
    return [o.reason if _rejected(o) else "served" for o in outcomes]


# ---- metrics ----------------------------------------------------------------

def test_histogram_percentiles_equal_reference():
    rng = np.random.default_rng(0)
    xs = rng.uniform(0, 1, 20_000)
    bounds = tuple(np.linspace(0.01, 1.0, 100))
    hs = [m.Histogram(bounds=bounds) for m in (jmetrics, tmetrics)]
    for h in hs:
        for x in xs:
            h.observe(x)
    j, t = hs
    for p in (0.01, 0.5, 0.95, 0.99, 1.0):
        assert t.percentile(p) == j.percentile(p)
    assert t.summary() == j.summary()
    assert abs(t.percentile(0.95) - 0.95) < 0.02 and t.count == 20_000


def test_histogram_small_sample_clamps_to_observed():
    h = tmetrics.Histogram(bounds=(0.1, 1.0, 10.0))
    h.observe(0.35)
    assert h.percentile(0.5) == pytest.approx(0.35)
    assert h.percentile(0.99) == pytest.approx(0.35)
    assert np.isnan(tmetrics.Histogram(bounds=(0.1, 1.0)).percentile(0.5))


def test_registry_aggregation_and_renderings_equal_reference():
    def fill(met):
        reg = met.MetricsRegistry(buckets=(0.1, 1.0))
        reg.histogram("lat", "a").observe(0.05)
        reg.histogram("lat", "b").observe(5.0)
        reg.counter("served", "a").inc(3)
        reg.counter("served", "b").inc(4)
        reg.counter("requests_served", "a").inc(3)
        reg.counter("requests_rejected").inc()
        reg.gauge("queue_depth", "a").set(5)
        h = reg.histogram("latency_seconds", "a")
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        return reg
    j, t = fill(jmetrics), fill(tmetrics)
    assert t.total("served") == j.total("served") == 7
    assert t.render() == j.render()
    txt = t.render_prometheus()
    assert txt == j.render_prometheus()
    assert "served{a} 3" in t.render() and "lat{ALL}" in t.render()
    assert 'prefillonly_latency_seconds_bucket{instance="a",le="1"} 2' in txt
    assert "prefillonly_requests_rejected 1" in txt and txt.endswith("\n")


def test_counter_thread_safety():
    c = tmetrics.MetricsRegistry().counter("n")
    threads = [threading.Thread(target=lambda: [c.inc() for _ in range(1000)])
               for _ in range(8)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert c.value == 8000


def test_metrics_http_endpoint_serves_the_reference_body():
    bodies = []
    for met, start in ((jmetrics, j_start_metrics),
                       (tmetrics, start_metrics_server)):
        reg = met.MetricsRegistry()
        reg.counter("requests_served", "a").inc(7)
        reg.histogram("latency_seconds", "a").observe(0.2)
        server = start(reg, port=0)
        try:
            host, port = server.server_address
            with urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                        timeout=5) as resp:
                assert resp.status == 200
                assert "text/plain" in resp.headers["Content-Type"]
                bodies.append(resp.read().decode())
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(f"http://{host}:{port}/nope",
                                       timeout=5)
        finally:
            server.shutdown()
            server.server_close()
    assert bodies[1] == bodies[0]
    assert 'prefillonly_requests_served{instance="a"} 7' in bodies[1]


# ---- routers ----------------------------------------------------------------

def _engines(pool):
    return {n: pool.engines[n] for n in pool.live_names()}


def test_user_hash_router_equals_reference():
    pool = _pool(PORT, 3)
    engines = _engines(pool)
    for u in range(40):
        kw = dict(user_id=f"u{u}", n_input=10, chain=(), instances=engines)
        picks = {trouter.UserHashRouter().route(**kw) for _ in range(3)}
        assert picks == {jrouter.UserHashRouter().route(**kw)}
        assert picks == {tft.rendezvous_hash(f"u{u}", sorted(engines))}


def test_least_backlog_routes_equal_reference():
    """Backlogs, cache affinity and ties: every route equals the
    reference's on the same engines."""
    tokens = list(range(64))
    chain = token_chain(tokens, 16)
    pool = tft.InstancePool(lambda name: FakeEngine(
        name, cached_chains=[chain] if name in ("i1", "i3") else []))
    pool.scale_to(["i0", "i1", "i2", "i3"])
    engines = _engines(pool)
    routers = [jrouter.LeastBacklogRouter(), trouter.LeastBacklogRouter()]
    rng = np.random.default_rng(3)
    for step in range(30):
        if step % 3 == 0:     # grow one instance's backlog
            engines[f"i{rng.integers(4)}"].submit(
                list(range(int(rng.integers(10, 200)))))
        for c in (chain, ()):
            kw = dict(user_id=f"u{step}", n_input=int(rng.integers(10, 120)),
                      chain=c, instances=engines)
            assert routers[1].route(**kw) == routers[0].route(**kw)
    empty = _pool(PORT, 2)
    for _ in range(3):
        empty.engines["i0"].submit(list(range(100)))
    assert [routers[1].route(user_id="u", n_input=50, chain=(),
                             instances=_engines(empty))
            for _ in range(5)] == ["i1"] * 5


def test_least_backlog_cache_affinity_tie_break():
    chain = token_chain(list(range(64)), 16)
    pool = tft.InstancePool(lambda name: FakeEngine(
        name, cached_chains=[chain] if name == "i1" else []))
    pool.scale_to(["i0", "i1", "i2"])
    r = trouter.LeastBacklogRouter()
    assert [r.route(user_id="u9", n_input=64, chain=chain,
                    instances=_engines(pool)) for _ in range(5)] == ["i1"] * 5
    assert len({r.route(user_id="u9", n_input=64, chain=(),
                        instances=_engines(pool)) for _ in range(5)}) == 1


def test_get_router_factory():
    assert isinstance(trouter.get_router("user_hash"),
                      trouter.UserHashRouter)
    assert isinstance(trouter.get_router("least_backlog",
                                         affinity_tol=0.3),
                      trouter.LeastBacklogRouter)
    with pytest.raises(KeyError):
        trouter.get_router("nope")


def test_least_backlog_probes_with_per_blocksize_chains():
    tokens = list(range(64))
    pool = _pool(PORT, 2)
    warm = pool.engines["i1"]
    warm.ecfg = _BS8()
    chain8 = token_chain(tokens, 8)
    warm.cached.add(tuple(chain8))
    chains = {16: token_chain(tokens, 16), 8: chain8}
    kw = dict(user_id="u", n_input=64, chain=chains[16],
              instances=_engines(pool), chains=chains)
    assert trouter.LeastBacklogRouter().route(**kw) == "i1" == \
        jrouter.LeastBacklogRouter().route(**kw)
    assert trouter.chain_for(warm, chains[16], chains) == chain8
    assert warm.cached_prefix_len(chains[16]) == 0


# ---- admission --------------------------------------------------------------

def test_admission_verdicts_equal_reference():
    rng = np.random.default_rng(1)
    ctrls = [(m.AdmissionController(max_input_tokens=500,
                                    deadline_slack=s),
              s) for m in (jadm, tadm) for s in (1.0, 2.0)]
    for _ in range(300):
        n = int(rng.integers(1, 700))
        now = float(rng.uniform(0, 100))
        dl = None if rng.random() < 0.2 else now + float(rng.uniform(0, 5))
        wait, jct = (float(x) for x in rng.uniform(0, 3, 2))
        got = [c.check(n, dl, now, wait, jct, user_id="u") for c, _ in ctrls]
        for a, b in ((got[0], got[2]), (got[1], got[3])):
            assert (a is None) == (b is None)
            if a is not None:
                assert dataclasses.asdict(b) == dataclasses.asdict(a)
    assert [(c.rejected_infeasible, c.rejected_deadline)
            for c, _ in ctrls[2:]] == [(c.rejected_infeasible,
                                        c.rejected_deadline)
                                       for c, _ in ctrls[:2]]


def _ref_chip(port):
    return jhw.ChipSpec(**{f.name: getattr(port, f.name)
                           for f in dataclasses.fields(port)})


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-3-8b"])
def test_admission_mil_from_memory_model(arch):
    for kv_keep in (None, 4096):
        t = tadm.AdmissionController(memory_model=MemoryModel(
            get_config(arch), H100_SXM), kv_keep=kv_keep)
        j = jadm.AdmissionController(memory_model=JMemoryModel(
            j_get_config(arch), _ref_chip(H100_SXM)), kv_keep=kv_keep)
        assert t.max_input_tokens == j.max_input_tokens > 0
        assert t.check(t.max_input_tokens + 1, None, 0, 0, 0).reason == \
            "infeasible"
        assert t.check(t.max_input_tokens, None, 0, 0, 0) is None


def test_admission_slack_feedback_equals_reference():
    rng = np.random.default_rng(2)
    outcomes = (rng.random(400) < np.repeat([0.3, 0.0, 0.15, 0.0], 100))
    regs = [jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()]
    ctrls = [m.AdmissionController(deadline_slack=1.0, adapt_window=10,
                                   shed_target=0.1, adapt_rate=2.0,
                                   max_slack=4.0, metrics=r)
             for m, r in zip((jadm, tadm), regs)]
    trail = [[], []]
    for shed in outcomes:
        for c, tr in zip(ctrls, trail):
            c.record_outcome(shed=bool(shed))
            tr.append(c.deadline_slack)
    assert trail[1] == trail[0]
    assert ctrls[1].slack_adjustments == ctrls[0].slack_adjustments > 1
    assert regs[1].render_prometheus() == regs[0].render_prometheus()
    off = tadm.AdmissionController(deadline_slack=1.0, adapt=False,
                                   adapt_window=2)
    for _ in range(10):
        off.record_outcome(shed=True)
    assert off.deadline_slack == 1.0
    cap = tadm.AdmissionController(deadline_slack=3.0, adapt_window=4,
                                   shed_target=0.0, adapt_rate=10.0,
                                   max_slack=4.0)
    for _ in range(8):
        cap.record_outcome(shed=True)
    assert cap.deadline_slack == pytest.approx(4.0)


# ---- server over fake engines: both packages --------------------------------

def test_server_serves_and_rejects_typed():
    def run(pkg):
        srv = pkg.server.AsyncServer(
            _pool(pkg, 2), router=pkg.router.get_router("least_backlog"),
            admission=pkg.adm.AdmissionController(max_input_tokens=500))
        srv.start()
        try:
            futs = [srv.submit(f"u{i}", list(range(20 + i)))
                    for i in range(10)]
            futs.append(srv.submit("big", list(range(501))))
            futs.append(srv.submit("late", list(range(50)),
                                   deadline=time.perf_counter() - 1.0))
            assert srv.drain(timeout=10)
            out = [f.result(timeout=1) for f in futs]
            assert all("latency" in o for o in out[:10])
            return (_kinds(out), srv.metrics.total("requests_served"),
                    srv.metrics.total("requests_rejected"))
        finally:
            srv.shutdown()
    got, want = _twin(run)
    assert got == want
    assert got == (["served"] * 10 + ["infeasible", "deadline"], 10, 2)


def test_server_sheds_queued_requests_whose_deadline_becomes_unreachable():
    pool = _pool(PORT, 1, sec_per_token=1e-2)
    srv = tserver.AsyncServer(pool, router=trouter.get_router("user_hash"),
                              admission=tadm.AdmissionController())
    srv.start()
    try:
        now = time.perf_counter()
        futs = [srv.submit("u", list(range(100)), deadline=now + 1.5)
                for _ in range(4)]
        assert srv.drain(timeout=15)
        kinds = _kinds([f.result(timeout=1) for f in futs])
        assert "served" in kinds and set(kinds) - {"served"}
        assert set(kinds) <= {"served", "shed", "deadline"}
    finally:
        srv.shutdown()


def test_server_cancel_queued_request():
    def run(pkg):
        pool = _pool(pkg, 1, sec_per_token=1e-2)
        srv = pkg.server.AsyncServer(pool,
                                     router=pkg.router.get_router("user_hash"))
        srv.start()
        try:
            futs = [srv.submit("u", list(range(100))) for _ in range(3)]
            with pool.engines["i0"].lock:
                queued = [r.req_id for r in pool.engines["i0"].queue]
            assert queued and srv.cancel(queued[-1])
            assert srv.drain(timeout=15)
            return _kinds([f.result(timeout=1) for f in futs])
        finally:
            srv.shutdown()
    got, want = _twin(run)
    assert got == want == ["served", "served", "cancelled"]


def test_server_mark_failed_requeues_to_peers():
    def run(pkg):
        pool = _pool(pkg, 3, sec_per_token=2e-3)
        srv = pkg.server.AsyncServer(pool,
                                     router=pkg.router.get_router("user_hash"))
        srv.start()
        try:
            futs = [srv.submit(f"u{i}", list(range(60))) for i in range(24)]
            srv.mark_failed(pool.live_names()[0])
            assert srv.drain(timeout=20)
            return _kinds([f.result(timeout=1) for f in futs]), \
                pool.live_names()
        finally:
            srv.shutdown()
    got, want = _twin(run)
    assert got == want and got[0] == ["served"] * 24


@pytest.mark.parametrize("how", ["mark_failed", "scale_to_empty"])
def test_losing_the_last_instance_rejects_stranded_futures(how):
    def run(pkg):
        pool = _pool(pkg, 1, sec_per_token=1e-2)
        srv = pkg.server.AsyncServer(pool,
                                     router=pkg.router.get_router("user_hash"))
        srv.start()
        try:
            futs = [srv.submit("u", list(range(100))) for _ in range(4)]
            if how == "mark_failed":
                srv.mark_failed("i0")
            else:
                srv.scale_to([])
            assert srv.drain(timeout=10)
            kinds = _kinds([f.result(timeout=5) for f in futs])
            return set(kinds) - {"served"}, "no_instances" in kinds
        finally:
            srv.shutdown()
    got, want = _twin(run)
    assert got == want == ({"no_instances"}, True)


def test_server_worker_crash_fails_instance_and_requeues():
    def run(pkg):
        pool = _pool(pkg, 2, sec_per_token=5e-3)
        crashing = pool.engines["i0"]
        orig_step = crashing.step

        def bad_step():
            if crashing.queue:
                raise RuntimeError("chip fell over")
            return orig_step()

        crashing.step = bad_step
        srv = pkg.server.AsyncServer(pool,
                                     router=pkg.router.get_router("user_hash"))
        srv.start()
        try:
            futs = [srv.submit(f"u{i}", list(range(40))) for i in range(12)]
            assert srv.drain(timeout=20)
            return (_kinds([f.result(timeout=1) for f in futs]),
                    pool.live_names(), srv.metrics.total("engine_errors"))
        finally:
            srv.shutdown()
    got, want = _twin(run)
    assert got == want == (["served"] * 12, ["i1"], 1)


def test_server_scale_down_rehomes_queued_requests():
    def run(pkg):
        pool = _pool(pkg, 2, sec_per_token=1e-2)
        srv = pkg.server.AsyncServer(pool,
                                     router=pkg.router.get_router("user_hash"))
        srv.start()
        try:
            futs = [srv.submit(f"u{i}", list(range(50))) for i in range(8)]
            srv.scale_to(["i0"])
            assert "i1" not in pool.engines
            assert srv.drain(timeout=20)
            return _kinds([f.result(timeout=1) for f in futs])
        finally:
            srv.shutdown()
    got, want = _twin(run)
    assert got == want == ["served"] * 8


def test_submit_chain_cut_at_routed_engines_block_size():
    uid = next(u for u in (f"u{i}" for i in range(50))
               if tft.rendezvous_hash(u, ["i0", "i1"]) == "i1")
    pool = _pool(PORT, 2)
    pool.engines["i1"].ecfg = _BS8()
    srv = tserver.AsyncServer(pool, router=trouter.get_router("user_hash"))
    srv._accepting = True                 # accept without starting workers
    tokens = list(range(32))
    srv.submit(uid, tokens)
    r = pool.engines["i1"].queue[0]
    assert tuple(r.chain) == token_chain(tokens, 8) == j_token_chain(tokens,
                                                                      8)


def test_drain_rechains_requests_across_block_sizes():
    pool = _pool(PORT, 2, sec_per_token=1e-2)
    pool.engines["i1"].ecfg = _BS8()
    tokens = list(range(32))
    pool.engines["i0"].submit(tokens, chain=token_chain(tokens, 16))
    pool.mark_failed("i0")
    assert tuple(pool.engines["i1"].queue[0].chain) == token_chain(tokens, 8)


@pytest.mark.parametrize("drain", [True, False])
def test_server_shutdown_rejects_queued(drain):
    pool = _pool(PORT, 1, sec_per_token=1e-2)
    srv = tserver.AsyncServer(pool, router=trouter.get_router("user_hash"))
    srv.start()
    futs = [srv.submit("u", list(range(100))) for _ in range(6)]
    srv.shutdown(drain=drain, timeout=0.05 if drain else None)
    kinds = _kinds([f.result(timeout=5) for f in futs])
    assert all(f.done() for f in futs) and "shutdown" in kinds
    assert srv.submit("u", [1, 2]).result(timeout=1).reason == "shutdown"


def test_concurrent_submit_soak_every_request_resolves_exactly_once():
    """4 submitter threads x 60 requests against 3 instances; every future
    resolves exactly once, and the counters agree with the outcomes."""
    srv = tserver.AsyncServer(
        _pool(PORT, 3, sec_per_token=2e-5),
        router=trouter.get_router("least_backlog"),
        admission=tadm.AdmissionController(max_input_tokens=400))
    srv.start()
    resolutions, futs = [], []
    lock = threading.Lock()

    def submitter(tid):
        rng = np.random.default_rng(tid)
        for i in range(60):
            n = 450 if i % 17 == 0 else int(rng.integers(10, 300))
            deadline = (time.perf_counter() - 1.0) if i % 23 == 0 else None
            f = srv.submit(f"u{tid}_{i % 7}", list(range(n)),
                           deadline=deadline)
            f.add_done_callback(lambda f: resolutions.append(f.result(0)))
            with lock:
                futs.append(f)

    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(4)]
    [t.start() for t in threads]
    [t.join(timeout=60) for t in threads]
    try:
        assert srv.drain(timeout=30), "soak drain timed out"
        assert len(futs) == 240 and all(f.done() for f in futs)
        assert len(resolutions) == 240
        rejected = [r for r in resolutions if _rejected(r)]
        assert len(rejected) >= 4 * (60 // 17)
        assert srv.metrics.total("requests_served") == 240 - len(rejected)
        assert srv.metrics.total("requests_rejected") == len(rejected)
    finally:
        srv.shutdown()


# ---- real engines -----------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    jcfg = j_reduce_config(j_get_config("qwen1.5-0.5b"), hybrid_chunk=0,
                           dtype="float32")
    tcfg = reduce_config(get_config("qwen1.5-0.5b"), hybrid_chunk=0,
                         dtype="float32")
    jparams = materialize(jax.random.PRNGKey(0), build(jcfg).defs(),
                          jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tree, tcfg, device="cpu")


def _engines_pair(setup, **kw):
    jcfg, tcfg, jparams, tparams = setup
    return (jengine.PrefillOnlyEngine(jcfg, jparams,
                                      jengine.EngineConfig(**kw)),
            tengine.PrefillOnlyEngine(tcfg, tparams,
                                      tengine.EngineConfig(**kw),
                                      device="cpu"))


def test_engine_config_not_shared_between_engines(setup):
    _, tcfg, _, tparams = setup
    a = tengine.PrefillOnlyEngine(tcfg, tparams, device="cpu")
    b = tengine.PrefillOnlyEngine(tcfg, tparams, device="cpu")
    assert a.ecfg is not b.ecfg
    a.ecfg.pack_token_budget = 1
    assert b.ecfg.pack_token_budget != 1


def test_engine_cancel_and_shed_as_the_reference(setup):
    got = []
    for eng in _engines_pair(setup):
        eng.jct_model.a, eng.jct_model.b = 1e-3, 0.0
        ids = [eng.submit(list(range(40))),
               eng.submit(list(range(40)),
                          deadline=time.perf_counter() - 1.0),
               eng.submit(list(range(40)),
                          deadline=time.perf_counter() + 1000.0)]
        first = eng.cancel(ids[0]) is not None
        again = eng.cancel(ids[0]) is None
        shed = [ids.index(r.req_id) for r in eng.shed_expired()]
        left = [ids.index(r.req_id) for r in eng.queue]
        got.append((first, again, shed, left))
    assert got[1] == got[0] == (True, True, [1], [2])


def test_engine_probes_track_cache_as_the_reference(setup):
    vals = []
    toks = np.random.default_rng(0).integers(0, 512, 80).tolist()
    for eng, tc in zip(_engines_pair(setup, cache_capacity_tokens=4096),
                       (j_token_chain, token_chain)):
        eng.jct_model.a, eng.jct_model.b = 1.0, 0.0
        chain = tc(toks, eng.ecfg.block_size)
        row = [eng.predict_jct(80, chain)]
        eng.submit(toks)
        row += [eng.pending_jct(), eng.inflight_snapshot()[0]]
        eng.step()
        row += [eng.cached_prefix_len(chain), eng.predict_jct(80, chain),
                eng.pending_jct(), eng.probe(80, chain), eng.last_step_ids
                == [eng.results[next(iter(eng.results))]["req_id"]],
                eng.inflight_snapshot()]
        vals.append(row)
    assert vals[1] == vals[0]
    assert vals[1][:3] == [80.0, 80.0, []]
    assert vals[1][3:6] == [80, 16.0, 0.0] and vals[1][7]


def test_engine_autotune_packing_formula(setup):
    got = []
    for eng in _engines_pair(setup):
        eng.jct_model.a, eng.jct_model.b = 1e-4, 1e-1
        first = eng.autotune_packing(ref_len=512)
        eng.jct_model.b = 0.0
        got.append((first, eng.autotune_packing(ref_len=512),
                    eng.ecfg.pack_token_budget, eng.ecfg.pack_prefix_budget))
    assert got[1] == got[0]
    assert got[1][0] == (1024, 16) and got[1][1][0] == 1024


def test_async_server_end_to_end_real_engines(setup):
    """Both packages' servers over two real engines each: the same
    requests are served with the same scores (f32, 1e-4), and the port's
    registry holds the engines' series."""
    jcfg, tcfg, jparams, tparams = setup
    rng = np.random.default_rng(1)
    reqs = [(f"u{i % 3}", rng.integers(0, 512, 48).tolist())
            for i in range(6)]
    results = []
    for pkg, make in (
            (REF, lambda n: jengine.PrefillOnlyEngine(
                jcfg, jparams, jengine.EngineConfig(
                    cache_capacity_tokens=2048))),
            (PORT, lambda n: tengine.PrefillOnlyEngine(
                tcfg, tparams, tengine.EngineConfig(
                    cache_capacity_tokens=2048), device="cpu"))):
        pool = pkg.ft.InstancePool(make)
        pool.scale_to(["a", "b"])
        srv = pkg.server.AsyncServer(
            pool, router=pkg.router.get_router("least_backlog"),
            admission=pkg.adm.AdmissionController())
        srv.start()
        try:
            futs = [srv.submit(u, t, allowed_tokens=(YES, NO))
                    for u, t in reqs]
            assert srv.drain(timeout=120)
            out = [f.result(timeout=1) for f in futs]
            assert srv.metrics.total("requests_served") == 6
            assert srv.metrics.merged_histogram("latency_seconds").count == 6
            results.append((out, srv.metrics))
        finally:
            srv.shutdown()
    (want, _), (got, reg) = results
    for g, w in zip(got, want):
        assert not _rejected(g) and set(g["scores"]) == {YES, NO}
        assert abs(sum(g["scores"].values()) - 1.0) < 1e-6
        for t in (YES, NO):
            assert abs(g["scores"][t] - w["scores"][t]) < F32_TOL
    assert reg.total("pack_solo_steps") + reg.total("pack_miss_steps") \
        + reg.total("pack_hit_steps") >= 1
    assert reg.merged_histogram("batch_wall_seconds").count >= 1
    assert reg.gauge("jct_coef_a", "a").value == reg.gauge(
        "jct_coef_a", "b").value


def test_server_feeds_shed_outcomes_back_to_admission(setup):
    _, tcfg, _, tparams = setup
    pool = tft.InstancePool(lambda name: tengine.PrefillOnlyEngine(
        tcfg, tparams, device="cpu"))
    pool.scale_to(["a"])
    ctrl = tadm.AdmissionController(adapt_window=2, shed_target=0.0,
                                    adapt_rate=1.5)
    srv = tserver.AsyncServer(pool, admission=ctrl)
    assert ctrl.metrics is srv.metrics
    eng = pool.engines["a"]
    srv.start()
    try:
        rng = np.random.default_rng(2)
        f = srv.submit("u", rng.integers(0, 512, 32).tolist(),
                       allowed_tokens=(YES, NO),
                       deadline=time.perf_counter() + 300.0)
        assert srv.drain(timeout=120)
        assert not _rejected(f.result(timeout=1))
        assert list(ctrl._outcomes) == [False]
        for _ in range(2):
            eng.submit(rng.integers(0, 512, 16).tolist(),
                       deadline=time.perf_counter() - 1.0)
        stop = time.time() + 30
        while ctrl.slack_adjustments == 0 and time.time() < stop:
            time.sleep(0.01)
        assert ctrl.slack_adjustments >= 1 and ctrl.deadline_slack > 1.0
        assert srv.metrics.counter("admission_slack_tightened").value >= 1
        assert srv.metrics.gauge("admission_deadline_slack").value > 1.0
    finally:
        srv.shutdown(drain=False)
