"""The port's launcher (``repro_torch.launch.serve``, thread mode) and the
engine's serving telemetry against the JAX package's.

* ``serve_trace`` of both packages replays one reduced post-recommendation
  trace through two f32 engines each (user-hash routing, admission on):
  the same requests are served with the same scores (1e-4), the same
  served counts and reject reasons.
* Over the same steps, a reference and a port engine bound to a registry
  and a tracer emit the same metric names and counter values (walls
  excluded) and the same spans and events per request, ``restore`` and
  ``prefetch`` included on a tiered engine.
* A tiered port engine behind ``AsyncServer`` triggers the route-time
  prefetch, as the reference's does.
* ``make_pool`` builds instances over one set of weights, on the card by
  default; process mode raises.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
import repro_torch.launch.serve as tserve
from repro.configs import get_config as j_get_config
from repro.configs import reduce_config as j_reduce_config
from repro.core import engine as jengine
from repro.core.prefix_cache import token_chain as j_token_chain
from repro.models.model import build
from repro.runtime import fault_tolerance as jft
from repro.runtime.sharding import materialize
from repro.serving import admission as jadm
from repro.serving import metrics as jmetrics
from repro.serving import server as jserver
from repro.serving import tracing as jtracing
from repro_torch.configs import get_config, reduce_config
from repro_torch.core.kv_policy import MemoryModel
from repro_torch.data.workloads import get_trace
from repro_torch.core import engine as tengine
from repro_torch.core.prefix_cache import token_chain
from repro_torch.launch import smoke as tsmoke
from repro_torch.models.params import params_from_numpy
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.runtime.hw import H100_SXM
from repro_torch.serving import admission as tadm
from repro_torch.serving import metrics as tmetrics
from repro_torch.serving import server as tserver
from repro_torch.serving import tracing as ttracing

F32_TOL = 1e-4
YES, NO = 5, 9
ARCH = "qwen1.5-0.5b"
ROOT = pathlib.Path(__file__).resolve().parents[1]
# the offload twins' engine settings (tests/test_torch_offload.py TIER): a
# 4-block device cache, solo steps, fine reuse granularity, a link priced
# huge so that restores win on the CPU
TIER = dict(cache_capacity_tokens=64, offload=True, offload_host_bw=1e18,
            prefix_bucket_blocks=1, max_pack_requests=1)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_reduce_config(j_get_config(ARCH), hybrid_chunk=0,
                           dtype="float32")
    tcfg = reduce_config(get_config(ARCH), hybrid_chunk=0, dtype="float32")
    jparams = materialize(jax.random.PRNGKey(0), build(jcfg).defs(),
                          jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, tree


def _pair(setup, **kw):
    jcfg, tcfg, jparams, tree = setup
    return (jengine.PrefillOnlyEngine(jcfg, jparams,
                                      jengine.EngineConfig(**kw)),
            tengine.PrefillOnlyEngine(tcfg, params_from_numpy(
                tree, tcfg, device="cpu"), tengine.EngineConfig(**kw),
                device="cpu"))


def _recording(server_cls, log):
    """``server_cls`` that keeps every submitted future in ``log``."""
    class Recording(server_cls):
        def submit(self, user_id, tokens, **kw):
            fut = super().submit(user_id, tokens, **kw)
            log.append(fut)
            return fut
    return Recording


# ---- serve_trace, both packages -------------------------------------------

def test_serve_trace_matches_reference(setup, monkeypatch):
    jcfg, tcfg, jparams, tree = setup
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    ecfg = dict(cache_capacity_tokens=4096)
    pools = (jft.InstancePool(lambda n: jengine.PrefillOnlyEngine(
        jcfg, jparams, jengine.EngineConfig(**ecfg))),
        tft.InstancePool(lambda n: tengine.PrefillOnlyEngine(
            tcfg, tparams, tengine.EngineConfig(**ecfg), device="cpu")))
    futs = ([], [])
    # no watchdog: a CPU host's step times vary with its load, and a trip
    # (a retry, an instance failed) would differ between the two runs; the
    # chaos twins hold the watchdog
    kw = dict(qps=40.0, n_instances=2, scale_tokens=0.02, seed=0,
              max_requests=12, router="user_hash", admission=True,
              metrics_port=0, drain_timeout=120.0, watchdog=False)
    outs = []
    for mod, srv_mod, pool, log in ((jserve, jserver, pools[0], futs[0]),
                                    (tserve, tserver, pools[1], futs[1])):
        pool.scale_to(["inst0", "inst1"])
        monkeypatch.setattr(mod, "AsyncServer",
                            _recording(srv_mod.AsyncServer, log))
        outs.append(mod.serve_trace(ARCH, pool=pool, **kw))
    want, got = outs
    for k in ("requests", "served", "rejected", "reject_reasons",
              "preempted", "retried", "watchdog_trips"):
        assert got[k] == want[k], k
    assert got["served"] == got["requests"] == 12
    assert [f.result() for f in futs[1]] == got["outcomes"]
    for g, w in zip(got["outcomes"], (f.result() for f in futs[0])):
        assert g["n_input"] == w["n_input"]
        for t in (YES, NO):
            assert abs(g["scores"][t] - w["scores"][t]) < F32_TOL
    assert 0.0 < got["token_hit_rate"] < 1.0
    server = got["server"]
    assert server.tracer.stats()["finished"] == 12
    series = tsmoke.parse_prometheus(server.metrics.render_prometheus())
    tsmoke.validate_histograms(series)
    for name in ("requests_served", "latency_seconds_bucket",
                 "batch_wall_seconds_bucket", "step_padding_waste",
                 "queue_depth", "backlog_seconds", "jct_coef_a"):
        assert f"prefillonly_{name}" in series, name
    tsmoke.validate_trace_jsonl(server.tracer.dump_jsonl())
    assert tsmoke.validate_chrome(server.tracer.chrome_trace()) >= 3 * 12


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _served(text: str) -> float:
    return sum(x["value"] for x in tsmoke.parse_prometheus(text).get(
        "prefillonly_requests_served", []))


def test_serve_trace_scrapes_during_the_replay(setup):
    """The ``/metrics``, ``/trace`` and ``/trace.chrome.json`` endpoints
    answer while a replay runs (a scraper polls ``/metrics`` on the port
    given until two requests are served) with what the strict validators
    accept."""
    _, tcfg, _, tree = setup
    pool = tserve.make_pool(ARCH, 1, device="cpu", params=tree,
                            ecfg=dict(max_pack_requests=1))
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    got = {}

    def scrape():
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(base + "/metrics",
                                            timeout=10) as r:
                    if _served(r.read().decode()) >= 2:
                        break
            except OSError:             # not listening yet
                pass
            time.sleep(0.01)
        for path in ("/metrics", "/trace", "/trace.chrome.json"):
            with urllib.request.urlopen(base + path, timeout=10) as r:
                got[path] = r.read().decode()

    th = threading.Thread(target=scrape, daemon=True)
    th.start()
    out = tserve.serve_trace(ARCH, pool=pool, qps=20.0, max_requests=6,
                             metrics_port=port, drain_timeout=120.0)
    th.join(timeout=60)
    assert out["served"] == 6
    assert _served(got["/metrics"]) >= 2
    tsmoke.validate_histograms(tsmoke.parse_prometheus(got["/metrics"]))
    tsmoke.validate_trace_jsonl(got["/trace"])
    tsmoke.validate_chrome(json.loads(got["/trace.chrome.json"]))


def test_write_trace_dump(tmp_path):
    tr = ttracing.SpanTracer()
    ctx = tr.begin(rid=3, user_id="u", n_input=8)
    t = time.perf_counter()
    tr.event(ctx, "route", instance="i0")
    tr.event(ctx, "enqueue", instance="i0", req_id=3)
    tr.span_rid(3, "queue", t, t + 1e-4, instance="i0")
    tr.span_rid(3, "execute", t + 1e-4, t + 2e-4, instance="i0")
    time.sleep(0.005)
    tr.finish(ctx, "delivered")
    cp = tserve.write_trace_dump(tr, tmp_path / "d" / "trace.jsonl")
    assert cp.name == "trace.chrome.json"
    tsmoke.validate_trace_jsonl((tmp_path / "d" / "trace.jsonl").read_text())
    assert tsmoke.validate_chrome(json.loads(cp.read_text())) == 2


# ---- make_pool, warm_pool, defaults ---------------------------------------

def test_make_pool_shares_one_weight_set(setup):
    _, tcfg, _, tree = setup
    pool = tserve.make_pool(ARCH, 3, device="cpu", params=tree,
                            cache_tokens=2048, ecfg=dict(
                                graph_memory_bytes=1 << 20,
                                max_pack_requests=4))
    engs = [pool.engines[f"inst{i}"] for i in range(3)]
    assert pool.live_names() == ["inst0", "inst1", "inst2"]
    for e in engs:
        assert e.device.type == "cpu"
        assert e.ecfg.cache_capacity_tokens == 2048
        assert e.ecfg.graph_memory_bytes == 1 << 20
        assert e.ecfg.max_pack_requests == 4
        assert e.params["embed"]["tok"].data_ptr() == \
            engs[0].params["embed"]["tok"].data_ptr()
    # the reduced config as the reference's make_pool reduces it
    assert engs[0].cfg == reduce_config(get_config(ARCH), hybrid_chunk=0)
    drawn = tserve.make_pool(ARCH, 2, device="cpu", seed=3)
    a, b = (drawn.engines[n].params["blocks"]["attn"]["wq"]
            for n in ("inst0", "inst1"))
    assert a.data_ptr() == b.data_ptr()
    again = tserve.make_pool(ARCH, 1, device="cpu", seed=3)
    assert torch.equal(again.engines["inst0"].params["blocks"]["attn"]["wq"],
                       a)


def test_instance_chip_is_each_instance_share_of_the_card(setup):
    """One instance holding nothing sees the whole card; N instances that
    each run a request at their MIL, with their prefix caches full and
    their forwards at their bound, fit the card together with the one set
    of weights they share."""
    _, tcfg, _, tree = setup
    bare = tserve.make_pool(ARCH, 1, device="cpu", params=tree,
                            cache_tokens=0, ecfg=dict(graph_memory_bytes=0))
    assert tserve.instance_chip(bare) == H100_SXM
    for n in (1, 2, 4):
        pool = tserve.make_pool(ARCH, n, device="cpu", params=tree,
                                cache_tokens=140_000,
                                ecfg=dict(graph_memory_bytes=10 << 30))
        share = tserve.instance_chip(pool)
        full = MemoryModel(tcfg, H100_SXM)
        mm = MemoryModel(tcfg, share)
        mil = mm.max_input_length("hybrid")
        held = 140_000 * full.kv_all_per_token + (10 << 30)
        assert share.hbm_bytes == pytest.approx(
            full.weights_bytes + (H100_SXM.hbm_bytes - full.weights_bytes) / n
            - held)
        working = mm.peak_bytes(mil, "hybrid") - mm.weights_bytes
        assert (full.weights_bytes + n * (working + held)
                <= H100_SXM.hbm_bytes)
        assert mil < full.max_input_length("hybrid")


def test_serve_trace_admits_up_to_each_instance_share(setup):
    """Two instances whose held memory leaves each room for a request of
    about the trace's median length: ``serve_trace``'s admission rejects
    every longer request as infeasible and serves the rest."""
    _, tcfg, _, tree = setup
    kw = dict(qps=40.0, scale_tokens=0.02, seed=0, max_requests=12)
    trace = get_trace("post_recommendation", kw["qps"],
                      scale_tokens=kw["scale_tokens"],
                      materialize_tokens=True, vocab=512, seed=0)
    lengths = [len(r.tokens) for r in trace.requests[:12]]
    target = sorted(lengths)[6]
    mm = MemoryModel(tcfg, H100_SXM)
    cache = 4096 * mm.kv_all_per_token
    # the share that prices the MIL at ``target``: the weights and the
    # working set at ``target`` in 0.9 of it (MemoryModel's utilisation)
    want = mm.peak_bytes(target, "hybrid") / 0.9
    graphs = int(mm.weights_bytes + (H100_SXM.hbm_bytes - mm.weights_bytes)
                 / 2 - cache - want)
    pool = tserve.make_pool(ARCH, 2, device="cpu", params=tree,
                            ecfg=dict(graph_memory_bytes=graphs))
    out = tserve.serve_trace(ARCH, pool=pool, router="user_hash",
                             watchdog=False, drain_timeout=120.0, **kw)
    mil = out["server"].admission.max_input_tokens
    assert abs(mil - target) <= 1
    longer = sum(n > mil for n in lengths)
    assert 0 < longer < 12
    assert out["reject_reasons"] == {"infeasible": longer}
    assert out["served"] == 12 - longer


def test_entry_points_serve_on_the_card_by_default():
    if torch.cuda.is_available():
        pool = tserve.make_pool(ARCH, 1)
        assert pool.engines["inst0"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.make_pool(ARCH, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.serve_trace(ARCH, max_requests=1)


def test_process_mode_raises(monkeypatch, capsys):
    with pytest.raises(NotImplementedError, match="A5b"):
        tserve.serve_trace(ARCH, workers=2)
    monkeypatch.setattr(sys, "argv", ["serve", "--workers", "2",
                                      "--device", "cpu"])
    with pytest.raises(SystemExit) as e:
        tserve.main()
    assert e.value.code == 2 and "A5b" in capsys.readouterr().err


def test_warm_pool_leaves_no_first_use_to_the_replay(setup):
    _, tcfg, _, tree = setup
    rng = np.random.default_rng(4)
    prof = rng.integers(0, 512, 150).tolist()
    lists = [prof + rng.integers(0, 512, n).tolist() for n in (5, 9, 7)]
    lists.append(rng.integers(0, 512, 300).tolist())
    pool = tserve.make_pool(ARCH, 2, device="cpu", params=tree,
                            ecfg=dict(max_pack_requests=1))
    steps = tserve.warm_pool(pool, lists, 512)
    assert steps == 2 * len(lists)
    for eng in pool.engines.values():
        n0 = len(eng.batch_records)
        for toks in lists:
            eng.submit(toks, allowed_tokens=(YES, NO))
            eng.run_until_drained()
        recs = list(eng.batch_records)[n0:]
        assert [r.n_requests for r in recs] == [1] * len(lists)
        assert not any(r.compiled for r in recs)
        assert [eng.results[i]["n_cached"] > 0 for i in
                [r.req_ids[0] for r in recs]] == [False, True, True, False]


# ---- the engine's serving telemetry, both packages ------------------------

def _telemetry_run(eng, mods, chains, trace):
    """Bind a registry and tracer to ``eng``, serve ``trace`` (a list of
    (tokens, prefetch first?) requests, one step each) with a timeline per
    request; returns per-request (span names, event names), the registry
    and the results."""
    metrics, tracing, token_chain_ = mods
    reg, tr = metrics.MetricsRegistry(), tracing.SpanTracer()
    eng.bind_telemetry(metrics=reg, instance="i0", tracer=tr)
    res = []
    for toks, prefetch in trace:
        rid = eng.submit(toks, allowed_tokens=(YES, NO))
        tr.begin(rid=rid, user_id="u", n_input=len(toks))
        if prefetch:
            assert eng.prefetch_prefix(token_chain_(toks, 16), rid=rid) > 0
            for th in threading.enumerate():
                if th.name == "kv-prefetch":
                    th.join(timeout=60)
        assert eng.step() == rid
        res.append(eng.results.pop(rid))
        tr.finish_rid(rid, "delivered")
    timelines = [([s["name"] for s in r["spans"]],
                  [e["name"] for e in r["events"]]) for r in tr.snapshot()]
    return timelines, reg, res


def _series(reg):
    """Counter values, gauges apart from the JCT fit's, and every
    histogram's count (its sum too where it holds no wall time)."""
    out = {}
    for row in reg.dump_state():
        key = (row["kind"], row["name"], row["instance"])
        if row["kind"] == "counter":
            out[key] = row["value"]
        elif row["kind"] == "gauge":
            out[key] = (None if row["name"].startswith("jct_")
                        else row["value"])
        elif row["kind"] == "hist":
            timed = row["name"].endswith("seconds") or "jct" in row["name"]
            out[key] = (row["count"],
                        None if timed else round(row["sum"], 12))
        else:
            out[key] = row["value"]
    return out


def test_engine_telemetry_matches_reference(setup):
    """The same steps on a reference and a port engine with the offload
    tier: a miss, a flood that demotes it, a hit that restores it, a
    second flood, a route-time prefetch ahead of the hit."""
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 512, 40).tolist()
    flood = [(rng.integers(0, 512, 40).tolist(), False) for _ in range(6)]
    trace = ([(toks, False)] + flood + [(toks, False)] + flood
             + [(toks, True)])
    jeng, teng = _pair(setup, **TIER)
    j_tl, j_reg, j_res = _telemetry_run(
        jeng, (jmetrics, jtracing, j_token_chain), {}, trace)
    t_tl, t_reg, t_res = _telemetry_run(
        teng, (tmetrics, ttracing, token_chain), {}, trace)
    assert t_tl == j_tl
    assert _series(t_reg) == _series(j_reg)
    for g, w in zip(t_res, j_res):
        assert g["n_cached"] == w["n_cached"]
        for t in (YES, NO):
            assert abs(g["scores"][t] - w["scores"][t]) < F32_TOL
    spans = [s for s, _ in t_tl]
    assert "restore" in spans[7] and "prefetch" in spans[-1]
    assert all({"queue", "execute", "score"} <= set(s) for s in spans)
    names = {k[1] for k in _series(t_reg)}
    assert {"kv_restore_blocks", "kv_restore_bytes", "kv_restore_seconds",
            "kv_prefetch_blocks", "kv_prefetch_bytes", "kv_prefetch_seconds",
            "host_kv_used_bytes", "kv_offload_blocks", "batch_wall_seconds",
            "step_padding_waste", "pack_solo_steps", "jct_coef_a"} <= names
    assert t_reg.counter("kv_prefetch_blocks", "i0").value > 0
    assert t_reg.counter("kv_restore_blocks", "i0").value > 0
    recs = [r.instance for r in teng.batch_records]
    assert recs and set(recs) == {"i0"}


def _prefetch_through_server(pkg_ft, pkg_server, tracing, make):
    pool = pkg_ft.InstancePool(lambda n: make())
    pool.scale_to(["i0"])
    adm = (tadm if pkg_server is tserver else jadm).AdmissionController()
    tr = tracing.SpanTracer()
    srv = pkg_server.AsyncServer(pool, admission=adm, tracer=tr).start()
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 512, 40).tolist()
    try:
        for wave in ([toks], [rng.integers(0, 512, 40).tolist()
                              for _ in range(6)], [toks]):
            for t in wave:
                assert "scores" in srv.submit("u", t, allowed_tokens=(
                    YES, NO)).result(timeout=120)
        for th in threading.enumerate():
            if th.name == "kv-prefetch":
                th.join(timeout=60)
    finally:
        srv.shutdown()
    last = tr.snapshot()[-1]
    route = next(e for e in last["events"] if e["name"] == "route")
    events = [e["name"] for e in last["events"]]
    return (srv.metrics.total("prefetches_triggered"), route["restore_s"] > 0,
            "prefetch" in events)


def test_tiered_engine_behind_the_server_prefetches_at_routing(setup):
    jcfg, tcfg, jparams, tree = setup
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    got = _prefetch_through_server(
        tft, tserver, ttracing, lambda: tengine.PrefillOnlyEngine(
            tcfg, tparams, tengine.EngineConfig(**TIER), device="cpu"))
    want = _prefetch_through_server(
        jft, jserver, jtracing, lambda: jengine.PrefillOnlyEngine(
            jcfg, jparams, jengine.EngineConfig(**TIER)))
    assert got == want == (1.0, True, True)


_REFIT_IMPORTS = """
import sys
from repro_torch.core.jct import LinearProxyJCT, PackedShapeJCT
before = set(sys.modules)
shape, linear = PackedShapeJCT(), LinearProxyJCT()
for i in range(40):
    shape.observe(100 + 7 * i, 128 << (i % 3), 1, 0, 0, 1e-3 * (1 + i))
    linear.observe(100 + 7 * i, 0, 1e-3 * (1 + i))
assert shape.fits and linear.fits, (shape.fits, linear.fits)
new = sorted(set(sys.modules) - before)
assert not new, (len(new), new[:5])
"""


def test_a_step_refit_imports_nothing():
    """The JCT models' refits, which run inside an engine step, import no
    module: a first import of ``scipy.optimize`` takes about a second, and
    the serving watchdog would time it as a wedged step."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", _REFIT_IMPORTS], env=env,
                   check=True, timeout=120)


def test_device_gate_shares_and_excludes(setup):
    """``compiled.device_lock`` excludes: an engine's step waits for
    another thread's hold before it forms its batch (nothing in flight for
    the watchdog meanwhile). ``compiled.capture_lock`` is what a prefetch
    excludes: it runs beside another engine's step (``device_lock`` held
    elsewhere), and waits for a first use."""
    from repro_torch.core import compiled
    _, tcfg, _, tree = setup
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    eng = tengine.PrefillOnlyEngine(tcfg, tparams, tengine.EngineConfig(
        **TIER), device="cpu")
    rng = np.random.default_rng(12)
    toks = rng.integers(0, 512, 40).tolist()
    held, release = threading.Event(), threading.Event()

    def peer():                       # another engine's step, in flight
        with compiled.device_lock:
            held.set()
            release.wait(10)

    p = threading.Thread(target=peer)
    p.start()
    assert held.wait(10)
    eng.submit(toks, allowed_tokens=(YES, NO))
    stepper = threading.Thread(target=eng.step)
    stepper.start()
    stepper.join(timeout=0.2)
    assert stepper.is_alive()         # waits for the peer's hold
    assert eng.inflight_snapshot()[0] == [] and len(eng.queue) == 1
    release.set()
    stepper.join(10)
    p.join(10)
    assert not eng.queue and eng.steps == 1
    for _ in range(2):                # flood: the request's blocks demote
        for t in [rng.integers(0, 512, 40).tolist() for _ in range(3)]:
            eng.submit(t, allowed_tokens=(YES, NO))
        eng.run_until_drained()
    chain = token_chain(toks, 16)
    r0 = eng.cache.restored_blocks
    held.clear()
    release.clear()
    p = threading.Thread(target=peer)
    p.start()
    assert held.wait(10)
    with compiled.capture_lock:       # a first use elsewhere
        n = eng.prefetch_prefix(chain)
        assert n > 0
        workers = [th for th in threading.enumerate()
                   if th.name == "kv-prefetch"]
        for th in workers:
            th.join(timeout=0.2)
        assert any(th.is_alive() for th in workers)
        assert eng.cache.restored_blocks == r0
    for th in workers:                # beside the peer's step
        th.join(timeout=60)
        assert not th.is_alive()
    assert eng.cache.restored_blocks == r0 + n
    release.set()
    p.join(10)
