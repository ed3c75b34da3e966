"""The port's analytic JCT models (``GridJCT``, ``RooflineJCT``,
``tp_comm_bytes_per_token``), workload traces and discrete-event simulator
held against the JAX package's on the same inputs; ``fit_roofline`` on
known parameters; then the reference's simulator behaviours
(``tests/test_simulator.py``) on the H100.

Configs and chips are bridged as in ``tests/test_torch_memory.py``. Real
numbers agree within rel 1e-12, discrete outputs (trace lengths, arrivals,
hash chains, simulator counts) exactly; a ``SimResult`` equals the
reference's field for field.
"""
import dataclasses

import pytest
from hypothesis import given, strategies as st

from repro.configs.registry import REGISTRY
from repro.core import jct as ref_jct
from repro.core import simulator as ref_sim
from repro.data import workloads as ref_wl
from repro_torch.configs import get_config
from repro_torch.core.jct import (GridJCT, LinearProxyJCT, RooflineJCT,
                                  _causal_context_sum, fit_roofline, pearson,
                                  tp_comm_bytes_per_token)
from repro_torch.core.simulator import (EngineSpec, SimResult, Simulator,
                                        paper_engines)
from repro_torch.data import workloads as wl
from repro_torch.runtime.hw import H100_SXM

from test_torch_memory import CHIPS, DENSE, LLAMA, close, port_config

REL = 1e-12
ROOF_KW = (dict(), dict(chips=2, comm_bytes_per_token=1.5e5),
           dict(efficiency=0.3, attn_efficiency=0.86, fixed_overhead=0.01,
                weight_bytes_per_param=1.0))


def roofs(arch):
    """(reference, port) roofline models of ``arch`` on each chip."""
    for rchip, pchip in CHIPS:
        for kw in ROOF_KW:
            yield (ref_jct.RooflineJCT(REGISTRY[arch], chip=rchip, **kw),
                   RooflineJCT(port_config(REGISTRY[arch]), chip=pchip, **kw))


# ---- JCT models against the reference ----------------------------------------

@pytest.mark.parametrize("arch", DENSE)
@given(st.integers(1, 200_000), st.integers(0, 200_000))
def test_roofline_matches_reference(arch, n_input, n_cached):
    n_cached = min(n_cached, n_input)
    for ref, port in roofs(arch):
        close(port.flops(n_input, n_cached), ref.flops(n_input, n_cached))
        close(port.predict(n_input, n_cached),
              ref.predict(n_input, n_cached))


@pytest.mark.parametrize("arch", DENSE)
def test_roofline_samples_and_grid_match_reference(arch):
    for ref, port in roofs(arch):
        want = ref.samples(max_len=60_000, granularity=4_000)
        got = port.samples(max_len=60_000, granularity=4_000)
        assert [s[:2] for s in got] == [s[:2] for s in want]
        for g, w in zip(got, want):
            close(g[2], w[2])
        rgrid, pgrid = ref_jct.GridJCT().fit(want), GridJCT().fit(got)
        for c_got, c_want in zip(pgrid.coef, rgrid.coef):
            close(c_got, c_want)
        for n, c in ((1_000, 0), (30_000, 12_000), (100_000, 99_000)):
            close(pgrid.predict(n, c), rgrid.predict(n, c))


@pytest.mark.parametrize("arch", DENSE)
def test_tp_comm_bytes_match_reference(arch):
    for tp in (1, 2, 4, 8):
        for b in (1, 2):
            close(tp_comm_bytes_per_token(port_config(REGISTRY[arch]), tp, b),
                  ref_jct.tp_comm_bytes_per_token(REGISTRY[arch], tp, b))


@given(st.integers(0, 100_000), st.integers(0, 100_000),
       st.sampled_from((0, 1, 16, 4096)), st.booleans())
def test_causal_context_sum_matches_reference(a, b, window, local_global):
    a, b = min(a, b), max(a, b)
    close(_causal_context_sum(b, a, window, local_global),
          ref_jct._causal_context_sum(b, a, window, local_global))


def test_roofline_chip_is_required():
    with pytest.raises(TypeError):
        RooflineJCT(get_config("qwen1.5-0.5b"))


@pytest.mark.parametrize("arch", ("qwen1.5-0.5b", "granite-3-8b"))
def test_fit_roofline_recovers_efficiency_and_overhead(arch):
    """Samples priced by a roofline of known efficiency and overhead (the
    card's profile lengths and one WL2-length step) give them back, from a
    model started elsewhere; the other fields stay."""
    cfg = get_config(arch)
    true = RooflineJCT(cfg, chip=H100_SXM, efficiency=0.31,
                       fixed_overhead=0.0043)
    lengths = (64, 128, 256, 512, 1024, 2048, 60_000)
    samples = [(n, 0, true.predict(n)) for n in lengths]
    start = RooflineJCT(cfg, chip=H100_SXM)
    fit = fit_roofline(start, samples)
    assert fit.efficiency == pytest.approx(0.31, rel=1e-6)
    assert fit.fixed_overhead == pytest.approx(0.0043, rel=1e-6)
    assert dataclasses.replace(fit, efficiency=start.efficiency,
                               fixed_overhead=start.fixed_overhead) == start


def test_fit_roofline_keeps_efficiency_in_range():
    """Steps slower than any efficiency explains (all fixed cost) and
    steps faster than the peak allows stay within (0, 1] and overhead >= 0."""
    cfg = get_config("qwen1.5-0.5b")
    start = RooflineJCT(cfg, chip=H100_SXM)
    flat = fit_roofline(start, [(n, 0, 0.02) for n in (64, 512, 2048)])
    assert 0 < flat.efficiency <= 1 and flat.fixed_overhead >= 0
    fast = fit_roofline(start, [(n, 0, 1e-9 * n) for n in (64, 512, 2048)])
    assert 0 < fast.efficiency <= 1 and fast.fixed_overhead >= 0


# ---- the reference's JCT behaviours (tests/test_jct_and_policy.py) on the H100

def test_proxy_pearson_on_h100_roofline_samples():
    samples = RooflineJCT(LLAMA, chip=H100_SXM).samples(
        max_len=60_000, granularity=2_000)
    assert pearson([s[0] - s[1] for s in samples],
                   [s[2] for s in samples]) > 0.97


def test_grid_jct_beats_proxy_on_h100():
    samples = RooflineJCT(LLAMA, chip=H100_SXM).samples(
        max_len=120_000, granularity=4_000)
    lin = LinearProxyJCT().fit(samples)
    grid = GridJCT().fit(samples)
    err_l = sum(abs(lin.predict(n, c) - t) for n, c, t in samples)
    err_g = sum(abs(grid.predict(n, c) - t) for n, c, t in samples)
    assert err_g <= err_l


@given(st.integers(1_000, 100_000), st.integers(0, 99_000))
def test_jct_monotonicity_on_h100(n_input, n_cached):
    model = RooflineJCT(LLAMA, chip=H100_SXM)
    n_cached = min(n_cached, n_input)
    t = model.predict(n_input, n_cached)
    assert t >= model.predict(n_input, min(n_input, n_cached + 1000)) - 1e-12
    assert model.predict(n_input + 1000, n_cached) >= t - 1e-12


def test_tp_comm_bytes_positive_and_scaling():
    assert tp_comm_bytes_per_token(LLAMA, 1) == 0.0
    assert 0 < tp_comm_bytes_per_token(LLAMA, 2) < tp_comm_bytes_per_token(
        LLAMA, 4)


# ---- traces ----------------------------------------------------------------

def _same_requests(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.n_input, g.arrival, g.chain, g.user_id) == (
            w.n_input, w.arrival, w.chain, w.user_id)
        assert g.tokens == w.tokens


@pytest.mark.parametrize("name", ("post_recommendation",
                                  "credit_verification"))
@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("scale", (1.0, 0.01))
def test_traces_match_reference(name, seed, scale):
    qps = 2.0 if name == "post_recommendation" else 0.5
    got = wl.get_trace(name, qps, seed=seed, scale_tokens=scale)
    want = ref_wl.get_trace(name, qps, seed=seed, scale_tokens=scale)
    assert got.name == want.name == name
    assert (got.total_tokens, got.max_len) == (want.total_tokens,
                                               want.max_len)
    _same_requests(got.requests, want.requests)


def test_materialized_trace_matches_reference():
    kw = dict(num_users=3, posts_per_user=2, seed=5, scale_tokens=0.01,
              materialize_tokens=True, vocab=151_936)
    got = wl.post_recommendation(0.0, **kw)
    _same_requests(got.requests, ref_wl.post_recommendation(0.0, **kw).requests)
    assert all(r.arrival == 0.0 for r in got.requests)
    assert all(len(r.tokens) == r.n_input for r in got.requests)
    with pytest.raises(KeyError):
        wl.get_trace("chat", 1.0)


# ---- the simulator against the reference -------------------------------------

_TRACES = {}


def _traces(name, qps):
    """(reference, port) traces of ``name`` at ``qps`` (built once: a run
    rewrites only the fields it then reads)."""
    key = (name, qps)
    if key not in _TRACES:
        _TRACES[key] = (ref_wl.get_trace(name, qps, seed=7),
                        wl.get_trace(name, qps, seed=7))
    return _TRACES[key]


# per trace, two rates: the reference's own (its tests' loads on the v5e) on
# the v5e, and a load that queues the H100's instances, on the H100
RUNS = (("post_recommendation", 2.0, 0), ("post_recommendation", 40.0, 1),
        ("credit_verification", 0.5, 0), ("credit_verification", 4.0, 1))


@pytest.mark.parametrize("engine", [s.name for s in paper_engines()])
@pytest.mark.parametrize("trace,qps,chip", RUNS)
def test_simulator_matches_reference(engine, trace, qps, chip):
    rchip, pchip = CHIPS[chip]
    rspec = {s.name: s for s in ref_sim.paper_engines()}[engine]
    pspec = {s.name: s for s in paper_engines()}[engine]
    assert dataclasses.asdict(rspec) == dataclasses.asdict(pspec)
    rtrace, ptrace = _traces(trace, qps)
    kw = dict(total_chips=2, weight_bytes_per_param=1.0,
              user_mil=ptrace.max_len)
    want = ref_sim.Simulator(REGISTRY["llama3.1-8b"], rspec, chip=rchip,
                             **kw).run(list(rtrace.requests), qps)
    got = Simulator(LLAMA, pspec, chip=pchip, **kw).run(
        list(ptrace.requests), qps)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.completed + got.rejected == len(ptrace.requests)


def test_simulator_prices_with_a_given_jct_model():
    """``jct_model`` replaces the roofline built from ``efficiency``: one
    request alone on one chip finishes in exactly its prediction."""
    cfg = get_config("qwen1.5-0.5b")
    roof = RooflineJCT(cfg, chip=H100_SXM, efficiency=0.2,
                       fixed_overhead=0.01)
    spec = EngineSpec("prefillonly", "srjf_calibrated", lam=0.05,
                      kv_budget_override=100_000)
    trace = wl.post_recommendation(0.0, num_users=1, posts_per_user=1)
    sim = Simulator(cfg, spec, total_chips=1, chip=H100_SXM, jct_model=roof)
    assert sim.jct_model is roof and sim.scheduler.jct_model is roof
    res = sim.run(list(trace.requests), 0.0)
    assert res.mean_latency == roof.predict(trace.requests[0].n_input)
    assert sim.cache_blocks == 100_000 // 16
    default = Simulator(cfg, spec, total_chips=1, chip=H100_SXM)
    assert default.jct_model == RooflineJCT(cfg, chip=H100_SXM)
    with pytest.raises(TypeError):
        Simulator(cfg, spec)


# ---- the reference's behaviours (tests/test_simulator.py) on the H100 --------
# On a 16 GB v5e the reference's traces load two instances to ~0.99 at 2-4
# qps (small prefix caches, low hit rates). On an 80 GB H100 every engine's
# cache holds every profile (hit rate ~0.97 for all) and the peak is 5x, so
# the same load comes at ~100 qps; the twins below run there unless a
# behaviour is about low load.

def _run(spec, trace, qps, chips=2):
    sim = Simulator(LLAMA, spec, total_chips=chips, chip=H100_SXM,
                    weight_bytes_per_param=1.0, user_mil=trace.max_len)
    return sim.run(list(trace.requests), qps)


def _engine(name):
    return {s.name: s for s in paper_engines()}[name]


def test_prefillonly_highest_throughput_at_high_qps_on_h100():
    """Under a load that queues every engine, PrefillOnly keeps the highest
    throughput. The reference's headline (> 1.5x the best baseline) comes
    from the v5e's small caches; with equal hit rates on the H100 paged
    FCFS does the same work and matches PrefillOnly's throughput, and the
    gain shows as latency instead: PrefillOnly's mean under 0.6x the best
    baseline's."""
    trace = wl.post_recommendation(qps=100.0, seed=1)
    results = {s.name: _run(s, trace, 100.0) for s in paper_engines()}
    po = results.pop("prefillonly")
    for name, r in results.items():
        assert po.throughput >= r.throughput, (name, r.throughput)
        assert r.hit_rate <= po.hit_rate
    assert po.mean_latency < 0.6 * min(r.mean_latency
                                       for r in results.values())


def test_prefillonly_highest_cache_hit_rate_on_h100():
    trace = wl.post_recommendation(qps=2.0, seed=2)
    results = {s.name: _run(s, trace, 2.0) for s in paper_engines()}
    assert results["prefillonly"].hit_rate == max(
        r.hit_rate for r in results.values())


def test_tensor_parallel_wins_at_low_qps_on_h100():
    trace = wl.post_recommendation(qps=0.3, seed=3)
    po = _run(_engine("prefillonly"), trace, 0.3)
    tp = _run(_engine("tensor_parallel"), trace, 0.3)
    assert tp.mean_latency < po.mean_latency


def test_credit_verification_on_h100():
    """WL2 (40k-60k tokens) is infeasible for paged on a 16 GB v5e; on the
    80 GB H100 paged's MIL is 293,334 tokens, so every engine serves WL2.
    Table 2's cross moves to inputs past paged's MIL: at 300k-600k tokens
    paged rejects every request and PrefillOnly (MIL 1,390,951) none."""
    trace = wl.credit_verification(qps=0.5, seed=4)
    for spec in paper_engines():
        assert _run(spec, trace, 0.5).rejected == 0, spec.name
    long = wl.credit_verification(qps=0.5, num_users=6, len_low=300_000,
                                  len_high=600_000, seed=4)
    paged = _run(_engine("paged_fcfs"), long, 0.5)
    po = _run(_engine("prefillonly"), long, 0.5)
    assert paged.mil < 300_000 and paged.rejected == len(long.requests)
    assert po.rejected == 0


def test_lambda_trades_p99_for_mean_on_h100():
    """Fig 11's regime, at the load of the reference's test (two instances
    busy ~0.99 of the time: 100 qps on the H100): lambda = 0 starves the
    tail, a moderate lambda repairs P99, a large one inflates the mean."""
    trace = wl.post_recommendation(qps=100.0, seed=5)
    r0 = _run(EngineSpec("po_l0", "srjf_calibrated", lam=0.0), trace, 100.0)
    rm = _run(EngineSpec("po_lm", "srjf_calibrated", lam=0.05), trace, 100.0)
    rh = _run(EngineSpec("po_lh", "srjf_calibrated", lam=2.0), trace, 100.0)
    assert rm.p99_latency < r0.p99_latency
    assert rh.mean_latency > rm.mean_latency


def test_conservation_on_h100():
    trace = wl.post_recommendation(qps=1.0, seed=6)
    for spec in paper_engines():
        r = _run(spec, trace, 1.0)
        assert isinstance(r, SimResult)
        assert r.completed + r.rejected == len(trace.requests)
