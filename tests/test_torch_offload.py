"""The port's DRAM offload tier (``repro_torch.core.offload`` and the
engine's offload code) against the JAX package's, on the CPU.

Unit twins of ``tests/test_offload.py`` and engine twins of
``tests/test_offload_e2e.py`` run the same operations on both packages and
compare every counter. The policy's numbers are given on both sides, since
the port prices the H100 and the reference a TPU v5e. The engines run the
reduced qwen1.5-0.5b and granite-3-8b configs in bfloat16 on bridged
weights, with the reference test's ``TIER`` settings; scores are held to
the repo's 2e-2 engine gate, the gate of the reference's round trip.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduce_config as j_reduce_config
from repro.core import engine as jengine
from repro.core import offload as joff
from repro.core.prefix_cache import token_chain as j_token_chain
from repro.models.model import build
from repro.runtime.sharding import materialize
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import compiled
from repro_torch.core import offload as toff
from repro_torch.core.engine import EngineConfig, PrefillOnlyEngine
from repro_torch.core.prefix_cache import token_chain
from repro_torch.models.params import params_from_numpy
from repro_torch.runtime.hw import H100_SXM
from repro_torch.serving.tracing import SpanTracer

SCORE_GATE = 2e-2
YES, NO = 5, 9
ARCHS = ("qwen1.5-0.5b", "granite-3-8b")
BLOCK = 4
# the reference test's engine settings: a 4-block device cache, solo steps
# and fine reuse granularity, so a handful of 40-token requests evict into
# the host tier; the link is priced huge so that restores win on the CPU
TIER = dict(cache_capacity_tokens=64, offload=True, offload_host_bw=1e18,
            prefix_bucket_blocks=1, max_pack_requests=1)
# explicit policy numbers, the same on both sides
LINK, PEAK = 64e9, 989e12


def _policies(**kw):
    kw = dict(dict(host_bw=LINK, peak_flops=PEAK), **kw)
    return joff.OffloadPolicy(**kw), toff.OffloadPolicy(H100_SXM, **kw)


def _caches(capacity, block=BLOCK, arch="granite-3-8b", host_bytes=None,
            **kw):
    """A reference and a port cache with the same policy numbers. A host
    store of ``host_bytes`` is set on the reference after construction (its
    constructor drops an empty store: ROADMAP §C12)."""
    jpol, tpol = _policies(**kw)
    cfgs = (j_get_config(arch), get_config(arch)) if arch else (None, None)
    j = joff.TieredPrefixCache(capacity, block, cfg=cfgs[0], policy=jpol)
    t = toff.TieredPrefixCache(
        capacity, block, cfg=cfgs[1], policy=tpol,
        host_store=toff.HostKVStore(host_bytes) if host_bytes else None)
    if host_bytes:
        j.host = joff.HostKVStore(host_bytes)
    return j, t


def _chain(n, seed=0):
    toks = [(seed * 997 + i) % 89 for i in range(n)]
    return j_token_chain(toks, BLOCK)


def _payloads(n, fill=None, size=2 * BLOCK):
    """The reference test's payloads (one f32 leaf a block) on both
    sides."""
    vals = range(n) if fill is None else [fill] * n
    return ([(np.full((size,), v, np.float32),) for v in vals],
            [(torch.full((size,), float(v)),) for v in vals])


def _same(j, t, chains):
    assert t.stats() == j.stats()
    for c in chains:
        assert t.match_tiers(c) == j.match_tiers(c)
        assert t.probe_blocks(c) == j.probe_blocks(c)
        assert t.restore_estimate(c) == j.restore_estimate(c)


# ---- unit twins of tests/test_offload.py -------------------------------------

def test_evicted_blocks_land_in_host_store():
    j, t = _caches(2)
    a, b = _chain(8, seed=1), _chain(8, seed=2)
    for c in (j, t):
        pa, pb = _payloads(len(a)), _payloads(len(b))
        side = 0 if c is j else 1
        c.insert(a, 8, payloads=pa[side])
        c.insert(b, 8, now=1.0, payloads=pb[side])   # evicts a's blocks
    assert t.host.offloads >= 1
    assert [h in t.host for h in a] == [h in j.host for h in a]
    assert any(h in t.host for h in a)
    _same(j, t, (a, b))


def test_match_restores_from_host():
    j, t = _caches(2)
    a, b = _chain(8, seed=1), _chain(8, seed=2)
    for side, c in enumerate((j, t)):
        c.insert(a, 8, payloads=_payloads(len(a))[side])
        c.insert(b, 8, now=1.0, payloads=_payloads(len(b))[side])
    _same(j, t, (a, b))
    for c in (j, t):
        assert super(type(c), c).match_blocks(a) == 0     # device miss
    assert t.match_len(a, now=2.0) == j.match_len(a, now=2.0) > 0
    assert t.host.restores == j.host.restores >= 1
    _same(j, t, (a, b))
    # the restored payload is intact
    got, want = t.match_payloads(a, now=3.0), j.match_payloads(a, now=3.0)
    assert len(got) == len(want) and got[0][0][0].item() == 0.0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), w[0])


def test_host_store_capacity_lru():
    payload_bytes = 2 * BLOCK * 4
    stores = (joff.HostKVStore(capacity_bytes=2 * payload_bytes),
              toff.HostKVStore(capacity_bytes=2 * payload_bytes))
    for i in range(4):
        stores[0].put(i, (np.zeros((2, BLOCK), np.float32),))
        stores[1].put(i, (torch.zeros((2, BLOCK)),))
    j, t = stores
    assert t.stats() == j.stats()
    assert t.used_bytes <= t.capacity_bytes and t.host_evictions >= 2
    assert 3 in t and 0 not in t
    # a payload past the capacity is not stored, as in the reference
    j.put(9, (np.zeros((64,), np.float32),))
    t.put(9, (torch.zeros((64,)),))
    assert t.stats() == j.stats() and 9 not in t


@pytest.mark.parametrize("arch", ARCHS)
def test_policy_breakeven(arch):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    for kw in ({}, {"host_bw": 1e3}, {"host_bw": 40e9}, {"efficiency": 0.2}):
        jp, tp = _policies(**kw)
        for n, nbytes in ((16, 2 * 2**20), (16, 1_572_864), (64, 10**7)):
            assert tp.restore_seconds(nbytes) == jp.restore_seconds(nbytes)
            assert tp.recompute_seconds(tcfg, n) == pytest.approx(
                jp.recompute_seconds(jcfg, n), rel=1e-12)
            assert (tp.worth_restoring(tcfg, n, nbytes)
                    == jp.worth_restoring(jcfg, n, nbytes))
    # an 8B model: restoring a 16-token block (~2 MB) beats recomputing; an
    # absurdly slow link makes recompute win
    if arch == "granite-3-8b":
        assert toff.OffloadPolicy(H100_SXM).worth_restoring(
            tcfg, 16, 2 * 2**20)
    assert not toff.OffloadPolicy(H100_SXM, host_bw=1e3).worth_restoring(
        tcfg, 16, 2 * 2**20)
    # the port has no default chip: its policy prices the H100 it is given
    p = toff.OffloadPolicy(H100_SXM)
    assert (p.host_bw, p.peak_flops) == (H100_SXM.host_bw,
                                         H100_SXM.peak_flops_bf16)


def test_pinned_blocks_survive_tiered_eviction():
    j, t = _caches(2, 4, arch=None)
    a = j_token_chain([1, 2, 3, 4, 5, 6, 7, 8], 4)
    b = j_token_chain([9, 10, 11, 12, 13, 14, 15, 16], 4)
    for side, c in enumerate((j, t)):
        c.insert(a, 8, payloads=_payloads(2, fill=1)[side])
        c.pin(a, 2)                          # a running request holds it
        c.insert(b, 8, now=1.0, payloads=_payloads(2, fill=0)[side])
    assert all(h in t.blocks for h in a), "eviction dropped a pinned block"
    assert t.probe_blocks(a) == 2
    _same(j, t, (a, b))
    for c in (j, t):
        c.unpin(a, 2)
    _same(j, t, (a, b))


def test_tiered_cache_needs_a_policy_and_keeps_its_host_store():
    """The port has no default chip, so the cache takes its policy
    explicitly; an empty host store passed in is kept (the reference's
    constructor replaces it by a 1 GiB one: ROADMAP §C12)."""
    with pytest.raises(TypeError):
        toff.TieredPrefixCache(2, 4)
    store = toff.HostKVStore(1234)
    c = toff.TieredPrefixCache(2, 4, host_store=store,
                               policy=toff.OffloadPolicy(H100_SXM))
    assert c.host is store
    ref = joff.TieredPrefixCache(2, 4, host_store=joff.HostKVStore(1234))
    assert ref.host.capacity_bytes == 1 << 30


def test_cpu_payloads_stay_where_they_are():
    """On the CPU a payload is already host memory: demotion and the copy
    back return it as it is, as the reference's ``np.asarray`` does."""
    x = torch.arange(6.0).view(2, 3)
    assert toff.to_host(x) is x
    assert toff.to_device(x, torch.device("cpu")) is x
    pair = toff.to_host((x, x))
    assert isinstance(pair, tuple) and all(p is x for p in pair)
    assert toff.to_host(None) is None


# ---- random operation sequences ---------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_random_operations_match_reference(seed):
    """Insert, pin, unpin, match, probe, estimate and evict, drawn from a
    seed, on both caches: after each operation the results, ``stats()``
    and every chain's tiers agree. Payload sizes vary, so the policy
    restores some blocks and not others; the host store is small enough to
    evict."""
    rng = np.random.default_rng(seed)
    # break-even at 96 bytes, the middle of the payload sizes below (32 to
    # 160 bytes): a 4-token block of qwen1.5-0.5b recomputes in 7.5 us
    j, t = _caches(6, 4, arch="qwen1.5-0.5b", host_bytes=512,
                   host_bw=12.8e6)
    roots = [list(rng.integers(0, 50, 4)) for _ in range(3)]
    chains = []
    for i in range(8):
        toks = list(roots[i % 3]) + list(rng.integers(0, 50, 4 * (1 + i % 3)))
        chains.append(j_token_chain(toks, 4))
    pinned = []
    for step in range(120):
        op = rng.choice(["insert", "insert", "match", "match_len", "pin",
                         "unpin", "probe", "estimate", "evict", "payloads"])
        c = chains[rng.integers(len(chains))]
        now = float(step)
        if op == "insert":
            n_tok = 4 * int(rng.integers(1, len(c) + 1))
            size = int(rng.choice([8, 16, 24, 40]))
            pays = _payloads(len(c), size=size)
            got = (j.insert(c, n_tok, now=now, payloads=pays[0]),
                   t.insert(c, n_tok, now=now, payloads=pays[1]))
        elif op == "match":
            touch = bool(rng.integers(2))
            got = (j.match_blocks(c, now, touch), t.match_blocks(c, now, touch))
        elif op == "match_len":
            got = (j.match_len(c, now), t.match_len(c, now))
        elif op == "pin":
            n = int(rng.integers(1, len(c) + 1))
            j.pin(c, n), t.pin(c, n)
            pinned.append((c, n))
            got = (None, None)
        elif op == "unpin" and pinned:
            pc, n = pinned.pop(int(rng.integers(len(pinned))))
            j.unpin(pc, n), t.unpin(pc, n)
            got = (None, None)
        elif op == "probe":
            got = (j.probe_blocks(c), t.probe_blocks(c))
        elif op == "estimate":
            got = (j.restore_estimate(c), t.restore_estimate(c))
        elif op == "evict":
            got = (j._evict_one(), t._evict_one())
        else:
            got = ([p[0].tolist() for p in j.match_payloads(c, now)],
                   [p[0].tolist() for p in t.match_payloads(c, now)])
        assert got[1] == got[0], (step, op)
        _same(j, t, chains)
    # the sequence reached every tier's path
    assert t.host.offloads and t.restored_blocks and t.host.host_evictions


# ---- engine twins of tests/test_offload_e2e.py -------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg = j_reduce_config(j_get_config(request.param), hybrid_chunk=0)
    tcfg = reduce_config(get_config(request.param), hybrid_chunk=0)
    jparams = materialize(jax.random.PRNGKey(0), build(jcfg).defs(),
                          jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tree, tcfg, device="cpu")


def _engines(setup, **over):
    jcfg, tcfg, jparams, tparams = setup
    ecfg = dict(TIER, **over)
    return (jengine.PrefillOnlyEngine(jcfg, jparams,
                                      jengine.EngineConfig(**ecfg)),
            PrefillOnlyEngine(tcfg, tparams, EngineConfig(**ecfg),
                              device="cpu"))


def _counters(eng):
    """The tier's counters, the device cache's and the host store's, less
    the host capacity (the reference's is always 1 GiB: ROADMAP §C12)."""
    st = eng.stats()["cache"]
    host = st.pop("host", {})
    host.pop("capacity_bytes", None)
    return st, host


def _serve(eng, reqs, t0=0.0):
    """Submit ``reqs`` together, then step until drained; per step the
    served requests' ``n_cached`` and the tier's counters."""
    ids = [eng.submit(r, allowed_tokens=(YES, NO), now=t0 + i)
           for i, r in enumerate(reqs)]
    steps = []
    while eng.queue:
        eng.step()
        steps.append(([eng.results[i]["n_cached"]
                       for i in eng._last_step_ids], _counters(eng)))
    return steps, [eng.results[i] for i in ids]


def _flood(seed, vocab, n=6, length=40):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, length).tolist() for _ in range(n)]


def _twin(pair, trace):
    """Drive both engines over ``trace`` (a list of request waves): every
    step's n_cached and counters must agree, and every score within the
    gate. Returns the port's results per wave."""
    (jeng, teng), out = pair, []
    for w, reqs in enumerate(trace):
        want_steps, want = _serve(jeng, reqs, 100.0 * w)
        got_steps, got = _serve(teng, reqs, 100.0 * w)
        assert got_steps == want_steps
        for g, r in zip(got, want):
            for tok in (YES, NO):
                assert abs(g["scores"][tok] - r["scores"][tok]) < SCORE_GATE
        out.append(got)
    return out


def _join_prefetch():
    """Wait for every ``kv-prefetch`` thread of this process."""
    for th in threading.enumerate():
        if th.name == "kv-prefetch":
            th.join(timeout=60)
            assert not th.is_alive()


def test_demote_restore_round_trip_scores(setup):
    _, tcfg, _, tparams = setup
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, 40).tolist()
    pair = _engines(setup)
    got = _twin(pair, [[toks], _flood(1, tcfg.vocab_size), [toks]])
    eng = pair[1]
    host = eng.cache.host
    assert host.offloads > 0, "device eviction never reached the host tier"
    assert eng.cache.restored_blocks > 0, "re-match did not restore"
    assert got[2][0]["n_cached"] > 0
    # demoted payloads are host memory (on the CPU the engine's own tensors)
    assert all(not p.is_cuda for p in host._store.values())
    cold = PrefillOnlyEngine(tcfg, tparams,
                             EngineConfig(cache_capacity_tokens=0),
                             device="cpu")
    ref = _serve(cold, [toks])[1][0]
    for tok in (YES, NO):
        assert abs(ref["scores"][tok] - got[2][0]["scores"][tok]) < SCORE_GATE


def test_probe_is_side_effect_free_across_tiers(setup):
    _, tcfg, _, _ = setup
    toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, 40).tolist()
    pair = _engines(setup)
    _twin(pair, [[toks], _flood(3, tcfg.vocab_size)])
    chain = token_chain(toks, 16)
    before = [_counters(e) for e in pair]
    got = [e.cache.probe_blocks(chain) for e in pair]
    assert got[1] == got[0] > 0, "host-resident prefix invisible to probes"
    assert [_counters(e) for e in pair] == before
    assert pair[1].cache.match_tiers(chain) == pair[0].cache.match_tiers(
        chain) == ["host"] * got[0]


def test_slow_link_breakeven_prefers_recompute(setup):
    _, tcfg, _, _ = setup
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, 40).tolist()
    pair = _engines(setup, offload_host_bw=1e3)     # ~KB/s link
    got = _twin(pair, [[toks], _flood(5, tcfg.vocab_size), [toks]])
    eng = pair[1]
    assert eng.cache.host.offloads > 0          # demotion still happens
    assert eng.cache.restored_blocks == 0, \
        "restored despite recompute being cheaper than the link"
    assert got[2][0]["n_cached"] == 0 and len(got[2][0]["scores"]) == 2


def test_restore_estimate_prices_the_host_prefix(setup):
    _, tcfg, _, _ = setup
    toks = np.random.default_rng(6).integers(0, tcfg.vocab_size, 40).tolist()
    pair = _engines(setup)
    _twin(pair, [[toks], _flood(7, tcfg.vocab_size)])
    chain = token_chain(toks, 16)
    want, est = (e.restore_estimate(chain) for e in pair)
    assert est == want
    assert est["blocks"] > 0 and est["bytes"] > 0
    assert est["restore_s"] == pytest.approx(
        est["bytes"] / pair[1].cache.policy.host_bw)
    # an engine without the tier estimates nothing
    plain = PrefillOnlyEngine(setup[1], setup[3], EngineConfig(),
                              device="cpu")
    assert plain.restore_estimate(chain)["blocks"] == 0
    assert plain.prefetch_prefix(chain) == 0


def test_prefetch_upgrades_host_blocks_to_device(setup):
    _, tcfg, _, _ = setup
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, 40).tolist()
    pair = _engines(setup)
    _twin(pair, [[toks], _flood(9, tcfg.vocab_size)])
    chain = token_chain(toks, 16)
    assert all(e.cache.probe_blocks(chain) > 0 for e in pair)
    assert all(e.cache.match_tiers(chain)[0] == "host" for e in pair)
    n = [e.prefetch_prefix(chain) for e in pair]
    assert n[1] == n[0] > 0
    _join_prefetch()
    eng = pair[1]
    assert _counters(eng) == _counters(pair[0])
    assert eng.cache.match_tiers(chain) == ["device"] * n[1]
    blks = [eng.cache.blocks[h] for h in chain[:n[1]]]
    assert all(isinstance(b.payload, torch.Tensor)
               and b.payload.device == eng.device for b in blks)
    # the hit that follows restores nothing on its execute path
    r0 = eng.cache.restored_blocks
    got = _twin(pair, [[toks]])
    assert eng.cache.restored_blocks == r0 and got[0][0]["n_cached"] > 0


def test_packed_hits_restore_in_one_step(setup):
    """Two users' demoted prefixes restored by one packed prefix-hit step
    (``_execute_packed``), counters and scores as the reference's."""
    _, tcfg, _, _ = setup
    rng = np.random.default_rng(10)
    users = [rng.integers(0, tcfg.vocab_size, 64).tolist() for _ in range(2)]
    posts = [u + rng.integers(0, tcfg.vocab_size, 8).tolist() for u in users]
    pair = _engines(setup, cache_capacity_tokens=160, max_pack_requests=4,
                    prefix_bucket_blocks=4)
    got = _twin(pair, [[users[0]], [users[1]],
                       _flood(11, tcfg.vocab_size, n=4, length=72), posts])
    eng = pair[1]
    hits = [r for r in eng.batch_records if r.kind == "hit"]
    assert hits and hits[-1].n_requests == 2
    assert eng.cache.restored_blocks > 0
    assert all(g["n_cached"] == 64 for g in got[3])


def test_profile_measures_the_link_unless_given(setup):
    _, tcfg, _, tparams = setup
    eng = PrefillOnlyEngine(tcfg, tparams, EngineConfig(offload=True),
                            device="cpu")
    assert eng.cache.policy.host_bw == H100_SXM.host_bw
    eng.profile((32, 64))
    bw = eng.cache.policy.host_bw
    assert np.isfinite(bw) and bw > 0 and bw != H100_SXM.host_bw
    assert eng.block_bytes() == 16 * tcfg.kv_bytes_per_token(2)
    given = PrefillOnlyEngine(tcfg, tparams, EngineConfig(
        offload=True, offload_host_bw=5e9, host_cache_bytes=1 << 20),
        device="cpu")
    given.profile((32, 64))
    assert given.cache.policy.host_bw == 5e9
    assert given.cache.host.capacity_bytes == 1 << 20


def test_prefetch_waits_for_a_capture(setup):
    """The prefetch worker holds ``compiled.capture_lock`` over its work, so
    one started while a forward captures waits for it and is not lost."""
    _, tcfg, _, _ = setup
    toks = np.random.default_rng(12).integers(0, tcfg.vocab_size, 40).tolist()
    eng = _engines(setup)[1]
    _serve(eng, [toks])
    _serve(eng, _flood(13, tcfg.vocab_size))
    chain = token_chain(toks, 16)
    r0 = eng.cache.restored_blocks
    with compiled.capture_lock:
        n = eng.prefetch_prefix(chain)
        assert n > 0
        workers = [th for th in threading.enumerate()
                   if th.name == "kv-prefetch"]
        for th in workers:
            th.join(timeout=0.5)
        assert any(th.is_alive() for th in workers)
        assert eng.cache.restored_blocks == r0
    _join_prefetch()
    assert eng.cache.restored_blocks == r0 + n
    assert eng.cache.match_tiers(chain) == ["device"] * n


def test_step_joins_its_requests_prefetch(setup):
    """The step that runs a request joins the prefetch started for it, so
    the execute path restores nothing the prefetch restores, and the
    ``prefetch`` span lands on the request's timeline before it finishes.
    The prefetch is held back (``capture_lock``) until the step waits."""
    _, tcfg, _, _ = setup
    toks = np.random.default_rng(14).integers(0, tcfg.vocab_size, 40).tolist()
    eng = _engines(setup)[1]
    _serve(eng, [toks])
    _serve(eng, _flood(15, tcfg.vocab_size))
    tracer = SpanTracer()
    eng.bind_telemetry(tracer=tracer)
    chain = token_chain(toks, 16)
    r0 = eng.cache.restored_blocks
    rid = eng.submit(toks, allowed_tokens=(YES, NO), now=500.0)
    ctx = tracer.begin(rid=rid)
    stepper = threading.Thread(target=eng.step)
    with compiled.capture_lock:
        n = eng.prefetch_prefix(chain, rid=rid)
        assert n > 0
        stepper.start()
        stepper.join(timeout=0.5)
        assert stepper.is_alive() and rid not in eng.results
    stepper.join(timeout=60)
    assert not stepper.is_alive()
    tracer.finish(ctx, "delivered")
    _join_prefetch()
    spans = {s["name"] for r in tracer.snapshot() if rid in r["rids"]
             for s in r["spans"]}
    assert "prefetch" in spans and "restore" not in spans
    assert eng.cache.restored_blocks == r0 + n
    assert eng.results[rid]["n_cached"] > 0
