"""The port's ``runtime/fault_tolerance.py`` against the JAX package's: the
watchdogs, the NaN guard, the preemption flag, rendezvous routing and the
instance pool's re-dispatch, each driven with the same inputs through both
copies and compared (twins of ``tests/test_fault_tolerance.py``)."""
import os
import signal

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core.prefix_cache import token_chain as j_token_chain
from repro.runtime import fault_tolerance as jft
from repro_torch.core.prefix_cache import token_chain
from repro_torch.runtime import fault_tolerance as tft

BOTH = pytest.mark.parametrize("ft", [jft, tft], ids=["reference", "port"])


@given(st.lists(st.floats(1e-4, 5.0), min_size=1, max_size=80),
       st.integers(2, 20), st.floats(1.5, 5.0))
@settings(max_examples=60, deadline=None)
def test_watchdogs_trip_on_the_same_steps(times, min_history, factor):
    for cls in ("StepWatchdog", "JCTDeadlineWatchdog"):
        j, t = (getattr(m, cls)(window=30, factor=factor,
                                min_history=min_history) for m in (jft, tft))
        assert [t.observe(s) for s in times] == [j.observe(s) for s in times]
        assert (t.trips, t.deadline()) == (j.trips, j.deadline())
        if cls == "JCTDeadlineWatchdog":
            for pred in (0.0, 0.01, 1.0, 10.0):
                assert t.batch_deadline(pred) == j.batch_deadline(pred)


@BOTH
def test_watchdog_trips_on_straggler(ft):
    w = ft.StepWatchdog(window=20, factor=3.0, min_history=5)
    for _ in range(10):
        assert not w.observe(0.1)
    assert w.observe(1.0)          # 10x p95
    assert w.trips == 1


def test_nan_guard_policy_matches_reference():
    seq = [1.0, float("nan"), float("nan"), 0.5, float("inf"),
           float("nan"), float("nan"), float("nan"), 2.0]
    j, t = jft.NaNGuard(limit=2), tft.NaNGuard(limit=2)
    assert [t.observe(v) for v in seq] == [j.observe(v) for v in seq]
    assert (t.consecutive, t.total_skipped) == (j.consecutive,
                                                j.total_skipped)


def test_preemption_flag():
    h = tft.PreemptionHandler().install()
    assert not h.requested
    os.kill(os.getpid(), signal.SIGTERM)
    assert h.requested
    h.uninstall()


@given(st.lists(st.text(min_size=1, max_size=8), min_size=1, max_size=6,
                unique=True), st.lists(st.text(max_size=10), max_size=30))
@settings(max_examples=80, deadline=None)
def test_rendezvous_hash_equals_reference(instances, users):
    for u in users + [f"user{i}" for i in range(10)]:
        assert tft.rendezvous_hash(u, instances) == \
            jft.rendezvous_hash(u, instances)


@given(st.lists(st.text(min_size=1, max_size=8), min_size=2, max_size=6,
                unique=True))
@settings(max_examples=40, deadline=None)
def test_rendezvous_minimal_remap(instances):
    """Removing one instance only remaps users that were ON that instance."""
    users = [f"user{i}" for i in range(40)]
    before = {u: tft.rendezvous_hash(u, instances) for u in users}
    after = {u: tft.rendezvous_hash(u, instances[1:]) for u in users}
    for u in users:
        if before[u] != instances[0]:
            assert after[u] == before[u], "stable user was remapped"


class _Req:
    def __init__(self, rid, user_id, tokens=None, chain=None):
        self.req_id, self.user_id = rid, user_id
        self.tokens, self.chain = tokens, chain


class _FakeEngine:
    """The pool's engine surface: a queue, a lock, a block size."""

    class _ECfg:
        block_size = 16

    def __init__(self, name):
        self.name = name
        self.queue = []
        self.ecfg = self._ECfg()

    def submit(self, tokens, user_id=None, **kw):
        r = _Req(len(self.queue), user_id, list(tokens),
                 token_chain(list(tokens), self.ecfg.block_size))
        self.queue.append(r)
        return r.req_id

    def step(self):
        if self.queue:
            self.queue.pop(0)


def _layout(pool):
    return {n: [(r.user_id, r.req_id) for r in e.queue]
            for n, e in pool.engines.items()}


def test_pool_redispatch_scale_and_routes_match_reference():
    """The same operations on both pools: every queue, route, re-home and
    dropped request is the same."""
    pools = [m.InstancePool(_FakeEngine) for m in (jft, tft)]
    rehomes = [[], []]
    for p, log in zip(pools, rehomes):
        p.on_rehome = lambda rid, src, dst, log=log: log.append(
            (rid, src, dst))
        p.scale_to(["a", "b", "c", "d"])
        for u in range(30):
            p.submit(f"user{u}", [1, 2, 3])
    assert _layout(pools[1]) == _layout(pools[0])
    queued = sum(len(e.queue) for e in pools[1].engines.values())
    for step in (lambda p: p.mark_failed("b"),
                 lambda p: p.scale_to(["a", "c", "e"]),
                 lambda p: p.step_all(),
                 lambda p: p.scale_to(["a", "c", "d", "e"])):
        got = [step(p) for p in pools]
        if isinstance(got[0], list):
            assert [(r.user_id, r.req_id) for r in got[1]] == \
                [(r.user_id, r.req_id) for r in got[0]]
        else:
            assert got[1] == got[0]
        assert _layout(pools[1]) == _layout(pools[0])
        assert pools[1].live_names() == pools[0].live_names()
        assert pools[1].redispatched == pools[0].redispatched
        assert {f"u{i}": pools[1].route(f"u{i}") for i in range(20)} == \
            {f"u{i}": pools[0].route(f"u{i}") for i in range(20)}
    assert rehomes[1] == rehomes[0] and rehomes[1]
    assert pools[1].redispatched > 0 and queued >= 30 - 4
    dropped = pools[1].scale_to([])
    assert pools[1].live_names() == [] and dropped


def test_pool_scale_down_rehomes_queued_to_survivors():
    pool = tft.InstancePool(_FakeEngine)
    pool.scale_to(["a", "b", "c"])
    for u in range(30):
        pool.submit(f"user{u}", [1, 2, 3])
    queued_before = sum(len(e.queue) for e in pool.engines.values())
    assert pool.scale_to(["a"]) == []
    assert set(pool.engines) == {"a"}
    assert len(pool.engines["a"].queue) == queued_before
    assert len(pool.scale_to([])) == queued_before
    assert pool.live_names() == []


def test_rechain_cuts_the_chain_at_the_peer_block_size():
    tokens = np.random.default_rng(0).integers(0, 500, 70).tolist()
    for cut in (8, 16, 32):
        old, peer = _FakeEngine("a"), _FakeEngine("b")
        peer.ecfg = type("E", (), {"block_size": cut})()
        got = _Req(0, "u", tokens, token_chain(tokens, 16))
        want = _Req(0, "u", tokens, j_token_chain(tokens, 16))
        tft._rechain(got, old, peer)
        jft._rechain(want, old, peer)
        assert got.chain == want.chain == token_chain(tokens, cut)
    # fakes without a block size or tokens keep their chain
    bare = _Req(0, "u", None, (1, 2))
    tft._rechain(bare, object(), peer)
    assert bare.chain == (1, 2)
