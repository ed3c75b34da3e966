"""The engine's per-shape compiled forwards (``core/compiled.py``), on the
CPU, in float32 at the reduced qwen1.5-0.5b config.

- Each of the four paths (solo miss, solo hit, packed miss, packed hit)
  through the engine's compiled forwards gives the scores of the port's
  eager forwards (``tfm.*`` called on fresh, unpadded inputs) within 1e-6,
  over a trace that runs a shorter request after a longer one under one
  shape key (stale static buffers) and two steps in a row on one key.
- The packed steps' padded inputs (``last`` to the reference's 16
  ``max_pack_requests`` rows; ``prefix_pos`` and the ghost prefix rows to
  the pack's Nb) leave every live row's logits as the reference's
  ``prefill_packed``/``prefill_packed_with_prefix`` give them on its own
  layout (float32 1e-4, summation order only), and leave the attention's
  live tiles as they were (the plain tile rule).
- ``packed_prefix_layout``'s scatter equals the boolean-mask rule it
  replaced, on random layouts.
- Launch counters: a first use's warm-up and capture add nothing, and each
  replay adds the change the capture recorded (a stand-in for the CUDA
  graph calls, on the CPU); a failed capture raises and never runs
  eagerly.
- Algorithm 1 with a fitted slope serves five requests that arrive longest
  first in order of length, in the port's ``Scheduler`` as in the
  reference's; with a clamped fit both serve them first come, first served.
"""
import dataclasses
import importlib.util
import pathlib
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given
from hypothesis import strategies as st

from repro.configs import get_config as j_get_config
from repro.configs import reduce_config as j_reduce_config
from repro.core import jct as jjct
from repro.core import scheduler as jsched
from repro.kernels.flash_attention import PAD_POS as J_PAD_POS
from repro.models import transformer as jtfm
from repro.models.model import build
from repro.runtime.sharding import materialize
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import compiled
from repro_torch.core import jct as tjct
from repro_torch.core import scheduler as tsched
from repro_torch.core.engine import (EngineConfig, PrefillOnlyEngine,
                                     packed_inputs)
from repro_torch.core.prefix_cache import token_chain
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tfm
from repro_torch.models.params import params_from_numpy

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

YES, NO = 5, 9
SCORE_TOL = 1e-6          # same arithmetic; padded shapes move the last ulp
F32_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _launch_counters_restored():
    """Some tests here move the kernels' launch counters by hand (stand-in
    forwards on the CPU); they are put back, as other tests in the same
    process read them."""
    before = compiled.read_launches()
    yield
    compiled.add_launches(compiled._diff(before, compiled.read_launches()))


@pytest.fixture(scope="module")
def model():
    over = dict(hybrid_chunk=0, dtype="float32", param_dtype="float32")
    jcfg = j_reduce_config(j_get_config("qwen1.5-0.5b"), **over)
    tcfg = reduce_config(get_config("qwen1.5-0.5b"), **over)
    tree = materialize(jax.random.PRNGKey(0), build(jcfg).defs(),
                       jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    rng = np.random.default_rng(0)
    # zero leaves made random, so the norm scales and qkv bias take part
    tree = jax.tree_util.tree_map(
        lambda a: a if a.any()
        else (0.1 * rng.standard_normal(a.shape)).astype(np.float32), tree)
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, tcfg, device="cpu"))


# ---- the four paths against the eager forwards --------------------------------
def _scores(logits_row) -> dict:
    row = logits_row.double().numpy()
    sub = row[[YES, NO]]
    sub = np.exp(sub - sub.max())
    sub /= sub.sum()
    return {YES: float(sub[0]), NO: float(sub[1])}


def _prefix(eng, tokens, plen):
    """(pk, pv) of the first ``plen`` tokens, from the engine's cache."""
    parts = eng.cache.match_payloads(
        token_chain(tokens, eng.ecfg.block_size))[:plen // eng.ecfg.block_size]
    return [torch.cat([p[i] for p in parts], dim=2) for i in (0, 1)]


def _eager_logits(eng, rec, reqs):
    """The step's logits from the eager forwards on fresh inputs of N rows
    (no Nb padding, no static buffers): ``reqs`` is [(tokens, n_cached)]
    in the step's batch order."""
    params, cfg = eng.params, eng.cfg
    sufs = [len(t) - p for t, p in reqs]
    toks = torch.zeros((1, rec.S), dtype=torch.long)
    off = 0
    for (t, p), s in zip(reqs, sufs):
        toks[0, off:off + s] = torch.as_tensor(t[p:])
        off += s
    if rec.n_requests == 1:
        (t, p), = reqs
        last = torch.tensor([sufs[0] - 1])
        if not p:
            return tfm.prefill(params, cfg, {"tokens": toks},
                               last_index=last)[0]
        pk, pv = _prefix(eng, t, p)
        return tfm.prefill_with_prefix(
            params, cfg, {"tokens": toks}, {"k": pk, "v": pv}, prefix_len=p,
            last_index=last)[0]
    plens = [p for _, p in reqs]
    lay = tfm.packed_layout(plens, sufs, rec.S, smax=max(sufs),
                            pmax=rec.pmax)
    if not rec.pmax:
        return tfm.prefill_packed(params, cfg, toks, lay["seg_ids"],
                                  lay["positions"], lay["last_indices"])[0]
    shape = (cfg.num_layers, len(reqs), rec.pmax, cfg.num_kv_heads,
             cfg.head_dim)
    pk, pv = torch.zeros(shape), torch.zeros(shape)
    for n, (t, p) in enumerate(reqs):
        if p:
            k, v = _prefix(eng, t, p)
            pk[:, n:n + 1, :p], pv[:, n:n + 1, :p] = k, v
    return tfm.prefill_packed_with_prefix(
        params, cfg, toks, lay["positions"], lay["last_indices"],
        {"k": pk, "v": pv}, lay["prefix_pos"], lay["seg_qidx"])[0]


@pytest.mark.parametrize("path", ["fresh", "suffix", "packed_miss",
                                  "packed_hit"])
def test_compiled_forwards_match_eager_forwards(model, path):
    _, tcfg, _, tparams = model
    ecfg, waves = smoke.graph_traces(tcfg.vocab_size)[path]
    eng = PrefillOnlyEngine(tcfg, tparams, EngineConfig(**ecfg),
                            device="cpu")
    tokens, checked, now = {}, [], 0.0
    for wave in waves:
        for t in wave:
            tokens[eng.submit(t, allowed_tokens=(YES, NO), now=now)] = t
            now += 1.0
        while eng.queue:
            eng.step()
            rec = eng.batch_records[-1]
            reqs = [(tokens[i], eng.results[i]["n_cached"])
                    for i in rec.req_ids]
            want = _eager_logits(eng, rec, reqs)
            for n, i in enumerate(rec.req_ids):
                got = eng.results[i]["scores"]
                for t, p in _scores(want[n]).items():
                    assert abs(got[t] - p) < SCORE_TOL
            checked.append(rec)
    recs = [r for r in checked if r.jit_path == path]
    # the path ran the same key twice in a row, the second step computing
    # fewer tokens than the first
    assert any(a.jit_key == b.jit_key
               and b.computed_tokens < a.computed_tokens
               for a, b in zip(recs, recs[1:])), [
        (r.jit_key, r.computed_tokens) for r in recs]
    table = {"fresh": eng._fresh_fns, "suffix": eng._suffix_fns,
             "packed_miss": eng._packed_fns,
             "packed_hit": eng._packed_hit_fns}[path]
    assert {r.jit_key for r in recs} == set(table)
    assert eng.forwards == eng.steps
    if path == "packed_hit":
        assert any(r.Nb > r.n_requests for r in recs)   # ghost rows ran


# ---- memory: one prefix buffer, a budget of held bytes ---------------------------
def _serve(eng, reqs, now=0.0):
    """Serve ``reqs`` one at a time; per step, its record and the scores of
    its requests against the eager forwards' (``_eager_logits``)."""
    out = []
    for t in reqs:
        rid = eng.submit(t, allowed_tokens=(YES, NO), now=now)
        now += 1.0
        eng.step()
        rec = eng.batch_records[-1]
        want = _eager_logits(eng, rec, [(t, eng.results[rid]["n_cached"])])
        for tok, p in _scores(want[0]).items():
            assert abs(eng.results[rid]["scores"][tok] - p) < SCORE_TOL
        out.append((rec, eng.results[rid]["scores"]))
    return out


def test_graph_memory_stays_bounded_over_many_prefix_lengths(model):
    """Hits at seven prefix lengths of one profile (a suffix forward each),
    then the first three again: every hit forward reads a view of the front
    of an engine prefix buffer, which grows by powers of two; the buffers
    alive hold less than twice the current one, itself at most twice the
    longest prefix; the live forwards hold no more than the budget and one
    forward, so forwards are dropped (least recently used first) and made
    again, and every step scores as the eager forwards do."""
    _, tcfg, _, tparams = model
    rng = np.random.default_rng(5)
    user = rng.integers(0, tcfg.vocab_size, 512).tolist()
    budget = 2000                 # bytes: about three solo forwards' inputs
    eng = PrefillOnlyEngine(tcfg, tparams, EngineConfig(
        max_pack_requests=1, graph_memory_bytes=budget), device="cpu")
    plens = [64 * i for i in range(1, 8)]
    _serve(eng, [user])
    steps, live = [], []
    for p in plens + plens[:3]:
        steps += _serve(eng, [user[:p + 10]])
        held = [f.held_bytes for f in eng.graphs()]
        assert eng.graph_bytes() == sum(held) <= budget + max(held)
        live.append(len(held))
        rec = steps[-1][0]
        f = eng._suffix_fns[rec.jit_key]
        for name in ("pk", "pv"):
            view = f.inputs[name]
            assert view.is_contiguous() and view.shape[2] == p
            if rec.compiled:            # made now: the current buffer
                assert view.data_ptr() == eng._prefix_store[name[1]].data_ptr()
        current = 2 * eng._prefix_store["k"].nbytes
        assert current <= eng.prefix_store_bytes() < 2 * current
    assert [rec.pmax for rec, _ in steps] == plens + plens[:3]
    assert max(live) < len(plens)                       # forwards were dropped
    per_token = (tcfg.num_layers * tcfg.num_kv_heads * tcfg.head_dim
                 * 4)                                    # f32 k (or v)
    need = 2 * max(plens) * per_token
    assert need <= 2 * eng._prefix_store["k"].nbytes <= 2 * need
    # the first three prefix lengths again, through forwards made anew
    assert all(rec.compiled for rec, _ in steps[-3:])
    for (_, first), (_, again) in zip(steps[:3], steps[-3:]):
        assert first == again


def test_packed_miss_forward_is_keyed_as_the_reference(model):
    """The packed-miss key is (S, K): packs of two and three requests under
    one (S, K) share one forward, ``last`` padded to max_pack_requests rows
    as the reference pads it; a changed max_pack_requests changes
    ``last``'s shape, and the forward is made again (jit's rule)."""
    _, tcfg, _, tparams = model
    rng = np.random.default_rng(6)
    eng = PrefillOnlyEngine(tcfg, tparams, EngineConfig(), device="cpu")
    waves = [[rng.integers(0, tcfg.vocab_size, n).tolist() for n in lens]
             for lens in ((40, 30), (30, 25, 20), (40, 30))]
    recs = []
    for wave in waves[:2]:
        for t in wave:
            eng.submit(t, allowed_tokens=(YES, NO))
        eng.step()
        recs.append(eng.batch_records[-1])
    assert [r.n_requests for r in recs] == [2, 3]
    assert recs[0].jit_key == recs[1].jit_key and len(recs[0].jit_key) == 2
    assert recs[0].compiled and not recs[1].compiled
    f, = eng._packed_fns.values()
    assert f.host_specs["last"][0] == (16,)
    eng.ecfg = dataclasses.replace(eng.ecfg, max_pack_requests=32)
    for t in waves[2]:
        eng.submit(t, allowed_tokens=(YES, NO))
    eng.step()
    rec = eng.batch_records[-1]
    assert rec.jit_key == recs[0].jit_key and rec.compiled
    f, = eng._packed_fns.values()
    assert f.host_specs["last"][0] == (32,)


# ---- the Nb-row padding against the reference ---------------------------------
@pytest.mark.parametrize("kind", ["miss", "hit"])
def test_nb_padding_leaves_live_rows_as_the_reference(model, kind):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(11)
    plens = (48, 0, 32) if kind == "hit" else (0, 0, 0)
    slens = (21, 30, 9)
    N, Nb, S, smax, n_last = 3, 4, 64, 32, 16
    pmax = 64 if kind == "hit" else 0
    Lyr, KV, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim
    reqs = [rng.integers(0, tcfg.vocab_size, p + s) for p, s in zip(plens,
                                                                    slens)]
    keeps = [16, 16, 0]
    K = S if kind == "hit" else 64
    host = packed_inputs([r[p:] for r, p in zip(reqs, plens)], plens, keeps,
                         S=S, Nb=Nb, smax=smax, pmax=pmax, K=K,
                         n_last=n_last)
    # the reference pads last_idx to max(N, max_pack_requests) rows with
    # the last segment's index
    assert host["last"].shape == (n_last,)
    assert (host["last"][N:] == host["last"][N - 1]).all()
    t = {k: torch.from_numpy(a) for k, a in host.items()}
    j = {k: jnp.asarray(a.astype(np.int32)) for k, a in host.items()}
    if kind == "miss":
        got, _ = tfm.prefill_packed(tparams, tcfg, t["toks"], t["seg_ids"],
                                    t["positions"], t["last"],
                                    kv_indices=t["kv_idx"])
        want, _ = jtfm.prefill_packed(
            jparams, jcfg, j["toks"], j["seg_ids"], j["positions"],
            j["last"], kv_indices=j["kv_idx"])
    else:
        pk = np.zeros((Lyr, Nb, pmax, KV, hd), np.float32)
        pv = np.zeros_like(pk)
        for n, (r, p) in enumerate(zip(reqs, plens)):
            if p:
                _, kv = jtfm.prefill(jparams, jcfg,
                                     {"tokens": jnp.asarray(r[None, :p])},
                                     kv_keep=p)
                pk[:, n, :p] = np.asarray(kv["k"])[:, 0]
                pv[:, n, :p] = np.asarray(kv["v"])[:, 0]
        assert (host["prefix_pos"][N:] == tl.PAD_POS).all()
        assert (host["seg_qidx"][N:] == -1).all()
        ppos = host["prefix_pos"].copy()
        ppos[ppos == tl.PAD_POS] = J_PAD_POS
        seg_qidx = host["seg_qidx"]
        inv_idx = np.zeros((S,), np.int32)
        rows, cols = np.nonzero(seg_qidx >= 0)
        inv_idx[seg_qidx[rows, cols]] = rows * smax + cols
        got, _ = tfm.prefill_packed_with_prefix(
            tparams, tcfg, t["toks"], t["positions"], t["last"],
            {"k": torch.from_numpy(pk), "v": torch.from_numpy(pv)},
            t["prefix_pos"], t["seg_qidx"], kv_indices=t["kv_idx"])
        want, _ = jtfm.prefill_packed_with_prefix(
            jparams, jcfg, j["toks"], j["positions"], j["last"],
            {"k": jnp.asarray(pk), "v": jnp.asarray(pv)}, jnp.asarray(ppos),
            j["seg_qidx"], jnp.asarray(inv_idx), kv_indices=j["kv_idx"])
        # the live tiles of the positioned attention are those of the
        # N-row layout; every ghost prefix tile is skipped
        lay = tfm.packed_layout(plens, slens, S, smax=smax, pmax=pmax)
        maps = []
        for ppos_t in (t["prefix_pos"], lay["prefix_pos"]):
            seg_q, seg_k, pos_k = tfm.packed_prefix_layout(
                t["positions"], ppos_t, t["seg_qidx"])
            maps.append(smoke.tile_rule(S, seg_k.shape[1], seg_q=seg_q,
                                        seg_k=seg_k, pos_q=t["positions"],
                                        pos_k=pos_k))
        padded, plain = maps
        cut = N * pmax // 32
        ghost = (Nb - N) * pmax // 32
        assert padded[..., cut:cut + ghost].sum() == 0
        assert torch.equal(torch.cat([padded[..., :cut],
                                      padded[..., cut + ghost:]], -1), plain)
    assert got.shape == (n_last, tcfg.vocab_size)
    np.testing.assert_allclose(got[:N].numpy(), np.asarray(want)[:N],
                               **F32_TOL)


# ---- packed_prefix_layout without a host sync ----------------------------------
def _mask_rule(positions, prefix_pos, seg_qidx):
    """The boolean-mask ``seg_q`` the scatter replaced."""
    S = positions.shape[1]
    rows = torch.arange(seg_qidx.shape[0])[:, None].expand_as(seg_qidx)
    real = seg_qidx >= 0
    seg_q = torch.full((S,), -1, dtype=torch.int32)
    seg_q[seg_qidx[real]] = rows[real].to(torch.int32)
    return seg_q[None]


@given(lens=st.lists(st.tuples(st.integers(0, 40), st.integers(1, 20)),
                     min_size=1, max_size=6),
       slack=st.integers(0, 9), ghosts=st.integers(0, 3))
def test_packed_prefix_layout_scatter_equals_mask_rule(lens, slack, ghosts):
    plens, slens = zip(*lens)
    S = sum(slens) + slack
    lay = tfm.packed_layout(plens, slens, S, rows=len(lens) + ghosts,
                            smax=max(slens), pmax=max(plens) or 1)
    seg_q, seg_k, pos_k = tfm.packed_prefix_layout(
        lay["positions"], lay["prefix_pos"], lay["seg_qidx"])
    want = _mask_rule(lay["positions"], lay["prefix_pos"], lay["seg_qidx"])
    assert seg_q.dtype == torch.int32 and torch.equal(seg_q, want)
    R, pmax = lay["prefix_pos"].shape
    assert torch.equal(seg_k[:, R * pmax:], want)
    assert torch.equal(pos_k[:, R * pmax:], lay["positions"])


# ---- launch counters through first use and replays -----------------------------
class _StandInGraph(compiled.CompiledForward):
    """A CompiledForward whose graph calls run on the CPU: warm-up and
    capture run ``fn``; a replay runs it with the counters left where they
    were, as a CUDA graph's replay leaves the Python counters."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.graphed = True
        self.captures = 0

    def _warm_up(self):
        self.fn(**self.inputs)

    def _capture(self):
        self.captures += 1
        return "graph", self.fn(**self.inputs)

    def _replay(self):
        frozen = compiled.read_launches()
        self.outputs = self.fn(**self.inputs)
        compiled.add_launches(compiled._diff(frozen,
                                             compiled.read_launches()))


def _counting_forward(x):
    rn.launches += 3                          # what 3 kernel calls would do
    fa.mode_launches["positioned"] += 2
    return x * 2


def test_replays_add_the_captured_launches_and_nothing_else():
    f = _StandInGraph(_counting_forward, "stand-in (4,)",
                      {"x": ((4,), torch.float32)}, on=torch.device("cpu"))
    n0, m0 = rn.launches, fa.mode_launches["positioned"]
    for i in range(1, 4):
        out = f({"x": np.full((4,), float(i), np.float32)})
        assert torch.equal(out, torch.full((4,), 2.0 * i))
        # warm-up and capture added nothing: each call counts once
        assert rn.launches - n0 == 3 * i
        assert fa.mode_launches["positioned"] - m0 == 2 * i
    assert f.captures == 1 and f.replays == 3
    assert f.launches["rmsnorm"] == 3
    assert f.launches["flash_attention[positioned]"] == 2
    assert f.launches["fused_mlp"] == 0


def test_failed_capture_raises_with_the_op_and_never_runs_eagerly():
    ran = []

    def broken(x):
        ran.append(1)
        rn.launches += 1
        return x.sum().item()                  # a host sync

    class SyncRefused(_StandInGraph):
        def _warm_up(self):
            self.fn(**self.inputs)
            raise RuntimeError("called a synchronizing CUDA operation")

    f = SyncRefused(broken, "broken (2,)", {"x": ((2,), torch.float32)},
                    on=torch.device("cpu"))
    n0 = rn.launches
    errors = []
    for _ in range(3):
        with pytest.raises(compiled.CaptureError,
                           match=r"broken \(2,\)") as info:
            f({"x": np.ones(2, np.float32)})
        errors.append(info.value)
    # the first call failed in its warm-up: the error names the key and is
    # chained to the op's own; later calls raise the same error without
    # trying again or running eagerly
    chain = "".join(traceback.format_exception(errors[0]))
    assert errors[0].__cause__ is not None
    assert "test_torch_graphs.py" in chain and "_warm_up" in chain
    assert errors[1] is errors[0] and errors[2] is errors[0]
    assert f.graph is None and f.outputs is None and len(ran) == 1
    assert rn.launches == n0                   # the counters were restored
    with pytest.raises(ValueError, match="expected"):
        f({"x": np.ones(3, np.float32)})       # shapes are the key's


# ---- Algorithm 1 with a slope: the order phase's twin --------------------------
ORDER_LENS = (1900, 1000, 500, 250, 60)


def _serve_order(sched_mod, jct_mod, samples, lam=0.05):
    """Five fresh requests arrive 1 ms apart, longest first; each step runs
    Algorithm 1's pick and lasts the fit's prediction."""
    model = jct_mod.LinearProxyJCT().fit(samples)
    sched = sched_mod.Scheduler("srjf_calibrated", model, lam)
    queue = [sched_mod.Request(n_input=n, arrival=1e-3 * i)
             for i, n in enumerate(ORDER_LENS)]
    now, order = 4e-3, []
    while queue:
        r = queue.pop(sched.pick(queue, None, now))
        order.append(r.n_input)
        now += model.predict(r.n_input)
    return order, model


@pytest.mark.parametrize("slope", [2e-6, 0.0])
def test_algorithm1_orders_by_length_once_the_fit_has_a_slope(slope):
    """slope 2e-6 s/token: a fit of 0.002 ms/token + 5 ms; slope 0: flat
    walls that fall a little with length (the card's fit with eager
    forwards), which the fit clamps to 1e-12."""
    lengths = [64, 128, 256, 512] * 2
    samples = [(n, 0, 5e-3 + slope * n - (0 if slope else 1e-8 * n))
               for n in lengths]
    got, tmodel = _serve_order(tsched, tjct, samples)
    want, jmodel = _serve_order(jsched, jjct, samples)
    assert got == want
    assert (tmodel.a, tmodel.b) == (jmodel.a, jmodel.b)
    if slope:
        assert got == sorted(ORDER_LENS)
        assert tmodel.pearson_r > 0.9
    else:
        assert tmodel.a == 1e-12 and got == list(ORDER_LENS)
