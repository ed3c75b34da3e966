"""The port's mixture of experts (``repro_torch.models.moe``) against the
JAX package's (``repro.models.moe``), layer by layer, on the CPU.

Both sides get the same weights (the reference's ``moe_defs`` tree from
``materialize``, carried across as numpy) and the same seeded numpy inputs,
at the reduced mixtral-8x22b (4 experts, top-2) and llama4-scout-17b-a16e
(4 experts, top-1, a shared expert) configs: d_model 128, d_ff 256,
``hybrid_chunk`` 32. The reference's routes and keep masks are computed by
its own ops (``jax.nn.softmax``, ``jax.lax.top_k``, the stable argsort and
``searchsorted`` of ``_dispatch_compute``) over the chunks its
``chunked_map`` makes, the last one padded with zero rows.

Tolerances: float32 outputs within 1e-5 (|port - reference| <= 1e-5 +
1e-5 |reference|: the same products in another summation order), routes
and keep masks equal. bfloat16: routes agree on at least ``BF16_AGREE`` of
the (token, layer) pairs (each side rounds its router logits to bf16
after products summed in another order, so a near tie may go either way),
and the outputs of tokens whose routes agree are within 5e-2 + 5e-2
|reference|, the bf16 tolerance of ``tests/test_torch_families.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduce_config as j_reduce_config
from repro.core.hybrid_prefill import chunked_map as j_chunked_map
from repro.models import moe as jmoe
from repro.runtime.sharding import materialize
from repro_torch.configs import get_config, reduce_config
from repro_torch.models import moe as tmoe

ARCHS = ("mixtral-8x22b", "llama4-scout-17b-a16e")
F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
# least share of (token, layer) routes that agree at bf16 (all 320 agree at
# both configs over these inputs)
BF16_AGREE = 0.97
CHUNK = 32


def _configs(arch: str, dtype: str = "float32", chunk: int = CHUNK):
    over = dict(hybrid_chunk=chunk, dtype=dtype, param_dtype=dtype)
    return (j_reduce_config(j_get_config(arch), **over),
            reduce_config(get_config(arch), **over))


def _np_tree(jcfg, seed: int = 0):
    """The reference's MoE tree as float32 numpy."""
    tree = materialize(jax.random.PRNGKey(seed), jmoe.moe_defs(jcfg),
                       jnp.float32)
    return jax.tree_util.tree_map(np.asarray, tree)


def _trees(tree, dtype: str):
    jt = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.dtype(dtype)),
                                tree)
    tdt = getattr(torch, dtype)

    def port(t):
        return {k: port(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v)).to(tdt)
                for k, v in t.items()}

    return jt, port(tree)


def ref_routes(x, router, jcfg, chunk: int):
    """The reference's (gate_idx, keep) of every token of x (T, D), in
    token order: ``_dispatch_compute``'s routing ops over the chunks of the
    reference's ``chunked_map``."""
    E, K = jcfg.num_experts, jcfg.num_experts_per_tok

    def routes(xr):
        t = xr.shape[0]
        C = jmoe._capacity(t, jcfg)
        probs = jax.nn.softmax((xr @ router).astype(jnp.float32), axis=-1)
        _, gate_idx = jax.lax.top_k(probs, K)
        flat_e = gate_idx.reshape(t * K)
        order = jnp.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        seg_start = jnp.searchsorted(sorted_e, jnp.arange(E))
        pos = jnp.arange(t * K) - seg_start[sorted_e]
        keep = jnp.zeros((t * K,), bool).at[order].set(pos < C)
        return jnp.concatenate([gate_idx, keep.reshape(t, K)], axis=1)

    out = np.asarray(j_chunked_map(routes, x, chunk, axis=0))
    return out[:, :K], out[:, K:].astype(bool)


def _run(arch, dtype, x, tree, chunk=CHUNK):
    """(reference output, port output, reference routes, port routes) of
    one layer on x (B, S, D) numpy."""
    jcfg, tcfg = _configs(arch, dtype, chunk)
    jt, tt = _trees(tree, dtype)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = jmoe.moe_apply(jt, jx, jcfg, hybrid_chunk=chunk)
    with tmoe.record_routes() as rec:
        got = tmoe.moe_apply(tt, torch.from_numpy(x).to(getattr(torch, dtype)),
                             tcfg, hybrid_chunk=chunk)
    D = x.shape[-1]
    ref = ref_routes(jx.reshape(-1, D), jt["router"], jcfg, chunk)
    (r,) = rec
    return (np.asarray(want.astype(jnp.float32)), got.float().numpy(), ref,
            (r["experts"].numpy(), r["keep"].numpy()), r["capacity"])


@pytest.fixture(scope="module", params=ARCHS)
def arch_tree(request):
    jcfg, _ = _configs(request.param)
    return request.param, _np_tree(jcfg)


def test_capacity_matches_reference():
    for arch in ARCHS:
        for cfg, jcfg in ((get_config(arch), j_get_config(arch)),
                          (_configs(arch)[1], _configs(arch)[0])):
            for t in list(range(0, 300)) + [511, 512, 2047, 2048, 2049,
                                            8192, 65_536]:
                assert tmoe._capacity(t, cfg) == jmoe._capacity(t, jcfg), t


def test_moe_defs_match_reference():
    for arch in ARCHS:
        jcfg, tcfg = _configs(arch)
        ref = {tuple(k.key for k in path): (tuple(d.shape), d.init)
               for path, d in jax.tree_util.tree_leaves_with_path(
                   jmoe.moe_defs(jcfg),
                   is_leaf=lambda d: hasattr(d, "shape"))}
        assert ref == tmoe.moe_defs(tcfg)


@pytest.mark.parametrize("S", [20, 64, 80], ids=["below-chunk",
                                                  "two-chunks",
                                                  "2.5-chunks"])
def test_moe_apply_matches_reference_f32(arch_tree, S):
    """Below one chunk, an exact multiple and 2.5 chunks (the last chunk
    padded by the reference, priced as a full chunk by the port)."""
    arch, tree = arch_tree
    x = np.random.default_rng(S).standard_normal(
        (1, S, 128)).astype(np.float32)
    want, got, (ri, rk), (ti, tk), caps = _run(arch, "float32", x, tree)
    np.testing.assert_array_equal(ti, ri)
    np.testing.assert_array_equal(tk, rk)
    np.testing.assert_allclose(got, want, **F32_TOL)
    cfg = _configs(arch)[1]
    assert caps == [tmoe._capacity(min(S, CHUNK), cfg)] * -(-S // CHUNK)


def test_dropped_assignments_and_the_last_chunks_capacity(arch_tree):
    """A router skewed toward expert 0 overflows it: assignments drop in
    every full chunk, and the last chunk (20 of 32 rows) keeps or drops as
    the reference's padded chunk does, where C priced from its 20 rows
    would drop more."""
    arch, tree = arch_tree
    jcfg, tcfg = _configs(arch)
    tree = jax.tree_util.tree_map(np.copy, tree)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 42, 128)).astype(np.float32)   # T = 84
    x[..., 0] = 4.0                     # every token's logit 0 up by 20
    tree["router"][0, 0] = 5.0
    want, got, (ri, rk), (ti, tk), caps = _run(arch, "float32", x, tree)
    np.testing.assert_array_equal(ti, ri)
    np.testing.assert_array_equal(tk, rk)
    np.testing.assert_allclose(got, want, **F32_TOL)
    assert (~tk).any()
    last = slice(2 * CHUNK, 84)
    full, short = caps[-1], tmoe._capacity(84 - 2 * CHUNK, tcfg)
    assert full == tmoe._capacity(CHUNK, tcfg) and short < full
    on_0 = int((ti[last] == 0).sum())
    assert on_0 == 20 and short < on_0          # C from 20 rows would drop
    assert int((~tk[last]).sum()) == max(0, on_0 - full)
    assert int((~tk[:CHUNK]).sum()) == CHUNK - full


def test_ties_go_to_the_references_experts(arch_tree):
    """Zero rows tie on every expert: both sides give them experts 0..K-1,
    after every real row of those experts. Repeated rows route alike, the
    earlier token first."""
    arch, tree = arch_tree
    jcfg, tcfg = _configs(arch)
    K = tcfg.num_experts_per_tok
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 40, 128)).astype(np.float32)
    x[0, 5:9] = 0.0
    x[0, 20:30] = x[0, 2]
    want, got, (ri, rk), (ti, tk), _ = _run(arch, "float32", x, tree,
                                            chunk=0)
    np.testing.assert_array_equal(ti, ri)
    np.testing.assert_array_equal(tk, rk)
    np.testing.assert_allclose(got, want, **F32_TOL)
    assert (ti[5:9] == np.arange(K)).all()
    assert (ti[20:30] == ti[2]).all()
    # torch.topk's order for the tied rows is not the reference's contract;
    # the port's selection is the stable sort's, ties to the lower index
    probs = torch.full((3, tcfg.num_experts), 0.25)
    assert tmoe.select_experts(probs, K)[1].tolist() == [list(range(K))] * 3


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_bf16_routes_and_rows(arch):
    """bf16, four layers' weights on four inputs (one a layer): routes agree
    on at least BF16_AGREE of the (token, layer) pairs, and every token
    whose routes and keeps agree is within the bf16 tolerance."""
    jcfg, tcfg = _configs(arch, "bfloat16")
    agree = total = 0
    for layer in range(4):
        tree = _np_tree(jcfg, seed=layer)
        x = np.random.default_rng(100 + layer).standard_normal(
            (1, 80, 128)).astype(np.float32)
        want, got, (ri, rk), (ti, tk), _ = _run(arch, "bfloat16", x, tree)
        same = (ti == ri).all(-1) & (tk == rk).all(-1)
        agree += int(same.sum())
        total += same.size
        np.testing.assert_allclose(got[0][same], want[0][same], **BF16_TOL)
    assert agree / total >= BF16_AGREE, agree / total


def test_routes_are_recorded_only_when_asked():
    _, tcfg = _configs("mixtral-8x22b")
    tree = _trees(_np_tree(_configs("mixtral-8x22b")[0]), "float32")[1]
    x = torch.zeros((1, 4, 128))
    tmoe.moe_apply(tree, x, tcfg)
    assert tmoe._routes is None
    with tmoe.record_routes() as outer:
        with tmoe.record_routes() as inner:
            tmoe.moe_apply(tree, x, tcfg)
        tmoe.moe_apply(tree, x, tcfg)
    assert len(inner) == 1 and len(outer) == 1
    assert tmoe._routes is None


def test_capacity_per_call_parts_a_hit_from_cold_as_in_the_reference():
    """ROADMAP §C17: capacity is priced per forward call, so where
    assignments drop, a prefix-cache hit (its suffix routed alone) scores
    otherwise than a cold run of the whole request, in the reference as in
    the port. Embeddings that share one large component route every token
    alike, so both calls overflow their experts: the cold call drops the
    whole suffix, the hit only the suffix's last tokens. The port's
    hit-vs-cold gap equals the reference's (within 1e-4, float32) and is
    far from 0."""
    from repro.models import transformer as jtfm
    from repro.models.model import build as j_build
    from repro_torch.models import transformer as ttfm
    from repro_torch.models.params import params_from_numpy
    jcfg, tcfg = _configs("mixtral-8x22b", chunk=0)
    tree = jax.tree_util.tree_map(np.asarray, materialize(
        jax.random.PRNGKey(3), j_build(jcfg).defs(), jnp.float32))
    rng = np.random.default_rng(3)
    tree["embed"]["tok"] = tree["embed"]["tok"] + 2.0 * rng.standard_normal(
        tcfg.d_model).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_numpy(tree, tcfg, device="cpu")
    P, S = 48, 16
    toks = rng.integers(0, tcfg.vocab_size, (1, P + S)).astype(np.int32)
    with tmoe.record_routes() as rec:
        cold, _ = ttfm.prefill(tp, tcfg, {"tokens": torch.from_numpy(
            toks).long()})
    assert all((~r["keep"][P:]).all() for r in rec)   # the suffix drops
    _, pkv = jtfm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :P])},
                          kv_keep=P)
    jcold, _ = jtfm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    jhit, _ = jtfm.prefill_with_prefix(
        jp, jcfg, {"tokens": jnp.asarray(toks[:, P:])}, pkv, P)
    with tmoe.record_routes() as rec:
        hit, _ = ttfm.prefill_with_prefix(
            tp, tcfg, {"tokens": torch.from_numpy(toks[:, P:]).long()},
            {n: torch.from_numpy(np.array(a)) for n, a in pkv.items()}, P)
    assert all(r["keep"][:8].all() for r in rec)      # the hit keeps some
    gap, want = (hit - cold).numpy(), np.asarray(jhit - jcold)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(gap, want, atol=1e-4, rtol=0)
