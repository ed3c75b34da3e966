"""The port's model layers and serving forwards against the JAX package.

Both sides get the same parameters: the reference tree from
``repro.runtime.sharding.materialize``, with its zero-initialized norms and
biases overwritten by seeded random values (so the ``(1 + w)`` scale and the
qkv bias are exercised), carried to the port by ``params_from_numpy``.
Forwards are compared in float32 at the reduced qwen1.5-0.5b config, at
the reduced granite-3-8b config (grouped-query attention: 4 query heads per
kv head, no qkv bias), at granite reduced to head_dim 128 (d_model 256,
8/2 heads), at the reduced llama3.1-8b config (4 query heads per kv
head, an untied LM head), at the reduced internvl2-2b (vlm: 2 query
heads per kv head) and musicgen-large (audio: MHA) configs, and at the
reduced MoE configs mixtral-8x22b (4 experts, top-2, a 16-token sliding
window) and llama4-scout-17b-a16e (4 experts, top-1, a shared expert),
and at phi3-mini-3.8b reduced to its head_dim of 96 (4 MHA heads):
logits and kept KV within 1e-4 (different summation orders over a 4-layer
model with O(1) activations; the MoE routes are equal at float32).

gemma2-9b (local_global) is held through the model API only, as the
reference runs it: reduced to its head_dim of 256 (4/2 heads) and an
8-token window, two (local, global) pairs, both softcaps and the
sqrt(d_model) embedding scale, ``prefill`` past the window against the
reference's within 1e-4 (logits and the {local, global} KV pair), the
twin of ``tests/test_model_consistency.py``'s window check, the
parameter bridge over ``blocks_local`` and ``blocks_global``, and the hit
forwards' refusal (ROADMAP §C20) beside the reference's own failure.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduce_config as j_reduce_config
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.models.model import build
from repro.runtime.sharding import materialize
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_mlp as fm
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttfm
from repro_torch.models.params import (init_params, param_defs,
                                      params_from_numpy)

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("qwen1.5-0.5b", "granite-3-8b", "llama3.1-8b", "internvl2-2b",
         "musicgen-large", "mixtral-8x22b", "llama4-scout-17b-a16e",
         "phi3-mini-3.8b")
# granite's head_dim, 4 query heads per kv head, at a CPU-test width
HD128 = dict(d_model=256, num_heads=8, num_kv_heads=2, head_dim=128)
# phi3's and gemma2's head dims at the reduced configs' 4 heads
HD96 = dict(head_dim=96)
GEMMA2 = "gemma2-9b"
GEMMA2_WIDTHS = dict(head_dim=256, sliding_window=8)


def _configs(chunk: int, arch: str = "qwen1.5-0.5b", **widths):
    over = dict(hybrid_chunk=chunk, dtype="float32", param_dtype="float32",
                **widths)
    jcfg = j_reduce_config(j_get_config(arch), **over)
    tcfg = reduce_config(get_config(arch), **over)
    return jcfg, tcfg


def _np_tree(jcfg, seed: int = 0):
    """Reference parameter tree as numpy, zero leaves made random."""
    tree = materialize(jax.random.PRNGKey(seed), build(jcfg).defs(),
                       jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    rng = np.random.default_rng(seed)

    def fill(a):
        if not a.any():
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map(fill, tree)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module", params=[
    (0, "qwen1.5-0.5b", {}), (16, "qwen1.5-0.5b", {}),
    (16, "granite-3-8b", {}), (0, "granite-3-8b", HD128),
    (16, "llama3.1-8b", {}), (16, "internvl2-2b", {}),
    (16, "musicgen-large", {}), (16, "mixtral-8x22b", {}),
    (16, "llama4-scout-17b-a16e", {}), (16, "phi3-mini-3.8b", HD96)],
    ids=["chunk0", "chunk16", "granite-chunk16", "granite-hd128-chunk0",
         "llama-chunk16", "internvl2-chunk16", "musicgen-chunk16",
         "mixtral-chunk16", "scout-chunk16", "phi3-hd96-chunk16"])
def model(request):
    chunk, arch, widths = request.param
    jcfg, tcfg = _configs(chunk, arch, **widths)
    tree = _np_tree(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_config_copy_matches_reference():
    for arch in ARCHS + (GEMMA2,):
        for chunk in (0, 2048):
            jcfg, tcfg = _configs(chunk, arch)
            assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        jcfg, tcfg = _configs(0, arch, **HD128)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        assert (dataclasses.asdict(j_get_config(arch))
                == dataclasses.asdict(get_config(arch)))
        full = get_config(arch)
        assert full.param_count() == j_get_config(arch).param_count()
    granite = get_config("granite-3-8b")
    assert (granite.num_heads // granite.num_kv_heads, granite.head_dim,
            granite.qkv_bias) == (4, 128, False)


def test_init_params_tree_matches_reference_shapes():
    for arch in ARCHS:
        jcfg, tcfg = _configs(0, arch)
        ref = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                     _np_tree(jcfg))
        got = init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
        got_shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), got)
        assert got_shapes == ref
        # the reference init scheme: zeros for norms/biases, scaled
        # elsewhere; the qkv biases exist only where the config has them
        blocks = got["blocks"]
        assert not blocks["ln1"].any()
        assert ("bq" in blocks["attn"]) == tcfg.qkv_bias
        if tcfg.qkv_bias:
            assert not blocks["attn"]["bq"].any()
        ffn = blocks["moe"] if tcfg.is_moe else blocks["mlp"]
        assert ("moe" in blocks) == tcfg.is_moe != ("mlp" in blocks)
        std = ffn["w_gate"].std().item()
        assert abs(std - tcfg.d_model ** -0.5) < 0.1 * tcfg.d_model ** -0.5
        again = init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
        assert torch.equal(again["embed"]["tok"], got["embed"]["tok"])


def test_params_from_numpy_rejects_a_foreign_tree():
    jcfg, tcfg = _configs(0)
    tree = _np_tree(jcfg)
    del tree["final_norm"]
    with pytest.raises(ValueError):
        params_from_numpy(tree, tcfg, device="cpu")
    tree = _np_tree(jcfg)
    tree["embed"]["tok"] = tree["embed"]["tok"][:-1]
    with pytest.raises(ValueError):
        params_from_numpy(tree, tcfg, device="cpu")


def test_rope_apply_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 24)).astype(np.int32)
    want = jl.rope_apply(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = tl.rope_apply(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_qkv_project_matches_reference(model):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 40, tcfg.d_model)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)[None] + 7
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["blocks"]["attn"])
    tp = ttfm.layer_params(tparams["blocks"], 1)["attn"]
    want = jl._qkv_project(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                           jcfg.hybrid_chunk)
    got = tl._qkv_project(tp, torch.from_numpy(x), tcfg,
                          torch.from_numpy(pos), tcfg.hybrid_chunk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


def test_mlp_apply_matches_reference(model):
    """The block's feed-forward: the MLP, or an MoE config's experts."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 40, tcfg.d_model)).astype(np.float32)
    name = "moe" if tcfg.is_moe else "mlp"
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"][name])
    tp = ttfm.layer_params(tparams["blocks"], 0)
    if tcfg.is_moe:
        want = jmoe.moe_apply(jp, jnp.asarray(x), jcfg,
                              hybrid_chunk=jcfg.hybrid_chunk)
    else:
        want = jl.mlp_apply(jp, jnp.asarray(x), chunk=jcfg.hybrid_chunk)
    got = ttfm._ffn(tp, torch.from_numpy(x), tcfg, tcfg.hybrid_chunk)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("S,keep", [(48, 32), (40, 0), (32, 64)])
def test_prefill_matches_reference(model, S, keep):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab_size, (1, S)).astype(np.int32)
    last = np.array([S - 5], np.int32)
    want_logits, want_kv = jtfm.prefill(
        jparams, jcfg, {"tokens": jnp.asarray(toks)}, kv_keep=keep,
        last_index=jnp.asarray(last))
    got_logits, got_kv = ttfm.prefill(
        tparams, tcfg, {"tokens": torch.from_numpy(toks).long()},
        kv_keep=keep, last_index=torch.from_numpy(last))
    assert got_logits.shape == (1, tcfg.vocab_size)
    assert got_logits.dtype == torch.float32
    np.testing.assert_allclose(_np(got_logits), _np(want_logits), **TOL)
    if keep == 0:
        assert got_kv is None and want_kv is None
        return
    for name in ("k", "v"):
        assert tuple(got_kv[name].shape) == want_kv[name].shape == (
            tcfg.num_layers, 1, min(keep, S), tcfg.num_kv_heads,
            tcfg.head_dim)
        np.testing.assert_allclose(_np(got_kv[name]), _np(want_kv[name]),
                                   **TOL)


@pytest.mark.parametrize("P,S,keep", [(32, 16, 48), (48, 24, 56), (32, 16, 0)])
def test_prefill_with_prefix_matches_reference(model, P, S, keep):
    """Solo-hit forward: the same cached prefix KV (the reference's own,
    from a prefill of the prefix) through both packages' suffix path."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tcfg.vocab_size, (1, P + S)).astype(np.int32)
    _, pkv = jtfm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :P])},
                          kv_keep=P)
    pkv_np = {n: np.array(a) for n, a in pkv.items()}
    last = np.array([S - 1], np.int32)
    want_logits, want_kv = jtfm.prefill_with_prefix(
        jparams, jcfg, {"tokens": jnp.asarray(toks[:, P:])},
        {n: jnp.asarray(a) for n, a in pkv_np.items()}, P, kv_keep=keep,
        last_index=jnp.asarray(last))
    got_logits, got_kv = ttfm.prefill_with_prefix(
        tparams, tcfg, {"tokens": torch.from_numpy(toks[:, P:]).long()},
        {n: torch.from_numpy(a) for n, a in pkv_np.items()}, P,
        kv_keep=keep, last_index=torch.from_numpy(last))
    np.testing.assert_allclose(_np(got_logits), _np(want_logits), **TOL)
    for name in ("k", "v"):
        assert tuple(got_kv[name].shape) == want_kv[name].shape
        np.testing.assert_allclose(_np(got_kv[name]), _np(want_kv[name]),
                                   **TOL)
    # the hit path is exact: it equals a cold prefill of prefix + suffix
    cold, _ = ttfm.prefill(tparams, tcfg,
                           {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(_np(got_logits), _np(cold), **TOL)


def test_cpu_forwards_launch_no_kernel(model):
    """On CPU tensors every kernel wrapper takes its plain version: the
    launch counters stay at 0 through a full prefill."""
    _, tcfg, _, tparams = model
    toks = torch.zeros((1, 32), dtype=torch.long)
    ttfm.prefill(tparams, tcfg, {"tokens": toks}, kv_keep=16)
    assert (rn.launches, fa.launches, fm.launches) == (0, 0, 0)


# ---- gemma2-9b: the local/global pair through the model API ------------------
@pytest.fixture(scope="module", params=[0, 16], ids=["chunk0", "chunk16"])
def gemma(request):
    jcfg, tcfg = _configs(request.param, GEMMA2, **GEMMA2_WIDTHS)
    tree = _np_tree(jcfg)
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, tcfg, device="cpu"))


@pytest.mark.parametrize("S,keep", [(48, 32), (40, 0), (24, 64)])
def test_gemma2_prefill_matches_reference(gemma, S, keep):
    """Every S is past the 8-token window: the local layers mask, the
    global ones do not; logits (both softcaps) and the kept KV pair within
    1e-4 of the reference's."""
    jcfg, tcfg, jparams, tparams = gemma
    rng = np.random.default_rng(13)
    toks = rng.integers(0, tcfg.vocab_size, (2, S)).astype(np.int32)
    want, want_kv = jtfm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                                 kv_keep=keep)
    got, got_kv = ttfm.prefill(tparams, tcfg,
                               {"tokens": torch.from_numpy(toks).long()},
                               kv_keep=keep)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert np.abs(_np(got)).max() <= tcfg.final_softcap
    if keep == 0:
        assert got_kv is None and want_kv is None
        return
    assert sorted(got_kv) == sorted(want_kv) == [
        "global_k", "global_v", "local_k", "local_v"]
    for name in got_kv:
        assert tuple(got_kv[name].shape) == want_kv[name].shape == (
            tcfg.num_layers // 2, 2, min(keep, S), tcfg.num_kv_heads, 256)
        np.testing.assert_allclose(_np(got_kv[name]), _np(want_kv[name]),
                                   **TOL)


def test_gemma2_local_global_window_matters(gemma):
    """Twin of ``tests/test_model_consistency.py``'s: a change of the first
    token moves the last token's logits (the global layers see it) while
    the outputs stay finite; both runs equal the reference's. Past the
    window a local layer's output at the last token ignores the first
    token: the layer's attention equals one over the window alone."""
    jcfg, tcfg, jparams, tparams = gemma
    S = 32
    toks = np.random.default_rng(12).integers(0, tcfg.vocab_size, (1, S))
    toks2 = toks.copy()
    toks2[0, 0] = (toks[0, 0] + 1) % tcfg.vocab_size
    got = []
    for t in (toks, toks2):
        want, _ = jtfm.prefill(jparams, jcfg, {"tokens": jnp.asarray(t)})
        out, _ = ttfm.prefill(tparams, tcfg, {"tokens": torch.from_numpy(t)})
        assert torch.isfinite(out).all()
        np.testing.assert_allclose(_np(out), _np(want), **TOL)
        got.append(_np(out))
    assert not np.allclose(got[0], got[1])
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, S, n, 256)).astype(np.float32)) for n in (4, 2, 2))
    full = tl.attention(q, k, v, window=8, softcap=50.0)
    k2 = k.clone()
    k2[:, 0] += 1.0
    moved = tl.attention(q, k2, v, window=8, softcap=50.0)
    assert torch.equal(full[:, 8:], moved[:, 8:])
    assert not torch.equal(full[:, :8], moved[:, :8])


def test_gemma2_embedding_scale_rounds_to_the_model_dtype():
    """sqrt(d_model) is rounded to the compute dtype before it scales the
    embedding, as the reference's ``jnp.asarray(..., dtype)``: 59.75 at
    gemma2-9b's 3584 in bfloat16."""
    full = get_config(GEMMA2)
    scale = torch.tensor(math.sqrt(full.d_model), dtype=torch.bfloat16)
    assert scale.item() == 59.75 == float(
        jnp.asarray(math.sqrt(full.d_model), jnp.bfloat16))
    jcfg, tcfg = _configs(0, GEMMA2, **GEMMA2_WIDTHS)
    tree = _np_tree(jcfg)
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    toks = torch.tensor([[3, 7, 11]])
    x = ttfm._inputs(tparams, tcfg, toks, None)
    want = tparams["embed"]["tok"][toks] * math.sqrt(tcfg.d_model)
    torch.testing.assert_close(x, want, atol=1e-6, rtol=1e-6)
    # embeds in place of tokens are not scaled (the reference's rule)
    assert torch.equal(ttfm._inputs(tparams, tcfg, None, x), x)


def test_gemma2_params_from_numpy_carries_the_pair():
    """``param_defs`` makes ``blocks_local`` and ``blocks_global`` of
    ``num_layers // 2`` blocks each (21 at the published 42), as the
    reference's ``model_defs``; the bridge carries both stacks, and a tree
    without one is refused; ``init_params`` draws the pair."""
    defs = param_defs(get_config(GEMMA2))
    assert {p[0] for p in defs} == {"embed", "blocks_local",
                                    "blocks_global", "final_norm"}
    assert defs[("blocks_local", "attn", "wq")][0] == (21, 3584, 16 * 256)
    jcfg, tcfg = _configs(0, GEMMA2, **GEMMA2_WIDTHS)
    tree = _np_tree(jcfg)
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    for stack in ("blocks_local", "blocks_global"):
        np.testing.assert_array_equal(
            tparams[stack]["mlp"]["w_up"].numpy(),
            tree[stack]["mlp"]["w_up"])
    ref = jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)
    got = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == ref
    del tree["blocks_global"]
    with pytest.raises(ValueError, match="blocks_global"):
        params_from_numpy(tree, tcfg, device="cpu")


def test_gemma2_hit_forwards_raise_where_the_reference_fails(gemma):
    """The prefix-cache hit forwards take no local_global config: the
    reference's scan ``params["blocks"]``, which its tree lacks (a
    ``KeyError``); the port raises ``NotImplementedError`` naming ROADMAP
    §C20 before touching the parameters."""
    jcfg, tcfg, jparams, tparams = gemma
    toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, (1, 24))
    _, jkv = jtfm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                          kv_keep=16)
    with pytest.raises(KeyError):
        jtfm.prefill_with_prefix(jparams, jcfg,
                                 {"tokens": jnp.asarray(toks[:, 16:])},
                                 jkv, 16)
    _, kv = ttfm.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                         kv_keep=16)
    with pytest.raises(NotImplementedError, match="§C20"):
        ttfm.prefill_with_prefix(tparams, tcfg,
                                 {"tokens": torch.from_numpy(toks[:, 16:])},
                                 kv, 16)
    with pytest.raises(NotImplementedError, match="§C20"):
        ttfm.prefill_packed_with_prefix(
            tparams, tcfg, torch.zeros((1, 8), dtype=torch.long),
            torch.zeros((1, 8), dtype=torch.int32), torch.tensor([7]), kv,
            torch.zeros((1, 16), dtype=torch.int32),
            torch.zeros((1, 8), dtype=torch.long))
