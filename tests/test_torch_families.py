"""The port's dense, vlm, audio and moe families on the CPU, beside the
model, engine, packed and decode twins that run llama3.1-8b, internvl2-2b,
musicgen-large, mixtral-8x22b and llama4-scout-17b-a16e at their reduced
widths (``tests/test_torch_{model,engine,packed,decode}.py``) and the MoE
layer's twins (``tests/test_torch_moe.py``): what those twins do not hold.

- Each config's published widths, parameter count, active parameter count
  (only the routed experts of an MoE config) and KV bytes a token, by
  hand, and its full-width tree's shapes against the reference's.
- Precomputed ``embeds`` in place of token ids (the vlm's input) through
  ``build(cfg).prefill`` and ``prefill_with_prefix``, against the JAX
  package at the reduced internvl2-2b and musicgen-large configs (4
  layers, d_model 128, 4 heads of 32, the family's GQA ratio) in float32
  and bfloat16, on the same parameters: the reference tree from
  ``repro.runtime.sharding.materialize`` with its zero leaves made random,
  carried to the port by ``params_from_numpy``; inputs from a numpy seed.
  Tolerances (|port - reference| <= atol + rtol |reference|): float32
  1e-4 (summation order only); bfloat16 5e-2, as ``tests/test_torch_
  packed.py`` and ``tests/test_packed_prefill.py`` hold bf16 forwards.
- Families the port does not run (SSM, hybrid) raise at the engine, the
  model API and ``param_defs``, naming their ROADMAP items; a local_global
  config (gemma2) raises at the engine and the hit forwards, naming
  ROADMAP §C20, beside the reference engine's own failure on it.
- The launcher builds a pool of the paper's model at reduced width.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduce_config as j_reduce_config
from repro.core import engine as jengine
from repro.models import transformer as jtfm
from repro.models.model import build as j_build
from repro.runtime.sharding import materialize
from repro_torch.configs import get_config, reduce_config
from repro_torch.core.engine import PrefillOnlyEngine
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttfm
from repro_torch.models.model import build
from repro_torch.models.params import param_defs, params_from_numpy

# the vlm and audio families, whose input paths the embeds test drives
EMBED_ARCHS = ("internvl2-2b", "musicgen-large")
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
YES, NO = 5, 9
# the published widths, by hand: (L, D, heads, kv heads, head_dim, d_ff,
# vocab, family, tied head, param_count, active_param_count, kv bytes a
# token in bf16)
FULL = {
    "llama3.1-8b": (32, 4096, 32, 8, 128, 14_336, 128_256, "dense", False,
                    8_030_261_248, 8_030_261_248, 131_072),
    "internvl2-2b": (24, 2048, 16, 8, 128, 8192, 92_553, "vlm", False,
                     1_889_146_880, 1_889_146_880, 98_304),
    "musicgen-large": (48, 2048, 32, 32, 64, 8192, 2048, "audio", False,
                       3_229_812_736, 3_229_812_736, 393_216),
    "mixtral-8x22b": (56, 6144, 48, 8, 128, 16_384, 32_768, "moe", False,
                      140_630_071_296, 39_161_468_928, 229_376),
    "llama4-scout-17b-a16e": (48, 5120, 40, 8, 128, 8192, 202_048, "moe",
                              False, 107_769_861_120, 17_172_894_720,
                              196_608),
    "phi3-mini-3.8b": (32, 3072, 32, 32, 96, 8192, 32_064, "dense", False,
                       3_821_079_552, 3_821_079_552, 393_216),
    "gemma2-9b": (42, 3584, 16, 8, 256, 14_336, 256_000, "dense", True,
                  9_241_404_928, 9_241_404_928, 344_064),
}
# the MoE and attention fields, by hand: (experts, experts a token, shared
# expert, sliding window)
MOE = {"mixtral-8x22b": (8, 2, False, 4096),
       "llama4-scout-17b-a16e": (16, 1, True, 0),
       "gemma2-9b": (0, 0, False, 4096)}
# gemma2's local/global fields, by hand: (local_global, attention softcap,
# final softcap)
LOCAL_GLOBAL = {"gemma2-9b": (True, 50.0, 30.0)}


def _configs(arch: str, dtype: str, chunk: int = 16):
    over = dict(hybrid_chunk=chunk, dtype=dtype, param_dtype=dtype)
    return (j_reduce_config(j_get_config(arch), **over),
            reduce_config(get_config(arch), **over))


def _np_tree(jcfg, seed: int = 0):
    """Reference parameter tree as numpy (float32), zero leaves (norms)
    made random so that the ``(1 + w)`` scales are exercised."""
    tree = materialize(jax.random.PRNGKey(seed), j_build(jcfg).defs(),
                       jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a if a.any()
        else (0.1 * rng.standard_normal(a.shape)).astype(np.float32), tree)


@functools.lru_cache(maxsize=None)
def _arch_tree(arch: str):
    """The reduced config's tree, the same in both dtypes (its leaves are
    float32; each side casts them to the config's dtype)."""
    return _np_tree(_configs(arch, "float32")[0])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype: str, what: str = "") -> None:
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what,
                               **TOL[dtype])


@pytest.fixture(scope="module", params=[(a, d) for a in EMBED_ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    arch, dtype = request.param
    jcfg, tcfg = _configs(arch, dtype)
    tree = _arch_tree(arch)
    jparams = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.dtype(dtype)), tree)
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams, dtype


# ---- configs ---------------------------------------------------------------

@pytest.mark.parametrize("arch", tuple(FULL))
def test_config_copy_and_quantities_match_reference(arch):
    """The published widths, by hand; the parameter count and KV bytes a
    token equal the reference's and the hand count, and the full-width
    tree's shapes the reference's (``tests/test_torch_model.py`` holds the
    configs equal field for field)."""
    full, ref = get_config(arch), j_get_config(arch)
    L, D, H, KV, hd, F, V, family, tied, params, active, kv = FULL[arch]
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size, full.family,
            full.tie_embeddings) == (L, D, H, KV, hd, F, V, family, tied)
    assert (full.num_experts, full.num_experts_per_tok, full.shared_expert,
            full.sliding_window) == MOE.get(arch, (0, 0, False, 0))
    assert (full.local_global, full.attn_softcap,
            full.final_softcap) == LOCAL_GLOBAL.get(arch, (False, 0.0, 0.0))
    assert full.param_count() == ref.param_count() == params
    assert full.active_param_count() == ref.active_param_count() == active
    assert full.kv_bytes_per_token() == ref.kv_bytes_per_token() == kv
    defs = param_defs(full)
    ref_defs = jax.tree_util.tree_leaves_with_path(
        j_build(ref).defs(), is_leaf=lambda x: hasattr(x, "shape"))
    assert {tuple(k.key for k in path): tuple(d.shape)
            for path, d in ref_defs} == {p: s for p, (s, _) in defs.items()}
    assert sum(int(np.prod(s)) for s, _ in defs.values()) == params


# ---- the embeds input ---------------------------------------------------------

def test_embeds_input_matches_reference(model):
    """Precomputed embeddings in place of token ids (the vlm stub's input),
    through ``build(cfg).prefill`` and ``prefill_with_prefix``: against the
    reference on the same embeddings; and, in the port, embeddings that
    are the tokens' own embedding rows give the tokens' logits exactly,
    without writing into the caller's tensor."""
    jcfg, tcfg, jparams, tparams, dtype = model
    rng = np.random.default_rng(5)
    P, S = 24, 16
    emb = rng.standard_normal((2, P + S, tcfg.d_model)).astype(np.float32)
    tdt = tl.torch_dtype(dtype)
    want, want_kv = j_build(jcfg).prefill(
        jparams, {"embeds": jnp.asarray(emb)}, kv_keep=P)
    tin = torch.from_numpy(emb)
    got, got_kv = build(tcfg).prefill(tparams, {"embeds": tin}, kv_keep=P)
    assert torch.equal(tin, torch.from_numpy(emb))
    _close(got, want, dtype, "logits")
    for n in ("k", "v"):
        _close(got_kv[n], want_kv[n], dtype, n)
    want_hit, _ = jtfm.prefill_with_prefix(
        jparams, jcfg, {"embeds": jnp.asarray(emb[:, P:])},
        {n: a for n, a in want_kv.items()}, P)
    got_hit, _ = ttfm.prefill_with_prefix(
        tparams, tcfg, {"embeds": torch.from_numpy(emb[:, P:])},
        {n: torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
         for n, a in want_kv.items()}, P)
    _close(got_hit, want_hit, dtype, "hit logits")
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, P + S)))
    rows = tparams["embed"]["tok"][toks]
    by_tokens, _ = build(tcfg).prefill(tparams, {"tokens": toks})
    by_rows, _ = build(tcfg).prefill(tparams, {"embeds": rows})
    assert torch.equal(by_rows, by_tokens)


# ---- gates and the launcher --------------------------------------------------

@pytest.mark.parametrize("over,item", [
    (dict(local_global=True), "ROADMAP §C20"),
    (dict(family="ssm"), "ROADMAP A6, SSM and hybrid"),
    (dict(family="hybrid", attn_every=2), "ROADMAP A6, SSM and hybrid")],
    ids=["local_global", "ssm", "hybrid"])
def test_unported_families_raise_naming_their_roadmap_item(over, item):
    """SSM and hybrid raise at the engine, the model API and
    ``param_defs``; a local_global config runs the model API (its prefill
    and decode twins are in ``tests/test_torch_{model,packed,decode}.py``)
    but raises at the engine and the hit forwards, naming §C20."""
    _, tcfg = _configs("llama3.1-8b", "float32")
    tparams = params_from_numpy(_arch_tree("llama3.1-8b"), tcfg, device="cpu")
    cfg = dataclasses.replace(tcfg, **over)
    toks = torch.zeros((1, 4), dtype=torch.long)
    fns = [lambda: PrefillOnlyEngine(cfg, tparams, device="cpu"),
           lambda: ttfm.prefill_with_prefix(tparams, cfg, {"tokens": toks},
                                            {}, 4)]
    if over.get("family"):
        fns += [lambda: build(cfg), lambda: param_defs(cfg),
                lambda: ttfm.prefill(tparams, cfg, {"tokens": toks})]
    else:
        assert build(cfg).cfg is cfg and ("blocks_local",) in {
            p[:1] for p in param_defs(cfg)}
    for fn in fns:
        with pytest.raises(NotImplementedError, match=item):
            fn()
    if over.get("family"):
        with pytest.raises(NotImplementedError, match="ROADMAP A6"):
            cfg.param_count()


def test_the_reference_engine_fails_on_gemma2_where_the_port_refuses():
    """ROADMAP §C20: the reference's engine takes a local_global config
    (its family gate passes dense) and fails at its first step that keeps
    KV, reading ``new_kv["k"]`` from a {local_k, ...} tree (a
    ``KeyError``); the port's engine refuses the config when it is made,
    with ``NotImplementedError`` naming §C20."""
    over = dict(hybrid_chunk=0, head_dim=256, sliding_window=8)
    jcfg = j_reduce_config(j_get_config("gemma2-9b"), **over)
    tcfg = reduce_config(get_config("gemma2-9b"), **over)
    tree = _np_tree(jcfg)
    ref = jengine.PrefillOnlyEngine(
        jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
        jengine.EngineConfig(cache_capacity_tokens=4096))
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, 48).tolist()
    ref.submit(toks, allowed_tokens=(YES, NO))
    with pytest.raises(KeyError):
        ref.step()
    with pytest.raises(NotImplementedError, match="§C20"):
        PrefillOnlyEngine(tcfg, params_from_numpy(tree, tcfg, device="cpu"),
                          device="cpu")


def test_make_pool_serves_the_papers_model_at_reduced_width():
    """``launch/serve.py``'s pool of llama3.1-8b instances (its reduced
    config, ``hybrid_chunk`` 0, on the bridged reference tree) scores a
    miss and a hit as the reference's engine does."""
    jcfg = j_reduce_config(j_get_config("llama3.1-8b"), hybrid_chunk=0)
    tree = _arch_tree("llama3.1-8b")
    pool = tserve.make_pool("llama3.1-8b", 2, device="cpu", params=tree)
    engs = list(pool.engines.values())
    assert len(engs) == 2 and (engs[0].params["lm_head"].data_ptr()
                               == engs[1].params["lm_head"].data_ptr())
    cfg = engs[0].cfg
    assert cfg == reduce_config(get_config("llama3.1-8b"), hybrid_chunk=0)
    assert not cfg.tie_embeddings and "lm_head" in engs[0].params
    rng = np.random.default_rng(9)
    user = rng.integers(0, cfg.vocab_size, 64).tolist()
    reqs = [user + rng.integers(0, cfg.vocab_size, n).tolist()
            for n in (8, 12)]
    ref = jengine.PrefillOnlyEngine(
        jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
        jengine.EngineConfig(cache_capacity_tokens=4096))
    for toks in reqs:
        rid, jrid = (engs[0].submit(toks, allowed_tokens=(YES, NO)),
                     ref.submit(toks, allowed_tokens=(YES, NO)))
        engs[0].step()
        ref.step()
        got, want = engs[0].results[rid], ref.results[jrid]
        assert got["n_cached"] == want["n_cached"]
        for tok in (YES, NO):
            assert abs(got["scores"][tok] - want["scores"][tok]) < 2e-2
    assert engs[0].results[rid]["n_cached"] > 0
