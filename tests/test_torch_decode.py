"""The port's decode path against the JAX package, on the CPU.

Flash decoding's plain version is held to the Pallas kernel (interpret
mode, through ``repro.kernels.ops.decode_attention``) and to
``ref.decode_attention_ref`` at the shapes of ``tests/test_kernels.py``,
with the dead cache slots filled with large finite values so that a mask
fault shows. The decode layers, ``init_cache`` and ``decode_step`` are held
to ``repro.models``' at the reduced qwen1.5-0.5b, granite-3-8b,
llama3.1-8b, internvl2-2b, musicgen-large, mixtral-8x22b,
llama4-scout-17b-a16e and phi3-mini-3.8b (reduced to its head_dim of 96)
configs (the ``arch`` fixture's params; granite and
llama have 4 query heads per kv head, internvl2 2, musicgen none shared,
and no qkv bias; the last five an untied LM head; mixtral and scout
mixtures of experts, whose decode runs each step's tokens through the
experts at once), on the same parameters (the reference tree with its
zero leaves made random, carried over by ``params_from_numpy``): float32 within 1e-4 (summation order over
four layers), bfloat16 within 2e-2 (rounding: the port keeps p in f32 in
P.V and the MLP's ``silu(g) * u`` in f32, ROADMAP §C2 and §C6). Inputs are
made with numpy from a seed and fed to both packages. MoE capacity is
priced per forward call (ROADMAP §C17): a decode step never fills an
expert, where a prefill over the same tokens may drop assignments, so a
decode step is held to the port's own prefill only where that prefill
dropped none (the chain itself is held to the reference's at every step).
gemma2-9b (reduced to its head_dim of 256 and an 8-token window) runs the
reference's ring/global pair: 8-slot local rings beside full global caches,
its chains held to the reference's in both dtypes and to the port's own
prefill in float32.
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
from repro.kernels import ops, ref
from repro.models import layers as jl
from repro.models import transformer as jtfm
from repro.models.model import build as j_build
from repro.runtime.sharding import materialize
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_mlp as fm
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.models.model import build
from repro_torch.models.params import param_defs, params_from_numpy

F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
# bf16 logits differ by rounding in proportion to their scale: BF16 holds
# for logits of std up to BF16_REF_STD (the tied heads' of qwen and granite,
# 0.22-0.23 here) and scales with a wider std, as chip_smoke.py's
# logits_limits scale its limits (the untied heads give std ~1.0)
BF16_REF_STD = 0.25
DEAD = 1e3                       # dead cache slots: large and finite
STEPS = 20


def _kernel_tol(dtype):
    """``tests/test_kernels.py``'s ``_tol`` for bf16; 1e-4 for f32."""
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else F32


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    jt = jnp.asarray(a, jnp.float32).astype(jnp.dtype(dtype))
    tt = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        getattr(torch, dtype))
    return jt, tt


def _caches(rng, B, S, KV, d, kv_len):
    k = rng.standard_normal((B, S, KV, d)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, d)).astype(np.float32)
    for b, n in enumerate(kv_len):
        k[b, n:] = DEAD
        v[b, n:] = -DEAD
    return k, v


# ---- flash decoding: plain version against the Pallas kernel and ref.py ------
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,KV,d,block_s", [
    (96, 4, 2, 16, 32),
    (64, 4, 4, 32, 64),
    (100, 8, 2, 16, 32),             # ragged cache length
    (96, 8, 2, 128, 32),             # granite: head_dim 128, G = 4
    (96, 4, 4, 96, 32),              # phi3: head_dim 96, G = 1
    (100, 4, 2, 256, 32),            # gemma2: head_dim 256, G = 2, ragged
])
def test_decode_attention_plain_matches_pallas_and_ref(S, H, KV, d, block_s,
                                                       dtype, softcap):
    rng = np.random.default_rng(3)
    kv_len = [S // 3, S]
    q = rng.standard_normal((2, 1, H, d)).astype(np.float32)
    k, v = _caches(rng, 2, S, KV, d, kv_len)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    jn = jnp.asarray(kv_len, jnp.int32)
    tn = torch.tensor(kv_len, dtype=torch.int32)
    got = da.decode_attention_plain(tq, tk, tv, tn, softcap=softcap)
    assert got.dtype == tq.dtype and got.shape == (2, 1, H, d)
    pallas = ops.decode_attention(jq, jk, jv, jn, softcap=softcap,
                                  block_s=block_s)
    oracle = ref.decode_attention_ref(jq.reshape(2, KV, H // KV, d), jk, jv,
                                      jn, softcap=softcap).reshape(2, 1, H, d)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _np(want), **_kernel_tol(dtype))
    # the wrapper takes the plain version for CPU tensors and launches nothing
    n0 = da.launches
    assert torch.equal(da.decode_attention(tq, tk, tv, tn, softcap=softcap),
                       got)
    assert da.launches == n0


def test_decode_attention_plain_row_with_no_live_slot_gives_zero():
    """kv_len 0 gives 0 (the reference's softmax over all-masked logits
    gives the mean of V instead; ROADMAP §C3); kv_len > S makes every slot
    live, as in the reference."""
    rng = np.random.default_rng(4)
    S, H, KV, d = 40, 4, 2, 16
    q = rng.standard_normal((3, 1, H, d)).astype(np.float32)
    k, v = _caches(rng, 3, S, KV, d, [S, S, 7])
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = da.decode_attention_plain(tq, tk, tv, torch.tensor([0, 99, 7]))
    assert not got[0].any()
    want = ref.decode_attention_ref(jnp.asarray(q).reshape(3, KV, 2, d),
                                    jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray([1, 99, 7], jnp.int32))
    np.testing.assert_allclose(_np(got[1:]),
                               np.asarray(want).reshape(3, 1, H, d)[1:],
                               **F32)


@pytest.mark.parametrize("per_sm", [1, 2, 4, 6, 16])
@pytest.mark.parametrize("rows,S", [(256, 32768), (32, 2048), (2, 100),
                                    (8, 4100), (1, 1), (4096, 64), (6, 0),
                                    (64, 32768)])     # granite: B 8 x KV 8
def test_split_rule_covers_the_cache(rows, S, per_sm):
    splits, chunk = da.split_rule(rows, S, 132, per_sm)
    assert splits >= 1 and chunk % da.KEY_TILE == 0
    assert splits * chunk >= S and (splits - 1) * chunk < max(S, 1)
    # the grid's waves: at least 85% of the slots that its waves offer
    # hold a block's whole chunk, where there is a wave's worth of tiles
    tiles, slots = -(-S // da.KEY_TILE), 132 * per_sm
    if rows * tiles >= 4 * slots:
        waves = -(-rows * splits // slots)
        assert rows * tiles >= 0.85 * waves * slots * (chunk // da.KEY_TILE)
    if (rows, S, per_sm) == (256, 32768, 6):   # qwen's decode: 768 blocks
        assert (splits, chunk) == (3, 10944)


# ---- decode layers -------------------------------------------------------------
QWEN = "qwen1.5-0.5b"
ARCHS = (QWEN, "granite-3-8b", "llama3.1-8b", "internvl2-2b",
         "musicgen-large", "mixtral-8x22b", "llama4-scout-17b-a16e",
         "phi3-mini-3.8b")
# widths a reduced config keeps from its published one: phi3's head_dim
# 96, gemma2's 256
WIDTHS = {"phi3-mini-3.8b": dict(head_dim=96),
          "gemma2-9b": dict(head_dim=256)}
GEMMA2 = "gemma2-9b"


def _configs(arch: str, window: int = 0, dtype: str = "float32"):
    over = dict(hybrid_chunk=0, dtype=dtype, param_dtype=dtype,
                sliding_window=window, **WIDTHS.get(arch, {}))
    jcfg = j_reduce_config(j_get_config(arch), **over)
    tcfg = reduce_config(get_config(arch), **over)
    return jcfg, tcfg


def _np_tree(jcfg, seed: int = 0):
    """Reference parameter tree as numpy (float32), zero leaves made
    random."""
    tree = materialize(jax.random.PRNGKey(seed), j_build(jcfg).defs(),
                       jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    rng = np.random.default_rng(seed)

    def fill(a):
        if not a.any():
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map(fill, tree)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return request.param


@functools.lru_cache(maxsize=None)
def _arch_tree(arch: str):
    return _np_tree(_configs(arch)[0])


@pytest.fixture(scope="module")
def tree(arch):
    return _arch_tree(arch)


@pytest.mark.parametrize("ring,kv_len", [(False, 5), (False, 24), (True, 5),
                                         (True, 24), (True, 70)])
def test_decode_attention_layer_matches_reference(ring, kv_len):
    rng = np.random.default_rng(6)
    B, S, H, KV, d = 2, 24, 4, 2, 32
    q = rng.standard_normal((B, 1, H, d)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KV, d)).astype(np.float32)
            for _ in range(2))
    want = jl.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.int32(kv_len), ring=ring)
    got = tl.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.tensor(kv_len),
                              ring=ring)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("ring,position", [(False, 6), (False, 20), (True, 5),
                                           (True, 13)])
def test_attention_decode_matches_reference_in_place(tree, arch, ring,
                                                     position):
    """Output and the written cache slot (mod S for a ring: position 13 of an
    8-slot ring writes slot 5; past the end of a 16-slot plain cache,
    position 20 writes slot 15, as the reference clamps) against the
    reference, whose caches come back as new arrays; the port writes into
    the tensors it was given."""
    jcfg, tcfg = _configs(arch, window=8 if ring else 0)
    p = jax.tree_util.tree_map(lambda a: a[0], tree["blocks"]["attn"])
    tp = {k: torch.from_numpy(np.array(a)) for k, a in p.items()}
    rng = np.random.default_rng(7)
    B, S = 2, 8 if ring else 16
    KV, hd = tcfg.num_kv_heads, tcfg.head_dim
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, S, KV, hd)).astype(np.float32)
              for _ in range(2))
    pos = np.full((B,), position, np.int32)
    jout, jk, jv = jl.attention_decode(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), jcfg,
        position=jnp.asarray(pos), k_cache=jnp.asarray(kc),
        v_cache=jnp.asarray(vc), ring=ring)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    ptrs = (tk.data_ptr(), tv.data_ptr())
    tout, rk, rv = tl.attention_decode(
        tp, torch.from_numpy(x), tcfg, position=torch.from_numpy(pos),
        k_cache=tk, v_cache=tv, ring=ring)
    assert rk is tk and rv is tv and (tk.data_ptr(), tv.data_ptr()) == ptrs
    np.testing.assert_allclose(_np(tout), _np(jout), **F32)
    slot = position % S if ring else min(position, S - 1)
    for got, want, old in ((tk, jk, kc), (tv, jv, vc)):
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        changed = np.flatnonzero((_np(got) != old).any(axis=(0, 2, 3)))
        assert changed.tolist() == [slot]


@pytest.mark.parametrize("window,max_len", [(0, 32), (8, 32), (8, 4)])
def test_init_cache_matches_reference(window, max_len):
    jcfg, tcfg = _configs(QWEN, window=window)
    want = jtfm.init_cache(jcfg, 3, max_len)
    got = ttfm.init_cache(tcfg, 3, max_len, device="cpu")
    assert sorted(got) == sorted(want) == ["k", "v"]
    for name in got:
        assert tuple(got[name].shape) == want[name].shape
        assert str(got[name].dtype) == f"torch.{want[name].dtype}"
        assert not got[name].any()


def test_init_cache_defaults_to_cuda():
    api = build(_configs(QWEN)[1])
    if torch.cuda.is_available():
        assert api.init_cache(1, 8)["k"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            api.init_cache(1, 8)


# ---- decode_step -----------------------------------------------------------------
def _prefill_no_drop(tapi, tparams, batch):
    """The port's prefill logits, and whether every MoE assignment of it
    got a slot (always, at a config without experts)."""
    with tmoe.record_routes() as rec:
        logits, _ = tapi.prefill(tparams, batch)
    return logits, all(bool(r["keep"].all()) for r in rec)


def _models(tree, arch: str, window: int, dtype: str = "float32"):
    jcfg, tcfg = _configs(arch, window=window, dtype=dtype)
    japi, tapi = j_build(jcfg), build(tcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    return jcfg, tcfg, japi, tapi, jparams, tparams


def test_decode_step_from_prefill_cache_matches_reference(tree, arch):
    """prefill(S) fills a cache, decode of token S matches the reference's
    decode and the port's own prefill(S + 1) (the twin of
    ``tests/test_model_consistency.py``'s dense check, at 1e-4); where an
    MoE prefill(S + 1) drops assignments, its gap to the decode equals the
    reference's."""
    jcfg, tcfg, japi, tapi, jparams, tparams = _models(tree, arch, 0)
    S, S_max = 31, 64
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (1, S + 1))
    _, jkv = japi.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])},
                          kv_keep=S)
    pad = ((0, 0), (0, 0), (0, S_max - S), (0, 0), (0, 0))
    jcache = {n: jnp.pad(jkv[n], pad) for n in ("k", "v")}
    jlog, _ = japi.decode_step(jparams, jnp.asarray(toks[:, S]), jcache,
                               jnp.array([S], jnp.int32))
    tt = torch.from_numpy(toks)
    _, tkv = tapi.prefill(tparams, {"tokens": tt[:, :S]}, kv_keep=S)
    cache = tapi.init_cache(1, S_max, device="cpu")
    for n in ("k", "v"):
        cache[n][:, :, :S] = tkv[n]
    tlog, _ = tapi.decode_step(tparams, tt[:, S], cache,
                               torch.tensor([S], dtype=torch.int32))
    np.testing.assert_allclose(_np(tlog), _np(jlog), **F32)
    full, no_drop = _prefill_no_drop(tapi, tparams, {"tokens": tt})
    if not no_drop:     # an MoE prefill that dropped: the reference's gap
        jfull, _ = japi.prefill(jparams, {"tokens": jnp.asarray(toks)})
        full = _np(full) - _np(jfull) + _np(jlog)
    np.testing.assert_allclose(_np(tlog), _np(full), **F32)


@functools.lru_cache(maxsize=None)
def _chains(arch: str, window: int, dtype: str):
    """A STEPS-step decode chain from an empty cache, B = 2, through both
    packages: per-step logits and the final caches (made once per arch,
    window and dtype; the tests read them)."""
    jcfg, tcfg, japi, tapi, jparams, tparams = _models(
        _arch_tree(arch), arch, window, dtype)
    toks = np.random.default_rng(11).integers(0, tcfg.vocab_size, (2, STEPS))
    jdec = jax.jit(japi.decode_step)
    jcache = japi.init_cache(2, STEPS + 4)
    cache = tapi.init_cache(2, STEPS + 4, device="cpu")
    jlogs, tlogs = [], []
    for t in range(STEPS):
        pos = np.full((2,), t, np.int32)
        jl_, jcache = jdec(jparams, jnp.asarray(toks[:, t]), jcache,
                           jnp.asarray(pos))
        tl_, cache = tapi.decode_step(tparams, torch.from_numpy(toks[:, t]),
                                      cache, torch.from_numpy(pos))
        jlogs.append(_np(jl_))
        tlogs.append(_np(tl_))
    return toks, tapi, tparams, jlogs, tlogs, jcache, cache


@pytest.mark.parametrize("window", [0, 8])
def test_decode_chain_matches_reference(arch, window):
    """20 steps from an empty cache (a ring of 8 slots wraps twice): every
    step's logits and the final caches within 1e-4 of the reference; no
    kernel launches on the CPU."""
    n0 = (rn.launches, fa.launches, fm.launches, da.launches)
    _, _, _, jlogs, tlogs, jcache, cache = _chains(arch, window,
                                                   "float32")
    assert (rn.launches, fa.launches, fm.launches, da.launches) == n0
    for t, (got, want) in enumerate(zip(tlogs, jlogs)):
        np.testing.assert_allclose(got, want, err_msg=f"step {t}", **F32)
    assert cache["k"].shape[2] == (8 if window else STEPS + 4)
    for n in ("k", "v"):
        np.testing.assert_allclose(_np(cache[n]), _np(jcache[n]), **F32)


@pytest.fixture(scope="module", params=[a for a in ARCHS
                                        if not get_config(a).is_moe])
def dense_arch(request):
    return request.param


@pytest.mark.parametrize("window", [0, 8])
def test_decode_chain_bf16_matches_reference(dense_arch, window):
    """bf16 chains at the configs without experts: a bf16 route flip moves
    an MoE row whole, so the MoE layer is held in bf16 at the module level
    (``tests/test_torch_moe.py``)."""
    _, _, _, jlogs, tlogs, _, _ = _chains(dense_arch, window, "bfloat16")
    scale = max(1.0, float(np.std(jlogs[0])) / BF16_REF_STD)
    for t, (got, want) in enumerate(zip(tlogs, jlogs)):
        np.testing.assert_allclose(got, want, err_msg=f"step {t}",
                                   **{k: v * scale for k, v in BF16.items()})


@pytest.mark.parametrize("window", [0, 8])
def test_decode_chain_matches_own_prefill(arch, window):
    """Each step's logits equal the port's prefill of the prefix up to that
    token (sliding-window attention in prefill, a ring cache in decode),
    at every step whose prefill dropped no MoE assignment (every step at
    the dense configs; 8 to 15 of the 20 at the MoE configs)."""
    toks, tapi, tparams, _, tlogs, _, _ = _chains(arch, window,
                                                  "float32")
    tt = torch.from_numpy(toks)
    held = 0
    for t in range(STEPS):
        want, no_drop = _prefill_no_drop(tapi, tparams,
                                         {"tokens": tt[:, :t + 1]})
        if no_drop:
            held += 1
            np.testing.assert_allclose(tlogs[t], _np(want),
                                       err_msg=f"step {t}", **F32)
    assert held >= (STEPS if not tapi.cfg.is_moe else 8)


def test_decode_step_updates_the_cache_in_place(tree, arch):
    _, tcfg, _, tapi, _, tparams = _models(tree, arch, 0)
    cache = tapi.init_cache(2, 12, device="cpu")
    g = torch.Generator().manual_seed(0)
    for n in ("k", "v"):
        cache[n].normal_(generator=g)
    before = {n: t.clone() for n, t in cache.items()}
    ptrs = {n: t.data_ptr() for n, t in cache.items()}
    logits, out = tapi.decode_step(tparams, torch.tensor([3, 4]), cache,
                                   torch.tensor([7, 7], dtype=torch.int32))
    assert out is cache and logits.shape == (2, tcfg.vocab_size)
    assert logits.dtype == torch.float32
    for n, t in out.items():
        assert t.data_ptr() == ptrs[n]
        changed = (t != before[n]).any(-1).any(-1).any(1)     # (L, S)
        assert changed.any(0).nonzero().flatten().tolist() == [7]
        assert changed[:, 7].all()                     # every layer


def test_build_fields_and_refusals():
    _, tcfg = _configs(QWEN)
    api = build(tcfg)
    assert api.cfg is tcfg and api.defs() == param_defs(tcfg)
    for name in ("prefill", "decode_step", "init_cache"):
        assert callable(getattr(api, name))
    with pytest.raises(NotImplementedError, match="A8"):
        api.train_loss({}, {})
    for over in (dict(family="ssm"), dict(family="hybrid")):
        with pytest.raises(NotImplementedError):
            build(dataclasses.replace(tcfg, **over))


def test_build_casts_parameters_to_the_config_dtype(tree, arch):
    """f32 parameters into a bf16 config: the API casts them, as the
    reference's ``build`` does, and the result is that of bf16 parameters."""
    _, tcfg = _configs(arch, dtype="bfloat16")
    api = build(tcfg)
    p32 = params_from_numpy(tree, dataclasses.replace(tcfg, dtype="float32"),
                            device="cpu")
    p16 = params_from_numpy(tree, tcfg, device="cpu")
    toks, pos = torch.tensor([1, 2]), torch.tensor([0, 0], dtype=torch.int32)
    a, _ = api.decode_step(p32, toks, api.init_cache(2, 4, device="cpu"), pos)
    b, _ = api.decode_step(p16, toks, api.init_cache(2, 4, device="cpu"), pos)
    assert torch.equal(a, b)


# ---- gemma2-9b: the ring/global cache pair -------------------------------------
@pytest.mark.parametrize("max_len", [24, 4])
def test_gemma2_init_cache_matches_reference(max_len):
    """The pair: local rings of min(window, max_len) slots, global caches
    of max_len, each of L // 2 layers."""
    jcfg, tcfg = _configs(GEMMA2, window=8)
    want = jtfm.init_cache(jcfg, 2, max_len)
    got = ttfm.init_cache(tcfg, 2, max_len, device="cpu")
    assert sorted(got) == sorted(want) == [
        "global_k", "global_v", "local_k", "local_v"]
    for name in got:
        assert tuple(got[name].shape) == want[name].shape
        assert not got[name].any()
    assert got["local_k"].shape[2] == min(8, max_len)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma2_decode_chain_matches_reference(dtype):
    """20 steps from an empty cache (the 8-slot local rings wrap twice, the
    24-slot global caches fill to 20): every step's logits against the
    reference's jitted ``decode_step`` (float32 1e-4; bfloat16 2e-2 scaled
    by the logits' std, as the dense chains), the four caches at float32;
    no kernel launches on the CPU."""
    n0 = (rn.launches, fa.launches, fm.launches, da.launches)
    _, _, _, jlogs, tlogs, jcache, cache = _chains(GEMMA2, 8, dtype)
    assert (rn.launches, fa.launches, fm.launches, da.launches) == n0
    tol = F32
    if dtype == "bfloat16":
        scale = max(1.0, float(np.std(jlogs[0])) / BF16_REF_STD)
        tol = {k: v * scale for k, v in BF16.items()}
    for t, (got, want) in enumerate(zip(tlogs, jlogs)):
        np.testing.assert_allclose(got, want, err_msg=f"step {t}", **tol)
    assert (cache["local_k"].shape[2], cache["global_k"].shape[2]) == (
        8, STEPS + 4)
    if dtype == "float32":
        for n in cache:
            np.testing.assert_allclose(_np(cache[n]), _np(jcache[n]), **F32)


def test_gemma2_decode_chain_matches_own_prefill():
    """Each step's logits equal the port's prefill of the sequence up to
    that token: the local layers' windowed prefill attention against their
    rings, the global layers' against their full caches."""
    toks, tapi, tparams, _, tlogs, _, _ = _chains(GEMMA2, 8, "float32")
    tt = torch.from_numpy(toks)
    for t in range(STEPS):
        want, _ = tapi.prefill(tparams, {"tokens": tt[:, :t + 1]})
        np.testing.assert_allclose(tlogs[t], _np(want), err_msg=f"step {t}",
                                   **F32)
