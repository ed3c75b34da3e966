"""The port's packed path (packed miss and packed hit) against the JAX
package, on the CPU.

- Kernel layer: the plain versions of the segmented and positioned
  attention modes against the Pallas kernel (``repro.kernels.ops.
  packed_flash_attention``, interpret mode) and its ``kernels/ref.py``
  oracles, and the port's tile-liveness rule against the Pallas
  ``debug_tile_map`` at the same block sizes.
- Model layer: ``prefill_packed`` and ``prefill_packed_with_prefix`` against
  the JAX functions in float32 at the reduced qwen1.5-0.5b config.
- Engine layer: the port's packed engine against ``repro.core.engine`` on
  one mixed hit/miss trace (no ``profile()``, so pack formation is
  deterministic) and against the port's solo engine; the copied
  batch-formation arithmetic against the reference's.

Inputs are made from a numpy seed and fed to both sides. Tolerances:
float32 1e-4 (summation order only; O(1) inputs); bfloat16 5e-2, as in
``tests/test_packed_prefill.py``; engine scores the repo's 2e-2 gate.
Attention outputs are compared on real rows only (``seg_q >= 0``): the port
returns 0 for a padding row, the Pallas kernel and
``ref.packed_flash_attention_ref`` a uniform average (ROADMAP §C).
"""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduce_config as j_reduce_config
from repro.core import engine as jengine
from repro.core import jct as jjct
from repro.core import scheduler as jsched
from repro.kernels import ops, ref
from repro.kernels.flash_attention import PAD_POS as J_PAD_POS
from repro.kernels.flash_attention import flash_attention as raw_flash
from repro.models import transformer as jtfm
from repro.models.model import build
from repro.runtime.sharding import materialize
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import jct as tjct
from repro_torch.core import scheduler as tsched
from repro_torch.core.engine import EngineConfig, PrefillOnlyEngine
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttfm
from repro_torch.models.params import params_from_numpy

# the plain tile rule the attention kernel's executed-tile map is held to
# lives beside its other user, chip_smoke.py
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SCORE_GATE = 2e-2
YES, NO = 5, 9


def _pair(a: np.ndarray, dtype: str = "float32"):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _ids(slens, S, plens=None, pmax=0):
    """numpy segment ids and positions of a packed layout as the port's
    model makes them (``tfm.packed_layout``, then for a hit
    ``tfm.packed_prefix_layout``): suffix segments of ``slens`` in S slots,
    each over its prefix of ``plens`` in a buffer of rows of pmax slots."""
    _, ids = smoke.packed_case("cpu", slens, S, plens, pmax)
    return {k: t.numpy() for k, t in ids.items()}


def _qkv(rng, Sq, Sk, H, KV, d):
    return (rng.standard_normal((1, Sq, H, d)).astype(np.float32),
            rng.standard_normal((1, Sk, KV, d)).astype(np.float32),
            rng.standard_normal((1, Sk, KV, d)).astype(np.float32))


# --------------------------------------------------------------------------
# kernel layer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lens,S,H,KV,d,window,softcap", [
    ((40, 30, 26), 96, 4, 4, 16, 0, 0.0),     # MHA
    ((40, 30, 20), 128, 4, 2, 16, 0, 0.0),    # GQA + a padding tail
    ((25, 45, 20), 96, 4, 2, 32, 13, 0.0),    # GQA + SWA + padding tail
    ((7, 80, 9), 112, 2, 1, 32, 5, 30.0),     # everything, skewed lengths
])
def test_segmented_plain_matches_pallas_and_ref(lens, S, H, KV, d, window,
                                                softcap, dtype):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, S, S, H, KV, d)
    seg = _ids(lens, S)["seg_q"]
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    got = fa.flash_attention(qt, kt, vt, window=window, softcap=softcap,
                             seg_q=torch.from_numpy(seg),
                             seg_k=torch.from_numpy(seg))
    assert got.dtype == qt.dtype and got.shape == qt.shape
    pallas = ops.packed_flash_attention(qj, kj, vj, jnp.asarray(seg),
                                        window=window, softcap=softcap,
                                        block_q=32, block_k=32)
    oracle = ref.packed_flash_attention_ref(
        *(a.transpose(0, 2, 1, 3) for a in (qj, kj, vj)), jnp.asarray(seg),
        window=window, softcap=softcap).transpose(0, 2, 1, 3)
    real = seg[0] >= 0
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got)[:, real], _np(want)[:, real],
                                   **tol)
    # a padding row has no live key: the port returns 0 there
    assert not _np(got)[:, ~real].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plens,slens,S,pmax,H,KV,d,window,softcap", [
    ((32, 0, 48), (20, 30, 10), 64, 48, 4, 4, 16, 0, 0.0),  # a miss row
    ((32, 16, 48), (20, 30, 10), 60, 64, 4, 2, 16, 0, 0.0),  # GQA, all hits
    ((48, 32), (25, 13), 40, 48, 4, 2, 32, 13, 0.0),         # GQA + SWA
    ((16, 64), (33, 30), 64, 64, 8, 2, 32, 0, 50.0),         # softcap
])
def test_positioned_plain_matches_pallas_and_ref(plens, slens, S, pmax, H, KV,
                                                 d, window, softcap, dtype):
    rng = np.random.default_rng(1)
    P = len(plens) * pmax
    q, k, v = _qkv(rng, S, S, H, KV, d)
    pk = rng.standard_normal((1, P, KV, d)).astype(np.float32)
    pv = rng.standard_normal((1, P, KV, d)).astype(np.float32)
    ids = _ids(slens, S, plens, pmax)
    seg, pos = ids["seg_q"], ids["pos_q"]
    (qj, qt), (kj, kt), (vj, vt), (pkj, pkt), (pvj, pvt) = (
        _pair(a, dtype) for a in (q, k, v, pk, pv))
    got = fa.flash_attention(
        qt, torch.cat([pkt, kt], 1), torch.cat([pvt, vt], 1), window=window,
        softcap=softcap, **{n: torch.from_numpy(a) for n, a in ids.items()})
    pallas = ops.packed_flash_attention(
        qj, kj, vj, jnp.asarray(seg), window=window, softcap=softcap,
        prefix_k=pkj, prefix_v=pvj, prefix_seg=jnp.asarray(ids["seg_k"][:, :P]),
        positions=jnp.asarray(pos),
        prefix_positions=jnp.asarray(ids["pos_k"][:, :P]),
        block_q=32, block_k=32)
    oracle = ref.packed_prefix_attention_ref(
        qj.transpose(0, 2, 1, 3),
        jnp.concatenate([pkj, kj], 1).transpose(0, 2, 1, 3),
        jnp.concatenate([pvj, vj], 1).transpose(0, 2, 1, 3),
        jnp.asarray(seg), jnp.asarray(ids["seg_k"]), jnp.asarray(pos),
        jnp.asarray(ids["pos_k"]), window=window, softcap=softcap
    ).transpose(0, 2, 1, 3)
    real = seg[0] >= 0
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got)[:, real], _np(want)[:, real],
                                   **tol)
    assert not _np(got)[:, ~real].any()


def _live_tiles(Sq, Sk, bq, bk, window=0, **ids):
    """(1, nq, nk) map of the tiles that hold at least one live pair."""
    live = fa._live_mask(Sq, Sk, causal=True, window=window, q_offset=0,
                         kv_valid=None, device="cpu",
                         **{n: torch.from_numpy(a) for n, a in ids.items()})
    nq, nk = -(-Sq // bq), -(-Sk // bk)
    live = torch.nn.functional.pad(live, (0, nk * bk - Sk, 0, nq * bq - Sq))
    return live.reshape(1, nq, bq, nk, bk).any(4).any(2).to(torch.int32)


def _pallas_tile_map(q, k, v, **kw):
    _, tmap = raw_flash(*(jnp.asarray(a).transpose(0, 2, 1, 3)
                          for a in (q, k, v)),
                        causal=True, block_q=32, block_k=32,
                        debug_tile_map=True,
                        **{n: jnp.asarray(a) for n, a in kw.items()})
    return np.asarray(tmap)


def test_padding_tail_block_runs_only_its_segments_tiles():
    """A packed miss with a padding tail: the Pallas rule lets the query
    block that holds the last segment's end and the padding run every tile
    of its causal range; the port's rule runs only that segment's tiles,
    and still every tile with a live pair."""
    rng = np.random.default_rng(9)
    lens, S = (100, 60, 40), 256                      # tail of 56 from 200
    seg = _ids(lens, S)["seg_q"]
    q, k, v = _qkv(rng, S, S, 2, 1, 16)
    want = _pallas_tile_map(q, k, v, seg_q=seg, seg_k=seg)
    got = smoke.tile_rule(S, S, seg_q=torch.from_numpy(seg),
                          seg_k=torch.from_numpy(seg)).numpy()
    assert want[0, 6].sum() == 7                      # rows 192..223
    assert got[0, 6].tolist() == [0, 0, 0, 0, 0, 1, 1, 0]
    assert not got[0, 7].any()                        # all padding
    np.testing.assert_array_equal(got[0, :6], want[0, :6])
    assert (got >= _live_tiles(S, S, 32, 32, seg_q=seg, seg_k=seg).numpy()
            ).all()


def test_segmented_tile_rule_matches_pallas_tile_map():
    """Twin of ``test_packed_prefill.py::test_cross_segment_tiles_are_
    skipped``: the port's tile rule (what its kernel runs) equals the Pallas
    kernel's executed-tile map at 32x32 tiles, and skips cross-segment
    tiles beyond the causal triangle."""
    rng = np.random.default_rng(2)
    lens = (40, 30, 26)
    S = sum(lens)
    q, k, v = _qkv(rng, S, S, 4, 2, 16)
    seg = _ids(lens, S)["seg_q"]
    want = _pallas_tile_map(q, k, v, seg_q=seg, seg_k=seg)
    got = smoke.tile_rule(S, S, seg_q=torch.from_numpy(seg),
                          seg_k=torch.from_numpy(seg))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got >= _live_tiles(S, S, 32, 32, seg_q=seg, seg_k=seg)).all()
    assert got[0, 2, 0] == 0 and got[0, 1, 0] == 1
    # the plain version runs no tiles: a CPU call takes no map
    with pytest.raises(ValueError):
        fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                           seg_q=torch.from_numpy(seg),
                           seg_k=torch.from_numpy(seg),
                           tile_map=torch.zeros((1, 3, 3), dtype=torch.int32))


def test_positioned_tile_rule_matches_pallas_tile_map():
    """Twin of ``test_packed_prefix.py::test_prefix_tiles_of_other_segments_
    are_skipped``: a query block never runs another segment's prefix tiles,
    in the Pallas map and in the port's rule alike."""
    rng = np.random.default_rng(3)
    plens, slens = (64, 64), (32, 32)
    S, P = sum(slens), sum(plens)
    q, k, v = _qkv(rng, S, P + S, 4, 2, 16)
    ids = _ids(slens, S, plens, 64)
    seg, seg_k, pos, pos_k = (ids[n] for n in ("seg_q", "seg_k", "pos_q",
                                               "pos_k"))
    want = _pallas_tile_map(q, k, v, seg_q=seg, seg_k=seg_k, pos_q=pos,
                            pos_k=pos_k)
    got = smoke.tile_rule(S, P + S, seg_q=torch.from_numpy(seg),
                          seg_k=torch.from_numpy(seg_k),
                          pos_q=torch.from_numpy(pos),
                          pos_k=torch.from_numpy(pos_k)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= _live_tiles(S, P + S, 32, 32, seg_q=seg, seg_k=seg_k,
                               pos_q=pos, pos_k=pos_k).numpy()).all()
    assert got[0, 0, 2] == got[0, 0, 3] == got[0, 1, 0] == got[0, 1, 1] == 0
    assert got[0, 0, 0] == got[0, 0, 1] == got[0, 1, 2] == got[0, 1, 3] == 1


@pytest.mark.parametrize("bq,window", [(32, 0), (64, 0), (32, 40)])
def test_engine_shaped_tile_rule_matches_pallas(bq, window):
    """The port's rule at another block size and with a window, on a layout
    shaped like the engine's packed hit (padded prefix rows, a miss row,
    ragged suffixes, padding slack), against the Pallas map: equal
    wherever neither the query block nor the key tile holds padding;
    elsewhere the port runs a subset of the Pallas tiles (its ranges skip
    padding tokens) that still covers every tile with a live pair."""
    rng = np.random.default_rng(4)
    plens, pmax, slens, S = (64, 0, 128), 128, (40, 56, 20), 128
    R = len(plens)
    ids = _ids(slens, S, plens, pmax)
    seg, seg_k, pos, pos_k = (ids[n] for n in ("seg_q", "seg_k", "pos_q",
                                               "pos_k"))
    q, k, v = _qkv(rng, S, R * pmax + S, 2, 1, 16)
    _, want = raw_flash(*(jnp.asarray(a).transpose(0, 2, 1, 3)
                          for a in (q, k, v)), causal=True, window=window,
                        seg_q=jnp.asarray(seg), seg_k=jnp.asarray(seg_k),
                        pos_q=jnp.asarray(pos), pos_k=jnp.asarray(pos_k),
                        block_q=bq, block_k=bq, debug_tile_map=True)
    got = smoke.tile_rule(S, R * pmax + S, window=window,
                          seg_q=torch.from_numpy(seg),
                          seg_k=torch.from_numpy(seg_k),
                          pos_q=torch.from_numpy(pos),
                          pos_k=torch.from_numpy(pos_k), block_q=bq,
                          block_k=bq)
    want = torch.from_numpy(np.array(want))
    pad_rows = torch.from_numpy((seg[0] < 0).reshape(-1, bq).any(1))
    pad_keys = torch.from_numpy((seg_k[0] < 0).reshape(-1, bq).any(1))
    clean = ~pad_rows[:, None] & ~pad_keys[None, :]
    assert torch.equal(got[0][clean], want[0][clean])
    assert (got <= want).all()
    assert (got >= _live_tiles(S, R * pmax + S, bq, bq, window=window,
                               seg_q=seg, seg_k=seg_k, pos_q=pos,
                               pos_k=pos_k)).all()
    assert 0 < int(got.sum()) < got.numel()           # some tiles skip


@pytest.mark.parametrize("mode,window", [("segmented", 0),
                                         ("segmented", 40),
                                         ("positioned", 0),
                                         ("positioned", 40)])
def test_tile_rule_at_the_bf16_kernel_tiles_matches_pallas(mode, window):
    """The rule the bf16 kernel's executed-tile map is held to, at its tile
    size (``fa.BLOCK_Q`` x ``fa.BLOCK_K``), against the Pallas
    ``debug_tile_map`` at the same block sizes, on a packed miss with a
    padding tail and a packed hit shaped like the engine's (padded prefix
    rows, a miss row): equal wherever neither the query block nor the key
    tile holds padding; elsewhere a subset of the Pallas tiles that still
    covers every tile with a live pair."""
    bq, bk = fa.BLOCK_Q, fa.BLOCK_K
    rng = np.random.default_rng(6)
    if mode == "segmented":
        S = 384
        ids = _ids((100, 60, 150, 40), S)                 # tail of 34
        Sk = S
    else:
        plens, pmax, S = (128, 0, 192), 192, 256
        ids = _ids((70, 40, 90), S, plens, pmax)
        Sk = len(plens) * pmax + S
    q, k, v = _qkv(rng, S, Sk, 2, 1, 16)
    _, want = raw_flash(*(jnp.asarray(a).transpose(0, 2, 1, 3)
                          for a in (q, k, v)), causal=True, window=window,
                        block_q=bq, block_k=bk, debug_tile_map=True,
                        **{n: jnp.asarray(a) for n, a in ids.items()})
    got = smoke.tile_rule(S, Sk, window=window, block_q=bq, block_k=bk,
                          **{n: torch.from_numpy(a) for n, a in ids.items()})
    want = torch.from_numpy(np.array(want))
    pad_rows = torch.from_numpy((ids["seg_q"][0] < 0).reshape(-1, bq).any(1))
    pad_keys = torch.from_numpy((ids["seg_k"][0] < 0).reshape(-1, bk).any(1))
    clean = ~pad_rows[:, None] & ~pad_keys[None, :]
    assert torch.equal(got[0][clean], want[0][clean])
    assert (got <= want).all()
    assert (got >= _live_tiles(S, Sk, bq, bk, window=window, **ids)).all()
    assert 0 < int(got.sum()) < got.numel()           # some tiles skip


def test_wrapper_refuses_positions_without_segments():
    q = torch.zeros((1, 8, 2, 16))
    pos = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, pos_q=pos, pos_k=pos)
    with pytest.raises(ValueError):
        fa.flash_attention_plain(q, q, q, pos_q=pos, pos_k=pos)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, seg_q=pos)            # seg_k missing
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, seg_q=pos, seg_k=pos, pos_q=pos,
                           pos_k=pos, q_offset=4)
    assert fa.launches == 0 and not any(fa.mode_launches.values())


# --------------------------------------------------------------------------
# model layer
# --------------------------------------------------------------------------

def _np_tree(jcfg, seed: int = 0):
    """Reference parameter tree as numpy, zero leaves made random (so the
    ``(1 + w)`` norm scale and the qkv bias are exercised)."""
    tree = materialize(jax.random.PRNGKey(seed), build(jcfg).defs(),
                       jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a if a.any()
        else (0.1 * rng.standard_normal(a.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def model():
    over = dict(hybrid_chunk=0, dtype="float32", param_dtype="float32")
    jcfg = j_reduce_config(j_get_config("qwen1.5-0.5b"), **over)
    tcfg = reduce_config(get_config("qwen1.5-0.5b"), **over)
    tree = _np_tree(jcfg)
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, tcfg, device="cpu"))


def test_prefill_packed_matches_reference(model):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(5)
    lens, S = (37, 61, 12, 50), 192                 # slack at the end
    lay = {k: t.numpy() for k, t in ttfm.packed_layout(
        [0] * len(lens), lens, S, smax=64).items()}
    segs, pos, last = lay["seg_ids"], lay["positions"], lay["last_indices"]
    toks = np.zeros((1, S), np.int32)
    keep = []
    off = 0
    for L in lens:
        toks[0, off:off + L] = rng.integers(0, tcfg.vocab_size, L)
        keep += list(off + np.arange((L // 16) * 16))   # block keep windows
        off += L
    kv_idx = np.asarray(keep + [0] * (128 - len(keep)), np.int32)
    want, want_kv = jtfm.prefill_packed(
        jparams, jcfg, jnp.asarray(toks), jnp.asarray(segs),
        jnp.asarray(pos), jnp.asarray(last), kv_indices=jnp.asarray(kv_idx))
    got, got_kv = ttfm.prefill_packed(
        tparams, tcfg, torch.from_numpy(toks).long(), torch.from_numpy(segs),
        torch.from_numpy(pos), torch.from_numpy(last),
        kv_indices=torch.from_numpy(kv_idx))
    assert got.shape == (len(lens), tcfg.vocab_size)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    for name in ("k", "v"):
        assert tuple(got_kv[name].shape) == want_kv[name].shape == (
            tcfg.num_layers, 1, 128, tcfg.num_kv_heads, tcfg.head_dim)
        np.testing.assert_allclose(_np(got_kv[name]), _np(want_kv[name]),
                                   **F32_TOL)
    # each segment's logits equal its own solo prefill's
    off = 0
    for n, L in enumerate(lens):
        solo, _ = ttfm.prefill(tparams, tcfg, {"tokens": torch.from_numpy(
            toks[:, off:off + L]).long()})
        np.testing.assert_allclose(_np(got[n]), _np(solo[0]), **F32_TOL)
        off += L


def test_prefill_packed_with_prefix_matches_reference(model):
    """The reference's batched per-segment einsum and the port's flat
    positioned kernel agree: logits and the kv_indices-gathered fresh KV;
    the port gives the same answer without the ghost rows."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(6)
    plens, slens = (32, 0, 48), (21, 30, 9)
    Nb, pmax, smax = 4, 64, 32                       # engine-style padding
    KV, hd, Lyr = tcfg.num_kv_heads, tcfg.head_dim, tcfg.num_layers
    reqs = [rng.integers(0, tcfg.vocab_size, p + s).astype(np.int32)
            for p, s in zip(plens, slens)]
    pk = np.zeros((Lyr, Nb, pmax, KV, hd), np.float32)
    pv = np.zeros_like(pk)
    for n, (t, p) in enumerate(zip(reqs, plens)):
        if p:
            _, kv = jtfm.prefill(jparams, jcfg,
                                 {"tokens": jnp.asarray(t[None, :p])},
                                 kv_keep=p)
            pk[:, n, :p] = np.asarray(kv["k"])[:, 0]
            pv[:, n, :p] = np.asarray(kv["v"])[:, 0]
    S = 64
    lay = {k: t.numpy() for k, t in ttfm.packed_layout(
        plens, slens, S, rows=Nb, smax=smax, pmax=pmax).items()}
    pos, last, seg_qidx = (lay[k] for k in ("positions", "last_indices",
                                            "seg_qidx"))
    # the reference's batched layout has Nb prefix rows and a scatter-back
    # map; the port's flat layout needs neither
    ppos = np.full((Nb, pmax), J_PAD_POS, np.int32)
    ppos[:len(plens)] = lay["prefix_pos"]
    inv_idx = np.zeros((S,), np.int32)
    rows_, cols = np.nonzero(seg_qidx >= 0)
    inv_idx[seg_qidx[rows_, cols]] = rows_ * smax + cols
    toks = np.zeros((1, S), np.int32)
    off = 0
    for t, p, s in zip(reqs, plens, slens):
        toks[0, off:off + s] = t[p:]
        off += s
    kv_idx = np.arange(S, dtype=np.int32)
    want, want_kv = jtfm.prefill_packed_with_prefix(
        jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(last),
        {"k": jnp.asarray(pk), "v": jnp.asarray(pv)}, jnp.asarray(ppos),
        jnp.asarray(seg_qidx), jnp.asarray(inv_idx),
        kv_indices=jnp.asarray(kv_idx))
    t = (lambda a: torch.from_numpy(a))
    for rows in (Nb, len(reqs)):                     # with / without ghosts
        got, got_kv = ttfm.prefill_packed_with_prefix(
            tparams, tcfg, t(toks).long(), t(pos), t(last),
            {"k": t(pk[:, :rows]), "v": t(pv[:, :rows])}, t(ppos[:rows]),
            t(seg_qidx), t(inv_idx), kv_indices=t(kv_idx))
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
        for name in ("k", "v"):
            assert tuple(got_kv[name].shape) == want_kv[name].shape
            real = np.asarray(seg_qidx[seg_qidx >= 0])
            np.testing.assert_allclose(_np(got_kv[name])[:, :, real],
                                       _np(want_kv[name])[:, :, real],
                                       **F32_TOL)
    # the packed hit is exact: each segment equals a cold prefill of its
    # whole request
    for n, tk in enumerate(reqs):
        cold, _ = ttfm.prefill(tparams, tcfg, {"tokens": t(tk[None]).long()})
        np.testing.assert_allclose(_np(got[n]), _np(cold[0]), **F32_TOL)


def test_packed_prefix_layout_ids_and_positions():
    """The engine's layout of a hit over a 2-token prefix beside a miss,
    and the attention's flat ids and positions made from it."""
    lay = ttfm.packed_layout([2, 0], [2, 3], 6, rows=3, smax=3, pmax=4)
    pos, ppos, seg_qidx = (lay[k] for k in ("positions", "prefix_pos",
                                            "seg_qidx"))
    assert lay["seg_ids"].tolist() == [[0, 0, 1, 1, 1, -1]]
    assert pos.tolist() == [[2, 3, 0, 1, 2, 0]]
    assert lay["last_indices"].tolist() == [1, 4]
    assert seg_qidx.tolist() == [[0, 1, -1], [2, 3, 4], [-1, -1, -1]]
    assert ppos[0, :2].tolist() == [0, 1]
    assert (ppos[0, 2:] == tl.PAD_POS).all() and (ppos[1] == tl.PAD_POS).all()
    seg_q, seg_k, pos_k = ttfm.packed_prefix_layout(pos, ppos, seg_qidx)
    assert seg_q.tolist() == [[0, 0, 1, 1, 1, -1]]
    assert seg_k.tolist() == [[0, 0, -1, -1, -1, -1, -1, -1,
                               0, 0, 1, 1, 1, -1]]
    assert pos_k[0, :2].tolist() == [0, 1]
    assert (pos_k[0, 2:8] == tl.PAD_POS).all()
    assert pos_k[0, 8:].tolist() == pos[0].tolist()


# --------------------------------------------------------------------------
# engine layer
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    jcfg = j_reduce_config(j_get_config("qwen1.5-0.5b"), hybrid_chunk=0)
    tcfg = reduce_config(get_config("qwen1.5-0.5b"), hybrid_chunk=0)
    jparams = materialize(jax.random.PRNGKey(0), build(jcfg).defs(),
                          jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tree, tcfg, device="cpu")


def _mixed_trace(vocab: int):
    """Two users' cached profiles, then a wave of hits and unrelated misses
    that co-pack (misses with misses, hits with hits and misses)."""
    rng = np.random.default_rng(7)
    profiles = [rng.integers(0, vocab, n).tolist() for n in (80, 64)]
    warm = [p + rng.integers(0, vocab, 8).tolist() for p in profiles]
    wave = ([rng.integers(0, vocab, n).tolist() for n in (40, 30)]
            + [profiles[0] + rng.integers(0, vocab, 20).tolist(),
               profiles[1] + rng.integers(0, vocab, 12).tolist(),
               rng.integers(0, vocab, 50).tolist()])
    return warm, wave


def _drive(eng, warm, wave):
    """Serve ``warm`` (one step, co-packed misses), then ``wave``; returns
    the per-step served ids and the results by submission order."""
    ids = [eng.submit(t, allowed_tokens=(YES, NO), now=float(i))
           for i, t in enumerate(warm)]
    steps = []
    while eng.queue:
        eng.step()
        steps.append(list(eng._last_step_ids))
    ids += [eng.submit(t, allowed_tokens=(YES, NO), now=10.0 + i)
            for i, t in enumerate(wave)]
    while eng.queue:
        eng.step()
        steps.append(list(eng._last_step_ids))
    pos = {rid: i for i, rid in enumerate(ids)}
    return ([[pos[r] for r in s] for s in steps],
            [eng.results[r] for r in ids])


def test_packed_engine_matches_reference_engine(engines):
    jcfg, tcfg, jparams, tparams = engines
    warm, wave = _mixed_trace(tcfg.vocab_size)
    ecfg = dict(cache_capacity_tokens=4096, pack_token_budget=512)
    want_steps, want = _drive(jengine.PrefillOnlyEngine(
        jcfg, jparams, jengine.EngineConfig(**ecfg)), warm, wave)
    eng = PrefillOnlyEngine(tcfg, tparams, EngineConfig(**ecfg),
                            device="cpu")
    got_steps, got = _drive(eng, warm, wave)
    assert got_steps == want_steps
    assert [g["n_cached"] for g in got] == [w["n_cached"] for w in want]
    # the trace exercised a packed miss and a packed hit
    kinds = {rec.kind for rec in eng.batch_records if rec.n_requests > 1}
    assert kinds == {"miss", "hit"}
    assert eng.stats()["packed_hit_requests"] >= 2
    for g, w in zip(got, want):
        for tok in (YES, NO):
            assert abs(g["scores"][tok] - w["scores"][tok]) < SCORE_GATE


def test_packed_engine_matches_solo_engine(engines):
    _, tcfg, _, tparams = engines
    warm, wave = _mixed_trace(tcfg.vocab_size)
    packed = PrefillOnlyEngine(tcfg, tparams, EngineConfig(
        cache_capacity_tokens=4096, pack_token_budget=512), device="cpu")
    _, got = _drive(packed, warm, wave)
    solo = PrefillOnlyEngine(tcfg, tparams, EngineConfig(
        max_pack_requests=1, cache_capacity_tokens=4096), device="cpu")
    solo_steps, want = _drive(solo, warm, wave)
    assert all(len(s) == 1 for s in solo_steps)
    assert packed.steps < solo.steps
    assert packed.forwards == packed.steps
    for g, w in zip(got, want):
        for tok in (YES, NO):
            assert abs(g["scores"][tok] - w["scores"][tok]) < SCORE_GATE
    recs = [r for r in packed.batch_records if r.kind == "hit"]
    assert recs and all(r.Nb >= r.n_requests and r.pmax > 0 for r in recs)
    assert packed.stats()["packed_requests"] > 0


def test_brownout_runs_hits_solo(engines):
    _, tcfg, _, tparams = engines
    warm, wave = _mixed_trace(tcfg.vocab_size)
    eng = PrefillOnlyEngine(tcfg, tparams, EngineConfig(
        cache_capacity_tokens=4096, pack_token_budget=512), device="cpu")
    eng.set_degraded(True)
    _drive(eng, warm, wave)
    assert eng.packed_hit_requests == 0
    assert any(r.kind == "miss" for r in eng.batch_records)


# --------------------------------------------------------------------------
# copies of the reference's batch-formation arithmetic
# --------------------------------------------------------------------------

def test_pick_backfill_copy_matches_reference():
    rng = np.random.default_rng(8)
    for trial in range(20):
        n = int(rng.integers(1, 8))
        arrivals = rng.integers(0, 3, n).astype(float)
        gains = [None if g < 0.1 else float(np.round(g, 1))
                 for g in rng.random(n)]
        tc = [(tsched.Request(n_input=10, arrival=a, req_id=i), 0)
              for i, a in enumerate(arrivals)]
        jc = [(jsched.Request(n_input=10, arrival=a, req_id=i), 0)
              for i, a in enumerate(arrivals)]
        ben = (lambda r, p: gains[r.req_id])
        assert (tsched.Scheduler("fifo", None).pick_backfill(tc, ben)
                == jsched.Scheduler("fifo", None).pick_backfill(jc, ben))


@pytest.mark.parametrize("shape_cost", [True, False])
def test_pack_shape_cost_and_autotune_copies_match_reference(engines,
                                                             shape_cost):
    jcfg, tcfg, jparams, tparams = engines
    ecfg = dict(shape_cost_model=shape_cost)
    jeng = jengine.PrefillOnlyEngine(jcfg, jparams,
                                     jengine.EngineConfig(**ecfg))
    teng = PrefillOnlyEngine(tcfg, tparams, EngineConfig(**ecfg),
                             device="cpu")
    for f in dataclasses.fields(jengine.EngineConfig):
        if hasattr(teng.ecfg, f.name):
            assert getattr(teng.ecfg, f.name) == getattr(jeng.ecfg, f.name)
    grid = [[(40, 0)], [(20, 64)], [(40, 0), (30, 0)],
            [(21, 32), (30, 0), (9, 48)], [(100, 0), (8, 512), (60, 128)],
            [(s, p) for s, p in zip((12, 33, 7, 64, 90), (0, 64, 1024, 0,
                                                           256))]]
    # unfitted (prior) and fitted shape models give the reference's prices
    samples = [(tjct.step_features(c, S, nb, sm, pm), 1e-5 * c + 1e-3)
               for c, S, nb, sm, pm in [(40, 64, 0, 0, 0), (100, 128, 2, 64,
                                                            128),
                                        (200, 256, 4, 64, 256),
                                        (30, 64, 0, 0, 128)] * 5]
    for fitted in (False, True):
        if fitted:
            teng.shape_jct.fit(samples)
            jeng.shape_jct.fit(samples)
        for rows in grid:
            assert teng._pack_shape(rows) == jeng._pack_shape(rows)
            assert teng._pack_cost(rows) == jeng._pack_cost(rows)
    fit = [(n, 0, 0.07 + 1.3e-5 * n) for n in (64, 128, 256, 512)] * 2
    teng.jct_model.fit(fit)
    jeng.jct_model.fit(fit)
    assert teng.autotune_packing(512) == jeng.autotune_packing(512)
    assert teng.ecfg.pack_prefix_budget == jeng.ecfg.pack_prefix_budget
    assert (jjct.step_features(50, 128, 4, 64, 256)
            == tjct.step_features(50, 128, 4, 64, 256))
