"""The port's CUDA kernels and engine on the card (marker ``cuda``).

Each kernel is held against its plain PyTorch version on the same CUDA
tensors over shapes the CPU tests cannot reach (every template
instantiation, ragged edges, strided inputs, float32 and bfloat16; for
attention also the segmented and positioned modes and their executed-tile
maps; for flash decoding ragged and empty rows, GQA groups and strided
cache views), the engine on the card, solo and packed, against the same
engine on the CPU, and the decode chain on the card against the CPU. The
module needs no JAX. On a host without CUDA every test skips. Run on a GPU
machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 1e-4 (summation order only); bfloat16 2e-2 + 2e-2·|y|
for RMSNorm (a few bf16 ulps after both sides round once), and for the
tensor-core attention and MLP kernels the limits ``chip_smoke.py`` sets from
their outputs' scale (``ATTN_BF16_TOL``, ``MLP_BF16_TOL``). Engine scores:
the repo's 2e-2 gate.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.core.engine import EngineConfig, PrefillOnlyEngine
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_mlp as fm
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models.params import init_params

pytestmark = pytest.mark.cuda

# the packed layouts and the plain tile rule are chip_smoke.py's, so these
# tests hold the kernel to what the smoke checks
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
ATTN_TOL = {torch.float32: TOL[torch.float32],
            torch.bfloat16: smoke.ATTN_BF16_TOL}
MLP_TOL = {torch.float32: TOL[torch.float32],
           torch.bfloat16: smoke.MLP_BF16_TOL}
DTYPES = [torch.float32, torch.bfloat16]
# flash decoding averages many slots into small outputs, so its bf16 atol is
# set well below them; the rtol covers one bf16 ulp
DEC_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-3, 2e-2)}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(dev, *shape, std=1.0, dtype=torch.float32, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)


def _close(got, want, dtype, tol=TOL):
    atol, rtol = tol[dtype]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,D,strided", [
    (1, 32, False), (37, 96, True), (512, 1024, False), (3, 4096, True)])
def test_rmsnorm_kernel_matches_plain(dev, T, D, strided, dtype):
    x = _randn(dev, T, D + (64 if strided else 0), dtype=dtype)[:, :D]
    w = _randn(dev, D, std=0.1, dtype=dtype, seed=1)
    n0 = rn.launches
    got = rn.rmsnorm(x, w)
    assert rn.launches == n0 + 1
    _close(got, rn.rmsnorm_plain(x, w), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Sq,Sk,H,KV,d,kw", [
    (1, 64, 64, 4, 4, 64, dict()),
    (2, 70, 70, 8, 2, 32, dict(window=13)),
    (1, 33, 33, 2, 1, 64, dict(softcap=30.0)),
    (3, 40, 100, 4, 2, 64, dict(causal=False, kv_valid=77)),
    (1, 17, 97, 4, 4, 64, dict(q_offset=80)),
    (1, 48, 1072, 16, 16, 64, dict(q_offset=1024, window=300)),
    (1, 8, 8, 2, 2, 32, dict(window=2, kv_valid=3)),    # fully masked rows
])
def test_flash_attention_kernel_matches_plain(dev, B, Sq, Sk, H, KV, d, kw,
                                              dtype):
    q = _randn(dev, B, Sq, H, d, dtype=dtype)
    k = _randn(dev, B, Sk, KV, d, dtype=dtype, seed=1)
    v = _randn(dev, B, Sk, KV, d, dtype=dtype, seed=2)
    n0 = fa.launches
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.launches == n0 + 1
    _close(got, fa.flash_attention_plain(q, k, v, **kw), dtype, ATTN_TOL)


def test_flash_attention_takes_the_model_layout_views(dev):
    """q/k/v as the model makes them: head-split views of one fused qkv
    projection (token stride (H + 2 KV) d), no copies."""
    B, S, H, KV, d = 2, 50, 4, 2, 32
    qkv = _randn(dev, B, S, (H + 2 * KV) * d, dtype=torch.bfloat16)
    q, k, v = torch.split(qkv, [H * d, KV * d, KV * d], dim=-1)
    q, k, v = (t.reshape(B, S, -1, d) for t in (q, k, v))
    assert not v.is_contiguous()
    _close(fa.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v),
           torch.bfloat16, ATTN_TOL)


def _packed_ids(dev, lens, S, plens=None, pmax=0):
    """(seg_q, seg_k, pos_q, pos_k) of a packed layout as the model makes
    them (``chip_smoke.packed_case``: suffix segments of ``lens`` in S
    slots, with ``plens`` each over its prefix in a buffer of pmax-slot
    rows ahead of the fresh keys); positions are None for a packed miss."""
    _, ids = smoke.packed_case(dev, lens, S, plens, pmax)
    return (ids["seg_q"], ids["seg_k"], ids.get("pos_q"), ids.get("pos_k"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lens,S,H,KV,d,kw", [
    ((40, 30, 26), 96, 4, 4, 64, dict()),
    ((7, 80, 9, 33), 160, 8, 2, 32, dict(window=13)),      # padding tail
    ((300, 64, 400, 17, 120), 1000, 16, 16, 64, dict()),   # ragged, S % 32
    ((5, 3), 70, 2, 1, 64, dict(softcap=30.0)),            # mostly padding
])
def test_segmented_kernel_matches_plain(dev, lens, S, H, KV, d, kw, dtype):
    q = _randn(dev, 1, S, H, d, dtype=dtype)
    k = _randn(dev, 1, S, KV, d, dtype=dtype, seed=1)
    v = _randn(dev, 1, S, KV, d, dtype=dtype, seed=2)
    seg_q, seg_k, _, _ = _packed_ids(dev, lens, S)
    n0, m0 = fa.launches, fa.mode_launches["segmented"]
    bq, bk = fa.tile_shape(dtype)
    tmap = torch.empty((1, -(-S // bq), -(-S // bk)), dtype=torch.int32,
                       device=dev)
    got = fa.flash_attention(q, k, v, seg_q=seg_q, seg_k=seg_k,
                             tile_map=tmap, **kw)
    assert (fa.launches, fa.mode_launches["segmented"]) == (n0 + 1, m0 + 1)
    _close(got, fa.flash_attention_plain(q, k, v, seg_q=seg_q, seg_k=seg_k,
                                         **kw), dtype, ATTN_TOL)
    assert not got[0, seg_q[0] < 0].any()         # padding rows give 0
    want_map = smoke.tile_rule(S, S, seg_q=seg_q, seg_k=seg_k,
                               window=kw.get("window", 0), block_q=bq,
                               block_k=bk)
    assert torch.equal(tmap, want_map)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("plens,lens,S,pmax,H,KV,d,kw", [
    ((32, 0, 48), (20, 30, 10), 64, 64, 4, 4, 64, dict()),
    ((1024, 768, 512, 1024), (128, 96, 160, 128), 512, 1024, 16, 16, 64,
     dict()),                                      # the chip_smoke shape
    ((48, 32), (25, 13), 40, 64, 8, 2, 32, dict(window=20)),
    ((16, 64, 0), (33, 30, 2), 70, 128, 4, 2, 64, dict(softcap=50.0)),
])
def test_positioned_kernel_matches_plain(dev, plens, lens, S, pmax, H, KV, d,
                                         kw, dtype):
    Sk = len(plens) * pmax + S
    q = _randn(dev, 1, S, H, d, dtype=dtype)
    k = _randn(dev, 1, Sk, KV, d, dtype=dtype, seed=1)
    v = _randn(dev, 1, Sk, KV, d, dtype=dtype, seed=2)
    ids = _packed_ids(dev, lens, S, plens, pmax)
    names = dict(zip(("seg_q", "seg_k", "pos_q", "pos_k"), ids))
    m0 = fa.mode_launches["positioned"]
    bq, bk = fa.tile_shape(dtype)
    tmap = torch.empty((1, -(-S // bq), -(-Sk // bk)), dtype=torch.int32,
                       device=dev)
    got = fa.flash_attention(q, k, v, tile_map=tmap, **names, **kw)
    assert fa.mode_launches["positioned"] == m0 + 1
    _close(got, fa.flash_attention_plain(q, k, v, **names, **kw), dtype,
           ATTN_TOL)
    want_map = smoke.tile_rule(S, Sk, window=kw.get("window", 0),
                               block_q=bq, block_k=bk, **names)
    assert torch.equal(tmap, want_map)
    # other rows' tiles skip: at 32 x 32 tiles in every layout here; at the
    # bf16 kernel's 64 x 64 tiles a single query block may hold every
    # segment, and then every tile holds a live pair
    assert int(tmap.sum()) < tmap.numel() or tmap.shape[1] == 1


def test_packed_modes_take_strided_views(dev):
    """q/k/v as head-split views of one fused qkv projection."""
    S, H, KV, d = 96, 4, 2, 64
    qkv = _randn(dev, 1, S, (H + 2 * KV) * d, dtype=torch.bfloat16)
    q, k, v = torch.split(qkv, [H * d, KV * d, KV * d], dim=-1)
    q, k, v = (t.reshape(1, S, -1, d) for t in (q, k, v))
    seg_q, seg_k, _, _ = _packed_ids(dev, (40, 30, 20), S)
    _close(fa.flash_attention(q, k, v, seg_q=seg_q, seg_k=seg_k),
           fa.flash_attention_plain(q, k, v, seg_q=seg_q, seg_k=seg_k),
           torch.bfloat16, ATTN_TOL)
    pos = torch.arange(S, device=dev, dtype=torch.int32)[None]
    _close(fa.flash_attention(q, k, v, seg_q=seg_q, seg_k=seg_k, pos_q=pos,
                              pos_k=pos),
           fa.flash_attention_plain(q, k, v, seg_q=seg_q, seg_k=seg_k),
           torch.bfloat16, ATTN_TOL)


def test_wrapper_refuses_positions_without_segments(dev):
    q = _randn(dev, 1, 8, 2, 64)
    pos = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    n0 = fa.launches
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, pos_q=pos, pos_k=pos)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, seg_q=pos, seg_k=pos.cpu())
    assert fa.launches == n0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,D,F", [
    (1, 32, 40),          # ragged last d_ff chunk, one token
    (100, 128, 352),      # ragged token tile
    (9, 512, 64),         # 4 columns per thread, half of them masked
    (513, 1024, 2816),    # the model's MLP, one token past a tile
    (16, 1024, 2816),     # a decode step: the narrowest tiles, d_ff split
    (128, 1024, 2816),    # a solo hit: d_ff split in two
    (2048, 1024, 2816),   # a miss: the widest tiles, no split
    (77, 96, 200),        # ragged in M, N and K of both products
])
def test_fused_mlp_kernel_matches_plain(dev, T, D, F, dtype):
    x = _randn(dev, T, D, dtype=dtype)
    ws = (_randn(dev, D, F, std=D ** -0.5, dtype=dtype, seed=1),
          _randn(dev, D, F, std=D ** -0.5, dtype=dtype, seed=2),
          _randn(dev, F, D, std=F ** -0.5, dtype=dtype, seed=3))
    n0 = fm.launches
    got = fm.fused_mlp(x, *ws)
    assert fm.launches == n0 + 1
    _close(got, fm.fused_mlp_plain(x, *ws), dtype, MLP_TOL)


def test_fused_mlp_bf16_takes_views_and_refuses_what_it_cannot_copy(dev):
    """x as a strided view of a wider activation is read (the wrapper makes
    it contiguous); d_ff not a multiple of 8 is refused (the bf16 kernels
    copy 16-byte rows), and a refused call counts no launch."""
    dtype = torch.bfloat16
    wide = _randn(dev, 40, 160, dtype=dtype)
    x = wide[:, 1:129]
    ws = (_randn(dev, 128, 64, std=0.1, dtype=dtype, seed=1),
          _randn(dev, 128, 64, std=0.1, dtype=dtype, seed=2),
          _randn(dev, 64, 128, std=0.1, dtype=dtype, seed=3))
    _close(fm.fused_mlp(x, *ws), fm.fused_mlp_plain(x, *ws), dtype, MLP_TOL)
    n0 = fm.launches
    with pytest.raises(ValueError):
        fm.fused_mlp(x, _randn(dev, 128, 60, dtype=dtype),
                     _randn(dev, 128, 60, dtype=dtype),
                     _randn(dev, 60, 128, dtype=dtype))
    assert fm.launches == n0


def test_flash_attention_bf16_refuses_unaligned_rows(dev):
    """The bf16 kernel copies 16-byte rows: a view whose token stride is not
    a multiple of 8 elements is refused, not copied; f32 takes it."""
    S, H, d = 20, 2, 32
    for dtype in DTYPES:
        qkv = _randn(dev, 1, S, H * d * 3 + 4, dtype=dtype)
        q, k, v = (qkv[..., i * H * d:(i + 1) * H * d].reshape(1, S, H, d)
                   for i in range(3))
        if dtype == torch.float32:
            _close(fa.flash_attention(q, k, v),
                   fa.flash_attention_plain(q, k, v), dtype, ATTN_TOL)
            continue
        n0 = fa.launches
        with pytest.raises(ValueError):
            fa.flash_attention(q, k, v)
        assert fa.launches == n0


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    half = _randn(dev, 4, 64, dtype=torch.float16)
    with pytest.raises(TypeError):
        rn.rmsnorm(half, torch.zeros(64, device=dev, dtype=torch.float16))
    q = _randn(dev, 1, 8, 2, 48)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)                   # head_dim 48
    q = _randn(dev, 1, 8, 2, 128)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)                   # head_dim 128
    x = _randn(dev, 4, 48)
    with pytest.raises(ValueError):
        fm.fused_mlp(x, _randn(dev, 48, 64), _randn(dev, 48, 64),
                     _randn(dev, 64, 48))             # D not a multiple of 32
    x = _randn(dev, 4, 2048)
    with pytest.raises(ValueError):
        fm.fused_mlp(x, _randn(dev, 2048, 64), _randn(dev, 2048, 64),
                     _randn(dev, 64, 2048))           # D above 1024
    with pytest.raises(ValueError):
        rn.rmsnorm(_randn(dev, 4, 64), torch.zeros(64))   # weight on the CPU


def test_engine_on_the_card_matches_the_cpu_engine(dev):
    cfg = reduce_config(get_config("qwen1.5-0.5b"), hybrid_chunk=0)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    profile = rng.integers(0, cfg.vocab_size, 150).tolist()
    trace = [profile + rng.integers(0, cfg.vocab_size, n).tolist()
             for n in (20, 30, 12)]
    out = {}
    for device in ("cpu", dev):
        eng = PrefillOnlyEngine(cfg, params, EngineConfig(
            cache_capacity_tokens=2048), device=device)
        n0 = (rn.launches, fa.launches, fm.launches)
        res = []
        for toks in trace:
            rid = eng.submit(toks, allowed_tokens=(5, 9))
            eng.step()
            res.append(eng.results[rid])
        used = tuple(a - b for a, b in zip(
            (rn.launches, fa.launches, fm.launches), n0))
        per = (2 * cfg.num_layers + 1, cfg.num_layers, cfg.num_layers)
        assert used == (tuple(len(trace) * p for p in per)
                        if device == dev else (0, 0, 0))
        out[str(device)] = res
    cpu, gpu = out["cpu"], out[str(dev)]
    assert [r["n_cached"] for r in gpu] == [r["n_cached"] for r in cpu]
    assert gpu[1]["n_cached"] > 0
    for g, c in zip(gpu, cpu):
        for t in (5, 9):
            assert abs(g["scores"][t] - c["scores"][t]) < 2e-2


def test_packed_engine_on_the_card_matches_the_cpu_engine(dev):
    """Packed miss and packed hit steps on the card: the same packs, cached
    lengths and scores as on the CPU, and 49/24/24 launches per forward."""
    cfg = reduce_config(get_config("qwen1.5-0.5b"), hybrid_chunk=0)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    profiles = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (80, 64)]
    warm = [p + rng.integers(0, cfg.vocab_size, 8).tolist() for p in profiles]
    wave = ([rng.integers(0, cfg.vocab_size, n).tolist() for n in (40, 30)]
            + [profiles[0] + rng.integers(0, cfg.vocab_size, 20).tolist(),
               profiles[1] + rng.integers(0, cfg.vocab_size, 12).tolist(),
               rng.integers(0, cfg.vocab_size, 50).tolist()])
    out = {}
    for device in ("cpu", dev):
        eng = PrefillOnlyEngine(cfg, params, EngineConfig(
            cache_capacity_tokens=4096, pack_token_budget=512), device=device)
        n0 = (rn.launches, fa.launches, fm.launches)
        m0 = dict(fa.mode_launches)
        steps, res = [], []
        for group in (warm, wave):
            ids = [eng.submit(t, allowed_tokens=(5, 9)) for t in group]
            while eng.queue:
                eng.step()
                steps.append(tuple(eng._last_step_ids))
            res += [eng.results[i] for i in ids]
        used = tuple(a - b for a, b in zip(
            (rn.launches, fa.launches, fm.launches), n0))
        per = (2 * cfg.num_layers + 1, cfg.num_layers, cfg.num_layers)
        assert used == (tuple(eng.forwards * p for p in per)
                        if device == dev else (0, 0, 0))
        kinds = {r.kind for r in eng.batch_records if r.n_requests > 1}
        assert kinds == {"miss", "hit"}
        if device == dev:
            for mode, kind in (("segmented", "miss"), ("positioned", "hit")):
                n = sum(r.kind == kind for r in eng.batch_records)
                assert fa.mode_launches[mode] - m0[mode] == n * cfg.num_layers
        out[str(device)] = ([len(s) for s in steps], res)
    (cpu_steps, cpu), (gpu_steps, gpu) = out["cpu"], out[str(dev)]
    assert gpu_steps == cpu_steps
    assert [r["n_cached"] for r in gpu] == [r["n_cached"] for r in cpu]
    for g, c in zip(gpu, cpu):
        for t in (5, 9):
            assert abs(g["scores"][t] - c["scores"][t]) < 2e-2


# ---- flash decoding (B6) ------------------------------------------------------
def _decode_inputs(dev, B, S, H, KV, d, kv_len, dtype, seed=0):
    q = _randn(dev, B, 1, H, d, dtype=dtype, seed=seed)
    k = _randn(dev, B, S, KV, d, dtype=dtype, seed=seed + 1)
    v = _randn(dev, B, S, KV, d, dtype=dtype, seed=seed + 2)
    n = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    for b, L in enumerate(kv_len):           # dead slots: large, finite
        k[b, max(L, 0):] = 300.0
        v[b, max(L, 0):] = -300.0
    return q, k, v, n


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,KV,d,kv_len,kw", [
    (2, 96, 4, 4, 64, [32, 96], dict()),                  # G = 1
    (2, 100, 4, 2, 32, [1, 100], dict()),                 # G = 2, S % 32
    (3, 4100, 16, 2, 64, [4100, 1, 2049], dict()),        # G = 8
    (2, 77, 12, 4, 32, [77, 5], dict()),                  # G = 3 (padded to 4)
    (4, 1000, 8, 8, 64, [1, 999, 1000, 1234], dict()),    # kv_len > S: all live
    (2, 300, 8, 4, 32, [300, 17], dict(softcap=50.0)),
    (1, 64, 4, 1, 64, [64], dict(softcap=5.0)),           # G = 4, cap binds
])
def test_decode_attention_kernel_matches_plain(dev, B, S, H, KV, d, kv_len,
                                               kw, dtype):
    q, k, v, n = _decode_inputs(dev, B, S, H, KV, d, kv_len, dtype)
    n0 = da.launches
    got = da.decode_attention(q, k, v, n, **kw)
    torch.cuda.synchronize()
    assert da.launches == n0 + 1
    _close(got, da.decode_attention_plain(q, k, v, n, **kw), dtype, DEC_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_short_rows_leave_most_splits_empty(dev, dtype):
    """S = 32,768 with rows of 1 and 1000 live slots: most of the split
    rule's chunks hold no live slot, and their (m, l) = (-1e30, 0) partials
    must merge without NaN; a row with kv_len 0 gives 0."""
    kv_len = [1, 1000, 32768, 0]
    q, k, v, n = _decode_inputs(dev, 4, 32768, 4, 4, 64, kv_len, dtype)
    splits, _ = da.split_rule(4 * 4, 32768, da._sm_count(dev.index))
    assert splits > 8
    got = da.decode_attention(q, k, v, n)
    _close(got, da.decode_attention_plain(q, k, v, n), dtype, DEC_TOL)
    assert not got[3].any()


def test_decode_attention_takes_strided_cache_views(dev):
    """A layer of a stacked cache, a slot prefix of a longer cache and a
    head slice are read in place; a cache that is not unit-stride over d,
    or whose rows are not 16-byte aligned, is refused, not copied."""
    dtype = torch.bfloat16
    stack = _randn(dev, 3, 2, 80, 6, 64, dtype=dtype)
    vstack = _randn(dev, 3, 2, 80, 6, 64, dtype=dtype, seed=1)
    q = _randn(dev, 2, 1, 4, 64, dtype=dtype, seed=2)
    n = torch.tensor([50, 64], dtype=torch.int32, device=dev)
    for k, v in ((stack[1, :, :64, 1:5], vstack[1, :, :64, 1:5]),
                 (stack[2, :, 10:74, 2:6], vstack[0, :, 3:67, :4])):
        assert not k.is_contiguous()
        _close(da.decode_attention(q, k, v, n),
               da.decode_attention_plain(q, k, v, n), dtype, DEC_TOL)
    n0 = da.launches
    kt = stack[0, :, :64, :4].transpose(-1, -2).contiguous().transpose(-1, -2)
    with pytest.raises(ValueError):
        da.decode_attention(q, kt, vstack[0, :, :64, :4], n)
    odd = torch.zeros(2 * 64 * 4 * 64 + 1, dtype=dtype, device=dev)[1:]
    with pytest.raises(ValueError):
        da.decode_attention(q, odd.view(2, 64, 4, 64),
                            vstack[0, :, :64, :4], n)
    assert da.launches == n0


def test_decode_attention_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    q = _randn(dev, 2, 1, 4, 48)
    k = _randn(dev, 2, 16, 4, 48)
    n = torch.tensor([16, 16], dtype=torch.int32, device=dev)
    n0 = da.launches
    with pytest.raises(ValueError):
        da.decode_attention(q, k, k, n)                  # head_dim 48
    q = _randn(dev, 2, 1, 16, 64)
    k = _randn(dev, 2, 16, 1, 64)
    with pytest.raises(ValueError):
        da.decode_attention(q, k, k, n)                  # 16 heads per kv
    k = _randn(dev, 2, 16, 4, 64)
    with pytest.raises(ValueError):
        da.decode_attention(q, k, k, n.cpu())            # kv_len on the CPU
    with pytest.raises(ValueError):
        da.decode_attention(q, k, k, n[:1])              # kv_len not (B,)
    assert da.launches == n0


@pytest.mark.parametrize("window", [0, 8])
def test_decode_chain_on_the_card_matches_the_cpu(dev, window):
    """The reduced model's decode chain (20 steps from an empty cache, ring
    cache when windowed) on the card against the same chain on the CPU, at
    float32: logits within 1e-4 (the kernels against their plain versions
    over four layers), 2L+1/L/L launches per step, caches alike."""
    from repro_torch.models.model import build
    cfg = reduce_config(get_config("qwen1.5-0.5b"), hybrid_chunk=0,
                        dtype="float32", param_dtype="float32",
                        sliding_window=window)
    api = build(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gparams = _to(params, dev)
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 20)))
    caches = {"cpu": api.init_cache(2, 24, device="cpu"),
              "gpu": api.init_cache(2, 24, device=dev)}
    for t in range(20):
        pos = torch.full((2,), t, dtype=torch.int32)
        want, _ = api.decode_step(params, toks[:, t], caches["cpu"], pos)
        n0 = (rn.launches, da.launches, fm.launches, fa.launches)
        got, _ = api.decode_step(gparams, toks[:, t].to(dev), caches["gpu"],
                                 pos.to(dev))
        torch.cuda.synchronize()
        used = tuple(a - b for a, b in zip(
            (rn.launches, da.launches, fm.launches, fa.launches), n0))
        L_ = cfg.num_layers
        assert used == (2 * L_ + 1, L_, L_, 0)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    for name in ("k", "v"):
        torch.testing.assert_close(caches["gpu"][name].cpu(),
                                   caches["cpu"][name], atol=1e-5, rtol=1e-5)


def _to(tree, dev):
    return {k: (_to(v, dev) if isinstance(v, dict) else v.to(dev))
            for k, v in tree.items()}
