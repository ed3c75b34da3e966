"""The port's CUDA kernels and engine on the card (marker ``cuda``).

Each kernel is held against its plain PyTorch version on the same CUDA
tensors over shapes the CPU tests cannot reach (every template
instantiation, ragged edges, strided inputs, float32 and bfloat16; for
attention also the segmented and positioned modes and their executed-tile
maps; for flash decoding ragged and empty rows, rows ending at key-tile
and chunk edges, GQA groups on both kernels and strided cache views; for
RMSNorm the vector kernel's plans and the scalar kernel's widths), the
engine on the card, solo and packed, against the same
engine on the CPU, the engine's CUDA graphs (a replay's logits and kept KV
against an eager run of the same forward on the same inputs, bit for bit:
the same kernels and launch plans, no atomics), the decode chain on the
card against the CPU, and the offload tier (pinned demotions, a bitwise
round trip, a prefetch during a capture). The module needs no JAX. On a host without CUDA every test skips. Run on a GPU
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
import threading
import traceback

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.core import compiled, offload
from repro_torch.core.engine import EngineConfig, PrefillOnlyEngine
from repro_torch.core.prefix_cache import token_chain
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
    (1, 32, False), (37, 96, True), (512, 1024, False), (3, 4096, True),
    # the vector kernel's plans: two warps a row (3 vectors a thread), 8
    # warps a row, granite's main-path T at D 4096, qwen's at D 1024
    (5, 1536, False), (2, 8192, True), (2048, 4096, False), (16, 1024, True),
    # the scalar kernel's width: D not whole 16-byte vectors in bf16, a
    # row stride of D + 1, a base 2 elements off, a row past 1024 threads
    (7, 100, False), (9, 1024, "odd"), (6, 4096, "offset"),
    (1, 40000, False)])
def test_rmsnorm_kernel_matches_plain(dev, T, D, strided, dtype):
    if strided == "offset":
        x = _randn(dev, T * D + 2, dtype=dtype)[2:].view(T, D)
    else:
        pad = {True: 64, False: 0, "odd": 1}[strided]
        x = _randn(dev, T, D + pad, dtype=dtype)[:, :D]
    w = _randn(dev, D, std=0.1, dtype=dtype, seed=1)
    vector = rn.vector_rule(D, x.element_size(), x.stride(0), x.data_ptr(),
                            w.data_ptr())
    scalar = (strided in ("odd", "offset") or D == 40000
              or D % (16 // x.element_size()) != 0)
    assert vector is not scalar
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


# granite-3-8b's widths: head_dim 128 with 4 query heads per kv head; bf16
# only (float32 at head_dim 128 is refused by flash_attention.width_rule)
@pytest.mark.parametrize("B,Sq,Sk,H,KV,kw", [
    (1, 130, 130, 32, 8, dict()),                          # causal, ragged
    (1, 64, 1088, 32, 8, dict(q_offset=1024)),             # a solo hit
    (2, 100, 100, 4, 1, dict(window=33, softcap=30.0, kv_valid=90)),
    (1, 40, 120, 8, 2, dict(causal=False)),
    (1, 8, 8, 4, 1, dict(window=2, kv_valid=3)),           # fully masked rows
])
def test_flash_attention_kernel_at_head_dim_128_matches_plain(dev, B, Sq, Sk,
                                                              H, KV, kw):
    dtype = torch.bfloat16
    q = _randn(dev, B, Sq, H, 128, dtype=dtype)
    k = _randn(dev, B, Sk, KV, 128, dtype=dtype, seed=1)
    v = _randn(dev, B, Sk, KV, 128, dtype=dtype, seed=2)
    n0 = fa.launches
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.launches == n0 + 1
    _close(got, fa.flash_attention_plain(q, k, v, **kw), dtype, ATTN_TOL)


def test_flash_attention_f32_at_head_dim_128_raises_its_rule(dev):
    """float32 at head_dim 128 is refused by the width rule before any
    launch, naming the rule; nothing falls back to the plain version."""
    q = _randn(dev, 1, 16, 4, 128)
    n0 = fa.launches
    with pytest.raises(ValueError, match="rule of dtype and width"):
        fa.flash_attention(q, q, q)
    assert fa.launches == n0


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
    _check_segmented(dev, lens, S, H, KV, d, kw, dtype)


@pytest.mark.parametrize("lens,S,H,KV,kw", [
    ((300, 64, 400, 17, 120), 1000, 32, 8, dict()),        # ragged, tail
    ((7, 80, 9, 33), 160, 8, 2, dict(window=13)),
])
def test_segmented_kernel_at_head_dim_128_matches_plain(dev, lens, S, H, KV,
                                                        kw):
    _check_segmented(dev, lens, S, H, KV, 128, kw, torch.bfloat16)


def _check_segmented(dev, lens, S, H, KV, d, kw, dtype):
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
    _check_positioned(dev, plens, lens, S, pmax, H, KV, d, kw, dtype)


@pytest.mark.parametrize("plens,lens,S,pmax,H,KV,kw", [
    ((1024, 768, 512, 1024), (128, 96, 160, 128), 512, 1024, 32, 8,
     dict()),                                      # the chip_smoke shape
    ((48, 32), (25, 13), 40, 64, 8, 2, dict(window=20)),
])
def test_positioned_kernel_at_head_dim_128_matches_plain(dev, plens, lens, S,
                                                         pmax, H, KV, kw):
    _check_positioned(dev, plens, lens, S, pmax, H, KV, 128, kw,
                      torch.bfloat16)


def _check_positioned(dev, plens, lens, S, pmax, H, KV, d, kw, dtype):
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


@pytest.mark.parametrize("T,D,F", [
    (8, 4096, 12800),     # granite-3-8b: a decode step, d_ff split
    (128, 4096, 12800),   # a solo hit: 64 down tiles, d_ff split
    (77, 2048, 8192),     # ragged tokens at another wide D
])
def test_fused_mlp_bf16_kernel_at_wide_d_matches_plain(dev, T, D, F):
    dtype = torch.bfloat16
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
        fa.flash_attention(q, q, q)                   # head_dim 128 in f32
    x = _randn(dev, 4, 48)
    with pytest.raises(ValueError):
        fm.fused_mlp(x, _randn(dev, 48, 64), _randn(dev, 48, 64),
                     _randn(dev, 64, 48))             # D not a multiple of 32
    x = _randn(dev, 4, 2048)
    with pytest.raises(ValueError):
        fm.fused_mlp(x, _randn(dev, 2048, 64), _randn(dev, 2048, 64),
                     _randn(dev, 64, 2048))           # f32 D above 1024
    with pytest.raises(ValueError):
        rn.rmsnorm(_randn(dev, 4, 64), torch.zeros(64))   # weight on the CPU


def test_engine_on_the_card_matches_the_cpu_engine(dev, cfg=None):
    cfg = cfg or reduce_config(get_config("qwen1.5-0.5b"), hybrid_chunk=0)
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


def test_packed_engine_on_the_card_matches_the_cpu_engine(dev, cfg=None):
    """Packed miss and packed hit steps on the card: the same packs, cached
    lengths and scores as on the CPU, and 49/24/24 launches per forward."""
    cfg = cfg or reduce_config(get_config("qwen1.5-0.5b"), hybrid_chunk=0)
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


@pytest.mark.parametrize("check", [
    test_engine_on_the_card_matches_the_cpu_engine,
    test_packed_engine_on_the_card_matches_the_cpu_engine,
], ids=["solo", "packed"])
def test_engines_on_the_card_at_head_dim_128(dev, check):
    """Both engines at granite-3-8b reduced to head_dim 128 (d_model 256,
    8/2 heads): the tensor-core attention at 128 in all three modes."""
    check(dev, cfg=reduce_config(get_config("granite-3-8b"), hybrid_chunk=0,
                                 d_model=256, num_heads=8, num_kv_heads=2,
                                 head_dim=128))


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
    (2, 4100, 32, 8, 128, [4100, 2049], dict()),          # granite: d 128, G 4
    (3, 300, 8, 1, 128, [300, 1, 77], dict(softcap=50.0)),  # d 128, G 8
])
def test_decode_attention_kernel_matches_plain(dev, B, S, H, KV, d, kv_len,
                                               kw, dtype):
    q, k, v, n = _decode_inputs(dev, B, S, H, KV, d, kv_len, dtype)
    n0 = da.launches
    got = da.decode_attention(q, k, v, n, **kw)
    torch.cuda.synchronize()
    assert da.launches == n0 + 1
    _close(got, da.decode_attention_plain(q, k, v, n, **kw), dtype, DEC_TOL)


def _plan(dev, q, k):
    """The launch plan the wrapper makes for q and cache k on this card."""
    B, _, H, d = q.shape
    return smoke.decode_plan(dev, B, k.shape[1], H, k.shape[2], d, q.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,KV,d", [(4, 4, 64), (8, 4, 32), (32, 8, 128),
                                    (16, 2, 64), (8, 1, 128), (12, 4, 64)])
def test_decode_attention_at_tile_and_chunk_edges(dev, H, KV, d, dtype):
    """Rows whose kv_len is 1, a key tile less or more one, on a chunk
    boundary, one past it, one short of the second and past it by a tile
    and a slot, and the whole cache: the last tile of a chunk and the
    slots past kv_len are masked, and chunks past kv_len load nothing. G
    1, 2, 4, 8 and 3 (padded to 4), d 32, 64 and 128."""
    S, B = 8192, 8
    q, k, v, n = _decode_inputs(dev, B, S, H, KV, d, [S] * B, dtype)
    plan = _plan(dev, q, k)
    assert plan.kernel == da.kernel_rule(H // KV, dtype)
    c, t = plan.chunk, da.KEY_TILE
    assert plan.splits > 2 and c % t == 0
    kv_len = [1, t - 1, t + 1, c, c + 1, 2 * c - 1, c + t + 1, S]
    q, k, v, n = _decode_inputs(dev, B, S, H, KV, d, kv_len, dtype)
    got = da.decode_attention(q, k, v, n)
    torch.cuda.synchronize()
    _close(got, da.decode_attention_plain(q, k, v, n), dtype, DEC_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_short_rows_leave_most_splits_empty(dev, dtype):
    """S = 32,768 with rows of 1 and 1000 live slots: most of the split
    rule's chunks hold no live slot, and their (m, l) = (-1e30, 0) partials
    must merge without NaN; a row with kv_len 0 gives 0."""
    kv_len = [1, 1000, 32768, 0]
    q, k, v, n = _decode_inputs(dev, 4, 32768, 4, 4, 64, kv_len, dtype)
    assert _plan(dev, q, k).splits > 8
    got = da.decode_attention(q, k, v, n)
    _close(got, da.decode_attention_plain(q, k, v, n), dtype, DEC_TOL)
    assert not got[3].any()


@pytest.mark.parametrize("H,d", [(4, 64), (16, 128), (8, 32)])
def test_decode_attention_takes_strided_cache_views(dev, H, d):
    """A layer of a stacked cache, a slot prefix of a longer cache and a
    head slice are read in place, by the GEMV kernel (G 1) and the
    tensor-core kernel (G 4 at d 128, G 2 at d 32); a cache that is not
    unit-stride over d, or whose rows are not 16-byte aligned, is refused,
    not copied."""
    dtype = torch.bfloat16
    stack = _randn(dev, 3, 2, 80, 6, d, dtype=dtype)
    vstack = _randn(dev, 3, 2, 80, 6, d, dtype=dtype, seed=1)
    q = _randn(dev, 2, 1, H, d, dtype=dtype, seed=2)
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
    odd = torch.zeros(2 * 64 * 4 * d + 1, dtype=dtype, device=dev)[1:]
    with pytest.raises(ValueError):
        da.decode_attention(q, odd.view(2, 64, 4, d),
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
def test_decode_chain_on_the_card_matches_the_cpu(dev, window,
                                                 arch="qwen1.5-0.5b",
                                                 widths=None):
    """The reduced model's decode chain (20 steps from an empty cache, ring
    cache when windowed) on the card against the same chain on the CPU, at
    float32: logits within 1e-4 (the kernels against their plain versions
    over four layers), 2L+1/L/L launches per step, caches alike."""
    from repro_torch.models.model import build
    cfg = reduce_config(get_config(arch), hybrid_chunk=0,
                        dtype="float32", param_dtype="float32",
                        sliding_window=window, **(widths or {}))
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


def test_decode_chain_on_the_card_at_head_dim_128(dev):
    """The chain at granite-3-8b reduced to head_dim 128 (8/2 heads): flash
    decoding at 128 and 4 query heads per kv head, in float32."""
    test_decode_chain_on_the_card_matches_the_cpu(
        dev, 0, arch="granite-3-8b",
        widths=dict(d_model=256, num_heads=8, num_kv_heads=2, head_dim=128))


def _to(tree, dev):
    return {k: (_to(v, dev) if isinstance(v, dict) else v.to(dev))
            for k, v in tree.items()}


# ---- the engine's CUDA graphs ---------------------------------------------------
@pytest.mark.parametrize("path", ["fresh", "suffix", "packed_miss",
                                  "packed_hit"])
def test_graph_replay_equals_the_eager_forward(dev, path):
    """After every step, the replay's static outputs (logits, kept KV)
    against the same forward run eagerly on the same static inputs, bit for
    bit at bf16; every forward was captured with its warm-up under
    ``set_sync_debug_mode("error")`` (a host sync would have raised), and a
    warm-up run again under it raises nothing. One profiled replay of each
    graph launches every kernel as often as its capture counted."""
    cfg = reduce_config(get_config("qwen1.5-0.5b"), hybrid_chunk=0)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ecfg, waves = smoke.graph_traces(cfg.vocab_size)[path]
    eng = PrefillOnlyEngine(cfg, params, EngineConfig(**ecfg), device=dev)
    tables = {"fresh": eng._fresh_fns, "suffix": eng._suffix_fns,
              "packed_miss": eng._packed_fns,
              "packed_hit": eng._packed_hit_fns}
    now, replayed = 0.0, 0
    for wave in waves:
        for t in wave:
            eng.submit(t, allowed_tokens=(5, 9), now=now)
            now += 1.0
        while eng.queue:
            eng.step()
            rec = eng.batch_records[-1]
            f = tables[rec.jit_path][rec.jit_key]
            replayed += not rec.compiled
            logits, kv = f.outputs
            want, want_kv = f.fn(**f.inputs)
            torch.cuda.synchronize()
            assert torch.equal(logits, want)
            if kv is not None and kv["k"] is not None:
                for name in ("k", "v"):
                    assert torch.equal(kv[name], want_kv[name])
    assert replayed >= 1 and any(r.jit_path == path
                                 for r in eng.batch_records)
    assert torch.cuda.get_sync_debug_mode() == 0
    for f in eng.graphs():
        assert f.graph is not None and f.replays >= 1
        assert smoke.replay_launches(torch, f) == {
            k: f.launches[k] for k in smoke.kernel_modules()}
        f._warm_up()
    torch.cuda.synchronize()


def test_graph_memory_stays_bounded_on_the_card(dev):
    """Hits at seven prefix lengths of one profile, then the first three
    again, under a budget that keeps one graph alive: after each step only
    its own graph lives (the pool keeps a captured graph throughout),
    device memory after the first hit grows by no more than one graph and
    twice the prefix buffer (plus the allocator's rounding), and the hits
    made anew score as the first time, bit for bit."""
    cfg = reduce_config(get_config("qwen1.5-0.5b"), hybrid_chunk=0)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(5)
    user = rng.integers(0, cfg.vocab_size, 512).tolist()
    eng = PrefillOnlyEngine(cfg, params, EngineConfig(
        max_pack_requests=1, graph_memory_bytes=1), device=dev)
    plens = [64 * i for i in range(1, 8)]
    scores, allocated, biggest = [], [], 0
    for i, t in enumerate([user] + [user[:p + 10] for p in plens + plens[:3]]):
        rid = eng.submit(t, allowed_tokens=(5, 9))
        eng.step()
        torch.cuda.synchronize()
        scores.append(eng.results[rid]["scores"])
        allocated.append(torch.cuda.memory_allocated(dev))
        live, = eng.graphs()
        assert live.graph is not None
        if i:
            biggest = max(biggest, live.held_bytes)
    recs = list(eng.batch_records)[1:]
    assert [r.pmax for r in recs] == plens + plens[:3]
    assert all(r.compiled for r in recs)
    store = 2 * eng._prefix_store["k"].nbytes
    assert eng.prefix_store_bytes() < 2 * store
    limit = biggest + 2 * store + (2 << 20)
    assert max(allocated[1:]) - allocated[1] <= limit
    assert scores[1:4] == scores[-3:]


def test_a_capture_that_fails_raises_and_runs_nothing_eagerly(dev):
    """A forward with a host sync (refused in the warm-up) and one with a
    pageable host copy (refused by the capture) each raise CaptureError
    naming the key, chained to the error of the op that broke it, on every
    call, and leave the launch counters as they were."""
    def synced(x):
        rn.launches += 1
        return x * x.sum().item()

    def pageable(x):
        rn.launches += 1
        return x + torch.ones(4).to(x.device, non_blocking=True)

    n0 = rn.launches
    for fn, op in ((synced, "x.sum().item()"), (pageable, "torch.ones(4)")):
        # a stream of their own: a capture that fails mid-way leaves its
        # stream's allocations routed to its pool
        f = compiled.CompiledForward(fn, f"{fn.__name__} (4,)",
                                     {"x": ((4,), torch.float32)}, on=dev,
                                     pool=torch.cuda.graph_pool_handle(),
                                     stream=torch.cuda.Stream(dev))
        errors = []
        for _ in range(2):
            with pytest.raises(compiled.CaptureError) as info:
                f({"x": np.ones(4, np.float32)})
            errors.append(info.value)
        chain = "".join(traceback.format_exception(errors[0]))
        assert fn.__name__ in str(errors[0]) and op in chain
        assert errors[1] is errors[0]              # raised again, not retried
        assert f.graph is None and f.outputs is None
    assert rn.launches == n0
    torch.cuda.synchronize()


@pytest.fixture(scope="module")
def qwen_peaks(dev):
    """chip_smoke.py's peak-memory phase at full-width qwen1.5-0.5b, S 4096
    and 8192 (four ways each: hybrid_chunk 2048 and 0, kv_keep 0 and
    16,384); it raises if the hybrid slope is not below chunk 0's or past
    1.5x the model's, or a kept slice is off by more than 5%."""
    from repro_torch.configs import get_config
    from repro_torch.core.kv_policy import MemoryModel
    from repro_torch.runtime.hw import H100_SXM
    cfg = get_config("qwen1.5-0.5b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    spec = smoke.QWEN._replace(long_lens=(4096, 8192))
    out = smoke.check_peak_memory(torch, dev, spec, cfg, params,
                                  MemoryModel(cfg, H100_SXM))
    del params
    torch.cuda.empty_cache()
    return cfg, out


def test_peak_memory_holds_to_the_model_on_the_card(qwen_peaks):
    cfg, (peaks, fits) = qwen_peaks
    slope, model = fits[(cfg.hybrid_chunk, 0)]
    assert 0 < slope <= smoke.SLOPE_LIMIT * model
    for S, kept, none in zip((4096, 8192), peaks[(cfg.hybrid_chunk,
                                                  smoke.MEM_KEEP)],
                             peaks[(cfg.hybrid_chunk, 0)]):
        assert kept > none


def test_hybrid_prefilling_lowers_the_peak_slope_on_the_card(qwen_peaks):
    cfg, (_, fits) = qwen_peaks
    assert fits[(cfg.hybrid_chunk, 0)][0] < fits[(0, 0)][0]


# ---- the DRAM offload tier --------------------------------------------------------
# the CPU twins' settings; a 4 MiB host tier (the engine pins its blocks
# when it is made)
_TIER = dict(cache_capacity_tokens=64, offload=True, offload_host_bw=1e18,
             prefix_bucket_blocks=1, max_pack_requests=1,
             host_cache_bytes=4 << 20)


def _tier_engine(dev, **over):
    cfg = reduce_config(get_config("qwen1.5-0.5b"), hybrid_chunk=0)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, PrefillOnlyEngine(cfg, params, EngineConfig(
        **dict(_TIER, **over)), device=dev)


def _tier_serve(eng, reqs):
    out = []
    for t in reqs:
        rid = eng.submit(t, allowed_tokens=(5, 9))
        eng.step()
        out.append(eng.results[rid])
    return out


def test_demoted_payloads_are_pinned_host_tensors(dev):
    """The engine pins its host tier when it is made; evicted blocks demote
    to pinned host tensors (one per block, k and v stacked), the device
    tier holds device tensors only, and the request restored from the host
    scores within the gate of a cold engine."""
    cfg, eng = _tier_engine(dev)
    held = torch.cuda.host_memory_stats()["allocated_bytes.current"]
    assert held >= eng.ecfg.host_cache_bytes
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, 40).tolist()
    flood = [rng.integers(0, cfg.vocab_size, 40).tolist() for _ in range(6)]
    _tier_serve(eng, [toks] + flood)
    torch.cuda.synchronize()
    store = eng.cache.host._store
    assert len(store) == eng.cache.host.offloads > 0
    for p in store.values():
        assert isinstance(p, offload.HostKV)
        assert p.kv.device.type == "cpu" and p.kv.is_pinned()
        assert p.kv.shape[0] == 2 and p.nbytes == eng.block_bytes()
    assert all(b.payload.is_cuda for b in eng.cache.blocks.values())
    got, = _tier_serve(eng, [toks])
    assert eng.cache.restored_blocks > 0 and got["n_cached"] > 0
    assert all(b.payload.is_cuda for b in eng.cache.blocks.values())
    cold = PrefillOnlyEngine(cfg, eng.params, EngineConfig(
        cache_capacity_tokens=0), device=dev)
    want, = _tier_serve(cold, [toks])
    for t in (5, 9):
        assert abs(got["scores"][t] - want["scores"][t]) < 2e-2


def test_demote_then_restore_is_bitwise_equal(dev):
    """A block demoted and restored at once (no synchronisation between)
    comes back bit for bit, through the engine's execute path on its
    stream and through a copy on another stream, which waits on the
    demotion's event; a 64 MiB payload makes the copy long enough that a
    missing wait would read it unfinished."""
    cfg, eng = _tier_engine(dev)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, 40).tolist()
    _tier_serve(eng, [toks])
    chain = token_chain(toks, eng.ecfg.block_size)
    c = eng.cache
    before = [c.blocks[h].payload.clone() for h in chain[:2]]
    while chain[0] in c.blocks:
        assert c._evict_one()
    with eng.lock:
        assert eng._match_restoring(chain) == 2
    after = [c.blocks[h].payload for h in chain[:2]]
    torch.cuda.synchronize()
    for a, b in zip(after, before):
        assert a.is_cuda and torch.equal(a, b)
    x = torch.randn(16 << 20, device=dev)
    side = torch.cuda.Stream(dev)
    y = offload.to_device(offload.to_host(x), dev, side)
    torch.cuda.synchronize()
    assert torch.equal(x, y)


def test_a_prefetch_during_a_capture_waits_for_it(dev, monkeypatch):
    """A prefetch started inside a capture (at ``_capture``, with the
    first use holding ``capture_lock``) runs after it: the capture holds,
    the forward replays later, and the prefetched blocks reach the card,
    so the hit that follows restores nothing on its execute path. The
    cache has room for every request, so no step evicts what another
    restores, in whatever order the prefetch and the step's insert take
    the engine lock; the blocks are demoted by hand."""
    cfg, eng = _tier_engine(dev, cache_capacity_tokens=4096)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, 40).tolist()
    _tier_serve(eng, [toks])
    chain = token_chain(toks, eng.ecfg.block_size)
    while chain[0] in eng.cache.blocks:
        assert eng.cache._evict_one()
    assert eng.cache.match_tiers(chain) == ["host"] * 2
    started = []
    capture = compiled.CompiledForward._capture

    def capture_with_prefetch(self):
        started.append(eng.prefetch_prefix(chain))
        return capture(self)

    monkeypatch.setattr(compiled.CompiledForward, "_capture",
                        capture_with_prefetch)
    new = [rng.integers(0, cfg.vocab_size, 100).tolist() for _ in range(2)]
    first, = _tier_serve(eng, new[:1])        # a new shape key: S 128
    monkeypatch.undo()
    for th in threading.enumerate():
        if th.name == "kv-prefetch":
            th.join(timeout=60)
            assert not th.is_alive()
    assert started and started[0] > 0 and eng.batch_records[-1].compiled
    assert all(f.graph is not None for f in eng.graphs())
    second, = _tier_serve(eng, new[1:])       # the captured key replays
    assert not eng.batch_records[-1].compiled
    assert eng.cache.restored_blocks >= started[0]
    r0 = eng.cache.restored_blocks
    got, = _tier_serve(eng, [toks])
    assert eng.cache.restored_blocks == r0 and got["n_cached"] > 0
    cold = PrefillOnlyEngine(cfg, eng.params, EngineConfig(
        cache_capacity_tokens=0), device=dev)
    for res, t in zip((first, second, got), new + [toks]):
        want, = _tier_serve(cold, [t])
        for tok in (5, 9):
            assert abs(res["scores"][tok] - want["scores"][tok]) < 2e-2


def _solo_scores(cfg, params, dev, reqs):
    """Each of ``reqs`` served alone on a fresh engine of its own."""
    out = []
    for toks in reqs:
        eng = PrefillOnlyEngine(cfg, params, EngineConfig(
            max_pack_requests=1, cache_capacity_tokens=0), device=dev)
        rid = eng.submit(toks, allowed_tokens=(5, 9))
        eng.step()
        out.append(eng.results[rid]["scores"])
    return out


def test_two_engines_step_side_by_side_while_one_captures(dev):
    """Two full-width qwen1.5-0.5b engines step in two threads: one replays
    keys it captured before, the other captures new keys meanwhile.
    ``compiled.device_lock`` keeps every step's device work out of the
    other's warm-up and capture: no ``CaptureError``, no sync
    debug error, and every score equals the same request's served on an
    engine of its own (the same kernels on the same inputs)."""
    cfg = get_config("qwen1.5-0.5b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    rng = np.random.default_rng(3)
    warm = [rng.integers(0, cfg.vocab_size, n).tolist()
            for n in (100, 200, 400)]
    new = [rng.integers(0, cfg.vocab_size, n).tolist()
           for n in (60, 700, 1500, 120, 450, 250)]   # six new keys
    engines = [PrefillOnlyEngine(cfg, params, EngineConfig(
        max_pack_requests=1, cache_capacity_tokens=0), device=dev)
        for _ in range(2)]
    for toks in warm:                      # engine 0's keys, captured now
        engines[0].submit(toks, allowed_tokens=(5, 9))
        engines[0].run_until_drained()
    work = ([warm[i % 3] for i in range(24)], new)
    got, errors = ([], []), []
    start = threading.Barrier(2)

    def serve(k):
        try:
            start.wait(30)
            eng = engines[k]
            for toks in work[k]:
                rid = eng.submit(toks, allowed_tokens=(5, 9))
                assert eng.step() == rid
                got[k].append(eng.results[rid]["scores"])
        except Exception:
            errors.append(traceback.format_exc())

    threads = [threading.Thread(target=serve, args=(k,)) for k in range(2)]
    [t.start() for t in threads]
    [t.join(timeout=600) for t in threads]
    assert not errors, errors[0]
    recs = [list(e.batch_records) for e in engines]
    assert not any(r.compiled for r in recs[0][len(warm):])
    assert sum(r.compiled for r in recs[1]) == len(new)
    assert all(f.graph is not None for e in engines for f in e.graphs())
    want = (_solo_scores(cfg, params, dev, warm), _solo_scores(
        cfg, params, dev, new))
    for g, w in zip(got[0], [want[0][i % 3] for i in range(24)]):
        assert max(abs(g[t] - w[t]) for t in (5, 9)) < 1e-5
    for g, w in zip(got[1], want[1]):
        assert max(abs(g[t] - w[t]) for t in (5, 9)) < 1e-5


def test_two_instance_serve_trace_on_the_card(dev):
    """``serve_trace`` over two full-width qwen1.5-0.5b instances on one
    card (WL1 at a tenth of its token scale, packing on): every request
    served, no engine error, retry or watchdog trip, and every score
    within 2e-2 of a cold engine's on the same weights."""
    from repro_torch.data.workloads import get_trace
    from repro_torch.launch.serve import make_pool, serve_trace
    from repro_torch.serving import Rejected
    pool = make_pool("qwen1.5-0.5b", 2, reduced=False, profile=True,
                     device=dev, cache_tokens=65536)
    kw = dict(qps=40.0, scale_tokens=0.1, seed=0, max_requests=24,
              trace_kw=dict(num_users=4, posts_per_user=6))
    out = serve_trace("qwen1.5-0.5b", pool=pool, drain_timeout=300.0, **kw)
    srv = out["server"]
    assert out["served"] == out["requests"] == 24
    for name in ("engine_errors", "requests_retried", "watchdog_trips",
                 "requests_rejected"):
        assert srv.metrics.total(name) == 0, name
    trace = get_trace("post_recommendation", kw["qps"],
                      scale_tokens=kw["scale_tokens"], materialize_tokens=True,
                      vocab=512, seed=0, **kw["trace_kw"])
    eng = pool.engines["inst0"]
    want = _solo_scores(eng.cfg, eng.params, dev,
                        [r.tokens for r in trace.requests[:24]])
    for o, w in zip(out["outcomes"], want):
        assert not isinstance(o, Rejected)
        assert max(abs(o["scores"][t] - w[t]) for t in (5, 9)) < 2e-2
