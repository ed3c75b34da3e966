"""The port's CUDA kernels and engine on the card (marker ``cuda``).

Each kernel is held against its plain PyTorch version on the same CUDA
tensors over shapes the CPU tests cannot reach (every template
instantiation, ragged edges, strided inputs, float32 and bfloat16; for
attention also the segmented and positioned modes and their executed-tile
maps), and the engine on the card, solo and packed, against the same
engine on the CPU. The module needs no JAX. On a host without CUDA every
test skips. Run on a GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 1e-4 (summation order only); bfloat16 2e-2 + 2e-2·|y|
(a few bf16 ulps after both sides round once). Engine scores: the repo's
2e-2 gate.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.core.engine import EngineConfig, PrefillOnlyEngine
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
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(dev, *shape, std=1.0, dtype=torch.float32, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
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
    _close(got, fa.flash_attention_plain(q, k, v, **kw), dtype)


def test_flash_attention_takes_the_model_layout_views(dev):
    """q/k/v as the model makes them: head-split views of one fused qkv
    projection (token stride (H + 2 KV) d), no copies."""
    B, S, H, KV, d = 2, 50, 4, 2, 32
    qkv = _randn(dev, B, S, (H + 2 * KV) * d, dtype=torch.bfloat16)
    q, k, v = torch.split(qkv, [H * d, KV * d, KV * d], dim=-1)
    q, k, v = (t.reshape(B, S, -1, d) for t in (q, k, v))
    assert not v.is_contiguous()
    _close(fa.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v),
           torch.bfloat16)


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
    tmap = torch.empty((1, -(-S // 32), -(-S // 32)), dtype=torch.int32,
                       device=dev)
    got = fa.flash_attention(q, k, v, seg_q=seg_q, seg_k=seg_k,
                             tile_map=tmap, **kw)
    assert (fa.launches, fa.mode_launches["segmented"]) == (n0 + 1, m0 + 1)
    _close(got, fa.flash_attention_plain(q, k, v, seg_q=seg_q, seg_k=seg_k,
                                         **kw), dtype)
    assert not got[0, seg_q[0] < 0].any()         # padding rows give 0
    want_map = smoke.tile_rule(S, S, seg_q=seg_q, seg_k=seg_k,
                               window=kw.get("window", 0))
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
    tmap = torch.empty((1, -(-S // 32), -(-Sk // 32)), dtype=torch.int32,
                       device=dev)
    got = fa.flash_attention(q, k, v, tile_map=tmap, **names, **kw)
    assert fa.mode_launches["positioned"] == m0 + 1
    _close(got, fa.flash_attention_plain(q, k, v, **names, **kw), dtype)
    want_map = smoke.tile_rule(S, Sk, window=kw.get("window", 0), **names)
    assert torch.equal(tmap, want_map)
    assert int(tmap.sum()) < tmap.numel()          # other rows' tiles skip


def test_packed_modes_take_strided_views(dev):
    """q/k/v as head-split views of one fused qkv projection."""
    S, H, KV, d = 96, 4, 2, 64
    qkv = _randn(dev, 1, S, (H + 2 * KV) * d, dtype=torch.bfloat16)
    q, k, v = torch.split(qkv, [H * d, KV * d, KV * d], dim=-1)
    q, k, v = (t.reshape(1, S, -1, d) for t in (q, k, v))
    seg_q, seg_k, _, _ = _packed_ids(dev, (40, 30, 20), S)
    _close(fa.flash_attention(q, k, v, seg_q=seg_q, seg_k=seg_k),
           fa.flash_attention_plain(q, k, v, seg_q=seg_q, seg_k=seg_k),
           torch.bfloat16)
    pos = torch.arange(S, device=dev, dtype=torch.int32)[None]
    _close(fa.flash_attention(q, k, v, seg_q=seg_q, seg_k=seg_k, pos_q=pos,
                              pos_k=pos),
           fa.flash_attention_plain(q, k, v, seg_q=seg_q, seg_k=seg_k),
           torch.bfloat16)


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
])
def test_fused_mlp_kernel_matches_plain(dev, T, D, F, dtype):
    x = _randn(dev, T, D, dtype=dtype)
    ws = (_randn(dev, D, F, std=D ** -0.5, dtype=dtype, seed=1),
          _randn(dev, D, F, std=D ** -0.5, dtype=dtype, seed=2),
          _randn(dev, F, D, std=F ** -0.5, dtype=dtype, seed=3))
    n0 = fm.launches
    got = fm.fused_mlp(x, *ws)
    assert fm.launches == n0 + 1
    _close(got, fm.fused_mlp_plain(x, *ws), dtype)


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
