"""The port's CUDA kernels and engine on the card (marker ``cuda``).

Each kernel is held against its plain PyTorch version on the same CUDA
tensors over shapes the CPU tests cannot reach (every template
instantiation, ragged edges, strided inputs, float32 and bfloat16), and the
engine on the card against the same engine on the CPU. The module needs no
JAX. On a host without CUDA every test skips. Run on a GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 1e-4 (summation order only); bfloat16 2e-2 + 2e-2·|y|
(a few bf16 ulps after both sides round once). Engine scores: the repo's
2e-2 gate.
"""
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
