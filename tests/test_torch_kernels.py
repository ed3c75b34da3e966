"""The port's kernel modules against the JAX package, on the CPU.

Each kernel wrapper of ``repro_torch.kernels`` uses its plain PyTorch
version on CPU tensors. Those plain versions are held against the Pallas
kernels (``repro.kernels.ops``, interpret mode, as ``tests/test_kernels.py``
runs them) and, where the Pallas kernel lacks a feature (the attention
query offset), against the model-layer function. Inputs are made from a
numpy seed and fed to both sides.

Tolerances: float32 1e-4 (the two sides sum in different orders; inputs are
O(1)); bfloat16 5e-2, as in ``tests/test_kernels.py`` (one bf16 rounding of
O(1) outputs is up to 2^-8 relative, and the two sides may round
intermediates at different ulps).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.models import layers as jl
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_mlp as fm
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import layers as tl

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same numpy values as a JAX array and a CPU torch tensor."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _tol(dtype: str):
    return F32_TOL if dtype == "float32" else BF16_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D", [(64, 128), (37, 96), (8, 1024),
                                 (16, 4096)])           # granite's d_model
def test_rmsnorm_plain_matches_pallas(T, D, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = (0.1 * rng.standard_normal(D)).astype(np.float32)
    xj, xt = _pair(x, dtype)
    wj, wt = _pair(w, dtype)
    want = ops.rmsnorm(xj, wj, block_t=16)
    got = rn.rmsnorm(xt, wt)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    # the model layer is the same function
    np.testing.assert_allclose(_np(tl.rms_norm(xt, wt)),
                               _np(jl.rms_norm(xj, wj)), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk,H,KV,d,causal,window,softcap", [
    (64, 64, 4, 4, 16, True, 0, 0.0),        # MHA full causal
    (64, 64, 4, 2, 16, True, 0, 0.0),        # GQA
    (70, 70, 4, 2, 16, True, 13, 0.0),       # SWA + ragged (padded) Sk
    (64, 64, 8, 2, 32, True, 0, 50.0),       # softcap
    (33, 33, 2, 1, 8, True, 7, 30.0),        # everything at once
    (40, 70, 4, 2, 16, False, 0, 0.0),       # non-causal, padded Sk
    (48, 48, 4, 1, 32, False, 0, 20.0),      # non-causal, GQA, softcap
    (64, 64, 8, 2, 128, True, 0, 0.0),       # granite: head_dim 128, G = 4
    (70, 70, 8, 2, 128, True, 13, 30.0),     # head_dim 128, SWA, softcap
    (64, 64, 4, 4, 96, True, 0, 0.0),        # phi3: head_dim 96, MHA
    (70, 70, 4, 2, 256, True, 13, 50.0),     # gemma2: 256, G 2, SWA, cap
])
def test_flash_attention_plain_matches_pallas(Sq, Sk, H, KV, d, causal,
                                              window, softcap, dtype):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, Sq, H, d)).astype(np.float32)
    k = rng.standard_normal((2, Sk, KV, d)).astype(np.float32)
    v = rng.standard_normal((2, Sk, KV, d)).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    want = ops.flash_attention(qj, kj, vj, causal=causal, window=window,
                               softcap=softcap, block_q=32, block_k=32)
    got = fa.flash_attention(qt, kt, vt, causal=causal, window=window,
                             softcap=softcap)
    assert got.shape == (2, Sq, H, d) and got.dtype == qt.dtype
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,P,H,KV,window,softcap", [
    (16, 48, 4, 4, 0, 0.0),                  # the solo-hit forward's shape
    (24, 40, 4, 2, 0, 0.0),                  # GQA
    (16, 64, 4, 2, 20, 30.0),                # window + softcap
])
def test_attention_q_offset_matches_blocked_attention(S, P, H, KV, window,
                                                      softcap, dtype):
    """Bottom-right causal alignment: suffix query i sits at P + i over the
    concat(prefix, suffix) keys — held against the reference model layer's
    ``blocked_attention(q_offset=P)``."""
    rng = np.random.default_rng(2)
    d = 32
    q = rng.standard_normal((1, S, H, d)).astype(np.float32)
    k = rng.standard_normal((1, P + S, KV, d)).astype(np.float32)
    v = rng.standard_normal((1, P + S, KV, d)).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    want = jl.blocked_attention(qj, kj, vj, window=window, softcap=softcap,
                                q_offset=P, q_block=8, kv_block=16)
    got = tl.attention(qt, kt, vt, window=window, softcap=softcap,
                       q_offset=P)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_attention_fully_masked_rows_are_zero():
    """A row with no live key (kv_valid cuts its window) returns 0, not NaN
    — the kernel's finite NEG_INF contract."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(np.float32))
    out = fa.flash_attention(q, k, k, window=2, kv_valid=3)
    assert torch.isfinite(out).all()
    assert torch.count_nonzero(out[:, 4:]) == 0      # rows 4..7 see nothing
    assert all(torch.count_nonzero(out[:, i]) > 0 for i in range(4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D,F", [
    (64, 32, 96),
    (100, 64, 150),      # ragged T and F (F not a multiple of a 32 chunk)
    (16, 128, 352),      # 352 = 11 x 32, as 2816 = 11 x 256 at full width
    (8, 512, 400),       # wider D; 400 = 12800 / 32, granite's d_ff / 32
])
def test_fused_mlp_plain_matches_pallas(T, D, F, dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((T, D)).astype(np.float32)
    ws = [(0.1 * rng.standard_normal(s)).astype(np.float32)
          for s in ((D, F), (D, F), (F, D))]
    xj, xt = _pair(x, dtype)
    wj, wt = zip(*(_pair(w, dtype) for w in ws))
    want = ops.fused_mlp(xj, *wj, block_t=32, block_f=32)
    got = fm.fused_mlp(xt, *wt)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("chunk", [0, 16])
def test_fused_mlp_matches_mlp_apply_at_f32(chunk):
    """The kernel casts after ``silu(g) * u``, the reference layer before
    the multiply; at float32 both orders are the same function."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 40, 64)).astype(np.float32)
    names = ("w_gate", "w_up", "w_down")
    shapes = ((64, 160), (64, 160), (160, 64))
    p = {n: (0.1 * rng.standard_normal(s)).astype(np.float32)
         for n, s in zip(names, shapes)}
    want = jl.mlp_apply({n: jnp.asarray(a) for n, a in p.items()},
                        jnp.asarray(x), chunk=chunk)
    pt = {n: torch.from_numpy(a) for n, a in p.items()}
    got = tl.mlp_apply(pt, torch.from_numpy(x), chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_allclose(
        _np(fm.fused_mlp(torch.from_numpy(x), pt["w_gate"], pt["w_up"],
                         pt["w_down"])), _np(want), **F32_TOL)


def test_cpu_tensors_never_launch_and_other_devices_raise():
    """On CPU tensors the wrappers take the plain versions and count no
    launch; a tensor on a device that is neither CPU nor CUDA is refused
    (there is no fallback path)."""
    before = (rn.launches, fa.launches, fm.launches)
    x = torch.ones(4, 32)
    rn.rmsnorm(x, torch.zeros(32))
    fa.flash_attention(torch.ones(1, 4, 2, 32), torch.ones(1, 4, 2, 32),
                       torch.ones(1, 4, 2, 32))
    fm.fused_mlp(x, torch.ones(32, 64), torch.ones(32, 64),
                 torch.ones(64, 32))
    assert (rn.launches, fa.launches, fm.launches) == before == (0, 0, 0)
    meta = torch.empty(4, 32, device="meta")
    with pytest.raises(ValueError):
        rn.rmsnorm(meta, torch.zeros(32, device="meta"))
    with pytest.raises(ValueError):
        fm.fused_mlp(meta, *(torch.empty(s, device="meta")
                             for s in ((32, 64), (32, 64), (64, 32))))
    q = torch.empty(1, 4, 2, 32, device="meta")
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("d,dtype,built", [
    (32, torch.bfloat16, True), (64, torch.bfloat16, True),
    (128, torch.bfloat16, True), (96, torch.bfloat16, True),
    (256, torch.bfloat16, True), (32, torch.float32, True),
    (64, torch.float32, True), (128, torch.float32, False),
    (96, torch.float32, False), (256, torch.float32, False),
    (80, torch.bfloat16, False), (80, torch.float32, False),
])
def test_flash_attention_width_rule(d, dtype, built):
    """The head dims each dtype's kernel is built for (bf16: 32, 64, 96,
    128, 256; f32: 32, 64): a rule of dtype and width that raises, naming
    the rule, before any launch; head_dim 80 names ROADMAP §A6.4."""
    if built:
        fa.width_rule(d, dtype)
        return
    with pytest.raises(ValueError, match="rule of dtype and width"):
        fa.width_rule(d, dtype)
    if d == 80:
        with pytest.raises(ValueError, match="§A6.4"):
            fa.width_rule(d, dtype)


@pytest.mark.parametrize("D,dtype,built", [
    (4096, torch.bfloat16, True), (1024, torch.bfloat16, True),
    (1024, torch.float32, True), (96, torch.float32, True),
    (2048, torch.float32, False), (4096, torch.float32, False),
    (48, torch.bfloat16, False), (0, torch.bfloat16, False),
])
def test_fused_mlp_width_rule(D, dtype, built):
    """bf16 takes any D % 32 == 0; f32 at most F32_MAX_D (its register
    accumulators); past it the error names the rule."""
    if built:
        fm.width_rule(D, dtype)
        return
    match = ("rule of dtype and width" if D % 32 == 0 and D > 0
             else "multiple of 32")
    with pytest.raises(ValueError, match=match):
        fm.width_rule(D, dtype)


@pytest.mark.parametrize("d,dtype,G,built", [
    (32, torch.bfloat16, 1, True), (128, torch.bfloat16, 4, True),
    (128, torch.float32, 8, True), (64, torch.float32, 1, True),
    (96, torch.bfloat16, 1, True), (256, torch.float32, 2, True),
    (256, torch.bfloat16, 8, True), (96, torch.float32, 1, True),
    (96, torch.bfloat16, 2, False), (96, torch.float32, 2, False),
    (80, torch.bfloat16, 1, False), (48, torch.float32, 1, False),
])
def test_decode_attention_width_rule(d, dtype, G, built):
    """Flash decoding is built for head dims 32, 64, 96, 128 and 256 in
    both dtypes, with head_dim 96 at G 1 only (the tensor-core kernel does
    not tile 12 column pieces a row); anything else raises, naming the
    rule, before any launch; head_dim 80 names ROADMAP §A6.4."""
    if built:
        da.width_rule(d, dtype, G)
        return
    with pytest.raises(ValueError, match="rule of dtype and width"):
        da.width_rule(d, dtype, G)
    if d == 80:
        with pytest.raises(ValueError, match="§A6.4"):
            da.width_rule(d, dtype, G)


def test_constants_match_reference():
    from repro.kernels.flash_attention import NEG_INF, PAD_POS
    assert tl.NEG_INF == jl.NEG_INF == NEG_INF == fa.NEG_INF
    assert tl.PAD_POS == PAD_POS
