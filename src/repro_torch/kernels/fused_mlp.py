"""Fused SwiGLU MLP: ``(silu(x Wg) * (x Wu)) Wd``.

Replaces the Pallas kernel ``repro/kernels/fused_mlp.py::fused_mlp`` and
keeps its rounding order: g and u in f32, ``a = silu(g) * u`` cast to the
input dtype, the down product accumulated in f32 and cast at the end. (The
reference model layer ``repro.models.layers.mlp_apply`` casts ``silu(g)``
before the multiply instead; the port's model path uses this kernel's
order. At float32 the two agree.)

The Hopper kernels (``csrc/fused_mlp.cu``) are chosen by dtype:

- bf16, the model path: two tensor-core GEMMs (``mma.sync`` m16n8k16, f32
  accumulators, a ring of ``cp.async`` stages). The gate/up GEMM keeps g
  and u in registers and rounds ``a`` once into a (T, F) bf16 workspace;
  the down GEMM splits d_ff across blocks into f32 partials, summed in a
  fixed order by a second kernel, where its grid is short of the SMs.
  ``mlp_plan`` chooses the tiles and the split from (T, D, F, SM count)
  alone. One departure from the Pallas kernel, which keeps ``a`` in VMEM:
  here ``a`` passes through device memory as bf16 (at most 11.5 MB at the
  config's ``hybrid_chunk = 2048``, mostly L2-resident; the f32 g and u
  never do), since a (256, D) f32 accumulator per block does not fit an
  SM's 227 KB. The paper's bound on intermediates is kept by
  ``chunked_map``.
- float32: the tensor cores take f32 only as TF32 (a 10-bit mantissa), so
  f32 inputs keep the CUDA-core kernel: a block owns 8 tokens and all D
  output columns in registers and walks d_ff in chunks of 32.

Widths are a rule of dtype (``width_rule``): bf16 takes any D % 32 == 0
(qwen1.5-0.5b's 1024, granite-3-8b's 4096); f32 takes D % 32 == 0 up to
``F32_MAX_D`` = 1024, the columns its registers hold. Any other width
raises before a launch; the plain version is never taken for a CUDA
tensor.

``fused_mlp`` launches the kernels for CUDA tensors and uses
``fused_mlp_plain`` for CPU tensors; ``launches`` counts calls that
launched them (one per call, whatever the number of internal launches).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

F32_MAX_D = 1024                # widest D of the f32 kernel (width_rule)
BK = 64                         # K elements per pipeline stage (csrc)
# (BM, BN) tiles instantiated in csrc/fused_mlp.cu: gate/up, widest first,
# and the down product's one tile
GATE_UP_TILES = ((128, 64), (64, 32), (16, 16))
DOWN_TILE = (64, 128)
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 5                       # x, wg, wu, wd, out
             + [ctypes.c_int] * 4                        # T, D, F, dtype
             + [ctypes.c_void_p])                        # stream
_BF16_ARGTYPES = ([ctypes.c_void_p] * 7                  # x, wg, wu, wd, a,
                  # part, out
                  + [ctypes.c_int] * 7                   # T, D, F, gate/up
                  # tile, splits, chunk
                  + [ctypes.c_void_p])                   # stream


@dataclasses.dataclass(frozen=True)
class MlpPlan:
    """Launch plan of the bf16 kernels: the gate/up tile (BM tokens, BN
    d_ff columns), and the down product's (``DOWN_TILE``) d_ff split into
    ``splits`` chunks of ``chunk`` rows."""
    gate_up: Tuple[int, int]
    splits: int
    chunk: int


def _blocks(T: int, N: int, tile: Tuple[int, int]) -> int:
    return -(-T // tile[0]) * -(-N // tile[1])


def mlp_plan(T: int, D: int, F: int, n_sm: int) -> MlpPlan:
    """Tiles and split for (T, D, F) on a card of ``n_sm`` SMs. Gate/up:
    the widest tile whose grid has at least ``n_sm`` blocks, else the
    narrowest (never split: its epilogue needs whole sums). Down: one
    wide tile, whose blocks do the most work per byte staged (narrower ones
    ran slower on the H100), with d_ff split into chunks of whole BK slices
    until the grid reaches ``n_sm`` blocks. A function of the shapes alone:
    no host read of device data."""
    gate_up = next((t for t in GATE_UP_TILES
                    if _blocks(T, F, t) >= n_sm), GATE_UP_TILES[-1])
    kt = -(-F // BK)                              # BK slices of d_ff
    blocks = _blocks(T, D, DOWN_TILE)
    per = kt if blocks >= n_sm else max(1, kt // -(-n_sm // blocks))
    return MlpPlan(gate_up, -(-kt // per), per * BK)


def width_rule(D: int, dtype) -> None:
    """Raise unless a kernel for ``dtype`` takes d_model ``D``. A rule of
    dtype and width, held before every launch: both kernels need D % 32 ==
    0; the bf16 tensor-core GEMMs take any such D; the f32 CUDA-core kernel
    keeps a block's 8 tokens x D output columns in registers, at most 4
    columns of each token a thread, so it takes D <= ``F32_MAX_D``."""
    if D <= 0 or D % 32:
        raise ValueError(f"fused_mlp: D={D} must be a positive multiple of "
                         f"32")
    if dtype == torch.float32 and D > F32_MAX_D:
        raise ValueError(
            f"fused_mlp: D={D} is past float32's width (rule of dtype and "
            f"width: the f32 kernel keeps D output columns in registers, "
            f"D <= {F32_MAX_D}; bfloat16 takes any D % 32 == 0)")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def swiglu_plain(x: torch.Tensor, w_gate: torch.Tensor,
                 w_up: torch.Tensor) -> torch.Tensor:
    """The plain version's (T, F) intermediate: ``silu(g) * u`` with g and
    u in f32, rounded once to x's dtype."""
    xf = x.float()
    return (F.silu(xf @ w_gate.float()) * (xf @ w_up.float())).to(x.dtype)


def fused_mlp_plain(x: torch.Tensor, w_gate: torch.Tensor,
                    w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (``repro.kernels.ref.fused_mlp_ref``)."""
    a = swiglu_plain(x, w_gate, w_up)
    return (a.float() @ w_down.float()).to(x.dtype)


def fused_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor) -> torch.Tensor:
    """x: (..., D); w_gate, w_up: (D, F); w_down: (F, D) -> (..., D)."""
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w_gate, w_up, w_down)
    ws = (w_gate, w_up, w_down)
    if x.device.type != "cuda" or any(w.device != x.device for w in ws):
        raise ValueError("fused_mlp: x and weights must share one CUDA device")
    D = x.shape[-1]
    Fd = w_gate.shape[1]
    if (w_gate.shape != (D, Fd) or w_up.shape != (D, Fd)
            or w_down.shape != (Fd, D)):
        raise ValueError(f"fused_mlp: x {tuple(x.shape)} with weights "
                         f"{[tuple(w.shape) for w in ws]}")
    if any(w.dtype != x.dtype for w in ws):
        raise ValueError("fused_mlp: x and weight dtypes differ")
    width_rule(D, x.dtype)
    if not all(w.is_contiguous() for w in ws):
        raise ValueError("fused_mlp: weights must be contiguous")
    code = _build.dtype_code(x.dtype)
    x2 = x.reshape(-1, D).contiguous()
    out = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.bfloat16:
        err = _launch_bf16(x2, ws, out, Fd, stream)
    else:
        fn = _build.function("fused_mlp", "fused_mlp_fwd", _ARGTYPES)
        with torch.cuda.device(x.device):
            err = fn(x2.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                     w_down.data_ptr(), out.data_ptr(), x2.shape[0], D, Fd,
                     code, stream)
    _build.check(err, "fused_mlp")
    global launches
    launches += 1
    return out.reshape(x.shape)


def _launch_bf16(x2: torch.Tensor, ws, out: torch.Tensor, Fd: int,
                 stream: int) -> int:
    """The tensor-core kernels: plan, workspaces, one C call."""
    if Fd % 8:
        raise ValueError(f"fused_mlp: d_ff={Fd} must be a multiple of 8 "
                         f"(the bf16 kernels copy 16-byte rows)")
    if any(w.data_ptr() % 16 for w in ws):
        raise ValueError("fused_mlp: weights must start 16-byte aligned")
    if x2.data_ptr() % 16:
        x2 = x2.clone()                    # a fresh allocation is aligned
    T, D = x2.shape
    if T == 0:
        return 0
    plan = mlp_plan(T, D, Fd, _sm_count(x2.device.index))
    a = torch.empty((T, Fd), dtype=torch.bfloat16, device=x2.device)
    part = (torch.empty((plan.splits, T, D), dtype=torch.float32,
                        device=x2.device) if plan.splits > 1 else None)
    fn = _build.function("fused_mlp", "fused_mlp_bf16_fwd", _BF16_ARGTYPES)
    with torch.cuda.device(x2.device):
        return fn(x2.data_ptr(), *(w.data_ptr() for w in ws), a.data_ptr(),
                  None if part is None else part.data_ptr(), out.data_ptr(),
                  T, D, Fd, *plan.gate_up, plan.splits, plan.chunk, stream)
