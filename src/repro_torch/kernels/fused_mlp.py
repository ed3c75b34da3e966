"""Fused SwiGLU MLP: ``(silu(x Wg) * (x Wu)) Wd`` without a (T, d_ff)
intermediate in device memory.

Replaces the Pallas kernel ``repro/kernels/fused_mlp.py::fused_mlp`` and
keeps its rounding order: g and u in f32, ``a = silu(g) * u`` cast to the
input dtype, the down product accumulated in f32 and cast at the end. (The
reference model layer ``repro.models.layers.mlp_apply`` casts ``silu(g)``
before the multiply instead; the port's model path uses this kernel's
order. At float32 the two agree.)

The Pallas (256, D) f32 scratch is 1 MiB at D = 1024, above an SM's 227 KB,
so the Hopper kernel (``csrc/fused_mlp.cu``) splits differently: a block
owns 8 tokens and all D output columns in registers and walks d_ff in
chunks of 32 — gate/up partial products, a silu*mul epilogue in shared
memory, then the down-product accumulation. A ragged last chunk is masked
(d_ff = 2816 is not a multiple of the Pallas block_f 512). It is bound by
operations at the main path's T >= 512, but this first version computes
with f32 FMAs rather than tensor cores.

``fused_mlp`` launches the kernel for CUDA tensors and uses
``fused_mlp_plain`` for CPU tensors; ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

MAX_D = 1024                    # widest D the kernel instantiates
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 5                       # x, wg, wu, wd, out
             + [ctypes.c_int] * 4                        # T, D, F, dtype
             + [ctypes.c_void_p])                        # stream


def fused_mlp_plain(x: torch.Tensor, w_gate: torch.Tensor,
                    w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (``repro.kernels.ref.fused_mlp_ref``)."""
    xf = x.float()
    g = xf @ w_gate.float()
    u = xf @ w_up.float()
    a = (F.silu(g) * u).to(x.dtype)
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
    if D % 32 or D > MAX_D:
        raise ValueError(f"fused_mlp: D={D} must be a multiple of 32, "
                         f"<= {MAX_D}")
    if any(w.dtype != x.dtype for w in ws):
        raise ValueError("fused_mlp: x and weight dtypes differ")
    if not all(w.is_contiguous() for w in ws):
        raise ValueError("fused_mlp: weights must be contiguous")
    code = _build.dtype_code(x.dtype)
    x2 = x.reshape(-1, D).contiguous()
    out = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    fn = _build.function("fused_mlp", "fused_mlp_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x2.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                 w_down.data_ptr(), out.data_ptr(), x2.shape[0], D, Fd, code,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "fused_mlp")
    global launches
    launches += 1
    return out.reshape(x.shape)
