"""Fused RMSNorm: ``x * rsqrt(mean(x^2) + eps) * (1 + w)`` with f32 internals.

Replaces the Pallas kernel ``repro/kernels/rmsnorm.py::rmsnorm``. The
Hopper kernel (``csrc/rmsnorm.cu``) gives each row one block: a warp-shuffle
reduction of x^2 in f32, then the ``(1 + w)`` scale. It is bound by bytes
(one read of x, one write of y; ~4 flops per element), so its design aim is
a single pass over device memory per row. On the main path it runs 2L+1
times per forward.

``rmsnorm`` launches the kernel for CUDA tensors and uses ``rmsnorm_plain``
for CPU tensors; ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # x, w, y
             ctypes.c_int, ctypes.c_int, ctypes.c_longlong,        # T, D, stride
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p]        # eps, dtype, stream


def rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version (``repro.kernels.ref.rmsnorm_ref``)."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(x.dtype)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D), weight: (D,) -> (..., D) in x's dtype."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, weight, eps)
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, weight on "
                         f"{weight.device}; the kernel takes one CUDA device")
    D = x.shape[-1]
    if weight.shape != (D,) or weight.dtype != x.dtype:
        raise ValueError(f"rmsnorm: weight {tuple(weight.shape)} "
                         f"{weight.dtype} for x {tuple(x.shape)} {x.dtype}")
    code = _build.dtype_code(x.dtype)
    x2 = x.reshape(-1, D)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    w = weight.contiguous()
    out = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    fn = _build.function("rmsnorm", "rmsnorm_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x2.data_ptr(), w.data_ptr(), out.data_ptr(), x2.shape[0], D,
                 x2.stride(0), eps, code,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rmsnorm")
    global launches
    launches += 1
    return out.reshape(x.shape)
