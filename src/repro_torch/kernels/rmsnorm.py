"""Fused RMSNorm: ``x * rsqrt(mean(x^2) + eps) * (1 + w)`` with f32 internals.

Replaces the Pallas kernel ``repro/kernels/rmsnorm.py::rmsnorm``. It is
bound by bytes (one read of x, one write of y; ~4 flops per element), so
the Hopper kernel (``csrc/rmsnorm.cu``) makes one pass over device memory
per row: each thread loads its share of the row into registers as 16-byte
vectors, the f32 sum of x^2 is a warp-shuffle reduction (across warps
through shared memory), and the scaled row is stored from the registers as
16-byte vectors. Warps a row and rows a block are ``launch_plan`` of (T, D,
dtype). Where the vectors cannot take a call (``vector_rule``: D or the
row stride not whole 16-byte vectors, an unaligned base, a row longer than
1024 threads' registers hold) a scalar kernel takes it, one block a row: a
rule of width inside the CUDA source, never the plain version. On the main
path it runs 2L+1 times per forward.

``rmsnorm`` launches the kernel for CUDA tensors and uses ``rmsnorm_plain``
for CPU tensors; ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

launches = 0
VECTOR_BYTES = 16
MAX_VECTORS = 4          # 16-byte vectors a thread holds (csrc kMaxVectors)
MAX_THREADS = 1024       # a block
BLOCK_WARPS = 4          # warps a block of the vector kernel aims at
SCALAR_THREADS = 256     # the scalar kernel: one block a row

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # x, w, y
             ctypes.c_int, ctypes.c_int, ctypes.c_longlong,        # T, D, stride
             ctypes.c_float, ctypes.c_int, ctypes.c_int,           # eps, plan
             ctypes.c_int, ctypes.c_void_p]                        # dtype, stream


class Plan(NamedTuple):
    """A launch: the vector kernel with ``warps_per_row`` warps a row and
    ``rows_per_block`` rows a block (each thread holding ``vectors``
    16-byte vectors of its row), or the scalar kernel (``warps_per_row``
    0, one block of ``threads`` a row)."""
    vector: bool
    warps_per_row: int
    rows_per_block: int
    blocks: int
    threads: int
    vectors: int


def vector_rule(D: int, elem_size: int, row_stride: int,
                *addresses: int) -> bool:
    """Whether the vector kernel takes a call: D and the row stride are
    whole 16-byte vectors, every base address is 16-byte aligned, and a row
    fits ``MAX_VECTORS`` vectors a thread of at most ``MAX_THREADS``
    threads. Otherwise the scalar kernel takes it (a rule of width)."""
    vec = VECTOR_BYTES // elem_size
    return (D % vec == 0 and row_stride % vec == 0
            and all(a % VECTOR_BYTES == 0 for a in addresses)
            and D // vec <= MAX_THREADS * MAX_VECTORS)


def launch_plan(T: int, D: int, elem_size: int, n_sm: int,
                vector: bool = True) -> Plan:
    """The launch for T rows of D elements of ``elem_size`` bytes on a card
    of ``n_sm`` SMs: one warp a row while a row is at most 32 x
    ``MAX_VECTORS`` vectors (bf16 D 1024, f32 D 512), as many warps as it
    needs above; up to ``BLOCK_WARPS // warps a row`` rows a block, so a
    block has 4 warps' loads in flight, but no more than ``T // n_sm`` (at
    least one), so that short calls spread over the SMs; with ``vector``
    False the scalar kernel's one block a row."""
    if not vector:
        return Plan(False, 0, 1, T, SCALAR_THREADS, 0)
    nvec = D // (VECTOR_BYTES // elem_size)
    wpr = max(1, -(-nvec // (32 * MAX_VECTORS)))
    rpb = max(1, min(BLOCK_WARPS // wpr, T // max(n_sm, 1)))
    tpr = 32 * wpr
    return Plan(True, wpr, rpb, -(-T // rpb), tpr * rpb, -(-nvec // tpr))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    T = x2.shape[0]
    if T == 0 or D == 0:
        return out.reshape(x.shape)
    plan = launch_plan(T, D, x.element_size(), _sm_count(x.device.index),
                       vector_rule(
        D, x.element_size(), x2.stride(0), x2.data_ptr(), w.data_ptr(),
        out.data_ptr()))
    fn = _build.function("rmsnorm", "rmsnorm_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x2.data_ptr(), w.data_ptr(), out.data_ptr(), T, D,
                 x2.stride(0), eps, plan.warps_per_row, plan.rows_per_block,
                 code, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rmsnorm")
    global launches
    launches += 1
    return out.reshape(x.shape)
