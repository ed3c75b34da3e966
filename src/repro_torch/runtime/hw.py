"""Hardware constants of the port's target card + roofline helpers.

The reference defaults to a TPU v5e (``repro.runtime.hw.DEFAULT_CHIP``);
the port has no default chip: every caller passes one explicitly.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float      # FLOP/s, dense tensor-core rate
    hbm_bw: float               # bytes/s
    hbm_bytes: float            # bytes


# NVIDIA H100 SXM data sheet (dense rates, 700 W power limit)
H100_SXM = ChipSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    hbm_bytes=80e9,
)


def compute_seconds(flops: float, chip: ChipSpec) -> float:
    return flops / chip.peak_flops_bf16


def memory_seconds(bytes_moved: float, chip: ChipSpec) -> float:
    return bytes_moved / chip.hbm_bw
