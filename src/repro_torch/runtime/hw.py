"""Hardware constants of the port's target card + roofline helpers.

The reference defaults to a TPU v5e (``repro.runtime.hw.DEFAULT_CHIP``);
the port has no default chip: every caller passes one explicitly. The
fields are those of the reference's ``ChipSpec`` that its models read
(``MemoryModel``, ``RooflineJCT``, the simulator, the offload tier); its
``vmem_bytes``, a TPU core's vector memory, is read by none of them and
has no counterpart here.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float      # FLOP/s, dense tensor-core rate
    hbm_bw: float               # bytes/s
    hbm_bytes: float            # bytes
    ici_bw: float               # bytes/s per link and direction (NVLink)
    host_bw: float              # bytes/s host<->device (PCIe)


# NVIDIA H100 SXM. Data sheet (dense rates, 700 W power limit): bf16 989
# TFLOP/s, HBM3 3.35 TB/s, NVLink 4 900 GB/s in both directions together
# (450 GB/s a direction), PCIe Gen5 x16 64 GB/s a direction. hbm_bytes is
# what the card reports as its total (torch.cuda.mem_get_info on an NVIDIA
# H100 80GB HBM3), which chip_smoke.py checks; host_bw is the link's rate,
# which chip_smoke.py prints beside the pinned copies it times, and which
# prices the offload tier's restores until the engine's profile() measures
# the link.
H100_SXM = ChipSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    hbm_bytes=85_017_493_504,
    ici_bw=450e9,
    host_bw=64e9,
)


def compute_seconds(flops: float, chip: ChipSpec) -> float:
    return flops / chip.peak_flops_bf16


def memory_seconds(bytes_moved: float, chip: ChipSpec) -> float:
    return bytes_moved / chip.hbm_bw


def collective_seconds(bytes_moved: float, chip: ChipSpec,
                       chips: int = 1) -> float:
    return bytes_moved / (chips * chip.ici_bw)
