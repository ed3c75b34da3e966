"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version and with a launch counter:

  rmsnorm          csrc/rmsnorm.cu          <- repro/kernels/rmsnorm.py
  flash_attention  csrc/flash_attention.cu  <- repro/kernels/flash_attention.py
                                               (dense mode + q_offset,
                                               segmented, positioned)
  fused_mlp        csrc/fused_mlp.cu        <- repro/kernels/fused_mlp.py
  decode_attention csrc/decode_attention.cu <- repro/kernels/decode_attention.py
                                               (split-K, with a combine)

Sources are built on first use (``_build``); nothing is built or loaded at
import time.
"""

SOURCES = ("rmsnorm", "flash_attention", "fused_mlp", "decode_attention")
