"""PrefillOnly on PyTorch + CUDA (NVIDIA Hopper).

A port of the ``repro`` package (JAX on a TPU) that keeps its module names,
so ``repro_torch.core.engine`` is the counterpart of ``repro.core.engine``.
It imports torch, numpy and the standard library only; what it needs from
the reference it keeps as its own copy.

Entry points take an explicit ``device`` (default ``"cuda"``) and raise when
CUDA is absent, unless the caller asks for ``"cpu"``. On CUDA tensors the
model's RMSNorm, attention and SwiGLU MLP run hand-written Hopper kernels
(``repro_torch/kernels/csrc``); on CPU tensors their plain PyTorch versions.
"""
