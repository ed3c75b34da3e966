"""Parameter trees of the transformer (dense, vlm, audio and moe families,
with or without local/global pairs): seeded init and a numpy bridge.

The tree is the reference's (``repro.models.transformer.model_defs``):
``embed/tok`` (V, D); ``blocks/{ln1, ln2, attn/{wq, wk, wv, wo, bq, bk, bv},
mlp/{w_gate, w_up, w_down}}`` stacked with a leading layer axis, where an
moe config has ``moe/{router, w_gate, w_up, w_down, shared/*}``
(``models.moe.moe_defs``) in place of ``mlp``, and a local_global config
(gemma2) has two such stacks of ``num_layers // 2`` blocks each,
``blocks_local`` and ``blocks_global``, in place of ``blocks``;
``final_norm`` (D,); ``lm_head`` (D, V) when embeddings are untied.
Initializers follow ``repro.runtime.sharding.materialize``: zeros for norms
and biases, normal/sqrt(fan_in) for "scaled" matrices, normal*0.02 for the
embedding. The numbers differ from the reference's (a torch.Generator is
not a jax PRNG key); the bridge carries the reference's own values across.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, check_ported
from repro_torch.models.layers import torch_dtype
from repro_torch.models.moe import moe_defs
from repro_torch.runtime.device import DeviceLike, resolve_device

# path -> (shape, init); init is "zeros", "scaled" or "normal" (std 0.02)
ParamDefs = Dict[Tuple[str, ...], Tuple[Tuple[int, ...], str]]


def param_defs(cfg: ModelConfig) -> ParamDefs:
    check_ported(cfg)
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    F, V, Ln = cfg.d_ff, cfg.vocab_size, cfg.num_layers
    block = {
        ("ln1",): ((D,), "zeros"),
        ("ln2",): ((D,), "zeros"),
        ("attn", "wq"): ((D, H * hd), "scaled"),
        ("attn", "wk"): ((D, KV * hd), "scaled"),
        ("attn", "wv"): ((D, KV * hd), "scaled"),
        ("attn", "wo"): ((H * hd, D), "scaled"),
    }
    if cfg.qkv_bias:
        block[("attn", "bq")] = ((H * hd,), "zeros")
        block[("attn", "bk")] = ((KV * hd,), "zeros")
        block[("attn", "bv")] = ((KV * hd,), "zeros")
    if cfg.is_moe:
        for path, spec in moe_defs(cfg).items():
            block[("moe",) + path] = spec
    else:
        block[("mlp", "w_gate")] = ((D, F), "scaled")
        block[("mlp", "w_up")] = ((D, F), "scaled")
        block[("mlp", "w_down")] = ((F, D), "scaled")
    defs: ParamDefs = {("embed", "tok"): ((V, D), "normal")}
    stacks = ((("blocks_local",), Ln // 2), (("blocks_global",), Ln // 2)) \
        if cfg.local_global else ((("blocks",), Ln),)
    for stack, n in stacks:
        for path, (shape, init) in block.items():
            defs[stack + path] = ((n,) + shape, init)
    defs[("final_norm",)] = ((D,), "zeros")
    if not cfg.tie_embeddings:
        defs[("lm_head",)] = ((D, V), "scaled")
    return defs


def _set(tree: Dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Dict:
    """Random parameters in ``cfg.dtype``, drawn on ``device`` from
    ``generator`` (a generator of that device) in tree order."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    tree: Dict = {}
    for path, (shape, init) in param_defs(cfg).items():
        if init == "zeros":
            arr = torch.zeros(shape, dtype=dtype, device=dev)
        else:
            std = (1.0 / math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
                   if init == "scaled" else 0.02)
            arr = (torch.randn(shape, generator=generator, device=dev,
                               dtype=torch.float32) * std).to(dtype)
        _set(tree, path, arr)
    return tree


def params_from_numpy(tree: Dict, cfg: ModelConfig,
                      device: DeviceLike = "cuda") -> Dict:
    """The port's tree from the reference's parameter tree given as numpy
    arrays (same nesting, stacked ``blocks``), cast to ``cfg.dtype``."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    defs = param_defs(cfg)
    got = dict(_leaves(tree))
    if set(got) != set(defs):
        raise ValueError(f"parameter tree mismatch: missing "
                         f"{sorted(set(defs) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(defs))}")
    out: Dict = {}
    for path, (shape, _) in defs.items():
        arr = np.asarray(got[path])
        if arr.shape != shape:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, "
                             f"expected {shape}")
        _set(out, path, torch.from_numpy(np.array(arr)).to(
            device=dev, dtype=dtype))
    return out


def cast_params(tree: Dict, dtype: torch.dtype,
                device: torch.device) -> Dict:
    """Floating leaves cast to ``dtype`` on ``device`` (the reference's
    ``repro.models.model.cast_params``)."""
    out: Dict = {}
    for path, arr in _leaves(tree):
        if arr.is_floating_point():
            arr = arr.to(device=device, dtype=dtype)
        else:
            arr = arr.to(device=device)
        _set(out, path, arr)
    return out
