"""Model API: one object per config of the port's families (dense, vlm,
audio, moe, with or without local/global layer pairs;
``configs.base.check_ported``).

Port of ``repro.models.model``'s ``ModelAPI`` and ``build``:

    defs()                                   parameter shapes and inits
    prefill(params, batch, kv_keep)          -> (last logits, prefix KV)
    decode_step(params, tokens, cache, position) -> (logits, cache)
    init_cache(batch, max_len, device)       zeroed KV cache on ``device``

Parameters are cast to ``cfg.dtype`` on every call, as the reference casts
them (leaves already in that dtype are passed as they are, so nothing is
copied). ``prefill``'s batch holds ``tokens`` or, in their place,
``embeds`` (B, S, D). ``decode_step`` updates the cache in place and
returns the same dict. ``train_loss`` waits for the training slice (ROADMAP
A8). The sharding argument ``num_shards`` and the dry-run's
``input_specs``, ``make_batch`` and ``init_cache(abstract=True)`` wait for
the sharding and dry-run slice (A9).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

from repro_torch.configs.base import ModelConfig, check_ported
from repro_torch.models import layers as L
from repro_torch.models import params as P
from repro_torch.models import transformer as tfm
from repro_torch.runtime.device import DeviceLike


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    defs: Callable[[], Any]
    train_loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_cache: Callable[..., Any]


def _train_loss(*args, **kwargs):
    raise NotImplementedError(
        "train_loss comes with the training slice of the port (ROADMAP A8)")


def build(cfg: ModelConfig) -> ModelAPI:
    """The API of a dense, vlm, audio or moe config (an moe config's decode
    runs its experts on each step's tokens, a sliding window's cache is a
    ring, and a local_global config's cache is the ring/global pair); other
    families raise, naming their ROADMAP items."""
    check_ported(cfg)
    dtype = L.torch_dtype(cfg.dtype)

    def cast(params: Dict) -> Dict:
        return P.cast_params(params, dtype, params["embed"]["tok"].device)

    def init_cache(batch: int, max_len: int, device: DeviceLike = "cuda"):
        return tfm.init_cache(cfg, batch, max_len, device=device)

    return ModelAPI(
        cfg=cfg,
        defs=lambda: P.param_defs(cfg),
        train_loss=_train_loss,
        prefill=lambda params, batch, kv_keep=0:
            tfm.prefill(cast(params), cfg, batch, kv_keep=kv_keep),
        decode_step=lambda params, tokens, cache, position:
            tfm.decode_step(cast(params), cfg, tokens, cache, position),
        init_cache=init_cache,
    )
