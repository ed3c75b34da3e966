"""Mixture-of-experts MLP: sort-based dispatch with a static capacity.

Port of ``repro.models.moe``'s ``moe_defs``, ``_capacity``,
``_dispatch_compute`` and ``moe_apply`` on one device (the reference's
path without a mesh; its ``shard_map`` path and ``num_shards`` come with
the sharding slice, ROADMAP A9). Semantics kept from the reference:

- **Capacity.** ``C = max(8, roundup8(ceil(t K / E capacity_factor)))``
  over the t rows of one dispatch call. Under hybrid prefilling
  (``hybrid_chunk`` > 0 and more tokens than one chunk) the reference pads
  the last chunk with zero rows to a full chunk, so every chunk of such a
  call prices C from ``hybrid_chunk`` rows. Here the last chunk is not
  padded: it is dispatched at its true length with C priced from
  ``hybrid_chunk`` rows. The padding rows would sort after every real row
  of their experts (stable order below) and take no real row's slot, so
  this gives the real rows the reference's routes, slots and drops.
- **Top-k ties.** The experts are chosen by a stable descending sort of
  the router's probabilities: among equal values the lower expert index
  comes first, as ``jax.lax.top_k`` orders them (``torch.topk`` gives no
  order for ties). Ties are common: a zero row ties on every expert, and
  bf16 router logits often round to one value.
- **Slots and drops.** A stable argsort of the (t K) expert ids, each
  assignment's position in its expert's run from ``searchsorted``, ``keep
  = pos < C``; a dropped assignment is written to the dump row ``E C`` and
  contributes 0 (its token keeps its residual and, in llama4-scout, the
  shared expert).
- **Rounding.** Router logits are a product in the model dtype, then f32
  for the softmax; the gate weights are renormalised over the K chosen
  experts. Each expert's g and u are products in the model dtype, ``silu``
  is taken in f32 and rounded to the model dtype before the product with
  u, the down projection is in the model dtype, and each contribution is
  scaled by its gate weight in the model dtype.
- **Combine.** The reference adds contributions into the token rows with a
  scatter-add. Here each (token, k) assignment gathers its expert row (the
  dump row reads as zeros), and the K contributions of a token are summed
  over a (t, K, D) tensor: no atomics, the same sum for every run.

The experts' products are batched ``torch.bmm`` over the (E, C, D) dispatch
buffer, as the reference computes them with ``einsum`` outside any Pallas
kernel. The shared expert is ``layers.mlp_apply``, the fused MLP kernel, as
a dense block's MLP is. Every shape is static and nothing syncs with the
host, so a CUDA graph captures the layer.

``record_routes()`` collects each call's routes and keep masks (the tests'
and ``chip_smoke.py``'s comparisons of routing); nothing is recorded
outside it.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hybrid_prefill import chunked_map
from repro_torch.models import layers as L

# path (below ``blocks/moe``) -> (shape, init), as ``params.param_defs``
MoEDefs = Dict[Tuple[str, ...], Tuple[Tuple[int, ...], str]]

# the active recorder of ``record_routes`` (None: nothing is recorded)
_routes: Optional[List[Dict]] = None


@contextlib.contextmanager
def record_routes() -> Iterator[List[Dict]]:
    """Collect the routing of every ``moe_apply`` call made inside, in call
    order (one a layer of a forward): a dict of ``experts`` (T, K) int64,
    the chosen experts of each token in the reference's order, ``keep``
    (T, K) bool, whether each assignment got a slot, and ``capacity``, the
    C of each dispatch (one a hybrid chunk)."""
    global _routes
    saved, _routes = _routes, []
    try:
        yield _routes
    finally:
        _routes = saved


def moe_defs(cfg: ModelConfig) -> MoEDefs:
    """The router (D, E), the experts' (E, D, F) gate and up and (E, F, D)
    down weights, all "scaled", and the shared expert's MLP where the
    config has one."""
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    defs: MoEDefs = {
        ("router",): ((D, E), "scaled"),
        ("w_gate",): ((E, D, F_), "scaled"),
        ("w_up",): ((E, D, F_), "scaled"),
        ("w_down",): ((E, F_, D), "scaled"),
    }
    if cfg.shared_expert:
        defs[("shared", "w_gate")] = ((D, F_), "scaled")
        defs[("shared", "w_up")] = ((D, F_), "scaled")
        defs[("shared", "w_down")] = ((F_, D), "scaled")
    return defs


def _capacity(t_local: int, cfg: ModelConfig) -> int:
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    c = int(math.ceil(t_local * K / E * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)  # >=8, rounded up to a multiple of 8


def select_experts(probs: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest probabilities of each row, ties
    going to the lower index first (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _route(xr: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
           C: int):
    """Router, top-k and slots of (t, D) tokens at capacity C: the gate
    weights (t, K) f32, the chosen experts (t, K), and their ``_slots``."""
    K = cfg.num_experts_per_tok
    logits = (xr @ router).float()                        # (t, E)
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = select_experts(probs, K)           # (t, K)
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)
    return (gate_w, gate_idx) + _slots(gate_idx, cfg.num_experts, C)


def _slots(gate_idx: torch.Tensor, E: int, C: int):
    """Slots of the (t, K) chosen experts at capacity C: the (t K)
    assignments' stable order by expert, and each assignment's row of the
    (E C + 1, D) dispatch buffer in that order (``dest``) and in (token, k)
    order (``dest_tok``); row E C is the dump row of the dropped ones."""
    flat_e = gate_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(E, device=flat_e.device, dtype=sorted_e.dtype))
    pos = (torch.arange(flat_e.numel(), device=flat_e.device)
           - seg_start[sorted_e])
    dest = torch.where(pos < C, sorted_e * C + pos, E * C)
    # each assignment's row in (token, k) order: a permutation's scatter
    dest_tok = torch.empty_like(dest).index_copy_(0, order, dest)
    return order, dest, dest_tok


def _dispatch(xr: torch.Tensor, order: torch.Tensor, dest: torch.Tensor,
              C: int, cfg: ModelConfig) -> torch.Tensor:
    """The kept assignments' token rows in the (E, C, D) buffer (a view of
    an (E C + 1, D) one whose last row takes the dropped ones)."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    D = xr.shape[1]
    buf = torch.zeros((E * C + 1, D), dtype=xr.dtype, device=xr.device)
    buf.index_copy_(0, dest, xr.index_select(0, order // K))
    return buf[: E * C].view(E, C, D)


def _experts(h: torch.Tensor, p: Dict) -> torch.Tensor:
    """Each expert's SwiGLU on its C rows of h (E, C, D); returns the
    (E C + 1, D) outputs with a zero row at E C for the dropped
    assignments."""
    E, C, D = h.shape
    g = torch.bmm(h, p["w_gate"])
    u = torch.bmm(h, p["w_up"])
    act = F.silu(g.float()).to(h.dtype) * u
    del g, u
    out_e = torch.zeros((E * C + 1, D), dtype=h.dtype, device=h.device)
    torch.bmm(act, p["w_down"], out=out_e[: E * C].view(E, C, D))
    return out_e


def _combine(out_e: torch.Tensor, dest_tok: torch.Tensor,
             gate_w: torch.Tensor) -> torch.Tensor:
    """Each token's K expert rows (the dump row reads zeros), scaled by
    their gate weights in the model dtype and summed: (t, D)."""
    t, K = gate_w.shape
    contrib = out_e.index_select(0, dest_tok).view(t, K, out_e.shape[1])
    contrib = contrib * gate_w.to(out_e.dtype)[:, :, None]
    return contrib.sum(dim=1)


def _dispatch_compute(xr: torch.Tensor, p: Dict, cfg: ModelConfig,
                      rows: int) -> torch.Tensor:
    """Sort-based MoE over (t, D) tokens with the capacity of ``rows`` rows
    (t, or the full chunk of a padded reference chunk). Returns (t, D)."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    t = xr.shape[0]
    C = _capacity(rows, cfg)
    gate_w, gate_idx, order, dest, dest_tok = _route(xr, p["router"], cfg, C)
    out_e = _experts(_dispatch(xr, order, dest, C, cfg), p)
    if _routes is not None:
        _routes[-1]["experts"].append(gate_idx)
        _routes[-1]["keep"].append(dest_tok.view(t, K) < E * C)
        _routes[-1]["capacity"].append(C)
    return _combine(out_e, dest_tok, gate_w)


def moe_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
              hybrid_chunk: int = 0) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D). Tokens are dispatched ``hybrid_chunk`` at
    a time (all at once at 0 or when they fit one chunk); every chunk of a
    chunked call has the capacity of a full chunk, as the reference's
    padded last chunk has."""
    B, S, D = x.shape
    T = B * S
    rows = hybrid_chunk if 0 < hybrid_chunk < T else T
    if _routes is not None:
        _routes.append({"experts": [], "keep": [], "capacity": []})
    out = chunked_map(lambda xc: _dispatch_compute(xc, p, cfg, rows),
                      x.reshape(T, D), hybrid_chunk, axis=0)
    if _routes is not None:
        rec = _routes[-1]
        rec["experts"] = torch.cat(rec["experts"])
        rec["keep"] = torch.cat(rec["keep"])
    out = out.reshape(B, S, D)
    if cfg.shared_expert:
        out = out + L.mlp_apply(p["shared"], x, chunk=hybrid_chunk)
    return out
