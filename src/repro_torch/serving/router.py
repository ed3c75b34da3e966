"""Routing policies for the instance pool (paper §7.1 "Routing"; copy of
``repro.serving.router``).

Two policies, both deterministic given the same pool state:

  * ``UserHashRouter`` — the paper's user-id rendezvous hash (elastic
    minimal remap on scale-up/down). Ignores load entirely.
  * ``LeastBacklogRouter`` — JCT-aware: route to the instance minimizing
    (sum of predicted JCTs of its queue) + (predicted JCT of THIS request
    given that instance's prefix cache). Only possible because prefill-only
    JCT is precisely predictable — the backlog number is trustworthy, not a
    proxy. Instances whose score ties within ``affinity_tol`` are broken by
    cache affinity (longest cached prefix wins: the near-tied instance that
    already holds this user's profile KV serves the request cheaper than the
    score difference suggests), then by rendezvous hash for determinism.

Routers see engines through three probes — ``pending_jct()``,
``predict_jct(n_input, chain)``, ``cached_prefix_len(chain)`` — all
lock-protected on the engine, so routing runs concurrently with serving.

``chain`` is the request's block-hash chain. Chains are granular in the
engine's block size, so on a heterogeneous pool a single chain cannot probe
every engine: callers pass ``chains`` (block_size -> chain) and each engine
is probed with the chain cut at ITS block size.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.runtime.fault_tolerance import rendezvous_hash


def chain_for(eng, chain: Tuple[int, ...],
              chains: Optional[Dict[int, Tuple[int, ...]]]):
    """The chain cut at ``eng``'s block size, falling back to ``chain``."""
    if not chains:
        return chain
    bs = getattr(getattr(eng, "ecfg", None), "block_size", None)
    return chains.get(bs, chain)


class UserHashRouter:
    """Rendezvous (HRW) hash on user id — stateless, cache-friendly for
    user-keyed workloads, oblivious to load."""

    name = "user_hash"

    def route(self, *, user_id: Optional[str], n_input: int,
              chain: Tuple[int, ...], instances: Dict[str, object],
              chains: Optional[Dict[int, Tuple[int, ...]]] = None) -> str:
        names = sorted(instances)
        return rendezvous_hash(user_id or "", names)


class LeastBacklogRouter:
    """JCT-aware least-backlog with cache-affinity tie-break."""

    name = "least_backlog"

    def __init__(self, affinity_tol: float = 0.15):
        # relative score window inside which cache affinity overrides backlog
        self.affinity_tol = affinity_tol

    def route(self, *, user_id: Optional[str], n_input: int,
              chain: Tuple[int, ...], instances: Dict[str, object],
              chains: Optional[Dict[int, Tuple[int, ...]]] = None) -> str:
        names = sorted(instances)
        scores = {}
        matched = {}
        for name in names:
            eng = instances[name]
            c = chain_for(eng, chain, chains)
            probe = getattr(eng, "probe", None)
            if probe is not None:
                # batched probe: all three numbers in ONE engine-lock
                # acquisition (in-process) or ONE staleness-bounded RPC
                # (cross-process RemoteEngine) per instance per scan
                pending, predict, matched[name] = probe(n_input, c)
                scores[name] = pending + predict
            else:
                scores[name] = eng.pending_jct() + eng.predict_jct(
                    n_input, c)
        best = min(scores.values())
        window = best + self.affinity_tol * max(best, 1e-9)
        close = [n for n in names if scores[n] <= window]
        if len(close) > 1:
            matched = {n: matched[n] if n in matched
                       else instances[n].cached_prefix_len(
                           chain_for(instances[n], chain, chains))
                       for n in close}
            top = max(matched.values())
            if top > 0:
                close = [n for n in close if matched[n] == top]
        if len(close) == 1:
            return close[0]
        return rendezvous_hash(user_id or "", close)


ROUTERS = {r.name: r for r in (UserHashRouter, LeastBacklogRouter)}


def get_router(name: str, **kw):
    try:
        return ROUTERS[name](**kw)
    except KeyError:
        raise KeyError(f"unknown router {name!r}; have {sorted(ROUTERS)}")
