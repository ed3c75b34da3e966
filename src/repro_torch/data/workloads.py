"""Workload traces — paper Table 1 (post recommendation, credit verification)
(copy of ``repro.data.workloads``).

Requests are generated with precomputed prefix hash chains so simulator-side
prefix matching never touches raw tokens. Real-token variants (for driving an
engine) are available via ``materialize_tokens=True``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.prefix_cache import token_chain
from repro_torch.core.scheduler import Request


@dataclasses.dataclass
class Trace:
    name: str
    requests: List[Request]

    @property
    def total_tokens(self) -> int:
        return sum(r.n_input for r in self.requests)

    @property
    def max_len(self) -> int:
        return max(r.n_input for r in self.requests)


def _poisson_arrivals(rng: np.random.Generator, n: int, rate: float) -> np.ndarray:
    if rate <= 0:
        return np.zeros(n)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def post_recommendation(qps: float, *, num_users: int = 20,
                        posts_per_user: int = 50, post_len: int = 150,
                        profile_mean: int = 14_000, profile_std: int = 3_000,
                        block_size: int = 16, vocab: int = 32_000,
                        seed: int = 0, materialize_tokens: bool = False,
                        scale_tokens: float = 1.0) -> Trace:
    """Paper Table 1 row 1: 20 users x 50 posts; requests of one user share
    the (11k-17k token) profile prefix. ``qps`` is the request-level Poisson
    rate. ``scale_tokens`` shrinks lengths for CPU-engine runs."""
    rng = np.random.default_rng(seed)
    n = num_users * posts_per_user
    arrivals = _poisson_arrivals(rng, n, qps)
    requests: List[Request] = []
    i = 0
    for u in range(num_users):
        plen = max(block_size,
                   int(rng.normal(profile_mean, profile_std) * scale_tokens))
        profile = rng.integers(0, vocab, size=plen).tolist()
        for _ in range(posts_per_user):
            post = rng.integers(0, vocab, size=max(1, int(post_len * scale_tokens))).tolist()
            tokens = profile + post
            requests.append(Request(
                n_input=len(tokens),
                arrival=float(arrivals[i]),
                chain=token_chain(tokens, block_size),
                tokens=tokens if materialize_tokens else None,
                user_id=f"user{u}",
            ))
            i += 1
    # interleave users in arrival order (Poisson over the joint stream)
    order = rng.permutation(n)
    for j, r in enumerate(requests):
        r.arrival = float(arrivals[order[j]])
    requests.sort(key=lambda r: r.arrival)
    return Trace("post_recommendation", requests)


def credit_verification(qps: float, *, num_users: int = 60,
                        len_low: int = 40_000, len_high: int = 60_000,
                        block_size: int = 16, vocab: int = 32_000,
                        seed: int = 0, materialize_tokens: bool = False,
                        scale_tokens: float = 1.0) -> Trace:
    """Paper Table 1 row 2: 60 users, one long request each (40k-60k tokens),
    no prefix sharing — stresses MIL."""
    rng = np.random.default_rng(seed)
    arrivals = _poisson_arrivals(rng, num_users, qps)
    requests = []
    for u in range(num_users):
        ln = max(block_size, int(rng.integers(len_low, len_high) * scale_tokens))
        tokens = rng.integers(0, vocab, size=ln).tolist()
        requests.append(Request(
            n_input=ln,
            arrival=float(arrivals[u]),
            chain=token_chain(tokens, block_size),
            tokens=tokens if materialize_tokens else None,
            user_id=f"user{u}",
        ))
    return Trace("credit_verification", requests)


def get_trace(name: str, qps: float, **kw) -> Trace:
    if name == "post_recommendation":
        return post_recommendation(qps, **kw)
    if name == "credit_verification":
        return credit_verification(qps, **kw)
    raise KeyError(name)
