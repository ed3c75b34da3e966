"""KV-cache policy + prefill memory model — paper §3.1 (profile run), §4, §5
(copy of ``repro.core.kv_policy``: ``bucket``, ``KVLifecycle`` and
``MemoryModel``, whose ``chip`` the caller always passes).

``MemoryModel`` answers three questions from one analytic model:
  * peak prefill memory of a technique at input length S  (Fig 3/4/10)
  * MIL — max input length a technique can serve            (Table 2)
  * prefix-KV budget: HBM left over for the prefix cache after reserving the
    peak working set at MIL                                  (profile run)

Techniques modeled (per paper §2.5/§4):
  paged       vLLM PagedAttention: full activations + full KV, no chunking
  chunked     chunked prefill: chunk-bounded activations, but KV of ALL
              layers retained between chunks
  discard     naive KV discard (§2.6): one layer of KV, but full-length
              linear-layer intermediates (the paper's 1.6x disappointment)
  hybrid      PrefillOnly hybrid prefilling: chunk-bounded MLP intermediates
              + one layer of transient K/V + suffix discard
  tp / pp     k-way tensor / pipeline parallel variants of ``paged``
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime.hw import ChipSpec

BYTES = 2  # bf16


def bucket(n: int, sizes: Sequence[int]) -> int:
    """Smallest bucket >= n; grows geometrically past the table (clamping
    would truncate requests longer than the largest configured bucket)."""
    for s in sizes:
        if n <= s:
            return s
    s = sizes[-1]
    while s < n:
        s *= 2
    return s


@dataclasses.dataclass(frozen=True)
class KVLifecycle:
    """SINGLE OWNER of the KV keep/discard decision (paper §2.6/§4).

    The engine's forward paths discard suffix KV layer-by-layer (only the
    keep-slice of each layer is copied out in ``models/transformer.py`` —
    each layer's full-length K/V is dropped as soon as its attention has
    consumed it), and the prefix cache only ever receives whole blocks of
    the kept slice. Every keep-budget, residency and insert-bound decision
    of the engine asks this object, so the policy is stated (and tested)
    once.

    All methods are pure shape/token arithmetic — safe to call under the
    engine lock and from routing probes.
    """
    block_size: int = 16
    kv_keep_tokens: int = 10**9             # suffix-discard threshold
    buckets: Tuple[int, ...] = (64, 128, 256, 512, 1024, 2048)

    def keep(self, n_input: int) -> int:
        """Per-request KV budget in tokens (the kept prefix slice)."""
        return min(n_input, self.kv_keep_tokens)

    def keep_aligned(self, n_input: int) -> int:
        """Budget rounded DOWN to whole cache blocks — only full blocks are
        insertable, so this is the most KV a request can leave behind."""
        return (self.keep(n_input) // self.block_size) * self.block_size

    def resident(self, matched_blocks: int, n_input: int) -> bool:
        """Chain already resident past the keep bound: an insert would only
        re-slice and re-touch existing blocks, so callers skip it."""
        return matched_blocks * self.block_size >= self.keep_aligned(n_input)

    def keep_new(self, n_input: int, prefix_len: int,
                 matched_blocks: int) -> int:
        """Block-aligned NEW kept tokens beyond a reused prefix (packed
        path's per-segment kv gather length; 0 when already resident)."""
        if self.resident(matched_blocks, n_input):
            return 0
        return max(0, self.keep_aligned(n_input) - prefix_len)

    def suffix_keep_new(self, keep: int, prefix_len: int, n_fresh: int) -> int:
        """Fresh-KV tokens the suffix (cache-hit) forward must emit so the
        total kept window reaches ``keep`` (solo hit path)."""
        return max(0, min(keep, prefix_len + n_fresh) - prefix_len)

    def keep_pad(self, keep: int, S: int) -> int:
        """Jit-key bucketing of a keep budget: kv_keep only bounds how much
        KV leaves each layer (keeping more is safe, callers slice), and a
        raw per-request value would put every length in its own jit key."""
        return min(bucket(keep, self.buckets) if keep else 0, S)

    def insertable_tokens(self, keep: int, kv_from: int, n_new: int) -> int:
        """Tokens of fresh KV actually insertable after a forward that
        produced ``n_new`` kept tokens starting at offset ``kv_from``."""
        return max(0, min(keep, kv_from + n_new) - kv_from)


@dataclasses.dataclass
class MemoryModel:
    cfg: ModelConfig
    chip: ChipSpec
    utilization: float = 0.9          # HBM headroom kept for the allocator
    weight_bytes_per_param: float = BYTES  # 1.0 = fp8 (paper's quantized setups)
    # hybrid-prefilling micro-optimizations (paper §4.3): without output
    # preallocation the chunked output is double-buffered; without in-place
    # reuse each grouped-linear keeps input+output copies.
    output_prealloc: bool = True
    inplace: bool = True

    # ---- per-token byte coefficients -------------------------------------
    @property
    def weights_bytes(self) -> float:
        return self.cfg.param_count() * self.weight_bytes_per_param

    @property
    def kv_all_per_token(self) -> float:
        return float(self.cfg.kv_bytes_per_token(BYTES))

    @property
    def kv_one_layer_per_token(self) -> float:
        n = max(1, self.cfg.num_layers if self.cfg.family != "hybrid"
                else self.cfg.num_layers // max(self.cfg.attn_every, 1))
        return self.kv_all_per_token / n

    @property
    def mlp_int_per_token(self) -> float:
        """gate+up intermediates — the paper's Fig 4 villain (14x one-layer KV
        on Llama-3.1-8B)."""
        d_ff = self.cfg.d_ff if self.cfg.d_ff else self.cfg.d_inner * 2
        mult = 1.0
        if not self.output_prealloc:
            mult += 0.5               # concat copy of the chunked output
        if not self.inplace:
            mult += 0.5               # separate in/out buffers per linear
        return 2.0 * d_ff * BYTES * mult

    @property
    def attn_stream_per_token(self) -> float:
        """Transient full-sequence q/k/v + residual streams for ONE layer."""
        cfg = self.cfg
        if not cfg.has_attention:
            return 4.0 * cfg.d_model * BYTES
        qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim * BYTES
        resid = 4.0 * cfg.d_model * BYTES
        return qkv + resid

    # ---- peak memory per technique ---------------------------------------
    def peak_bytes(self, S: int, technique: str, chunk: int = 2048,
                   k: int = 2, kv_keep: Optional[int] = None) -> float:
        """``kv_keep`` (hybrid only) prices the PEAK-LAYER footprint of the
        layer-wise discard: the transient suffix KV costs ONE layer (freed as
        soon as the next layer consumes it), while the kept slice — at most
        ``kv_keep`` tokens, what ``KVLifecycle`` lets out of the forward —
        persists across ALL layers into the cache insert. ``kv_keep=None``
        keeps the pre-hierarchy behavior (kept slice not priced; the prefix
        budget accounted it globally instead)."""
        W = self.weights_bytes
        act_full = self.mlp_int_per_token + self.attn_stream_per_token
        if technique == "paged":
            return W + S * act_full + S * self.kv_all_per_token
        if technique == "chunked":
            return W + chunk * act_full + S * self.kv_all_per_token
        if technique == "discard":
            return W + S * act_full + S * self.kv_one_layer_per_token
        if technique == "hybrid":
            kept = (min(S, kv_keep) * self.kv_all_per_token
                    if kv_keep is not None else 0.0)
            return (W + chunk * self.mlp_int_per_token
                    + S * self.attn_stream_per_token
                    + S * self.kv_one_layer_per_token + kept)
        if technique == "tp":
            return (W + S * act_full + S * self.kv_all_per_token) / k
        if technique == "pp":
            # weights and KV split across stages; activations of one stage
            return (W + S * self.kv_all_per_token) / k + S * act_full
        raise ValueError(technique)

    # ---- MIL + prefix budget ----------------------------------------------
    def budget_bytes(self) -> float:
        return self.chip.hbm_bytes * self.utilization

    def max_input_length(self, technique: str, chunk: int = 2048,
                         k: int = 2, kv_keep: Optional[int] = None) -> int:
        """Closed-form MIL: peak_bytes is affine in S (piecewise affine with
        a kv_keep knee — for S past the keep bound the kept slice is a
        constant, so the long-input branch is tried first)."""
        budget = self.budget_bytes()
        base = self.peak_bytes(0, technique, chunk, k)
        slope = self.peak_bytes(1, technique, chunk, k) - base
        if kv_keep is not None and technique == "hybrid":
            const = kv_keep * self.kv_all_per_token
            if slope > 0 and base + const < budget:
                s = int((budget - base - const) / slope)
                if s > kv_keep:
                    return s
            # short-input branch: the kept slice still grows with S
            slope += self.kv_all_per_token
        if base >= budget:
            return 0
        if slope <= 0:
            return 1 << 30
        return int((budget - base) / slope)

    def prefix_budget_tokens(self, mil: int, chunk: int = 2048,
                             kv_keep: Optional[int] = None) -> int:
        """Paper §3.1 profile run: after reserving the hybrid-prefill working
        set at MIL, the remaining HBM holds the prefix KV cache. Pricing the
        peak-layer footprint via ``kv_keep`` shrinks the reservation, so the
        same HBM yields a LARGER effective device cache (BENCH_offload)."""
        reserve = self.peak_bytes(mil, "hybrid", chunk, kv_keep=kv_keep)
        free = self.budget_bytes() - reserve
        if free <= 0 or self.kv_all_per_token == 0:
            return 0
        return int(free / self.kv_all_per_token)

    def mil_table(self, chunk: int = 2048, k: int = 2) -> Dict[str, int]:
        return {t: self.max_input_length(t, chunk, k)
                for t in ("paged", "chunked", "discard", "tp", "pp", "hybrid")}
