"""JCT (job completion time) models — paper §6.3 (copy of ``repro.core.jct``'s
``pearson``, ``LinearProxyJCT``, ``step_features``, ``PackedShapeJCT``,
``GridJCT``, ``RooflineJCT`` and ``tp_comm_bytes_per_token``; the
roofline's ``chip`` has no default).

Prefill-only requests have deterministic JCT given (n_input, n_cached); the
paper fits ``a * (n_input - n_cached) + b`` from a profile run and keeps it
calibrated online. The engine also builds ``PackedShapeJCT``, which prices
a step from its realized padded shape (the solo path's shapes included).
``GridJCT`` regresses the profiling grid with a quadratic attention term;
``RooflineJCT`` is the simulator's analytic model, and ``fit_roofline``
calibrates its efficiency and fixed overhead to steps measured on a card.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
# imported with the module, not inside a fit: a first import of
# scipy.optimize takes about a second, which an engine step's refit (timed
# by the serving watchdog) must not pay
from scipy.optimize import least_squares, nnls

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime.hw import ChipSpec

Sample = Tuple[int, int, float]  # (n_input, n_cached, seconds)


def pearson(xs: Sequence[float], ys: Sequence[float]) -> float:
    x = np.asarray(xs, np.float64)
    y = np.asarray(ys, np.float64)
    if len(x) < 2 or x.std() == 0 or y.std() == 0:
        # Degenerate input carries no correlation evidence; report 0 so a
        # zero-variance fit can't masquerade as a perfect one on the
        # jct_pearson_r gauge.
        return 0.0
    return float(np.corrcoef(x, y)[0, 1])


class LinearProxyJCT:
    """jct ≈ a * miss_tokens + b (the paper's default proxy).

    ``observe`` keeps the proxy calibrated online: the engine reports every
    executed step as (tokens, cached, wall-seconds) — a PREPACKED batch
    reports its *total packed tokens*, so the model learns packed-batch cost
    on the same miss-token axis and Algorithm 1's scores stay comparable
    between solo and packed execution. Refits over a sliding window every
    ``refit_every`` observations (cheap: 2-param lstsq).
    """

    def __init__(self, a: float = 1e-4, b: float = 0.01, window: int = 256,
                 refit_every: int = 16):
        self.a, self.b = a, b
        self.pearson_r: float = 1.0
        self.window = window
        self.refit_every = refit_every
        self.fits = 0
        self.clamped_fits = 0
        self._recent: List[Sample] = []
        self._since_fit = 0

    def observe(self, n_input: int, n_cached: int, seconds: float) -> None:
        """Record one executed step; refit periodically."""
        self._recent.append((n_input, n_cached, seconds))
        if len(self._recent) > self.window:
            del self._recent[: len(self._recent) - self.window]
        self._since_fit += 1
        if self._since_fit >= self.refit_every and len(self._recent) >= 4:
            self.fit(self._recent)
            self._since_fit = 0

    def fit(self, samples: Sequence[Sample]) -> "LinearProxyJCT":
        miss = np.array([s[0] - s[1] for s in samples], np.float64)
        t = np.array([s[2] for s in samples], np.float64)
        A = np.stack([miss, np.ones_like(miss)], axis=1)
        coef, *_ = np.linalg.lstsq(A, t, rcond=None)
        if coef[0] < 1e-12 or coef[1] < 0.0:
            # The projection left the physically-meaningful region (negative
            # slope/intercept) — we still clamp, but count it so calibration
            # drift from a mis-specified model is observable.
            self.clamped_fits += 1
        self.a, self.b = float(max(coef[0], 1e-12)), float(max(coef[1], 0.0))
        self.pearson_r = pearson(miss, t)
        self.fits += 1
        return self

    def predict(self, n_input: int, n_cached: int = 0) -> float:
        return self.a * max(n_input - n_cached, 0) + self.b


ShapeSample = Tuple[Tuple[float, ...], float]  # (features, seconds)

SHAPE_FEATURES = ("const", "computed", "seq", "row_tokens", "prefix_slots",
                  "attn_area")


def step_features(computed: int, S: int, Nb: int, smax: int,
                  pmax: int) -> Tuple[float, ...]:
    """Feature vector for one executed step's realized shape.

    Canonicalizes the three step kinds onto one basis so formation-time
    pricing and ``BatchRecord`` observations agree:

      * fresh/solo-miss:   (S,)            → rows=0, no padded dims
      * solo-suffix (hit): (S, pmax)       → one row of (S, pmax)
      * packed:            (S, Nb, smax, pmax)

    ``row_tokens`` = rows*smax (row padding the batched hit attention pays),
    ``prefix_slots`` = rows*pmax (padded prefix keys every row attends over),
    ``attn_area`` = rows*smax*(smax+pmax) — the dense masked einsum area.
    """
    rows = Nb if Nb else (1 if pmax else 0)
    sm = smax if smax else (S if pmax else 0)
    return (1.0, float(computed), float(S), float(rows * sm),
            float(rows * pmax), float(rows * sm * (sm + pmax)) * 1e-6)


class PackedShapeJCT:
    """Prices a step from its realized padded shape.

    The token-linear proxy can't see that the batched hit attention pads
    every row to (smax, pmax): one long row re-prices the whole pack. This
    model regresses wall time on shape features — computed tokens, row
    padding, prefix slots, quadratic attention area — fitted online from the
    per-step (shape, wall) pairs the engine already emits as BatchRecords.

    Coefficients are constrained non-negative (scipy NNLS, clipped-lstsq
    fallback) so marginal pack costs are monotone in every padded dimension;
    before ``min_samples`` warm observations it falls back to a prior that
    charges the linear proxy's per-token rate on computed tokens plus
    ``pad_discount`` of that rate on padded slots.
    """

    def __init__(self, fallback: LinearProxyJCT | None = None,
                 pad_discount: float = 0.25, window: int = 512,
                 refit_every: int = 16, min_samples: int = 16):
        self.fallback = fallback or LinearProxyJCT()
        self.pad_discount = pad_discount
        self.window = window
        self.refit_every = refit_every
        self.min_samples = min_samples
        self.coef = np.zeros(len(SHAPE_FEATURES))
        self.fits = 0
        self.pearson_r: float = 0.0
        self._recent: List[ShapeSample] = []
        self._since_fit = 0

    @property
    def fitted(self) -> bool:
        return self.fits > 0

    def observe(self, computed: int, S: int, Nb: int, smax: int, pmax: int,
                seconds: float) -> None:
        """Record one executed step's (shape, wall); refit periodically."""
        self._recent.append((step_features(computed, S, Nb, smax, pmax),
                             seconds))
        if len(self._recent) > self.window:
            del self._recent[: len(self._recent) - self.window]
        self._since_fit += 1
        if (self._since_fit >= self.refit_every
                and len(self._recent) >= self.min_samples):
            self.refit_recent()
            self._since_fit = 0

    def refit_recent(self) -> None:
        if len(self._recent) >= self.min_samples:
            self.fit(self._recent)

    def fit(self, samples: Sequence[ShapeSample]) -> "PackedShapeJCT":
        X = np.array([s[0] for s in samples], np.float64)
        t = np.array([s[1] for s in samples], np.float64)
        try:
            coef, _ = nnls(X, t)
        except Exception:  # pragma: no cover - NNLS did not converge
            coef, *_ = np.linalg.lstsq(X, t, rcond=None)
            coef = np.clip(coef, 0.0, None)
        self.coef = np.asarray(coef, np.float64)
        self.pearson_r = pearson(X @ self.coef, t)
        self.fits += 1
        return self

    def predict(self, computed: int, S: int, Nb: int, smax: int,
                pmax: int, pad_slots: float | None = None) -> float:
        """Predicted wall seconds for a step of this realized shape.

        ``pad_slots`` (when the caller knows the exact row layout, e.g. batch
        formation) is the number of padded-but-dead slots the step pays:
        Σ(pmax-pref_i) + Σ(smax-suf_i) + (Nb-N)·(smax+pmax). Without it the
        prior falls back to the feature-derived upper bound.
        """
        feats = step_features(computed, S, Nb, smax, pmax)
        if self.fitted:
            return float(np.dot(self.coef, feats))
        # Prior: linear proxy on computed tokens + discounted padding rent.
        _, comp, _, row_tokens, prefix_slots, _ = feats
        if pad_slots is None:
            pad_slots = max(row_tokens - comp, 0.0) + prefix_slots
        return (self.fallback.a * (comp + self.pad_discount * pad_slots)
                + self.fallback.b)

    def coefficients(self) -> dict:
        return {name: float(c) for name, c in zip(SHAPE_FEATURES, self.coef)}


class GridJCT:
    """Bilinear + quadratic-attention regression over the profiling grid."""

    def __init__(self):
        self.coef = np.zeros(4)

    @staticmethod
    def _features(n_input, n_cached):
        n_input = np.asarray(n_input, np.float64)
        n_cached = np.asarray(n_cached, np.float64)
        return np.stack([
            np.ones_like(n_input),
            n_input - n_cached,
            n_cached,
            (n_input ** 2 - n_cached ** 2) * 1e-6,
        ], axis=-1)

    def fit(self, samples: Sequence[Sample]) -> "GridJCT":
        X = self._features([s[0] for s in samples], [s[1] for s in samples])
        t = np.array([s[2] for s in samples], np.float64)
        self.coef, *_ = np.linalg.lstsq(X, t, rcond=None)
        return self

    def predict(self, n_input: int, n_cached: int = 0) -> float:
        return float(self._features(n_input, n_cached) @ self.coef)


@dataclasses.dataclass
class RooflineJCT:
    """Analytic per-request prefill time on an instance of ``chips`` chips.

    compute = linear-layer FLOPs of the miss tokens + causal-attention FLOPs
    (quadratic over total context, discounted by the cached prefix), memory =
    one weight sweep (batch==1 per PrefillOnly's one-at-a-time execution).
    ``efficiency`` is the achievable MFU (calibratable); ``comm_overhead``
    models TP all-reduce cost per token (0 for single-instance PrefillOnly).
    """

    cfg: ModelConfig
    chips: int = 1
    chip: ChipSpec = dataclasses.field(kw_only=True)
    efficiency: float = 0.55
    comm_bytes_per_token: float = 0.0   # TP: 2*(k-1)/k * d_model * 2L * bytes
    attn_efficiency: float = 1.0        # chunked-prefill kernel penalty < 1
    fixed_overhead: float = 0.003       # scheduling + launch
    weight_bytes_per_param: float = 2.0  # 1.0 = fp8

    def flops(self, n_input: int, n_cached: int = 0) -> float:
        cfg = self.cfg
        miss = max(n_input - n_cached, 0)
        linear = 2.0 * cfg.active_param_count() * miss
        attn = 0.0
        if cfg.has_attention:
            n_attn = cfg.num_layers
            if cfg.family == "hybrid":
                n_attn = max(1, cfg.num_layers // max(cfg.attn_every, 1))
            w = cfg.sliding_window
            hd, H = cfg.head_dim, cfg.num_heads
            # causal: sum over miss tokens of context length
            ctx_total = _causal_context_sum(n_input, n_cached, w,
                                            local_global=cfg.local_global)
            attn = 4.0 * n_attn * H * hd * ctx_total
        return linear + attn

    def predict(self, n_input: int, n_cached: int = 0) -> float:
        f = self.flops(n_input, n_cached)
        compute = f / (self.chips * self.chip.peak_flops_bf16
                       * self.efficiency * self.attn_efficiency)
        weight_bytes = self.weight_bytes_per_param * self.cfg.active_param_count()
        memory = weight_bytes / (self.chips * self.chip.hbm_bw)
        comm = 0.0
        if self.comm_bytes_per_token:
            miss = max(n_input - n_cached, 0)
            comm = self.comm_bytes_per_token * miss / self.chip.ici_bw
        return max(compute, memory) + comm + self.fixed_overhead

    def samples(self, max_len: int, granularity: int = 1000) -> List[Sample]:
        """The paper's profile run: jct over the (n_input, n_cached) grid."""
        out = []
        for n in range(granularity, max_len + 1, granularity):
            for c in range(0, n, granularity):
                out.append((n, c, self.predict(n, c)))
        return out


def _causal_context_sum(n_input: int, n_cached: int, window: int,
                        local_global: bool = False) -> float:
    """Sum of attended-context lengths for tokens n_cached..n_input-1."""
    def full(a: int, b: int) -> float:       # sum_{i=a}^{b-1} (i+1)
        return (b * (b + 1) - a * (a + 1)) / 2.0

    def windowed(a: int, b: int, w: int) -> float:
        total = 0.0
        if a < w:
            total += full(a, min(b, w))
        if b > w:
            total += (b - max(a, w)) * w
        return total

    if window and local_global:
        return 0.5 * (full(n_cached, n_input)
                      + windowed(n_cached, n_input, window))
    if window:
        return windowed(n_cached, n_input, window)
    return full(n_cached, n_input)


def tp_comm_bytes_per_token(cfg: ModelConfig, tp: int, bytes_per_el: int = 2) -> float:
    """All-reduce bytes/token for TP-k: 2 all-reduces per layer over d_model,
    ring cost 2*(k-1)/k of payload."""
    if tp <= 1:
        return 0.0
    payload = 2 * cfg.num_layers * cfg.d_model * bytes_per_el
    return 2.0 * (tp - 1) / tp * payload


def fit_roofline(model: RooflineJCT,
                 samples: Sequence[Sample]) -> RooflineJCT:
    """``model`` with ``efficiency`` and ``fixed_overhead`` fitted to steps
    measured on a card, ``samples`` of (n_input, n_cached, seconds); every
    other field stays. Least squares on relative residuals (the samples
    span orders of magnitude of wall time, and each should count alike),
    started from the weighted linear fit of seconds on FLOPs, with the
    efficiency held in (0, 1] and the overhead at or above 0."""
    rows = [(int(n), int(c)) for n, c, _ in samples]
    t = np.array([s[2] for s in samples], np.float64)
    flops = np.array([model.flops(n, c) for n, c in rows])
    rate = model.chips * model.chip.peak_flops_bf16 * model.attn_efficiency
    A = np.stack([flops, np.ones_like(flops)], axis=1) / t[:, None]
    (alpha, beta), *_ = np.linalg.lstsq(A, np.ones_like(t), rcond=None)
    eff0 = (float(np.clip(1.0 / (alpha * rate), 1e-4, 1.0)) if alpha > 0
            else model.efficiency)

    def fitted(x) -> RooflineJCT:
        return dataclasses.replace(model, efficiency=float(x[0]),
                                   fixed_overhead=float(x[1]))

    def residuals(x) -> np.ndarray:
        m = fitted(x)
        return np.array([m.predict(n, c) for n, c in rows]) / t - 1.0

    sol = least_squares(residuals, [eff0, max(float(beta), 0.0)],
                        bounds=([1e-4, 0.0], [1.0, np.inf]))
    return fitted(sol.x)
