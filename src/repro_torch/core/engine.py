"""PrefillOnly engine — the real-compute serving loop (paper §3), solo path.

Port of ``repro.core.engine`` for one request per step (the reference's
``max_pack_requests <= 1`` branch):

  profile run   -> JCT model fit
  submit()      -> hash-chain the request, enqueue
  step()        -> Algorithm 1 pick (continuous JCT calibration) -> hybrid
                   prefill: ``tfm.prefill`` on a cache miss, the cache-hit
                   suffix path ``tfm.prefill_with_prefix`` when a bucketed
                   prefix is cached -> suffix-KV discard into the block
                   cache -> constrained single-token output (the paper's
                   P(Yes)/P(No) scoring)

Scheduler, JCT models, ``KVLifecycle`` and ``PrefixCache`` are the port's
own copies of the reference's. Shapes are bucketed so forwards run a
bounded set of shapes; the first use of a shape key (which includes
building the CUDA kernels on a fresh checkout) is flagged
``_step_compiled`` and is not a JCT sample, as a jit compile is not in the
reference.

Prepacked batch formation (``max_pack_requests > 1``) and the DRAM offload
tier (``offload=True``) come with later slices and raise here.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.jct import LinearProxyJCT, PackedShapeJCT, Sample
from repro_torch.core.kv_policy import KVLifecycle, bucket as _bucket
from repro_torch.core.prefix_cache import PrefixCache, token_chain
from repro_torch.core.scheduler import Request, Scheduler
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import torch_dtype
from repro_torch.models.params import cast_params
from repro_torch.runtime.device import DeviceLike, resolve_device
from repro_torch.runtime.fault_tolerance import NaNGuard
from repro_torch.serving.tracing import BatchRecord, JCTCalibrationMonitor


@dataclasses.dataclass
class EngineConfig:
    policy: str = "srjf_calibrated"
    lam: float = 0.05                 # starvation offset (JCT-sec per wait-sec)
    block_size: int = 16
    cache_capacity_tokens: int = 4096  # prefix-KV budget (profile run output)
    kv_keep_tokens: int = 10**9        # suffix discard threshold (per request)
    suffix_buckets: Tuple[int, ...] = (64, 128, 256, 512, 1024, 2048)
    prefix_bucket_blocks: int = 4      # reuse granularity: 4 blocks = 64 tok
    max_pack_requests: int = 1         # >1 (prepacking) comes with the
                                       # packed-miss slice
    shape_pad_discount: float = 0.25   # unfitted-prior rent per padded slot,
                                       # as a fraction of the linear proxy's
                                       # per-computed-token rate
    offload: bool = False              # DRAM tier: comes with the offload
                                       # slice

    def __post_init__(self):
        if self.max_pack_requests > 1:
            raise NotImplementedError(
                "max_pack_requests > 1 (prepacked batch formation) comes with "
                "the packed-miss slice of the port; use 1")
        if self.offload:
            raise NotImplementedError(
                "offload=True (DRAM KV tier) comes with the offload slice of "
                "the port")


class PrefillOnlyEngine:
    """Single-instance engine over a dense model (real tensors on
    ``device``: ``"cuda"`` by default, ``"cpu"`` only when asked for)."""

    def __init__(self, cfg: ModelConfig, params: Dict,
                 ecfg: Optional[EngineConfig] = None,
                 device: DeviceLike = "cuda"):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r}: the port's engine runs dense models")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = cast_params(params, torch_dtype(cfg.dtype), self.device)
        self.ecfg = ecfg = EngineConfig() if ecfg is None else ecfg
        # Guards queue / cache / results / jct_model: a worker thread drives
        # step() while other threads submit, cancel, shed and probe; the
        # forward itself runs outside the lock.
        self.lock = threading.RLock()
        # KV keep/discard has ONE owner: every keep-budget / residency /
        # insert-bound decision in this file asks self.kv (kv_policy).
        self.kv = KVLifecycle(block_size=ecfg.block_size,
                              kv_keep_tokens=ecfg.kv_keep_tokens,
                              buckets=ecfg.suffix_buckets)
        self.cache = PrefixCache(ecfg.cache_capacity_tokens // ecfg.block_size,
                                 ecfg.block_size)
        self.jct_model = LinearProxyJCT()
        # shape-aware step pricing: the solo path prices its realized
        # (bucketed suffix, prefix) shape for BatchRecord.predicted_jct and
        # the in-flight prediction
        self.shape_jct = PackedShapeJCT(
            fallback=self.jct_model, pad_discount=ecfg.shape_pad_discount)
        # usable_prefix hook: Algorithm-1 scores price requests against the
        # prefix a forward would actually reuse, matching the hit-aware
        # predict_jct/pending_jct/shed probes — not the raw token match
        self.scheduler = Scheduler(ecfg.policy, self.jct_model, ecfg.lam,
                                   usable_prefix=self._usable_prefix_len)
        self.queue: List[Request] = []
        self.results: Dict[int, Dict] = {}
        # shape keys already run once (the reference's per-shape jit caches)
        self._fresh_keys: set = set()
        self._suffix_keys: set = set()
        self._last_step_ids: List[int] = []
        self._inflight: List[int] = []         # popped by step(), not yet in
                                               # results (crash accounting)
        self._inflight_pred = 0.0              # predicted cost of that batch
        self._inflight_t0 = 0.0                # and when it started
        self.steps = 0
        self.forwards = 0                      # model forwards run (profile
                                               # runs included)
        self.hit_tokens = 0
        self.total_tokens = 0
        self.padded_slots = 0                  # bucketed forward slots paid
        self._formed_cost = 0.0                # shape-priced cost of the step
        self._step_compiled = False            # step hit a fresh shape key
        # result validation: non-finite logits are flagged "corrupt" instead
        # of delivered; consecutive corruption advises a reload
        self.result_guard = NaNGuard(limit=3)
        self.nonfinite_results = 0
        self.batch_records: "deque[BatchRecord]" = deque(maxlen=256)
        self.jct_monitor = JCTCalibrationMonitor(
            self.jct_model, buckets=ecfg.suffix_buckets,
            shape_model=self.shape_jct)
        self._last_path: Tuple[str, Tuple] = ("", ())
        self._last_shape: Dict[str, int] = {}

    def _sync(self) -> None:
        """Wait for the device: timestamps must see compute, not launches."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- profile run (paper §3.1) ------------------------------------------
    def profile(self, lengths: Sequence[int] = (64, 128, 256, 512)) -> float:
        """Measure jct(n_input, 0) on this device, fit the linear proxy."""
        samples: List[Sample] = []
        rng = np.random.default_rng(0)
        for n in lengths:
            toks = rng.integers(0, self.cfg.vocab_size, size=n).tolist()
            self._run_fresh(toks)            # warm-up: exclude first use
            for _ in range(2):               # steady-state samples
                self._sync()
                t0 = time.perf_counter()
                self._run_fresh(toks)
                self._sync()
                samples.append((n, 0, time.perf_counter() - t0))
        self.jct_model.fit(samples)
        return self.jct_model.pearson_r

    # ---- request lifecycle ---------------------------------------------------
    def submit(self, tokens: Sequence[int],
               allowed_tokens: Optional[Sequence[int]] = None,
               user_id: Optional[str] = None, now: Optional[float] = None,
               deadline: Optional[float] = None,
               chain: Optional[Tuple[int, ...]] = None) -> int:
        now = time.perf_counter() if now is None else now
        r = Request(n_input=len(tokens), arrival=now,
                    chain=(token_chain(tokens, self.ecfg.block_size)
                           if chain is None else chain),
                    tokens=list(tokens), user_id=user_id,
                    allowed_tokens=tuple(allowed_tokens) if allowed_tokens else None,
                    deadline=deadline)
        with self.lock:
            r.n_cached_at_arrival = self.cache.probe_len(r.chain)
            self.queue.append(r)
        return r.req_id

    def cancel(self, req_id: int) -> Optional[Request]:
        """Remove a QUEUED request (no effect once executing). Returns the
        removed request, or None if it was not waiting here."""
        with self.lock:
            for i, r in enumerate(self.queue):
                if r.req_id == req_id:
                    return self.queue.pop(i)
        return None

    def shed_expired(self, now: Optional[float] = None) -> List[Request]:
        """Pop queued requests that cannot meet their deadline anymore:
        even starting RIGHT NOW, now + predicted JCT > deadline."""
        now = time.perf_counter() if now is None else now
        shed: List[Request] = []
        with self.lock:
            keep = []
            for r in self.queue:
                if r.deadline is not None and (
                        now + self.jct_model.predict(
                            r.n_input, self._usable_prefix_len(
                                r.n_input,
                                self.cache.probe_blocks(r.chain)))
                        > r.deadline):
                    shed.append(r)
                else:
                    keep.append(r)
            if shed:
                self.queue[:] = keep
        return shed

    def pending_jct(self, now: Optional[float] = None) -> float:
        """Predicted seconds of queued work PLUS the predicted remainder of
        the step executing right now — the backlog signal JCT-aware routing
        ranks instances by. Queued requests are priced against their
        ARRIVAL-time cache match bucketed to the prefix a forward would
        reuse (conservative: the cache only warms for a queued request's
        own prefix)."""
        now = time.perf_counter() if now is None else now
        bs = self.ecfg.block_size
        with self.lock:
            queued = sum(
                self.jct_model.predict(
                    r.n_input, self._usable_prefix_len(
                        r.n_input, r.n_cached_at_arrival // bs))
                for r in self.queue)
            running = 0.0
            if self._inflight:
                running = max(0.0, self._inflight_pred
                              - (now - self._inflight_t0))
            return queued + running

    def predict_jct(self, n_input: int, chain: Tuple[int, ...] = ()) -> float:
        """Predicted JCT of a PROSPECTIVE request given this instance's
        cache state, against the prefix the engine would actually reuse."""
        with self.lock:
            return self.jct_model.predict(
                n_input, self._usable_prefix_len(
                    n_input, self.cache.probe_blocks(chain)))

    def probe(self, n_input: int,
              chain: Tuple[int, ...] = ()) -> Tuple[float, float, int]:
        """``(pending_jct, predict_jct, cached_prefix_len)`` in ONE lock
        acquisition (one consistent cache/queue state)."""
        with self.lock:
            return (self.pending_jct(), self.predict_jct(n_input, chain),
                    self.cache.probe_len(chain))

    def step(self) -> Optional[int]:
        """One scheduling step: pick (Algorithm 1), prefill, cache, score.
        Returns the served request's id."""
        now = time.perf_counter()
        batch = self._form_batch(now)
        if batch is None:
            return None
        r = batch[0]
        r.start_time = now
        with self.lock:
            self._inflight = [r.req_id]
            self._inflight_pred = self._formed_cost
            self._inflight_t0 = now
        self._step_compiled = False
        padded0 = self.padded_slots
        logits = self._execute(r)
        # asynchronous launches: sync before timestamping, or the JCT model
        # observes launch latency instead of compute time
        self._sync()
        done = r.finish_time = time.perf_counter()
        with self.lock:
            self.results[r.req_id] = self._score(logits, r)
            # steps that ran a fresh shape (first use, kernel build) are NOT
            # JCT samples (profile() excludes them the same way)
            if not self._step_compiled:
                self.jct_model.observe(r.n_input, r.n_cached_at_start,
                                       r.finish_time - now)
        self.steps += 1
        self._last_step_ids = [r.req_id]
        self._record_step(r, now, done, padded0)
        with self.lock:
            self._inflight = []
            self._inflight_pred = 0.0
        return r.req_id

    def _record_step(self, r: Request, t0: float, t_done: float,
                     padded0: int) -> None:
        """Observability epilogue of step(): BatchRecord into the ring, JCT
        calibration sample (warm steps only)."""
        pred = self._inflight_pred
        computed = r.n_input - r.n_cached_at_start
        path, key = self._last_path
        shape = self._last_shape
        rec = BatchRecord(
            step=self.steps, ts=t_done, kind="solo", n_requests=1,
            req_ids=(r.req_id,), computed_tokens=computed,
            padded_tokens=self.padded_slots - padded0,
            S=shape.get("S", 0), pmax=shape.get("pmax", 0),
            jit_path=path, jit_key=key, compiled=self._step_compiled,
            predicted_jct=pred, wall=t_done - t0)
        self.batch_records.append(rec)
        if not self._step_compiled:
            self.jct_monitor.observe(pred, t_done - t0, computed, kind="solo")
            self.shape_jct.observe(computed, rec.S, rec.Nb, rec.smax,
                                   rec.pmax, rec.wall)

    # ---- batch formation -------------------------------------------------------
    def _usable_prefix_len(self, n_input: int, matched_blocks: int) -> int:
        """Bucketed prefix-reuse length given a raw cache match in blocks
        (granularity ``prefix_bucket_blocks``; >=1 fresh token guaranteed —
        the last token's logits must be computed)."""
        bs = self.ecfg.block_size
        gran = self.ecfg.prefix_bucket_blocks
        prefix_len = (matched_blocks // gran) * gran * bs
        if prefix_len >= n_input:
            prefix_len = max(0, ((n_input - 1) // (gran * bs)) * gran * bs)
        return prefix_len

    def _solo_cost(self, suffix: int, pref: int) -> float:
        """Shape-priced wall seconds of one solo step: S = bucketed suffix
        over an exact prefix buffer (the reference's one-row
        ``_pack_shape`` / ``_pack_cost``)."""
        S = _bucket(suffix, self.ecfg.suffix_buckets)
        return self.shape_jct.predict(suffix, S, 0, 0, pref,
                                      pad_slots=S - suffix)

    def _form_batch(self, now: float) -> Optional[List[Request]]:
        """Algorithm 1 pick: the scheduler's choice runs alone."""
        with self.lock:
            i = self.scheduler.pick(self.queue, self.cache, now)
            if i is None:
                return None
            r = self.queue.pop(i)
            pref = self._usable_prefix_len(r.n_input,
                                           self.cache.probe_blocks(r.chain))
            self._formed_cost = self._solo_cost(r.n_input - pref, pref)
            return [r]

    def run_until_drained(self) -> List[int]:
        """Serve until the queue is empty; returns the served ids in
        completion order."""
        done = []
        while self.queue:
            if self.step() is not None:
                done.extend(self._last_step_ids)
        return done

    # ---- execution -----------------------------------------------------------
    def _execute(self, r: Request) -> torch.Tensor:
        bs = self.ecfg.block_size
        # cache probe + pin under the lock; the forward itself runs outside
        # it so router/admission probes never block on compute
        with self.lock:
            matched = self.cache.match_blocks(r.chain, touch=True)
            prefix_len = self._usable_prefix_len(r.n_input, matched)
            use_blocks = prefix_len // bs
            r.n_cached_at_start = prefix_len
            self.hit_tokens += prefix_len
            self.total_tokens += r.n_input
            self.padded_slots += prefix_len + _bucket(
                r.n_input - prefix_len, self.ecfg.suffix_buckets)
            keep = self.kv.keep(r.n_input)
            # chain already resident past the keep bound: the insert below
            # would only re-slice and re-touch existing blocks — skip it
            resident = self.kv.resident(matched, r.n_input)
            if prefix_len:
                self.cache.pin(r.chain, use_blocks)
                payloads = self.cache.match_payloads(r.chain)[:use_blocks]
                pk = torch.cat([p[0] for p in payloads], dim=2)
                pv = torch.cat([p[1] for p in payloads], dim=2)
        if prefix_len == 0:
            logits, new_kv, n_new = self._run_fresh(r.tokens, keep)
            kv_from = 0
        else:
            logits, new_kv, n_new = self._run_suffix(
                r.tokens[prefix_len:], pk, pv, prefix_len, keep)
            kv_from = prefix_len
        # split fresh KV into block payloads and insert (suffix discard:
        # only up to ``keep`` tokens total). Each block is its own copy, so
        # an evicted block frees its memory rather than pinning the whole
        # kept-KV tensor it was sliced from.
        with self.lock:
            if prefix_len:
                self.cache.unpin(r.chain, use_blocks)
            if not resident:
                n_insertable = self.kv.insertable_tokens(keep, kv_from, n_new)
                n_blocks_new = n_insertable // bs
                payloads_all = self.cache.match_payloads(
                    r.chain)[:use_blocks]
                for b in range(n_blocks_new):
                    k_b = new_kv["k"][:, :, b * bs:(b + 1) * bs].clone()
                    v_b = new_kv["v"][:, :, b * bs:(b + 1) * bs].clone()
                    payloads_all.append((k_b, v_b))
                self.cache.insert(r.chain, kv_from + n_blocks_new * bs,
                                  now=time.perf_counter(),
                                  payloads=payloads_all)
        return logits

    def _tokens(self, tokens: Sequence[int], S: int):
        toks = torch.zeros((1, S), dtype=torch.long)
        toks[0, :len(tokens)] = torch.as_tensor(list(tokens), dtype=torch.long)
        last = torch.tensor([len(tokens) - 1], dtype=torch.long)
        return toks.to(self.device), last.to(self.device)

    def _run_fresh(self, tokens: Sequence[int], keep: int = 0):
        S = _bucket(len(tokens), self.ecfg.suffix_buckets)
        # shape-key bucketing of the keep budget is owned by KVLifecycle
        keep_pad = self.kv.keep_pad(keep, S)
        key = (S, keep_pad)
        self._last_path = ("fresh", key)
        self._last_shape = {"S": S}
        if key not in self._fresh_keys:
            self._step_compiled = True
            self._fresh_keys.add(key)
        toks, last = self._tokens(tokens, S)
        logits, kv = tfm.prefill(self.params, self.cfg, {"tokens": toks},
                                 kv_keep=keep_pad, last_index=last)
        self.forwards += 1
        if kv is None:
            return logits, {"k": None, "v": None}, 0
        # kv: (L, 1, keep_pad, KV, hd); valid fresh tokens = len(tokens),
        # usable budget = the caller's keep (keep_pad only pads the key)
        n_new = min(keep, keep_pad, len(tokens))
        return logits, kv, n_new

    def _run_suffix(self, tokens, pk, pv, prefix_len: int, keep: int):
        S = _bucket(len(tokens), self.ecfg.suffix_buckets)
        P = pk.shape[2]
        keep_new = self.kv.suffix_keep_new(keep, prefix_len, S)
        keep_pad = self.kv.keep_pad(keep_new, S)
        key = (S, P, keep_pad)
        self._last_path = ("suffix", key)
        self._last_shape = {"S": S, "pmax": P}
        if key not in self._suffix_keys:
            self._step_compiled = True
            self._suffix_keys.add(key)
        toks, last = self._tokens(tokens, S)
        logits, kv = tfm.prefill_with_prefix(
            self.params, self.cfg, {"tokens": toks}, {"k": pk, "v": pv},
            prefix_len=P, kv_keep=P + keep_pad, last_index=last)
        self.forwards += 1
        n_new = min(keep_new, len(tokens))
        return logits, kv, n_new

    # ---- output --------------------------------------------------------------
    def _score(self, logits: torch.Tensor, r: Request) -> Dict:
        """Constrained single-token output: renormalize over allowed ids
        (paper §2.3 — P(Yes)/P(No) without fine-tuning)."""
        out = {"req_id": r.req_id, "latency": r.latency,
               "n_cached": r.n_cached_at_start, "n_input": r.n_input,
               "deadline": r.deadline}
        logits = logits[0].double().cpu().numpy()
        # non-finite guard: constrained scoring needs every allowed logit
        # finite (renormalization); unconstrained argmax tolerates -inf
        # ("never this token") but not NaN or an all-non-finite row.
        if r.allowed_tokens:
            bad = not bool(np.isfinite(logits[list(r.allowed_tokens)]).all())
        else:
            bad = bool(np.isnan(logits).any()
                       or not np.isfinite(logits).any())
        if bad:
            self.nonfinite_results += 1
            self.result_guard.observe(float("nan"))
            out["corrupt"] = "nonfinite_logits"
            out["token"] = -1
            if r.allowed_tokens:
                out["scores"] = {}
            return out
        self.result_guard.observe(0.0)
        if r.allowed_tokens:
            sub = logits[list(r.allowed_tokens)]
            sub = np.exp(sub - sub.max())
            sub /= sub.sum()
            out["scores"] = {int(t): float(p)
                             for t, p in zip(r.allowed_tokens, sub)}
            out["token"] = int(r.allowed_tokens[int(np.argmax(sub))])
        else:
            out["token"] = int(np.argmax(logits))
        return out

    def stats(self) -> Dict:
        return {
            "steps": self.steps,
            "forwards": self.forwards,
            "hit_rate": self.hit_tokens / max(1, self.total_tokens),
            "nonfinite_results": self.nonfinite_results,
            # fraction of paid forward slots that were padding/cache slack
            "padding_waste": 1.0 - (self.total_tokens
                                    / max(1, self.padded_slots)),
            "cache": self.cache.stats(),
            "jct": self.jct_monitor.summary(),
        }
