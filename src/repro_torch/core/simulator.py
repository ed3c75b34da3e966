"""Discrete-event simulator: the SAME scheduler + prefix-cache code as the
real engine, driven by an analytic JCT cost model instead of real forwards.

Copy of ``repro.core.simulator`` over the port's ``Scheduler`` and
``PrefixCache``, priced on the chip the caller passes (no default). This is
how the paper's QPS-latency curves (Fig 6/7/9/11) are reproduced without
running the forwards: engine variants differ only in their cost model
parameters (attention-efficiency penalty, TP comm term, PP bubble factor),
their MIL (infeasible requests are rejected — Table 2's ✗), their prefix
cache capacity, and their scheduling policy. ``jct_model`` (the port's
addition) replaces the roofline built from ``efficiency`` with one the
caller calibrated on a card (``core.jct.fit_roofline``).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.jct import RooflineJCT, tp_comm_bytes_per_token
from repro_torch.core.kv_policy import MemoryModel
from repro_torch.core.prefix_cache import PrefixCache
from repro_torch.core.scheduler import Request, Scheduler
from repro_torch.runtime.hw import ChipSpec


@dataclasses.dataclass
class EngineSpec:
    """One serving configuration (PrefillOnly or a baseline)."""
    name: str
    policy: str                     # fifo | srjf | srjf_calibrated
    lam: float = 0.0
    chips_per_instance: int = 1
    attn_efficiency: float = 1.0    # chunked prefill kernel penalty
    tp: int = 1                     # adds all-reduce comm to JCT
    pp: int = 1                     # adds bubble factor to JCT
    technique: str = "hybrid"       # memory-model row for MIL + cache budget
    prefix_caching: bool = True
    kv_budget_override: Optional[int] = None  # tokens of prefix cache / inst.


def paper_engines(block: int = 16) -> List[EngineSpec]:
    """The paper's §7 lineup."""
    return [
        EngineSpec("prefillonly", "srjf_calibrated", lam=0.05,
                   technique="hybrid"),
        EngineSpec("paged_fcfs", "fifo", technique="paged"),
        EngineSpec("chunked_prefill", "fifo", technique="chunked",
                   attn_efficiency=0.86),   # paper §2.5: −14% e2e throughput
        EngineSpec("tensor_parallel", "fifo", technique="tp",
                   chips_per_instance=2, tp=2),
        EngineSpec("pipeline_parallel", "fifo", technique="pp",
                   chips_per_instance=2, pp=2),
    ]


@dataclasses.dataclass
class SimResult:
    name: str
    qps: float
    completed: int
    rejected: int
    mean_latency: float
    p50_latency: float
    p99_latency: float
    throughput: float               # completed requests / makespan
    hit_rate: float
    mil: int

    def row(self) -> Dict:
        return dataclasses.asdict(self)


class _Instance:
    def __init__(self, idx: int, spec: EngineSpec, jct_model,
                 scheduler: Scheduler, cache_blocks: int, block_size: int):
        self.idx = idx
        self.spec = spec
        self.jct = jct_model
        self.scheduler = scheduler
        self.cache = PrefixCache(cache_blocks if spec.prefix_caching else 0,
                                 block_size)
        self.queue: List[Request] = []
        # PP pipelines `pp` requests concurrently (one per stage)
        self.slots = max(1, spec.pp)
        self.in_flight = 0
        self.hit_tokens = 0
        self.total_tokens = 0

    def start_next(self, now: float) -> Optional[Request]:
        if self.in_flight >= self.slots:
            return None
        i = self.scheduler.pick(self.queue, self.cache, now)
        if i is None:
            return None
        self.in_flight += 1
        r = self.queue.pop(i)
        n_cached = self.cache.match_len(r.chain, now, touch=True)
        n_cached = min(n_cached, r.n_input)
        jct = self.jct.predict(r.n_input, n_cached)
        if self.spec.pp > 1:
            # bubble: stage imbalance across variable-length requests
            jct *= 1.0 + 0.5 * (self.spec.pp - 1) / self.spec.pp
        r.start_time = now
        r.n_cached_at_start = n_cached
        r.finish_time = now + jct
        self.hit_tokens += n_cached
        self.total_tokens += r.n_input
        # pin matched blocks for the duration, insert the new prefix KV
        self.cache.pin(r.chain, n_cached // self.cache.block_size)
        return r

    def finish(self, r: Request, now: float):
        self.in_flight -= 1
        self.cache.unpin(r.chain, r.n_cached_at_start // self.cache.block_size)
        # PrefillOnly: insert prefix KV up to budget (suffix discarded);
        # baselines keep all KV anyway — cache capacity enforces the budget.
        self.cache.insert(r.chain, r.n_input, now)


class Simulator:
    def __init__(self, cfg: ModelConfig, spec: EngineSpec, *,
                 total_chips: int = 2, chip: ChipSpec,
                 block_size: int = 16, efficiency: float = 0.55,
                 hybrid_chunk: int = 2048, weight_bytes_per_param: float = 2.0,
                 user_mil: int = 32_768,
                 jct_model: Optional[RooflineJCT] = None):
        """``user_mil`` is the paper's §3.1 profile-run input: the maximum
        request length the deployment must handle. Every engine reserves its
        peak working set at min(user_mil, own MIL); leftover HBM becomes the
        prefix cache. ``jct_model``, when given, prices every request in
        place of the roofline built from ``efficiency``."""
        self.cfg = cfg
        self.spec = spec
        self.chip = chip
        self.block_size = block_size
        k = max(spec.tp, spec.pp)
        mem = MemoryModel(cfg, chip,
                          weight_bytes_per_param=weight_bytes_per_param)
        self.mil = mem.max_input_length(spec.technique, chunk=hybrid_chunk, k=k)
        if spec.kv_budget_override is not None:
            kv_tokens = spec.kv_budget_override
        else:
            reserve_at = min(user_mil, self.mil)
            free_per_chip = (mem.budget_bytes()
                             - mem.peak_bytes(reserve_at, spec.technique,
                                              chunk=hybrid_chunk, k=k))
            kv_tokens = max(0, int(free_per_chip / max(mem.kv_all_per_token, 1)))
            # parallelism shards the prefix cache across k chips (paper Fig 9:
            # "parallelize the prefix caches across GPUs")
            kv_tokens *= k
        self.cache_blocks = kv_tokens // block_size
        self.n_instances = max(1, total_chips // spec.chips_per_instance)
        if jct_model is None:
            jct_model = RooflineJCT(
                cfg, chips=spec.tp, chip=chip, efficiency=efficiency,
                attn_efficiency=spec.attn_efficiency,
                comm_bytes_per_token=tp_comm_bytes_per_token(cfg, spec.tp),
                weight_bytes_per_param=weight_bytes_per_param)
        self.jct_model = jct_model
        self.scheduler = Scheduler(spec.policy, jct_model, spec.lam)

    def run(self, requests: List[Request], qps: float) -> SimResult:
        insts = [_Instance(i, self.spec, self.jct_model, self.scheduler,
                           self.cache_blocks, self.block_size)
                 for i in range(self.n_instances)]
        # user-id routing, round-robin over first appearance (paper §7.1)
        user_map: Dict[str, int] = {}
        completed: List[Request] = []
        rejected = 0

        events: List = []           # (time, seq, kind, payload)
        seq = 0
        for r in requests:
            heapq.heappush(events, (r.arrival, seq, "arrive", r))
            seq += 1

        while events:
            now, _, kind, payload = heapq.heappop(events)
            if kind == "arrive":
                r: Request = payload
                if r.n_input > self.mil:
                    rejected += 1
                    continue
                uid = r.user_id or str(r.req_id)
                if uid not in user_map:
                    user_map[uid] = len(user_map) % self.n_instances
                inst = insts[user_map[uid]]
                r.n_cached_at_arrival = inst.cache.match_len(r.chain)
                inst.queue.append(r)
                started = inst.start_next(now)
                if started is not None:
                    heapq.heappush(events, (started.finish_time, seq,
                                            "finish", (inst, started)))
                    seq += 1
            else:
                inst, r = payload
                inst.finish(r, now)
                completed.append(r)
                started = inst.start_next(now)
                if started is not None:
                    heapq.heappush(events, (started.finish_time, seq,
                                            "finish", (inst, started)))
                    seq += 1

        lats = np.array([r.latency for r in completed]) if completed else np.array([0.0])
        makespan = (max(r.finish_time for r in completed)
                    - min(r.arrival for r in completed)) if completed else 1.0
        hit = sum(i.hit_tokens for i in insts)
        tot = max(1, sum(i.total_tokens for i in insts))
        return SimResult(
            name=self.spec.name, qps=qps, completed=len(completed),
            rejected=rejected, mean_latency=float(lats.mean()),
            p50_latency=float(np.percentile(lats, 50)),
            p99_latency=float(np.percentile(lats, 99)),
            throughput=len(completed) / max(makespan, 1e-9),
            hit_rate=hit / tot, mil=self.mil)
