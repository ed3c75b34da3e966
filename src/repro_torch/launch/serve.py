"""Serving driver: async PrefillOnly instance pool + trace replay (the port of
``repro.launch.serve``, thread mode).

The paper's deployment shape (§7.1): N single-model-copy engine instances
behind a router, each running Algorithm-1 scheduling with continuous JCT
calibration and suffix-KV discard. An ``AsyncServer`` runs one worker
thread per engine, the submitting thread replays the trace open-loop in
real time (sleep to each arrival, submit, move on), and every request
resolves through a ``Future`` to either a scored result or a typed
``Rejected``.

Routing is pluggable (``--router user_hash`` is the paper's rendezvous user
hash; ``--router least_backlog`` routes on predicted-JCT backlog with
cache-affinity tie-break). Admission control (MIL + deadline feasibility)
and in-queue deadline shedding are on by default when ``--deadline`` is
given.

The instances run on the card (``device="cuda"``, the default) and share
one set of weights; several engines on one card take turns under
``core/compiled.py``'s ``device_lock``. ``device="cpu"`` runs the plain
versions (the tests). Process mode (``workers > 0``: engine worker
processes behind an RPC boundary) is not ported yet and raises.

    python -m repro_torch.launch.serve --full --profile --qps 4
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.core.engine import EngineConfig, PrefillOnlyEngine
from repro_torch.core.kv_policy import MemoryModel
from repro_torch.data.workloads import get_trace
from repro_torch.models.layers import torch_dtype
from repro_torch.models.params import (_leaves, cast_params, init_params,
                                      params_from_numpy)
from repro_torch.runtime.device import DeviceLike, resolve_device
from repro_torch.runtime.hw import ChipSpec, H100_SXM
from repro_torch.runtime.fault_tolerance import (InstancePool,
                                                 JCTDeadlineWatchdog,
                                                 PreemptionHandler)
from repro_torch.serving import (AdmissionController, AsyncServer,
                                 BrownoutController, ChaosConfig, FaultPlan,
                                 Rejected, RetryPolicy, SpanTracer,
                                 get_router, wrap_pool)

PROCESS_MODE = ("process mode (workers > 0: engine worker processes behind "
                "an RPC boundary) is not ported yet (ROADMAP A5b); use "
                "thread mode (workers=0) with n_instances engines")
YES_NO = (5, 9)


def make_pool(arch: str, n_instances: int = 2, *, reduced: bool = True,
              policy: str = "srjf_calibrated", lam: float = 0.05,
              cache_tokens: int = 4096, seed: int = 0,
              profile: bool = False, offload: bool = False,
              host_cache_mb: int = 256,
              profile_lengths=(32, 64, 128),
              device: DeviceLike = "cuda", params: Optional[Dict] = None,
              ecfg: Optional[Dict] = None) -> InstancePool:
    """Build N engine instances over ONE set of weights on ``device``.

    The weights are drawn by ``init_params`` from a ``torch.Generator``
    seeded with ``seed``, or taken from ``params``: the reference's tree as
    numpy arrays (bridged by ``params_from_numpy``), or the port's tree of
    tensors (cast to the config's dtype on ``device``, which copies
    nothing where they already are). Every instance reads the same
    tensors. ``profile=True`` runs the paper's profile step per instance:
    fits the JCT linear proxy on measured forwards and auto-tunes the
    prepacking budget from the fitted curve. ``offload=True`` gives every
    instance the DRAM KV tier (``host_cache_mb`` per instance). ``ecfg``
    overrides any other ``EngineConfig`` field (``cache_capacity_tokens``,
    ``graph_memory_bytes``, ``host_cache_bytes``, ...), which full-width
    instances on the card need sized for their trace.
    """
    cfg = get_config(arch)
    if reduced:
        cfg = reduce_config(cfg, hybrid_chunk=0)
    dev = resolve_device(device)
    if params is None:
        params = init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    elif isinstance(next(_leaves(params))[1], torch.Tensor):
        params = cast_params(params, torch_dtype(cfg.dtype), dev)
    else:
        params = params_from_numpy(params, cfg, device=dev)
    fields = dict(policy=policy, lam=lam, cache_capacity_tokens=cache_tokens,
                  offload=offload, host_cache_bytes=host_cache_mb << 20)
    fields.update(ecfg or {})

    def make_engine(name: str) -> PrefillOnlyEngine:
        eng = PrefillOnlyEngine(cfg, params, EngineConfig(**fields),
                                device=dev)
        if profile:
            eng.profile(profile_lengths)
        return eng

    pool = InstancePool(make_engine)
    pool.scale_to([f"inst{i}" for i in range(n_instances)])
    return pool


def warm_pool(pool: InstancePool, token_lists: Sequence[Sequence[int]],
              vocab: int) -> int:
    """Run every shape key a solo replay of ``token_lists`` reaches on every
    instance before the replay, so that its steps replay graphs instead of
    capturing them: each list, with every token id moved by one (the same
    lengths and prefix sharing, chains no request shares), is served alone
    in order. Returns the steps run. The warm-up's blocks stay in each
    cache as the least recently used."""
    steps = 0
    for eng in pool.engines.values():
        for toks in token_lists:
            eng.submit([(t + 1) % vocab for t in toks],
                       allowed_tokens=YES_NO)
            steps += len(eng.run_until_drained())
    return steps


def instance_chip(pool: InstancePool) -> ChipSpec:
    """The H100 as admission sees it from one of the pool's N instances,
    which share the card and one set of weights: the weights, one N-th of
    the rest of the card, less what the instance holds between steps at
    most (its prefix cache at ``cache_capacity_tokens`` and its compiled
    forwards at ``graph_memory_bytes``). The MIL priced on it fits while
    every instance runs such a request at once; with one instance and
    nothing held it is ``H100_SXM``."""
    engines = list(pool.engines.values())
    mm = MemoryModel(engines[0].cfg, H100_SXM)
    held = max(e.ecfg.cache_capacity_tokens * mm.kv_all_per_token
               + e.ecfg.graph_memory_bytes for e in engines)
    w = mm.weights_bytes
    return dataclasses.replace(
        H100_SXM, hbm_bytes=w + (H100_SXM.hbm_bytes - w) / len(engines)
        - held)


def start_metrics_server(registry, port: int = 0, host: str = "127.0.0.1",
                         tracer=None) -> ThreadingHTTPServer:
    """Plain-HTTP observability endpoint over a ``MetricsRegistry`` (and,
    when a ``SpanTracer`` is given, its trace rings).

    GET /metrics           Prometheus text exposition
    GET /trace             finished request timelines + batch records, JSONL
    GET /trace.chrome.json Chrome-trace JSON (open in Perfetto / about:tracing)

    Anything else is 404. Runs in a daemon thread; ``port=0`` binds an
    ephemeral port (read it back from ``server.server_address``). Call
    ``server.shutdown()`` to stop.
    """

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):                          # noqa: N802 (stdlib API)
            path = self.path.rstrip("/")
            if path in ("", "/metrics"):
                body = registry.render_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/trace" and tracer is not None:
                body = tracer.dump_jsonl().encode()
                ctype = "application/x-ndjson; charset=utf-8"
            elif path == "/trace.chrome.json" and tracer is not None:
                body = json.dumps(tracer.chrome_trace()).encode()
                ctype = "application/json; charset=utf-8"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):                 # keep stdout clean
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="metrics-http").start()
    return server


def write_trace_dump(tracer, path) -> Path:
    """Write the JSONL dump to ``path`` plus the Chrome-trace JSON next to
    it (``<stem>.chrome.json``). Returns the chrome-trace path."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(tracer.dump_jsonl())
    cp = p.with_suffix(".chrome.json")
    cp.write_text(json.dumps(tracer.chrome_trace()))
    return cp


def serve_trace(arch: str = "qwen1.5-0.5b",
                trace_name: str = "post_recommendation",
                qps: float = 5.0, n_instances: int = 2, workers: int = 0,
                scale_tokens: float = 0.02, policy: str = "srjf_calibrated",
                lam: float = 0.05, seed: int = 0,
                max_requests: Optional[int] = None,
                router: str = "least_backlog",
                deadline: Optional[float] = None,
                admission: bool = True,
                max_input_tokens: Optional[int] = None,
                profile: bool = False,
                pool: Optional[InstancePool] = None,
                trace_kw: Optional[Dict] = None,
                metrics_port: Optional[int] = None,
                retry_budget: int = 2,
                watchdog: bool = True,
                watchdog_factor: float = 4.0,
                watchdog_min_deadline: float = 1.0,
                brownout: bool = False,
                chaos: Optional[ChaosConfig] = None,
                drain_timeout: Optional[float] = 30.0,
                trace_dump: Optional[str] = None,
                trace_capacity: int = 4096,
                offload: bool = False,
                host_cache_mb: int = 256,
                cache_tokens: int = 4096,
                reduced: bool = True,
                device: DeviceLike = "cuda",
                ecfg: Optional[Dict] = None,
                warm: bool = False) -> Dict:
    """Replay a paper workload through the AsyncServer. Returns latency
    stats over SERVED requests plus rejection counts and a telemetry dump.

    ``deadline`` is seconds after each request's arrival; with
    ``admission=True`` doomed requests are rejected/shed instead of blowing
    out the tail. ``pool=None`` builds a fresh pool (``make_pool`` with
    ``reduced``, ``device`` and ``ecfg``; pass one to reuse
    warmed engines across runs). ``warm=True`` runs ``warm_pool`` over the
    trace first. ``metrics_port`` starts a plain-HTTP Prometheus scrape
    endpoint (GET /metrics) for the duration of the replay; 0 picks an
    ephemeral port. Admission prices the MIL on each instance's share of
    the card (``instance_chip``). The result's ``server`` is the stopped
    ``AsyncServer``, with its registry and tracer.

    Robustness: the JCT-deadline watchdog and idempotent retry are ON by
    default (``watchdog=False`` / ``retry_budget=0`` disable); ``brownout``
    arms the graceful-degradation ladder; ``chaos`` wraps the pool in the
    seeded fault injector (``serving.chaos``, the step/submit kinds).
    SIGTERM/SIGINT during the replay (when called from the main thread)
    stops submitting and drains in-flight work for up to ``drain_timeout``
    seconds instead of dying mid-batch.

    ``workers`` > 0 (process mode) raises ``NotImplementedError``.
    """
    if workers:
        raise NotImplementedError(PROCESS_MODE)
    plan = FaultPlan(chaos) if chaos is not None else None
    if pool is None:
        pool = make_pool(arch, n_instances, reduced=reduced, policy=policy,
                         lam=lam, seed=seed, profile=profile,
                         offload=offload, host_cache_mb=host_cache_mb,
                         cache_tokens=cache_tokens, device=device,
                         ecfg=ecfg)
    # the reference's token range: min(512, the published vocab)
    vocab = min(512, get_config(arch).vocab_size)
    trace = get_trace(trace_name, qps, scale_tokens=scale_tokens,
                      materialize_tokens=True, vocab=vocab, seed=seed,
                      **(trace_kw or {}))
    requests = (trace.requests[:max_requests] if max_requests
                else trace.requests)
    if warm:
        warm_pool(pool, [r.tokens for r in requests], vocab)
    if plan is not None:
        wrap_pool(pool, plan)
    ctrl = None
    if admission:
        # MIL from the engines' own model config unless given explicitly —
        # the same closed form the profile run sizes the KV budget with,
        # priced for each instance's share of the card the port serves on
        any_eng = next(iter(pool.engines.values()))
        # price the engines' actual KV lifecycle into the MIL gate: finite
        # kv_keep means peak-layer suffix footprint, not all-layers
        kv_keep = getattr(getattr(any_eng, "ecfg", None),
                          "kv_keep_tokens", None)
        if kv_keep is not None and kv_keep >= 10**9:
            kv_keep = None
        ctrl = AdmissionController(max_input_tokens=max_input_tokens,
                                   memory_model=MemoryModel(
                                       any_eng.cfg, instance_chip(pool)),
                                   kv_keep=kv_keep)
    # always-on request-lifecycle tracing: the ring bounds memory and the
    # per-event cost is one lock + list append, so the replay always
    # records full timelines; trace_dump / the /trace endpoint export them
    tracer = SpanTracer(capacity=trace_capacity)
    server = AsyncServer(
        pool, router=get_router(router), admission=ctrl,
        retry=RetryPolicy(budget=retry_budget),
        watchdog=(JCTDeadlineWatchdog(factor=watchdog_factor,
                                      min_deadline=watchdog_min_deadline)
                  if watchdog else None),
        brownout=BrownoutController() if brownout else None,
        tracer=tracer)
    server.start()
    exporter = None
    # SIGTERM/SIGINT -> drain instead of dying mid-batch
    handler = PreemptionHandler().install()
    if metrics_port is not None:
        exporter = start_metrics_server(server.metrics, metrics_port,
                                        tracer=tracer)
        print(f"metrics: http://{exporter.server_address[0]}:"
              f"{exporter.server_address[1]}/metrics  "
              f"(+ /trace, /trace.chrome.json)", flush=True)
    try:
        out = _replay(server, requests, deadline, pool,
                      stop=lambda: handler.requested,
                      drain_timeout=drain_timeout)
        if plan is not None:
            out["faults_injected"] = plan.counts()
        if trace_dump:
            cp = write_trace_dump(tracer, trace_dump)
            print(f"trace dump: {trace_dump} + {cp}")
        return out
    finally:
        handler.uninstall()
        # shutdown() stops serve_forever; server_close() releases the bound
        # socket — without it a second serve_trace on the same port (the
        # warmed-pool reuse pattern) dies with EADDRINUSE
        if exporter is not None:
            exporter.shutdown()
            exporter.server_close()


def _replay(server, requests, deadline, pool, stop=None,
            drain_timeout=None) -> Dict:
    t0 = time.perf_counter()
    futures = []
    preempted = False
    for r in requests:                      # open loop: real-time arrivals
        # sleep to the arrival in short slices so a SIGTERM mid-gap stops
        # the replay within ~100ms, not after the longest arrival gap
        while True:
            if stop is not None and stop():
                preempted = True
                break
            delay = t0 + r.arrival - time.perf_counter()
            if delay <= 0:
                break
            time.sleep(min(delay, 0.1))
        if preempted:
            break
        futures.append(server.submit(
            r.user_id, r.tokens, allowed_tokens=YES_NO,
            deadline=(t0 + r.arrival + deadline) if deadline else None))
    server.drain(timeout=drain_timeout)
    wall = time.perf_counter() - t0
    # if the drain timed out, shutdown resolves the stragglers Rejected
    # ("shutdown") — a preempted/overloaded replay still resolves every
    # future before reporting
    server.shutdown(drain=True, timeout=1.0 if drain_timeout else None)

    outcomes = [f.result() for f in futures]
    served = [o for o in outcomes if not isinstance(o, Rejected)]
    rejected = [o for o in outcomes if isinstance(o, Rejected)]
    # no fabricated samples: a fully-shed run reports NaN latency, not a
    # vacuous 0.0 that would read as a perfect tail
    lats = np.array([o["latency"] for o in served]) if served \
        else np.array([np.nan])
    hit = sum(o["n_cached"] for o in served)
    tot = sum(o["n_input"] for o in served)
    reasons: Dict[str, int] = {}
    for o in rejected:
        reasons[o.reason] = reasons.get(o.reason, 0) + 1
    return {
        "requests": len(outcomes),
        "served": len(served),
        "rejected": len(rejected),
        "reject_reasons": reasons,
        "preempted": preempted,
        "retried": server.metrics.total("requests_retried"),
        "watchdog_trips": server.metrics.total("watchdog_trips"),
        "wall_seconds": wall,
        "throughput_rps": len(served) / wall,
        "mean_latency": float(lats.mean()),
        "p50_latency": float(np.percentile(lats, 50)),
        "p99_latency": float(np.percentile(lats, 99)),
        "token_hit_rate": hit / max(tot, 1),
        # JCT-calibration fit per instance: coefficients, residual p50/p95,
        # refit counts — readable from results without scraping Prometheus
        "jct_fit": {n: e.stats().get("jct")
                    for n, e in pool.engines.items()},
        "trace": (server.tracer.stats()
                  if server.tracer is not None else None),
        "metrics": server.metrics.render(),
        "per_instance": {n: e.stats() for n, e in pool.engines.items()},
        # each submitted request's result dict or Rejected, in trace order
        "outcomes": outcomes,
        # the stopped server: its registry and tracer for later reads
        "server": server,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--trace", default="post_recommendation")
    ap.add_argument("--qps", type=float, default=5.0)
    ap.add_argument("--instances", type=int, default=2)
    ap.add_argument("--workers", type=int, default=0, metavar="N",
                    help="process mode; not ported yet (raises unless 0)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--full", action="store_true",
                    help="the architecture at its published widths (default:"
                         " the reduced config)")
    ap.add_argument("--policy", default="srjf_calibrated",
                    choices=["fifo", "srjf", "srjf_calibrated"])
    ap.add_argument("--router", default="least_backlog",
                    choices=["user_hash", "least_backlog"])
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline, seconds after arrival")
    ap.add_argument("--no-admission", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="run the JCT profile fit per instance first")
    ap.add_argument("--warm", action="store_true",
                    help="run every solo shape key of the trace on every "
                         "instance before the replay")
    ap.add_argument("--lam", type=float, default=0.05)
    ap.add_argument("--scale-tokens", type=float, default=0.02)
    ap.add_argument("--max-requests", type=int, default=60)
    ap.add_argument("--dump-metrics", action="store_true")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus text metrics on this port "
                         "(GET /metrics, /trace, /trace.chrome.json) "
                         "during the replay; 0 = ephemeral")
    ap.add_argument("--trace-dump", default=None, metavar="PATH",
                    help="write request/batch timelines as JSONL to PATH "
                         "(+ PATH stem .chrome.json for Perfetto) on exit")
    ap.add_argument("--retry-budget", type=int, default=2,
                    help="idempotent re-submissions per lost request "
                         "(0 disables retry)")
    ap.add_argument("--no-watchdog", action="store_true",
                    help="disable the JCT-deadline hang watchdog")
    ap.add_argument("--watchdog-factor", type=float, default=4.0,
                    help="trip when an in-flight batch exceeds this "
                         "multiple of its predicted JCT")
    ap.add_argument("--watchdog-min-deadline", type=float, default=1.0,
                    help="absolute floor on the per-batch deadline, sec")
    ap.add_argument("--brownout", action="store_true",
                    help="arm the graceful-degradation ladder")
    ap.add_argument("--offload", action="store_true",
                    help="DRAM KV tier: evicted prefix blocks demote to "
                         "host memory and restore (or router-prefetch) "
                         "instead of recomputing")
    ap.add_argument("--host-cache-mb", type=int, default=256,
                    help="DRAM tier capacity per instance, MiB")
    ap.add_argument("--cache-tokens", type=int, default=4096,
                    help="device prefix-KV cache capacity per instance, "
                         "tokens")
    ap.add_argument("--graph-memory-mb", type=int, default=None,
                    help="device memory the compiled forwards of one "
                         "instance may hold, MiB (default: EngineConfig's)")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    help="max seconds to drain on completion or SIGTERM")
    chaos = ap.add_argument_group(
        "chaos", "seeded fault injection (any rate > 0 wraps the pool)")
    chaos.add_argument("--chaos-seed", type=int, default=0)
    chaos.add_argument("--chaos-step-error", type=float, default=0.0,
                       help="P(step crashes after the forward, results lost)")
    chaos.add_argument("--chaos-hang", type=float, default=0.0,
                       help="P(step hangs past the watchdog deadline)")
    chaos.add_argument("--chaos-hang-seconds", type=float, default=1.0)
    chaos.add_argument("--chaos-straggler", type=float, default=0.0,
                       help="P(step dawdles below the watchdog deadline)")
    chaos.add_argument("--chaos-straggler-seconds", type=float, default=0.1)
    chaos.add_argument("--chaos-nan", type=float, default=0.0,
                       help="P(step results corrupted to non-finite scores)")
    chaos.add_argument("--chaos-submit-error", type=float, default=0.0,
                       help="P(submit raises transiently)")
    chaos.add_argument("--chaos-max-faults", type=int, default=None,
                       help="total fault budget across the run")
    args = ap.parse_args()
    if args.workers:
        ap.error(PROCESS_MODE)
    chaos_cfg = None
    if any(r > 0 for r in (args.chaos_step_error, args.chaos_hang,
                           args.chaos_straggler, args.chaos_nan,
                           args.chaos_submit_error)):
        chaos_cfg = ChaosConfig(
            seed=args.chaos_seed, step_error=args.chaos_step_error,
            hang=args.chaos_hang, hang_seconds=args.chaos_hang_seconds,
            straggler=args.chaos_straggler,
            straggler_seconds=args.chaos_straggler_seconds,
            nan_score=args.chaos_nan,
            submit_error=args.chaos_submit_error,
            max_faults=args.chaos_max_faults)
    ecfg = ({"graph_memory_bytes": args.graph_memory_mb << 20}
            if args.graph_memory_mb is not None else None)
    out = serve_trace(args.arch, args.trace, qps=args.qps,
                      n_instances=args.instances, workers=args.workers,
                      policy=args.policy,
                      lam=args.lam, scale_tokens=args.scale_tokens,
                      max_requests=args.max_requests, router=args.router,
                      deadline=args.deadline,
                      admission=not args.no_admission, profile=args.profile,
                      metrics_port=args.metrics_port,
                      retry_budget=args.retry_budget,
                      watchdog=not args.no_watchdog,
                      watchdog_factor=args.watchdog_factor,
                      watchdog_min_deadline=args.watchdog_min_deadline,
                      brownout=args.brownout, chaos=chaos_cfg,
                      drain_timeout=args.drain_timeout,
                      trace_dump=args.trace_dump,
                      offload=args.offload,
                      host_cache_mb=args.host_cache_mb,
                      cache_tokens=args.cache_tokens,
                      reduced=not args.full, device=args.device, ecfg=ecfg,
                      warm=args.warm)
    for k, v in out.items():
        if k == "metrics":
            if args.dump_metrics:
                print("--- metrics ---")
                print(v)
        elif k not in ("per_instance", "jct_fit", "outcomes", "server"):
            print(f"{k}: {v}")
    for n, fit in sorted((out.get("jct_fit") or {}).items()):
        if fit:
            print(f"jct_fit[{n}]: a={fit['a']:.3g} b={fit['b']:.3g} "
                  f"r={fit['pearson_r']:.3f} "
                  f"resid_p50={fit['residual_p50']:.4f} "
                  f"resid_p95={fit['residual_p95']:.4f} "
                  f"refits={fit['refits']}+{fit['drift_refits']}")


if __name__ == "__main__":
    main()
