"""Async serving subsystem: JCT-aware routing, admission control, telemetry
(the port of ``repro.serving``, thread mode).

The deployment shape of paper §7.1 — N single-copy PrefillOnly instances
behind a router — as a first-class layer:

  server.AsyncServer      worker thread per engine, submit() -> Future,
                          deadlines + cancellation, drain/shutdown, health
  router                  user-hash rendezvous | JCT-aware least-backlog
                          with cache-affinity tie-break
  admission               MIL + deadline feasibility -> typed Rejected
  metrics                 counters / gauges / fixed-bucket histograms,
                          per-instance and global, text dump, Prometheus
  tracing                 request timelines (SpanTracer), per-step records,
                          JCT calibration
  chaos                   seeded deterministic fault injection (step crash,
                          hang, straggler, NaN corruption, submit failure)
  robustness              idempotent retry (RetryPolicy), JCT-deadline
                          watchdog, brownout ladder (BrownoutController)

The cross-process plane (worker processes behind an RPC boundary, their
supervisor, and the process-level fault injectors) is not ported yet.
"""
from repro_torch.serving.admission import (AdmissionController,    # noqa: F401
                                           BrownoutController, Rejected)
from repro_torch.serving.chaos import (ChaosConfig, ChaosEngine,   # noqa: F401
                                       FaultPlan, InjectedFault, wrap_pool)
from repro_torch.serving.metrics import (Counter, Gauge,           # noqa: F401
                                         Histogram, MetricsRegistry,
                                         StateGauge)
from repro_torch.serving.router import (LeastBacklogRouter,        # noqa: F401
                                        UserHashRouter, get_router)
from repro_torch.serving.server import AsyncServer, RetryPolicy    # noqa: F401
from repro_torch.serving.tracing import (BatchRecord,              # noqa: F401
                                         JCTCalibrationMonitor, SpanTracer)
