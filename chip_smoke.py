#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py [--seed N]

(``--seed``, default 0, draws every weight and input from another seed.)
It builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
then runs phases 2-10 below for each model of ``SPECS``: qwen1.5-0.5b, then
granite-3-8b at full width (40 layers, d_model 4096, GQA 32/8, head_dim
128, d_ff 12,800; qwen's weights, engines and decode cache are freed
first), each at its own widths and shapes (``Spec``: a model's extra
attention and decode cases of phase 2, and whether it runs the order and
graph memory checks of phase 6, are fields of it; qwen has them, granite
not), and where a width rule refuses f32 at granite's widths phase 2
checks that the refusal names its rule. It raises on the first failure:

  1. prints the card (``nvidia-smi`` name and power limit) and build time;
  2. holds each kernel against its plain PyTorch version on the card at
     the main path's shapes, in bf16 (the tensor-core kernels) and once in
     f32 (the CUDA-core kernels), and times kernel, plain version and one
     library call used only as a yardstick: RMSNorm at every T of the main
     path (a decode step's batch, 128, 512, 1024, 2048) with its launch
     plan; the fused MLP at T = 16, 128, 512 and 2048; flash attention in
     its three modes: dense (causal S = 512 and 2048, and the hit's 128
     queries over 1152 keys),
     segmented (a packed miss: S=2048 of mixed segments and a padding
     tail) and positioned (a packed hit: 4 rows over 1024/768/512/1024-
     token prefixes), where it also holds the kernel's executed-tile map
     against the plain tile rule (``tile_rule``) at the kernel's tile size
     and prints the bound reckoned from the live layout. Each bf16 limit
     is printed beside the kernel's reading against it and the readings
     of kernels that skip one live key tile or d_ff slice (``limit``
     lines);
  3. runs full-width 24-layer qwen1.5-0.5b forwards (random weights from a
     seed) through the kernels and through the plain versions —
     ``prefill`` (S=512), ``prefill_packed`` and
     ``prefill_packed_with_prefix`` at the phase-2 shapes — and compares
     the logits (per segment: max and mean |Δ| limits, scaled by the plain
     logits' std where it passes qwen's (``logits_limits``), and the plain
     argmax within the kernel's top 5);
  4. drives the solo path: ``PrefillOnlyEngine(max_pack_requests=1)`` runs
     the profile run, then serves requests of two users that each share a
     1030-token profile prefix — misses first, then prefix-cache hits —
     checks that every forward launched each kernel (49, 24 and 24 launches
     per forward, counted through the CUDA graphs' replays) and that the
     scores of every hit, at both (S, P) shapes, match a cold engine's;
     each ``step`` line says whether the step captured its shape key's
     graph or replayed it; prints the warm step latency per shape (median
     and max, beside the eager forwards' median), traces one more miss step and
     hit step with ``torch.profiler`` (idle share of the profiled wall and
     of the unprofiled warm median), and prints the engine's ``graph``
     lines: each graph's capture ms, pool growth and held bytes, and the
     wrapper launches of one profiled replay of it, which must equal what
     its capture counted (the counts the engine adds per replay); the
     graphs must hold no more than the engine's budget and one graph, and
     the pool no more than what they hold and one capture's temporaries;
  5. drives the packed path: ``PrefillOnlyEngine()`` (packing on, the
     reference's defaults) runs the profile run, then waves of distinct
     users' misses that co-pack into packed-miss steps and waves of those
     users' prefix-cache hits that co-pack into packed-hit steps (Nb >= 4,
     pmax = 1024); every score is held against a solo engine's on the same
     weights and requests, launches are 49/24/24 per forward (the packed
     forwards through the segmented and positioned modes); prints the warm
     packed step walls per shape beside the solo walls of the same
     requests, and traces one warm packed-miss and packed-hit step (every
     traced step must name the tensor-core kernels it ran); ``graph``
     lines as in phase 4; then holds the segmented attention and the MLP
     against their plain versions at each packed-miss layout the engine
     ran (its requests' lengths in its S slots; ``path layout`` rows), as
     in phase 2;
  6. checks that Algorithm 1 is no longer first come, first served: a
     solo engine reads its profile fit at lengths up to 2048 and at the
     default lengths (printing both; one must have a slope and pearson >=
     0.9), then serves five fresh requests that arrive about 1 ms apart,
     longest first, and must serve them shortest first; then a solo
     engine with a 32 MiB graph budget serves hits at 15 prefix lengths
     of one profile (a new graph each) and three of them again: device
     memory must grow by no more than the budget, one graph and twice the
     prefix buffer (itself at most twice the longest prefix), and the
     recaptured hits must score as before;
  7. drives the dense decode path through ``build(cfg)``: flash decoding
     (B6) against its plain version at the decode path's shape (B=16,
     S=32768, bf16 and f32), a ragged, a GQA and a head_dim-32 softcap
     case (granite: rows that end inside a key tile and on chunk edges),
     each with its launch plan (kernel, resident blocks a SM, splits,
     waves), a ``limit`` line (the bf16 reading beside those of kernels
     that skip one live key tile of a row), an SDPA yardstick and its
     live-slot bound; then
     full-width ``decode_step`` — 8 steps after a 1024-token ``prefill``
     (B=2), each step's logits against ``prefill`` of the same prefix,
     through the kernels and through the plain versions — and 8 steps at
     positions 32760..32767 of a 48 GiB ``init_cache(16, 32768)`` filled
     from a seed (49/24/24 launches per step and no flash attention, the
     cache written in place at one slot per layer, peak memory under cache
     + weights + 1 GiB), with the warm step wall, tokens/s and a
     ``torch.profiler`` trace of one warm step;
  8. the paper's evaluation layer (``run_long_inputs``): (a) prints
     ``MemoryModel``'s MIL table and prefix budgets at the H100, checks the
     card's reported memory against ``H100_SXM.hbm_bytes`` (within 1%) and
     times a pinned host-to-device copy beside ``host_bw``; holds causal
     attention, RMSNorm and the MLP at the longest S of (b) against their
     plain versions on the first and last 256 rows, timed beside SDPA /
     their library calls and bounds (``long kernel`` lines); (b) runs eager ``prefill`` at each S of
     ``Spec.long_lens`` with ``hybrid_chunk`` on and 0 and ``kv_keep`` 0
     and 16,384, reads the peak bytes above the weights, fits them over S
     beside the model, and fails unless hybrid's slope lies below chunk
     0's and within 1.5x the model's and each kept slice is within 5% of
     its K/V bytes; (c) a solo engine sized by ``prefix_budget_tokens``
     serves two 60,000-token requests through the S = 65,536 graph
     (captured, then replayed; launches counted per forward, the MLP once
     a chunk), each scored within 2e-2 of eager ``prefill`` (at qwen a
     third one traced: ``trace`` lines), then the profile lengths; (d)
     fits ``RooflineJCT``'s efficiency and fixed overhead to those warm
     steps and, at qwen, replays a 4-user x 4-post ``post_recommendation``
     trace at full token scale (all arriving at once; twice, the second
     with every token id moved by one so that every graph is warm) through
     ``PrefillOnlyEngine()``, every score against a cold engine's,
     measured latencies beside the port ``Simulator``'s for the same
     requests and each step's wall beside the roofline's price, then one
     more warm hit traced. Every replay step runs solo: each miss is
     longer than the autotuned pack token budget and each hit's cached
     prefix longer than the pack prefix budget, so the packed modes run in
     phase 5, not here;
  9. the DRAM offload tier (``run_offload``; ``EngineConfig(offload=True)``):
     (a) one block's pinned copies each way (median of 20) beside the
     engine's ``profile()``-measured link and ``H100_SXM.host_bw``, and the
     break-even link at which restoring a block beats recomputing it. The
     policy's decision at the measured link picks what follows, never the
     model's name. Where it restores (granite): (b) two users' 1124-token
     requests, warm hits solo and packed (B4), a flood (one miss as long as
     the device cache) that demotes them, then the solo hit and the packed
     hit restored (replayed graphs, scores within 1e-6 of the same
     request's before demotion and within 2e-2 of a cold engine; every
     replayed step moves device memory by its cache's change alone, so a
     demoted block leaves the card); (c) the same request on an engine
     whose explicit link is slow recomputes; (d) ``restore_estimate`` and
     ``prefetch_prefix`` ahead of a hit, which then restores nothing on its
     execute path, and a prefetch started inside the capture of a new
     shape key, which waits for it (``compiled.capture_lock``); (e) a
     16,384-token request (1,024 blocks) demoted and restored whole, its
     restored hit beside the warm hit and a recompute, the host ms spent
     queuing demotions and restores, and the pinned bytes the process
     holds beside ``host.used_bytes``. Where it refuses (qwen): (c)
     demotion, no restore, a recompute. (f) Launches per forward as in the
     other phases;
 10. the serving plane (``run_serving``; ``repro_torch.launch.serve`` and
     ``repro_torch.serving``): ``make_pool`` instances over the model's
     weights, two on the card, one worker thread each, behind the port's
     ``serve_trace`` or ``AsyncServer``. qwen: (a) WL1 at full token scale
     (4 users x 4 posts at 4 qps, profiled instances warmed on the trace's
     shape keys, least-backlog routing, admission on; cache and graph
     memory sizes printed); (b) WL1 at a twentieth of its token scale, 8 x
     8 at 500 qps, packed-miss and packed-hit steps through the server
     (autotuned budgets printed); (c) (b)'s trace under a seeded
     ``ChaosConfig`` (a step crash, stragglers, NaN corruption; retry on),
     every future resolved once and each served score within 2e-2 of
     (b)'s. granite: (d) the offload tier's serving side through
     ``AsyncServer.submit`` (phase 9's requests; a hit that restores after a
     flood, a hit whose blocks the route-time prefetch brings back; the
     route event's ``restore_s``, ``prefetches_triggered``, the
     ``kv_restore_*``/``kv_prefetch_*`` series and spans, restored scores
     equal to the warm hits'); (e) a short WL1 replay. Every replay
     scrapes ``/metrics`` over HTTP while it runs (strict exposition
     parser, the serving series present) and reads
     ``/trace.chrome.json`` (every served request with queue, execute and
     score spans), prints a ``serve`` line (requests, served, rejected by
     reason, wall, scored requests/s, latency mean/p50/p99, token hit
     rate, steps by kind, engine errors, retries, watchdog trips, peak
     device memory, the card), holds the fault-free replays to no engine
     error, retry, watchdog trip, capture failure or rejection and every
     score within 2e-2 of a cold solo engine, and checks the launches per
     forward;
 11. prints its total seconds and the ``kernels`` JSON line (every kernel
     and attention mode: qwen's row at the top level, each model's row and
     main-path launches under ``models``, ``launches`` their sum), then the
     result line ``{"ok": true, "device": {...}}`` last.

It exits non-zero, printing no result, when CUDA is unavailable or when run
outside a checkout.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import pathlib
import statistics
import subprocess
import sys
import time
import typing

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
YES, NO = 9454, 2753            # stand-in answer token ids
PROFILE_LEN, POST_LEN = 1030, 100

# bf16 outputs: both sides compute in f32 and differ in summation order,
# then round once — a few bf16 ulps (2^-8 relative each)
BF16_TOL = (2e-2, 2e-2)         # |kernel - plain| <= atol + rtol * |plain|
F32_TOL = (1e-4, 1e-4)
# The tensor-core kernels' bf16 limits, set from their outputs' scale. Both
# sides round their f32 result once, so they may differ by one bf16 ulp
# (at most 2^-7 relative): rtol 1e-2. Attention outputs are averages of
# unit-variance V rows (|plain| ~0.03-1 at these shapes); the kernel also
# rounds each p <= 1 to bf16 (2^-9 relative), which moves an output by up
# to 2^-9 max|v| ~ 1e-2 and typically ~1e-3 where few keys are live, so
# atol 4e-3. The MLP's outputs have rms ~0.6; both sides round a = silu(g)
# u once, from f32 sums taken in another order, so a few a values in a
# million land one ulp apart (2^-7 |a|, |a| up to ~20), each moving its
# row by ulp(a) |Wd| (measured up to 4.2e-3 at T = 2048): atol 1e-2.
# Dropping one 64-key tile or one 64-column d_ff slice moves outputs by
# ~1e-2-1e-1; phase 2 prints each kernel's reading beside the readings of
# kernels that skip one such tile.
ATTN_BF16_TOL = (4e-3, 1e-2)
MLP_BF16_TOL = (1e-2, 1e-2)
# flash decoding averages thousands of slots, so its outputs are small
# (|plain| ~0.01 at S = 32768), and one dropped 64-slot tile of a 32768-slot
# row moves them by ~1e-3 at most. Kernel and plain version both compute in
# f32 and round once, so they differ by at most one bf16 ulp, 2^-7 |y| at
# most: rtol 8e-3 admits that and no more, and atol 2e-4 covers outputs
# near 0, so a one-tile skip reads above 1
DEC_BF16_TOL = (2e-4, 8e-3)
# full-width logits limits (max and mean |Δ|), set for logits of std up to
# LOGITS_REF_STD (qwen1.5-0.5b's, 0.6389-0.6404 at random init on the
# card, PERF.md); wider logits scale both by their std (logits_limits)
LOGITS_MAX_TOL = 0.15
LOGITS_MEAN_TOL = 0.02
LOGITS_REF_STD = 0.65
TOP_K = 5                       # the plain argmax ranks in the kernel's top 5
SCORE_GATE = 2e-2               # the repo's engine score gate
# the engine's profile lengths (the reference's), and the longer ladder
# ROADMAP C7 step 3 names for a fit that comes out flat
LONG_LENGTHS = (64, 128, 256, 512, 1024, 2048)
FIT_PEARSON = 0.9
# the order phase: fresh requests arriving about 1 ms apart, longest first
ORDER_LENS = (1900, 1000, 500, 250, 60)
# warm step wall medians with eager forwards, before they were CUDA graphs
# (this script on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 5),
# printed beside this run's
EAGER_WARM_MS = {("solo", 2048, 0): 40.779, ("solo", 128, 1024): 39.320,
                ("solo", 64, 1088): 24.592, ("miss",): 82.229,
                ("hit",): 50.857}
# graph pool: one pool per engine holds every graph's static outputs and
# about one forward's temporaries, not one set of temporaries per graph
# (allocator segments round each capture up, by at most this much)
POOL_SLACK = 32 << 20
# the graph memory phase: a solo engine whose compiled forwards may hold
# GRAPH_BUDGET bytes serves hits at MEMORY_PLENS prefix lengths of one
# user's profile (a new graph each), then the first few again
GRAPH_BUDGET = 32 << 20
MEMORY_PROFILE = 2048
MEMORY_PLENS = tuple(range(128, 1985, 128))
# device kernels one wrapper call launches, by name (the bf16 MLP runs a
# gate/up GEMM and a down GEMM; a split's combine and sum kernels are not
# counted): one replay of each graph is profiled and read with these
KERNEL_CALLS = (("rmsnorm_kernel", "rmsnorm", 1),
                ("flash_fwd", "flash_attention", 1),
                ("mlp_gemm_kernel", "fused_mlp", 2),
                ("fused_mlp_kernel", "fused_mlp", 1),
                ("decode_split", "decode_attention", 1))
SPIN_CYCLES = 2_000_000         # ~1 ms of device spin ahead of a timed call

# packed-miss kernel shape: segments of mixed lengths, then padding slack
SEG_LENS = (64, 400, 128, 256, 96, 300, 180, 72, 350, 110)
SEG_S = 2048
# decode: the JAX package's decode_32k shape (B=128, S=32768) cut to fit
# one 80 GB card beside the weights (Spec.dec_b): B=16 at qwen1.5-0.5b (48
# GiB of KV), B=8 at granite-3-8b (40 GiB beside 16 GB of weights)
DEC_S, DEC_STEPS = 32768, 8
DEC_PREFIX, DEC_CONS_B = 1024, 2      # consistency: prefill 1024 tokens, B=2
# phase 8: the paper's workloads' longest inputs (WL1 post recommendation,
# WL2 credit verification), the kept slice of the peak-memory runs, the
# limits on them, the query rows held against the plain attention at long
# S, the pinned copy timed for the host link, and the replayed trace's size
WL1_MAX, WL2_MAX = 19_000, 60_000
MEM_KEEP = 16_384
SLOPE_LIMIT = 1.5               # measured hybrid slope <= 1.5x the model's
KEPT_TOL = 0.05                 # kept slice within 5% of kv_keep tokens' K/V
LONG_TAIL = 256
HOST_COPY_BYTES = 256 << 20
REPLAY_USERS, REPLAY_POSTS = 4, 4
# the replay engine's graph budget: the trace's miss graphs keep every
# token's K/V as a static output (1.6 GB at S 16,384, 3.2 GB at 32,768 at
# qwen), past the default 2 GiB, which would drop and recapture them
REPLAY_GRAPH_BYTES = 24 << 30
# phase 9, the offload tier: two users' requests of a 1024-token profile
# and a 100-token post (70 blocks each) in a device cache that holds the
# two; a restored step's scores within OFF_SAME of the same request's
# before demotion (the same graph over the same KV: equal); a link of
# OFF_SLOW_BW bytes/s priced slow; the capture-during-prefetch key, a hit
# over 1024 of user 0's tokens, from two prefixes of its request
# (suffixes of 26 and 36 tokens in one S 64 key); (e) a WL1-length request
# of OFF_LONG tokens
OFF_PROFILE, OFF_POST = 1024, 100
OFF_SAME = 1e-6
OFF_SLOW_BW = 1e3
OFF_PREFIX_CUTS = (1050, 1060)
OFF_LONG = 16_384
# phase 10, the serving plane: serve_trace's answer ids (the reference's);
# (a) WL1 at full token scale (profiles 13-19k tokens, posts 150), 4 users x
# 4 posts at 4 qps through two instances warmed on the trace's shape keys,
# each with room for the warm-up's chains and the replay's (140,000 tokens,
# 13.8 GB of KV at qwen) and its miss graphs at S 16,384 and 32,768 (which
# keep every token's K/V: 1.6 and 3.2 GB); (b) WL1 at a twentieth of its
# token scale (profiles ~0.5-0.9k, posts 7): no two misses of WL1 at a
# tenth (1.1-1.7k each) fit the largest pack token budget autotune can set
# (2048, the top suffix bucket, which profiling up to 2048 tokens sets), at
# these two do; 8 users x 8 posts at 500 qps (64 requests in about 0.13 s,
# faster than a step: at 64 qps the misses rarely queued together), so
# misses and hits queue together; (c) (b)'s trace under seeded chaos: a
# step crash on inst0's second step, NaN corruption of inst1's second
# (the warm pool packs (b)'s trace into few steps), and more stragglers
# and NaN corruption drawn from the seed; (e) WL1 at a tenth, 4 x 4
SERVE_ANSWER = (5, 9)
SERVE_A = dict(qps=4.0, scale_tokens=1.0, max_requests=16,
               trace_kw=dict(num_users=4, posts_per_user=4))
SERVE_A_CACHE = 140_000
SERVE_A_GRAPHS = 10 << 30
SERVE_B = dict(qps=500.0, scale_tokens=0.05, max_requests=64,
               trace_kw=dict(num_users=8, posts_per_user=8))
SERVE_B_CACHE = 16_384
SERVE_CHAOS = dict(nan_score=0.05, straggler=0.05, straggler_seconds=0.01,
                   schedule=(("inst0", 1, "step_error"),
                             ("inst1", 1, "nan_score")), max_faults=8)
SERVE_E = dict(qps=8.0, scale_tokens=0.1, max_requests=16,
               trace_kw=dict(num_users=4, posts_per_user=4))
SERVE_E_CACHE = 16_384


class Spec(typing.NamedTuple):
    """One model's phases: its config, the packed-hit shape (prefix and
    suffix lengths of 4 rows, pmax, S; also the packed engine's profiles
    and posts, and the least rows and the pmax (0: any) that one of the
    packed engine's hit steps must have), the decode depth batch, the kernel
    rows' token counts (the MLP's first T is its JSON row; RMSNorm's JSON
    row is norm_t, and it is timed at every T of norm_ts), extra dense
    attention cases (label, B, Sq, Sk, H, KV, d, kwargs) and extra decode
    cases (label, B, S, H, KV, d, kv_len or "ragged", softcap) for phase 2,
    whether the model's extra phases run (phase 6's order and graph memory
    checks; phase 8's trace replay and its traces of a warm long step and
    of a warm replay hit), the eager forwards' warm step medians printed
    beside this run's, and the peak-memory ladder's S of phase 8 (its last
    also the long attention, MLP and RMSNorm rows' S and T)."""
    arch: str
    plens: tuple
    slens: tuple
    pmax: int
    hit_s: int
    hit_nb: int
    hit_pmax: int
    dec_b: int
    mlp_ts: tuple
    norm_t: int
    norm_ts: tuple
    extra_attn: tuple
    extra_dec: tuple
    extra_phases: bool
    eager_ms: dict
    long_lens: tuple


# qwen1.5-0.5b, the earlier slices' model. Its extra cases cover the
# kernels' other options (window, softcap, kv_valid, head_dim 32, ragged
# and GQA caches), and the order and graph memory checks run at its
# widths, where they were set.
QWEN = Spec("qwen1.5-0.5b", plens=(1024, 768, 512, 1024),
            slens=(128, 96, 160, 128), pmax=1024, hit_s=512, hit_nb=4,
            hit_pmax=1024, dec_b=16,
            mlp_ts=(512, 16, 128, 2048), norm_t=512,
            norm_ts=(16, 128, 512, 1024, 2048),
            extra_attn=(
                ("gqa_window_softcap_padded", 2, 300, 300, 16, 4, 64,
                 dict(window=128, softcap=30.0, kv_valid=250)),
                ("noncausal_d32", 1, 96, 200, 8, 8, 32, dict(causal=False))),
            extra_dec=(
                ("ragged", 16, DEC_S, 16, 16, 64, "ragged", 0.0),
                ("gqa", 4, 8192, 16, 2, 64, (8192, 5000, 77, 8192), 0.0),
                ("d32_softcap", 4, 4100, 8, 4, 32, (4100, 4099, 2050, 1),
                 50.0)),
            extra_phases=True, eager_ms=EAGER_WARM_MS,
            long_lens=(8192, 16384, 32768, 65536))
# granite-3-8b at full width (40 layers, d_model 4096, 32/8 heads of 128,
# d_ff 12,800). Its profiles are half qwen's: autotune_packing sets a token
# budget of at least 1024 whenever the fit has a slope (a 1024-token step
# costs less than twice a 512-token one), where two of qwen's profiles
# never fit one pack; two of these misses (256 + 512) always fit, and four
# hits (512 computed tokens over 1664 cached) fit the budgets, though the
# shape cost model may split them by their prefix lengths: a packed hit
# step of 2 or more rows is required. Its logits have twice qwen's scale
# (std ~0.02 sqrt(4096) = 1.3), which logits_limits reads from each run.
GRANITE = Spec("granite-3-8b", plens=(512, 384, 256, 512),
               slens=(128, 96, 160, 128), pmax=512, hit_s=512, hit_nb=2,
               hit_pmax=0, dec_b=8,
               mlp_ts=(512, 8, 128, 2048), norm_t=2048,
               norm_ts=(8, 128, 512, 1024, 2048), extra_attn=(),
               extra_dec=(("ragged_tiles", 8, DEC_S, 32, 8, 128, "tiles",
                           0.0),),
               extra_phases=False, eager_ms={},
               long_lens=(8192, 16384, 32768))
SPECS = (QWEN, GRANITE)

# JSON entries: (name, launch counter, TPU kernel it replaces); the entry
# "flash_attention" is the attention kernel's dense mode
KERNELS = (
    ("rmsnorm", "rmsnorm", "src/repro/kernels/rmsnorm.py:25"),
    ("flash_attention", "flash_attention[dense]",
     "src/repro/kernels/flash_attention.py:166"),
    ("flash_attention[segmented]", "flash_attention[segmented]",
     "src/repro/kernels/flash_attention.py:100"),
    ("flash_attention[positioned]", "flash_attention[positioned]",
     "src/repro/kernels/flash_attention.py:78"),
    ("fused_mlp", "fused_mlp", "src/repro/kernels/fused_mlp.py:46"),
    ("decode_attention", "decode_attention",
     "src/repro/kernels/decode_attention.py:55"),
)
SOURCE = {"rmsnorm": "rmsnorm", "fused_mlp": "fused_mlp",
          "decode_attention": "decode_attention"}
# the bf16 tensor-core kernels a traced step must name (the f32 CUDA-core
# kernels are flash_fwd_kernel and fused_mlp_kernel)
TC_PREFILL = ("flash_fwd_tc_kernel", "mlp_gemm_kernel")
TC_DECODE = ("mlp_gemm_kernel",)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def main() -> int:
    global SEED
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=SEED,
                        help="seed of every weight and input (default 0)")
    SEED = parser.parse_args().seed
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run it from the root of a checkout "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False    # plain f32 stays f32
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import SOURCES, _build

    print(f"card: {card_line()}", flush=True)
    print(f"seed: {SEED}", flush=True)
    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    print(f"build: {len(SOURCES)} kernels in "
          f"{time.perf_counter() - t0:.1f} s (parallel nvcc, sm_90a)",
          flush=True)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    results, launches = {}, {}
    for spec in SPECS:
        results[spec.arch], launches[spec.arch] = run_model(torch, dev, spec)
        gc.collect()                  # the model's weights, engines, graph
        torch.cuda.empty_cache()      # pools and caches go back to the card

    lines = []
    for name, counter, replaces in KERNELS:
        by_model = {arch: dict(results[arch][name],
                               launches=launches[arch][counter])
                    for arch in results}
        for row in by_model.values():
            row.pop("f32_err")
        r = by_model[QWEN.arch]
        lines.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      f"{SOURCE.get(name, 'flash_attention')}.cu",
            "replaces": replaces,
            "launches": sum(m["launches"] for m in by_model.values()),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "models": by_model})
    print(f"total: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_model(torch, dev, spec: Spec):
    """Every phase at one model's widths. Returns the kernel rows and the
    launches of its main path (solo engine, packed engine, decode steps,
    phase 8's engine steps)."""
    print(f"=== {spec.arch}: device memory allocated "
          f"{torch.cuda.memory_allocated()} bytes, reserved "
          f"{torch.cuda.memory_reserved()}, free "
          f"{torch.cuda.mem_get_info(dev)[0]} of "
          f"{torch.cuda.mem_get_info(dev)[1]}", flush=True)
    t0 = time.perf_counter()
    results = check_kernels(torch, dev, spec)
    results.update(check_packed_kernels(torch, dev, spec))
    results.update(check_decode_kernel(torch, dev, spec))
    cfg, params = draw_model(torch, dev, spec.arch)
    check_full_prefill(torch, dev, cfg, params)
    check_packed_forwards(torch, dev, spec, cfg, params)
    solo = run_engine(torch, dev, spec, cfg, params)
    packed = run_packed_engine(torch, dev, spec, cfg, params)
    if spec.extra_phases:
        run_order(torch, dev, cfg, params)
        run_graph_memory(torch, dev, cfg, params)
    decode = run_decode(torch, dev, spec, cfg, params)
    gc.collect()                  # the decode cache goes back to the card
    torch.cuda.empty_cache()
    long = run_long_inputs(torch, dev, spec, cfg, params)
    gc.collect()                  # phase 8's engines go back to the card
    torch.cuda.empty_cache()
    offload = run_offload(torch, dev, cfg, params)
    serving = run_serving(torch, dev, spec, cfg, params)
    paths = (solo, packed, decode, long, offload, serving)
    launches = {k: sum(p.get(k, 0) for p in paths)
                for k in set().union(*paths)}
    print(f"{spec.arch}: main path launches (solo engine + packed engine + "
          f"decode steps + long requests and replay + offload tier + "
          f"serving plane): "
          f"{launches}; phases took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return results, launches


def draw_model(torch, dev, arch: str):
    """The config of ``arch`` and its random weights in the config's dtype,
    drawn on the card from SEED; prints their size, the time to draw them
    and the peak of device memory meanwhile."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params
    cfg = get_config(arch)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    print(f"model: {cfg.name} L={cfg.num_layers} d_model={cfg.d_model} "
          f"heads={cfg.num_heads}/{cfg.num_kv_heads} head_dim="
          f"{cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
          f"params={sum(a.numel() for a in leaves)} {cfg.dtype}; weights "
          f"{sum(a.numel() * a.element_size() for a in leaves)} bytes drawn "
          f"in {time.perf_counter() - t0:.2f} s, peak allocated "
          f"{torch.cuda.max_memory_allocated()} bytes", flush=True)
    return cfg, params


# ---- timing -----------------------------------------------------------------
def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``iters`` runs, each after a 64 MiB
    write that evicts the 50 MB L2 (a layer's kernels find their weights
    cold in a forward). A spin kernel keeps the device busy while the host
    enqueues ``fn``, so the events time the device work and not the host's
    launch overhead."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(chip, flops: float, nbytes: float):
    from repro_torch.runtime import hw
    t_ops = hw.compute_seconds(flops, chip)
    t_mem = hw.memory_seconds(nbytes, chip)
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops >= t_mem else "bytes")


# ---- phase 2: kernels against their plain versions ---------------------------
def compare(torch, got, want, tol, what: str) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite kernel output")
    err = (got - want).abs()
    atol, rtol = tol
    if not bool((err <= atol + rtol * want.abs()).all()):
        fail(f"{what}: max |kernel - plain| = {err.max().item():.3e} "
             f"beyond {atol} + {rtol}|plain|")
    return err.max().item()


def builds(rule, width: int, dtype) -> bool:
    """Whether a kernel's width rule takes ``width`` in ``dtype``."""
    try:
        rule(width, dtype)
    except ValueError:
        return False
    return True


def width_refused(torch, what: str, fn) -> None:
    """A call that a kernel's width rule refuses must raise, naming the
    rule, and launch nothing."""
    try:
        fn()
    except ValueError as e:
        if "rule of dtype and width" not in str(e):
            fail(f"{what}: refused without naming the rule: {e}")
        print(f"width rule: {what} refused: {e}", flush=True)
        return
    fail(f"{what}: ran, past its kernel's width rule")


def check_kernels(torch, dev, spec: Spec):
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.runtime.hw import H100_SXM as chip

    cfg = get_config(spec.arch)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16

    def randn(*shape, std=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    out = {}
    print(f"phase 2 at {spec.arch} widths", flush=True)

    # RMSNorm at the model's d_model and every T of the main path
    # (spec.norm_ts: a decode step's batch, a hit, a packed hit, a packed
    # miss, a miss), each with its launch plan; the JSON row is T =
    # spec.norm_t. Each kernel is checked in bf16 on the inputs it is timed
    # on (an entry's max_abs_err), and the JSON row's shape also in f32
    # (f32_err)
    D = cfg.d_model
    for T in spec.norm_ts:
        errs = {}
        dtypes = ((torch.float32, F32_TOL), (bf16, BF16_TOL)) \
            if T == spec.norm_t else ((bf16, BF16_TOL),)
        for dtype, tol in dtypes:
            x, w = randn(T, D, dtype=dtype), randn(D, std=0.1, dtype=dtype)
            errs[dtype] = compare(torch, rn.rmsnorm(x, w),
                                  rn.rmsnorm_plain(x, w), tol,
                                  f"rmsnorm T={T} {dtype}")
        w1 = (1.0 + w.float()).to(bf16)
        plan = rn.launch_plan(
            T, D, x.element_size(), rn._sm_count(dev.index), rn.vector_rule(
                D, x.element_size(), x.stride(0), x.data_ptr(),
                w.data_ptr()))
        b_ms, b_by = bound(chip, 4.0 * T * D, 2 * (2 * T * D + D))
        row = dict(
            max_abs_err=errs[bf16], f32_err=errs.get(torch.float32),
            ms=time_ms(torch, lambda: rn.rmsnorm(x, w)),
            plain_ms=time_ms(torch, lambda: rn.rmsnorm_plain(x, w)),
            library_ms=time_ms(torch, lambda: F.rms_norm(x, (D,), w1, 1e-6)),
            bound_ms=b_ms, bound_by=b_by,
            shape=f"T={T} D={D} bf16, plan: "
                  + (f"vector, {plan.warps_per_row} warps a row, "
                     f"{plan.rows_per_block} rows a block, {plan.vectors} "
                     f"16-byte vectors a thread, {plan.blocks} blocks of "
                     f"{plan.threads}" if plan.vector else
                     f"scalar, {plan.blocks} blocks of {plan.threads}"))
        report("rmsnorm" if T == spec.norm_t else f"rmsnorm[T={T}]", row)
        if T == spec.norm_t:
            out["rmsnorm"] = row

    # attention cases: (label, B, Sq, Sk, H, KV, d, kwargs) at the model's
    # heads; the first is the JSON row, causal_2048 the solo miss's shape,
    # q_offset the solo hit's
    H, KV, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cases = [
        ("causal", 1, 512, 512, H, KV, d, dict()),
        ("causal_2048", 1, 2048, 2048, H, KV, d, dict()),
        ("q_offset", 1, 128, 1152, H, KV, d, dict(q_offset=1024)),
    ]
    cases += spec.extra_attn
    f32_attn = builds(fa.width_rule, d, torch.float32)
    if not f32_attn:
        q32 = randn(1, 64, H, d, dtype=torch.float32)
        width_refused(torch, f"flash_attention float32 head_dim {d}",
                      lambda: fa.flash_attention(q32, q32[:, :, :KV],
                                                 q32[:, :, :KV]))
    for label, B, Sq, Sk, H, KV, d, kw in cases:
        dtypes = ((torch.float32, F32_TOL), (bf16, ATTN_BF16_TOL)) \
            if label == "causal" and f32_attn else ((bf16, ATTN_BF16_TOL),)
        errs = {}
        for dtype, tol in dtypes:
            q = randn(B, Sq, H, d, dtype=dtype)
            k, v = randn(B, Sk, KV, d, dtype=dtype), randn(B, Sk, KV, d,
                                                            dtype=dtype)
            got = fa.flash_attention(q, k, v, **kw)
            want = fa.flash_attention_plain(q, k, v, **kw)
            errs[dtype] = compare(torch, got, want, tol,
                                  f"flash_attention {label} {dtype}")
        live = fa._live_mask(Sq, Sk, causal=kw.get("causal", True),
                             window=kw.get("window", 0),
                             q_offset=kw.get("q_offset", 0),
                             kv_valid=kw.get("kv_valid"), device=dev)
        if label in ("causal", "causal_2048", "q_offset"):
            report_limit(torch, f"flash_attention[{label}]", got, want,
                         ATTN_BF16_TOL, attention_skips(
                             torch, fa, q, k, v, live, want, ATTN_BF16_TOL,
                             softcap=kw.get("softcap", 0.0)))
        pairs = float(live.sum().item()) * B * H
        nbytes = 2 * (2 * B * Sq * H * d + 2 * B * Sk * KV * d)
        b_ms, b_by = bound(chip, 4.0 * d * pairs, nbytes)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = None if label.startswith("causal") else live

        def library(qt=qt, kt=kt, vt=vt, mask=mask, gqa=H != KV):
            # the causal cases use SDPA's own causal mode; the others give
            # it the live mask (the softcap case has no SDPA counterpart)
            if mask is None:
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=gqa)
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=gqa)

        splits, chunk = fa.split_rule(B, Sq, H, Sk, fa._sm_count(dev.index))
        row = dict(
            max_abs_err=errs[bf16], f32_err=errs.get(torch.float32),
            ms=time_ms(torch, lambda: fa.flash_attention(q, k, v, **kw)),
            plain_ms=time_ms(torch,
                             lambda: fa.flash_attention_plain(q, k, v, **kw)),
            library_ms=(time_ms(torch, library)
                        if not kw.get("softcap") else None),
            bound_ms=b_ms, bound_by=b_by,
            shape=f"B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} d={d} {label} bf16, "
                  f"key split {splits}x{chunk} tiles")
        report(f"flash_attention[{label}]", row)
        if label == "causal":
            out["flash_attention"] = row

    # fused MLP at the model's width and the main path's token counts: a
    # decode step's batch, a solo hit's 128, the packed hit's 512 (the JSON
    # row) and a miss's 2048
    D = cfg.d_model
    f32_mlp = builds(fm.width_rule, D, torch.float32)
    if not f32_mlp:
        x32 = randn(8, D, dtype=torch.float32)
        w32 = randn(D, 64, dtype=torch.float32)
        width_refused(torch, f"fused_mlp float32 D {D}",
                      lambda: fm.fused_mlp(x32, w32, w32, w32.T.contiguous()))
    for T in spec.mlp_ts:
        dtypes = ((torch.float32, F32_TOL), (bf16, MLP_BF16_TOL)) \
            if T == spec.mlp_ts[0] and f32_mlp else ((bf16, MLP_BF16_TOL),)
        row = check_mlp(torch, dev, cfg, randn, T, dtypes)
        report("fused_mlp" if T == spec.mlp_ts[0] else f"fused_mlp[T={T}]",
               row)
        if T == spec.mlp_ts[0]:
            out["fused_mlp"] = row
    return out


def check_mlp(torch, dev, cfg, randn, T: int, dtypes, where: str = ""):
    """The fused MLP at the model's widths and T tokens against its plain
    version in each of ``dtypes`` (random inputs from ``randn``); the bf16
    limit beside the one-slice-skip readings; times and bound. Returns the
    row (of the last dtype's inputs, bf16)."""
    import torch.nn.functional as F
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.runtime.hw import H100_SXM as chip
    D, Fd = cfg.d_model, cfg.d_ff
    errs = {}
    for dtype, tol in dtypes:
        x = randn(T, D, dtype=dtype)
        wg, wu, wd = (randn(D, Fd, std=D ** -0.5, dtype=dtype),
                      randn(D, Fd, std=D ** -0.5, dtype=dtype),
                      randn(Fd, D, std=Fd ** -0.5, dtype=dtype))
        got = fm.fused_mlp(x, wg, wu, wd)
        want = fm.fused_mlp_plain(x, wg, wu, wd)
        errs[dtype] = compare(torch, got, want, tol,
                              f"fused_mlp T={T}{where} {dtype}")
    report_limit(torch, f"fused_mlp[T={T}]{where}", got, want, MLP_BF16_TOL,
                 mlp_skips(torch, fm, x, wg, wu, wd, want, MLP_BF16_TOL))
    b_ms, b_by = bound(chip, 6.0 * T * D * Fd, 2 * (2 * T * D + 3 * D * Fd))
    plan = fm.mlp_plan(T, D, Fd, fm._sm_count(dev.index))
    return dict(
        max_abs_err=errs[torch.bfloat16], f32_err=errs.get(torch.float32),
        ms=time_ms(torch, lambda: fm.fused_mlp(x, wg, wu, wd)),
        plain_ms=time_ms(torch, lambda: fm.fused_mlp_plain(x, wg, wu, wd)),
        library_ms=time_ms(torch, lambda: (F.silu(x @ wg) * (x @ wu)) @ wd),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"T={T} D={D} F={Fd} bf16, gate/up tile {plan.gate_up}, "
              f"down tile {fm.DOWN_TILE} x {plan.splits} d_ff splits")


def reading(torch, got, want, tol) -> float:
    """max |got - want| / (atol + rtol |want|): a check passes at <= 1."""
    atol, rtol = tol
    got, want = got.float(), want.float()
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


def attention_skips(torch, fa, q, k, v, live, want, tol, softcap=0.0):
    """Readings of a kernel that skips one live (query block, key tile)
    pair of the bf16 kernel's tiles, for every such pair: the plain
    version's arithmetic (``fa.attend_plain``) over the block's rows with
    that tile's keys masked, against the plain output. Returns a list of
    (reading, block, tile)."""
    bq, bk = fa.tile_shape(q.dtype)
    Sq, Sk = live.shape[-2:]
    out = []
    for i in range(-(-Sq // bq)):
        rows = slice(i * bq, min((i + 1) * bq, Sq))
        lv = live[..., rows, :]
        for j in range(-(-Sk // bk)):
            if not bool(lv[..., j * bk:(j + 1) * bk].any()):
                continue
            m = lv.clone()
            m[..., j * bk:(j + 1) * bk] = False
            got = fa.attend_plain(q[:, rows], k, v, m, softcap=softcap)
            out.append((reading(torch, got, want[:, rows], tol), i, j))
    return out


def mlp_skips(torch, fm, x, wg, wu, wd, want, tol):
    """Readings of a kernel that drops one BK-wide slice of d_ff (one k
    tile of the down product), for every slice: the plain version with
    that slice of a zeroed, against the plain output. Returns a list of
    (reading, slice, None)."""
    a = fm.swiglu_plain(x, wg, wu)
    out = []
    for j in range(-(-a.shape[1] // fm.BK)):
        cut = a.clone()
        cut[:, j * fm.BK:(j + 1) * fm.BK] = 0
        got = (cut.float() @ wd.float()).to(x.dtype)
        out.append((reading(torch, got, want, tol), j, None))
    return out


def report_limit(torch, name: str, got, want, tol, skips) -> None:
    """Print a bf16 limit beside the kernel's reading against it and the
    readings of kernels that skip one live tile; fail if the kernel's
    reading is above 1."""
    sound = reading(torch, got, want, tol)
    vals = sorted(r for r, _, _ in skips)
    least = min(skips, key=lambda t: t[0])
    caught = sum(r > 1 for r in vals)
    print(f"limit {name}: |kernel - plain| <= {tol[0]} + {tol[1]}|plain| "
          f"(reading 1); kernel reading {sound:.4f}; one-tile skips read "
          f"min {least[0]:.4f} (tile {least[1:]}), median "
          f"{statistics.median(vals):.4f}; {caught} of {len(vals)} skips "
          f"caught", flush=True)
    if sound > 1:
        fail(f"{name}: kernel reading {sound:.4f} above the bf16 limit")


def packed_case(dev, slens, S, plens=None, pmax=0):
    """A packed step's model inputs as the engine lays them out
    (``tfm.packed_layout``; suffix segments of ``slens`` in S slots, each
    over its cached prefix of ``plens`` in a (len(plens), pmax) buffer), on
    ``dev``, and ``ids``: the attention's segment ids and positions as the
    model derives them (``seg_ids`` for both sides of a packed miss;
    ``tfm.packed_prefix_layout`` for a packed hit)."""
    from repro_torch.models import transformer as tfm
    lay = tfm.packed_layout(plens or [0] * len(slens), slens, S,
                            smax=max(slens), pmax=pmax)
    lay = {k: t.to(dev) for k, t in lay.items()}
    if plens is None:
        return lay, {"seg_q": lay["seg_ids"], "seg_k": lay["seg_ids"]}
    seg_q, seg_k, pos_k = tfm.packed_prefix_layout(
        lay["positions"], lay["prefix_pos"], lay["seg_qidx"])
    return lay, {"seg_q": seg_q, "seg_k": seg_k, "pos_q": lay["positions"],
                 "pos_k": pos_k}


def tile_rule(Sq: int, Sk: int, *, causal: bool = True, window: int = 0,
              seg_q=None, seg_k=None, pos_q=None, pos_k=None,
              block_q: int = 32, block_k: int = 32):
    """(B, nq, nk) int32 map of the (query block, key tile) pairs the
    attention kernel runs (1) or skips (0): the plain rule its executed-tile
    map is held against, here and in the tests. It is the Pallas kernel's
    rule (``src/repro/kernels/flash_attention.py:78-111``) with the block and
    tile ranges taken over real tokens only (with segment ids, ``seg >=
    0``): a padding query attends nothing, so it does not widen its block's
    range, where the Pallas kernel lets the block that holds a padding tail
    run every tile of its causal range.

    A tile runs iff, without positions, it lies in the block's structural
    key range (causal: ``j*bk <= last row``; window: ``j*bk + bk - 1 >=
    first row - window + 1``); with segment ids, the block's and the tile's
    id ranges meet and the tile holds an id >= 0; with positions,
    ``min(pos_k) <= max(pos_q)`` (causal) and ``max(pos_k) >= min(pos_q) -
    window + 1`` (window)."""
    import torch
    import torch.nn.functional as F
    big = 2 ** 31 - 1
    B = 1 if seg_q is None else seg_q.shape[0]
    dev = "cpu" if seg_q is None else seg_q.device
    nq, nk = -(-Sq // block_q), -(-Sk // block_k)

    def ranges(x, real, n, block):
        """Per-block (min, max) of x over its real entries; a block without
        one gets (big, -big), which meets no range."""
        pad = n * block - x.shape[1]
        lo = F.pad(torch.where(real, x.long(), big), (0, pad), value=big)
        hi = F.pad(torch.where(real, x.long(), -big), (0, pad), value=-big)
        return (lo.reshape(B, n, block).amin(-1),
                hi.reshape(B, n, block).amax(-1))

    i = torch.arange(nq, device=dev)[:, None]
    j = torch.arange(nk, device=dev)[None, :]
    run = torch.ones((nq, nk), dtype=torch.bool, device=dev)
    if pos_q is None:
        last = torch.clamp((i + 1) * block_q, max=Sq) - 1
        if causal:
            run = run & (j * block_k <= last)
        if window > 0:
            run = run & (j * block_k + block_k - 1
                         >= i * block_q - window + 1)
    run = run[None].expand(B, nq, nk)
    if seg_q is not None:
        q_real, k_real = seg_q >= 0, seg_k >= 0
        qlo, qhi = ranges(seg_q, q_real, nq, block_q)
        klo, khi = ranges(seg_k, k_real, nk, block_k)
        run = run & (qlo[:, :, None] <= khi[:, None, :]) \
            & (qhi[:, :, None] >= klo[:, None, :]) & (khi[:, None, :] >= 0)
    if pos_q is not None:
        plo, phi = ranges(pos_q, q_real, nq, block_q)
        klo, khi = ranges(pos_k, k_real, nk, block_k)
        if causal:
            run = run & (klo[:, None, :] <= phi[:, :, None])
        if window > 0:
            run = run & (khi[:, None, :] >= plo[:, :, None] - window + 1)
    return run.to(torch.int32)


def live_bytes(ids, Sq: int, H: int, KV: int, d: int) -> int:
    """Bytes a packed attention call must move, reckoned from its live
    layout: q of the real query rows (``seg_q >= 0``; a padding row's output
    is 0 whatever its q), the bf16 output of all Sq rows, K and V of the
    real keys (``seg_k >= 0``; no query attends a padding key), and each
    distinct id or position array once (``seg_q is seg_k`` in a packed
    miss)."""
    q_real = int((ids["seg_q"] >= 0).sum())
    k_real = int((ids["seg_k"] >= 0).sum())
    arrays = {t.data_ptr(): t.numel() * t.element_size()
              for t in ids.values()}
    return (2 * (q_real * H * d + Sq * H * d + 2 * k_real * KV * d)
            + sum(arrays.values()))


def check_packed_kernels(torch, dev, spec: Spec):
    """Phase 2, packed modes: the segmented (packed miss) and positioned
    (packed hit) attention at the model's heads against the plain version,
    in bf16 and, where the width rule builds it, in f32 (``check_packed``).
    """
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa

    cfg = get_config(spec.arch)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    S, N = spec.hit_s, len(spec.plens)
    dtypes = [(torch.bfloat16, ATTN_BF16_TOL)]
    if builds(fa.width_rule, cfg.head_dim, torch.float32):
        dtypes.insert(0, (torch.float32, F32_TOL))
    return {
        "flash_attention[segmented]": check_packed(
            torch, dev, cfg, gen, "segmented", SEG_S, SEG_S,
            packed_case(dev, SEG_LENS, SEG_S)[1],
            segments_desc(SEG_LENS, SEG_S), dtypes),
        "flash_attention[positioned]": check_packed(
            torch, dev, cfg, gen, "positioned", S, N * spec.pmax + S,
            packed_case(dev, spec.slens, S, spec.plens, spec.pmax)[1],
            f"Sq={S} Sk={N * spec.pmax + S} plens={spec.plens} "
            f"suffixes={spec.slens} pmax={spec.pmax}", dtypes)}


def segments_desc(lens, S: int) -> str:
    return (f"S={S} segments={len(lens)} ({min(lens)}...{max(lens)}, tail "
            f"{S - sum(lens)})")


def check_packed(torch, dev, cfg, gen, label: str, Sq: int, Sk: int, ids,
                 desc: str, dtypes, where: str = ""):
    """The attention in a packed mode (``label``) at the model's heads on
    the layout ``ids`` against the plain version in each of ``dtypes``; the
    kernel's executed-tile map against the plain tile rule at its own tile
    size; the bf16 limit beside the one-tile-skip readings; times and the
    live-layout bound. Returns the row (bf16)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.runtime.hw import H100_SXM as chip

    H, KV, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    name = f"flash_attention[{label}]{where}"
    errs = {}
    for dtype, tol in dtypes:
        q = (torch.randn((1, Sq, H, d), generator=gen, device=dev)).to(dtype)
        k, v = ((torch.randn((1, Sk, KV, d), generator=gen, device=dev)
                 ).to(dtype) for _ in range(2))
        bq, bk = fa.tile_shape(dtype)
        tmap = torch.empty((1, -(-Sq // bq), -(-Sk // bk)),
                           dtype=torch.int32, device=dev)
        got = fa.flash_attention(q, k, v, tile_map=tmap, **ids)
        want = fa.flash_attention_plain(q, k, v, **ids)
        errs[dtype] = compare(torch, got, want, tol, f"{name} {dtype}")
        pad = ids["seg_q"][0] < 0
        if pad.any() and got[0, pad].abs().max().item() != 0.0:
            fail(f"{name}: a padding row is not 0")
        # the executed tiles against the plain rule at the kernel's own
        # tile size (bf16: BLOCK_Q x BLOCK_K; f32: 32 x 32)
        want_map = tile_rule(Sq, Sk, block_q=bq, block_k=bk, **ids)
        causal_map = tile_rule(Sq, Sk, block_q=bq, block_k=bk)
        ran, total = int(tmap.sum()), tmap.numel()
        print(f"tiles {label}{where} {dtype}: kernel ran {ran} of {total} "
              f"{bq}x{bk} tiles, plain tile rule {int(want_map.sum())} "
              f"(causal-only structural rule {int(causal_map.sum())}); "
              f"maps equal: {bool(torch.equal(tmap, want_map))}", flush=True)
        if not torch.equal(tmap, want_map):
            fail(f"{name} {dtype}: executed-tile map differs from the plain "
                 f"tile rule")
    live = fa._live_mask(Sq, Sk, causal=True, window=0, q_offset=0,
                         kv_valid=None, device=dev, **ids)
    report_limit(torch, name, got, want, ATTN_BF16_TOL,
                 attention_skips(torch, fa, q, k, v, live, want,
                                 ATTN_BF16_TOL))
    pairs = int(live.sum().item()) * H
    nbytes = live_bytes(ids, Sq, H, KV, d)
    b_ms, b_by = bound(chip, 4.0 * d * pairs, nbytes)
    print(f"bound {label}{where}: {nbytes} bytes (live layout), {pairs} live "
          f"(q, k) pairs over {H} heads -> {b_ms:.6f} ms ({b_by})",
          flush=True)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = live[:, None]                              # (1, 1, Sq, Sk)

    def library(qt=qt, kt=kt, vt=vt, mask=mask, gqa=H != KV):
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=gqa)

    row = dict(
        max_abs_err=errs[torch.bfloat16], f32_err=errs.get(torch.float32),
        ms=time_ms(torch, lambda: fa.flash_attention(q, k, v, **ids)),
        plain_ms=time_ms(torch,
                         lambda: fa.flash_attention_plain(q, k, v, **ids)),
        library_ms=time_ms(torch, library),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"{desc} H={H} KV={KV} d={d} bf16, live pairs/head "
              f"{pairs // H}, tiles run {ran}/{total}")
    report(name, row)
    return row


def check_path_layouts(torch, dev, spec: Spec, cfg, layouts) -> None:
    """Phase 5's packed-miss layouts as the engine ran them (S slots and
    its requests' lengths, in order): the segmented attention at the
    model's heads, and the MLP at S tokens where phase 2 has no row at S,
    against their plain versions in bf16 with phase 2's limits and skip
    readings (``path layout`` rows)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    for S, lens in sorted(layouts):
        check_packed(torch, dev, cfg, gen, "segmented", S, S,
                     packed_case(dev, lens, S)[1], segments_desc(lens, S),
                     [(torch.bfloat16, ATTN_BF16_TOL)],
                     where=f" path layout {lens}")
    for S in sorted({S for S, _ in layouts} - set(spec.mlp_ts)):
        report(f"fused_mlp[T={S}] path layout",
               check_mlp(torch, dev, cfg, randn, S,
                         ((torch.bfloat16, MLP_BF16_TOL),),
                         where=" path layout"))


def decode_live(k, kv_len) -> int:
    """Live cache slots of a decode call: ``min(kv_len[b], S)`` summed over
    the rows (a host read of ``kv_len``, made by this script only)."""
    return int(kv_len.clamp(0, k.shape[1]).sum().item())


def decode_bound_bytes(q, k, kv_len) -> int:
    """Bytes a decode call must move: q and the output once, K and V over
    the live slots of each row only, and ``kv_len``."""
    B, _, H, d = q.shape
    KV = k.shape[2]
    return (k.element_size() * (2 * B * H * d + 2 * decode_live(k, kv_len)
                                * KV * d) + kv_len.numel() * 4)


def decode_plan(dev, B, S, H, KV, d, dtype):
    """Flash decoding's launch plan on this card for q (B, 1, H, d) and
    caches (B, S, KV, d) of ``dtype``: the kernel (``kernel_rule``), its
    resident blocks a SM, the split rule's splits and chunk, blocks and
    waves, as the wrapper makes it."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    tc = da.kernel_rule(H // KV, dtype) == "tc"
    per_sm = da._blocks_per_sm(dev.index, _build.dtype_code(dtype), d,
                               H // KV, tc)
    return da.launch_plan(B, S, H, KV, dtype, da._sm_count(dev.index),
                          per_sm)


def decode_skips(torch, q, k, v, kv_len, want, tol, softcap=0.0):
    """Readings of a kernel that skips one live ``KEY_TILE``-slot key tile
    of one row, for every such (row, tile): the plain version's arithmetic
    with that tile's slots masked, against the plain output. Masking a
    tile takes its terms out of the softmax's sums, so every skip comes
    from one pass: per-tile sums l_t = sum p and o_t = sum p v (p against
    the row's max), and the skip's output (O - o_t) / (L - l_t), cast to
    q's dtype. Returns a list of (reading, row, tile)."""
    from repro_torch.kernels import decode_attention as da
    B, _, H, d = q.shape
    S, KV = k.shape[1], k.shape[2]
    G, T = H // KV, da.KEY_TILE
    nt = -(-S // T)
    pad = (0, 0, 0, 0, 0, nt * T - S)
    kf = torch.nn.functional.pad(k.float(), pad)
    qf = q.reshape(B, KV, G, d).float() * d ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", qf, kf)
    del kf
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    live = (torch.arange(nt * T, device=q.device)[None, :]
            < kv_len.reshape(B, 1))[:, None, None, :]
    s = s.masked_fill(~live, da.NEG_INF)
    p = (torch.exp(s - s.amax(-1, keepdim=True)) * live).view(
        B, KV, G, nt, T)
    del s
    vf = torch.nn.functional.pad(v.float(), pad).view(B, nt, T, KV, d)
    o_t = torch.einsum("bkgtj,btjkd->bkgtd", p, vf)
    del vf
    l_t = p.sum(-1, keepdim=True)
    skip = ((o_t.sum(3, keepdim=True) - o_t)
            / (l_t.sum(3, keepdim=True) - l_t).clamp_min(1e-30))
    skip = skip.to(q.dtype).float()
    ref = want.reshape(B, KV, G, 1, d).float()
    atol, rtol = tol
    read = ((skip - ref).abs() / (atol + rtol * ref.abs())).amax((1, 2, 4))
    tile_live = (torch.arange(nt, device=q.device)[None, :] * T
                 < kv_len.reshape(B, 1))
    rows, tiles = tile_live.nonzero(as_tuple=True)
    return list(zip(read[rows, tiles].tolist(), rows.tolist(),
                    tiles.tolist()))


def check_decode_kernel(torch, dev, spec: Spec):
    """Phase 2, flash decoding (B6): the kernel against its plain version on
    the card at the decode path's shape (the model's heads, B = spec.dec_b,
    S = DEC_S; bf16, and in f32) and at the model's extra cases (qwen1.5-
    0.5b: a ragged, a GQA and a head_dim-32 softcap shape; granite-3-8b:
    rows ending inside a key tile and on chunk boundaries); the bf16 limit
    beside the readings of kernels that skip one live key tile of a row;
    the launch plan; times with an SDPA yardstick over the live slots;
    live-slot bounds."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.runtime.hw import H100_SXM as chip

    from repro_torch.configs import get_config
    cfg = get_config(spec.arch)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    rng = np.random.default_rng(SEED + 9)
    B = spec.dec_b
    # (label, B, S, H, KV, d, kv_len, softcap)
    cases = [("decode_path", B, DEC_S, cfg.num_heads, cfg.num_kv_heads,
              cfg.head_dim, [DEC_S] * B, 0.0)] + list(spec.extra_dec)
    out = {}
    for label, B, S, H, KV, d, lens, cap in cases:
        if lens == "ragged":         # an empty, a short and a full row
            lens = [1, 1000, 10923, S] + rng.integers(1, S + 1,
                                                      B - 4).tolist()
        elif lens == "tiles":        # ends inside a tile, on chunk edges
            c = decode_plan(dev, B, S, H, KV, d, torch.bfloat16).chunk
            t = da.KEY_TILE
            lens = [1, t + 1, c, c + 37, 2 * c, 2 * c + 1, S - 37, S][:B]
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        errs = {}
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, DEC_BF16_TOL)):
            q = torch.randn((B, 1, H, d), generator=gen, device=dev).to(dtype)
            k, v = (torch.randn((B, S, KV, d), generator=gen, device=dev
                                ).to(dtype) for _ in range(2))
            got = da.decode_attention(q, k, v, kv_len, softcap=cap)
            want = da.decode_attention_plain(q, k, v, kv_len, softcap=cap)
            errs[dtype] = compare(torch, got, want, tol,
                                  f"decode_attention {label} {dtype}")
            if dtype == torch.float32:
                del q, k, v
        report_limit(torch, f"decode_attention[{label}]", got, want,
                     DEC_BF16_TOL, decode_skips(torch, q, k, v, kv_len, want,
                                                DEC_BF16_TOL, softcap=cap))
        del got, want
        live = decode_live(k, kv_len)
        nbytes = decode_bound_bytes(q, k, kv_len)
        pairs = live * H
        b_ms, b_by = bound(chip, 4.0 * d * pairs, nbytes)
        plan = decode_plan(dev, B, S, H, KV, d, q.dtype)
        print(f"bound decode_attention[{label}]: {nbytes} bytes (q, output, "
              f"kv_len and K/V over {live} live slots of {B * S}), {pairs} "
              f"live (q, slot) pairs over {H} heads -> {b_ms:.6f} ms "
              f"({b_by}); plan: kernel {plan.kernel}, {plan.per_sm} "
              f"resident blocks a SM, {plan.splits} splits of {plan.chunk} "
              f"slots, {plan.blocks} blocks, {plan.waves:.3f} waves; "
              f"kv_len {'S in every row' if min(lens) >= S else lens}",
              flush=True)
        qt = q.transpose(1, 2).contiguous()                 # (B, H, 1, d)
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        mask = None if min(lens) >= S else (
            torch.arange(S, device=dev)[None, :] < kv_len[:, None]
        )[:, None, None, :]

        def library(qt=qt, kt=kt, vt=vt, mask=mask, gqa=H != KV):
            # SDPA over the live slots (a boolean mask where rows are
            # ragged); it has no softcap, so that case has no yardstick
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=gqa)

        row = dict(
            max_abs_err=errs[torch.bfloat16],
            f32_err=errs[torch.float32],
            ms=time_ms(torch, lambda: da.decode_attention(q, k, v, kv_len,
                                                          softcap=cap)),
            plain_ms=time_ms(torch, lambda: da.decode_attention_plain(
                q, k, v, kv_len, softcap=cap)),
            library_ms=time_ms(torch, library) if not cap else None,
            bound_ms=b_ms, bound_by=b_by,
            shape=f"B={B} S={S} H={H} KV={KV} d={d} {label} bf16, live "
                  f"slots {live}/{B * S}, {plan.kernel} kernel, "
                  f"{plan.splits} splits of {plan.chunk}, {plan.per_sm} "
                  f"blocks a SM, {plan.waves:.3f} waves")
        report(f"decode_attention[{label}]", row)
        if label == "decode_path":
            out["decode_attention"] = row
        del q, k, v, kt, vt, qt
    return out


def report(name: str, row) -> None:
    lib, f32 = row["library_ms"], row["f32_err"]
    print(f"kernel {name} [{row['shape']}]: max_abs_err="
          f"{row['max_abs_err']:.3e} (f32 check: "
          f"{'n/a' if f32 is None else f'{f32:.3e}'}) ms={row['ms']:.4f} "
          f"plain_ms={row['plain_ms']:.4f} "
          f"library_ms={'n/a' if lib is None else f'{lib:.4f}'} "
          f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']})", flush=True)


# ---- phase 3: a full-width forward, kernels vs plain versions ----------------
def kernel_modules():
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     fused_mlp, rmsnorm)
    return {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
            "fused_mlp": fused_mlp, "decode_attention": decode_attention}


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel wrappers to their plain versions (the
    comparison run of this script only)."""
    mods = kernel_modules()
    saved = {name: getattr(m, name) for name, m in mods.items()}
    for name, m in mods.items():
        setattr(m, name, getattr(m, f"{name}_plain"))
    try:
        yield
    finally:
        for name, m in mods.items():
            setattr(m, name, saved[name])


def reset_launches() -> None:
    from repro_torch.core import compiled
    compiled.reset_launches()


def read_launches():
    """Launches per kernel (attention: the sum of its modes' counts), and
    of the attention kernel per mode."""
    from repro_torch.core import compiled
    return compiled.read_launches()


def kernel_launches(launches):
    """The kernels' totals (every attention mode counted once)."""
    return {k: launches[k] for k in kernel_modules()}


def per_forward(cfg, S: int = 0):
    """Launches of one forward over S tokens (0: at most one hybrid chunk):
    the MLP runs once a chunk of ``cfg.hybrid_chunk`` tokens."""
    chunks = -(-S // cfg.hybrid_chunk) if S and cfg.hybrid_chunk else 1
    return {"rmsnorm": 2 * cfg.num_layers + 1,
            "flash_attention": cfg.num_layers,
            "fused_mlp": cfg.num_layers * chunks, "decode_attention": 0}


def per_decode_step(cfg):
    return {"rmsnorm": 2 * cfg.num_layers + 1, "flash_attention": 0,
            "fused_mlp": cfg.num_layers, "decode_attention": cfg.num_layers}


def check_full_prefill(torch, dev, cfg, params) -> None:
    import numpy as np
    from repro_torch.models import transformer as tfm
    rng = np.random.default_rng(SEED)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 512)),
                           device=dev)
    reset_launches()
    with torch.no_grad():
        got, _ = tfm.prefill(params, cfg, {"tokens": toks}, kv_keep=512)
        torch.cuda.synchronize()
        if kernel_launches(read_launches()) != per_forward(cfg):
            fail(f"full prefill launches {read_launches()}, expected "
                 f"{per_forward(cfg)}")
        with plain_versions():
            want, _ = tfm.prefill(params, cfg, {"tokens": toks}, kv_keep=512)
        torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail("full prefill: non-finite logits")
    err = (got - want).abs()
    max_tol, mean_tol = logits_limits(want)
    print(f"full prefill S=512: logits std={want.std().item():.4f} "
          f"max|kernel-plain|={err.max().item():.4e} "
          f"mean={err.mean().item():.4e} (limits {max_tol:.4f}, {mean_tol:.4f}) "
          f"argmax {int(got.argmax())} vs {int(want.argmax())}", flush=True)
    if err.max().item() > max_tol or err.mean().item() > mean_tol:
        fail(f"full prefill logits disagree: max {err.max().item():.3e} "
             f"(<= {max_tol}), mean {err.mean().item():.3e} "
             f"(<= {mean_tol})")


def logits_limits(want):
    """Full-width logits limits (max |Δ|, mean |Δ|) for reference logits
    ``want``: LOGITS_MAX_TOL and LOGITS_MEAN_TOL, scaled by want's std over
    LOGITS_REF_STD where it passes it (a model whose logits are wider
    differs by as much more in the same bf16 rounding)."""
    scale = max(1.0, want.float().std().item() / LOGITS_REF_STD)
    return LOGITS_MAX_TOL * scale, LOGITS_MEAN_TOL * scale


def compare_rows(torch, got, want, what: str,
                 names=("kernel", "plain"), unit: str = "segment") -> None:
    """Per-segment logits, kernels against plain versions (or, with
    ``names``, any path against its reference): max and mean |Δ| within the
    full-width limits (``logits_limits`` of the reference), and the
    reference's argmax among the top 5 of ``got`` (an equal argmax means
    little at random init, where the top two of a vocabulary's logits often
    lie closer than bf16's rounding over the layers; the top-two gap is
    printed beside each)."""
    a, b = names
    max_tol, mean_tol = logits_limits(want)
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite logits")
    for n in range(got.shape[0]):
        err = (got[n] - want[n]).abs()
        a_want = int(want[n].argmax())
        top = got[n].topk(TOP_K).indices.tolist()
        two = want[n].topk(2).values
        rank = top.index(a_want) + 1 if a_want in top else None
        print(f"{what} {unit} {n}: max|{a}-{b}|={err.max().item():.4e} "
              f"mean={err.mean().item():.4e} (limits {max_tol:.4f}, "
              f"{mean_tol:.4f}) {b} argmax {a_want} at "
              f"{a} rank {rank if rank else f'>{TOP_K}'}, {b} top-two "
              f"gap {(two[0] - two[1]).item():.4e}", flush=True)
        if (err.max().item() > max_tol
                or err.mean().item() > mean_tol or rank is None):
            fail(f"{what} {unit} {n}: logits disagree")


def check_packed_forwards(torch, dev, spec: Spec, cfg, params) -> None:
    """Phase 3, packed: full-width ``prefill_packed`` (the segmented kernel
    shape) and ``prefill_packed_with_prefix`` (the positioned one, over
    prefix KV made by ``prefill``) through the kernels and through the plain
    versions; 2L+1/L/L launches per forward, every attention launch in the
    forward's mode."""
    import numpy as np
    from repro_torch.models import transformer as tfm
    rng = np.random.default_rng(SEED + 2)
    V, Lyr = cfg.vocab_size, cfg.num_layers

    def tokens(lens, S):
        toks = torch.zeros((1, S), dtype=torch.long)
        off = 0
        for L in lens:
            toks[0, off:off + L] = torch.from_numpy(rng.integers(0, V, L))
            off += L
        return toks.to(dev)

    lay, _ = packed_case(dev, SEG_LENS, SEG_S)
    toks = tokens(SEG_LENS, SEG_S)
    kv_idx = torch.nonzero(lay["seg_ids"][0] >= 0)[:, 0]

    def miss():
        return tfm.prefill_packed(params, cfg, toks, lay["seg_ids"],
                                  lay["positions"], lay["last_indices"],
                                  kv_indices=kv_idx)

    N, S = len(spec.plens), spec.hit_s
    hlay, _ = packed_case(dev, spec.slens, S, spec.plens, spec.pmax)
    htoks = tokens(spec.slens, S)
    shape = (Lyr, N, spec.pmax, cfg.num_kv_heads, cfg.head_dim)
    pk = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    pv = torch.zeros_like(pk)
    with torch.no_grad():
        for n, p in enumerate(spec.plens):
            ptoks = torch.as_tensor(rng.integers(0, V, (1, p)), device=dev)
            _, kv = tfm.prefill(params, cfg, {"tokens": ptoks}, kv_keep=p)
            pk[:, n:n + 1, :p] = kv["k"]
            pv[:, n:n + 1, :p] = kv["v"]

    def hit():
        return tfm.prefill_packed_with_prefix(
            params, cfg, htoks, hlay["positions"], hlay["last_indices"],
            {"k": pk, "v": pv}, hlay["prefix_pos"], hlay["seg_qidx"],
            kv_indices=torch.arange(S, device=dev))

    for name, fn, mode in (("prefill_packed", miss, "segmented"),
                           ("prefill_packed_with_prefix", hit,
                            "positioned")):
        reset_launches()
        with torch.no_grad():
            got, got_kv = fn()
            torch.cuda.synchronize()
            launches = read_launches()
            with plain_versions():
                want, want_kv = fn()
            torch.cuda.synchronize()
        if (kernel_launches(launches) != per_forward(cfg)
                or launches[f"flash_attention[{mode}]"] != Lyr):
            fail(f"{name} launches {launches}, expected {per_forward(cfg)} "
                 f"with every attention launch {mode}")
        kv_err = max((got_kv[k].float() - want_kv[k].float()).abs().max()
                     .item() for k in ("k", "v"))
        what = f"full {name} {cfg.dtype}"
        print(f"{what}: {got.shape[0]} segments, logits std="
              f"{want.std().item():.4f}, gathered KV max|kernel-plain|="
              f"{kv_err:.4e}", flush=True)
        compare_rows(torch, got, want, what)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ---- phase 4: the main path --------------------------------------------------
def run_engine(torch, dev, spec: Spec, cfg, params):
    import numpy as np
    from repro_torch.core.engine import EngineConfig, PrefillOnlyEngine
    rng = np.random.default_rng(SEED + 1)
    users = [rng.integers(0, cfg.vocab_size, PROFILE_LEN).tolist()
             for _ in range(2)]
    trace = [users[i % 2] + rng.integers(0, cfg.vocab_size,
                                         POST_LEN).tolist()
             for i in range(6)]              # A1 B1 (misses) A2 B2 A3 B3

    eng = PrefillOnlyEngine(cfg, params, EngineConfig(
        max_pack_requests=1, cache_capacity_tokens=8192), device=dev)
    reset_launches()                         # the main path starts here
    t0 = time.perf_counter()
    r = eng.profile()
    print(f"{cfg.name} profile run: {time.perf_counter() - t0:.2f} s, JCT ~ "
          f"{eng.jct_model.a * 1e3:.6f} ms/token + "
          f"{eng.jct_model.b * 1e3:.3f} ms (pearson {r:.4f}; slope and "
          f"pearson >= {FIT_PEARSON}: {fit_ok(eng.jct_model)})", flush=True)
    served = []
    for toks in trace + trace:               # pass 2 reuses each whole chain
        rid = eng.submit(toks, allowed_tokens=(YES, NO))
        if eng.step() != rid:
            fail("the engine served another request than the one queued")
        res, rec = eng.results[rid], eng.batch_records[-1]
        served.append((toks, res, rec))
        print(f"{cfg.name} step n_input={res['n_input']} "
              f"n_cached={res['n_cached']} "
              f"S={rec.S} P={rec.pmax} wall_ms={rec.wall * 1e3:.3f} "
              f"first_use={rec.compiled} graph={graph_use(rec)} "
              f"P(yes)={res['scores'].get(YES)}", flush=True)
    torch.cuda.synchronize()
    launches = read_launches()               # the main path ends here
    expect = {k: v * eng.forwards for k, v in per_forward(cfg).items()}
    print(f"{cfg.name} launches over {eng.forwards} forwards: {launches} "
          f"(expected {expect})", flush=True)
    if kernel_launches(launches) != expect or (
            launches["flash_attention[segmented]"]
            or launches["flash_attention[positioned]"]):
        fail("the main path did not launch every kernel once per use")

    cached = [res["n_cached"] for _, res, _ in served]
    if cached[:2] != [0, 0] or min(cached[2:]) <= 0:
        fail(f"expected two misses then hits, n_cached={cached}")
    for _, res, _ in served:
        if "corrupt" in res or not all(np.isfinite(list(
                res["scores"].values()))):
            fail(f"non-finite scores: {res}")
    # every hit of both passes (two (S, P) shapes) against a cold engine's
    # scores for the same tokens; pass 2 repeats pass 1's token lists
    cold = PrefillOnlyEngine(cfg, params, EngineConfig(
        max_pack_requests=1, cache_capacity_tokens=0), device=dev)
    cold_scores, worst = {}, {}
    for toks, res, rec in served[2:]:
        key = tuple(toks)
        if key not in cold_scores:
            rid = cold.submit(toks, allowed_tokens=(YES, NO))
            cold.step()
            ref = cold.results[rid]
            if ref["n_cached"] != 0:
                fail("the cold engine hit its cache")
            cold_scores[key] = ref["scores"]
        diff = max(abs(cold_scores[key][t] - res["scores"][t])
                   for t in (YES, NO))
        shape = (rec.S, rec.pmax)
        worst[shape] = max(worst.get(shape, 0.0), diff)
    print(f"{cfg.name} hits vs cold engine, max |score diff| per (S, P): "
          f"{worst} (gate {SCORE_GATE})", flush=True)
    if len(worst) < 2 or max(worst.values()) >= SCORE_GATE:
        fail("prefix-cache hit scores disagree with a cold engine, or the "
             "hits did not cover both passes' shapes")
    warm = {}
    for rec in eng.batch_records:
        if not rec.compiled:
            warm.setdefault((rec.S, rec.pmax), []).append(rec.wall * 1e3)
    for (S, P), walls in sorted(warm.items()):
        eager = (f"; eager median {spec.eager_ms[('solo', S, P)]} ms"
                 if ("solo", S, P) in spec.eager_ms else "")
        print(f"{cfg.name} step latency S={S} P={P}: warm wall median "
              f"{statistics.median(walls):.3f} ms, max {max(walls):.3f} ms "
              f"(n={len(walls)}{eager})", flush=True)
    trace_steps(torch, eng, cfg, rng, warm_medians(eng))
    report_graphs(torch, eng, f"{cfg.name} solo engine")
    return launches


def run_packed_engine(torch, dev, spec: Spec, cfg, params):
    """Phase 5: the packed path. Packing on (the reference's defaults, and
    the profile run's autotune); each round brings four new users whose
    profiles (``spec.plens`` tokens, cut in proportion where the two
    longest exceed the autotuned token budget, as are the hit pmax the
    phase requires) arrive as one wave of misses, then
    waves of their prefix-cache hits (``spec.slens``-token posts). A solo
    engine on the same weights serves the same waves; every score must
    agree. Then the kernels are held to their plain versions at the
    packed-miss layouts the engine ran (``check_path_layouts``)."""
    import numpy as np
    from repro_torch.core.engine import EngineConfig, PrefillOnlyEngine
    rng = np.random.default_rng(SEED + 3)
    V = cfg.vocab_size

    eng = PrefillOnlyEngine(cfg, params, EngineConfig(
        cache_capacity_tokens=65536), device=dev)
    reset_launches()                         # the packed path starts here
    eng.profile()
    # the profiles, cut (to multiples of 64) so that the two longest fit
    # one pack under the budget autotune set from this run's fit: qwen's
    # fit, mostly fixed cost, sets 2048 tokens in most runs and 1024 in
    # some, where two of its profiles never fit one pack
    budget = eng.ecfg.pack_token_budget
    scale = min(1.0, budget / sum(sorted(spec.plens)[-2:]))
    plens = tuple(max(64, int(p * scale) // 64 * 64) for p in spec.plens)
    hit_pmax = int(spec.hit_pmax * scale)
    print(f"{cfg.name} packed engine: profile fit "
          f"{eng.jct_model.a * 1e3:.6f} ms/token + "
          f"{eng.jct_model.b * 1e3:.3f} ms (pearson "
          f"{eng.jct_model.pearson_r:.4f}); autotuned pack_token_budget="
          f"{budget} max_pack_requests="
          f"{eng.ecfg.max_pack_requests} pack_prefix_budget="
          f"{eng.ecfg.pack_prefix_budget}; profiles {plens} (set "
          f"{spec.plens}, cut by {scale:g} to the budget)", flush=True)

    def round_waves(n_hit_waves: int):
        users = [rng.integers(0, V, p).tolist() for p in plens]
        waves = [("miss", users)]
        for _ in range(n_hit_waves):
            waves.append(("hit", [u + rng.integers(0, V, s).tolist()
                                  for u, s in zip(users, spec.slens)]))
        return waves

    waves = round_waves(2) + round_waves(2)
    def serve(engine, reqs):
        ids = [engine.submit(t, allowed_tokens=(YES, NO)) for t in reqs]
        recs = []
        while engine.queue:
            engine.step()
            recs.append(engine.batch_records[-1])
        return [engine.results[i] for i in ids], recs

    packed = []
    for kind, reqs in waves:
        got, precs = serve(eng, reqs)
        packed.append((kind, got, precs))
        for rec in precs:
            print(f"{cfg.name} packed step kind={rec.kind} "
                  f"n={rec.n_requests} S={rec.S} "
                  f"Nb={rec.Nb} smax={rec.smax} pmax={rec.pmax} K={rec.K} "
                  f"wall_ms={rec.wall * 1e3:.3f} first_use={rec.compiled} "
                  f"graph={graph_use(rec)}", flush=True)
    torch.cuda.synchronize()
    launches = read_launches()               # the packed path ends here
    # each packed miss step's layout: S slots, its requests' lengths
    miss_layouts = {(r.S, tuple(eng.results[i]["n_input"]
                                for i in r.req_ids))
                    for r in eng.batch_records if r.kind == "miss"}
    # the same waves through a solo engine (after the count was read)
    solo = PrefillOnlyEngine(cfg, params, EngineConfig(
        max_pack_requests=1, cache_capacity_tokens=65536), device=dev)
    served = []
    for (kind, got, precs), (_, reqs) in zip(packed, waves):
        want, srecs = serve(solo, reqs)
        served.append((kind, got, want, precs, srecs))
    kinds = [r.kind for r in eng.batch_records]
    n_miss, n_hit = kinds.count("miss"), kinds.count("hit")
    expect = {k: v * eng.forwards for k, v in per_forward(cfg).items()}
    print(f"{cfg.name} packed engine launches over {eng.forwards} forwards "
          f"({n_miss} packed-miss, {n_hit} packed-hit, "
          f"{eng.forwards - n_miss - n_hit} solo incl. profile): {launches}",
          flush=True)
    Lyr = cfg.num_layers
    if (kernel_launches(launches) != expect
            or launches["flash_attention[segmented]"] != Lyr * n_miss
            or launches["flash_attention[positioned]"] != Lyr * n_hit):
        fail("the packed path did not launch every kernel once per use, in "
             "its forward's mode")
    for kind in ("miss", "hit"):
        if not any(r.kind == kind and r.n_requests > 1
                   for r in eng.batch_records):
            fail(f"no packed {kind} step with more than one request ran")
    if not any(r.kind == "hit" and r.Nb >= spec.hit_nb
               and hit_pmax in (0, r.pmax) for r in eng.batch_records):
        fail(f"no packed hit step with Nb >= {spec.hit_nb} and pmax = "
             f"{hit_pmax or 'any'}")

    worst = 0.0
    for kind, got, want, _, _ in served:
        for g, w in zip(got, want):
            if g["n_cached"] != w["n_cached"] or "corrupt" in g:
                fail(f"packed vs solo: {g} vs {w}")
            worst = max(worst, max(abs(g["scores"][t] - w["scores"][t])
                                   for t in (YES, NO)))
    print(f"{cfg.name} packed engine vs solo engine, max |score diff| over "
          f"{sum(len(g) for _, g, _, _, _ in served)} requests: "
          f"{worst:.3e} (gate {SCORE_GATE}); stats: "
          f"{ {k: eng.stats()[k] for k in ('packed_steps', 'packed_requests', 'packed_hit_requests', 'pack_skew_splits')} }",
          flush=True)
    if worst >= SCORE_GATE:
        fail("packed scores disagree with the solo engine's")
    check_path_layouts(torch, dev, spec, cfg, miss_layouts)

    # warm packed step walls per shape beside the solo walls of the same
    # requests (a wave counts on the solo side only when all its solo steps
    # were warm)
    table = {}
    for kind, _, _, precs, srecs in served:
        solo_ms = (sum(r.wall for r in srecs) * 1e3
                   if not any(r.compiled for r in srecs) else None)
        for rec in precs:
            key = (rec.kind, rec.S, rec.Nb, rec.smax, rec.pmax)
            row = table.setdefault(key, ([], []))
            if not rec.compiled:
                row[0].append(rec.wall * 1e3)
        if solo_ms is not None:
            table.setdefault(("wave", kind), ([], []))[1].append(
                (solo_ms, sum(r.wall for r in precs) * 1e3,
                 all(not r.compiled for r in precs)))
    for key, (walls, _) in sorted((k, v) for k, v in table.items()
                                  if k[0] != "wave"):
        if walls:
            eager = (f"; eager median of the packed {key[0]} steps "
                     f"{spec.eager_ms[(key[0],)]} ms"
                     if (key[0],) in spec.eager_ms else "")
            print(f"{cfg.name} packed step latency kind={key[0]} S={key[1]} "
                  f"Nb={key[2]} smax={key[3]} pmax={key[4]}: warm wall "
                  f"median {statistics.median(walls):.3f} ms, max "
                  f"{max(walls):.3f} ms (n={len(walls)}{eager})", flush=True)
    for kind in ("miss", "hit"):
        pairs = [(s, p) for s, p, warm in table.get(("wave", kind),
                                                    ([], []))[1] if warm]
        if pairs:
            print(f"{cfg.name} wave of 4 {kind} requests: packed steps summed,"
                  f" warm "
                  f"median "
                  f"{statistics.median(p for _, p in pairs):.3f} ms vs solo "
                  f"steps summed {statistics.median(s for s, _ in pairs):.3f}"
                  f" ms (n={len(pairs)} waves)", flush=True)

    # one more warm packed-miss step and packed-hit step, traced
    medians = warm_medians(eng)
    for kind, reqs in round_waves(1):
        for t in reqs:
            eng.submit(t, allowed_tokens=(YES, NO))
        trace_one_step(torch, eng, kind, medians, packed=True)
    report_graphs(torch, eng, f"{cfg.name} packed engine")
    return launches


# ---- the engine's CUDA graphs and Algorithm 1's order ------------------------
def graph_use(rec) -> str:
    """Whether a step captured its forward's graph (first use) or replayed
    it."""
    return "captured" if rec.compiled else "replayed"


def replay_launches(torch, f, tries: int = 3, replays: int = 3):
    """Wrapper launches in one replay of compiled forward ``f``'s graph,
    counted from the device kernels ``torch.profiler`` records
    (``KERNEL_CALLS``). Now and then the profiler loses a leading run of a
    session's device events (on the H100 about 2 sessions in 60, whether
    the work was eager, a graph replay, or came after a spin kernel or a
    warm-up step; ``PERF.md`` §6), and a granite packed-miss session read
    80 of its 81 norms three times in a row. So each session replays the
    graph ``replays`` times, a spin kernel between replays; the device
    events, in order of start, are split at the spins into one count per
    replay, and the first replay that reads what the capture counted is
    the answer. Up to ``tries`` sessions are profiled, each short reading
    printed. A graph that lacks a kernel matches in none, and a whole
    replay that reads more than its capture fails at once."""
    from torch.profiler import ProfilerActivity, profile
    want = {k: f.launches[k] for k in kernel_modules()}
    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(replays):
                if i:
                    torch.cuda._sleep(SPIN_CYCLES)
                f.graph.replay()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        readings = [dict.fromkeys(kernel_modules(), 0.0)]
        for e in evs:
            if "spin_kernel" in e.name:
                readings.append(dict.fromkeys(kernel_modules(), 0.0))
                continue
            for name, wrapper, per_call in KERNEL_CALLS:
                if name in e.name:
                    readings[-1][wrapper] += 1 / per_call
                    break
        # a reading after a recorded spin is a whole replay; the first
        # may have lost its head, or run into the second if the lost
        # head took the first spin too
        if readings[0] == want:
            return readings[0]
        for counts in readings[1:]:
            if counts == want or any(counts[k] > want[k] for k in want):
                return counts
        print(f"graph {f.name}: profiled session {attempt + 1} of {tries} "
              f"read {readings} over {replays} replays, its capture "
              f"counted {want}", flush=True)
    return readings[-1]


def report_graphs(torch, eng, label: str) -> None:
    """``graph`` lines of one engine: each graph's key, capture ms, what
    its capture added to the engine's pool, what it holds between steps,
    and the wrapper launches one profiled replay of it made; the totals,
    the engine's prefix buffer and ``torch.cuda.memory_reserved()`` after
    the phase. Fails unless every graph replayed, every profiled replay
    launched each kernel as often as its capture counted (the counts the
    engine adds per replay), the live graphs hold no more than the
    engine's budget and one graph, and the pool is shared: at most what
    the graphs hold plus the largest single capture's growth (one
    forward's temporaries), with POOL_SLACK of segment rounding a graph."""
    graphs = eng.graphs()
    pool = sum(f.pool_bytes for f in graphs)
    held = [f.held_bytes for f in graphs]
    biggest = max((f.pool_bytes for f in graphs), default=0)
    limit = sum(held) + biggest + POOL_SLACK * len(graphs)
    if not graphs or any(f.graph is None or not f.replays for f in graphs):
        fail(f"{label}: a forward was not captured or never replayed")
    for f in graphs:
        got = replay_launches(torch, f)
        want = {k: f.launches[k] for k in kernel_modules()}
        print(f"graph {label}: {f.name}: capture {f.capture_ms:.1f} ms, "
              f"pool +{f.pool_bytes} bytes, held {f.held_bytes} bytes, "
              f"replays {f.replays}, profiled replay launched {got} "
              f"(captured {want})", flush=True)
        if got != want:
            fail(f"{label}: a replay of {f.name} launched {got}, its "
                 f"capture counted {want}")
    budget = eng.ecfg.graph_memory_bytes
    print(f"graph {label}: {len(graphs)} graphs live, captured in "
          f"{sum(f.capture_ms for f in graphs):.1f} ms; held {sum(held)} "
          f"bytes (budget {budget}); prefix buffer "
          f"{eng.prefix_store_bytes()} bytes; pool {pool} bytes (limit "
          f"{limit}: held {sum(held)} + largest capture {biggest} + slack); "
          f"memory_reserved {torch.cuda.memory_reserved()} bytes",
          flush=True)
    if sum(held) > budget + max(held):
        fail(f"{label}: the graphs hold {sum(held)} bytes, past the budget")
    if pool > limit:
        fail(f"{label}: the graphs do not share one pool")


def fit_ok(m) -> bool:
    """A fit with a slope (not clamped to 1e-12) and pearson >= 0.9."""
    return m.a > 1e-12 and m.pearson_r >= FIT_PEARSON


def run_order(torch, dev, cfg, params) -> None:
    """Algorithm 1 orders requests by length on the card (ROADMAP C7). A
    solo engine (``max_pack_requests=1``, ``srjf_calibrated``, lambda 0.05;
    autotune off, so the profile leaves it solo) reads its profile fit at
    LONG_LENGTHS and at the default lengths, printing both, and keeps the
    default fit unless only the long one has a slope and pearson >= 0.9.
    Then five fresh, unrelated requests of ORDER_LENS tokens arrive about
    1 ms apart, longest first; the engine must serve them shortest first."""
    import numpy as np
    from repro_torch.core.engine import EngineConfig, PrefillOnlyEngine
    eng = PrefillOnlyEngine(cfg, params, EngineConfig(
        max_pack_requests=1, autotune_pack=False), device=dev)
    fits = {}
    for name, lengths in (("lengths up to 2048", LONG_LENGTHS),
                          ("default lengths", None)):
        t0 = time.perf_counter()
        if lengths is None:
            eng.profile()
        else:
            eng.profile(lengths)
        m = eng.jct_model
        fits[name] = (m.a, m.b, m.pearson_r, fit_ok(m))
        print(f"profile fit ({name}): {m.a * 1e3:.6f} ms/token + "
              f"{m.b * 1e3:.3f} ms, pearson {m.pearson_r:.4f}, slope and "
              f"pearson >= {FIT_PEARSON}: {fit_ok(m)} "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
    if not fit_ok(eng.jct_model):
        if not fits["lengths up to 2048"][3]:
            fail("the profile fit has no slope, or pearson < "
                 f"{FIT_PEARSON}, at either ladder: {fits}")
        eng.profile(LONG_LENGTHS)
    rng = np.random.default_rng(SEED + 7)
    ids = {}
    for n in ORDER_LENS:
        ids[eng.submit(rng.integers(0, cfg.vocab_size, n).tolist(),
                       allowed_tokens=(YES, NO))] = n
        time.sleep(1e-3)
    served = [ids[i] for i in eng.run_until_drained()]
    m = eng.jct_model
    print(f"order: submitted {list(ORDER_LENS)} (about 1 ms apart), served "
          f"{served}; fit {m.a * 1e3:.6f} ms/token + {m.b * 1e3:.3f} ms "
          f"(pearson {m.pearson_r:.4f}), lambda {eng.ecfg.lam}; walls "
          f"{[round(r.wall * 1e3, 3) for r in list(eng.batch_records)[-5:]]}"
          f" ms", flush=True)
    if served != sorted(ORDER_LENS):
        fail(f"Algorithm 1 served {served}, not shortest first")
    report_graphs(torch, eng, "order engine")


def run_graph_memory(torch, dev, cfg, params) -> None:
    """The compiled forwards' memory stays bounded however many shape keys
    the traffic brings. A solo engine with ``graph_memory_bytes`` =
    GRAPH_BUDGET serves one user's MEMORY_PROFILE-token profile, then hits
    on it at each of MEMORY_PLENS prefix lengths (a new suffix graph each),
    then the first three again (recaptured if they were dropped). Fails
    unless graphs were dropped, device memory never grew past what it held
    after the first hit by more than the budget, one hit graph, twice the
    prefix buffer (the buffers it grew from, which older graphs may still
    read, hold less than it) and POOL_SLACK, the prefix buffer holds at
    most twice the longest prefix, and the repeated hits scored as the
    first time."""
    import numpy as np
    from repro_torch.core.engine import EngineConfig, PrefillOnlyEngine
    rng = np.random.default_rng(SEED + 9)
    user = rng.integers(0, cfg.vocab_size, MEMORY_PROFILE).tolist()
    eng = PrefillOnlyEngine(cfg, params, EngineConfig(
        max_pack_requests=1, cache_capacity_tokens=4 * MEMORY_PROFILE,
        graph_memory_bytes=GRAPH_BUDGET), device=dev)
    plens = MEMORY_PLENS + MEMORY_PLENS[:3]
    reqs = [user] + [user[:p + 40] for p in plens]
    scores, allocated, keys, biggest = [], [], set(), 0
    for i, t in enumerate(reqs):
        rid = eng.submit(t, allowed_tokens=(YES, NO))
        eng.step()
        torch.cuda.synchronize()
        rec, res = eng.batch_records[-1], eng.results[rid]
        scores.append(res["scores"])
        allocated.append(torch.cuda.memory_allocated())
        keys.add((rec.jit_path, rec.jit_key))
        if i:
            biggest = max([biggest] + [f.held_bytes for f in eng.graphs()])
    served = [r.pmax for r in list(eng.batch_records)[1:]]
    base = allocated[1]
    grew = max(allocated[1:]) - base
    store = 2 * eng._prefix_store["k"].nbytes
    alive = eng.prefix_store_bytes()
    want_store = 2 * (cfg.num_layers * max(MEMORY_PLENS) * cfg.num_kv_heads
                      * cfg.head_dim * eng._prefix_store["k"].element_size())
    diff = max(abs(scores[1 + i][t] - scores[1 + len(MEMORY_PLENS) + i][t])
               for i in range(3) for t in (YES, NO))
    limit = GRAPH_BUDGET + biggest + 2 * store + POOL_SLACK
    print(f"graph memory: {len(keys)} shape keys served, {len(eng.graphs())}"
          f" graphs live (budget {GRAPH_BUDGET} bytes, held "
          f"{eng.graph_bytes()}); prefixes {served}; memory_allocated grew "
          f"{grew} bytes after the first hit (limit {limit}); prefix buffer "
          f"{store} bytes (longest prefix {want_store} bytes; all buffers "
          f"alive {alive}); "
          f"memory_reserved {torch.cuda.memory_reserved()} bytes; repeated "
          f"hits' max |score diff| {diff:.3e}", flush=True)
    if served != list(plens) or len(eng.graphs()) >= len(keys):
        fail("graph memory: the hits did not run at every prefix length, "
             "or no graph was dropped")
    if grew > limit:
        fail(f"graph memory: device memory grew {grew} bytes")
    if not (want_store <= store <= 2 * want_store and alive < 2 * store):
        fail(f"graph memory: prefix buffer of {store} bytes")
    if diff >= SCORE_GATE:
        fail("graph memory: a recaptured graph scored another way")


def graph_traces(vocab: int):
    """The graph tests' traces (``tests/test_torch_graphs.py`` on the CPU,
    ``tests/test_torch_cuda.py`` on the card): per path, engine settings and
    waves of requests, a longer request (or pack) then a shorter one under
    the same shape key, two steps in a row."""
    import numpy as np
    rng = np.random.default_rng(3)

    def toks(n):
        return rng.integers(0, vocab, n).tolist()

    profiles = [toks(n) for n in (128, 64, 128)]
    return {
        "fresh": (dict(max_pack_requests=1, cache_capacity_tokens=0),
                  [[toks(60)], [toks(40)], [toks(52)]]),
        "suffix": (dict(max_pack_requests=1),
                   [[profiles[0] + toks(20)], [profiles[0] + toks(30)],
                    [profiles[0] + toks(12)]]),
        "packed_miss": (dict(), [[toks(60), toks(50)], [toks(55), toks(45)],
                                 [toks(30), toks(25), toks(20)]]),
        "packed_hit": (dict(), [[p + toks(8) for p in profiles],
                                [p + toks(s) for p, s in zip(profiles,
                                                             (20, 12, 30))],
                                [p + toks(s) for p, s in zip(profiles,
                                                             (15, 10, 25))]]),
    }


# ---- phase 6: the dense decode path ------------------------------------------
def run_decode(torch, dev, spec: Spec, cfg, params):
    """Full-width decode through ``build(cfg)``: the consistency check at
    B=2, then the depth run at B=spec.dec_b, S=32768. Returns the depth
    run's launches (its 8 steps are the decode path's counted run)."""
    from repro_torch.models.model import build
    api = build(cfg)
    check_decode_consistency(torch, dev, api, params)
    gc.collect()
    torch.cuda.empty_cache()
    return run_decode_depth(torch, dev, api, params, spec.dec_b)


def check_decode_consistency(torch, dev, api, params) -> None:
    """``prefill`` of DEC_PREFIX tokens fills an ``init_cache(2, 2048)``;
    DEC_STEPS ``decode_step``s then feed the next tokens of a seeded
    sequence, and each step's logits are held against ``prefill`` of the
    sequence up to that token — through the kernels, then through the
    plain versions — within the full-width logits limits, with the
    prefill's argmax in the decode's top 5."""
    import numpy as np
    cfg = api.cfg
    B, P = DEC_CONS_B, DEC_PREFIX
    rng = np.random.default_rng(SEED + 4)
    seq = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                       (B, P + DEC_STEPS)), device=dev)
    for route in ("kernels", "plain"):
        ctx = plain_versions() if route == "plain" else contextlib.nullcontext()
        with torch.no_grad(), ctx:
            cache = api.init_cache(B, 2 * P, device=dev)
            _, kv = api.prefill(params, {"tokens": seq[:, :P]}, kv_keep=P)
            for n in ("k", "v"):
                cache[n][:, :, :P] = kv[n]
            del kv
            for i in range(DEC_STEPS):
                pos = torch.full((B,), P + i, dtype=torch.int32, device=dev)
                reset_launches()
                got, cache = api.decode_step(params, seq[:, P + i], cache, pos)
                launches = kernel_launches(read_launches())
                want, _ = api.prefill(params, {"tokens": seq[:, :P + i + 1]})
                torch.cuda.synchronize()
                expect = (per_decode_step(cfg) if route == "kernels"
                          else dict.fromkeys(kernel_modules(), 0))
                if launches != expect:
                    fail(f"decode step ({route}) launches {launches}, "
                         f"expected {expect}")
                compare_rows(torch, got, want,
                             f"{cfg.name} decode vs prefill ({route}) step "
                             f"{i} position {P + i}",
                             names=("decode", "prefill"), unit="row")


def run_decode_depth(torch, dev, api, params, B: int):
    """DEC_STEPS decode steps at positions S-8..S-1 of an
    ``init_cache(B, 32768)`` (48 GiB of bf16 KV at qwen1.5-0.5b's B = 16,
    40 GiB at granite-3-8b's B = 8) filled from a seeded generator one layer
    at a time in bf16: per-step launches (2L+1/L/L, no flash attention),
    finite logits, the written slot new and finite in every layer while
    every other slot keeps its f32 checksum, and the peak memory of each
    step under cache + weights + 1 GiB (no cache copy). Prints the warm
    step wall, tokens/s and one traced warm step."""
    import numpy as np
    cfg = api.cfg
    S, Lyr = DEC_S, cfg.num_layers
    P0 = S - DEC_STEPS
    cache = api.init_cache(B, S, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    with torch.no_grad():
        for n in ("k", "v"):
            for layer in range(Lyr):
                cache[n][layer].normal_(generator=gen)
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    weight_bytes = sum(a.numel() * a.element_size() for a in _leaves(params))
    names = ("k", "v")

    def checksums():
        """Per (k/v, layer): f32 sum of slots [0, P0), and per-slot f32 sums
        of slots [P0, S)."""
        head = torch.stack([cache[n][layer, :, :P0].sum(dtype=torch.float32)
                            for n in names for layer in range(Lyr)])
        tail = torch.stack([cache[n][layer, :, P0:].sum(
            dim=(0, 2, 3), dtype=torch.float32)
            for n in names for layer in range(Lyr)])
        return head, tail

    head0, tail0 = checksums()
    prev_tail = tail0
    rng = np.random.default_rng(SEED + 6)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (DEC_STEPS + 1, B)),
                           dtype=torch.long, device=dev)
    torch.cuda.synchronize()
    print(f"{cfg.name} decode depth: init_cache({B}, {S}) {cache_bytes} "
          f"bytes of "
          f"{cfg.dtype} KV, weights {weight_bytes} bytes, allocated "
          f"{torch.cuda.memory_allocated()} bytes after the fill", flush=True)
    walls, peak = [], 0
    reset_launches()                         # the decode path starts here
    for i in range(DEC_STEPS):
        p = P0 + i
        old = torch.stack([cache[n][:, :, p] for n in names])
        pos = torch.full((B,), p, dtype=torch.int32, device=dev)
        before = kernel_launches(read_launches())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, out = api.decode_step(params, toks[i], cache, pos)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        peak = max(peak, torch.cuda.max_memory_allocated())
        step = {k: v - before[k] for k, v in
                kernel_launches(read_launches()).items()}
        if step != per_decode_step(cfg):
            fail(f"decode step {i} launches {step}, expected "
                 f"{per_decode_step(cfg)}")
        if out is not cache or not torch.isfinite(logits).all():
            fail(f"decode step {i}: cache not returned in place, or "
                 f"non-finite logits")
        new = torch.stack([cache[n][:, :, p] for n in names])
        head, tail = checksums()
        changed = (new != old).flatten(2).any(-1)          # (k/v, layer)
        if not (changed.all() and torch.isfinite(new).all()):
            fail(f"decode step {i}: slot {p} not rewritten with finite "
                 f"values in every layer")
        if not (torch.equal(head, head0)
                and torch.equal(tail[:, :i], prev_tail[:, :i])
                and torch.equal(tail[:, i + 1:], tail0[:, i + 1:])):
            fail(f"decode step {i}: a slot other than {p} changed")
        prev_tail = tail
    launches = read_launches()               # the decode path ends here
    limit = cache_bytes + weight_bytes + (1 << 30)
    print(f"{cfg.name} decode depth: {DEC_STEPS} steps at positions "
          f"{P0}..{S - 1}, "
          f"launches {kernel_launches(launches)} ({per_decode_step(cfg)} "
          f"per step); written slot new and finite in all {Lyr} layers, "
          f"other slots' checksums unchanged; peak allocated over the steps "
          f"{peak} bytes (limit cache + weights + 1 GiB = {limit})",
          flush=True)
    if peak >= limit:
        fail("decode steps allocated more than cache + weights + 1 GiB: "
             "the cache was copied")
    warm = statistics.median(walls[1:])
    full_kv = 128 * S * cfg.kv_bytes_per_token()
    print(f"{cfg.name} decode step latency B={B} S={S}: step walls "
          f"{[round(w, 3) for w in walls]} ms; warm wall median {warm:.3f} ms "
          f"(n={len(walls) - 1}), {B / warm * 1e3:.1f} tokens/s "
          f"(decode_32k cut from B=128 to B={B}: its {full_kv / 2**30:.0f} "
          f"GiB of KV does not fit one 80 GB card)", flush=True)
    trace_decode_step(torch, api, params, cache, toks[DEC_STEPS], S - 1)
    return launches


def trace_decode_step(torch, api, params, cache, tokens, position) -> None:
    """One more warm decode step (rewriting slot ``position``), traced."""
    from torch.profiler import ProfilerActivity, profile
    pos = torch.full((tokens.shape[0],), position, dtype=torch.int32,
                     device=tokens.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.no_grad():
            api.decode_step(params, tokens, cache, pos)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # a GQA model's decode runs flash decoding's tensor-core kernel
    gqa = api.cfg.num_heads > api.cfg.num_kv_heads
    report_trace(torch, prof, f"{api.cfg.name} decode B={tokens.shape[0]} "
                 f"S={cache['k'].shape[2]}", wall,
                 expect=TC_DECODE + (("decode_split_tc_kernel",) if gqa
                                     else ()))


# ---- phase 8: the paper's evaluation layer on the card ------------------------
def run_long_inputs(torch, dev, spec: Spec, cfg, params):
    """Phase 8: the memory model and MIL at the card (a), long-S kernel
    rows, eager peaks against the model (b), a WL2-length request through
    the solo engine's CUDA graph (c), the roofline fitted to the engine's
    steps and, at qwen, a post-recommendation replay beside the
    simulator's prediction (d). Returns the launches of its engine runs
    (the 60,000-token steps and the replay's steps)."""
    from repro_torch.core.kv_policy import MemoryModel
    from repro_torch.runtime.hw import H100_SXM as chip
    t0 = time.perf_counter()
    mm = MemoryModel(cfg, chip)
    report_mil(torch, dev, cfg, mm)
    check_long_kernels(torch, dev, spec, cfg)
    check_peak_memory(torch, dev, spec, cfg, params, mm)
    launches, samples = run_long_request(torch, dev, spec, cfg, params, mm)
    roof = calibrate_roofline(cfg, samples)
    if spec.extra_phases:
        gc.collect()
        torch.cuda.empty_cache()
        more = run_replay(torch, dev, cfg, params, mm, roof)
        launches = {k: launches.get(k, 0) + more.get(k, 0)
                    for k in set(launches) | set(more)}
    print(f"{cfg.name} phase 8 took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches


def report_mil(torch, dev, cfg, mm) -> None:
    """(a) The closed-form MIL and prefix budgets at the H100; the card's
    reported memory against the constant (within 1%); a pinned host-to-
    device copy's rate beside the link's."""
    chip = mm.chip
    print(f"{cfg.name} MIL at {chip.name} ({chip.hbm_bytes} bytes x "
          f"utilization {mm.utilization}, weights {mm.weights_bytes:.0f} "
          f"bytes): {mm.mil_table()}; prefix_budget_tokens at WL1's "
          f"{WL1_MAX} / WL2's {WL2_MAX} tokens: "
          f"{mm.prefix_budget_tokens(WL1_MAX)} / "
          f"{mm.prefix_budget_tokens(WL2_MAX)}; bytes a token: one layer's "
          f"K/V + streams "
          f"{mm.kv_one_layer_per_token + mm.attn_stream_per_token:.0f}, "
          f"every layer's K/V {mm.kv_all_per_token:.0f}, MLP intermediates "
          f"{mm.mlp_int_per_token:.0f}", flush=True)
    total = torch.cuda.mem_get_info(dev)[1]
    off = total / chip.hbm_bytes - 1
    print(f"card memory: torch.cuda.mem_get_info total {total} bytes, "
          f"{chip.name} hbm_bytes {chip.hbm_bytes} ({off * 100:+.4f}%)",
          flush=True)
    if abs(off) > 0.01:
        fail(f"the card reports {total} bytes, not hbm_bytes within 1%")
    n = HOST_COPY_BYTES
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    buf = torch.empty(n, dtype=torch.uint8, device=dev)
    ms = []
    for i in range(7):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        buf.copy_(host, non_blocking=True)
        end.record()
        end.synchronize()
        if i >= 2:
            ms.append(start.elapsed_time(end))
    rate = n / (statistics.median(ms) * 1e-3)
    print(f"host->device: pinned copy of {n} bytes at {rate / 1e9:.3f} GB/s "
          f"(median of 5), {chip.name} host_bw {chip.host_bw / 1e9:.1f} GB/s "
          f"(PCIe Gen5 x16, one direction)", flush=True)


def check_long_kernels(torch, dev, spec: Spec, cfg) -> None:
    """B2, B5 and B1 at the long-input shapes the forwards below run: each
    kernel on the full (S, .) input, its last and first TAIL rows held
    against the plain version (attention's tail at ``q_offset`` S - TAIL
    over every key), timed beside its library call and its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.runtime.hw import H100_SXM as chip
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    bf16 = torch.bfloat16

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf16)

    S, H, KV, d = spec.long_lens[-1], cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    q, k, v = randn(1, S, H, d), randn(1, S, KV, d), randn(1, S, KV, d)
    got = fa.flash_attention(q, k, v)
    tail = compare(torch, got[:, -LONG_TAIL:], fa.flash_attention_plain(
        q[:, -LONG_TAIL:], k, v, q_offset=S - LONG_TAIL), ATTN_BF16_TOL,
        f"flash_attention causal S={S}, last {LONG_TAIL} rows")
    head = compare(torch, got[:, :LONG_TAIL], fa.flash_attention_plain(
        q[:, :LONG_TAIL], k[:, :LONG_TAIL], v[:, :LONG_TAIL]), ATTN_BF16_TOL,
        f"flash_attention causal S={S}, first {LONG_TAIL} rows")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    del got
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v), iters=10)
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=H != KV), iters=10)
    flops = 4.0 * d * H * S * (S + 1) / 2
    b_ms, b_by = bound(chip, flops, 2 * (2 * S * H * d + 2 * S * KV * d))
    splits, chunk = fa.split_rule(1, S, H, S, fa._sm_count(dev.index))
    print(f"long kernel flash_attention[causal S={S}] [B=1 H={H} KV={KV} "
          f"d={d} bf16, key split {splits}x{chunk} tiles]: max_abs_err last "
          f"/ first {LONG_TAIL} rows {tail:.3e} / {head:.3e}; ms={ms:.4f} "
          f"library_ms={lib:.4f} (SDPA) bound_ms={b_ms:.4f} ({b_by}); "
          f"{flops / ms * 1e-9:.1f} TFLOP/s, kernel / library "
          f"{ms / lib:.2f}", flush=True)
    del q, k, v, qt, kt, vt

    T, D, Fd = spec.long_lens[-1], cfg.d_model, cfg.d_ff
    x = randn(T, D)
    w = randn(D, std=0.1)
    got = rn.rmsnorm(x, w)
    tail = compare(torch, got[-LONG_TAIL:], rn.rmsnorm_plain(
        x[-LONG_TAIL:], w), BF16_TOL, f"rmsnorm T={T}, last rows")
    head = compare(torch, got[:LONG_TAIL], rn.rmsnorm_plain(
        x[:LONG_TAIL], w), BF16_TOL, f"rmsnorm T={T}, first rows")
    w1 = (1.0 + w.float()).to(bf16)
    b_ms, b_by = bound(chip, 4.0 * T * D, 2 * (2 * T * D + D))
    print(f"long kernel rmsnorm[T={T}] [D={D} bf16]: max_abs_err last / "
          f"first {LONG_TAIL} rows {tail:.3e} / {head:.3e}; ms="
          f"{time_ms(torch, lambda: rn.rmsnorm(x, w), iters=10):.4f} "
          f"library_ms={time_ms(torch, lambda: F.rms_norm(x, (D,), w1, 1e-6), iters=10):.4f} "
          f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
    wg, wu = randn(D, Fd, std=D ** -0.5), randn(D, Fd, std=D ** -0.5)
    wd = randn(Fd, D, std=Fd ** -0.5)
    got = fm.fused_mlp(x, wg, wu, wd)
    tail = compare(torch, got[-LONG_TAIL:], fm.fused_mlp_plain(
        x[-LONG_TAIL:], wg, wu, wd), MLP_BF16_TOL,
        f"fused_mlp T={T}, last rows")
    head = compare(torch, got[:LONG_TAIL], fm.fused_mlp_plain(
        x[:LONG_TAIL], wg, wu, wd), MLP_BF16_TOL,
        f"fused_mlp T={T}, first rows")
    del got
    b_ms, b_by = bound(chip, 6.0 * T * D * Fd, 2 * (2 * T * D + 3 * D * Fd))
    plan = fm.mlp_plan(T, D, Fd, fm._sm_count(dev.index))
    ms = time_ms(torch, lambda: fm.fused_mlp(x, wg, wu, wd), iters=5)
    lib = time_ms(torch, lambda: (F.silu(x @ wg) * (x @ wu)) @ wd, iters=5)
    print(f"long kernel fused_mlp[T={T}] [D={D} F={Fd} bf16, gate/up tile "
          f"{plan.gate_up}, {plan.splits} d_ff splits]: max_abs_err last / "
          f"first {LONG_TAIL} rows {tail:.3e} / {head:.3e}; ms={ms:.4f} "
          f"library_ms={lib:.4f} "
          f"bound_ms={b_ms:.4f} ({b_by}); kernel / library {ms / lib:.2f}",
          flush=True)


def check_peak_memory(torch, dev, spec: Spec, cfg, params, mm):
    """(b) Eager ``prefill`` at each S of ``spec.long_lens``, four ways:
    ``hybrid_chunk`` as configured and 0, ``kv_keep`` 0 and MEM_KEEP. The
    bytes allocated above what was held before the call (the weights) at
    its peak, fitted over S (slope, intercept) beside ``MemoryModel``'s
    (hybrid; discard where the chunk is 0) less the weights, fitted the
    same way. Fails unless the hybrid slope lies below the chunk-0 slope
    and within SLOPE_LIMIT of the model's, and each kept slice's bytes
    are MEM_KEEP (or S) tokens of every layer's K/V within KEPT_TOL.
    Returns the peaks by (chunk, kv_keep) and the (measured, model) slopes
    of each."""
    import dataclasses

    import numpy as np
    from repro_torch.models import transformer as tfm
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    chunk = cfg.hybrid_chunk
    ways = [(chunk, 0), (chunk, MEM_KEEP), (0, 0), (0, MEM_KEEP)]
    lens = spec.long_lens

    def peak(c, S, keep):
        toks = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                             device=dev)
        run_cfg = dataclasses.replace(cfg, hybrid_chunk=c)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            out = tfm.prefill(params, run_cfg, {"tokens": toks},
                              kv_keep=keep)
        torch.cuda.synchronize()
        del out
        return torch.cuda.max_memory_allocated() - base

    t0 = time.perf_counter()
    peak(chunk, lens[0], 0)                 # one-time allocations first
    got = {(c, keep): [peak(c, S, keep) for S in lens] for c, keep in ways}
    fits = {}
    for c, keep in ways:
        tech = "hybrid" if c else "discard"
        model = [mm.peak_bytes(S, tech, chunk=c or chunk, kv_keep=keep)
                 - mm.weights_bytes for S in lens]
        m_slope, m_icpt = np.polyfit(lens, model, 1)
        slope, icpt = np.polyfit(lens, got[(c, keep)], 1)
        fits[(c, keep)] = (slope, m_slope)
        print(f"{cfg.name} peak memory hybrid_chunk={c} kv_keep={keep}: "
              f"bytes above the weights at S={list(lens)}: "
              f"{got[(c, keep)]}; fit {slope:.1f} bytes/token + "
              f"{icpt:.0f}; model ({tech}) {[int(b) for b in model]}, fit "
              f"{m_slope:.1f} bytes/token + {m_icpt:.0f}; measured / model "
              f"slope {slope / m_slope:.3f}", flush=True)
    for c in (chunk, 0):
        for S, with_keep, without in zip(lens, got[(c, MEM_KEEP)],
                                         got[(c, 0)]):
            want = min(S, MEM_KEEP) * mm.kv_all_per_token
            kept = with_keep - without
            print(f"{cfg.name} kept slice hybrid_chunk={c} S={S}: {kept} "
                  f"bytes, model {want:.0f} ({kept / want - 1:+.4f})",
                  flush=True)
            if abs(kept / want - 1) > KEPT_TOL:
                fail(f"the kept slice at S={S}, chunk {c}: {kept} bytes, "
                     f"not {want:.0f} within {KEPT_TOL}")
    hybrid, _ = fits[(chunk, 0)]
    off, _ = fits[(0, 0)]
    model = fits[(chunk, 0)][1]
    print(f"{cfg.name} peak slopes: hybrid {hybrid:.1f} bytes/token, "
          f"hybrid_chunk=0 {off:.1f}, model {model:.1f} (limit "
          f"{SLOPE_LIMIT}x); {time.perf_counter() - t0:.1f} s", flush=True)
    if not hybrid < off:
        fail("hybrid prefilling does not lower the peak's slope")
    if hybrid > SLOPE_LIMIT * model:
        fail(f"the hybrid peak grows {hybrid:.1f} bytes a token, past "
             f"{SLOPE_LIMIT}x the model's {model:.1f}")
    return got, fits


def run_long_request(torch, dev, spec: Spec, cfg, params, mm):
    """(c) A solo engine sized by ``prefix_budget_tokens`` at WL2's longest
    input serves two requests of WL2_MAX tokens (misses; the
    first captures the shape key's graph, the second replays it; 49/24/24
    or 81/40/40 launches a forward), each scored within SCORE_GATE of
    eager ``prefill`` on the same tokens; then three fresh requests at
    each of LONG_LENGTHS. Returns the launches of the two long steps and
    the warm steps as (n_input, 0, seconds) samples."""
    import numpy as np
    from repro_torch.core.engine import EngineConfig, PrefillOnlyEngine
    from repro_torch.core.kv_policy import bucket
    from repro_torch.models import transformer as tfm
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 15)
    budget = mm.prefix_budget_tokens(WL2_MAX)
    eng = PrefillOnlyEngine(cfg, params, EngineConfig(
        max_pack_requests=1, cache_capacity_tokens=budget), device=dev)
    n = WL2_MAX
    reqs = [rng.integers(0, cfg.vocab_size, n).tolist() for _ in range(2)]
    samples, recs = [], []
    reset_launches()                         # the long path starts here
    for toks in reqs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rid = eng.submit(toks, allowed_tokens=(YES, NO))
        eng.step()
        rec, res = eng.batch_records[-1], eng.results[rid]
        recs.append((rec, res, torch.cuda.max_memory_allocated()))
    torch.cuda.synchronize()
    launches = read_launches()               # the long path ends here
    S = bucket(n, eng.ecfg.suffix_buckets)
    expect = {k: v * eng.forwards for k, v in per_forward(cfg, S).items()}
    for toks, (rec, res, peak) in zip(reqs, recs):
        with torch.no_grad():
            logits, _ = tfm.prefill(params, cfg, {"tokens": torch.tensor(
                [toks], device=dev)})
        sub = logits[0, [YES, NO]].double().cpu().numpy()
        sub = np.exp(sub - sub.max())
        sub /= sub.sum()
        diff = max(abs(res["scores"].get(t, float("nan")) - p)
                   for t, p in zip((YES, NO), sub))
        print(f"{cfg.name} long request n_input={res['n_input']} S={rec.S} "
              f"graph={graph_use(rec)} wall_ms={rec.wall * 1e3:.3f} peak "
              f"allocated {peak} bytes (cache budget {budget} tokens, "
              f"{eng.cache.used_blocks * eng.ecfg.block_size} held); "
              f"P(yes)={res['scores'].get(YES)}, eager {sub[0]:.6f}, "
              f"|diff| {diff:.3e} (gate {SCORE_GATE})", flush=True)
        if "corrupt" in res or not diff < SCORE_GATE:
            fail(f"the {n}-token request scored {res} against eager "
                 f"{sub.tolist()}")
    print(f"{cfg.name} long path launches over {eng.forwards} forwards: "
          f"{launches} (expected {expect})", flush=True)
    if kernel_launches(launches) != expect or [
            r.S for r, _, _ in recs] != [S] * 2 or [
            graph_use(r) for r, _, _ in recs] != ["captured", "replayed"]:
        fail("the long requests did not run once each through the "
             f"S={S} graph with every kernel once per use")
    samples.append((n, 0, recs[1][0].wall))
    if spec.extra_phases:                    # where a long step's time goes
        eng.submit(rng.integers(0, cfg.vocab_size, n).tolist(),
                   allowed_tokens=(YES, NO))
        trace_one_step(torch, eng, "miss", {})
    for length in LONG_LENGTHS:
        for i in range(3):
            eng.submit(rng.integers(0, cfg.vocab_size, length).tolist(),
                       allowed_tokens=(YES, NO))
            eng.step()
            rec = eng.batch_records[-1]
            if i and not rec.compiled:
                samples.append((length, 0, rec.wall))
    return launches, samples


def calibrate_roofline(cfg, samples):
    """(d) ``RooflineJCT``'s efficiency and fixed overhead fitted to the
    solo engine's warm steps; prints the fit and, per length, the
    measured median beside the calibrated and the data-sheet (efficiency
    0.55, overhead 3 ms) predictions."""
    from repro_torch.core.jct import RooflineJCT, fit_roofline
    from repro_torch.runtime.hw import H100_SXM as chip
    sheet = RooflineJCT(cfg, chip=chip)
    roof = fit_roofline(sheet, samples)
    by_len = {}
    for n, _, t in samples:
        by_len.setdefault(n, []).append(t)
    rows = [f"{n}: {statistics.median(ts) * 1e3:.3f} / "
            f"{roof.predict(n) * 1e3:.3f} / {sheet.predict(n) * 1e3:.3f}"
            for n, ts in sorted(by_len.items())]
    print(f"{cfg.name} RooflineJCT fitted to {len(samples)} warm steps: "
          f"efficiency {roof.efficiency:.4f}, fixed_overhead "
          f"{roof.fixed_overhead * 1e3:.3f} ms; ms measured / calibrated / "
          f"data sheet by n_input: {'; '.join(rows)}", flush=True)
    return roof


def run_replay(torch, dev, cfg, params, mm, roof):
    """(d) A reduced ``post_recommendation`` trace (REPLAY_USERS users x
    REPLAY_POSTS posts at full token scale, every request arriving at once)
    through ``PrefillOnlyEngine()`` (packing on) sized by the prefix budget
    at WL1's longest input and a graph budget of REPLAY_GRAPH_BYTES, twice:
    as drawn, then with every token id moved by one (the same lengths and
    prefix sharing, new chains), which must replay the first pass's graphs
    and capture none. Every score against a cold engine's; measured
    latencies beside the simulator's for the same requests (the
    calibrated roofline, the same cache budget, one chip), and each step's
    wall beside the roofline's price of its request (a miss's also at its
    bucketed S). Every step runs solo (the engine's defaults: no miss fits
    the pack token budget, no hit's prefix the pack prefix budget), as the
    simulator, which packs nothing, serves them. Returns the launches of
    both passes."""
    import numpy as np
    from repro_torch.core.engine import EngineConfig, PrefillOnlyEngine
    from repro_torch.core.simulator import EngineSpec, Simulator
    from repro_torch.data.workloads import post_recommendation
    from repro_torch.runtime.hw import H100_SXM as chip
    budget = mm.prefix_budget_tokens(WL1_MAX)
    kw = dict(num_users=REPLAY_USERS, posts_per_user=REPLAY_POSTS,
              vocab=cfg.vocab_size, seed=SEED)
    trace = post_recommendation(0.0, materialize_tokens=True, **kw)
    V = cfg.vocab_size
    passes = [[r.tokens for r in trace.requests],
              [[(t + 1) % V for t in r.tokens] for r in trace.requests]]
    eng = PrefillOnlyEngine(cfg, params, EngineConfig(
        cache_capacity_tokens=budget, graph_memory_bytes=REPLAY_GRAPH_BYTES),
        device=dev)
    eng.profile()
    cold = PrefillOnlyEngine(cfg, params, EngineConfig(
        max_pack_requests=1, cache_capacity_tokens=0), device=dev)
    sim = Simulator(cfg, EngineSpec("prefillonly", "srjf_calibrated",
                                    lam=eng.ecfg.lam,
                                    kv_budget_override=budget),
                    total_chips=1, chip=chip, jct_model=roof)
    sim_reqs = post_recommendation(0.0, **kw).requests
    pred = sim.run(sim_reqs, 0.0)
    pred_max = max(r.latency for r in sim_reqs)
    total = {}
    for i, toks in enumerate(passes):
        reset_launches()                     # the replay path starts here
        steps0, forwards0 = len(eng.batch_records), eng.forwards
        t0 = time.perf_counter()
        ids = [eng.submit(t, allowed_tokens=(YES, NO), now=t0) for t in toks]
        eng.run_until_drained()
        torch.cuda.synchronize()
        launches = read_launches()           # the replay path ends here
        recs = list(eng.batch_records)[steps0:]
        expect = {k: sum(per_forward(cfg, r.S)[k] for r in recs)
                  for k in per_forward(cfg)}
        if (kernel_launches(launches) != expect
                or eng.forwards - forwards0 != len(recs)):
            fail(f"replay pass {i + 1}: launches {launches} over "
                 f"{eng.forwards - forwards0} forwards, expected {expect}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        lats = np.array([eng.results[r]["latency"] for r in ids])
        worst = 0.0
        for rid, t in zip(ids, toks):
            c = cold.submit(t, allowed_tokens=(YES, NO))
            cold.step()
            got, want = eng.results[rid], cold.results[c]
            if "corrupt" in got:
                fail(f"replay: non-finite scores {got}")
            worst = max(worst, max(abs(got["scores"][t] - want["scores"][t])
                                   for t in (YES, NO)))
        hit = (sum(eng.results[r]["n_cached"] for r in ids)
               / sum(len(t) for t in toks))
        steps = []
        for r in recs:
            res = [eng.results[q] for q in r.req_ids]
            n = sum(x["n_input"] for x in res)
            c = sum(x["n_cached"] for x in res)
            at_s = "" if c else f" ({roof.predict(r.S) * 1e3:.1f} at S)"
            steps.append(f"{r.kind} {len(res)}x{n}/{c} S={r.S} "
                         f"{r.wall * 1e3:.1f}/{roof.predict(n, c) * 1e3:.1f}"
                         f"{at_s}")
        print(f"{cfg.name} replay pass {i + 1}: {len(ids)} requests of "
              f"{min(len(t) for t in toks)}-{max(len(t) for t in toks)} "
              f"tokens in {len(recs)} steps ({sum(r.compiled for r in recs)} "
              f"first uses); hit share {hit:.4f}; latency mean "
              f"{lats.mean() * 1e3:.3f} ms, p50 "
              f"{np.percentile(lats, 50) * 1e3:.3f}, max "
              f"{lats.max() * 1e3:.3f}; simulator mean "
              f"{pred.mean_latency * 1e3:.3f}, p50 "
              f"{pred.p50_latency * 1e3:.3f}, max {pred_max * 1e3:.3f} "
              f"(hit share {pred.hit_rate:.4f}); measured / simulated mean "
              f"{lats.mean() / pred.mean_latency:.3f}; launches {launches}; "
              f"max |score diff| vs a cold engine {worst:.3e} (gate "
              f"{SCORE_GATE})", flush=True)
        print(f"{cfg.name} replay pass {i + 1} steps (kind, requests x "
              f"tokens / cached, S, wall ms / roofline ms): "
              f"{'; '.join(steps)}", flush=True)
        if worst >= SCORE_GATE or pred.completed != len(ids):
            fail("replay: scores disagree with a cold engine, or the "
                 "simulator did not serve every request")
        if i and any(r.compiled for r in recs):
            fail("replay: the second pass captured a graph")
    # one more warm hit of the last user, traced: a new post on its profile
    toks = passes[-1][-1]
    post = len(toks) - eng.results[ids[-1]]["n_cached"]
    eng.submit(toks[:-post] + [(t + 1) % V for t in toks[-post:]],
               allowed_tokens=(YES, NO))
    trace_one_step(torch, eng, "hit", {})
    return total


# ---- phase 9: the DRAM offload tier -------------------------------------------
def run_offload(torch, dev, cfg, params):
    """Phase 9: the offload tier (``EngineConfig(offload=True)``) on the
    card. (a) times one block's copies each way beside the engine's
    measured link and the data sheet's, and prints the break-even link and
    the policy's decision after ``profile()``. Where the policy restores:
    (b) a demote -> restore round trip through the solo and the packed hit
    forwards, (c) the same requests on an engine with a slow explicit link,
    which recomputes, (d) a route-time prefetch, and one started while a
    new shape key captures, (e) one WL1-length request of OFF_LONG tokens
    demoted and restored whole. Where it refuses: (c) demotion without a
    restore. Every score within SCORE_GATE of a cold engine; (f) launches
    per forward as in the earlier phases. Returns the launches of every
    forward of the phase."""
    import numpy as np
    from repro_torch.core.engine import EngineConfig, PrefillOnlyEngine
    from repro_torch.models.layers import torch_dtype
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 17)
    engines = []

    def engine(**over):
        eng = PrefillOnlyEngine(cfg, params, EngineConfig(**over),
                                device=dev)
        engines.append(eng)
        return eng

    def fresh(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    reset_launches()                         # the offload path starts here
    # room for two users' requests (OFF_PROFILE + OFF_POST tokens, 70
    # blocks each) on the device, and for four times that on the host
    # (the users' blocks and the flood's that their restores demote); the
    # token-linear pricing co-packs two equal hits whenever the fit has a
    # fixed cost
    cap = 2 * (OFF_PROFILE + OFF_POST) // 16 * 16
    made = time.perf_counter()
    eng = engine(offload=True, cache_capacity_tokens=cap,
                 host_cache_bytes=4 * cap * cfg.kv_bytes_per_token(
                     torch_dtype(cfg.dtype).itemsize),
                 shape_cost_model=False)
    print(f"{cfg.name} offload engine made in "
          f"{time.perf_counter() - made:.3f} s (host_cache_bytes "
          f"{eng.ecfg.host_cache_bytes}, pinned for "
          f"{eng.ecfg.host_cache_bytes // eng.block_bytes()} blocks)",
          flush=True)
    eng.profile()
    restores = report_link(torch, dev, cfg, eng)
    users = [fresh(OFF_PROFILE) + fresh(OFF_POST) for _ in range(2)]
    cold = engine(max_pack_requests=1, cache_capacity_tokens=0)
    if restores:
        print(f"{cfg.name} offload: the policy restores at the measured "
              f"link: phase 9 runs (b), (c) on a slow explicit link, (d) "
              f"and (e)", flush=True)
        run_restore(torch, cfg, eng, engine, cold, users, fresh, cap)
        run_long_restore(torch, cfg, engine, fresh,
                         eng.cache.policy.host_bw)
    else:
        print(f"{cfg.name} offload: the policy recomputes at the measured "
              f"link: phase 9 runs (c)", flush=True)
        run_recompute(torch, cfg, eng, cold, users, fresh, "(c)")
    torch.cuda.synchronize()
    launches = read_launches()               # the offload path ends here
    expect, modes = launches_since(cfg, mark((), made=engines))
    print(f"{cfg.name} offload (f) launches over "
          f"{sum(e.forwards for e in engines)} forwards of {len(engines)} "
          f"engines: {launches} (expected {expect}, segmented "
          f"{modes['segmented']}, positioned {modes['positioned']})",
          flush=True)
    if (kernel_launches(launches) != expect
            or launches["flash_attention[segmented]"] != modes["segmented"]
            or launches["flash_attention[positioned]"]
            != modes["positioned"]):
        fail("the offload path did not launch every kernel once per use, "
             "in its forward's mode")
    print(f"{cfg.name} phase 9 took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches


def report_link(torch, dev, cfg, eng) -> bool:
    """(a) One block's copies each way (pinned host memory, the median of
    20, CUDA events), the engine's measured link beside the data sheet's,
    the break-even link and the policy's decision at both. Returns whether
    the policy restores a block at the measured link."""
    from repro_torch.models.layers import torch_dtype
    from repro_torch.runtime.hw import H100_SXM as chip
    pol, nb = eng.cache.policy, eng.block_bytes()
    shape = (2, cfg.num_layers, 1, 16, cfg.num_kv_heads, cfg.head_dim)
    block = torch.randn(shape, device=dev).to(torch_dtype(cfg.dtype))
    host = torch.empty(shape, dtype=block.dtype, pin_memory=True)
    ms = {}
    for way, dst, src in (("device->host", host, block),
                          ("host->device", block, host)):
        times = []
        for _ in range(20):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms[way] = statistics.median(times)
    rate = pol.host_bw
    print(f"{cfg.name} offload link (a): one block {nb} bytes; "
          + "; ".join(f"{way} median {t:.4f} ms ({nb / t / 1e6:.3f} GB/s)"
                      for way, t in ms.items())
          + f" (median of 20); _measure_host_bw {rate / 1e9:.3f} GB/s "
          f"beside {chip.name} host_bw {chip.host_bw / 1e9:.1f} GB/s",
          flush=True)
    if block.nbytes != nb or not rate > 0:
        fail("the block's bytes or the measured link are wrong")
    re_s = pol.recompute_seconds(cfg, 16)
    at_sheet = nb / chip.host_bw < re_s
    worth = pol.worth_restoring(cfg, 16, nb)
    print(f"{cfg.name} offload break-even (a): recompute {re_s * 1e6:.2f} "
          f"us a block; restore {nb / chip.host_bw * 1e6:.2f} us at host_bw "
          f"(worth_restoring {at_sheet}), {pol.restore_seconds(nb) * 1e6:.2f}"
          f" us at the measured link (worth_restoring {worth}); break-even "
          f"link {nb / re_s / 1e9:.3f} GB/s", flush=True)
    return worth


class HostTimer:
    """Host seconds of an engine's demotions (its host store's ``put``)
    and of its execute-path matches with their restores
    (``_match_restoring``, less the demotions of the blocks its restores
    evict), read per step."""

    def __init__(self, eng):
        self.s = {"demote": 0.0, "restore": 0.0}
        for key, owner, name in (("demote", eng.cache.host, "put"),
                                 ("restore", eng, "_match_restoring")):
            setattr(owner, name, self._wrap(key, getattr(owner, name)))

    def _wrap(self, key, fn):
        def timed(*args, **kw):
            t, nested = time.perf_counter(), self.s["demote"]
            try:
                return fn(*args, **kw)
            finally:
                dt = time.perf_counter() - t
                if key == "restore":
                    dt -= self.s["demote"] - nested
                self.s[key] += dt
        return timed


def tier_step(torch, eng, reqs, label: str, timer=None):
    """Serve ``reqs`` as one step (submitted together); prints the step's
    tier counters and checks that a replayed step changed the requested
    device bytes by its cache's change, within less than one block (a
    demoted block leaves the device). Returns (record, results, restored
    blocks)."""
    import numpy as np
    c = eng.cache
    tiered = hasattr(c, "host")

    def counters():
        return (c.restored_blocks if tiered else 0, c.evictions,
                c.host.offloads if tiered else 0, c.used_blocks,
                torch.cuda.memory_allocated(),
                torch.cuda.memory_stats()["requested_bytes.all.current"],
                dict(timer.s) if timer else {})

    before = counters()
    ids = [eng.submit(t, allowed_tokens=(YES, NO)) for t in reqs]
    eng.step()
    torch.cuda.synchronize()
    if eng.queue or sorted(eng._last_step_ids) != sorted(ids):
        fail(f"{label}: the requests did not run as one step")
    after = counters()
    rec, res = eng.batch_records[-1], [eng.results[i] for i in ids]
    d = [a - b for a, b in zip(after[:6], before[:6])]
    host = "".join(f" host ms {k} {1e3 * (after[6][k] - before[6][k]):.3f}"
                   for k in after[6])
    print(f"{eng.cfg.name} offload {label} step n={rec.n_requests} n_input="
          f"{[r['n_input'] for r in res]} n_cached="
          f"{[r['n_cached'] for r in res]} restored={d[0]} evicted={d[1]} "
          f"offloaded={d[2]} S={rec.S} Nb={rec.Nb} P={rec.pmax} wall_ms="
          f"{rec.wall * 1e3:.3f} graph={graph_use(rec)} memory_allocated "
          f"{d[4]:+d} bytes, requested {d[5]:+d} (cache blocks {d[3]:+d} x "
          f"{eng.block_bytes()})"
          f"{host} P(yes)={[r['scores'].get(YES) for r in res]}",
          flush=True)
    for r in res:
        if "corrupt" in r or not all(np.isfinite(list(
                r["scores"].values()))):
            fail(f"{label}: non-finite scores {r}")
    # a demoted block leaves the card: a replayed step moves the device
    # bytes requested by its cache's change, within less than one block.
    # The allocated bytes count each block the allocator hands out whole,
    # up to 1 MiB past the request when it does not split a cached block,
    # so they move by up to megabytes besides (3,670,016 bytes in one step
    # on an NVIDIA H100 80GB HBM3; PERF.md section 6)
    if not rec.compiled and abs(d[5] - d[3] * eng.block_bytes()) \
            >= eng.block_bytes():
        fail(f"{label}: requested device memory moved by {d[5]} bytes, "
             f"the cache's blocks by {d[3]}: demoted blocks stayed on the "
             "device")
    return rec, res, d[0]


def score_diff(a, b, tokens=(YES, NO)) -> float:
    return max(abs(a["scores"][t] - b["scores"][t]) for t in tokens)


def cold_scores(torch, cold, reqs):
    """A cold engine's results for ``reqs`` (misses, one a step)."""
    out = []
    for t in reqs:
        _, (res,), _ = tier_step(torch, cold, [t], "cold")
        if res["n_cached"]:
            fail("the cold engine hit its cache")
        out.append(res)
    return out


def flood(torch, eng, fresh, label: str, timer=None) -> None:
    """One fresh miss as long as the device cache: its insert evicts every
    other block (the cache evicts least recently used leaves, and a chain
    whose tail goes leaves its parent as the newest leaf, so a run of
    shorter misses would evict the chains round robin)."""
    n = eng.cache.capacity_blocks * eng.ecfg.block_size
    tier_step(torch, eng, [fresh(n)], f"{label} flood", timer)


def run_recompute(torch, cfg, eng, cold, users, fresh, label: str):
    """(c) Where the policy refuses: user 0's request (miss, then two
    hits), a flood that demotes it, then the request again: blocks are
    offloaded, none restored, and the request recomputes, scored within
    SCORE_GATE of a cold engine. Returns its record."""
    a = users[0]
    timer = HostTimer(eng)
    tier_step(torch, eng, [a], f"{label} miss", timer)
    tier_step(torch, eng, [a], f"{label} hit", timer)
    warm, _, _ = tier_step(torch, eng, [a], f"{label} hit", timer)
    flood(torch, eng, fresh, label, timer)
    c = eng.cache
    off0 = c.host.offloads
    rec, (res,), restored = tier_step(torch, eng, [a], f"{label} again",
                                      timer)
    ref, = cold_scores(torch, cold, [a])
    diff = score_diff(res, ref)
    print(f"{cfg.name} offload {label}: link {c.policy.host_bw / 1e9:.3f} "
          f"GB/s, worth_restoring a block "
          f"{c.policy.worth_restoring(cfg, 16, eng.block_bytes())}; "
          f"offloads {off0}, restored blocks {c.restored_blocks}; the "
          f"request recomputed: n_cached={res['n_cached']} S={rec.S} wall "
          f"{rec.wall * 1e3:.3f} ms ({graph_use(rec)}) beside its warm hit "
          f"{warm.wall * 1e3:.3f} ms; |score - cold| {diff:.3e} (gate "
          f"{SCORE_GATE})", flush=True)
    if not off0 or restored or c.restored_blocks or res["n_cached"] \
            or diff >= SCORE_GATE:
        fail(f"{label}: expected demotion, no restore and a recompute "
             "within the gate")
    return rec


def run_restore(torch, cfg, eng, engine, cold, users, fresh, cap):
    """(b) Two users' requests served, then their hits warm (solo, then
    both in one packed step); a flood demotes them, the solo hit restores
    one (same graph, scores within OFF_SAME of the warm hit's), a second
    flood, the packed hit restores both. (c) The same request on an engine
    with a slow explicit link recomputes. (d) A prefetch ahead of the hit
    (which then restores nothing on its execute path); then a prefetch
    started while a new shape key captures, which must neither break the
    capture nor be lost."""
    from repro_torch.core import compiled
    from repro_torch.core.prefix_cache import token_chain
    a, b = users
    chains = [token_chain(t, 16) for t in users]
    timer = HostTimer(eng)
    for t in users:
        tier_step(torch, eng, [t], "(b) miss", timer)
    tier_step(torch, eng, [a], "(b) hit", timer)
    warm_a, (warm_ra,), _ = tier_step(torch, eng, [a], "(b) hit", timer)
    tier_step(torch, eng, users, "(b) packed hit", timer)
    warm_p, warm_rp, _ = tier_step(torch, eng, users, "(b) packed hit",
                                   timer)
    if warm_p.n_requests != 2 or warm_p.kind != "hit":
        fail("(b) the two users' hits did not run as one packed hit step")
    ref_a, ref_b = cold_scores(torch, cold, users)
    c, nb = eng.cache, eng.block_bytes()

    def demoted(label):
        flood(torch, eng, fresh, label, timer)
        tiers = [c.match_tiers(ch) for ch in chains]
        if any(t != ["host"] * len(ch) for t, ch in zip(tiers, chains)):
            fail(f"{label}: the flood left the users' blocks {tiers}")

    demoted("(b)")
    rec, (ra,), restored = tier_step(torch, eng, [a], "(b) restored hit",
                                     timer)
    same = score_diff(ra, warm_ra)
    if (restored != len(chains[0]) or rec.compiled or same > OFF_SAME
            or score_diff(ra, ref_a) >= SCORE_GATE):
        fail(f"(b) the restored hit: {restored} blocks, graph "
             f"{graph_use(rec)}, |score - warm| {same:.3e}")
    demoted("(b)")
    prec, rp, prestored = tier_step(torch, eng, users,
                                    "(b) restored packed hit", timer)
    psame = max(score_diff(g, w) for g, w in zip(rp, warm_rp))
    pcold = max(score_diff(g, w) for g, w in zip(rp, (ref_a, ref_b)))
    if (prestored != sum(map(len, chains)) or prec.compiled
            or prec.n_requests != 2 or psame > OFF_SAME
            or pcold >= SCORE_GATE):
        fail(f"(b) the restored packed hit: {prestored} blocks, graph "
             f"{graph_use(prec)}, |score - warm| {psame:.3e}")
    # (c) the same requests on an engine whose explicit link is slow
    slow = engine(offload=True, offload_host_bw=OFF_SLOW_BW,
                  cache_capacity_tokens=cap, max_pack_requests=1)
    rrec = run_recompute(torch, cfg, slow, cold, users, fresh, "(c)")
    print(f"{cfg.name} offload (b) restored hit: {restored} blocks "
          f"({restored * nb} bytes) restored, n_cached={ra['n_cached']}; "
          f"wall {rec.wall * 1e3:.3f} ms beside the warm hit "
          f"{warm_a.wall * 1e3:.3f} ms and a recompute of the same request "
          f"{rrec.wall * 1e3:.3f} ms (slow link, S={rrec.S}, "
          f"{graph_use(rrec)}); |score - before demotion| {same:.3e} (limit "
          f"{OFF_SAME}), |score - cold| {score_diff(ra, ref_a):.3e} (gate "
          f"{SCORE_GATE})", flush=True)
    print(f"{cfg.name} offload (b) restored packed hit: {prestored} blocks "
          f"restored, Nb={prec.Nb} pmax={prec.pmax}; wall "
          f"{prec.wall * 1e3:.3f} ms beside the warm packed hit "
          f"{warm_p.wall * 1e3:.3f} ms; |score - before demotion| "
          f"{psame:.3e} (limit {OFF_SAME}), |score - cold| {pcold:.3e} "
          f"(gate {SCORE_GATE}); no restore recaptured: every restored "
          f"step replayed", flush=True)

    # (d) a route-time prefetch ahead of user 0's hit
    demoted("(d)")
    est = eng.restore_estimate(chains[0])
    t = time.perf_counter()
    n = eng.prefetch_prefix(chains[0])
    join_prefetch()
    wait = time.perf_counter() - t
    on_card = on_device(eng, chains[0])
    print(f"{cfg.name} offload (d) prefetch of user 0: restore_estimate "
          f"{est}; {n} blocks scheduled; {sum(on_card)} device payloads after "
          f"the kv-prefetch thread, joined after {wait * 1e3:.3f} ms",
          flush=True)
    if n != len(chains[0]) or len(on_card) != n or not all(on_card):
        fail("(d) the prefetch did not bring user 0's blocks to the card")
    rec, (ra,), restored = tier_step(torch, eng, [a], "(d) hit after the "
                                     "prefetch", timer)
    if restored or rec.compiled or score_diff(ra, warm_ra) > OFF_SAME:
        fail(f"(d) the hit after the prefetch restored {restored} blocks "
             "on its execute path or left its graph or its scores")
    # a prefetch of user 1 started while a new shape key captures: it waits
    # for the capture (capture_lock). The key is a hit over 1024 of user
    # 0's resident tokens (prefixes of its request, whose blocks are all
    # resident: the steps insert and evict nothing), taken twice
    posts = [a[:n] for n in OFF_PREFIX_CUTS]
    refs = cold_scores(torch, cold, posts)
    started = []
    capture = compiled.CompiledForward._capture

    def capture_with_prefetch(self):
        started.append(eng.prefetch_prefix(chains[1]))
        return capture(self)

    compiled.CompiledForward._capture = capture_with_prefetch
    try:
        crec, (rc,), _ = tier_step(torch, eng, [posts[0]],
                                   "(d) capture during a prefetch", timer)
    finally:
        compiled.CompiledForward._capture = capture
    join_prefetch()
    on_card = on_device(eng, chains[1])
    brec, (rb,), brestored = tier_step(torch, eng, [b], "(d) user 1's hit",
                                       timer)
    rrec, (rr,), _ = tier_step(torch, eng, [posts[1]],
                               "(d) the captured key replayed", timer)
    diffs = [score_diff(rc, refs[0]), score_diff(rr, refs[1]),
             score_diff(rb, ref_b)]
    print(f"{cfg.name} offload (d) a prefetch of user 1 started inside the "
          f"capture of S={crec.S} P={crec.pmax} ({graph_use(crec)}): "
          f"{started} blocks scheduled, {sum(on_card)} device payloads after "
          f"it; user 1's hit then restored {brestored} blocks on its execute "
          f"path ({graph_use(brec)}); the key replayed ({graph_use(rrec)}); "
          f"|score - cold| "
          f"{', '.join(f'{x:.3e}' for x in diffs)} (gate {SCORE_GATE})",
          flush=True)
    if (started != [len(chains[1])] or not crec.compiled or rrec.compiled
            or (rrec.S, rrec.pmax) != (crec.S, crec.pmax)
            or len(on_card) != len(chains[1]) or not all(on_card)
            or brestored or brec.compiled or max(diffs) >= SCORE_GATE
            or any(f.graph is None for f in eng.graphs())):
        fail("(d) the prefetch during a capture broke the capture or was "
             "lost")


def on_device(eng, chain):
    """Per resident block of ``chain``: whether its payload is a tensor on
    the engine's device (not a demoted host copy)."""
    import torch
    c = eng.cache
    return [isinstance(c.blocks[h].payload, torch.Tensor)
            and c.blocks[h].payload.device == eng.device
            for h in chain if h in c.blocks]


def join_prefetch() -> None:
    import threading
    for th in threading.enumerate():
        if th.name == "kv-prefetch":
            th.join(timeout=300)
            if th.is_alive():
                fail("a kv-prefetch thread did not end")


def run_long_restore(torch, cfg, engine, fresh, link: float) -> None:
    """(e) One WL1-length request of OFF_LONG tokens (its OFF_LONG / 16
    blocks cached) on an engine whose device cache holds it and whose host
    store holds twice it, at the link this run measured: a warm hit, a
    flood that demotes it, the restored hit (same graph, scores within
    OFF_SAME of the warm hit's), a second flood, then the request
    recomputed once the link is priced slow."""
    from repro_torch.core.prefix_cache import token_chain
    from repro_torch.models.layers import torch_dtype
    gc.collect()
    torch.cuda.empty_cache()
    nblk = OFF_LONG // 16
    nb = 16 * cfg.kv_bytes_per_token(torch_dtype(cfg.dtype).itemsize)
    host_bytes = 2 * nblk * nb
    made = time.perf_counter()
    eng = engine(offload=True, offload_host_bw=link, max_pack_requests=1,
                 cache_capacity_tokens=OFF_LONG, host_cache_bytes=host_bytes,
                 graph_memory_bytes=REPLAY_GRAPH_BYTES)
    made = time.perf_counter() - made
    timer = HostTimer(eng)
    r = fresh(OFF_LONG)
    chain = token_chain(r, 16)
    tier_step(torch, eng, [r], "(e) miss", timer)
    tier_step(torch, eng, [r], "(e) hit", timer)
    warm, (wr,), _ = tier_step(torch, eng, [r], "(e) hit", timer)
    flood(torch, eng, fresh, "(e)", timer)
    if eng.cache.match_tiers(chain) != ["host"] * nblk:
        fail("(e) the flood did not demote the whole request")
    c = eng.cache
    rec, (rr,), restored = tier_step(torch, eng, [r], "(e) restored hit",
                                     timer)
    same = score_diff(rr, wr)
    stats = (torch.cuda.host_memory_stats()
             if hasattr(torch.cuda, "host_memory_stats") else {})
    pinned = {k: stats.get(k, "not reported")
              for k in ("allocated_bytes.current", "active_bytes.current")}
    flood(torch, eng, fresh, "(e)", timer)
    c.policy.host_bw = OFF_SLOW_BW
    rrec, (rc,), rrestored = tier_step(torch, eng, [r], "(e) recomputed",
                                       timer)
    print(f"{cfg.name} offload (e) a {OFF_LONG}-token request ({nblk} blocks"
          f", {nblk * nb} bytes; host_cache_bytes {host_bytes}, "
          f"cache_capacity_tokens {OFF_LONG}, link "
          f"{link / 1e9:.3f} GB/s; engine made in {made:.3f} s, its host "
          f"tier's pinned memory reserved): restored {restored} blocks; "
          f"restored "
          f"hit wall {rec.wall * 1e3:.3f} ms ({graph_use(rec)}) beside the "
          f"warm hit {warm.wall * 1e3:.3f} ms and the request recomputed "
          f"{rrec.wall * 1e3:.3f} ms (S={rrec.S}, {graph_use(rrec)}, link "
          f"priced {OFF_SLOW_BW:g} B/s); host ms queuing demotions "
          f"{timer.s['demote'] * 1e3:.3f} and restores "
          f"{timer.s['restore'] * 1e3:.3f} over the phase; pinned host "
          f"bytes the process holds {pinned} beside host.used_bytes "
          f"{c.host.used_bytes} ({c.host.stats()['blocks']} blocks); "
          f"|score - before demotion| {same:.3e} (limit {OFF_SAME}), "
          f"recomputed |score - warm| {score_diff(rc, wr):.3e} (gate "
          f"{SCORE_GATE})", flush=True)
    if (restored != nblk or rec.compiled or same > OFF_SAME or rrestored
            or rc["n_cached"] or score_diff(rc, wr) >= SCORE_GATE):
        fail("(e) the long request's round trip failed")


# ---- traces ------------------------------------------------------------------
def shape_key(rec):
    return (rec.kind, rec.S, rec.Nb, rec.smax, rec.pmax)


def warm_medians(eng):
    """Median unprofiled wall (ms) of the engine's warm steps, per step
    kind and shape (``shape_key``)."""
    walls = {}
    for rec in eng.batch_records:
        if not rec.compiled:
            walls.setdefault(shape_key(rec), []).append(rec.wall * 1e3)
    return {k: statistics.median(v) for k, v in walls.items()}


def trace_steps(torch, eng, cfg, rng, medians) -> None:
    """One more warm miss step and one warm hit step (solo)."""
    user = rng.integers(0, cfg.vocab_size, PROFILE_LEN).tolist()
    for label in ("miss", "hit"):
        eng.submit(user + rng.integers(0, cfg.vocab_size, POST_LEN).tolist(),
                   allowed_tokens=(YES, NO))
        trace_one_step(torch, eng, label, medians)


def trace_one_step(torch, eng, label: str, medians,
                   packed: bool = False) -> None:
    """Run the engine's next step under ``torch.profiler``: device time per
    kernel, of the other device ops (projections, RoPE, embedding, LM head,
    KV copies) and the device's idle share of the step's wall; then drain
    the queue unprofiled. Runs after the main path's launch counts were
    read. ``label`` is the kind the step must be: ``miss``/``hit`` (solo
    steps) or, with ``packed``, a packed step of that kind. ``medians``
    (``warm_medians``) gives the unprofiled warm wall of the step's shape,
    against which the idle share is also read: the profiler's own tracing
    of a graph launch adds host time that an unprofiled step does not
    pay."""
    from torch.profiler import ProfilerActivity, profile
    while True:
        # a packed wave's first step may be one request the batch
        # formation left alone: trace the wave's steps until a packed one
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.step()
        rec = eng.batch_records[-1]
        if packed:
            ok = rec.kind == label and rec.n_requests > 1
        else:
            ok = rec.kind == "solo" and (rec.pmax > 0) == (label == "hit")
        if (ok and not rec.compiled) or not packed or not eng.queue:
            break
    if not ok or rec.compiled:
        fail(f"traced step was not a warm {'packed ' if packed else ''}"
             f"{label} step: {rec}")
    eng.run_until_drained()
    if packed:
        label = (f"packed-{label} S={rec.S} Nb={rec.Nb} smax={rec.smax} "
                 f"pmax={rec.pmax} n={rec.n_requests}")
    else:
        label = f"{label} S={rec.S} P={rec.pmax}"
    label = f"{eng.cfg.name} {label} ({graph_use(rec)})"
    report_trace(torch, prof, label, rec.wall * 1e3, expect=TC_PREFILL,
                 unprofiled=medians.get(shape_key(rec)))


def report_trace(torch, prof, label: str, wall: float, expect=(),
                 unprofiled=None) -> None:
    """Print a profiled step's ``trace`` lines: device ms and launches per
    kernel group and of the other device ops, busy ms and idle share of
    the step's wall (ms), the widest device gap and the top host ops, and
    the port's kernels that ran, by name; fail unless every name in
    ``expect`` ran."""
    groups = (("flash_fwd", "flash_attention"),
              ("flash_combine", "flash_attention"),
              ("fused_mlp", "fused_mlp"), ("mlp_gemm", "fused_mlp"),
              ("split_sum", "fused_mlp"),
              ("rmsnorm", "rmsnorm"), ("decode_split", "decode_attention"),
              ("decode_combine", "decode_attention"))
    dev_ms, n, names, name_ms = {}, {}, {}, {}
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    for e in evs:
        key = next((k for k, _ in groups if k in e.name), None)
        g = dict(groups).get(key, "other")
        dev_ms[g] = dev_ms.get(g, 0.0) + e.time_range.elapsed_us() / 1e3
        n[g] = n.get(g, 0) + 1
        if key is not None:
            short = (e.name.replace("(anonymous namespace)::", "")
                     .replace("repro_torch::", "").replace("void ", "")
                     .split("(")[0])
            names.setdefault(g, {}).setdefault(short, 0)
            names[g][short] += 1
            name_ms[short] = (name_ms.get(short, 0.0)
                              + e.time_range.elapsed_us() / 1e3)
    busy = sum(dev_ms.values())
    against = ("" if unprofiled is None or not busy else
               f" ({1 - busy / unprofiled:.4f} against the unprofiled warm "
               f"median {unprofiled:.3f} ms)")
    print(f"trace {label}: step wall {wall:.3f} ms "
          f"(profiled), device busy {busy:.3f} ms, idle share "
          f"{'not measured' if not busy else f'{1 - busy / wall:.4f}'}"
          f"{against}; "
          f"device ms (launches) per group: "
          + ", ".join(f"{g} {dev_ms[g]:.3f} ({n[g]})"
                      for g in sorted(dev_ms)), flush=True)
    # where the idle time sits: the widest gap between device events,
    # and the host ops with the most self CPU time
    gap = max(((b.time_range.start - a.time_range.end, b.name)
               for a, b in zip(evs, evs[1:])), default=(0, ""))
    host = sorted((e for e in prof.key_averages()
                   if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:5]
    print(f"trace {label}: widest device gap {gap[0] / 1e3:.3f} ms "
          f"(before {gap[1][:48]}); host self ms (calls): "
          + ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3:.3f} "
                      f"({e.count})" for e in host), flush=True)
    ran = {k for per in names.values() for k in per}
    print(f"trace {label}: port kernels (launches, device ms): "
          + "; ".join(f"{g}: " + ", ".join(f"{k} ({c}, {name_ms[k]:.3f})"
                                           for k, c in sorted(per.items()))
                      for g, per in sorted(names.items())), flush=True)
    missing = [k for k in expect if not any(k in r for r in ran)]
    if missing:
        fail(f"trace {label}: {missing} did not run")



# ---- phase 10: the serving plane ------------------------------------------------
def run_serving(torch, dev, spec: Spec, cfg, params):
    """Phase 10: the in-process serving plane on the card: ``make_pool``
    instances over the model's weights behind the port's ``serve_trace`` or
    ``AsyncServer`` (two instances on one card, one worker thread each).
    qwen: (a) WL1 at full token scale, (b) WL1 packed through the server,
    (c) (b)'s trace under seeded chaos; granite: (d) the offload tier's
    serving side (restore and route-time prefetch), (e) a short WL1
    replay. Every replay scrapes ``/metrics`` over HTTP while it runs and
    reads ``/trace.chrome.json``, holds the served scores against a cold
    solo engine's (or, under chaos, against (b)'s), and checks that its
    forwards launched every kernel once per use. Returns the launches of
    the phase."""
    from repro_torch.core.engine import EngineConfig, PrefillOnlyEngine
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cold = PrefillOnlyEngine(cfg, params, EngineConfig(
        max_pack_requests=1, cache_capacity_tokens=0,
        graph_memory_bytes=REPLAY_GRAPH_BYTES), device=dev)
    total = {}
    with thread_errors() as errors:
        if spec.extra_phases:
            runs = (serve_full_scale, serve_packed_and_chaos)
        else:
            runs = (serve_offload, serve_short)
        for run in runs:
            for k, v in run(torch, dev, cfg, params, cold).items():
                total[k] = total.get(k, 0) + v
            gc.collect()
            torch.cuda.empty_cache()
    if errors:
        fail(f"phase 10: a thread raised: {errors[0]}")
    print(f"{cfg.name} phase 10 took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return total


@contextlib.contextmanager
def thread_errors():
    """Collect the exceptions that end any thread meanwhile (a future
    resolved twice raises in the worker thread that resolves it)."""
    import threading
    errors, old = [], threading.excepthook

    def hook(args):
        errors.append(f"{args.thread.name}: {args.exc_type.__name__}: "
                      f"{args.exc_value}")
        old(args)

    threading.excepthook = hook
    try:
        yield errors
    finally:
        threading.excepthook = old


def mark(engines, made=()):
    """Each engine's (forwards, step records) now, for ``launches_since``;
    engines ``made`` in the window count from their construction (their
    profile runs)."""
    out = {eng: (eng.forwards, len(eng.batch_records)) for eng in engines}
    out.update({eng: (0, 0) for eng in made})
    return out


def launches_since(cfg, marks):
    """Launches the engines' forwards since ``marks`` must have made:
    ``per_forward`` at each step's S (profile runs: one chunk), and the
    packed steps' attention launches by mode."""
    expect = {k: 0 for k in per_forward(cfg)}
    modes = {"segmented": 0, "positioned": 0}
    for eng, (f0, n0) in marks.items():
        recs = list(eng.batch_records)
        if len(recs) == eng.batch_records.maxlen:
            fail("the step records overflowed their ring")
        new = recs[n0:]
        for S in [0] * (eng.forwards - f0 - len(new)) + [r.S for r in new]:
            for k, v in per_forward(cfg, S).items():
                expect[k] += v
        for r in new:
            if r.n_requests > 1:
                modes["positioned" if r.kind == "hit" else
                      "segmented"] += cfg.num_layers
    return expect, modes


def check_launches(torch, cfg, label: str, marks):
    torch.cuda.synchronize()
    launches = read_launches()
    expect, modes = launches_since(cfg, marks)
    print(f"{cfg.name} serve {label} launches: {launches} (expected "
          f"{expect}, segmented {modes['segmented']}, positioned "
          f"{modes['positioned']})", flush=True)
    if (kernel_launches(launches) != expect
            or launches["flash_attention[segmented]"] != modes["segmented"]
            or launches["flash_attention[positioned]"]
            != modes["positioned"]):
        fail(f"serve {label}: the forwards did not launch every kernel "
             "once per use, in their forward's mode")
    return launches


class Scrape:
    """A scraper of a replay's endpoint: it picks the port ``serve_trace``
    is to serve on, polls ``/metrics`` there until ``after`` requests are
    served, then fetches ``/metrics`` and ``/trace.chrome.json`` while the
    replay's later arrivals run."""

    def __init__(self, after: int):
        import socket
        import threading
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self.port = s.getsockname()[1]
        self.after, self.got = after, {}
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="scrape")
        self.thread.start()

    def _run(self):
        from repro_torch.launch import smoke as v
        address = ("127.0.0.1", self.port)
        deadline = time.monotonic() + 600
        try:
            while time.monotonic() < deadline:
                try:
                    text = fetch(address, ("/metrics",))["/metrics"]
                except OSError:            # not serving yet
                    text = ""
                if sum(x["value"] for x in v.parse_prometheus(text).get(
                        "prefillonly_requests_served", [])) >= self.after:
                    break
                time.sleep(0.02)
            self.got = fetch(address)
        except Exception as e:
            self.got = {"error": f"{type(e).__name__}: {e}"}

    def wait(self):
        self.thread.join(timeout=60)
        if not self.got or "error" in self.got:
            fail(f"the scrape during the replay failed: {self.got}")
        return self.got


def fetch(address, paths=("/metrics", "/trace.chrome.json")):
    import urllib.request
    base = f"http://{address[0]}:{address[1]}"
    out = {}
    for path in paths:
        with urllib.request.urlopen(base + path, timeout=60) as r:
            out[path] = r.read().decode()
    return out


SERVE_SERIES = ("requests_served", "latency_seconds_bucket",
                "batch_wall_seconds_bucket", "step_padding_waste",
                "queue_depth", "backlog_seconds", "jct_coef_a", "jct_coef_b",
                "jct_pearson_r")


def check_observability(label: str, got, server, served_ids) -> str:
    """The scrape parses under the strict exposition parser and holds the
    serving series; its chrome trace parses; every served request's
    timeline has queue, execute and score spans. Returns a summary."""
    from repro_torch.launch import smoke as v
    series = v.parse_prometheus(got["/metrics"])
    fams = v.validate_histograms(series)
    missing = [n for n in SERVE_SERIES if f"prefillonly_{n}" not in series]
    chrome = json.loads(got["/trace.chrome.json"])
    nested = v.validate_chrome(chrome)
    nested_all = v.validate_chrome(server.tracer.chrome_trace())
    recs = {rid: r for r in server.tracer.snapshot() for rid in r["rids"]}
    lacking = [rid for rid in served_ids if rid not in recs or not {
        "queue", "execute", "score"} <= {s["name"] for s in
                                        recs[rid]["spans"]}]
    if missing or lacking:
        fail(f"serve {label}: the scrape lacks {missing}, or requests "
             f"{lacking[:5]} lack queue/execute/score spans")
    split = {}
    for rid in served_ids:          # each attempt adds its own spans
        for s in recs[rid]["spans"]:
            split.setdefault(s["name"], []).append(s["dur"] * 1e3)
    return (f"scrape: {sum(len(x) for x in series.values())} samples of "
            f"{len(series)} series ({len(fams)} histograms), chrome trace "
            f"{len(chrome['traceEvents'])} events ({nested} nested spans; "
            f"{nested_all} at the end); {len(served_ids)} served timelines "
            f"with queue, execute and score spans; span ms mean (count): "
            + ", ".join(f"{k} {statistics.mean(v):.3f} ({len(v)})"
                        for k, v in sorted(split.items())))


def serve_line(torch, cfg, label: str, server, outcomes, wall: float,
               card: str, counted: bool = True) -> str:
    """The ``serve`` line of one replay. ``counted``: the server's served
    and rejected counters must equal the outcomes (each future resolved
    once). Under injected faults the reference server's counters may count
    a request whose served result was parked and then replaced by a
    rejection twice, so a chaos replay relies on the futures and on no
    thread raising instead."""
    import numpy as np
    from repro_torch.serving import Rejected
    served = [o for o in outcomes if not isinstance(o, Rejected)]
    reasons = {}
    for o in outcomes:
        if isinstance(o, Rejected):
            reasons[o.reason] = reasons.get(o.reason, 0) + 1
    m = server.metrics
    if counted and (m.total("requests_served") != len(served) or m.total(
            "requests_rejected") != len(outcomes) - len(served)):
        fail(f"serve {label}: the server resolved {m.total('requests_served')}"
             f" served and {m.total('requests_rejected')} rejected futures, "
             f"the outcomes {len(served)} and {len(outcomes) - len(served)}")
    lats = np.array([o["latency"] for o in served] or [np.nan])
    hit = sum(o["n_cached"] for o in served) / max(
        1, sum(o["n_input"] for o in served))
    kinds = {k: m.total(f"pack_{k}_steps") for k in ("solo", "miss", "hit")}
    return (f"{cfg.name} serve {label}: requests {len(outcomes)}, served "
            f"{len(served)}, rejected {reasons}; wall {wall:.3f} s, "
            f"{len(served) / wall:.3f} scored requests/s, latency mean "
            f"{lats.mean() * 1e3:.3f} ms, p50 "
            f"{np.percentile(lats, 50) * 1e3:.3f}, p99 "
            f"{np.percentile(lats, 99) * 1e3:.3f}; token hit rate {hit:.4f}; "
            f"steps by kind {kinds}, packed steps "
            f"{kinds['miss'] + kinds['hit']}; engine_errors "
            f"{m.total('engine_errors')}, retries "
            f"{m.total('requests_retried')}, watchdog trips "
            f"{m.total('watchdog_trips')}, quarantined "
            f"{m.total('results_quarantined')}; peak device memory "
            f"{torch.cuda.max_memory_allocated()} bytes; card {card}")


def check_fault_free(cfg, label: str, server, pool, outcomes) -> None:
    """No engine error, retry, watchdog trip, capture failure or rejection
    of any reason in a replay without injected faults."""
    from repro_torch.serving import Rejected
    m = server.metrics
    bad = {n: m.total(n) for n in ("engine_errors", "requests_retried",
                                   "watchdog_trips", "results_quarantined")
           if m.total(n)}
    failed = [f.name for e in pool.engines.values() for f in e.graphs()
              if f._failure is not None]
    rejected = [o.reason for o in outcomes if isinstance(o, Rejected)]
    if bad or failed or rejected or not all(pool.healthy.values()):
        fail(f"serve {label}: {bad}, capture errors {failed}, rejected "
             f"{rejected}, healthy {pool.healthy}")


def cold_diff(cold, reqs, outcomes, memo) -> float:
    """Max |score - a cold solo engine's| over the served requests (the
    cold scores memoised by tokens)."""
    worst = 0.0
    for toks, o in zip(reqs, outcomes):
        key = tuple(toks)
        if key not in memo:
            rid = cold.submit(toks, allowed_tokens=SERVE_ANSWER)
            cold.step()
            memo[key] = cold.results.pop(rid)["scores"]
        worst = max(worst, max(abs(o["scores"][t] - memo[key][t])
                               for t in SERVE_ANSWER))
    return worst


def replay(torch, cfg, label: str, pool, cold, card: str, marks, *,
           fault_free: bool = True, memo=None, **kw):
    """One ``serve_trace`` over ``pool`` with a scrape while it runs;
    prints the ``serve`` line and checks the replay. Returns (outcomes,
    the trace's token lists, launches)."""
    from repro_torch.launch.serve import serve_trace
    from repro_torch.serving import Rejected
    torch.cuda.reset_peak_memory_stats()
    # the replay's arrivals run on for seconds after its second result
    scrape = Scrape(after=2)
    out = serve_trace(cfg.name, pool=pool, metrics_port=scrape.port,
                      drain_timeout=600.0, seed=SEED, **kw)
    got = scrape.wait()
    server, outcomes = out["server"], out["outcomes"]
    reqs = trace_tokens(kw)
    served = [o["req_id"] for o in outcomes if not isinstance(o, Rejected)]
    obs = check_observability(label, got, server, served)
    print(serve_line(torch, cfg, label, server, outcomes,
                     out["wall_seconds"], card, counted=fault_free)
          + f"; {obs}", flush=True)
    if fault_free:
        check_fault_free(cfg, label, server, pool, outcomes)
    if memo is not None:
        worst = cold_diff(cold, [t for t, o in zip(reqs, outcomes)
                                 if not isinstance(o, Rejected)],
                          [o for o in outcomes if not isinstance(o, Rejected)],
                          memo)
        print(f"{cfg.name} serve {label}: max |score - cold solo engine| "
              f"{worst:.3e} over {len(served)} served (gate {SCORE_GATE})",
              flush=True)
        if worst >= SCORE_GATE:
            fail(f"serve {label}: scores disagree with a cold engine")
    launches = check_launches(torch, cfg, label, marks)
    return outcomes, reqs, launches, out


def trace_tokens(kw):
    from repro_torch.data.workloads import get_trace
    trace = get_trace("post_recommendation", kw["qps"],
                      scale_tokens=kw["scale_tokens"], materialize_tokens=True,
                      vocab=512, seed=SEED, **kw["trace_kw"])
    return [r.tokens for r in trace.requests[:kw["max_requests"]]]


def pool_sizes(cfg, pool, what: str) -> str:
    from repro_torch.models.layers import torch_dtype
    eng = next(iter(pool.engines.values()))
    e = eng.ecfg
    kv = cfg.kv_bytes_per_token(torch_dtype(cfg.dtype).itemsize)
    return (f"{cfg.name} serve {what}: {len(pool.engines)} instances, each "
            f"cache_capacity_tokens {e.cache_capacity_tokens} "
            f"({e.cache_capacity_tokens * kv} bytes of KV), "
            f"graph_memory_bytes {e.graph_memory_bytes}, pack budgets "
            f"(token {e.pack_token_budget}, prefix {e.pack_prefix_budget}, "
            f"requests {e.max_pack_requests}), offload {e.offload}"
            + (f" (host_cache_bytes {e.host_cache_bytes}, link "
               f"{eng.cache.policy.host_bw / 1e9:.3f} GB/s)"
               if e.offload else ""))


def serve_full_scale(torch, dev, cfg, params, cold):
    """(a) WL1 at full token scale: SERVE_A's users and posts at
    SERVE_A_QPS through two profiled instances warmed on the trace's shape
    keys first, the least-backlog router, admission on."""
    from repro_torch.launch.serve import make_pool
    card = card_line()
    reset_launches()
    pool = make_pool(cfg.name, 2, reduced=False, profile=True, device=dev,
                     params=params, cache_tokens=SERVE_A_CACHE,
                     ecfg=dict(graph_memory_bytes=SERVE_A_GRAPHS))
    print(pool_sizes(cfg, pool, "(a)"), flush=True)
    marks = mark([cold], made=pool.engines.values())
    _, _, launches, out = replay(
        torch, cfg, "(a) WL1 full scale", pool, cold, card, marks,
        memo={}, warm=True, **SERVE_A)
    return launches


def serve_packed_and_chaos(torch, dev, cfg, params, cold):
    """(b) WL1 at SERVE_B's scale with arrivals close enough that misses
    and hits queue together: packed-miss and packed-hit steps through the
    server (profiled on LONG_LENGTHS, so that autotune sets the pack token
    budget to the top suffix bucket). (c) The same trace on the same pool
    under a seeded ChaosConfig of step crashes, stragglers and NaN
    corruption, retry on: every future resolves exactly once, the injected
    faults counted, every served score within SCORE_GATE of (b)'s."""
    from repro_torch.launch.serve import make_pool
    from repro_torch.serving import ChaosConfig, Rejected
    card = card_line()
    reset_launches()
    pool = make_pool(cfg.name, 2, reduced=False, profile=True, device=dev,
                     params=params, cache_tokens=SERVE_B_CACHE,
                     profile_lengths=LONG_LENGTHS)
    print(pool_sizes(cfg, pool, "(b)") + " (autotuned by profile())",
          flush=True)
    marks = mark([cold], made=pool.engines.values())
    outs, reqs, launches, _ = replay(
        torch, cfg, "(b) WL1 packed", pool, cold, card, marks, memo={},
        **SERVE_B)
    kinds = {k: sum(r.n_requests > 1 and r.kind == k
                    for e in pool.engines.values() for r in e.batch_records)
             for k in ("miss", "hit")}
    print(f"{cfg.name} serve (b) packed steps through the server: "
          f"packed-miss {kinds['miss']}, packed-hit {kinds['hit']}",
          flush=True)
    if not (kinds["miss"] and kinds["hit"]):
        fail("serve (b): no packed-miss or no packed-hit step ran")
    total = dict(launches)
    reset_launches()
    marks = mark(pool.engines.values())
    chaos = ChaosConfig(seed=SEED, **SERVE_CHAOS)
    couts, _, launches, out = replay(
        torch, cfg, "(c) WL1 packed under chaos", pool, cold, card, marks,
        fault_free=False, chaos=chaos, **SERVE_B)
    worst = max([max(abs(c["scores"][t] - b["scores"][t])
                     for t in SERVE_ANSWER)
                 for c, b in zip(couts, outs)
                 if not isinstance(c, Rejected)] or [0.0])
    faults = out.get("faults_injected", {})
    print(f"{cfg.name} serve (c): faults injected {faults}; every future "
          f"resolved once ({len(couts)} of {len(reqs)}); max |score - (b)| "
          f"{worst:.3e} over the served (gate {SCORE_GATE})", flush=True)
    if (len(couts) != len(reqs) or not faults.get("step_error")
            or not faults.get("nan_score") or worst >= SCORE_GATE):
        fail("serve (c): a future was lost, the step crash or the NaN "
             "corruption did not fire, or a served score moved")
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    return total



def serve_offload(torch, dev, cfg, params, cold):
    """(d) The offload tier's serving side: two profiled instances with
    ``offload=True`` sized as phase 9's (a device cache of two users'
    1124-token requests, 70 blocks each), the user-hash router (each
    user's requests and floods on one instance), admission on. Each user:
    a miss, two hits (the second is the warm reference); a hit that waits
    behind a flood demoting its blocks, so its step restores them
    (``restore``); a flood; then a hit submitted while the instance runs
    another miss, so the route-time prefetch restores the blocks first
    (``prefetch``). Restored scores must equal the warm hits' (|Δ| <=
    OFF_SAME), admission's route event must price the restore, and the
    prefetch and restore series and spans must be there."""
    import numpy as np
    from repro_torch.core.kv_policy import MemoryModel
    from repro_torch.core.prefix_cache import token_chain
    from repro_torch.launch.serve import (instance_chip, make_pool,
                                          start_metrics_server)
    from repro_torch.models.layers import torch_dtype
    from repro_torch.runtime.fault_tolerance import rendezvous_hash
    from repro_torch.serving import (AdmissionController, AsyncServer,
                                     Rejected, SpanTracer, get_router)
    card = card_line()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(SEED + 23)

    def fresh(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    cap = 2 * (OFF_PROFILE + OFF_POST) // 16 * 16
    kv = cfg.kv_bytes_per_token(torch_dtype(cfg.dtype).itemsize)
    pool = make_pool(cfg.name, 2, reduced=False, profile=True, offload=True,
                     device=dev, params=params, cache_tokens=cap,
                     ecfg=dict(host_cache_bytes=4 * cap * kv,
                               max_pack_requests=1))
    print(pool_sizes(cfg, pool, "(d)"), flush=True)
    engines = pool.engines
    for name, eng in engines.items():
        if not eng.cache.policy.worth_restoring(cfg, 16, eng.block_bytes()):
            fail(f"serve (d): {name}'s policy recomputes at its measured "
                 "link, so the tier has no restore to serve")
    marks = mark([cold], made=engines.values())
    tracer = SpanTracer()
    server = AsyncServer(
        pool, router=get_router("user_hash"),
        admission=AdmissionController(memory_model=MemoryModel(
            cfg, instance_chip(pool))),
        tracer=tracer).start()
    exporter = start_metrics_server(server.metrics, 0, tracer=tracer)
    address = exporter.server_address[:2]
    users = {"userA": fresh(OFF_PROFILE) + fresh(OFF_POST),
             "userB": fresh(OFF_PROFILE) + fresh(OFF_POST)}
    log = []            # (label, user, tokens, result)

    def ask(user, toks, label):
        res = server.submit(user, toks, allowed_tokens=SERVE_ANSWER).result(
            timeout=600)
        log.append((label, user, toks, res))
        return res

    def ask_behind(user, toks, busy, label):
        """Submit ``busy``, wait until it runs on the user's instance, then
        submit ``toks``."""
        eng = engines[rendezvous_hash(user, sorted(engines))]
        first = server.submit(user, busy, allowed_tokens=SERVE_ANSWER)
        deadline = time.monotonic() + 600
        while not eng._inflight and time.monotonic() < deadline:
            time.sleep(0.0005)
        fut = server.submit(user, toks, allowed_tokens=SERVE_ANSWER)
        log.append((label + " (ahead)", user, busy, first.result(timeout=600)))
        res = fut.result(timeout=600)
        log.append((label, user, toks, res))
        return res

    t0 = time.perf_counter()
    try:
        for u, toks in users.items():
            ask(u, toks, "miss")
        warm = {}
        for u, toks in users.items():
            ask(u, toks, "hit")
            warm[u] = ask(u, toks, "warm hit")
        got, restored, prefetched = None, {}, {}
        for u, toks in users.items():
            # on the card at routing (an earlier user's flood on a shared
            # instance may have demoted it), so no prefetch starts, then
            # demoted by the flood ahead of it: its step restores
            ask(u, toks, "hit")
            restored[u] = ask_behind(u, toks, fresh(cap), "restored hit")
            if got is None:
                got = fetch(address)          # the scrape, while (d) runs
            ask(u, fresh(cap), "flood")
            eng = engines[rendezvous_hash(u, sorted(engines))]
            chain = token_chain(toks, 16)
            if eng.cache.match_tiers(chain) != ["host"] * len(chain):
                fail(f"serve (d): the flood left {u}'s blocks "
                     f"{eng.cache.match_tiers(chain)}")
            prefetched[u] = ask_behind(u, toks, fresh(len(toks)),
                                       "prefetched hit")
        join_prefetch()
        wall = time.perf_counter() - t0
        got["/trace.chrome.json"] = fetch(address)["/trace.chrome.json"]
    finally:
        server.shutdown(drain=True, timeout=60)
        exporter.shutdown()
        exporter.server_close()
    outcomes = [res for _, _, _, res in log]
    served = [o["req_id"] for o in outcomes if not isinstance(o, Rejected)]
    obs = check_observability("(d)", got, server, served)
    print(serve_line(torch, cfg, "(d) offload tier", server, outcomes, wall,
                     card) + f"; {obs}", flush=True)
    check_fault_free(cfg, "(d)", server, pool, outcomes)
    recs = {rid: r for r in tracer.snapshot() for rid in r["rids"]}

    def timeline(res):
        rec = recs[res["req_id"]]
        route = next(e for e in rec["events"] if e["name"] == "route")
        return route["restore_s"], {s["name"] for s in rec["spans"]}

    m = server.metrics
    series = {k: (m.total(f"kv_{k}_blocks"), m.total(f"kv_{k}_bytes"),
                  m.merged_histogram(f"kv_{k}_seconds").count)
              for k in ("restore", "prefetch")}
    same = max(score_diff(r, warm[u], SERVE_ANSWER)
               for part in (restored, prefetched) for u, r in part.items())
    lines = []
    for u in users:
        rs, rspans = timeline(restored[u])
        ps, pspans = timeline(prefetched[u])
        lines.append(f"{u}: restored hit n_cached "
                     f"{restored[u]['n_cached']} route restore_s {rs:.3e} "
                     f"spans {sorted(rspans)}; prefetched hit route "
                     f"restore_s {ps:.3e} spans {sorted(pspans)}")
        if ("restore" not in rspans or ps <= 0 or "prefetch" not in pspans
                or not restored[u]["n_cached"]):
            fail(f"serve (d): {lines[-1]}")
    print(f"{cfg.name} serve (d): " + "; ".join(lines) + f"; "
          f"prefetches_triggered {m.total('prefetches_triggered')}; "
          f"kv_(blocks, bytes, episodes) {series}; |restored score - warm "
          f"hit| {same:.3e} (limit {OFF_SAME})", flush=True)
    if (m.total("prefetches_triggered") < 1 or same > OFF_SAME
            or not all(all(v) for v in series.values())):
        fail("serve (d): no route-time prefetch, a restore or prefetch "
             "series is empty, or a restored score moved")
    worst = cold_diff(cold, [toks for _, _, toks, _ in log], outcomes, {})
    print(f"{cfg.name} serve (d): max |score - cold solo engine| "
          f"{worst:.3e} over {len(outcomes)} served (gate {SCORE_GATE})",
          flush=True)
    if worst >= SCORE_GATE:
        fail("serve (d): scores disagree with a cold engine")
    return check_launches(torch, cfg, "(d)", marks)


def serve_short(torch, dev, cfg, params, cold):
    """(e) A short WL1 replay (SERVE_E) through two profiled instances."""
    from repro_torch.launch.serve import make_pool
    card = card_line()
    reset_launches()
    pool = make_pool(cfg.name, 2, reduced=False, profile=True, device=dev,
                     params=params, cache_tokens=SERVE_E_CACHE)
    print(pool_sizes(cfg, pool, "(e)"), flush=True)
    marks = mark([cold], made=pool.engines.values())
    _, _, launches, _ = replay(torch, cfg, "(e) WL1 short", pool, cold, card,
                               marks, memo={}, **SERVE_E)
    return launches


if __name__ == "__main__":
    sys.exit(main())
