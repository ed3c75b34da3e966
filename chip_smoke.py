#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
then runs these phases and raises on the first failure:

  1. prints the card (``nvidia-smi`` name and power limit) and build time;
  2. holds each kernel against its plain PyTorch version on the card at
     the main path's shapes, in bf16 (the tensor-core kernels) and once in
     f32 (the CUDA-core kernels), and times kernel, plain version and one
     library call used only as a yardstick: the fused MLP at T = 16, 128,
     512 and 2048; flash attention in its three modes: dense (causal
     S = 512 and 2048, and the hit's 128 queries over 1152 keys),
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
     the logits (per segment: max and mean |Δ| limits, and the plain
     argmax within the kernel's top 5);
  4. drives the solo path: ``PrefillOnlyEngine(max_pack_requests=1)`` runs
     the profile run, then serves requests of two users that each share a
     1030-token profile prefix — misses first, then prefix-cache hits —
     checks that every forward launched each kernel (49, 24 and 24 launches
     per forward) and that the scores of every hit, at both (S, P) shapes,
     match a cold engine's; prints the warm step latency per shape, then
     traces one more miss step and hit step with ``torch.profiler``;
  5. drives the packed path: ``PrefillOnlyEngine()`` (packing on, the
     reference's defaults) runs the profile run, then waves of distinct
     users' misses that co-pack into packed-miss steps and waves of those
     users' prefix-cache hits that co-pack into packed-hit steps (Nb >= 4,
     pmax = 1024); every score is held against a solo engine's on the same
     weights and requests, launches are 49/24/24 per forward (the packed
     forwards through the segmented and positioned modes); prints the warm
     packed step walls per shape beside the solo walls of the same
     requests, and traces one warm packed-miss and packed-hit step (every
     traced step must name the tensor-core kernels it ran);
  6. drives the dense decode path through ``build(cfg)``: flash decoding
     (B6) against its plain version at the decode path's shape (B=16,
     S=32768, bf16 and f32), a ragged, a GQA and a head_dim-32 softcap
     case, each timed with an SDPA yardstick and its live-slot bound; then
     full-width ``decode_step`` — 8 steps after a 1024-token ``prefill``
     (B=2), each step's logits against ``prefill`` of the same prefix,
     through the kernels and through the plain versions — and 8 steps at
     positions 32760..32767 of a 48 GiB ``init_cache(16, 32768)`` filled
     from a seed (49/24/24 launches per step and no flash attention, the
     cache written in place at one slot per layer, peak memory under cache
     + weights + 1 GiB), with the warm step wall, tokens/s and a
     ``torch.profiler`` trace of one warm step;
  7. prints the ``kernels`` JSON line (every kernel and attention mode),
     then the result line ``{"ok": true, "device": {...}}`` last.

It exits non-zero, printing no result, when CUDA is unavailable or when run
outside a checkout.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

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
# (|plain| ~0.01 at S = 32768): a fixed 2e-2 would pass a kernel that drops
# whole chunks. The atol sits far below what a dropped chunk reads and the
# rtol above one bf16 ulp (2^-7 relative at most)
DEC_BF16_TOL = (1e-3, 2e-2)
LOGITS_MAX_TOL = 0.15           # full-width logits, std ~0.6 at random init
LOGITS_MEAN_TOL = 0.02
TOP_K = 5                       # the plain argmax ranks in the kernel's top 5
SCORE_GATE = 2e-2               # the repo's engine score gate
SPIN_CYCLES = 2_000_000         # ~1 ms of device spin ahead of a timed call

# packed-miss kernel shape: segments of mixed lengths, then padding slack
SEG_LENS = (64, 400, 128, 256, 96, 300, 180, 72, 350, 110)
SEG_S = 2048
# packed-hit kernel shape: per-row cached prefix and suffix lengths
HIT_PLENS, HIT_SLENS, HIT_S, HIT_PMAX = (1024, 768, 512, 1024), \
    (128, 96, 160, 128), 512, 1024
# decode: the JAX package's decode_32k shape (B=128, S=32768) cut to B=16,
# since its 384 GiB of KV does not fit one 80 GB card (16 rows: 48 GiB)
DEC_B, DEC_S, DEC_STEPS = 16, 32768, 8
DEC_PREFIX, DEC_CONS_B = 1024, 2      # consistency: prefill 1024 tokens, B=2

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
    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    print(f"build: {len(SOURCES)} kernels in "
          f"{time.perf_counter() - t0:.1f} s (parallel nvcc, sm_90a)",
          flush=True)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    results = check_kernels(torch, dev)
    results.update(check_packed_kernels(torch, dev))
    results.update(check_decode_kernel(torch, dev))
    check_full_prefill(torch, dev)
    check_packed_forwards(torch, dev)
    solo = run_engine(torch, dev)
    packed = run_packed_engine(torch, dev)
    decode = run_decode(torch, dev)
    paths = (solo, packed, decode)
    launches = {k: sum(p.get(k, 0) for p in paths)
                for k in set().union(*paths)}
    print(f"main path launches (solo engine + packed engine + decode "
          f"steps): {launches}", flush=True)

    lines = []
    for name, counter, replaces in KERNELS:
        r = results[name]
        lines.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      f"{SOURCE.get(name, 'flash_attention')}.cu",
            "replaces": replaces, "launches": launches[counter],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]})
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


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


def check_kernels(torch, dev):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.runtime.hw import H100_SXM as chip

    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16

    def randn(*shape, std=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    out = {}

    # RMSNorm at T=512, D=1024
    # each kernel is checked in f32, then in bf16 on the inputs it is timed
    # on: an entry's max_abs_err is that bf16 check's, f32_err the f32 one's
    T, D = 512, 1024
    errs = {}
    for dtype, tol in ((torch.float32, F32_TOL), (bf16, BF16_TOL)):
        x, w = randn(T, D, dtype=dtype), randn(D, std=0.1, dtype=dtype)
        errs[dtype] = compare(torch, rn.rmsnorm(x, w), rn.rmsnorm_plain(x, w),
                              tol, f"rmsnorm {dtype}")
    w1 = (1.0 + w.float()).to(bf16)
    b_ms, b_by = bound(chip, 4.0 * T * D, 2 * (2 * T * D + D))
    out["rmsnorm"] = dict(
        max_abs_err=errs[bf16], f32_err=errs[torch.float32],
        ms=time_ms(torch, lambda: rn.rmsnorm(x, w)),
        plain_ms=time_ms(torch, lambda: rn.rmsnorm_plain(x, w)),
        library_ms=time_ms(torch, lambda: F.rms_norm(x, (D,), w1, 1e-6)),
        bound_ms=b_ms, bound_by=b_by, shape=f"T={T} D={D} bf16")
    report("rmsnorm", out["rmsnorm"])

    # attention cases: (label, B, Sq, Sk, H, KV, d, kwargs); the first is
    # the JSON row, causal_2048 the solo miss's shape
    cases = [
        ("causal", 1, 512, 512, 16, 16, 64, dict()),
        ("causal_2048", 1, 2048, 2048, 16, 16, 64, dict()),
        ("q_offset", 1, 128, 1152, 16, 16, 64, dict(q_offset=1024)),
        ("gqa_window_softcap_padded", 2, 300, 300, 16, 4, 64,
         dict(window=128, softcap=30.0, kv_valid=250)),
        ("noncausal_d32", 1, 96, 200, 8, 8, 32, dict(causal=False)),
    ]
    for label, B, Sq, Sk, H, KV, d, kw in cases:
        dtypes = ((torch.float32, F32_TOL), (bf16, ATTN_BF16_TOL)) \
            if label == "causal" else ((bf16, ATTN_BF16_TOL),)
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

        def library(qt=qt, kt=kt, vt=vt, mask=mask):
            # the causal cases use SDPA's own causal mode; the others give
            # it the live mask (the softcap case has no SDPA counterpart)
            if mask is None:
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

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

    # fused MLP at qwen1.5-0.5b width (D=1024, F=2816) and the main path's
    # token counts: a decode step's T=16, a solo hit's 128, the packed
    # hit's 512 (the JSON row) and a miss's 2048
    D, Fd = 1024, 2816
    for T in (512, 16, 128, 2048):
        errs = {}
        for dtype, tol in (((torch.float32, F32_TOL), (bf16, MLP_BF16_TOL))
                           if T == 512 else ((bf16, MLP_BF16_TOL),)):
            x = randn(T, D, dtype=dtype)
            wg, wu, wd = (randn(D, Fd, std=D ** -0.5, dtype=dtype),
                          randn(D, Fd, std=D ** -0.5, dtype=dtype),
                          randn(Fd, D, std=Fd ** -0.5, dtype=dtype))
            got = fm.fused_mlp(x, wg, wu, wd)
            want = fm.fused_mlp_plain(x, wg, wu, wd)
            errs[dtype] = compare(torch, got, want, tol,
                                  f"fused_mlp T={T} {dtype}")
        report_limit(torch, f"fused_mlp[T={T}]", got, want, MLP_BF16_TOL,
                     mlp_skips(torch, fm, x, wg, wu, wd, want, MLP_BF16_TOL))
        b_ms, b_by = bound(chip, 6.0 * T * D * Fd,
                           2 * (2 * T * D + 3 * D * Fd))
        plan = fm.mlp_plan(T, D, Fd, fm._sm_count(dev.index))
        row = dict(
            max_abs_err=errs[bf16], f32_err=errs.get(torch.float32),
            ms=time_ms(torch, lambda: fm.fused_mlp(x, wg, wu, wd)),
            plain_ms=time_ms(torch, lambda: fm.fused_mlp_plain(x, wg, wu,
                                                               wd)),
            library_ms=time_ms(torch,
                               lambda: (F.silu(x @ wg) * (x @ wu)) @ wd),
            bound_ms=b_ms, bound_by=b_by,
            shape=f"T={T} D={D} F={Fd} bf16, gate/up tile {plan.gate_up}, "
                  f"down tile {fm.DOWN_TILE} x {plan.splits} d_ff splits")
        report("fused_mlp" if T == 512 else f"fused_mlp[T={T}]", row)
        if T == 512:
            out["fused_mlp"] = row
    return out


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


def check_packed_kernels(torch, dev):
    """Phase 2, packed modes: the segmented (packed miss) and positioned
    (packed hit) attention at full width against the plain version, in f32
    and bf16; the kernel's executed-tile map against the plain tile rule;
    times and live-layout bounds."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.runtime.hw import H100_SXM as chip

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    H = KV = 16
    d = 64
    cases = (
        ("segmented", SEG_S, SEG_S,
         packed_case(dev, SEG_LENS, SEG_S)[1],
         f"S={SEG_S} segments={len(SEG_LENS)} ({min(SEG_LENS)}..."
         f"{max(SEG_LENS)}, tail {SEG_S - sum(SEG_LENS)})"),
        ("positioned", HIT_S, len(HIT_PLENS) * HIT_PMAX + HIT_S,
         packed_case(dev, HIT_SLENS, HIT_S, HIT_PLENS, HIT_PMAX)[1],
         f"Sq={HIT_S} Sk={len(HIT_PLENS) * HIT_PMAX + HIT_S} "
         f"plens={HIT_PLENS} suffixes={HIT_SLENS} pmax={HIT_PMAX}"),
    )
    out = {}
    for label, Sq, Sk, ids, desc in cases:
        errs = {}
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, ATTN_BF16_TOL)):
            q = (torch.randn((1, Sq, H, d), generator=gen, device=dev)
                 ).to(dtype)
            k, v = ((torch.randn((1, Sk, KV, d), generator=gen, device=dev)
                     ).to(dtype) for _ in range(2))
            bq, bk = fa.tile_shape(dtype)
            tmap = torch.empty((1, -(-Sq // bq), -(-Sk // bk)),
                               dtype=torch.int32, device=dev)
            got = fa.flash_attention(q, k, v, tile_map=tmap, **ids)
            want = fa.flash_attention_plain(q, k, v, **ids)
            errs[dtype] = compare(torch, got, want, tol,
                                  f"flash_attention {label} {dtype}")
            pad = ids["seg_q"][0] < 0
            if pad.any() and got[0, pad].abs().max().item() != 0.0:
                fail(f"flash_attention {label}: a padding row is not 0")
            # the executed tiles against the plain rule at the kernel's
            # own tile size (bf16: BLOCK_Q x BLOCK_K; f32: 32 x 32)
            want_map = tile_rule(Sq, Sk, block_q=bq, block_k=bk, **ids)
            causal_map = tile_rule(Sq, Sk, block_q=bq, block_k=bk)
            ran, total = int(tmap.sum()), tmap.numel()
            print(f"tiles {label} {dtype}: kernel ran {ran} of {total} "
                  f"{bq}x{bk} tiles, plain tile rule {int(want_map.sum())} "
                  f"(causal-only structural rule {int(causal_map.sum())}); "
                  f"maps equal: {bool(torch.equal(tmap, want_map))}",
                  flush=True)
            if not torch.equal(tmap, want_map):
                fail(f"flash_attention {label} {dtype}: executed-tile map "
                     f"differs from the plain tile rule")
        live = fa._live_mask(Sq, Sk, causal=True, window=0, q_offset=0,
                             kv_valid=None, device=dev, **ids)
        report_limit(torch, f"flash_attention[{label}]", got, want,
                     ATTN_BF16_TOL, attention_skips(torch, fa, q, k, v, live,
                                                    want, ATTN_BF16_TOL))
        pairs = int(live.sum().item()) * H
        nbytes = live_bytes(ids, Sq, H, KV, d)
        b_ms, b_by = bound(chip, 4.0 * d * pairs, nbytes)
        print(f"bound {label}: {nbytes} bytes (live layout), {pairs} live "
              f"(q, k) pairs over {H} heads -> {b_ms:.6f} ms ({b_by})",
              flush=True)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = live[:, None]                          # (1, 1, Sq, Sk)

        def library(qt=qt, kt=kt, vt=vt, mask=mask):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        row = dict(
            max_abs_err=errs[torch.bfloat16],
            f32_err=errs[torch.float32],
            ms=time_ms(torch, lambda: fa.flash_attention(q, k, v, **ids)),
            plain_ms=time_ms(torch,
                             lambda: fa.flash_attention_plain(q, k, v,
                                                              **ids)),
            library_ms=time_ms(torch, library),
            bound_ms=b_ms, bound_by=b_by,
            shape=f"{desc} H={H} KV={KV} d={d} bf16, live pairs/head "
                  f"{pairs // H}, tiles run {ran}/{total}")
        report(f"flash_attention[{label}]", row)
        out[f"flash_attention[{label}]"] = row
    return out


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


def check_decode_kernel(torch, dev):
    """Phase 2, flash decoding (B6): the kernel against its plain version on
    the card at the decode path's shape (bf16, and once in f32) and at a
    ragged, a GQA and a head_dim-32 softcap shape; times with an SDPA
    yardstick over the live slots; live-slot bounds."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.runtime.hw import H100_SXM as chip

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    rng = np.random.default_rng(SEED + 9)
    ragged = [1, 1000, 10923, DEC_S] + rng.integers(
        1, DEC_S + 1, DEC_B - 4).tolist()
    # (label, B, S, H, KV, d, kv_len, softcap)
    cases = (
        ("decode_path", DEC_B, DEC_S, 16, 16, 64, [DEC_S] * DEC_B, 0.0),
        ("ragged", DEC_B, DEC_S, 16, 16, 64, ragged, 0.0),
        ("gqa", 4, 8192, 16, 2, 64, [8192, 5000, 77, 8192], 0.0),
        ("d32_softcap", 4, 4100, 8, 4, 32, [4100, 4099, 2050, 1], 50.0),
    )
    out = {}
    for label, B, S, H, KV, d, lens, cap in cases:
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        errs = {}
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, DEC_BF16_TOL)):
            q = torch.randn((B, 1, H, d), generator=gen, device=dev).to(dtype)
            k, v = (torch.randn((B, S, KV, d), generator=gen, device=dev
                                ).to(dtype) for _ in range(2))
            errs[dtype] = compare(
                torch, da.decode_attention(q, k, v, kv_len, softcap=cap),
                da.decode_attention_plain(q, k, v, kv_len, softcap=cap), tol,
                f"decode_attention {label} {dtype}")
            if dtype == torch.float32:
                del q, k, v
        live = decode_live(k, kv_len)
        nbytes = decode_bound_bytes(q, k, kv_len)
        pairs = live * H
        b_ms, b_by = bound(chip, 4.0 * d * pairs, nbytes)
        splits, chunk = da.split_rule(B * KV, S, da._sm_count(dev.index))
        print(f"bound decode_attention[{label}]: {nbytes} bytes (q, output, "
              f"kv_len and K/V over {live} live slots of {B * S}), {pairs} "
              f"live (q, slot) pairs over {H} heads -> {b_ms:.6f} ms "
              f"({b_by}); split rule: {splits} splits of {chunk} slots, "
              f"{B * KV * splits} blocks", flush=True)
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
                  f"slots {live}/{B * S}")
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
    mods = kernel_modules()
    for name in ("rmsnorm", "fused_mlp", "decode_attention"):
        mods[name].launches = 0
    modes = mods["flash_attention"].mode_launches
    for mode in modes:
        modes[mode] = 0


def read_launches():
    """Launches per kernel (attention: the sum of its modes' counts), and
    of the attention kernel per mode."""
    mods = kernel_modules()
    out = {name: m.launches for name, m in mods.items()}
    for mode, n in mods["flash_attention"].mode_launches.items():
        out[f"flash_attention[{mode}]"] = n
    return out


def kernel_launches(launches):
    """The kernels' totals (every attention mode counted once)."""
    return {k: launches[k] for k in kernel_modules()}


def per_forward(cfg):
    return {"rmsnorm": 2 * cfg.num_layers + 1,
            "flash_attention": cfg.num_layers, "fused_mlp": cfg.num_layers,
            "decode_attention": 0}


def per_decode_step(cfg):
    return {"rmsnorm": 2 * cfg.num_layers + 1, "flash_attention": 0,
            "fused_mlp": cfg.num_layers, "decode_attention": cfg.num_layers}


def model(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params
    cfg = get_config("qwen1.5-0.5b")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return cfg, init_params(cfg, gen, device=dev)


def check_full_prefill(torch, dev) -> None:
    import numpy as np
    from repro_torch.models import transformer as tfm
    cfg, params = model(torch, dev)
    n_params = sum(a.numel() for a in _leaves(params))
    print(f"model: {cfg.name} L={cfg.num_layers} d_model={cfg.d_model} "
          f"heads={cfg.num_heads}/{cfg.num_kv_heads} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} params={n_params} {cfg.dtype}", flush=True)
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
    print(f"full prefill S=512: logits std={want.std().item():.4f} "
          f"max|kernel-plain|={err.max().item():.4e} "
          f"mean={err.mean().item():.4e} argmax "
          f"{int(got.argmax())} vs {int(want.argmax())}", flush=True)
    if err.max().item() > LOGITS_MAX_TOL or err.mean().item() > LOGITS_MEAN_TOL:
        fail(f"full prefill logits disagree: max {err.max().item():.3e} "
             f"(<= {LOGITS_MAX_TOL}), mean {err.mean().item():.3e} "
             f"(<= {LOGITS_MEAN_TOL})")


def compare_rows(torch, got, want, what: str, names=("kernel", "plain"),
                 unit: str = "segment") -> None:
    """Per-segment logits, kernels against plain versions (or, with
    ``names``, any path against its reference): max and mean |Δ| within the
    full-width limits, and the reference's argmax among the top 5 of
    ``got`` (an equal argmax means little at random init, where the top
    two of 151,936 logits often lie closer than bf16's rounding over 24
    layers; the top-two gap is printed beside each)."""
    a, b = names
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite logits")
    for n in range(got.shape[0]):
        err = (got[n] - want[n]).abs()
        a_want = int(want[n].argmax())
        top = got[n].topk(TOP_K).indices.tolist()
        two = want[n].topk(2).values
        rank = top.index(a_want) + 1 if a_want in top else None
        print(f"{what} {unit} {n}: max|{a}-{b}|={err.max().item():.4e} "
              f"mean={err.mean().item():.4e} {b} argmax {a_want} at "
              f"{a} rank {rank if rank else f'>{TOP_K}'}, {b} top-two "
              f"gap {(two[0] - two[1]).item():.4e}", flush=True)
        if (err.max().item() > LOGITS_MAX_TOL
                or err.mean().item() > LOGITS_MEAN_TOL or rank is None):
            fail(f"{what} {unit} {n}: logits disagree")


def check_packed_forwards(torch, dev) -> None:
    """Phase 3, packed: full-width ``prefill_packed`` (the segmented kernel
    shape) and ``prefill_packed_with_prefix`` (the positioned one, over
    prefix KV made by ``prefill``) through the kernels and through the plain
    versions; 49/24/24 launches per forward, every attention launch in the
    forward's mode."""
    import numpy as np
    from repro_torch.models import transformer as tfm
    cfg, params = model(torch, dev)
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

    N = len(HIT_PLENS)
    hlay, _ = packed_case(dev, HIT_SLENS, HIT_S, HIT_PLENS, HIT_PMAX)
    htoks = tokens(HIT_SLENS, HIT_S)
    shape = (Lyr, N, HIT_PMAX, cfg.num_kv_heads, cfg.head_dim)
    pk = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    pv = torch.zeros_like(pk)
    with torch.no_grad():
        for n, p in enumerate(HIT_PLENS):
            ptoks = torch.as_tensor(rng.integers(0, V, (1, p)), device=dev)
            _, kv = tfm.prefill(params, cfg, {"tokens": ptoks}, kv_keep=p)
            pk[:, n:n + 1, :p] = kv["k"]
            pv[:, n:n + 1, :p] = kv["v"]

    def hit():
        return tfm.prefill_packed_with_prefix(
            params, cfg, htoks, hlay["positions"], hlay["last_indices"],
            {"k": pk, "v": pv}, hlay["prefix_pos"], hlay["seg_qidx"],
            kv_indices=torch.arange(HIT_S, device=dev))

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
def run_engine(torch, dev):
    import numpy as np
    from repro_torch.core.engine import EngineConfig, PrefillOnlyEngine
    cfg, params = model(torch, dev)
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
    print(f"profile run: {time.perf_counter() - t0:.2f} s, JCT ~ "
          f"{eng.jct_model.a * 1e3:.4f} ms/token + "
          f"{eng.jct_model.b * 1e3:.3f} ms (pearson {r:.3f})", flush=True)
    served = []
    for toks in trace + trace:               # pass 2 reuses each whole chain
        rid = eng.submit(toks, allowed_tokens=(YES, NO))
        if eng.step() != rid:
            fail("the engine served another request than the one queued")
        res, rec = eng.results[rid], eng.batch_records[-1]
        served.append((toks, res, rec))
        print(f"step n_input={res['n_input']} n_cached={res['n_cached']} "
              f"S={rec.S} P={rec.pmax} wall_ms={rec.wall * 1e3:.3f} "
              f"first_use={rec.compiled} P(yes)={res['scores'].get(YES)}",
              flush=True)
    torch.cuda.synchronize()
    launches = read_launches()               # the main path ends here
    expect = {k: v * eng.forwards for k, v in per_forward(cfg).items()}
    print(f"launches over {eng.forwards} forwards: {launches} "
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
    print(f"hits vs cold engine, max |score diff| per (S, P): {worst} "
          f"(gate {SCORE_GATE})", flush=True)
    if len(worst) < 2 or max(worst.values()) >= SCORE_GATE:
        fail("prefix-cache hit scores disagree with a cold engine, or the "
             "hits did not cover both passes' shapes")
    warm = {}
    for rec in eng.batch_records:
        if not rec.compiled:
            warm.setdefault((rec.S, rec.pmax), []).append(rec.wall * 1e3)
    for (S, P), walls in sorted(warm.items()):
        print(f"step latency S={S} P={P}: warm wall median "
              f"{statistics.median(walls):.3f} ms (n={len(walls)})",
              flush=True)
    trace_steps(torch, eng, cfg, rng)
    return launches


def run_packed_engine(torch, dev):
    """Phase 5: the packed path. Packing on (the reference's defaults, and
    the profile run's autotune); each round brings four new users whose
    profiles (HIT_PLENS tokens) arrive as one wave of misses, then waves of
    their prefix-cache hits (HIT_SLENS-token posts). A solo engine on the
    same weights serves the same waves; every score must agree."""
    import numpy as np
    from repro_torch.core.engine import EngineConfig, PrefillOnlyEngine
    cfg, params = model(torch, dev)
    rng = np.random.default_rng(SEED + 3)
    V = cfg.vocab_size

    def round_waves(n_hit_waves: int):
        users = [rng.integers(0, V, p).tolist() for p in HIT_PLENS]
        waves = [("miss", users)]
        for _ in range(n_hit_waves):
            waves.append(("hit", [u + rng.integers(0, V, s).tolist()
                                  for u, s in zip(users, HIT_SLENS)]))
        return waves

    waves = round_waves(2) + round_waves(2)
    eng = PrefillOnlyEngine(cfg, params, EngineConfig(
        cache_capacity_tokens=65536), device=dev)
    reset_launches()                         # the packed path starts here
    eng.profile()
    print(f"packed engine: profile fit {eng.jct_model.a * 1e3:.4f} ms/token "
          f"+ {eng.jct_model.b * 1e3:.3f} ms; autotuned pack_token_budget="
          f"{eng.ecfg.pack_token_budget} max_pack_requests="
          f"{eng.ecfg.max_pack_requests} pack_prefix_budget="
          f"{eng.ecfg.pack_prefix_budget}", flush=True)
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
            print(f"packed step kind={rec.kind} n={rec.n_requests} S={rec.S} "
                  f"Nb={rec.Nb} smax={rec.smax} pmax={rec.pmax} K={rec.K} "
                  f"wall_ms={rec.wall * 1e3:.3f} first_use={rec.compiled}",
                  flush=True)
    torch.cuda.synchronize()
    launches = read_launches()               # the packed path ends here
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
    print(f"packed engine launches over {eng.forwards} forwards "
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
    if not any(r.kind == "hit" and r.Nb >= 4 and r.pmax == HIT_PMAX
               for r in eng.batch_records):
        fail(f"no packed hit step with Nb >= 4 and pmax = {HIT_PMAX}")

    worst = 0.0
    for kind, got, want, _, _ in served:
        for g, w in zip(got, want):
            if g["n_cached"] != w["n_cached"] or "corrupt" in g:
                fail(f"packed vs solo: {g} vs {w}")
            worst = max(worst, max(abs(g["scores"][t] - w["scores"][t])
                                   for t in (YES, NO)))
    print(f"packed engine vs solo engine, max |score diff| over "
          f"{sum(len(g) for _, g, _, _, _ in served)} requests: "
          f"{worst:.3e} (gate {SCORE_GATE}); stats: "
          f"{ {k: eng.stats()[k] for k in ('packed_steps', 'packed_requests', 'packed_hit_requests', 'pack_skew_splits')} }",
          flush=True)
    if worst >= SCORE_GATE:
        fail("packed scores disagree with the solo engine's")

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
            print(f"packed step latency kind={key[0]} S={key[1]} Nb={key[2]} "
                  f"smax={key[3]} pmax={key[4]}: warm wall median "
                  f"{statistics.median(walls):.3f} ms (n={len(walls)})",
                  flush=True)
    for kind in ("miss", "hit"):
        pairs = [(s, p) for s, p, warm in table.get(("wave", kind),
                                                    ([], []))[1] if warm]
        if pairs:
            print(f"wave of 4 {kind} requests: packed steps summed, warm "
                  f"median "
                  f"{statistics.median(p for _, p in pairs):.3f} ms vs solo "
                  f"steps summed {statistics.median(s for s, _ in pairs):.3f}"
                  f" ms (n={len(pairs)} waves)", flush=True)

    # one more warm packed-miss step and packed-hit step, traced
    for kind, reqs in round_waves(1):
        for t in reqs:
            eng.submit(t, allowed_tokens=(YES, NO))
        trace_one_step(torch, eng, kind, packed=True)
    return launches


# ---- phase 6: the dense decode path ------------------------------------------
def run_decode(torch, dev):
    """Full-width decode through ``build(cfg)``: the consistency check at
    B=2, then the depth run at B=16, S=32768. Returns the depth run's
    launches (its 8 steps are the decode path's counted run)."""
    import gc
    from repro_torch.models.model import build
    cfg, params = model(torch, dev)
    api = build(cfg)
    check_decode_consistency(torch, dev, api, params)
    gc.collect()
    torch.cuda.empty_cache()
    return run_decode_depth(torch, dev, api, params)


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
                             f"decode vs prefill ({route}) step {i} "
                             f"position {P + i}", names=("decode", "prefill"),
                             unit="row")


def run_decode_depth(torch, dev, api, params):
    """DEC_STEPS decode steps at positions S-8..S-1 of an
    ``init_cache(16, 32768)`` (48 GiB of bf16 KV) filled from a seeded
    generator one layer at a time in bf16: per-step launches (49/24/24, no
    flash attention), finite logits, the written slot new and finite in
    every layer while every other slot keeps its f32 checksum, and the peak
    memory of each step under cache + weights + 1 GiB (no cache copy).
    Prints the warm step wall, tokens/s and one traced warm step."""
    import numpy as np
    cfg = api.cfg
    B, S, Lyr = DEC_B, DEC_S, cfg.num_layers
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
    print(f"decode depth: init_cache({B}, {S}) {cache_bytes} bytes of "
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
    print(f"decode depth: {DEC_STEPS} steps at positions {P0}..{S - 1}, "
          f"launches {kernel_launches(launches)} ({per_decode_step(cfg)} "
          f"per step); written slot new and finite in all {Lyr} layers, "
          f"other slots' checksums unchanged; peak allocated over the steps "
          f"{peak} bytes (limit cache + weights + 1 GiB = {limit})",
          flush=True)
    if peak >= limit:
        fail("decode steps allocated more than cache + weights + 1 GiB: "
             "the cache was copied")
    warm = statistics.median(walls[1:])
    print(f"decode step latency B={B} S={S}: step walls "
          f"{[round(w, 3) for w in walls]} ms; warm wall median {warm:.3f} ms "
          f"(n={len(walls) - 1}), {B / warm * 1e3:.1f} tokens/s "
          f"(decode_32k cut from B=128 to B={B}: its 384 GiB of KV does not "
          f"fit one 80 GB card)", flush=True)
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
    report_trace(torch, prof, f"decode B={tokens.shape[0]} "
                 f"S={cache['k'].shape[2]}", wall, expect=TC_DECODE)


def trace_steps(torch, eng, cfg, rng) -> None:
    """One more warm miss step and one warm hit step (solo)."""
    user = rng.integers(0, cfg.vocab_size, PROFILE_LEN).tolist()
    for label in ("miss", "hit"):
        eng.submit(user + rng.integers(0, cfg.vocab_size, POST_LEN).tolist(),
                   allowed_tokens=(YES, NO))
        trace_one_step(torch, eng, label)


def trace_one_step(torch, eng, label: str, packed: bool = False) -> None:
    """Run the engine's next step under ``torch.profiler``: device time per
    kernel, of the other device ops (projections, RoPE, embedding, LM head,
    KV copies) and the device's idle share of the step's wall; then drain
    the queue unprofiled. Runs after the main path's launch counts were
    read. ``label`` is the kind the step must be: ``miss``/``hit`` (solo
    steps) or, with ``packed``, a packed step of that kind."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step()
    rec = eng.batch_records[-1]
    if packed:
        ok = rec.kind == label and rec.n_requests > 1
    else:
        ok = rec.kind == "solo" and (rec.pmax > 0) == (label == "hit")
    if not ok or rec.compiled:
        fail(f"traced step was not a warm {'packed ' if packed else ''}"
             f"{label} step: {rec}")
    eng.run_until_drained()
    if packed:
        label = (f"packed-{label} S={rec.S} Nb={rec.Nb} smax={rec.smax} "
                 f"pmax={rec.pmax} n={rec.n_requests}")
    else:
        label = f"{label} S={rec.S} P={rec.pmax}"
    report_trace(torch, prof, label, rec.wall * 1e3, expect=TC_PREFILL)


def report_trace(torch, prof, label: str, wall: float, expect=()) -> None:
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
    dev_ms, n, names = {}, {}, {}
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
    busy = sum(dev_ms.values())
    print(f"trace {label}: step wall {wall:.3f} ms "
          f"(profiled), device busy {busy:.3f} ms, idle share "
          f"{'not measured' if not busy else f'{1 - busy / wall:.4f}'}; "
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
    print(f"trace {label}: port kernels (launches): "
          + "; ".join(f"{g}: " + ", ".join(f"{k} ({c})" for k, c in
                                           sorted(per.items()))
                      for g, per in sorted(names.items())), flush=True)
    missing = [k for k in expect if not any(k in r for r in ran)]
    if missing:
        fail(f"trace {label}: {missing} did not run")


if __name__ == "__main__":
    sys.exit(main())
