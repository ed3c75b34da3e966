#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
then runs five phases and raises on the first failure:

  1. prints the card (``nvidia-smi`` name and power limit) and build time;
  2. holds each kernel against its plain PyTorch version on the card at
     the main path's shapes, in bf16 (and once in f32), and times kernel,
     plain version and one library call used only as a yardstick;
  3. runs a full-width 24-layer qwen1.5-0.5b ``prefill`` (random weights
     from a seed) through the kernels and through the plain versions, and
     compares the last-token logits;
  4. drives the main path: ``PrefillOnlyEngine(device="cuda")`` runs the
     profile run, then serves requests of two users that each share a
     1030-token profile prefix — misses first, then prefix-cache hits —
     checks that every forward launched each kernel (49, 24 and 24 launches
     per forward) and that the scores of every hit, at both (S, P) shapes,
     match a cold engine's; prints the warm step latency per shape, then
     traces one more miss step and hit step with ``torch.profiler``;
  5. prints the ``kernels`` JSON line, then the result line
     ``{"ok": true, "device": {...}}`` last.

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
LOGITS_MAX_TOL = 0.15           # full-width logits, std ~0.6 at random init
LOGITS_MEAN_TOL = 0.02
SCORE_GATE = 2e-2               # the repo's engine score gate
SPIN_CYCLES = 2_000_000         # ~1 ms of device spin ahead of a timed call

TPU_KERNELS = {
    "rmsnorm": "src/repro/kernels/rmsnorm.py:25",
    "flash_attention": "src/repro/kernels/flash_attention.py:166",
    "fused_mlp": "src/repro/kernels/fused_mlp.py:46",
}


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
    check_full_prefill(torch, dev)
    launches = run_engine(torch, dev)

    lines = []
    for name in SOURCES:
        r = results[name]
        lines.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": TPU_KERNELS[name], "launches": launches[name],
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

    # attention cases: (label, B, Sq, Sk, H, KV, d, kwargs)
    cases = [
        ("causal", 1, 512, 512, 16, 16, 64, dict()),
        ("q_offset", 1, 128, 1152, 16, 16, 64, dict(q_offset=1024)),
        ("gqa_window_softcap_padded", 2, 300, 300, 16, 4, 64,
         dict(window=128, softcap=30.0, kv_valid=250)),
        ("noncausal_d32", 1, 96, 200, 8, 8, 32, dict(causal=False)),
    ]
    for label, B, Sq, Sk, H, KV, d, kw in cases:
        dtypes = ((torch.float32, F32_TOL), (bf16, BF16_TOL)) \
            if label == "causal" else ((bf16, BF16_TOL),)
        errs = {}
        for dtype, tol in dtypes:
            q = randn(B, Sq, H, d, dtype=dtype)
            k, v = randn(B, Sk, KV, d, dtype=dtype), randn(B, Sk, KV, d,
                                                            dtype=dtype)
            errs[dtype] = compare(torch, fa.flash_attention(q, k, v, **kw),
                                  fa.flash_attention_plain(q, k, v, **kw),
                                  tol, f"flash_attention {label} {dtype}")
        live = fa._live_mask(Sq, Sk, causal=kw.get("causal", True),
                             window=kw.get("window", 0),
                             q_offset=kw.get("q_offset", 0),
                             kv_valid=kw.get("kv_valid"), device=dev)
        pairs = float(live.sum().item()) * B * H
        nbytes = 2 * (2 * B * Sq * H * d + 2 * B * Sk * KV * d)
        b_ms, b_by = bound(chip, 4.0 * d * pairs, nbytes)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = None if label == "causal" else live

        def library(qt=qt, kt=kt, vt=vt, mask=mask):
            # the causal case uses SDPA's own causal mode; the others give
            # it the live mask (the softcap case has no SDPA counterpart)
            if mask is None:
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        row = dict(
            max_abs_err=errs[bf16], f32_err=errs.get(torch.float32),
            ms=time_ms(torch, lambda: fa.flash_attention(q, k, v, **kw)),
            plain_ms=time_ms(torch,
                             lambda: fa.flash_attention_plain(q, k, v, **kw)),
            library_ms=(time_ms(torch, library)
                        if not kw.get("softcap") else None),
            bound_ms=b_ms, bound_by=b_by,
            shape=f"B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} d={d} {label} bf16")
        report(f"flash_attention[{label}]", row)
        if label == "causal":
            out["flash_attention"] = row

    # fused MLP at T=512, D=1024, F=2816
    T, D, Fd = 512, 1024, 2816
    errs = {}
    for dtype, tol in ((torch.float32, F32_TOL), (bf16, BF16_TOL)):
        x = randn(T, D, dtype=dtype)
        wg, wu, wd = (randn(D, Fd, std=D ** -0.5, dtype=dtype),
                      randn(D, Fd, std=D ** -0.5, dtype=dtype),
                      randn(Fd, D, std=Fd ** -0.5, dtype=dtype))
        errs[dtype] = compare(torch, fm.fused_mlp(x, wg, wu, wd),
                              fm.fused_mlp_plain(x, wg, wu, wd), tol,
                              f"fused_mlp {dtype}")
    b_ms, b_by = bound(chip, 6.0 * T * D * Fd, 2 * (2 * T * D + 3 * D * Fd))
    out["fused_mlp"] = dict(
        max_abs_err=errs[bf16], f32_err=errs[torch.float32],
        ms=time_ms(torch, lambda: fm.fused_mlp(x, wg, wu, wd)),
        plain_ms=time_ms(torch, lambda: fm.fused_mlp_plain(x, wg, wu, wd)),
        library_ms=time_ms(torch, lambda: (F.silu(x @ wg) * (x @ wu)) @ wd),
        bound_ms=b_ms, bound_by=b_by, shape=f"T={T} D={D} F={Fd} bf16")
    report("fused_mlp", out["fused_mlp"])
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
    from repro_torch.kernels import flash_attention, fused_mlp, rmsnorm
    return {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
            "fused_mlp": fused_mlp}


@contextlib.contextmanager
def plain_versions():
    """Route the model's three kernel wrappers to their plain versions (the
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
    for m in kernel_modules().values():
        m.launches = 0


def read_launches():
    return {name: m.launches for name, m in kernel_modules().items()}


def per_forward(cfg):
    return {"rmsnorm": 2 * cfg.num_layers + 1,
            "flash_attention": cfg.num_layers, "fused_mlp": cfg.num_layers}


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
        if read_launches() != per_forward(cfg):
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
    if launches != expect:
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


def trace_steps(torch, eng, cfg, rng) -> None:
    """One more warm miss step and one warm hit step, each under
    ``torch.profiler``: device time per kernel, of the other device ops
    (projections, RoPE, embedding, LM head) and the device's idle share of
    the step's wall. Runs after the main path's launch counts were read."""
    from torch.profiler import ProfilerActivity, profile
    groups = (("flash_fwd", "flash_attention"), ("fused_mlp", "fused_mlp"),
              ("rmsnorm", "rmsnorm"))
    user = rng.integers(0, cfg.vocab_size, PROFILE_LEN).tolist()
    for label in ("miss", "hit"):
        rid = eng.submit(user + rng.integers(0, cfg.vocab_size,
                                             POST_LEN).tolist(),
                         allowed_tokens=(YES, NO))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.step()
        rec = eng.batch_records[-1]
        if (eng.results[rid]["n_cached"] > 0) != (label == "hit") \
                or rec.compiled:
            fail(f"traced {label} step was not a warm {label}")
        dev_ms, n = {}, {}
        evs = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        for e in evs:
            g = next((g for k, g in groups if k in e.name), "other")
            dev_ms[g] = dev_ms.get(g, 0.0) + e.time_range.elapsed_us() / 1e3
            n[g] = n.get(g, 0) + 1
        busy = sum(dev_ms.values())
        wall = rec.wall * 1e3
        print(f"trace {label} S={rec.S} P={rec.pmax}: step wall {wall:.3f} ms "
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


if __name__ == "__main__":
    sys.exit(main())
