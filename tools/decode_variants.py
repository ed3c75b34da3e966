"""Flash decoding's tensor-core kernel (B6, bf16 at G >= 2) under other ring
depths, key tiles and block sizes, on one card, in one process.

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python tools/decode_variants.py [--variants 3x64x128,2x64x128,...]

Each variant ``STAGESxTILExTHREADS`` is this checkout's
``csrc/decode_attention.cu`` with its ``kStages``, ``kTile`` and
``kTcThreads`` set so (a suffix ``-L2:N`` also sets the L2 prefetch of
its 16-byte ``cp.async`` copies to N bytes, 64, 128 or 256, or none for
0), compiled (all variants' ``nvcc`` at once) into
``src/repro_torch/kernels/build/variants/`` and loaded in turn in place of
the built library, so the wrapper (its split rule reading each variant's
own residency) runs it. Each is held against the plain version and timed
with ``chip_smoke.time_ms`` in turns (forward, then backward order, three
rounds) beside SDPA, at granite-3-8b's decode shape, the G 8 case of
``chip_smoke.py`` and two more GQA shapes. The first variant listed should
be the source as it is (3x64x128). The last line is a JSON object of the
results.
"""
import argparse
import ctypes
import json
import pathlib
import shutil
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# (label, B, S, H, KV, d, kv_len)
SHAPES = (("granite decode_path", 8, 32768, 32, 8, 128, None),
          ("gqa G8", 4, 8192, 16, 2, 64, (8192, 5000, 77, 8192)),
          ("G2 d128", 8, 32768, 16, 8, 128, None),
          ("G4 d64", 8, 32768, 32, 8, 64, None))
CONSTANTS = ("constexpr int kStages = {}", "constexpr int kTile = {}",
             "constexpr int kTcThreads = {}")
COPY = "cp.async.cg.shared.global.L2::128B [%0]"


def build(_build, variants):
    """Compile every variant at once; returns {name: library path}."""
    out = _build.BUILD_DIR / "variants"
    src = (_build.CSRC / "decode_attention.cu").read_text()
    jobs = {}
    for name in variants:
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for h in _build.CSRC.glob("*.cuh"):
            shutil.copy(h, d)
        shape, _, l2 = name.partition("-L2:")
        text = src
        if l2:
            assert COPY in text
            text = text.replace(COPY, COPY.replace(
                ".L2::128B", f".L2::{l2}B" if int(l2) else ""))
        for pattern, value in zip(CONSTANTS, shape.split("x")):
            now = next(line for line in text.splitlines()
                       if line.startswith(pattern.format("")))
            text = text.replace(now, pattern.format(value) + ";")
        (d / "decode_attention.cu").write_text(text)
        jobs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "decode_attention.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, job in jobs.items():
        log, _ = job.communicate()
        if job.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = out / name / "lib.so"
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default="3x64x128,2x64x128,4x64x128,"
                    "6x32x128,4x32x128,3x64x256")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("decode_variants: needs a CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    import chip_smoke as smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da

    print(f"card: {smoke.card_line()}", flush=True)
    variants = args.variants.split(",")
    libs = build(_build, variants)

    def use(name):
        _build._libs["decode_attention"] = ctypes.CDLL(str(libs[name]))
        for key in [k for k in _build._fns if k[0] == "decode_attention"]:
            del _build._fns[key]
        da._blocks_per_sm.cache_clear()

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    results = []
    for label, B, S, H, KV, d, lens in SHAPES:
        kv_len = torch.tensor(lens or [S] * B, dtype=torch.int32, device=dev)
        q = torch.randn((B, 1, H, d), generator=gen, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((B, S, KV, d), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        want = da.decode_attention_plain(q, k, v, kv_len)
        plans, times = {}, {n: [] for n in variants}
        for name in variants:
            use(name)
            smoke.compare(torch, da.decode_attention(q, k, v, kv_len), want,
                          smoke.DEC_BF16_TOL, f"variant {name} {label}")
            plans[name] = smoke.decode_plan(dev, B, S, H, KV, d,
                                            torch.bfloat16)
        for r in range(3):
            for name in variants if r % 2 == 0 else variants[::-1]:
                use(name)
                times[name].append(smoke.time_ms(
                    torch, lambda: da.decode_attention(q, k, v, kv_len)))
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        mask = None if lens is None else (
            torch.arange(S, device=dev)[None, :] < kv_len[:, None]
        )[:, None, None, :]
        lib = smoke.time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True))
        for name in variants:
            p = plans[name]
            ms = statistics.median(times[name])
            results.append(dict(shape=label, variant=name, ms=ms,
                                readings=times[name], sdpa_ms=lib,
                                plan=p._asdict()))
            print(f"variant {name} (stages x tile x threads) "
                  f"decode_attention[{label}]: {ms:.4f} ms, readings "
                  f"{['%.4f' % x for x in times[name]]}; {p.per_sm} blocks "
                  f"a SM, {p.splits} splits, {p.blocks} blocks; SDPA "
                  f"{lib:.4f} ms", flush=True)
        del q, k, v, qt, kt, vt
    use(variants[0])
    print(json.dumps({"card": smoke.card_line(), "rows": results}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
