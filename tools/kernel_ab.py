"""Flash decoding (B6) and RMSNorm (B1): this checkout's kernels against
another checkout's, on one card, in one process.

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python tools/kernel_ab.py --base DIR [--rounds N] [--ptxas]

``DIR`` is the root of the other checkout (for example the parent commit,
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
Both checkouts' ``rmsnorm`` and ``decode_attention`` wrappers are loaded
side by side (the other's through its own ``kernels/_build.py``, so each
builds its own sources), held against this checkout's plain versions, and
timed with ``chip_smoke.time_ms`` in turns (base, this, this, base, N
rounds of that) beside the one PyTorch call of the same function (SDPA,
``F.rms_norm``) and the bound, at the shapes of ``chip_smoke.py``'s rows:
flash decoding at qwen1.5-0.5b's and granite-3-8b's decode and the G 8
case, RMSNorm at every T of the main path at both models' d_model. Each
line gives both medians over the rounds and every reading; this
checkout's launch plan and the resident blocks a SM of each of its
kernels' instantiations. ``--ptxas`` first compiles both of this
checkout's sources with ``-Xptxas -v`` and prints each kernel's registers,
spills and shared memory; ``--sweep 1,2,4`` also times this checkout's
flash decoding under plans of those split counts beside the split rule's,
and on a head-major copy of the cache. The last line is a JSON object of
the results.
"""
import argparse
import importlib.util
import json
import pathlib
import re
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# (label, B, S, H, KV, d, kv_len): chip_smoke.py's decode rows
DECODE = (("qwen decode_path", 16, 32768, 16, 16, 64, None),
          ("granite decode_path", 8, 32768, 32, 8, 128, None),
          ("gqa G8", 4, 8192, 16, 2, 64, (8192, 5000, 77, 8192)))
NORM_T = {1024: (16, 128, 512, 1024, 2048), 4096: (8, 128, 512, 1024, 2048)}


def load_base(base: pathlib.Path):
    """The other checkout's ``rmsnorm`` and ``decode_attention`` modules,
    each bound to that checkout's own ``_build`` (its sources, its build
    directory)."""
    kdir = base / "src" / "repro_torch" / "kernels"

    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    build = load("base_kernels_build", kdir / "_build.py")
    mods = {}
    for name in ("rmsnorm", "decode_attention"):
        mods[name] = load(f"base_{name}", kdir / f"{name}.py")
        mods[name]._build = build
    return build, mods


def demangle(name: str) -> str:
    try:
        name = subprocess.run(["c++filt", name], capture_output=True,
                              text=True).stdout.strip() or name
    except OSError:                # no c++filt: the mangled name
        pass
    return name.replace("(anonymous namespace)::", "").replace(
        "repro_torch::", "")


def ptxas(build) -> None:
    """``-Xptxas -v`` of this checkout's two sources: per kernel, its
    registers, spill stores and loads, and static shared memory."""
    for name in ("rmsnorm", "decode_attention"):
        cmd = [build.nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
               "-Xptxas", "-v", "-c", "-o", "/dev/null",
               str(build.CSRC / f"{name}.cu")]
        log = subprocess.run(cmd, capture_output=True, text=True,
                             check=True).stderr
        fn = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn, spill = demangle(m.group(1)), "spills not read"
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and fn:
                spill = f"{m.group(1)}/{m.group(2)} spill bytes"
            m = re.search(r"Used (\d+) registers(.*)", line)
            if m and fn:
                smem = re.search(r"(\d+) bytes smem", m.group(2))
                print(f"ptxas {name}.cu {fn}: {m.group(1)} registers, "
                      f"{spill}, static smem "
                      f"{smem.group(1) if smem else 0} bytes", flush=True)
                fn = None


def sweep(torch, smoke, da, dev, label, q, k, v, kt, vt, kv_len, counts):
    """This checkout's flash decoding under the split rule's plan and under
    plans of each split count in ``counts`` (in turns, each plan printed),
    and on the head-major copies ``kt``, ``vt`` ((B, KV, S, d) contiguous,
    viewed as (B, S, KV, d): one head's slots contiguous, the layout the
    SDPA yardstick reads) under the rule's plan."""
    B, S, KV, d = k.shape
    H = q.shape[2]
    rule = da.split_rule
    tiles = -(-S // da.KEY_TILE)

    def forced(n):
        chunk = -(-tiles // min(n, tiles))
        return lambda *_: (-(-tiles // chunk), chunk * da.KEY_TILE)

    plans = {"rule": rule, **{n: forced(n) for n in counts}}
    times = {key: [] for key in plans}
    order = list(plans)
    try:
        for _ in range(2):
            for key in order + order[::-1]:
                da.split_rule = plans[key]
                times[key].append(smoke.time_ms(
                    torch, lambda: da.decode_attention(q, k, v, kv_len)))
    finally:
        da.split_rule = rule
    per_sm = smoke.decode_plan(dev, B, S, H, KV, d, q.dtype).per_sm
    for key in order:
        splits, chunk = plans[key](B * KV, S, da._sm_count(dev.index),
                                   per_sm)
        print(f"sweep decode_attention[{label}] "
              f"{'split rule' if key == 'rule' else f'{key} splits asked'}: "
              f"{splits} splits of {chunk}, {B * KV * splits} blocks, "
              f"{B * KV * splits / (da._sm_count(dev.index) * per_sm):.3f} "
              f"waves: median {statistics.median(times[key]):.4f} ms, "
              f"readings {['%.4f' % x for x in times[key]]}", flush=True)
    km, vm = kt.transpose(1, 2), vt.transpose(1, 2)
    want = da.decode_attention_plain(q, k, v, kv_len)
    smoke.compare(torch, da.decode_attention(q, km, vm, kv_len), want,
                  smoke.DEC_BF16_TOL, f"head-major decode {label}")
    t = [smoke.time_ms(torch, lambda: da.decode_attention(q, km, vm, kv_len))
         for _ in range(4)]
    print(f"sweep decode_attention[{label}] head-major cache (B, KV, S, d):"
          f" median {statistics.median(t):.4f} ms, readings "
          f"{['%.4f' % x for x in t]}", flush=True)


def device_kernels(torch, fn, calls: int = 5):
    """Mean device ms a call of each kernel that ``calls`` runs of ``fn``
    launch, by name (one ``torch.profiler`` session). Before each call a
    sum over a 64 MiB buffer evicts the 50 MB L2 without leaving dirty
    lines; its reduction kernel is left out."""
    from torch.profiler import ProfilerActivity, profile
    evict = torch.ones(16 << 20, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            evict.sum()
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and "reduce_kernel" not in e.name):
            name = demangle(e.name).replace("void ", "").split("(")[0]
            ms[name] = ms.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return {k: v / calls for k, v in ms.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True, type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--sweep", default="",
                    help="comma-separated split counts: time this "
                         "checkout's flash decoding under the split rule's "
                         "plan and under each count's, and on a "
                         "head-major cache copy")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    import chip_smoke as smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.runtime.hw import H100_SXM as chip

    print(f"card: {smoke.card_line()}", flush=True)
    if args.ptxas:
        ptxas(_build)
    base_build, base = load_base(args.base.resolve())
    base_build.build_all(["rmsnorm", "decode_attention"])
    _build.build_all(["rmsnorm", "decode_attention"])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    # the resident blocks a SM of every instantiation this checkout launches
    for code, dtype in ((1, bf16), (0, torch.float32)):
        for d in (32, 64, 128):
            for G in (1, 2, 4, 8):
                tc = da.kernel_rule(G, dtype) == "tc"
                print(f"occupancy decode_attention {dtype} d {d} G {G} "
                      f"{'tc' if tc else 'gemv'}: "
                      f"{da._blocks_per_sm(dev.index, code, d, G, tc)} "
                      f"blocks a SM", flush=True)

    def turns(fns):
        """Medians of base and this checkout over the rounds, each round
        base, this, this, base; every reading kept."""
        got = {"base": [], "this": []}
        for _ in range(args.rounds):
            for who in ("base", "this", "this", "base"):
                got[who].append(smoke.time_ms(torch, fns[who]))
        return got

    results = []

    def row(kernel, label, fns, library, b_ms, b_by, plan):
        t = turns(fns)
        lib = smoke.time_ms(torch, library)
        r = dict(kernel=kernel, shape=label, base_ms=statistics.median(
            t["base"]), ms=statistics.median(t["this"]), library_ms=lib,
            bound_ms=b_ms, bound_by=b_by, plan=plan, base_all=t["base"],
            this_all=t["this"])
        results.append(r)
        print(f"ab {kernel}[{label}]: base {r['base_ms']:.4f} ms, this "
              f"{r['ms']:.4f} ms (this / base {r['ms'] / r['base_ms']:.3f}),"
              f" library {lib:.4f} ms (this / library "
              f"{r['ms'] / lib:.3f}), bound {b_ms:.5f} ms ({b_by}); plan "
              f"{plan}; readings base {['%.4f' % x for x in t['base']]}, "
              f"this {['%.4f' % x for x in t['this']]}", flush=True)

    for label, B, S, H, KV, d, lens in DECODE:
        kv_len = torch.tensor(lens or [S] * B, dtype=torch.int32, device=dev)
        q = torch.randn((B, 1, H, d), generator=gen, device=dev).to(bf16)
        k, v = (torch.randn((B, S, KV, d), generator=gen, device=dev
                            ).to(bf16) for _ in range(2))
        want = da.decode_attention_plain(q, k, v, kv_len)
        for who, mod in (("base", base["decode_attention"]), ("this", da)):
            smoke.compare(torch, mod.decode_attention(q, k, v, kv_len), want,
                          smoke.DEC_BF16_TOL, f"{who} decode {label}")
        live = smoke.decode_live(k, kv_len)
        b_ms, b_by = smoke.bound(chip, 4.0 * d * live * H,
                                 smoke.decode_bound_bytes(q, k, kv_len))
        plan = smoke.decode_plan(dev, B, S, H, KV, d, bf16)
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        mask = None if lens is None else (
            torch.arange(S, device=dev)[None, :] < kv_len[:, None]
        )[:, None, None, :]
        row("decode_attention", label,
            {"base": lambda: base["decode_attention"].decode_attention(
                q, k, v, kv_len),
             "this": lambda: da.decode_attention(q, k, v, kv_len)},
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=H != KV),
            b_ms, b_by, plan._asdict())
        for who, fn in (("base", lambda: base["decode_attention"]
                         .decode_attention(q, k, v, kv_len)),
                        ("this", lambda: da.decode_attention(q, k, v,
                                                             kv_len)),
                        ("library", lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, attn_mask=mask,
                            enable_gqa=H != KV))):
            print(f"trace decode_attention[{label}] {who}: device ms a call "
                  + ", ".join(f"{n} {t:.4f}" for n, t in
                              device_kernels(torch, fn).items()), flush=True)
        if args.sweep:
            sweep(torch, smoke, da, dev, label, q, k, v, kt, vt, kv_len,
                  [int(c) for c in args.sweep.split(",")])
        del q, k, v, qt, kt, vt

    for D, ts in NORM_T.items():
        for T in ts:
            x = torch.randn((T, D), generator=gen, device=dev).to(bf16)
            w = (torch.randn((D,), generator=gen, device=dev) * 0.1).to(bf16)
            want = rn.rmsnorm_plain(x, w)
            for who, mod in (("base", base["rmsnorm"]), ("this", rn)):
                smoke.compare(torch, mod.rmsnorm(x, w), want, smoke.BF16_TOL,
                              f"{who} rmsnorm T={T} D={D}")
            w1 = (1.0 + w.float()).to(bf16)
            b_ms, b_by = smoke.bound(chip, 4.0 * T * D, 2 * (2 * T * D + D))
            plan = rn.launch_plan(T, D, 2, rn._sm_count(dev.index),
                                  rn.vector_rule(D, 2, x.stride(0),
                                                 x.data_ptr(), w.data_ptr()))
            row("rmsnorm", f"T={T} D={D}",
                {"base": lambda: base["rmsnorm"].rmsnorm(x, w),
                 "this": lambda: rn.rmsnorm(x, w)},
                lambda: F.rms_norm(x, (D,), w1, 1e-6), b_ms, b_by,
                plan._asdict())
    print(json.dumps({"card": smoke.card_line(), "rows": results}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
