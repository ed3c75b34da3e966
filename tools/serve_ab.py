"""Two checkouts' serving planes on one card: this checkout's against
another's, on ``chip_smoke.py``'s phase-10 replays (a) and (b).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python tools/serve_ab.py --base DIR [--rounds N] [--seed S]

``DIR`` is the root of the other checkout (for example the parent commit,
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
Each turn runs in a process of its own with one checkout's package on its
path: it draws qwen1.5-0.5b's weights at full width from ``--seed``, and
for each replay builds a fresh two-instance pool with ``make_pool`` and
replays the trace through ``serve_trace`` at the launcher's defaults
(watchdog floor, retries, admission): (a) WL1 at full token scale, warmed,
and (b) the packed burst, with ``chip_smoke.py``'s sizes. Turns run in the
order base, this, this, base, ``--rounds`` times. Each line gives one
replay's requests, served, wall, scored requests per second, latency mean,
p50 and p99, retries, watchdog trips and engine errors, the step records
whose forward took longer than ``SLOW_S``, and each watchdog trip's
elapsed time against its deadline with the request's spans and step
records (where the checkout's ``serve_trace`` returns its server); then
each
checkout's medians beside the card's name and power limit, and a JSON
object of every reading as the last line.
"""
import argparse
import json
import pathlib
import re
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen1.5-0.5b"
KEYS = ("wall_s", "scored_rps", "mean_ms", "p50_ms", "p99_ms")
SLOW_S = 0.3          # a step record listed when its forward took longer


def cells(smoke):
    """(label, make_pool keywords, serve_trace keywords) of (a) and (b)."""
    return (
        ("(a)", dict(cache_tokens=smoke.SERVE_A_CACHE,
                     ecfg=dict(graph_memory_bytes=smoke.SERVE_A_GRAPHS)),
         dict(warm=True, **smoke.SERVE_A)),
        ("(b)", dict(cache_tokens=smoke.SERVE_B_CACHE,
                     profile_lengths=smoke.LONG_LENGTHS),
         dict(smoke.SERVE_B)))


def worker(root: pathlib.Path, seed: int) -> None:
    """Both replays on ``root``'s package; one JSON line each."""
    sys.path[:0] = [str(root / "src"), str(ROOT)]
    import gc
    import torch
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_pool, serve_trace
    from repro_torch.models.params import init_params
    import repro_torch
    if not pathlib.Path(repro_torch.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"{repro_torch.__file__} is not under {root}")
    params = init_params(get_config(ARCH), torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    for label, pool_kw, serve_kw in cells(smoke):
        pool = make_pool(ARCH, 2, reduced=False, profile=True,
                         device="cuda", params=params, **pool_kw)
        out = serve_trace(ARCH, pool=pool, drain_timeout=600.0, seed=seed,
                          **serve_kw)
        errors = sum(float(v) for v in re.findall(
            r"^counter engine_errors\S* (\S+)$", out["metrics"], re.M))
        slow = [dict(instance=name, kind=r.kind, S=r.S,
                     n_requests=r.n_requests, computed=r.computed_tokens,
                     compiled=r.compiled, predicted_s=r.predicted_jct,
                     forward_s=r.wall)
                for name, eng in pool.engines.items()
                for r in eng.batch_records if r.wall > SLOW_S]
        srv = out.get("server")       # a checkout whose result carries it
        steps = {rid: r for eng in pool.engines.values()
                 for r in eng.batch_records for rid in r.req_ids}
        trips = [dict(rids=rec["rids"], n_input=rec["n_input"],
                      elapsed_s=e["elapsed"], deadline_s=e["batch_deadline"],
                      instance=e["instance"], at_s=e["t"] - rec["t0"],
                      spans=[(sp["name"], sp["t0"] - rec["t0"],
                              sp["t1"] - rec["t0"]) for sp in rec["spans"]],
                      steps=[dict(kind=steps[r].kind, S=steps[r].S,
                                  compiled=steps[r].compiled,
                                  instance=steps[r].instance,
                                  forward_s=steps[r].wall)
                             for r in rec["rids"] if r in steps])
                 for rec in (srv.tracer.snapshot() if srv else ())
                 for e in rec["events"] if e["name"] == "watchdog_trip"]
        print(json.dumps(dict(
            cell=label, requests=out["requests"], served=out["served"],
            wall_s=out["wall_seconds"], scored_rps=out["throughput_rps"],
            mean_ms=out["mean_latency"] * 1e3,
            p50_ms=out["p50_latency"] * 1e3,
            p99_ms=out["p99_latency"] * 1e3, retries=out["retried"],
            watchdog_trips=out["watchdog_trips"], engine_errors=errors,
            slow_steps=slow, trips=trips)),
            flush=True)
        del pool, out
        gc.collect()
        torch.cuda.empty_cache()


def turn(root: pathlib.Path, seed: int):
    run = subprocess.run(
        [sys.executable, __file__, "--worker", str(root), "--seed",
         str(seed)], capture_output=True, text=True, timeout=1200)
    if run.returncode:
        sys.stderr.write(run.stdout + run.stderr)
        raise SystemExit(f"the replays of {root} failed "
                         f"(exit {run.returncode})")
    return [json.loads(line) for line in run.stdout.splitlines()
            if line.startswith('{"cell"')]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--base", type=pathlib.Path)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--worker", type=pathlib.Path, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker is not None:
        worker(args.worker.resolve(), args.seed)
        return 0
    import torch
    if args.base is None or not torch.cuda.is_available():
        print("needs --base and a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    card = smoke.card_line()
    roots = {"base": args.base.resolve(), "this": ROOT}
    rows = []
    for _ in range(args.rounds):
        for who in ("base", "this", "this", "base"):
            for row in turn(roots[who], args.seed):
                row["checkout"] = who
                rows.append(row)
                print(json.dumps(row), flush=True)
    for label in ("(a)", "(b)"):
        for who in ("base", "this"):
            mine = [r for r in rows if r["cell"] == label
                    and r["checkout"] == who]
            print(f"{label} {who}: median over {len(mine)} replays: "
                  + ", ".join(f"{k} {statistics.median(r[k] for r in mine)}"
                              for k in KEYS)
                  + "; retries, watchdog trips, engine errors "
                  + str([sum(r[k] for r in mine) for k in (
                      "retries", "watchdog_trips", "engine_errors")])
                  + f"; card {card}", flush=True)
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
