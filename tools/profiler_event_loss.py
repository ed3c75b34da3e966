"""How often ``torch.profiler`` loses device events, and which.

``chip_smoke.py`` counts each CUDA graph's kernels from one profiled
replay (``replay_launches``), so a session that loses events reads short.
This script profiles the same work many times and prints, for each way of
profiling it, how many sessions read short and what they read:

- ``eager``: 1,402 launches (``neg_``, 1,400 ``mul_``, ``abs_``);
- ``graph``: the same 1,402 kernels captured as one CUDA graph;

each ``bare`` (one run a session), after a ``spin`` kernel (and one after
it), after a 5 ms ``host-wait``, behind a ``warmup-step`` of the profiler's
schedule, and ``split``: three graph replays a session with a spin kernel
between them, read as ``replay_launches`` reads them (short only when no
whole replay after a recorded spin, nor the first, reads all 1,402).

Run on a card: ``python tools/profiler_event_loss.py [sessions]`` (default
60 a mode). The last line is a JSON object of the results.
"""
import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, schedule

N_MID = 1400
SPIN_CYCLES = 2_000_000
WHOLE = {"first": 1, "mid": N_MID, "last": 1}


def part(name: str):
    name = name.lower()
    for key, word in (("first", "neg"), ("last", "abs"), ("mid", "mul")):
        if word in name:
            return key
    return None


def device_events(events):
    return sorted((e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def count(events):
    c = dict.fromkeys(WHOLE, 0)
    for e in events:
        k = part(e.name)
        if k:
            c[k] += 1
    return c


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_event_loss: needs a CUDA device", file=sys.stderr)
        return 2
    sessions = int(sys.argv[1]) if len(sys.argv) > 1 else 60
    a = torch.randn(1 << 22, device="cuda")

    def eager():
        a.neg_()
        for _ in range(N_MID):
            a.mul_(1.0)
        a.abs_()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        eager()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def one(mode, work):
        torch.cuda.synchronize()
        if mode == "warmup-step":
            got = {}
            with profile(activities=acts,
                         schedule=schedule(wait=0, warmup=1, active=1),
                         on_trace_ready=lambda p: got.update(
                             c=count(device_events(p.events())))) as prof:
                for _ in range(2):
                    work()
                    torch.cuda.synchronize()
                    prof.step()
            return got["c"], got["c"] == WHOLE
        with profile(activities=acts) as prof:
            if mode == "host-wait":
                time.sleep(0.005)
            if mode == "spin":
                torch.cuda._sleep(SPIN_CYCLES)
            for i in range(3 if mode == "split" else 1):
                if i:
                    torch.cuda._sleep(SPIN_CYCLES)
                work()
            if mode == "spin":
                torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        evs = device_events(prof.events())
        if mode != "split":
            c = count(evs)
            return c, c == WHOLE
        readings = [[]]
        for e in evs:
            if "spin_kernel" in e.name:
                readings.append([])
            else:
                readings[-1].append(e)
        readings = [count(r) for r in readings]
        ok = readings[0] == WHOLE or WHOLE in readings[1:]
        return readings, ok

    out = {"card": torch.cuda.get_device_name(0), "sessions": sessions}
    for label, work in (("eager", eager), ("graph", graph.replay)):
        for mode in ("bare", "spin", "host-wait", "warmup-step", "split"):
            if mode == "split" and label == "eager":
                continue
            short, head, t0 = [], [], time.perf_counter()
            for _ in range(sessions):
                c, ok = one(mode, work)
                if not ok:
                    short.append(c)
                elif mode == "split" and c[0] != WHOLE:
                    head.append(c)
            key = f"{label} {mode}"
            out[key] = {"short": len(short), "examples": short[:3],
                        "s": round(time.perf_counter() - t0, 1)}
            if mode == "split":
                # sessions whose first replay read short, read whole later
                out[key]["first_replay_short"] = len(head)
                out[key]["first_replay_examples"] = head[:3]
            print(key, out[key], flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
