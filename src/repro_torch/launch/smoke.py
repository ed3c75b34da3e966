"""Serve-smoke validators (copy of ``repro.launch.smoke``'s strict checks of
the observability plane's payloads).

Each raises ``ValueError`` on the first fault. They check that:

  * the Prometheus payload PARSES (strict line-format check: HELP/TYPE
    comments, sample syntax, cumulative ``le`` buckets ending ``+Inf``,
    ``_count`` == the ``+Inf`` bucket) and contains the JCT-calibration
    series (``jct_coef_a`` gauge, ``jct_residual_seconds`` histogram);
  * the /trace JSONL dump contains at least one COMPLETE submit→deliver
    timeline (submit, route, enqueue, finish events; queue + execute
    spans) for a delivered request;
  * /trace.chrome.json is valid JSON whose phase spans nest inside their
    request's umbrella span (what Perfetto renders as containment).

The reference's live smoke (``run_live_smoke``, which boots a reduced pool
on the CPU) is not ported: ``chip_smoke.py`` phase 10 scrapes a full-width
pool on the card with these validators.
"""
from __future__ import annotations

import json
import math
import re
from typing import Dict, List

_SAMPLE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})? '
    r'(?P<value>[^ ]+)$')
_LABEL = re.compile(r'^[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"$')


def parse_prometheus(text: str) -> Dict[str, List[Dict]]:
    """Strict parse of the text exposition format; raises ValueError on any
    malformed line. Returns {metric_name: [{labels, value}, ...]} keyed by
    the SAMPLE name (``foo_bucket`` etc., not the family name)."""
    series: Dict[str, List[Dict]] = {}
    typed = set()
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            if len(parts) < 4 or not parts[2]:
                raise ValueError(f"line {ln}: malformed comment: {line!r}")
            if parts[1] == "TYPE":
                if parts[3] not in ("counter", "gauge", "histogram",
                                    "summary", "untyped"):
                    raise ValueError(f"line {ln}: bad TYPE {parts[3]!r}")
                typed.add(parts[2])
            continue
        if line.startswith("#"):
            raise ValueError(f"line {ln}: unknown comment: {line!r}")
        m = _SAMPLE.match(line)
        if m is None:
            raise ValueError(f"line {ln}: malformed sample: {line!r}")
        labels = {}
        if m.group("labels"):
            for pair in re.split(r',(?=[a-zA-Z_])', m.group("labels")):
                if not _LABEL.match(pair):
                    raise ValueError(f"line {ln}: bad label {pair!r}")
                k, v = pair.split("=", 1)
                labels[k] = v[1:-1]
        try:
            value = float(m.group("value"))
        except ValueError:
            raise ValueError(f"line {ln}: bad value {m.group('value')!r}")
        family = re.sub(r'_(bucket|sum|count)$', '', m.group("name"))
        if family not in typed and m.group("name") not in typed:
            raise ValueError(f"line {ln}: sample {m.group('name')!r} has "
                             f"no preceding # TYPE")
        series.setdefault(m.group("name"), []).append(
            {"labels": labels, "value": value})
    return series


def validate_histograms(series: Dict[str, List[Dict]]) -> List[str]:
    """Cumulative-bucket + _sum/_count consistency across every histogram
    family in a parsed exposition. Returns the family names checked."""
    fams = sorted({n[:-len("_bucket")] for n in series if
                   n.endswith("_bucket")})
    for fam in fams:
        by_inst: Dict[str, List[Dict]] = {}
        for s in series[fam + "_bucket"]:
            by_inst.setdefault(s["labels"].get("instance", ""),
                               []).append(s)
        for inst, buckets in by_inst.items():
            les = [b["labels"].get("le") for b in buckets]
            if "+Inf" not in les:
                raise ValueError(f"{fam}{{{inst}}}: no +Inf bucket")
            if les[-1] != "+Inf":
                raise ValueError(f"{fam}{{{inst}}}: +Inf not last")
            vals = [b["value"] for b in buckets]
            if vals != sorted(vals):
                raise ValueError(f"{fam}{{{inst}}}: buckets not cumulative")
            count = [s["value"] for s in series.get(fam + "_count", [])
                     if s["labels"].get("instance", "") == inst]
            if not count or count[0] != vals[-1]:
                raise ValueError(f"{fam}{{{inst}}}: _count != +Inf bucket")
            ssum = [s["value"] for s in series.get(fam + "_sum", [])
                    if s["labels"].get("instance", "") == inst]
            if not ssum or not math.isfinite(ssum[0]):
                raise ValueError(f"{fam}{{{inst}}}: bad _sum")
    return fams


def validate_trace_jsonl(text: str) -> Dict:
    """Require one complete submit→deliver timeline; returns that record."""
    requests = []
    batches = 0
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        row = json.loads(line)
        if row.get("type") == "request":
            requests.append(row)
        elif row.get("type") == "batch":
            batches += 1
    delivered = [r for r in requests if r.get("outcome") == "delivered"]
    if not delivered:
        raise ValueError(f"no delivered request in trace dump "
                         f"({len(requests)} requests, {batches} batches)")
    for r in delivered:
        events = [e["name"] for e in r["events"]]
        spans = {s["name"] for s in r["spans"]}
        missing = {"submit", "route", "enqueue", "finish"} - set(events)
        if not missing and {"queue", "execute"} <= spans:
            ts = [e["t"] for e in r["events"]]
            if ts != sorted(ts):
                raise ValueError(f"req {r['req_id']}: events out of order")
            for s in r["spans"]:
                if s["t1"] < s["t0"]:
                    raise ValueError(f"req {r['req_id']}: negative span "
                                     f"{s['name']}")
            return r
    raise ValueError(
        "no delivered request has a complete timeline; first delivered "
        f"has events={delivered[0]['events']} spans={delivered[0]['spans']}")


def validate_chrome(obj: Dict) -> int:
    """Perfetto-loadability proxy: the JSON parsed, every event carries the
    required keys, and each phase span nests inside a request umbrella span
    on the same (pid, tid). Returns the number of nested phase spans."""
    events = obj["traceEvents"]
    umbrellas = [e for e in events if e["ph"] == "X"
                 and e["name"].startswith("request ")]
    if not umbrellas:
        raise ValueError("no request umbrella spans")
    nested = 0
    for e in events:
        if e["ph"] not in ("X", "i", "M"):
            raise ValueError(f"unknown phase {e['ph']!r}")
        if e["ph"] == "X" and (e["ts"] < 0 or e["dur"] <= 0):
            raise ValueError(f"bad X event timing: {e}")
        if (e["ph"] == "X" and not e["name"].startswith("request ")
                and not e["name"].startswith("step ")):
            host = [u for u in umbrellas
                    if u["pid"] == e["pid"] and u["tid"] == e["tid"]
                    and u["ts"] <= e["ts"] + 1e-6
                    and e["ts"] + e["dur"] <= u["ts"] + u["dur"] + 1e-3]
            if not host:
                raise ValueError(f"span {e['name']!r} (tid {e['tid']}) not "
                                 f"nested in any request span")
            nested += 1
    return nested
