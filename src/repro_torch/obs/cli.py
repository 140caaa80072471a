"""``python -m repro_torch.obs`` — summarize a Chrome trace file (the port's
copy of `repro.obs.cli`: plain Python, output byte for byte the same).

Reads a trace produced by `repro_torch.obs.trace.Tracer.save` (or any Chrome
``traceEvents`` JSON) and prints three tables:

* **top spans by self-time** — "X" events aggregated by name, with the
  time spent in nested child spans subtracted, so the hot stage is
  visible without opening Perfetto;
* **per-request latency** — async "b"/"e" pairs (the scheduler's request
  lifecycle), with TTFT from the ``first_token`` "n" instant;
* **counter tails** — the final value of every counter track.

Output is deterministic for a given trace (sorted, fixed formatting), so
the golden test pins it exactly.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict


def load_events(path: str) -> list[dict]:
    """The traceEvents list of `path` (accepts a bare JSON array too)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc if isinstance(doc, list) else doc.get("traceEvents", [])
    if not isinstance(events, list):
        raise ValueError(f"{path}: no traceEvents array")
    return events


def span_self_times(events: list[dict]) -> dict[str, dict]:
    """Aggregate "X" events by name: {name: {count, total_us, self_us}}.

    Self-time subtracts the duration of children, where parenthood is time
    containment within one (pid, tid) — the same rule Perfetto applies.
    """
    by_track: dict[tuple, list[dict]] = defaultdict(list)
    for ev in events:
        if ev.get("ph") == "X":
            by_track[(ev.get("pid"), ev.get("tid"))].append(ev)

    agg: dict[str, dict] = defaultdict(
        lambda: {"count": 0, "total_us": 0.0, "self_us": 0.0})
    for track in by_track.values():
        # sort by start, longest first at equal start so parents precede
        track.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        stack: list[dict] = []     # open ancestors, each with _child_us
        for ev in track:
            ts, dur = ev["ts"], ev.get("dur", 0.0)
            while stack and ts >= stack[-1]["ts"] + stack[-1].get("dur", 0.0):
                stack.pop()
            if stack:
                stack[-1]["_child_us"] = \
                    stack[-1].get("_child_us", 0.0) + dur
            ev["_child_us"] = 0.0
            stack.append(ev)
        for ev in track:
            a = agg[ev["name"]]
            a["count"] += 1
            a["total_us"] += ev.get("dur", 0.0)
            a["self_us"] += ev.get("dur", 0.0) - ev.pop("_child_us", 0.0)
    return dict(agg)


def request_table(events: list[dict]) -> list[dict]:
    """Per-request rows from async lifecycle events, sorted by begin time."""
    reqs: dict[tuple, dict] = {}
    for ev in events:
        ph = ev.get("ph")
        if ph not in ("b", "n", "e"):
            continue
        key = (ev.get("cat", ""), ev.get("id"))
        row = reqs.setdefault(key, {"id": ev.get("id"), "args": {}})
        if ph == "b":
            row["begin_us"] = ev["ts"]
            row["name"] = ev.get("name", "")
        elif ph == "e":
            row["end_us"] = ev["ts"]
            row["args"].update(ev.get("args", {}))
        elif ev.get("name") == "first_token":
            row["first_token_us"] = ev["ts"]
    rows = []
    for row in reqs.values():
        if "begin_us" not in row or "end_us" not in row:
            continue
        row["e2e_ms"] = (row["end_us"] - row["begin_us"]) / 1e3
        if "first_token_us" in row:
            row["ttft_ms"] = (row["first_token_us"] - row["begin_us"]) / 1e3
        rows.append(row)
    rows.sort(key=lambda r: (r["begin_us"], str(r["id"])))
    return rows


def counter_tails(events: list[dict]) -> dict[str, dict]:
    """Last sample of each counter track: {name: {series: value}}."""
    tails: dict[str, dict] = {}
    for ev in events:
        if ev.get("ph") == "C":
            tails[ev["name"]] = dict(ev.get("args", {}))
    return dict(sorted(tails.items()))


def _fmt_us(us: float) -> str:
    return f"{us / 1e3:10.3f}"


def summarize(path: str, top: int = 15, out=None) -> None:
    """Print the three summary tables for the trace at `path`."""
    out = out or sys.stdout
    events = load_events(path)
    n_x = sum(1 for e in events if e.get("ph") == "X")
    print(f"trace: {len(events)} events ({n_x} spans)", file=out)

    spans = span_self_times(events)
    if spans:
        print(f"\ntop {min(top, len(spans))} spans by self-time (ms):",
              file=out)
        print(f"  {'self':>10} {'total':>10} {'count':>6}  name", file=out)
        ranked = sorted(spans.items(),
                        key=lambda kv: (-kv[1]["self_us"], kv[0]))
        for name, a in ranked[:top]:
            print(f"  {_fmt_us(a['self_us'])} {_fmt_us(a['total_us'])} "
                  f"{a['count']:6d}  {name}", file=out)

    reqs = request_table(events)
    if reqs:
        print("\nrequests:", file=out)
        print(f"  {'id':>8} {'ttft_ms':>10} {'e2e_ms':>10}  args", file=out)
        for r in reqs:
            ttft = f"{r['ttft_ms']:10.3f}" if "ttft_ms" in r else " " * 10
            args = " ".join(f"{k}={v}" for k, v in sorted(r["args"].items()))
            print(f"  {str(r['id']):>8} {ttft} {r['e2e_ms']:10.3f}  {args}",
                  file=out)

    tails = counter_tails(events)
    if tails:
        print("\ncounters (final values):", file=out)
        for name, series in tails.items():
            vals = " ".join(f"{k}={v:g}" if isinstance(v, (int, float))
                            else f"{k}={v}"
                            for k, v in sorted(series.items()))
            print(f"  {name}: {vals}", file=out)


def main(argv: list[str] | None = None) -> int:
    """CLI entry point (``python -m repro_torch.obs summarize
    trace.json``)."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs", description="Chrome-trace summarizer")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("summarize", help="summarize a trace file")
    s.add_argument("trace", help="path to a Chrome trace JSON")
    s.add_argument("--top", type=int, default=15,
                   help="spans to list (default 15)")
    args = ap.parse_args(argv)
    summarize(args.trace, top=args.top)
    return 0
