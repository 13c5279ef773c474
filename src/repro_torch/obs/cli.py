"""``python -m repro_torch.obs`` — read a Chrome trace back as tables.

Renders, from a trace file written by
:func:`repro_torch.obs.chrome.write_chrome_trace`:

* the **per-request latency breakdown** (one row per ``cat='request'``
  span: replica, submit offset, TTFT, end-to-end latency, tokens, finish
  reason) with a nearest-rank p50/p95 footer that matches
  ``ServeReport.summary()`` on the same run;
* the **top-N slowest spans** (stage items, link transfers) — where the
  wall actually went.

  PYTHONPATH=src python -m repro_torch.obs trace.json
  PYTHONPATH=src python -m repro_torch.obs trace.json --top 20
  PYTHONPATH=src python -m repro_torch.obs trace.json --metrics metrics.json
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.chrome import load_chrome_trace, validate_chrome_trace
from repro_torch.obs.stats import latency_summary


def _track_names(events: Sequence[Dict[str, Any]]
                 ) -> Dict[Tuple[int, int], str]:
    procs: Dict[int, str] = {}
    threads: Dict[Tuple[int, int], str] = {}
    for ev in events:
        if ev.get("ph") != "M":
            continue
        if ev.get("name") == "process_name":
            procs[ev["pid"]] = ev["args"]["name"]
        elif ev.get("name") == "thread_name":
            threads[(ev["pid"], ev["tid"])] = ev["args"]["name"]
    return {key: f"{procs.get(pid, pid)}/{name}"
            for (pid, tid), name in threads.items()
            for key in [(pid, tid)]}


def request_rows(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Per-request breakdown rows from the trace's ``cat='request'``
    spans, sorted by submit time."""
    events = trace.get("traceEvents", [])
    tracks = _track_names(events)
    rows = []
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") != "request":
            continue
        args = ev.get("args", {})
        track = tracks.get((ev.get("pid"), ev.get("tid")), "")
        rows.append({
            "rid": args.get("rid", ev.get("name", "?")),
            "replica": track.split("/")[0],
            "submit_ms": ev["ts"] / 1e3,
            "ttft_ms": args.get("ttft_ms"),
            "latency_ms": ev.get("dur", 0.0) / 1e3,
            "tokens": args.get("tokens"),
            "finish": args.get("finish", ""),
        })
    rows.sort(key=lambda r: (r["submit_ms"], str(r["rid"])))
    return rows


def slowest_spans(trace: Dict[str, Any], top: int = 10
                  ) -> List[Dict[str, Any]]:
    """The ``top`` longest non-request spans (stage items, link
    transfers, driver runs), longest first."""
    events = trace.get("traceEvents", [])
    tracks = _track_names(events)
    spans = [ev for ev in events
             if ev.get("ph") == "X" and ev.get("cat") != "request"]
    spans.sort(key=lambda ev: -ev.get("dur", 0.0))
    return [{
        "name": ev.get("name", "?"),
        "cat": ev.get("cat", ""),
        "track": tracks.get((ev.get("pid"), ev.get("tid")), "?"),
        "start_ms": ev["ts"] / 1e3,
        "dur_ms": ev.get("dur", 0.0) / 1e3,
    } for ev in spans[:top]]


def _table(headers: Sequence[str], rows: Sequence[Sequence[Any]]) -> str:
    def fmt(v: Any) -> str:
        if isinstance(v, float):
            return f"{v:.2f}"
        return "-" if v is None else str(v)
    cells = [[fmt(v) for v in row] for row in rows]
    widths = [max(len(h), *(len(r[i]) for r in cells)) if cells else len(h)
              for i, h in enumerate(headers)]
    lines = ["  ".join(h.rjust(w) for h, w in zip(headers, widths))]
    lines.append("  ".join("-" * w for w in widths))
    lines.extend("  ".join(c.rjust(w) for c, w in zip(row, widths))
                 for row in cells)
    return "\n".join(lines)


def render_report(trace: Dict[str, Any], top: int = 10) -> str:
    """The full text report for a loaded trace: request breakdown table,
    nearest-rank percentile footer, top-N slowest spans."""
    out = []
    rows = request_rows(trace)
    if rows:
        out.append(f"per-request breakdown ({len(rows)} request(s)):")
        out.append(_table(
            ("rid", "replica", "submit_ms", "ttft_ms", "latency_ms",
             "tokens", "finish"),
            [(r["rid"], r["replica"], r["submit_ms"], r["ttft_ms"],
              r["latency_ms"], r["tokens"], r["finish"]) for r in rows]))
        lats = [r["latency_ms"] for r in rows if r["latency_ms"]]
        ttfts = [r["ttft_ms"] for r in rows if r["ttft_ms"] is not None]
        if lats:
            s = latency_summary(lats)
            line = (f"latency_ms p50={s['p50']:.2f} p95={s['p95']:.2f} "
                    f"max={s['max']:.2f}")
            if ttfts:
                t = latency_summary(ttfts)
                line += f" | ttft_ms p50={t['p50']:.2f} p95={t['p95']:.2f}"
            out.append(line)
    else:
        out.append("no request spans in trace")
    slow = slowest_spans(trace, top)
    if slow:
        out.append(f"\ntop {len(slow)} slowest spans:")
        out.append(_table(
            ("name", "cat", "track", "start_ms", "dur_ms"),
            [(r["name"], r["cat"], r["track"], r["start_ms"], r["dur_ms"])
             for r in slow]))
    dropped = trace.get("otherData", {}).get("dropped_spans", 0)
    if dropped:
        out.append(f"\nWARNING: {dropped} span(s) dropped from full rings")
    return "\n".join(out)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI entry point; returns 2 when the trace fails validation."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="render a repro_torch.obs Chrome trace as tables")
    ap.add_argument("trace", help="trace-event JSON file "
                                  "(repro_torch.obs.write_chrome_trace)")
    ap.add_argument("--top", type=int, default=10,
                    help="slowest spans to list (default 10)")
    ap.add_argument("--metrics", default=None,
                    help="also print a metrics snapshot JSON file")
    args = ap.parse_args(argv)

    trace = load_chrome_trace(args.trace)
    errors = validate_chrome_trace(trace)
    if errors:
        for e in errors[:20]:
            print(f"INVALID: {e}", file=sys.stderr)
        return 2
    print(render_report(trace, top=args.top))
    if args.metrics:
        with open(args.metrics) as f:
            snap = json.load(f)
        print(f"\nmetrics snapshot ({args.metrics}):")
        for k in sorted(snap):
            print(f"  {k} = {snap[k]}")
    return 0
