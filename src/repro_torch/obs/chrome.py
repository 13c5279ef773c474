"""Chrome trace-event JSON export: spans -> a Perfetto-loadable timeline.

The `trace-event format <https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU>`_
is the lingua franca of timeline viewers: ``chrome://tracing`` and
https://ui.perfetto.dev both open the emitted file directly.  Each span's
``track`` ("process/thread" path, e.g. ``"replica0/stage1"``) becomes one
timeline row: the process part groups rows per replica (or ``router``,
``health``), the thread part is the stage / link / driver / requests row.
Timestamps are microseconds; ``"X"`` complete events carry ``dur``,
``"i"`` instant events mark faults, admissions, and failovers.

:func:`validate_chrome_trace` is the same check the ``obs-smoke`` CI job
and the ``python -m repro_torch.obs`` CLI run before trusting a file.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence, Tuple, Union

from repro_torch.obs.trace import Span, Tracer
from repro_torch.utils.atomicio import atomic_write_json


def _split_track(track: str) -> Tuple[str, str]:
    proc, _, thread = track.partition("/")
    return (proc or "main"), (thread or "main")


def to_chrome_trace(spans: Sequence[Span], *,
                    dropped: int = 0) -> Dict[str, Any]:
    """Render ``spans`` as a Chrome trace-event JSON object.

    Tracks are assigned stable integer pid/tid in first-seen order and
    named via ``process_name`` / ``thread_name`` metadata events;
    ``dropped`` (spans evicted from full rings) lands in
    ``otherData.dropped_spans`` so a truncated trace is self-describing."""
    pids: Dict[str, int] = {}
    tids: Dict[Tuple[str, str], int] = {}
    events: List[Dict[str, Any]] = []
    for s in spans:
        proc, thread = _split_track(s.track)
        if proc not in pids:
            pids[proc] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name",
                           "pid": pids[proc], "tid": 0,
                           "args": {"name": proc}})
        key = (proc, thread)
        if key not in tids:
            tids[key] = len(tids) + 1
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pids[proc], "tid": tids[key],
                           "args": {"name": thread}})
        ev: Dict[str, Any] = {
            "ph": s.ph, "name": s.name, "cat": s.cat or "default",
            "ts": round(s.ts * 1e6, 3),
            "pid": pids[proc], "tid": tids[key],
        }
        if s.ph == "X":
            ev["dur"] = round(s.dur * 1e6, 3)
        else:
            ev["s"] = "t"                      # instant scoped to its row
        if s.args:
            ev["args"] = dict(s.args)
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"dropped_spans": dropped}}


def write_chrome_trace(path: str,
                       source: Union[Tracer, Sequence[Span]]) -> None:
    """Export a tracer (or a span list) to ``path`` atomically."""
    if isinstance(source, Tracer) or hasattr(source, "spans"):
        payload = to_chrome_trace(source.spans(), dropped=source.dropped)
    else:
        payload = to_chrome_trace(source)
    atomic_write_json(path, payload)


def load_chrome_trace(path: str) -> Dict[str, Any]:
    """Parse a trace-event JSON file (as written by
    :func:`write_chrome_trace`)."""
    with open(path) as f:
        return json.load(f)


def validate_chrome_trace(trace: Dict[str, Any]) -> List[str]:
    """Structural check of a trace-event object; returns the list of
    violations (empty = loads cleanly in Perfetto / ``chrome://tracing``).

    Checks: ``traceEvents`` is a list of dicts; every event has ``ph`` and
    ``name``; ``X``/``i`` events carry numeric non-negative ``ts`` and
    integer ``pid``/``tid``; ``X`` events carry numeric non-negative
    ``dur``; every pid/tid referenced is named by a metadata event."""
    errors: List[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    named_pids, named_tids = set(), set()
    for ev in events:
        if isinstance(ev, dict) and ev.get("ph") == "M":
            if ev.get("name") == "process_name":
                named_pids.add(ev.get("pid"))
            elif ev.get("name") == "thread_name":
                named_tids.add((ev.get("pid"), ev.get("tid")))
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if not ph:
            errors.append(f"event {i}: missing ph")
            continue
        if not isinstance(ev.get("name"), str):
            errors.append(f"event {i}: missing name")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"event {i} ({ev.get('name')}): bad ts {ts!r}")
        if not isinstance(ev.get("pid"), int) \
                or not isinstance(ev.get("tid"), int):
            errors.append(f"event {i} ({ev.get('name')}): "
                          "pid/tid must be integers")
        elif ev["pid"] not in named_pids:
            errors.append(f"event {i}: pid {ev['pid']} has no "
                          "process_name metadata")
        elif (ev["pid"], ev["tid"]) not in named_tids:
            errors.append(f"event {i}: tid {ev['tid']} has no "
                          "thread_name metadata")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {i} ({ev.get('name')}): "
                              f"bad dur {dur!r}")
    return errors
