"""The program's own spans on the profiler's clock, and the device's time
put down to them.

The port records spans (``repro_torch.obs``) on ``time.perf_counter``;
``torch.profiler``'s Chrome export stamps its events in microseconds on a
clock of its own.  :func:`anchor`, called while the profiler runs, takes
``perf_counter`` reads inside ``record_function`` blocks named
:data:`ANCHOR`: the offset between the shortest such block's midpoint in
the trace and its read maps every span onto the trace's clock, within
that block's duration (the mapping's error).

:class:`Events` reads the export keeping ``args`` (``Trace`` in
``trace.py`` drops them): device operations and the runtime calls that
launched them share an ``args.correlation`` id.  :class:`SpanView` then
gives, for each span name, its count, its self time (the duration less
what its child spans cover, on the host clock), the device time of the
operations launched while it was the innermost open span, and the idle
time between the device's busy intervals while it was the innermost open
span.  A gap is split among the spans open during it rather than given
whole to the span at its midpoint: one gap of the search runs through
several host-only spans (``search.build``, ``search.prepare``,
``search.tables``).
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

ANCHOR = "obs.clock_anchor"
NO_SPAN = "no program span"
SHORT_GAPS = "gaps under 5 us"
NO_LAUNCH = "no launch found"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def anchor(n: int = 3) -> List[float]:
    """``n`` ``perf_counter`` reads, each inside a ``record_function``
    block named :data:`ANCHOR` (the first call in a process takes ~1 ms,
    later ones ~10 us: the shortest block maps the clocks)."""
    from torch.profiler import record_function
    reads = []
    for _ in range(n):
        with record_function(ANCHOR):
            reads.append(time.perf_counter())
    return reads


class Events:
    """A Chrome export's events with their ``args``: ``device`` [(name,
    start_us, dur_us, correlation)], ``launches`` {correlation: start_us}
    of the runtime calls, and ``anchors`` [(start_us, dur_us)] in order."""

    def __init__(self, events: Iterable[dict]):
        self.device: List[Tuple[str, float, float, Optional[int]]] = []
        self.launches: Dict[int, float] = {}
        self.anchors: List[Tuple[float, float]] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, args = e.get("cat"), e.get("args") or {}
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.device.append((e["name"], ts, dur,
                                    args.get("correlation")))
            elif cat in LAUNCH_CATS and "correlation" in args:
                self.launches[args["correlation"]] = ts
            elif cat == "user_annotation" and e.get("name") == ANCHOR:
                self.anchors.append((ts, dur))
        self.device.sort(key=lambda d: d[1])
        self.anchors.sort()

    def offset_us(self, reads: Sequence[float]) -> Tuple[float, float]:
        """(offset, error) in us: trace time = perf_counter s x 1e6 +
        offset, from the shortest anchor block paired with its read."""
        if len(self.anchors) != len(reads) or not reads:
            raise ValueError(f"{len(self.anchors)} anchors in the trace for "
                             f"{len(reads)} clock reads")
        i = min(range(len(reads)), key=lambda j: self.anchors[j][1])
        ts, dur = self.anchors[i]
        return ts + dur / 2 - reads[i] * 1e6, dur

    def busy_intervals(self, lo: float = float("-inf"),
                       hi: float = float("inf")) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals (us), clipped to
        [lo, hi]."""
        out: List[Tuple[float, float]] = []
        for _, t, d, _ in self.device:
            a, b = max(t, lo), min(t + d, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                if b > out[-1][1]:
                    out[-1] = (out[-1][0], b)
            else:
                out.append((a, b))
        return out


def innermost(spans: Sequence[Tuple[str, float, float]]
              ) -> List[Tuple[float, float, str]]:
    """Disjoint segments (start, end, name) of the innermost open span, from
    spans (name, start, end) that nest (one track, one thread)."""
    segs: List[Tuple[float, float, str]] = []
    stack: List[Tuple[str, float]] = []        # (name, end)
    t = None
    for name, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        while stack and stack[-1][1] <= a:     # close what ended before a
            n, e = stack.pop()
            if e > t:
                segs.append((t, e, n))
            t = max(t, e)
        if stack and a > t:
            segs.append((t, a, stack[-1][0]))
        stack.append((name, b))
        t = a
    while stack:
        n, e = stack.pop()
        if e > t:
            segs.append((t, e, n))
        t = max(t, e)
    return segs


def self_times(spans: Sequence[Tuple[str, float, float]]) -> Dict[str, float]:
    """Each name's summed self time: its spans' durations less the parts
    their children cover (the same units as the spans)."""
    acc: Dict[str, float] = collections.defaultdict(float)
    for a, b, name in innermost(spans):
        acc[name] += b - a
    return dict(acc)


class SpanView:
    """The program's spans over one traced window, on the trace's clock.

    ``spans``: ``repro_torch.obs.Span`` records (``ts`` relative to
    ``epoch``); ``reads`` the :func:`anchor` reads; ``t0`` and
    ``window_s`` the window's start (a ``perf_counter`` read) and length.
    Only spans that lie in the window are kept."""

    def __init__(self, events: Events, spans: Iterable, epoch: float,
                 reads: Sequence[float], t0: float, window_s: float,
                 min_gap_us: float = 5.0):
        self.events = events
        self.offset_us, self.error_us = events.offset_us(reads)
        self.lo = t0 * 1e6 + self.offset_us
        self.hi = self.lo + window_s * 1e6
        self.min_gap_us = min_gap_us
        self.spans = []                # (name, start_us, end_us, args)
        for s in spans:
            if getattr(s, "ph", "X") != "X":
                continue
            a = (epoch + s.ts) * 1e6 + self.offset_us
            b = a + s.dur * 1e6
            if a >= self.lo and b <= self.hi:
                self.spans.append((s.name, a, b, s.args or {}))
        self._segs = innermost([(n, a, b) for n, a, b, _ in self.spans])
        self._starts = [a for a, _, _ in self._segs]

    def at(self, t: float) -> str:
        """The innermost span open at trace time ``t``, or :data:`NO_SPAN`."""
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t < self._segs[i][1]:
            return self._segs[i][2]
        return NO_SPAN

    def args(self, name: str) -> List[dict]:
        """The ``args`` of every kept span named ``name``, in order."""
        return [a for n, _, _, a in self.spans if n == name]

    def split(self, a: float, b: float) -> Dict[str, float]:
        """Microseconds of [a, b] under each innermost span (the rest under
        :data:`NO_SPAN`)."""
        acc: Dict[str, float] = collections.defaultdict(float)
        i = max(bisect.bisect_right(self._starts, a) - 1, 0)
        covered = 0.0
        for s0, s1, name in self._segs[i:]:
            if s0 >= b:
                break
            part = min(s1, b) - max(s0, a)
            if part > 0:
                acc[name] += part
                covered += part
        if b - a > covered:
            acc[NO_SPAN] += b - a - covered
        return acc

    def idle_by_span(self) -> Dict[str, float]:
        """Seconds of the window in which the device ran nothing, by the
        innermost span open meanwhile; gaps shorter than ``min_gap_us``
        summed apart (:data:`SHORT_GAPS`), so the values add up to the
        window's idle time."""
        acc: Dict[str, float] = collections.defaultdict(float)
        edges = [self.lo]
        for a, b in self.events.busy_intervals(self.lo, self.hi):
            edges += [a, b]
        edges.append(self.hi)
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            if b - a < self.min_gap_us:
                acc[SHORT_GAPS] += (b - a) / 1e6
                continue
            for name, us in self.split(a, b).items():
                acc[name] += us / 1e6
        return dict(acc)

    def busy_by_span(self) -> Dict[str, float]:
        """Seconds of device operations (summed, not unioned) by the
        innermost span open at their launch; operations with no launch
        event in the trace under :data:`NO_LAUNCH`."""
        acc: Dict[str, float] = collections.defaultdict(float)
        for _, t, d, corr in self.events.device:
            if not self.lo <= t < self.hi:
                continue
            at = self.events.launches.get(corr)
            acc[NO_LAUNCH if at is None else self.at(at)] += d / 1e6
        return dict(acc)

    def summary(self) -> Dict[str, dict]:
        """By span name: ``count``, ``self_ms`` (host clock),
        ``device_busy_ms`` and ``device_idle_ms``."""
        selfs = self_times([(n, a, b) for n, a, b, _ in self.spans])
        busy, idle = self.busy_by_span(), self.idle_by_span()
        counts = collections.Counter(n for n, _, _, _ in self.spans)
        return {n: {"count": counts[n], "self_ms": selfs.get(n, 0.0) / 1e3,
                    "device_busy_ms": 1e3 * busy.get(n, 0.0),
                    "device_idle_ms": 1e3 * idle.get(n, 0.0)}
                for n in counts}

    def metric(self, names: Sequence[str], per: float) -> Optional[dict]:
        """A per-layer metric over the spans ``names``: their summed self
        time in ms over ``per`` (searches or vectors), with their count,
        device busy and device idle ms beside it; None when none ran."""
        rows = self.summary()
        got = [rows[n] for n in names if n in rows]
        if not got or not per:
            return None
        return {"value": sum(r["self_ms"] for r in got) / per,
                "count": sum(r["count"] for r in got),
                "device_busy_ms": sum(r["device_busy_ms"] for r in got),
                "device_idle_ms": sum(r["device_idle_ms"] for r in got),
                "clock_error_us": self.error_us}
