"""Low-overhead, thread-safe span recorder for the serve/search/fleet
runtime.

Design constraints, in order:

* **Cheap on the hot path.**  A serve replica emits a span per stage item
  and per link transfer from its worker threads; recording must not
  serialize them.  Each thread appends to its *own* bounded ring
  (``collections.deque``), registered once under the tracer lock on the
  thread's first span — steady-state recording takes no shared lock.
* **Bounded.**  Rings drop their oldest span once ``capacity_per_thread``
  is reached and count the drops (:attr:`Tracer.dropped`); a runaway run
  degrades the trace, never the process.
* **Monotonic.**  All timestamps are ``time.perf_counter()`` seconds
  relative to the tracer's construction epoch — never ``time.time()``
  (the RPR401 analyzer rule enforces this repo-wide for durations).

Spans carry a ``track`` — a ``"process/thread"`` path like
``"replica0/stage1"`` — which the Chrome exporter
(:mod:`repro_torch.obs.chrome`) turns into one timeline row per stage / link /
replica.  Use :meth:`Tracer.span` as a context manager around live work,
:meth:`Tracer.complete` to record an interval whose endpoints were already
measured (zero extra clock reads), and :meth:`Tracer.instant` for
point events (faults, admissions, failovers).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Span:
    """One recorded event: a complete interval (``ph='X'``) or an instant
    (``ph='i'``).  ``ts``/``dur`` are seconds relative to the tracer's
    epoch; ``track`` is the ``"process/thread"`` timeline row."""

    name: str
    cat: str
    track: str
    ts: float
    dur: float = 0.0
    ph: str = "X"
    args: Optional[Dict[str, Any]] = None

    @property
    def end(self) -> float:
        """Interval end (``ts`` itself for instants)."""
        return self.ts + self.dur


class _ThreadRing:
    """One thread's bounded span buffer (drops oldest past capacity)."""

    __slots__ = ("spans", "dropped", "capacity")

    def __init__(self, capacity: int):
        self.spans: collections.deque = collections.deque()
        self.dropped = 0
        self.capacity = capacity

    def append(self, span: Span) -> None:
        if len(self.spans) >= self.capacity:
            self.spans.popleft()
            self.dropped += 1
        self.spans.append(span)


class _SpanCtx:
    """Context manager recording one live interval on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_track", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, track: str,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._track = track
        self._args = args

    def __enter__(self) -> "_SpanCtx":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._tracer.complete(self._name, cat=self._cat, track=self._track,
                              start=self._t0, end=time.perf_counter(),
                              args=self._args)


class Tracer:
    """Thread-safe span recorder (see module docstring).

    All recording methods may be called from any thread; :meth:`spans`
    merges every thread's ring into one ``ts``-sorted list (a snapshot —
    recording may continue concurrently)."""

    enabled = True

    def __init__(self, capacity_per_thread: int = 65536):
        if capacity_per_thread <= 0:
            raise ValueError("capacity_per_thread must be > 0, got "
                             f"{capacity_per_thread}")
        self._epoch = time.perf_counter()
        self._capacity = capacity_per_thread
        self._lock = threading.Lock()
        self._rings: List[_ThreadRing] = []
        self._local = threading.local()

    @property
    def epoch(self) -> float:
        """``time.perf_counter()`` value all span timestamps are relative
        to (the tracer's construction instant)."""
        return self._epoch

    def now(self) -> float:
        """Seconds since the tracer epoch (monotonic)."""
        return time.perf_counter() - self._epoch

    def _ring(self) -> _ThreadRing:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            ring = self._local.ring = _ThreadRing(self._capacity)
            with self._lock:
                self._rings.append(ring)
        return ring

    def span(self, name: str, cat: str = "", track: str = "",
             **args: Any) -> _SpanCtx:
        """Context manager recording a complete span around the ``with``
        body (clocked with ``perf_counter`` at entry/exit)."""
        return _SpanCtx(self, name, cat, track, args or None)

    def complete(self, name: str, cat: str = "", track: str = "", *,
                 start: float, end: Optional[float] = None,
                 dur: Optional[float] = None,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """Record an interval whose endpoints were already measured:
        ``start`` (and ``end``) are absolute ``perf_counter`` values, or
        pass ``dur`` seconds instead of ``end``.  Lets instrumented code
        reuse clock reads it takes anyway (health/Def.-4 accounting)."""
        if dur is None:
            dur = (end if end is not None else time.perf_counter()) - start
        self._ring().append(Span(name=name, cat=cat, track=track,
                                 ts=start - self._epoch, dur=max(dur, 0.0),
                                 args=args))

    def instant(self, name: str, cat: str = "", track: str = "",
                ts: Optional[float] = None,
                args: Optional[Dict[str, Any]] = None) -> None:
        """Record a point event (``ts``: absolute ``perf_counter`` value;
        default now)."""
        t = time.perf_counter() if ts is None else ts
        self._ring().append(Span(name=name, cat=cat, track=track,
                                 ts=t - self._epoch, ph="i", args=args))

    def spans(self) -> List[Span]:
        """Snapshot of every recorded span, sorted by start time."""
        with self._lock:
            rings = list(self._rings)
        out: List[Span] = []
        for ring in rings:
            out.extend(ring.spans)
        out.sort(key=lambda s: (s.ts, s.track, s.name))
        return out

    @property
    def dropped(self) -> int:
        """Spans evicted from full per-thread rings (0 = complete trace)."""
        with self._lock:
            rings = list(self._rings)
        return sum(r.dropped for r in rings)


class Laps:
    """Consecutive spans under one parent span on one track, each ending at
    the clock read that starts the next, so ``n`` laps take ``n + 1``
    reads.  :meth:`lap` closes a child span (or, with no name, skips the
    time since the last read, which then counts to the parent alone);
    :meth:`close` records the parent, ending at the last lap's read.  Built
    only behind ``if obs.enabled:``: its first read is taken here."""

    __slots__ = ("tracer", "name", "track", "args", "start", "t")

    def __init__(self, tracer: "Tracer", name: str, track: str,
                 args: Optional[Dict[str, Any]] = None):
        self.tracer, self.name, self.track, self.args = (tracer, name, track,
                                                         args)
        self.start = self.t = time.perf_counter()

    def lap(self, name: Optional[str] = None,
            args: Optional[Dict[str, Any]] = None) -> None:
        """End the current lap now; record it as ``name`` unless None."""
        t = time.perf_counter()
        if name is not None:
            self.tracer.complete(name, track=self.track, start=self.t, end=t,
                                 args=args)
        self.t = t

    def close(self) -> None:
        """Record the parent span, from construction to the last lap."""
        self.tracer.complete(self.name, track=self.track, start=self.start,
                             end=self.t, args=self.args)


class _NullSpanCtx:
    """Reusable no-op ``with`` target for :class:`NullTracer.span`."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpanCtx":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_CTX = _NullSpanCtx()


class NullTracer:
    """No-op :class:`Tracer` twin: same surface, records nothing.  The
    disabled :class:`~repro_torch.obs.handle.Obs` carries one so instrumented
    code never branches on ``None``."""

    enabled = False

    def now(self) -> float:
        """Monotonic seconds (still real so callers can use it freely)."""
        return time.perf_counter()

    def span(self, name: str, cat: str = "", track: str = "",
             **args: Any) -> _NullSpanCtx:
        """No-op context manager."""
        return _NULL_CTX

    def complete(self, name: str, cat: str = "", track: str = "", *,
                 start: float, end: Optional[float] = None,
                 dur: Optional[float] = None,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """Discard the interval."""

    def instant(self, name: str, cat: str = "", track: str = "",
                ts: Optional[float] = None,
                args: Optional[Dict[str, Any]] = None) -> None:
        """Discard the event."""

    def spans(self) -> List[Span]:
        """Always empty."""
        return []

    @property
    def dropped(self) -> int:
        """Always 0."""
        return 0
