"""Unified metrics: named counters / gauges / histograms behind one
registry.

The serve, search, and fleet layers used to smuggle operational numbers
out through per-report ``extra`` dicts — write-once, aggregate-only, and
invisible to anything that wasn't holding the report object.  A
:class:`MetricsRegistry` replaces that: instruments are created on first
use by name, are thread-safe (one lock per instrument — increments happen
on serve worker threads and fleet heartbeat threads), and
:meth:`MetricsRegistry.snapshot` flattens everything into a JSON-ready
dict published via ``repro_torch.utils.atomicio``.

A process-global :func:`default_registry` serves call sites that have no
natural handle to thread an :class:`~repro_torch.obs.handle.Obs` through
(``TorchNSGA2Search``'s search walls, fleet worker loops); the
serve runtime uses the registry carried by its ``Obs`` handle instead so
concurrent replicas/tests can keep their numbers separate.
"""

from __future__ import annotations

import collections
import threading
from typing import Deque, Dict, Union

from repro_torch.obs.stats import percentile
from repro_torch.utils.atomicio import atomic_write_json

# histogram percentile estimates come from a bounded reservoir of the most
# recent observations; count/sum/min/max stay exact over the full stream
_HIST_KEEP = 1024


class Counter:
    """Monotonically increasing named count (requests routed, cache hits,
    faults injected)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        """Add ``n`` (default 1) to the count."""
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        """Current count."""
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins named value (queue depth, divergence ratio)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        """Record the current level."""
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        """Most recently set value (0.0 before any set)."""
        with self._lock:
            return self._value


class Histogram:
    """Streaming distribution of named observations (latencies, walls).

    Exact ``count`` / ``total`` / ``min`` / ``max`` over every observation;
    :meth:`quantile` estimates come from a bounded reservoir of the most
    recent observations so memory stays constant on long runs."""

    def __init__(self, name: str, keep: int = _HIST_KEEP):
        self.name = name
        self._lock = threading.Lock()
        self._recent: Deque[float] = collections.deque(maxlen=keep)
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, value: float) -> None:
        """Fold one observation in."""
        v = float(value)
        with self._lock:
            self._recent.append(v)
            self.count += 1
            self.total += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    def quantile(self, q: float) -> float:
        """Nearest-rank percentile over the retained reservoir (0.0 before
        any observation)."""
        with self._lock:
            if not self._recent:
                return 0.0
            return percentile(self._recent, q)

    def summary(self) -> Dict[str, float]:
        """Flat digest: count, mean, p50/p95 (reservoir), min/max."""
        with self._lock:
            if not self.count:
                return {"count": 0}
            recent = list(self._recent)
        return {
            "count": self.count,
            "mean": self.total / self.count,
            "p50": percentile(recent, 50),
            "p95": percentile(recent, 95),
            "min": self.min,
            "max": self.max,
        }


_Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Get-or-create registry of named instruments.

    One name is one instrument of one kind for the registry's lifetime —
    asking for an existing name as a different kind raises ``TypeError``
    (a silent re-kind would corrupt the snapshot)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        """The :class:`Counter` named ``name`` (created on first use)."""
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        """The :class:`Gauge` named ``name`` (created on first use)."""
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        """The :class:`Histogram` named ``name`` (created on first use)."""
        return self._get(name, Histogram)

    def snapshot(self) -> Dict[str, object]:
        """Flatten every instrument into a JSON-ready dict: counters and
        gauges as ``name``, histograms as ``name.count`` / ``name.mean`` /
        ``name.p50`` / ``name.p95`` / ``name.min`` / ``name.max``."""
        with self._lock:
            metrics = dict(self._metrics)
        out: Dict[str, object] = {}
        for name in sorted(metrics):
            m = metrics[name]
            if isinstance(m, Histogram):
                for k, v in m.summary().items():
                    out[f"{name}.{k}"] = round(v, 6) if isinstance(
                        v, float) else v
            else:
                v = m.value
                out[name] = round(v, 6) if isinstance(v, float) else v
        return out

    def write_snapshot(self, path: str) -> None:
        """Publish :meth:`snapshot` at ``path`` atomically (crash-safe,
        same discipline as every other artifact — RPR301)."""
        atomic_write_json(path, self.snapshot())

    def reset(self) -> None:
        """Drop every instrument (tests; a long-lived process keeps its
        instruments for the process lifetime)."""
        with self._lock:
            self._metrics.clear()


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry used by call sites without an ``Obs``
    handle (search strategy internals, fleet worker loops)."""
    return _DEFAULT
