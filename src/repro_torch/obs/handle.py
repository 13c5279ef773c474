"""The ``Obs`` handle: one object carrying a tracer + metrics registry
through the runtime.

Every instrumented layer (scheduler, serve engine, router, health
monitors, launch drivers) takes an optional ``obs`` parameter and defaults
to :data:`NOOP_OBS` — a shared disabled handle whose tracer and metrics
are no-ops, so observability costs nothing unless explicitly switched on
with :meth:`Obs.on`.  Hot paths additionally guard span construction with
``if obs.enabled:`` so the disabled path never even builds args dicts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import NullTracer, Tracer


class _NullMetrics:
    """No-op :class:`MetricsRegistry` twin for the disabled handle."""

    def __init__(self):
        self._counter = Counter("null")
        self._gauge = Gauge("null")
        self._histogram = Histogram("null", keep=1)

    def counter(self, name: str) -> Counter:
        """A shared throwaway counter."""
        return self._counter

    def gauge(self, name: str) -> Gauge:
        """A shared throwaway gauge."""
        return self._gauge

    def histogram(self, name: str) -> Histogram:
        """A shared throwaway histogram."""
        return self._histogram

    def snapshot(self) -> dict:
        """Always empty."""
        return {}

    def write_snapshot(self, path: str) -> None:
        """No-op."""

    def reset(self) -> None:
        """No-op."""


@dataclasses.dataclass
class Obs:
    """Observability handle: a span :class:`~repro_torch.obs.trace.Tracer` plus
    a :class:`~repro_torch.obs.metrics.MetricsRegistry`, passed together through
    the serve/search/fleet layers.

    ``enabled`` is the hot-path guard: instrumented code checks it before
    building span arguments, so a disabled handle's cost is one attribute
    read per site."""

    tracer: Union[Tracer, NullTracer]
    metrics: Union[MetricsRegistry, _NullMetrics]
    enabled: bool = True

    @classmethod
    def on(cls, capacity_per_thread: int = 65536,
           metrics: Optional[MetricsRegistry] = None) -> "Obs":
        """A live handle: fresh tracer, fresh registry (or the one passed
        in, e.g. :func:`repro_torch.obs.metrics.default_registry` to merge with
        process-global search/fleet metrics)."""
        return cls(tracer=Tracer(capacity_per_thread),
                   metrics=metrics if metrics is not None
                   else MetricsRegistry(), enabled=True)

    @classmethod
    def off(cls) -> "Obs":
        """The shared disabled handle (:data:`NOOP_OBS`)."""
        return NOOP_OBS


NOOP_OBS = Obs(tracer=NullTracer(), metrics=_NullMetrics(), enabled=False)
