"""Observability for the serve/search/fleet runtime: request-level spans,
a unified metrics registry, and Chrome-trace export.

* :class:`Obs` — the handle threaded through ``SlotScheduler``,
  ``PipelineServeEngine``, ``ReplicaRouter``, the health monitors and the
  launch drivers; disabled (:data:`NOOP_OBS`) by default, switched on with
  ``Obs.on()``.
* :class:`Tracer` / :class:`Span` — low-overhead, thread-safe span
  recording on monotonic clocks (:mod:`repro_torch.obs.trace`).
* :class:`MetricsRegistry` / :func:`default_registry` — counters, gauges,
  histograms replacing ad-hoc ``extra`` dicts (:mod:`repro_torch.obs.metrics`).
* :func:`write_chrome_trace` and friends — Perfetto-loadable trace-event
  JSON (:mod:`repro_torch.obs.chrome`); read back with ``python -m repro_torch.obs``.
* :func:`percentile` / :func:`latency_summary` / :func:`mean_tail` — the
  single nearest-rank statistics definition (:mod:`repro_torch.obs.stats`).
"""

from repro_torch.obs.chrome import (load_chrome_trace, to_chrome_trace,
                              validate_chrome_trace, write_chrome_trace)
from repro_torch.obs.handle import NOOP_OBS, Obs
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               default_registry)
from repro_torch.obs.stats import latency_summary, mean_tail, percentile
from repro_torch.obs.trace import NullTracer, Span, Tracer

__all__ = [
    "Obs", "NOOP_OBS", "Tracer", "NullTracer", "Span",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "default_registry",
    "to_chrome_trace", "write_chrome_trace", "load_chrome_trace",
    "validate_chrome_trace",
    "percentile", "latency_summary", "mean_tail",
]
