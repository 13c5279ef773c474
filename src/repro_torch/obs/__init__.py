"""Observability for the serve/search/fleet runtime: request-level spans,
a unified metrics registry, and Chrome-trace export.

* :class:`Obs` — the handle threaded through ``SlotScheduler``,
  ``PipelineServeEngine``, ``ReplicaRouter``, the health monitors and the
  launch drivers; disabled (:data:`NOOP_OBS`) by default, switched on with
  ``Obs.on()``.
* :class:`Tracer` / :class:`Span` — low-overhead, thread-safe span
  recording on monotonic clocks (:mod:`repro_torch.obs.trace`);
  :class:`Laps` — consecutive child spans of one parent, one clock read
  each.
* :class:`MetricsRegistry` / :func:`default_registry` — counters, gauges,
  histograms replacing ad-hoc ``extra`` dicts (:mod:`repro_torch.obs.metrics`).
* :func:`write_chrome_trace` and friends — Perfetto-loadable trace-event
  JSON (:mod:`repro_torch.obs.chrome`); read back with ``python -m repro_torch.obs``.
* :func:`percentile` / :func:`latency_summary` / :func:`mean_tail` — the
  single nearest-rank statistics definition (:mod:`repro_torch.obs.stats`).

Where the handle is threaded and what it records with ``Obs.on()``:

* the serve runtime (``SlotScheduler``, ``PipelineServeEngine``,
  ``ReplicaRouter``, the health monitors): request, stage and link spans;
* the search (``obs=`` of ``run_spec``, ``explore_graph``, ``run_search``,
  ``torch_nsga2``; track ``search``): ``search.build``,
  ``search.prepare``, ``search.tables``, ``search.run`` holding one
  ``search.generation`` a generation (``gen``) with ``search.evaluate``,
  ``search.offspring``, ``search.rank`` (``n``, ``m``, ``feasible``,
  ``impl``, ``block``) → ``search.k1`` or ``search.dominance``,
  ``search.peel`` (``fronts``, ``ranked``) → one ``search.front`` a front
  (``k``, ``alive``), ``search.infeasible_tail``; ``search.crowding``,
  ``search.survivors``; then ``search.final_front``; and the counter ``search_host_reads``, every device-to-host read;
* the measured accuracy oracle (``obs=`` of ``cnn_measured_accuracy`` and
  ``PartitionedCNNRunner``; track ``oracle``): one ``oracle.measure`` a cut
  vector (``cuts``, ``cached``) holding one ``oracle.quantize`` a stage
  (``stage``, ``bits``, ``tensors``), one ``oracle.stage`` a stage, one
  ``oracle.link`` a link fake-quant (``bytes``) and ``oracle.read``;
* ``OnlineRepartitioner``: its decisions (instants and counters).
"""

from repro_torch.obs.chrome import (load_chrome_trace, to_chrome_trace,
                              validate_chrome_trace, write_chrome_trace)
from repro_torch.obs.handle import NOOP_OBS, Obs
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               default_registry)
from repro_torch.obs.stats import latency_summary, mean_tail, percentile
from repro_torch.obs.trace import Laps, NullTracer, Span, Tracer

__all__ = [
    "Obs", "NOOP_OBS", "Tracer", "NullTracer", "Span", "Laps",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "default_registry",
    "to_chrome_trace", "write_chrome_trace", "load_chrome_trace",
    "validate_chrome_trace",
    "percentile", "latency_summary", "mean_tail",
]
