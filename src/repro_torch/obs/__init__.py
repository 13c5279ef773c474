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
  ``impl``) → ``search.k1``, ``search.peel`` (``fronts``, ``ranked``,
  ``impl``) → on the plain loop (``impl`` ``ref``) one ``search.front`` a
  front (``k``, ``alive``), none on the peel kernel's one launch,
  ``search.infeasible_tail``;
  ``search.crowding``, ``search.survivors``; then ``search.final_front``;
  and the counter ``search_host_reads``, every device-to-host read (one a
  ranking on the kernel, one a front and one at entry on the plain loop);
* the measured accuracy oracle (``obs=`` of ``cnn_measured_accuracy`` and
  ``PartitionedCNNRunner``; track ``oracle``): one ``oracle.measure`` a cut
  vector (``cuts``, ``cached``) holding one ``oracle.quantize`` a stage
  (``stage``, ``bits``, ``tensors``), one ``oracle.stage`` a stage, one
  ``oracle.link`` a link fake-quant (``bytes``) and ``oracle.read``; the
  counters ``fake_quant_tensors.cuda`` and ``fake_quant_tensors.ref`` (each
  tensor the runner fake-quantizes, a stage's weights and each link's
  activation, by the path it takes: the fake-quant kernel pair K7 or the
  plain chain of ATen ops), ``mbconv_dw.cuda`` and ``mbconv_dw.ref``
  (each MBConv block the runner runs, by its depthwise unit's route: the
  kernel K8 or the plain chain of ops);
* the LM oracle (``obs=`` of ``lm_measured_accuracy`` and, for the mixed
  family, ``PartitionedLMRunner``; track ``oracle``): the same spans, each
  ``oracle.stage`` with ``stage``, ``mamba`` and ``attention`` (the mixers
  it holds) and ``tokens``, the head in the last; the counters
  ``ssm_scan_calls.cuda`` and ``ssm_scan_calls.ref`` (each Mamba2 mixer's
  scan, by the path it takes: the SSD scan kernel or the plain chunked
  scan), ``fake_quant_tensors.cuda`` and ``fake_quant_tensors.ref`` (each
  stage's stacked leaves and each link, as the CNN runner counts them)
  and ``oracle_positions`` (next-token positions scored); for a model with
  experts (granite-4.0-h-small) each ``oracle.stage`` also carries ``moe``
  (the expert units it holds) and ``moe_ms`` (their device time, from CUDA
  events read at the stage's sync; the host clock off a card), and the
  expert units count ``moe_rows.held`` (the token-expert rows the held
  experts computed) and ``moe_rows.routed`` (tokens x top-k);
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
