"""``repro_torch.fleet`` — distributed campaign orchestration for zoo-scale
partitioning sweeps.

The serial :class:`~repro_torch.explore.campaign.Campaign` fans one spec template
across models × systems in-process; this package turns the same fan-out
into a durable, resumable, fault-tolerant sweep service:

* :mod:`repro_torch.fleet.manifest` — a JSON work manifest on a (shared)
  filesystem.  Each (model, system) cell has a stable id and a state
  machine (pending → running → done / failed) driven entirely by atomic
  filesystem operations (``O_CREAT|O_EXCL`` claim files, ``os.replace``
  shard writes), so any number of worker processes — on one host or many
  hosts sharing the directory — can cooperate without a coordinator, and a
  crashed sweep resumes from the manifest without recomputing done cells.
* :mod:`repro_torch.fleet.worker` — the worker loop: claim a cell, run the
  configured search strategy (any of the registered strategies, including
  ``torch_nsga2`` on the worker's device, default ``"cuda"``) with
  per-worker shared model/schedule/cost-table caches,
  write the result shard, retry failures within a bounded budget.
* :mod:`repro_torch.fleet.merge` — deterministic merge of per-cell report shards
  into one :class:`~repro_torch.explore.campaign.CampaignReport` that is
  report-identical (modulo wall-clock) to a serial ``Campaign.run`` of the
  same sweep; detects duplicate-cell conflicts and materializes
  placeholders for terminally failed cells.
* :mod:`repro_torch.fleet.launch` — local multi-process launcher plus the
  per-host command printer for multi-host runs; also the ``python -m
  repro_torch.fleet`` CLI (``init`` / ``run`` / ``worker`` / ``merge`` /
  ``status`` / ``hosts``).

Typical use::

    from repro_torch.explore import Campaign
    from repro_torch.fleet import run_fleet

    Campaign(spec, models=zoo_models).to_manifest("sweep.manifest")
    report = run_fleet("sweep.manifest", workers=4)   # == serial .run()

Every worker is its own process (started with ``subprocess``, never
forked from a process that has used CUDA) with its own CUDA context; two
workers may share one card.

or from a shell (resume after a crash is the same command)::

    python -m repro_torch.fleet init --spec spec.json --manifest sweep.manifest
    python -m repro_torch.fleet run  --manifest sweep.manifest --workers 4
"""

from repro_torch.fleet.manifest import (CellInfo, Manifest, ManifestError,
                                  cell_id_for)
from repro_torch.fleet.merge import (ReportMergeError, failed_cell_entry,
                               merge_manifest, merge_shards,
                               report_fingerprint)
from repro_torch.fleet.launch import host_commands, run_fleet, start_workers
from repro_torch.fleet.worker import run_worker

__all__ = [
    "CellInfo", "Manifest", "ManifestError", "ReportMergeError",
    "cell_id_for", "failed_cell_entry", "host_commands", "merge_manifest",
    "merge_shards", "report_fingerprint", "run_fleet", "run_worker",
    "start_workers",
]
