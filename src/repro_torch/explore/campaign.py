"""Campaign runner: fan one exploration-spec template across many models
and/or systems in a single run.

Per model, the schedule, the Def.-3 :class:`SegmentMemoryTable` and the
per-arch ``layer_cost_table`` prefix sums are built **once** and shared
across every system in the fan-out (two systems built from the same
accelerator archs never re-profile a layer).  The outcome is a
:class:`CampaignResult` holding full :class:`ExplorationResult` objects for
programmatic use plus a JSON-serializable :class:`CampaignReport`
(per-model Pareto fronts + Def.-2 selections) for storage and dashboards.
The report's JSON has the JAX package's layout, key for key.  The tensor
strategies run on the ``device`` passed to :meth:`Campaign.run` (default
``"cuda"``).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.graph import linearize
from repro_torch.core.memory import SegmentMemoryTable
from repro_torch.explore.result import ExplorationResult
from repro_torch.explore.spec import (ExplorationSpec, ModelRef, SweepSpec,
                                SystemSpec)
from repro_torch.utils.atomicio import atomic_write_text


@dataclasses.dataclass
class CampaignEntry:
    """One (model, system) cell of the fan-out, with its live result."""

    model: str
    system: str
    result: ExplorationResult
    wall_s: float


def campaign_entry_dict(model: str, system: str, result: ExplorationResult,
                        wall_s: float) -> Dict[str, Any]:
    """The canonical report-entry dict for one (model, system) cell — shared
    by the serial runner and the fleet workers so a merged fleet report is
    entry-identical to a serial run."""
    return {"model": model, "system": system, "wall_s": round(wall_s, 4),
            **result.to_report()}


@dataclasses.dataclass
class CampaignReport:
    """Serializable campaign outcome (JSON round-trippable)."""

    template: Dict[str, Any]          # the spec template, as a plain dict
    entries: List[Dict[str, Any]]     # flattened per-(model, system) reports
    wall_s: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        # normalized through JSON so tuples become lists and the dict form
        # is identical before and after a round-trip
        return json.loads(json.dumps(dataclasses.asdict(self)))

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(dataclasses.asdict(self), indent=indent)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CampaignReport":
        return cls(template=d["template"], entries=list(d["entries"]),
                   wall_s=float(d.get("wall_s", 0.0)))

    @classmethod
    def from_json(cls, s: str) -> "CampaignReport":
        return cls.from_dict(json.loads(s))

    def save(self, path: str, indent: int = 1) -> None:
        atomic_write_text(path, self.to_json(indent=indent))

    def summary(self) -> str:
        lines = [f"campaign: {len(self.entries)} (model × system) runs "
                 f"in {self.wall_s:.1f}s"]
        for e in self.entries:
            sel = e.get("selected")
            pick = (f"cuts={tuple(sel['cuts'])} "
                    f"lat={sel['latency_s']*1e3:.2f}ms "
                    f"th={sel['throughput']:.1f}/s"
                    if sel else "no feasible partitioning")
            lines.append(f"  {e['model']} × {e['system']}: "
                         f"|pareto|={len(e['pareto'])}  {pick}")
        return "\n".join(lines)


@dataclasses.dataclass
class CampaignResult:
    entries: List[CampaignEntry]
    report: CampaignReport

    def get(self, model: str, system: Optional[str] = None
            ) -> ExplorationResult:
        for e in self.entries:
            if e.model == model and (system is None or e.system == system):
                return e.result
        raise KeyError(f"no campaign entry for model={model!r} "
                       f"system={system!r}")


class Campaign:
    """Fan an :class:`ExplorationSpec` template across models × systems.

    ``models`` / ``systems`` default to the template's own; objectives,
    constraints, search settings, schedule policy and batch size come from
    the template unchanged, so swapping the search strategy for the whole
    fleet is a one-field edit.
    """

    def __init__(self, template: ExplorationSpec,
                 models: Optional[Sequence[ModelRef]] = None,
                 systems: Optional[Sequence[SystemSpec]] = None):
        self.template = template
        self.models = list(models) if models is not None else [template.model]
        self.systems = (list(systems) if systems is not None
                        else [template.system])

    # -- fleet glue ----------------------------------------------------------
    def to_sweep(self) -> SweepSpec:
        """The campaign as durable data (template × models × systems)."""
        return SweepSpec(template=self.template, models=tuple(self.models),
                         systems=tuple(self.systems))

    @classmethod
    def from_sweep(cls, sweep: SweepSpec) -> "Campaign":
        """Rebuild the runnable campaign from its durable SweepSpec."""
        return cls(sweep.template, models=sweep.models,
                   systems=sweep.systems)

    def to_manifest(self, manifest_dir: str, max_retries: int = 2):
        """Materialize this campaign as a durable fleet work manifest;
        run it with ``python -m repro_torch.fleet run --manifest <dir>`` (see
        :mod:`repro_torch.fleet`).  Returns the created
        :class:`repro_torch.fleet.manifest.Manifest`."""
        from repro_torch.fleet.manifest import Manifest
        return Manifest.create(manifest_dir, self.to_sweep(),
                               max_retries=max_retries)

    def run(self, verbose: bool = False, device="cuda") -> CampaignResult:
        """Explore every (model, system) cell serially, sharing cost caches
        and memory tables per model, with the tensor strategies on
        ``device``; returns the merged CampaignResult."""
        from repro_torch.explore.runner import explore_graph, resolve_device
        resolve_device(device)
        t_start = time.perf_counter()
        tpl = self.template
        entries: List[CampaignEntry] = []
        for mref in self.models:
            graph, shared = mref.build()
            schedule = linearize(graph, tpl.schedule_policy)
            memtable = SegmentMemoryTable(schedule, shared)
            cost_cache: Dict = {}     # per-arch tables, shared across systems
            for sspec in self.systems:
                t0 = time.perf_counter()
                res = explore_graph(
                    graph, sspec.build(), objectives=tpl.objectives,
                    weights=tpl.weights, constraints=tpl.constraints,
                    search=tpl.search, batch=tpl.batch,
                    accuracy=tpl.accuracy,
                    shared_groups=shared, schedule=schedule,
                    cost_cache=cost_cache, memtable=memtable,
                    device=device)
                wall = time.perf_counter() - t0
                entries.append(CampaignEntry(
                    model=mref.label, system=sspec.label, result=res,
                    wall_s=wall))
                if verbose:
                    sel = res.selected
                    print(f"[campaign] {mref.label} × {sspec.label}: "
                          f"|pareto|={len(res.pareto)} "
                          f"cuts={sel.cuts if sel else None} "
                          f"({wall:.2f}s)")
        report = CampaignReport(
            template=tpl.to_dict(),
            entries=[campaign_entry_dict(e.model, e.system, e.result,
                                         e.wall_s) for e in entries],
            wall_s=round(time.perf_counter() - t_start, 4))
        return CampaignResult(entries=entries, report=report)
