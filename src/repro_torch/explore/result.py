"""Exploration results and their serializable report form.

:class:`ExplorationResult` is the in-memory outcome of one search (full
``PartitionEval`` objects, live schedule); ``to_report()`` flattens it into
plain JSON-safe dicts for storage inside a
:class:`~repro_torch.explore.campaign.CampaignReport`.

``summary()`` and the report paths are total: they tolerate empty Pareto
fronts (``selected is None``) and cut indices outside the schedule (the
``-1`` / ``L-1`` sentinels of skipped platforms) without raising.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.layers import LayerInfo
from repro_torch.core.nsga2 import NSGA2Result
from repro_torch.core.partition import PartitionEval


def eval_to_dict(ev: PartitionEval) -> Dict[str, Any]:
    """JSON-safe dict form of a :class:`PartitionEval`."""
    d = dataclasses.asdict(ev)
    d["cuts"] = list(d["cuts"])
    d["memory_bytes"] = [int(m) for m in d["memory_bytes"]]
    d["stage_latency_s"] = list(d["stage_latency_s"])
    d["link_latency_s"] = list(d["link_latency_s"])
    return d


def eval_from_dict(d: Dict[str, Any]) -> PartitionEval:
    return PartitionEval(
        cuts=tuple(int(c) for c in d["cuts"]),
        latency_s=float(d["latency_s"]),
        energy_j=float(d["energy_j"]),
        throughput=float(d["throughput"]),
        link_bytes=int(d["link_bytes"]),
        memory_bytes=tuple(int(m) for m in d["memory_bytes"]),
        accuracy=float(d["accuracy"]),
        stage_latency_s=tuple(float(t) for t in d["stage_latency_s"]),
        link_latency_s=tuple(float(t) for t in d["link_latency_s"]),
        violation=float(d.get("violation", 0.0)))


@dataclasses.dataclass
class ExplorationResult:
    """Outcome of the Fig.-1 pipeline for one (model, system) pair."""

    schedule: List[LayerInfo]
    candidates: List[int]                 # feasible clean-cut positions
    all_evals: List[PartitionEval]        # scan points (exhaustive paths)
    pareto: List[PartitionEval]
    selected: Optional[PartitionEval]     # Def.-2 pick; None if front empty
    baselines: List[PartitionEval]        # single-platform runs
    objectives: Tuple[str, ...]
    nsga: Optional[NSGA2Result] = None
    strategy: str = "auto"
    n_evaluated: int = 0          # candidate vectors scored by all strategies
    strategy_used: str = ""       # strategies that actually ran ("+"-joined);
    #                               differs from `strategy` on documented
    #                               downgrades (torch_nsga2 measured-accuracy
    #                               fallback) and for the "auto" policy

    def layer_name(self, cut: int) -> str:
        """Layer name at a cut position; ``"-"`` for the ``-1`` / out-of-
        range sentinels (platform skipped / single-platform schedules)."""
        if 0 <= cut < len(self.schedule):
            return self.schedule[cut].name
        return "-"

    def summary(self) -> str:
        """Human-readable report: schedule size, baselines, Pareto front."""
        lines = [f"schedule: {len(self.schedule)} layers, "
                 f"{len(self.candidates)} feasible cut points "
                 f"[{self.strategy}]"]
        for i, b in enumerate(self.baselines):
            lines.append(
                f"  all-on-platform-{i}: lat={b.latency_s*1e3:.3f} ms  "
                f"E={b.energy_j*1e3:.3f} mJ  th={b.throughput:.1f}/s  "
                f"acc={b.accuracy:.4f}")
        s = self.selected
        if s is None:
            lines.append("  no feasible partitioning found "
                         "(empty Pareto front)")
        else:
            names = [self.layer_name(c) for c in s.cuts]
            lines.append(
                f"  selected cuts {s.cuts} ({','.join(names)}): "
                f"lat={s.latency_s*1e3:.3f} ms  E={s.energy_j*1e3:.3f} mJ  "
                f"th={s.throughput:.1f}/s  acc={s.accuracy:.4f}  "
                f"mem={tuple(int(m/1024) for m in s.memory_bytes)} KiB")
        return "\n".join(lines)

    @classmethod
    def empty_report(cls, strategy: str = "-") -> Dict[str, Any]:
        """A neutral ``to_report()``-shaped dict (no schedule, no points) —
        in sync with real reports by construction; used for failed-cell
        placeholders in fleet merges."""
        return cls(schedule=[], candidates=[], all_evals=[], pareto=[],
                   selected=None, baselines=[], objectives=(),
                   strategy=strategy).to_report()

    def to_report(self) -> Dict[str, Any]:
        """JSON-safe flattened form (Pareto front + selection + baselines);
        the full ``all_evals`` scan is intentionally not serialized."""
        return {
            "n_layers": len(self.schedule),
            "n_candidates": len(self.candidates),
            "n_scanned": len(self.all_evals),
            "n_evaluated": self.n_evaluated,
            "objectives": list(self.objectives),
            "strategy": self.strategy,
            "strategy_used": self.strategy_used or self.strategy,
            "pareto": [eval_to_dict(e) for e in self.pareto],
            "selected": (eval_to_dict(self.selected)
                         if self.selected is not None else None),
            "selected_layers": ([self.layer_name(c) for c in
                                 self.selected.cuts]
                                if self.selected is not None else []),
            "baselines": [eval_to_dict(b) for b in self.baselines],
        }
