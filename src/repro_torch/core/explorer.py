"""DEPRECATED — thin shim over :mod:`repro_torch.explore` (the JAX
package's ``repro.core.explorer``).

The monolithic :class:`Explorer` (the original Fig.-1 pipeline with an
inlined search loop) has been replaced by the declarative exploration API:

* :class:`repro_torch.explore.ExplorationSpec` — JSON-round-trippable run
  spec,
* :class:`repro_torch.explore.SearchStrategy` implementations
  (``ExhaustiveSearch`` / ``MultiCutScan`` / ``NSGA2Search`` /
  ``TorchNSGA2Search``),
* :class:`repro_torch.explore.Campaign` — multi-model/system fan-out with
  shared cost tables.

This module keeps the old constructor/``run`` surface working (it emits a
:class:`DeprecationWarning` and delegates to the strategies through
:func:`repro_torch.explore.run_search`) so existing callers keep
functioning while they migrate.  ``device`` is where the tensor strategies
run, the card unless the caller asks for another device, as
``run_search``'s.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.accuracy import ProxyAccuracy
from repro_torch.core.graph import LayerGraph, linearize
from repro_torch.core.partition import (Constraints, PartitionEval,
                                        PartitionEvaluator, SystemConfig)
from repro_torch.explore.filters import (candidate_positions, link_filter,
                                         memory_filter)
from repro_torch.explore.result import ExplorationResult  # re-export (compat)
from repro_torch.explore.runner import (DEFAULT_OBJECTIVES, run_search,
                                        select_weighted)
from repro_torch.explore.spec import SearchSettings

__all__ = ["DEFAULT_OBJECTIVES", "ExplorationResult", "Explorer"]


class Explorer:
    """Deprecated facade over the pluggable exploration API."""

    def __init__(self, graph: LayerGraph, system: SystemConfig,
                 constraints: Optional[Constraints] = None,
                 objectives: Sequence[str] = DEFAULT_OBJECTIVES,
                 weights: Optional[Sequence[float]] = None,
                 schedule_policy: str = "min_memory",
                 accuracy_fn: Optional[Callable] = None,
                 batch: int = 1,
                 shared_groups: Optional[Dict[str, str]] = None,
                 allow_multi_tensor_cuts: bool = False,
                 device="cuda"):
        warnings.warn(
            "repro_torch.core.Explorer is deprecated; use repro_torch.explore "
            "(ExplorationSpec + run_spec / explore_graph, or Campaign for "
            "multi-model fan-out)", DeprecationWarning, stacklevel=2)
        self.graph = graph
        self.system = system
        self.constraints = constraints or Constraints()
        self.objectives = tuple(objectives)
        self.weights = tuple(weights) if weights else tuple(
            1.0 for _ in self.objectives)
        self.schedule = linearize(graph, schedule_policy)
        acc = accuracy_fn or ProxyAccuracy(self.schedule, system)
        self.evaluator = PartitionEvaluator(
            graph, self.schedule, system, accuracy_fn=acc, batch=batch,
            shared_groups=shared_groups)
        self.allow_multi_tensor_cuts = allow_multi_tensor_cuts
        self.device = device

    # -- candidate discovery & filtering (now repro_torch.explore.filters) ---
    def candidate_cuts(self) -> List[int]:
        return candidate_positions(self.evaluator, self.constraints,
                                   self.allow_multi_tensor_cuts)

    def _memory_filter(self, cands: List[int]) -> List[int]:
        return memory_filter(self.evaluator, cands)

    def _link_filter(self, cands: List[int]) -> List[int]:
        return link_filter(self.evaluator, cands,
                           self.constraints.max_link_bytes)

    # -- evaluation + search (now repro_torch.explore.strategies/runner) -----
    def run(self, seed: int = 0, use_nsga: Optional[bool] = None,
            pop_size: Optional[int] = None,
            n_gen: Optional[int] = None) -> ExplorationResult:
        settings = SearchSettings(
            strategy="auto", seed=seed, use_nsga=use_nsga,
            pop_size=pop_size, n_gen=n_gen,
            allow_multi_tensor_cuts=self.allow_multi_tensor_cuts)
        return run_search(self.evaluator, constraints=self.constraints,
                          objectives=self.objectives, weights=self.weights,
                          settings=settings, device=self.device)

    # -- Def. 2 selection (now repro_torch.explore.runner.select_weighted) ---
    def _select(self, pareto: List[PartitionEval]) -> PartitionEval:
        return select_weighted(pareto, self.objectives, self.weights)
