"""Exploration engine: resolve a spec, run its strategies, finish with the
final non-dominated filtering and the paper's Def.-2 weighted-sum selection.

Three entry points, from most to least declarative:

* :func:`run_spec`      — resolve an :class:`ExplorationSpec` end-to-end.
* :func:`explore_graph` — run over a live ``LayerGraph``/``SystemConfig``
  (for callers that already hold model objects, e.g. the serving driver).
* :func:`run_search`    — run over a prebuilt ``PartitionEvaluator``
  (campaigns inject shared cost tables here).

All strategies — including the tensor ``torch_nsga2``, which reads the
evaluator's tables as tensors via ``PartitionEvaluator.torch_tables()``
(built lazily, cached per evaluator and device) — consume the same
evaluator, so cost-table sharing benefits the device path too.

Every entry point takes ``device`` (default ``"cuda"``), the device the
tensor strategies run on.  With the default and no CUDA device they raise;
pass ``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.accuracy import ProxyAccuracy
from repro_torch.core.graph import LayerGraph, linearize
from repro_torch.core.layers import LayerInfo
from repro_torch.core.memory import SegmentMemoryTable
from repro_torch.core.nsga2 import fast_non_dominated_sort
from repro_torch.core.partition import (Constraints, PartitionEval,
                                  PartitionEvaluator, SystemConfig,
                                  single_platform_eval)
from repro_torch.explore.filters import candidate_positions, link_feasibility
from repro_torch.explore.result import ExplorationResult
from repro_torch.explore.spec import AccuracySpec, ExplorationSpec, SearchSettings
from repro_torch.explore.strategies import (SearchContext, resolve_strategies)

DEFAULT_OBJECTIVES = ("latency", "energy")


def select_weighted(pareto: Sequence[PartitionEval],
                    objectives: Sequence[str],
                    weights: Sequence[float]) -> Optional[PartitionEval]:
    """Def. 2: min-max-normalized weighted sum over the front; ``None`` for
    an empty front."""
    if not pareto:
        return None
    F = np.array([ev.as_objectives(objectives) for ev in pareto], dtype=float)
    lo, hi = F.min(axis=0), F.max(axis=0)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    score = ((F - lo) / span) @ np.asarray(weights)
    return pareto[int(np.argmin(score))]


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; raises when a CUDA device is
    asked for and none is available (the port never carries on silently on
    the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            f"available; pass device='cpu' to run on the CPU")
    return dev


def run_search(evaluator: PartitionEvaluator, *,
               constraints: Optional[Constraints] = None,
               objectives: Sequence[str] = DEFAULT_OBJECTIVES,
               weights: Optional[Sequence[float]] = None,
               settings: Optional[SearchSettings] = None,
               candidates: Optional[Sequence[int]] = None,
               warm_cuts: Optional[Sequence[Sequence[int]]] = None,
               device="cuda") -> ExplorationResult:
    """Run the configured strategies over a prebuilt evaluator and finish:
    union pool → final non-dominated filter → Def.-2 selection.

    ``candidates`` overrides the filtered candidate positions — the online
    re-partitioner pins them to the *baseline* system's list so the gene
    table (and hence the compiled-runner shape) stays identical across
    drifted systems; feasibility shifts are then absorbed by constraint
    domination instead of by re-filtering.  ``warm_cuts`` feeds a previous
    Pareto front's cut rows to warm-startable strategies (honored when
    ``settings.warm_start`` is on).  ``device`` is where the tensor
    strategies run.
    """
    dev = resolve_device(device)
    constraints = constraints or Constraints()
    settings = settings or SearchSettings()
    objectives = tuple(objectives)
    weights = (tuple(weights) if weights
               else tuple(1.0 for _ in objectives))
    if candidates is None:
        cands = candidate_positions(evaluator, constraints,
                                    settings.allow_multi_tensor_cuts)
    else:
        cands = list(candidates)
    ctx = SearchContext(
        evaluator=evaluator, candidates=cands, constraints=constraints,
        objectives=objectives, settings=settings,
        link_feas=link_feasibility(evaluator, constraints.max_link_bytes),
        warm_cuts=(np.asarray(warm_cuts, dtype=int)
                   if warm_cuts is not None and len(warm_cuts) else None),
        device=str(dev))

    baselines = [single_platform_eval(evaluator, i, constraints)
                 for i in range(len(evaluator.system.platforms))]

    scan_pool: List[PartitionEval] = []
    search_pool: List[PartitionEval] = []
    all_evals: List[PartitionEval] = []
    nsga = None
    n_evaluated = 0
    used: List[str] = []
    for strategy in resolve_strategies(settings, ctx.n_cuts, len(cands)):
        out = strategy.search(ctx)
        (scan_pool if out.exhaustive else search_pool).extend(out.evals)
        if not all_evals and out.all_evals:
            all_evals = out.all_evals
        nsga = out.nsga or nsga
        n_evaluated += out.n_evaluated
        used.append(out.strategy_used or strategy.name)

    # pool order mirrors the legacy Explorer: exact scans, then feasible
    # baselines, then heuristic-search points (first-seen wins dedupe ties)
    pool = scan_pool + [b for b in baselines if b.violation <= 0] + search_pool
    if not pool:
        pool = baselines[:]

    pareto: List[PartitionEval] = []
    if pool:
        F = np.array([ev.as_objectives(objectives) for ev in pool])
        CV = np.array([ev.violation for ev in pool])
        fronts = fast_non_dominated_sort(F, CV)
        seen = set()
        for i in fronts[0]:
            if pool[i].cuts not in seen:
                seen.add(pool[i].cuts)
                pareto.append(pool[i])

    selected = select_weighted(pareto, objectives, weights)
    return ExplorationResult(
        schedule=list(evaluator.schedule), candidates=cands,
        all_evals=all_evals, pareto=pareto, selected=selected,
        baselines=baselines, objectives=objectives, nsga=nsga,
        strategy=settings.strategy, n_evaluated=n_evaluated,
        strategy_used="+".join(dict.fromkeys(used)) or settings.strategy)


def explore_graph(graph: LayerGraph, system: SystemConfig, *,
                  objectives: Sequence[str] = DEFAULT_OBJECTIVES,
                  weights: Optional[Sequence[float]] = None,
                  constraints: Optional[Constraints] = None,
                  search: Optional[SearchSettings] = None,
                  schedule_policy: str = "min_memory",
                  batch: int = 1,
                  accuracy_fn: Optional[Callable] = None,
                  accuracy: Optional[AccuracySpec] = None,
                  shared_groups: Optional[Dict[str, str]] = None,
                  schedule: Optional[Sequence[LayerInfo]] = None,
                  cost_cache: Optional[Dict] = None,
                  memtable: Optional[SegmentMemoryTable] = None,
                  device="cuda") -> ExplorationResult:
    """Run one exploration over live graph/system objects.

    ``schedule`` / ``cost_cache`` / ``memtable`` let campaign runners share
    per-model scheduling and per-arch cost tables across systems.  The
    accuracy oracle resolves in precedence order: a live ``accuracy_fn``
    object, then a declarative ``accuracy`` :class:`AccuracySpec` (proxy
    knobs or a registered measured oracle), then the default
    :class:`ProxyAccuracy`.
    """
    resolve_device(device)
    if schedule is None:
        schedule = linearize(graph, schedule_policy)
    acc = accuracy_fn
    if acc is None and accuracy is not None:
        acc = accuracy.build(graph, schedule, system, device)
    if acc is None:
        acc = ProxyAccuracy(schedule, system)
    evaluator = PartitionEvaluator(
        graph, schedule, system, accuracy_fn=acc, batch=batch,
        shared_groups=shared_groups, cost_cache=cost_cache,
        memtable=memtable)
    return run_search(evaluator, constraints=constraints,
                      objectives=objectives, weights=weights,
                      settings=search, device=device)


def run_spec(spec: ExplorationSpec, device="cuda") -> ExplorationResult:
    """Resolve a declarative spec (model + system refs) and run it, with the
    tensor strategies on ``device``."""
    resolve_device(device)
    graph, shared = spec.model.build()
    system = spec.system.build()
    return explore_graph(
        graph, system, objectives=spec.objectives, weights=spec.weights,
        constraints=spec.constraints, search=spec.search,
        schedule_policy=spec.schedule_policy, batch=spec.batch,
        accuracy=spec.accuracy, shared_groups=shared, device=device)
