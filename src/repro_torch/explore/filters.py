"""Candidate-cut discovery and filtering (Fig. 1 stages 2–3, §IV-B).

Positions are pruned by two feasibility checks before any metric evaluation:

* **memory** — the prefix up to ``p`` must fit the first platform and the
  suffix after ``p`` the last one (interior platforms are handled by
  NSGA-II constraint domination, as in the paper);
* **link** — a per-``(link, position)`` feasibility matrix prices the cut
  tensor at each *producer* platform's bit width.  A position survives if
  it is feasible on at least one link (identical keep-set to the old
  cheapest-producer scalar bound, since ``ceil`` is monotone in the bit
  width), but the matrix additionally lets multi-cut strategies prune
  *exactly*: a full cut vector is dropped only when one of its **active**
  cuts is infeasible on the specific link it lands on
  (:func:`feasible_cut_rows`).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core.memory import prefix_feasible_limit
from repro_torch.core.partition import Constraints, PartitionEvaluator


def memory_filter(evaluator: PartitionEvaluator,
                  positions: List[int]) -> List[int]:
    """§IV-B memory pruning of candidate positions (see module docstring)."""
    schedule, system = evaluator.schedule, evaluator.system
    plat0 = system.platforms[0]
    limit = prefix_feasible_limit(
        schedule, plat0.memory_model, plat0.capacity,
        evaluator.shared_groups, evaluator.batch)
    positions = [p for p in positions if p <= limit]
    platN = system.platforms[-1]
    rev = prefix_feasible_limit(
        list(reversed(schedule)), platN.memory_model, platN.capacity,
        evaluator.shared_groups, evaluator.batch)
    min_p = len(schedule) - 2 - rev   # suffix schedule[p+1..] must fit plat N
    return [p for p in positions if p >= min_p]


def link_feasibility(evaluator: PartitionEvaluator,
                     max_link_bytes: Optional[int]) -> Optional[np.ndarray]:
    """Per-(link, position) feasibility matrix, or ``None`` when unbounded.

    ``feas[k, p]`` is True iff the tensor cut after position ``p``, priced
    at link ``k``'s producer platform (platform ``k``) bit width and the
    evaluator's batch size, fits the per-cut bandwidth budget.  Shape is
    ``(n_links, L - 1)`` over *all* schedule positions so strategies can
    index it by absolute cut position.
    """
    system = evaluator.system
    if not max_link_bytes or len(system.platforms) < 2:
        return None
    elems = evaluator.cut_elements()          # (L-1,) elements over the link
    feas = np.empty((len(system.links), len(elems)), dtype=bool)
    for k in range(len(system.links)):
        bpe = system.platforms[k].quant.bits / 8.0
        nbytes = np.ceil(elems * bpe).astype(np.int64) * evaluator.batch
        feas[k] = nbytes <= max_link_bytes
    return feas


def link_filter(evaluator: PartitionEvaluator, positions: List[int],
                max_link_bytes: Optional[int]) -> List[int]:
    """Keep positions feasible on at least one link they could land on."""
    feas = link_feasibility(evaluator, max_link_bytes)
    if feas is None:
        return positions
    any_link = feas.any(axis=0)
    return [p for p in positions if any_link[p]]


def candidate_positions(evaluator: PartitionEvaluator,
                        constraints: Optional[Constraints] = None,
                        allow_multi_tensor_cuts: bool = False) -> List[int]:
    """Fig.-1 candidate discovery + filtering: clean (Def.-1) cut positions
    that pass the memory and link feasibility checks."""
    graph, schedule = evaluator.graph, evaluator.schedule
    if allow_multi_tensor_cuts:
        cands = [p for p, _ in graph.all_cuts(schedule)]
    else:
        cands = graph.clean_cuts(schedule)
    cands = memory_filter(evaluator, cands)
    cap = constraints.max_link_bytes if constraints else None
    return link_filter(evaluator, cands, cap)


def feasible_cut_rows(C: np.ndarray, evaluator: PartitionEvaluator,
                      feas: Optional[np.ndarray]) -> np.ndarray:
    """Exact per-(link, position) pruning of an ``(N, n_cuts)`` cut matrix.

    Returns a boolean keep-mask.  A row is dropped only when one of its
    *active* cuts (producer ran something, and something remains downstream
    — the same activity rule as ``evaluate_batch``) is infeasible on the
    link it occupies; inactive cuts ship nothing and never disqualify.
    Rows dropped here would carry a positive ``max_link_bytes`` violation,
    so removing them never removes a feasible point.
    """
    n = len(C)
    if feas is None or n == 0:
        return np.ones(n, dtype=bool)
    L = len(evaluator.schedule)
    bounds = np.concatenate(
        [np.full((n, 1), -1, dtype=np.int64), C.astype(np.int64),
         np.full((n, 1), L - 1, dtype=np.int64)], axis=1)
    keep = np.ones(n, dtype=bool)
    for k in range(len(evaluator.system.links)):
        p = C[:, k]
        sent = bounds[:, k + 1] > bounds[:, k]
        remaining = bounds[:, -1] > bounds[:, k + 1]
        active = (p >= 0) & (p < L - 1) & sent & remaining
        keep &= ~active | feas[k, np.clip(p, 0, L - 2)]
    return keep
