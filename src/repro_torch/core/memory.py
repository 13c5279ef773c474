"""Memory-size estimation — §IV-B, Definition 3.

``m_A(l_n..l_m) = (Σ_i s_i + max_j a_j) · b_A`` with ``a_j = f_in,j + f_out,j``.

For a multi-platform schedule the model is applied per segment.  Shared
weights (Zamba2-style blocks reused across the depth) are counted **once per
platform** that executes any layer referencing them — a beyond-paper
extension controlled by ``shared_groups``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.layers import LayerInfo


@dataclasses.dataclass(frozen=True)
class MemoryModel:
    """Per-platform memory accounting parameters."""

    bytes_per_param: float = 2.0   # b_A for weights (quantized bit width / 8)
    bytes_per_act: Optional[float] = None  # defaults to bytes_per_param

    @property
    def act_bytes(self) -> float:
        return self.bytes_per_act if self.bytes_per_act is not None else self.bytes_per_param


def segment_memory(layers: Sequence[LayerInfo], model: MemoryModel,
                   shared_groups: Optional[Dict[str, str]] = None,
                   batch: int = 1) -> int:
    """Definition 3 for one contiguous segment on one platform.

    shared_groups maps layer name -> group id; all layers of a group share
    one copy of their parameters (counted once).
    """
    if not layers:
        return 0
    params = 0
    seen_groups = set()
    for l in layers:
        g = (shared_groups or {}).get(l.name)
        if g is None:
            params += l.params
        elif g not in seen_groups:
            params += l.params
            seen_groups.add(g)
    peak_act = max(l.activation_footprint for l in layers) * batch
    return int(params * model.bytes_per_param + peak_act * model.act_bytes)


class SegmentMemoryTable:
    """Precomputed Definition-3 structures for batched segment queries.

    Built once per (schedule, shared_groups); ``batched(a, b, model, batch)``
    then returns the memory of ``schedule[a..b]`` for whole index arrays in
    O(1) per segment:

    * ungrouped parameters via a prefix sum,
    * shared-group parameters via per-group sorted member positions
      (``searchsorted`` finds the first member inside each segment, matching
      the scalar first-seen accounting of :func:`segment_memory`),
    * peak activation via a sparse table (range-max in two overlapping
      power-of-two windows).
    """

    def __init__(self, schedule: Sequence[LayerInfo],
                 shared_groups: Optional[Dict[str, str]] = None):
        groups = shared_groups or {}
        self.L = len(schedule)
        params = np.array([l.params for l in schedule], dtype=np.int64)
        acts = np.array([l.activation_footprint for l in schedule],
                        dtype=np.int64)
        grouped = np.array([groups.get(l.name) is not None for l in schedule],
                           dtype=bool) if self.L else np.zeros(0, dtype=bool)
        base = np.where(grouped, 0, params) if self.L else params
        self.base_prefix = np.concatenate([[0], np.cumsum(base)])
        by_group: Dict[str, List[int]] = {}
        for i, l in enumerate(schedule):
            g = groups.get(l.name)
            if g is not None:
                by_group.setdefault(g, []).append(i)
        # (sorted member positions, member params) per group
        self.groups = [(np.asarray(pos, dtype=np.int64), params[pos])
                       for pos in by_group.values()]
        if self.L:
            levels = int(self.L).bit_length()
            st = np.zeros((levels, self.L), dtype=np.int64)
            st[0] = acts
            for j in range(1, levels):
                w, half = 1 << j, 1 << (j - 1)
                st[j, : self.L - w + 1] = np.maximum(
                    st[j - 1, : self.L - w + 1],
                    st[j - 1, half: self.L - half + 1])
            self.act_sparse = st

    def batched(self, a: np.ndarray, b: np.ndarray, model: MemoryModel,
                batch: int = 1) -> np.ndarray:
        """Memory bytes of ``schedule[a..b]`` inclusive; 0 where ``a > b``."""
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        valid = a <= b
        aa = np.where(valid, a, 0)
        bb = np.where(valid, b, 0)
        par = self.base_prefix[bb + 1] - self.base_prefix[aa]
        for pos, gpar in self.groups:
            idx = np.minimum(np.searchsorted(pos, aa), len(pos) - 1)
            hit = pos[idx] >= aa
            hit &= pos[idx] <= bb
            par = par + np.where(hit, gpar[idx], 0)
        length = bb - aa + 1
        k = np.frexp(length.astype(np.float64))[1] - 1
        peak = np.maximum(self.act_sparse[k, aa],
                          self.act_sparse[k, bb - (1 << k) + 1]) * batch
        mem = par * model.bytes_per_param + peak * model.act_bytes
        return np.where(valid, mem.astype(np.int64), 0)


def split_memory(schedule: Sequence[LayerInfo], cut_positions: Sequence[int],
                 models: Sequence[MemoryModel],
                 shared_groups: Optional[Dict[str, str]] = None,
                 batch: int = 1) -> List[int]:
    """Memory per platform for a multi-cut partition of ``schedule``.

    ``cut_positions`` are sorted indices p; platform k executes
    schedule[p_{k-1}+1 .. p_k].  len(models) == len(cut_positions) + 1.
    """
    cuts = list(cut_positions)
    assert cuts == sorted(cuts), "cut positions must be sorted"
    assert len(models) == len(cuts) + 1
    bounds = [-1] + cuts + [len(schedule) - 1]
    out: List[int] = []
    for k in range(len(models)):
        seg = schedule[bounds[k] + 1: bounds[k + 1] + 1]
        out.append(segment_memory(seg, models[k], shared_groups, batch))
    return out


def prefix_feasible_limit(schedule: Sequence[LayerInfo], model: MemoryModel,
                          capacity_bytes: int,
                          shared_groups: Optional[Dict[str, str]] = None,
                          batch: int = 1) -> int:
    """Largest p such that schedule[0..p] fits in ``capacity_bytes``.

    The paper prunes *all following* candidate points once the prefix
    exceeds platform-A memory (§IV-B) — Def. 3 prefix cost is monotone in p,
    so a single limit suffices.  Returns -1 if even the first layer doesn't
    fit.
    """
    params = 0.0
    peak_act = 0
    seen = set()
    limit = -1
    for p, l in enumerate(schedule):
        g = (shared_groups or {}).get(l.name)
        if g is None:
            params += l.params
        elif g not in seen:
            params += l.params
            seen.add(g)
        peak_act = max(peak_act, l.activation_footprint * batch)
        total = params * model.bytes_per_param + peak_act * model.act_bytes
        if total <= capacity_bytes:
            limit = p
        else:
            break
    return limit


def min_memory_schedule(graph, model: MemoryModel, batch: int = 1):
    """§IV-B: among topological orders, pick one minimizing the peak a_j-driven
    footprint inside parallel-branch regions.

    Exact search over all topological orders is exponential; the paper builds
    subgraphs for parallel branches and evaluates their orders.  We use the
    greedy min-activation-first policy (optimal for series-parallel regions
    whose branches are chains with monotone footprints — true for the CNN
    zoo) and fall back to comparing against the insertion order, returning
    whichever has the lower Definition-3 segment cost.
    """
    from repro_torch.core.graph import linearize
    cands = [linearize(graph, "insertion"), linearize(graph, "min_memory")]
    costs = [segment_memory(s, model, batch=batch) for s in cands]
    return cands[costs.index(min(costs))]
