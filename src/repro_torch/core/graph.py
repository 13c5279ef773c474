"""Layer-graph IR: DAG construction, topological scheduling, cut discovery.

This is §IV-A of the paper.  A model is a DAG of :class:`LayerInfo` nodes.
The partitioner needs:

* a *linear schedule* (topological order). The paper breaks ties among
  parallel branches randomly; we additionally provide a memory-minimizing
  tie-break (used by the memory estimator, §IV-B) that schedules parallel
  branches as contiguous subgraphs picked greedily by Definition-3 cost.
* the set of *clean cut points*: positions ``p`` in the schedule where every
  edge from the prefix to the suffix carries the output of the single layer
  ``l_p`` (Definition 1 transmits exactly ``f_p``).  A beyond-paper extension
  also enumerates *multi-tensor cuts* where the full live set is transmitted.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.layers import LayerInfo


class GraphError(ValueError):
    pass


@dataclasses.dataclass
class LayerGraph:
    """A DAG of layers. Edges carry the producer's output feature map."""

    nodes: Dict[str, LayerInfo] = dataclasses.field(default_factory=dict)
    edges: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    name: str = "graph"

    # -- construction -------------------------------------------------------
    def add(self, layer: LayerInfo, after: Optional[Iterable[str]] = None) -> LayerInfo:
        """Insert one layer with edges from each ``after`` predecessor."""
        if layer.name in self.nodes:
            raise GraphError(f"duplicate node {layer.name!r}")
        self.nodes[layer.name] = layer
        for pred in (after or ()):
            if pred not in self.nodes:
                raise GraphError(f"unknown predecessor {pred!r}")
            self.edges.append((pred, layer.name))
        return layer

    def chain(self, layers: Sequence[LayerInfo], after: Optional[str] = None) -> str:
        """Add a linear chain; returns the name of the last layer."""
        prev = after
        for l in layers:
            self.add(l, after=[prev] if prev else None)
            prev = l.name
        assert prev is not None
        return prev

    # -- adjacency ----------------------------------------------------------
    def preds(self, name: str) -> List[str]:
        """Direct predecessors of ``name`` (edge order)."""
        return [u for (u, v) in self.edges if v == name]

    def succs(self, name: str) -> List[str]:
        """Direct successors of ``name`` (edge order)."""
        return [v for (u, v) in self.edges if u == name]

    def _adj(self) -> Tuple[Dict[str, List[str]], Dict[str, int]]:
        out: Dict[str, List[str]] = {n: [] for n in self.nodes}
        indeg: Dict[str, int] = {n: 0 for n in self.nodes}
        for u, v in self.edges:
            out[u].append(v)
            indeg[v] += 1
        return out, indeg

    def __len__(self) -> int:
        return len(self.nodes)

    @property
    def total_params(self) -> int:
        """Parameter count summed over every layer."""
        return sum(l.params for l in self.nodes.values())

    @property
    def total_macs(self) -> int:
        """MAC count summed over every layer."""
        return sum(l.macs for l in self.nodes.values())

    # -- scheduling (§IV-A) --------------------------------------------------
    def topo_sort(self, seed: Optional[int] = None,
                  key=None) -> List[LayerInfo]:
        """Kahn's algorithm.

        ``seed`` reproduces the paper's random tie-break among ready parallel
        layers; ``key`` (name -> sortable) overrides it with a deterministic
        policy (used by the min-memory scheduler).  Default: insertion order.
        """
        out, indeg = self._adj()
        ready = [n for n in self.nodes if indeg[n] == 0]
        if not ready and self.nodes:
            raise GraphError("graph has no source node (cycle?)")
        rng = None
        if seed is not None:
            import random
            rng = random.Random(seed)
        order: List[LayerInfo] = []
        while ready:
            if rng is not None:
                idx = rng.randrange(len(ready))
            elif key is not None:
                idx = min(range(len(ready)), key=lambda i: key(ready[i]))
            else:
                idx = 0
            n = ready.pop(idx)
            order.append(self.nodes[n])
            for m in out[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    ready.append(m)
        if len(order) != len(self.nodes):
            cyc = set(self.nodes) - {l.name for l in order}
            raise GraphError(f"cycle detected among {sorted(cyc)[:5]}...")
        return order

    # -- cut analysis --------------------------------------------------------
    def live_set(self, schedule: Sequence[LayerInfo], p: int) -> List[str]:
        """Tensors live across the cut after position ``p`` (0-indexed).

        A producer in the prefix is live if any consumer is in the suffix,
        or if it is a graph output (no consumers at all) — graph outputs
        are not transmitted, so they are excluded here.
        """
        prefix = {l.name for l in schedule[: p + 1]}
        live: List[str] = []
        for name in prefix:
            consumers = self.succs(name)
            if any(c not in prefix for c in consumers):
                live.append(name)
        return sorted(live)

    def clean_cuts(self, schedule: Sequence[LayerInfo]) -> List[int]:
        """Positions p where the live set is exactly {schedule[p].name}.

        These are the paper's Definition-1 partitioning points: one tensor
        (f_p, the output of l_p) crosses the link.
        """
        cuts: List[int] = []
        for p in range(len(schedule) - 1):
            if self.live_set(schedule, p) == [schedule[p].name]:
                cuts.append(p)
        return cuts

    def all_cuts(self, schedule: Sequence[LayerInfo],
                 max_live: int = 4) -> List[Tuple[int, List[str]]]:
        """Beyond-paper: every position with |live set| <= max_live."""
        out: List[Tuple[int, List[str]]] = []
        for p in range(len(schedule) - 1):
            live = self.live_set(schedule, p)
            if 0 < len(live) <= max_live:
                out.append((p, live))
        return out

    def cut_bytes(self, schedule: Sequence[LayerInfo], p: int,
                  bytes_per_elem: float) -> int:
        """Bytes transmitted over the link for a cut after position p.

        Sub-byte widths round up (a 4-bit link shipping one element still
        moves a byte), matching the serving-side accounting."""
        live = self.live_set(schedule, p)
        total = sum(self.nodes[n].fmap_out for n in live)
        return int(math.ceil(total * bytes_per_elem))

    # -- parallel-branch discovery (for the min-memory scheduler) ------------
    def branch_regions(self, schedule: Sequence[LayerInfo]) -> List[Tuple[int, int]]:
        """Maximal [i, j] index ranges in the schedule that sit between two
        clean cuts — inside such a region parallel branches may be reordered
        without affecting anything outside it."""
        cuts = [-1] + self.clean_cuts(schedule) + [len(schedule) - 1]
        regions = []
        for a, b in zip(cuts, cuts[1:]):
            if b - a > 1:
                regions.append((a + 1, b))
        return regions

    def validate_schedule(self, schedule: Sequence[LayerInfo]) -> bool:
        """True iff ``schedule`` is a topological order covering every
        node exactly once."""
        pos = {l.name: i for i, l in enumerate(schedule)}
        if len(pos) != len(self.nodes):
            return False
        return all(pos[u] < pos[v] for u, v in self.edges)


def linearize(graph: LayerGraph, policy: str = "insertion",
              seed: Optional[int] = None) -> List[LayerInfo]:
    """Produce the linear execution schedule used by the partitioner.

    policies:
      * ``insertion`` — deterministic, model-definition order.
      * ``random``    — the paper's random tie-break (give ``seed``).
      * ``min_memory``— greedy: among ready nodes prefer the one whose
        activation footprint (Def. 3 ``a_j``) is smallest, which empirically
        matches the paper's branch-subgraph memory minimization for the
        CNN zoo (branches are scheduled depth-first, cheapest first).
    """
    if policy == "insertion":
        return graph.topo_sort()
    if policy == "random":
        return graph.topo_sort(seed=0 if seed is None else seed)
    if policy == "min_memory":
        names = list(graph.nodes)
        order_idx = {n: i for i, n in enumerate(names)}
        return graph.topo_sort(
            key=lambda n: (graph.nodes[n].activation_footprint, order_idx[n]))
    raise ValueError(f"unknown schedule policy {policy!r}")
