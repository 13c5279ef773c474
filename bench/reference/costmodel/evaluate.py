"""Score a cut vector the plain way (Defs. 1-4): each platform's segment
summed layer by layer, each active link priced on its own.

``dtype`` is the precision of the sums: float64, as the configuration
states, or float32 for the control that the search cell's comparison has
to reject.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from .arch import get_arch
from .graph import LayerGraph, linearize
from .link import get_link
from .mapper import layer_cost_table
from .memory import MemoryModel, segment_memory


@dataclasses.dataclass
class Chain:
    """The platforms and links of a configuration's system, with the
    schedule and each platform's per-layer latency and energy."""
    graph: LayerGraph
    schedule: list
    archs: List[object]
    bits: List[int]
    capacities: List[int]
    links: List[object]
    costs: Dict[str, np.ndarray]


def build_chain(graph: LayerGraph, platforms: Sequence[dict],
                links: Sequence[str], policy: str = "min_memory",
                batch: int = 1) -> Chain:
    schedule = linearize(graph, policy)
    archs = [get_arch(p["arch"]) for p in platforms]
    costs = {}
    for arch in archs:
        if arch.name not in costs:
            tab = layer_cost_table(schedule, arch, batch)
            costs[arch.name] = np.array([[c.latency_s, c.energy_j]
                                         for c in tab], dtype=np.float64)
    return Chain(graph, schedule, archs, [int(p["bits"]) for p in platforms],
                 [int(p.get("mem_capacity") or a.mem_bytes)
                  for p, a in zip(platforms, archs)],
                 [get_link(l) for l in links], costs)


def evaluate(chain: Chain, cuts: Sequence[int], dtype=np.float64) -> dict:
    """latency_s, energy_j, throughput, link_bytes, memory_bytes and
    violation of the sorted cut vector ``cuts`` on ``chain``."""
    L = len(chain.schedule)
    cuts = [max(int(c), -1) for c in cuts]
    bounds = [-1] + cuts + [L - 1]
    one = dtype(1.0)
    stage_lat, energy = [], dtype(0.0)
    for k, arch in enumerate(chain.archs):
        a, b = bounds[k] + 1, bounds[k + 1]
        lat = dtype(0.0)
        for row in chain.costs[arch.name][a:b + 1].astype(dtype):
            lat = lat + row[0]
            energy = energy + row[1]
        stage_lat.append(lat)
    link_lat, link_bytes = [], []
    for k, link in enumerate(chain.links):
        p = cuts[k]
        sent = bounds[k + 1] > bounds[k]
        remaining = bounds[-1] > bounds[k + 1]
        if p < 0 or p >= L - 1 or not (sent and remaining):
            link_lat.append(dtype(0.0))
            link_bytes.append(0)
            continue
        nbytes = chain.graph.cut_bytes(chain.schedule, p,
                                       chain.bits[k] / 8.0)
        link_lat.append(dtype(link.latency_s(nbytes)))
        energy = energy + dtype(link.energy_j(nbytes))
        link_bytes.append(int(nbytes))
    latency = dtype(0.0)
    for t in stage_lat + link_lat:
        latency = latency + t
    active = [t for t in stage_lat + link_lat if t > 0]
    throughput = one / max(active) if active else dtype(0.0)
    mems, violation = [], 0.0
    for k in range(len(chain.archs)):
        seg = chain.schedule[bounds[k] + 1: bounds[k + 1] + 1]
        m = segment_memory(seg, MemoryModel(chain.bits[k] / 8.0))
        mems.append(m)
        if m > chain.capacities[k]:
            violation += (m - chain.capacities[k]) / chain.capacities[k]
    return {"latency_s": float(latency), "energy_j": float(energy),
            "throughput": float(throughput),
            "link_bytes": max(link_bytes) if link_bytes else 0,
            "memory_bytes": mems, "violation": violation}


def candidates(chain: Chain) -> List[int]:
    """The positions a cut may take (Fig. 1, §IV-B): clean cuts (one
    tensor crosses) whose prefix fits the first platform and whose suffix
    fits the last one."""
    sched = chain.schedule
    fits = [lambda seg, k=k: segment_memory(
        seg, MemoryModel(chain.bits[k] / 8.0)) <= chain.capacities[k]
        for k in (0, len(chain.archs) - 1)]
    return [p for p in chain.graph.clean_cuts(sched)
            if fits[0](sched[:p + 1]) and fits[1](sched[p + 1:])]


def evaluate_many(chain: Chain, cuts: np.ndarray) -> dict:
    """:func:`evaluate` of each row of ``cuts`` ((n, platforms - 1),
    sorted), in float64, as arrays.  Segment sums come from running sums,
    so a value may differ from :func:`evaluate`'s in its last bits."""
    C = np.asarray(cuts, dtype=np.int64)
    n, L = len(C), len(chain.schedule)
    C = np.maximum(C, -1)
    bounds = np.concatenate([np.full((n, 1), -1), C, np.full((n, 1), L - 1)],
                            axis=1)
    params = np.concatenate([[0], np.cumsum([l.params
                                             for l in chain.schedule])])
    act = np.array([l.activation_footprint for l in chain.schedule])
    peak = np.zeros((L, L), dtype=np.int64)        # peak[a, b]: max act[a..b]
    for a in range(L):
        peak[a, a:] = np.maximum.accumulate(act[a:])
    stage_lat, energy, mems = [], np.zeros(n), []
    violation = np.zeros(n)
    for k, arch in enumerate(chain.archs):
        run = np.concatenate([np.zeros((1, 2)),
                              np.cumsum(chain.costs[arch.name], axis=0)])
        a, b = bounds[:, k] + 1, bounds[:, k + 1]
        some = b >= a
        seg = np.where(some[:, None], run[np.maximum(b, -1) + 1] - run[a], 0.0)
        stage_lat.append(seg[:, 0])
        energy = energy + seg[:, 1]
        bpe = chain.bits[k] / 8.0
        m = np.where(some, np.floor(
            (params[np.maximum(b, -1) + 1] - params[a]) * bpe
            + peak[np.minimum(a, L - 1), np.maximum(b, 0)] * bpe), 0)
        m = m.astype(np.int64)
        mems.append(m)
        cap = chain.capacities[k]
        violation = violation + np.where(m > cap, (m - cap) / cap, 0.0)
    link_lat, link_bytes = [], []
    for k, link in enumerate(chain.links):
        nb = np.array([chain.graph.cut_bytes(chain.schedule, p,
                                             chain.bits[k] / 8.0)
                       for p in range(L - 1)] + [0])
        p = C[:, k]
        active = ((p >= 0) & (p < L - 1) & (bounds[:, k + 1] > bounds[:, k])
                  & (bounds[:, -1] > bounds[:, k + 1]))
        sent = np.where(active, nb[np.clip(p, 0, L - 1)], 0)
        link_lat.append(link.latency_s_vec(sent))
        energy = energy + link.energy_j_vec(sent)
        link_bytes.append(sent)
    times = np.stack(stage_lat + link_lat, axis=1)
    slowest = times.max(axis=1)
    return {"latency_s": times.sum(axis=1), "energy_j": energy,
            "throughput": np.where(slowest > 0, 1.0 / np.where(
                slowest > 0, slowest, 1.0), 0.0),
            "link_bytes": np.stack(link_bytes, axis=1).max(axis=1),
            "memory_bytes": np.stack(mems, axis=1), "violation": violation}
