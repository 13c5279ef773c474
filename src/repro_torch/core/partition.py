"""Partition evaluation — Definitions 1–4 over a concrete system.

A *system* is a chain of platforms connected by links (the paper's §V-C
four-platform chain generalizes the two-platform case).  Given a linear
schedule and a sorted cut vector, this module produces every optimization
metric of Table I's last row: latency, bandwidth, energy, memory, accuracy
and throughput.

Cut encoding: platform ``k`` executes ``schedule[cuts[k-1]+1 .. cuts[k]]``
(with ``cuts[-1] := -1`` and ``cuts[n] := L-1`` implied).  A cut may be
``-1`` (empty leading segment) or repeat the previous value (platform
skipped); that is how the explorer discovers that *fewer* partitions can be
optimal (Table II).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import LayerGraph
from repro_torch.core.hwmodel.arch import AcceleratorArch
from repro_torch.core.hwmodel.mapper import LayerCost, layer_cost_table
from repro_torch.core.layers import LayerInfo
from repro_torch.core.link import LinkModel
from repro_torch.core.memory import (MemoryModel, SegmentMemoryTable,
                               segment_memory)
from repro_torch.core.quant import QuantSpec


@dataclasses.dataclass(frozen=True)
class Platform:
    """One compute node in the chain."""
    name: str
    arch: AcceleratorArch
    quant: QuantSpec
    mem_capacity: Optional[int] = None   # defaults to arch.mem_bytes

    @property
    def capacity(self) -> int:
        """Usable memory bytes: explicit override or the arch default."""
        return self.mem_capacity if self.mem_capacity is not None else self.arch.mem_bytes

    @property
    def memory_model(self) -> MemoryModel:
        """Bytes-per-parameter model implied by the quantization bits."""
        return MemoryModel(bytes_per_param=self.quant.bits / 8.0)


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """A chain: platforms[i] --links[i]--> platforms[i+1]."""
    platforms: Sequence[Platform]
    links: Sequence[LinkModel]

    def __post_init__(self):
        assert len(self.links) == len(self.platforms) - 1

    @property
    def n_cuts(self) -> int:
        """Number of cut positions (= platforms - 1)."""
        return len(self.platforms) - 1


@dataclasses.dataclass(frozen=True)
class Constraints:
    max_link_bytes: Optional[int] = None       # per-cut bandwidth budget
    min_accuracy: Optional[float] = None
    max_latency_s: Optional[float] = None
    max_energy_j: Optional[float] = None
    min_throughput: Optional[float] = None


@dataclasses.dataclass
class PartitionEval:
    cuts: Tuple[int, ...]
    latency_s: float
    energy_j: float
    throughput: float              # inferences / s (Def. 4)
    link_bytes: int                # max bytes over any active link
    memory_bytes: Tuple[int, ...]  # per platform (Def. 3)
    accuracy: float
    stage_latency_s: Tuple[float, ...]
    link_latency_s: Tuple[float, ...]
    violation: float = 0.0

    @property
    def n_partitions(self) -> int:
        """Number of platforms that execute at least one layer."""
        return sum(1 for t in self.stage_latency_s if t > 0)

    def as_objectives(self, keys: Sequence[str]) -> List[float]:
        table = {
            "latency": self.latency_s,
            "energy": self.energy_j,
            "throughput": -self.throughput,       # maximize
            "bandwidth": float(self.link_bytes),
            "memory": float(max(self.memory_bytes)),
            "accuracy": -self.accuracy,           # maximize
        }
        return [table[k] for k in keys]


@dataclasses.dataclass
class BatchEval:
    """Column-oriented result of :meth:`PartitionEvaluator.evaluate_batch`.

    Every field is an array whose leading axis indexes the N candidate cut
    vectors; :meth:`row` materializes a single :class:`PartitionEval` and
    :meth:`as_objectives` hands NSGA-II its (N, n_obj) matrix directly.
    """

    cuts: np.ndarray             # (N, n_cuts) int
    latency_s: np.ndarray        # (N,)
    energy_j: np.ndarray         # (N,)
    throughput: np.ndarray       # (N,)
    link_bytes: np.ndarray       # (N,) int — max over active links
    memory_bytes: np.ndarray     # (N, n_platforms) int
    accuracy: np.ndarray         # (N,)
    stage_latency_s: np.ndarray  # (N, n_platforms)
    link_latency_s: np.ndarray   # (N, n_links)
    violation: np.ndarray        # (N,)

    def __len__(self) -> int:
        return len(self.cuts)

    def as_objectives(self, keys: Sequence[str]) -> np.ndarray:
        table = {
            "latency": self.latency_s,
            "energy": self.energy_j,
            "throughput": -self.throughput,
            "bandwidth": self.link_bytes.astype(float),
            "memory": self.memory_bytes.max(axis=1).astype(float),
            "accuracy": -self.accuracy,
        }
        return np.stack([table[k] for k in keys], axis=1)

    def row(self, i: int) -> PartitionEval:
        return PartitionEval(
            cuts=tuple(int(c) for c in self.cuts[i]),
            latency_s=float(self.latency_s[i]),
            energy_j=float(self.energy_j[i]),
            throughput=float(self.throughput[i]),
            link_bytes=int(self.link_bytes[i]),
            memory_bytes=tuple(int(m) for m in self.memory_bytes[i]),
            accuracy=float(self.accuracy[i]),
            stage_latency_s=tuple(float(t) for t in self.stage_latency_s[i]),
            link_latency_s=tuple(float(t) for t in self.link_latency_s[i]),
            violation=float(self.violation[i]))

    def to_evals(self) -> List[PartitionEval]:
        return [self.row(i) for i in range(len(self))]


class PartitionEvaluator:
    """Evaluates cut vectors against a system; caches per-arch cost tables."""

    def __init__(self, graph: LayerGraph, schedule: Sequence[LayerInfo],
                 system: SystemConfig,
                 accuracy_fn: Optional[Callable[[Sequence[int]], float]] = None,
                 batch: int = 1,
                 shared_groups: Optional[Dict[str, str]] = None,
                 cost_cache: Optional[Dict[str, Tuple[List[LayerCost],
                                                      np.ndarray]]] = None,
                 memtable: Optional[SegmentMemoryTable] = None):
        """``cost_cache`` / ``memtable`` optionally inject precomputed
        per-arch cost tables and the Def.-3 memory table so campaign
        runners can share them across systems; the cache is keyed by arch
        name and is only valid for this exact (schedule, batch) pair —
        callers own that invariant."""
        self.graph = graph
        self.schedule = list(schedule)
        self.system = system
        self.batch = batch
        self.accuracy_fn = accuracy_fn or (lambda cuts: 1.0)
        self.shared_groups = shared_groups
        self._tables: Dict[str, List[LayerCost]] = {}
        self._prefix: Dict[str, np.ndarray] = {}
        self._cut_bytes_cache: Dict[Tuple[int, float], int] = {}
        self._memtable = (memtable if memtable is not None
                          else SegmentMemoryTable(self.schedule, shared_groups))
        self._cut_elems: Optional[np.ndarray] = None  # lazy, O(L·E) to build
        self._torch_tables: Dict[str, object] = {}    # EvalTables per device
        cache = cost_cache if cost_cache is not None else {}
        for plat in system.platforms:
            key = plat.arch.name
            if key not in self._tables:
                if key in cache:
                    tab, pre = cache[key]
                else:
                    tab = layer_cost_table(self.schedule, plat.arch, batch)
                    lat = np.array([c.latency_s for c in tab])
                    en = np.array([c.energy_j for c in tab])
                    pre = np.stack([
                        np.concatenate([[0.0], np.cumsum(lat)]),
                        np.concatenate([[0.0], np.cumsum(en)])])
                    cache[key] = (tab, pre)
                self._tables[key] = tab
                self._prefix[key] = pre

    # -- O(1) segment cost via prefix sums -----------------------------------
    def _segment_cost(self, arch_name: str, a: int, b: int) -> Tuple[float, float]:
        """Latency/energy of schedule[a..b] inclusive; zero when a > b."""
        if a > b:
            return 0.0, 0.0
        pre = self._prefix[arch_name]
        return float(pre[0, b + 1] - pre[0, a]), float(pre[1, b + 1] - pre[1, a])

    def _cut_bytes(self, p: int, bpe: float) -> int:
        key = (p, bpe)
        if key not in self._cut_bytes_cache:
            self._cut_bytes_cache[key] = self.graph.cut_bytes(
                self.schedule, p, bpe)
        return self._cut_bytes_cache[key]

    def _cut_elems_vec(self) -> np.ndarray:
        """Elements crossing the link for every cut position p in [0, L-1)."""
        if self._cut_elems is None:
            self._cut_elems = np.array(
                [self.graph.cut_bytes(self.schedule, p, 1.0)
                 for p in range(len(self.schedule) - 1)], dtype=np.int64)
        return self._cut_elems

    def cut_elements(self) -> np.ndarray:
        """Public view of the per-position link element counts (length
        L-1), used by the candidate filters' feasibility matrices."""
        return self._cut_elems_vec()

    def torch_tables(self, device):
        """All precomputed tables as tensors on ``device`` (cached per
        device).

        Returns the :class:`repro_torch.core.partition_torch.EvalTables`
        feeding the tensor ``evaluate_batch`` fast-path used by
        ``TorchNSGA2Search`` — per-arch prefix sums, link/memory tables and
        (when the accuracy oracle is a proxy) the accuracy weight prefix.
        Import is lazy so NumPy-only callers never pay for torch.
        """
        from repro_torch.core.partition_torch import build_eval_tables
        key = str(device)
        if key not in self._torch_tables:
            self._torch_tables[key] = build_eval_tables(self, device)
        return self._torch_tables[key]

    def evaluate(self, cuts: Sequence[int],
                 constraints: Optional[Constraints] = None) -> PartitionEval:
        """Score one sorted cut vector: per-stage latency/energy/memory,
        link costs, Def.-2/3 feasibility, and the composite objectives."""
        L = len(self.schedule)
        cuts = tuple(max(int(c), -1) for c in cuts)
        assert list(cuts) == sorted(cuts), f"cuts must be sorted: {cuts}"
        assert len(cuts) == self.system.n_cuts
        bounds = [-1] + list(cuts) + [L - 1]
        plats = self.system.platforms

        stage_lat: List[float] = []
        energy = 0.0
        for k, plat in enumerate(plats):
            a, b = bounds[k] + 1, bounds[k + 1]
            lat, en = self._segment_cost(plat.arch.name, a, b)
            stage_lat.append(lat)
            energy += en

        link_lat: List[float] = []
        link_bytes_all: List[int] = []
        for k, link in enumerate(self.system.links):
            p = cuts[k]
            sent = bounds[k + 1] > bounds[k]       # producer side ran something
            remaining = bounds[-1] > bounds[k + 1]  # anything left downstream
            if p < 0 or p >= L - 1 or not (sent and remaining):
                link_lat.append(0.0)
                link_bytes_all.append(0)
                continue
            nbytes = self._cut_bytes(p, plats[k].quant.bits / 8.0) * self.batch
            link_lat.append(link.latency_s(nbytes))
            energy += link.energy_j(nbytes)
            link_bytes_all.append(nbytes)

        latency = sum(stage_lat) + sum(link_lat)
        # Def. 4: asynchronous pipeline — slowest active module bounds rate
        active = [t for t in stage_lat if t > 0] + [t for t in link_lat if t > 0]
        throughput = 1.0 / max(active) if active else 0.0

        mems = []
        for k, plat in enumerate(plats):
            seg = self.schedule[bounds[k] + 1: bounds[k + 1] + 1]
            mems.append(segment_memory(seg, plat.memory_model,
                                       self.shared_groups, self.batch))
        acc = float(self.accuracy_fn(cuts))
        ev = PartitionEval(cuts=cuts, latency_s=latency, energy_j=energy,
                           throughput=throughput,
                           link_bytes=max(link_bytes_all) if link_bytes_all else 0,
                           memory_bytes=tuple(mems), accuracy=acc,
                           stage_latency_s=tuple(stage_lat),
                           link_latency_s=tuple(link_lat))
        ev.violation = self._violation(ev, constraints)
        return ev

    def evaluate_batch(self, cuts: np.ndarray,
                       constraints: Optional[Constraints] = None) -> BatchEval:
        """Vectorized :meth:`evaluate` over an (N, n_cuts) matrix of sorted
        cut vectors — the NSGA-II hot path (one call per generation).

        Stage latency/energy come from the per-arch prefix-sum tables via
        gathers, link bytes from the precomputed per-position element counts,
        memory from :class:`SegmentMemoryTable`, accuracy from the accuracy
        oracle's ``evaluate_batch`` when it has one.  Matches the scalar path
        metric-for-metric (tested) up to float summation order.
        """
        C = np.maximum(np.asarray(cuts, dtype=np.int64), -1)
        if C.ndim != 2:
            raise ValueError(f"cuts matrix must be 2-D, got shape {C.shape}")
        L = len(self.schedule)
        assert C.shape[1] == self.system.n_cuts
        assert np.all(C < L), "cut positions must be < len(schedule)"
        assert np.all(np.diff(C, axis=1) >= 0), "cut rows must be sorted"
        n = C.shape[0]
        plats = self.system.platforms
        bounds = np.concatenate(
            [np.full((n, 1), -1, dtype=np.int64), C,
             np.full((n, 1), L - 1, dtype=np.int64)], axis=1)

        stage_lat = np.empty((n, len(plats)))
        energy = np.zeros(n)
        for k, plat in enumerate(plats):
            pre = self._prefix[plat.arch.name]
            a, b1 = bounds[:, k] + 1, bounds[:, k + 1] + 1
            stage_lat[:, k] = pre[0, b1] - pre[0, a]
            energy += pre[1, b1] - pre[1, a]

        n_links = len(self.system.links)
        link_lat = np.zeros((n, n_links))
        link_bytes = np.zeros((n, n_links), dtype=np.int64)
        elems = self._cut_elems_vec()
        for k, link in enumerate(self.system.links):
            p = C[:, k]
            sent = bounds[:, k + 1] > bounds[:, k]
            remaining = bounds[:, -1] > bounds[:, k + 1]
            active = (p >= 0) & (p < L - 1) & sent & remaining
            bpe = plats[k].quant.bits / 8.0
            raw = (np.ceil(elems[np.clip(p, 0, L - 2)] * bpe)
                   .astype(np.int64) * self.batch if len(elems)
                   else np.zeros(n, dtype=np.int64))
            nbytes = np.where(active, raw, 0)
            link_lat[:, k] = link.latency_s_vec(nbytes)
            energy += link.energy_j_vec(nbytes)
            link_bytes[:, k] = nbytes

        latency = stage_lat.sum(axis=1) + link_lat.sum(axis=1)
        mods = np.concatenate([stage_lat, link_lat], axis=1)
        slowest = np.max(np.where(mods > 0, mods, 0.0), axis=1)
        throughput = np.divide(1.0, slowest, where=slowest > 0,
                               out=np.zeros(n))

        mems = np.empty((n, len(plats)), dtype=np.int64)
        for k, plat in enumerate(plats):
            mems[:, k] = self._memtable.batched(
                bounds[:, k] + 1, bounds[:, k + 1], plat.memory_model,
                self.batch)

        if hasattr(self.accuracy_fn, "evaluate_batch"):
            acc = np.asarray(self.accuracy_fn.evaluate_batch(C), dtype=float)
        else:
            acc = np.array([float(self.accuracy_fn(tuple(int(c) for c in row)))
                            for row in C])

        max_link = (link_bytes.max(axis=1) if n_links
                    else np.zeros(n, dtype=np.int64))
        be = BatchEval(cuts=C, latency_s=latency, energy_j=energy,
                       throughput=throughput, link_bytes=max_link,
                       memory_bytes=mems, accuracy=acc,
                       stage_latency_s=stage_lat, link_latency_s=link_lat,
                       violation=np.zeros(n))
        be.violation = self._violation_batch(be, constraints)
        return be

    def _violation_batch(self, be: BatchEval,
                         cons: Optional[Constraints]) -> np.ndarray:
        v = np.zeros(len(be))
        for k, plat in enumerate(self.system.platforms):
            cap = plat.capacity
            over = be.memory_bytes[:, k] - cap
            v += np.where(over > 0, over / cap, 0.0)
        if cons is None:
            return v
        if cons.max_link_bytes:
            over = be.link_bytes - cons.max_link_bytes
            v += np.where(over > 0, over / cons.max_link_bytes, 0.0)
        if cons.min_accuracy:
            v += np.maximum(0.0, cons.min_accuracy - be.accuracy)
        if cons.max_latency_s:
            over = be.latency_s - cons.max_latency_s
            v += np.where(over > 0, over / cons.max_latency_s, 0.0)
        if cons.max_energy_j:
            over = be.energy_j - cons.max_energy_j
            v += np.where(over > 0, over / cons.max_energy_j, 0.0)
        if cons.min_throughput:
            short = cons.min_throughput - be.throughput
            v += np.where(short > 0, short / cons.min_throughput, 0.0)
        return v

    def _violation(self, ev: PartitionEval,
                   cons: Optional[Constraints]) -> float:
        v = 0.0
        for k, plat in enumerate(self.system.platforms):
            cap = plat.capacity
            if ev.memory_bytes[k] > cap:
                v += (ev.memory_bytes[k] - cap) / cap
        if cons is None:
            return v
        if cons.max_link_bytes and ev.link_bytes > cons.max_link_bytes:
            v += (ev.link_bytes - cons.max_link_bytes) / cons.max_link_bytes
        if cons.min_accuracy and ev.accuracy < cons.min_accuracy:
            v += cons.min_accuracy - ev.accuracy
        if cons.max_latency_s and ev.latency_s > cons.max_latency_s:
            v += (ev.latency_s - cons.max_latency_s) / cons.max_latency_s
        if cons.max_energy_j and ev.energy_j > cons.max_energy_j:
            v += (ev.energy_j - cons.max_energy_j) / cons.max_energy_j
        if cons.min_throughput and ev.throughput < cons.min_throughput:
            v += (cons.min_throughput - ev.throughput) / cons.min_throughput
        return v


def single_platform_eval(evaluator: PartitionEvaluator, platform_idx: int,
                         constraints: Optional[Constraints] = None
                         ) -> PartitionEval:
    """Run the whole DNN on one platform (the paper's square markers)."""
    L = len(evaluator.schedule)
    n = evaluator.system.n_cuts
    cuts = [(-1 if k < platform_idx else L - 1) for k in range(n)]
    return evaluator.evaluate(cuts, constraints)
