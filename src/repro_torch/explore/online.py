"""Online re-partitioning under live system drift.

The paper's deployment scenarios (automotive, robotics) have links that
degrade and nodes that drop out mid-mission.  :class:`OnlineRepartitioner`
turns the search into a service that re-partitions each drifted system
from what the previous one left behind, by exploiting three invariants of
drift:

1. **Shapes are static.**  Link degradation changes ``rate_bps`` values and
   node dropout shrinks a ``mem_capacity`` — neither changes any table
   shape, so the evaluation tables of every drifted system keep the
   baseline's :meth:`EvalTables.shape_signature()
   <repro_torch.core.partition_torch.EvalTables.shape_signature>` and go
   through the same evaluation function
   (:func:`repro_torch.core.partition_torch.make_runtime_eval_fn`) as
   tensor arguments.  The graph, the schedule, the Def.-3 memory table and
   the per-arch cost cache are built once, for the baseline, and shared by
   every update.
2. **The candidate list is pinned** to the baseline system's filtered cut
   positions, keeping the gene table identical across drifted systems;
   feasibility shifts are absorbed by Deb constraint domination inside the
   search, exactly how the paper's NSGA-II handles infeasible rows.
3. **Optima move slowly.**  Each re-search warm-starts from the previous
   Pareto front (:func:`repro_torch.core.nsga2_torch.warm_population`), so a
   small generation budget re-converges.

The search runs ``torch_nsga2`` on ``device`` (default ``"cuda"``), ranking
through the CUDA Pareto kernels there.  Nothing is compiled, so the first
update differs from the later ones only by the process's first use of the
device and by its cold start.

Perturbation helpers (:func:`degrade_link`, :func:`drop_node`) produce
same-shape :class:`~repro_torch.explore.spec.SystemSpec` variants; a
decision's :meth:`RepartitionDecision.block_cuts` maps its cut vector to the
block cuts of a partitioned LM runner (see ``launch/drift.py`` for the
scripted mission).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.accuracy import ProxyAccuracy
from repro_torch.core.graph import linearize
from repro_torch.core.nsga2 import crowding_distance
from repro_torch.core.partition import PartitionEvaluator, SystemConfig
from repro_torch.explore.deploy import lm_block_cuts
from repro_torch.explore.filters import candidate_positions
from repro_torch.explore.result import ExplorationResult
from repro_torch.explore.runner import resolve_device, run_search
from repro_torch.explore.spec import ExplorationSpec, SearchSettings, SystemSpec
from repro_torch.obs.handle import NOOP_OBS, Obs

SystemLike = Union[SystemSpec, SystemConfig]

# a "dropped" node keeps its table slot (shapes must not change) but gets a
# 1-byte memory capacity: every placement that assigns it layers violates
# Def. 3 maximally, so constraint domination routes the search around it
_DROPPED_CAPACITY = 1


def degrade_link(system: SystemSpec, link: int,
                 factor: float) -> SystemSpec:
    """A same-shape copy of ``system`` with ``links[link]`` slowed down.

    The link's effective ``rate_bps`` (registry base plus any existing
    override) is divided by ``factor`` (> 1 degrades, < 1 upgrades).  Only
    a value changes, so the perturbed spec's tables keep the baseline's
    shape signature.
    """
    if not 0 <= link < len(system.links):
        raise IndexError(f"link {link} out of range "
                         f"(system has {len(system.links)})")
    if factor <= 0:
        raise ValueError(f"factor must be > 0, got {factor}")
    links = list(system.links)
    rate = links[link].build().rate_bps / factor
    links[link] = dataclasses.replace(links[link], rate_bps=rate)
    return dataclasses.replace(
        system, links=tuple(links),
        name=f"{system.label}~link{link}/{factor:g}")


def drop_node(system: SystemSpec, node: int) -> SystemSpec:
    """A same-shape copy of ``system`` with platform ``node`` marked dead.

    The platform keeps its slot in every table (shapes are sacred) but its
    memory capacity collapses to 1 byte, so any placement routing layers
    onto it is maximally infeasible and the re-search steers every stage
    around the node — the paper's node-dropout scenario with the tables'
    shapes unchanged.
    """
    if not 0 <= node < len(system.platforms):
        raise IndexError(f"node {node} out of range "
                         f"(system has {len(system.platforms)})")
    plats = list(system.platforms)
    plats[node] = dataclasses.replace(plats[node],
                                      mem_capacity=_DROPPED_CAPACITY)
    return dataclasses.replace(
        system, platforms=tuple(plats),
        name=f"{system.label}~drop{node}")


@dataclasses.dataclass
class RepartitionDecision:
    """One re-deployment decision emitted by :class:`OnlineRepartitioner`.

    ``cuts`` is the Def.-2 selected cut vector (``None`` when the front
    came up empty), ``changed`` flags whether deployment must act (the cut
    vector differs from the previous decision's), ``repartition_ms`` is the
    wall-clock of the whole update (evaluator build + warm re-search +
    selection), and ``feasible`` reports whether the selected placement
    satisfies every constraint on the *drifted* system.
    """

    step: int                       # 0-based update counter
    label: str                      # system label at this step
    cuts: Optional[Tuple[int, ...]]
    changed: bool
    repartition_ms: float
    feasible: bool
    pareto_size: int
    strategy_used: str
    result: ExplorationResult = dataclasses.field(repr=False)
    trigger: str = "event"          # 'event' (told) | 'measured' (observed)

    def block_cuts(self, n_layers: int) -> List[int]:
        """Decoder-block cut indices for ``PartitionedLMRunner`` — the
        serve-side form of this decision (falls back to a middle split
        when ``cuts`` is None, so deployment always has a target)."""
        return lm_block_cuts(self.cuts or (), n_layers)


class OnlineRepartitioner:
    """Warm re-partitioning service over a stream of drifted systems.

    Construction resolves the spec's model once (graph, schedule, Def.-3
    memory table, per-arch cost cache are all shared across updates) and
    pins the candidate cut positions from the spec's *baseline* system.
    Each :meth:`update` then builds a cheap evaluator for the drifted
    system, re-searches on ``device`` warm from the previous Pareto front,
    and emits a :class:`RepartitionDecision`.

    The search strategy is forced to ``torch_nsga2`` (the strategy that
    searches on the device and takes a warm population); every other knob
    of ``spec.search`` — or of an explicit ``settings`` override — is
    honored, including ``warm_start=False`` for A/B comparisons.  With the
    default ``device="cuda"`` and no CUDA device, construction raises.
    """

    def __init__(self, spec: ExplorationSpec, *,
                 settings: Optional[SearchSettings] = None,
                 max_warm_front: int = 64,
                 obs: Optional[Obs] = None,
                 device="cuda"):
        self.device = str(resolve_device(device))
        if max_warm_front < 1:
            raise ValueError(
                f"max_warm_front must be >= 1, got {max_warm_front}")
        self.max_warm_front = max_warm_front
        # repartition decisions land on the "health/repartition" track
        self.obs = obs if obs is not None else NOOP_OBS
        self.spec = spec
        settings = settings or spec.search
        if settings.strategy != "torch_nsga2":
            settings = dataclasses.replace(settings, strategy="torch_nsga2")
        self.settings = settings
        graph, shared = spec.model.build()
        self.graph = graph
        self.shared_groups = shared
        self.schedule = linearize(graph, spec.schedule_policy)
        self._cost_cache: dict = {}
        base_eval = self._evaluator(spec.system.build())
        self._memtable = base_eval._memtable
        # pinned gene space: the baseline system's filtered candidates
        self.candidates: List[int] = candidate_positions(
            base_eval, spec.constraints, settings.allow_multi_tensor_cuts)
        self.decisions: List[RepartitionDecision] = []
        self._front_cuts: Optional[np.ndarray] = None
        self._last_cuts: Optional[Tuple[int, ...]] = None

    def _evaluator(self, system: SystemConfig) -> PartitionEvaluator:
        spec = self.spec
        if spec.accuracy is not None:
            acc = spec.accuracy.build(self.graph, self.schedule, system,
                                      self.device)
        else:
            acc = ProxyAccuracy(self.schedule, system)
        return PartitionEvaluator(
            self.graph, self.schedule, system, accuracy_fn=acc,
            batch=spec.batch, shared_groups=self.shared_groups,
            cost_cache=self._cost_cache,
            memtable=getattr(self, "_memtable", None))

    def update(self, system: SystemLike, label: Optional[str] = None,
               trigger: str = "event") -> RepartitionDecision:
        """Re-partition for one (possibly drifted) system snapshot.

        ``system`` may be a declarative :class:`SystemSpec` (typically from
        :func:`degrade_link` / :func:`drop_node`, or a
        ``DivergenceMonitor.drifted_system()`` snapshot — in that case pass
        ``trigger='measured'``) or an already-built :class:`SystemConfig`.
        It should be same-shape with the baseline (same platform/link
        counts), so that its tables keep the baseline's shape signature; a
        different shape still works.
        """
        t0 = time.perf_counter()
        if isinstance(system, SystemSpec):
            label = label or system.label
            system = system.build()
        label = label or f"step{len(self.decisions)}"
        evaluator = self._evaluator(system)
        res = run_search(
            evaluator, constraints=self.spec.constraints,
            objectives=self.spec.objectives, weights=self.spec.weights,
            settings=self.settings, candidates=self.candidates,
            warm_cuts=self._front_cuts, device=self.device)
        ms = (time.perf_counter() - t0) * 1e3
        cuts = res.selected.cuts if res.selected is not None else None
        feasible = res.selected is not None and res.selected.violation <= 0
        decision = RepartitionDecision(
            step=len(self.decisions), label=label, cuts=cuts,
            changed=cuts != self._last_cuts, repartition_ms=ms,
            feasible=feasible, pareto_size=len(res.pareto),
            strategy_used=res.strategy_used, result=res, trigger=trigger)
        self._last_cuts = cuts
        if self.obs.enabled:
            self.obs.tracer.instant(
                "repartition", cat="health", track="health/repartition",
                args={"label": label, "trigger": trigger,
                      "changed": decision.changed,
                      "feasible": feasible, "ms": round(ms, 3)})
            self.obs.metrics.counter("repartition_decisions").inc()
            if decision.changed:
                self.obs.metrics.counter("repartition_changes").inc()
            self.obs.metrics.histogram("repartition_ms").observe(ms)
        if res.pareto:
            front = res.pareto
            if len(front) > self.max_warm_front:
                # bound the carried warm seed: long drift histories must
                # not grow it without limit, and crowding distance keeps
                # the most diversity-preserving top-k of the front
                F = np.asarray([e.as_objectives(self.spec.objectives)
                                for e in front], dtype=float)
                cd = crowding_distance(F)
                keep = sorted(np.argsort(-cd, kind="stable")
                              [:self.max_warm_front])
                front = [front[int(i)] for i in keep]
            self._front_cuts = np.asarray([e.cuts for e in front],
                                          dtype=int)
        self.decisions.append(decision)
        return decision

    def watch(self, systems: Iterable[SystemLike]
              ) -> Iterator[RepartitionDecision]:
        """Drive :meth:`update` over a stream of system snapshots, yielding
        each decision as it is made (generator — lazy, so a live producer
        can feed it)."""
        for system in systems:
            yield self.update(system)
