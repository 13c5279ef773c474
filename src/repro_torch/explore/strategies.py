"""Pluggable search strategies (Fig. 1 stages 4–5).

Every strategy consumes the same :class:`SearchContext` — a shared
:class:`~repro_torch.core.partition.PartitionEvaluator`, the filtered candidate
positions, constraints, objectives — and returns a :class:`StrategyOutput`
pool of evaluated placements, so strategies are interchangeable through one
:class:`~repro_torch.explore.spec.ExplorationSpec` and directly comparable in
tests:

* :class:`ExhaustiveSearch` — single-cut scan over the candidates (today's
  default path; exact for two-platform systems).
* :class:`MultiCutScan`    — exhaustive enumeration of every sorted k-cut
  vector over the candidate table, chunked through ``evaluate_batch`` with
  a streaming non-dominated archive.  Exact ground truth for small systems
  now that ~1M evals/s are available.
* :class:`NSGA2Search`     — the genetic search of ``repro_torch.core.nsga2``
  with population/generation defaults scaled to the schedule depth and cut
  count (not the old scalar-loop constants).
* :class:`TorchNSGA2Search` — the same search with the whole generation
  loop (ranking, crowding, tournaments, variation, repair, batched metric
  evaluation over the precomputed cost tables) as tensor code on the
  search device (``repro_torch.core.nsga2_torch``), ranking through the
  hand-written CUDA Pareto kernels, for the 10k+-individual populations
  the NumPy path cannot reach.

Register additional strategies with :func:`register_strategy`.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
import warnings
from typing import Dict, List, Optional, Protocol, Tuple, Type, runtime_checkable

import numpy as np

from repro_torch.core.nsga2 import (NSGA2Result, dominates_matrix,
                              non_dominated_mask, nsga2, pareto_indices)
from repro_torch.core.partition import (Constraints, PartitionEval,
                                  PartitionEvaluator)
from repro_torch.explore.filters import feasible_cut_rows
from repro_torch.explore.spec import SearchSettings
from repro_torch.obs.handle import Obs
from repro_torch.obs.metrics import default_registry

# full per-point scans are kept (for Fig.-2-style plots) only below this size
_ALL_EVALS_CAP = 16384


@dataclasses.dataclass
class SearchContext:
    """Everything a strategy needs; shared across strategies of one run."""

    evaluator: PartitionEvaluator
    candidates: List[int]
    constraints: Constraints
    objectives: Tuple[str, ...]
    settings: SearchSettings
    link_feas: Optional[np.ndarray] = None   # (n_links, L-1) or None
    warm_cuts: Optional[np.ndarray] = None   # (n, n_cuts) previous front
    device: str = "cuda"                     # where tensor strategies run
    obs: Obs = dataclasses.field(default_factory=Obs.off)  # spans, reads

    @property
    def n_cuts(self) -> int:
        """Number of cut genes (= platforms - 1) for this system."""
        return self.evaluator.system.n_cuts

    @property
    def depth(self) -> int:
        """Schedule length L (cut positions live in [-1, L-1])."""
        return len(self.evaluator.schedule)


@dataclasses.dataclass
class StrategyOutput:
    """What one strategy hands back to :func:`~repro_torch.explore.runner
    .run_search`: its candidate pool plus bookkeeping."""

    evals: List[PartitionEval]
    all_evals: List[PartitionEval] = dataclasses.field(default_factory=list)
    nsga: Optional[NSGA2Result] = None
    exhaustive: bool = False   # exact scans precede baselines in the pool
    n_evaluated: int = 0       # candidate vectors actually scored
    strategy_used: str = ""    # actual strategy name when != the requested
    #                            one (e.g. torch_nsga2's NumPy fallback)


@runtime_checkable
class SearchStrategy(Protocol):
    """The strategy protocol: a name and one ``search`` method."""

    name: str

    def search(self, ctx: SearchContext) -> StrategyOutput:
        """Produce candidate cut vectors for the runner to score."""
        ...


def scaled_nsga_defaults(n_candidates: int, n_cuts: int,
                         depth: int) -> Tuple[int, int]:
    """Population/generation defaults sized for the batched evaluator.

    The paper sizes the GA by layer count; with ``evaluate_batch`` scoring
    ~1M candidates/s a generation costs one vectorized call, so defaults
    scale with the gene space (candidates × cuts) and the schedule depth
    instead of the old fixed small constants.
    """
    span = n_candidates + 2                  # + the -1 / L-1 sentinels
    pop = int(np.clip(8.0 * np.sqrt(span * max(n_cuts, 1)), 64, 512))
    pop = max(pop // 4 * 4, 16)
    n_gen = int(np.clip(depth // 2, 24, 120))
    return pop, n_gen


def _gene_table(ctx: SearchContext) -> np.ndarray:
    """Gene values: [skip-sentinel -1] + candidates + [end-sentinel L-1]."""
    return np.array([-1] + list(ctx.candidates) + [ctx.depth - 1], dtype=int)


class ExhaustiveSearch:
    """Single-cut scan: every candidate as the first (only) cut, remaining
    platforms idle.  For two-platform systems this is the exact Fig.-2 scan
    and matches the legacy ``Explorer.run`` point set bit-for-bit."""

    name = "exhaustive"

    def search(self, ctx: SearchContext) -> StrategyOutput:
        """Enumerate every single-cut placement (Fig.-2 scan)."""
        if not ctx.candidates:
            return StrategyOutput([], exhaustive=True)
        C = np.full((len(ctx.candidates), ctx.n_cuts), ctx.depth - 1,
                    dtype=int)
        C[:, 0] = ctx.candidates
        evals = ctx.evaluator.evaluate_batch(C, ctx.constraints).to_evals()
        return StrategyOutput(evals, all_evals=evals, exhaustive=True,
                              n_evaluated=len(evals))


class MultiCutScan:
    """Exhaustive k-cut enumeration over the candidate table.

    Enumerates every sorted cut vector (with the skip/end sentinels, so
    fewer-partition schedules are included — the Table-II effect), prunes
    rows whose active cuts fail the per-(link, position) feasibility matrix
    exactly, and streams chunks through ``evaluate_batch`` while keeping a
    running constrained non-dominated archive — memory stays bounded even
    for hundreds of thousands of combinations.
    """

    name = "multicut"

    def search(self, ctx: SearchContext) -> StrategyOutput:
        """Enumerate all sorted cut combinations when the combinatorial
        budget allows (exact small-system solver)."""
        if not ctx.candidates:
            return StrategyOutput([], exhaustive=True)
        table = _gene_table(ctx)
        k = ctx.n_cuts
        n_combos = math.comb(len(table) + k - 1, k)
        if n_combos > ctx.settings.max_scan:
            raise ValueError(
                f"MultiCutScan: {n_combos} cut vectors exceed "
                f"max_scan={ctx.settings.max_scan}; use the 'nsga2' "
                f"strategy for this system or raise SearchSettings.max_scan")
        keep_all = n_combos <= _ALL_EVALS_CAP
        all_evals: List[PartitionEval] = []
        front_evals: List[PartitionEval] = []
        front_F = front_CV = None
        n_evaluated = 0
        chunk = max(int(ctx.settings.scan_chunk), 1)
        combos = itertools.combinations_with_replacement(table.tolist(), k)
        while True:
            block = list(itertools.islice(combos, chunk))
            if not block:
                break
            C = np.asarray(block, dtype=np.int64)
            C = C[feasible_cut_rows(C, ctx.evaluator, ctx.link_feas)]
            if not len(C):
                continue
            be = ctx.evaluator.evaluate_batch(C, ctx.constraints)
            n_evaluated += len(be)
            if keep_all:
                all_evals.extend(be.to_evals())
            F = be.as_objectives(ctx.objectives)
            CV = be.violation
            if front_F is not None:
                # cheap pre-filter: drop rows the archive already dominates
                # (|archive| × chunk) before the quadratic in-chunk mask
                dom = dominates_matrix(front_F, front_CV, F, CV)
                alive = np.flatnonzero(~dom.any(axis=0))
                if not len(alive):
                    continue
                F2 = np.concatenate([front_F, F[alive]])
                CV2 = np.concatenate([front_CV, CV[alive]])
            else:
                alive = np.arange(len(F))
                F2, CV2 = F, CV
            n_arch = len(front_evals)
            fr = np.flatnonzero(non_dominated_mask(F2, CV2))
            front_evals = [front_evals[j] if j < n_arch
                           else be.row(alive[j - n_arch]) for j in fr]
            front_F, front_CV = F2[fr], CV2[fr]
        # all_evals stays empty above the cap: only a full scan may pose as
        # "every point" (n_evaluated records the true coverage either way)
        return StrategyOutput(front_evals, all_evals=all_evals,
                              exhaustive=True, n_evaluated=n_evaluated)


def _gene_seeds(cands: List[int], table: np.ndarray,
                n_cuts: int) -> List[List[int]]:
    """Single-cut seed individuals spread over the candidate table."""
    seeds = []
    for p in cands[:: max(1, len(cands) // 16)]:
        i = 1 + cands.index(p)
        seeds.append([i] + [len(table) - 1] * (n_cuts - 1))
    return seeds


def _rank_devices(rank_devices: Optional[int]) -> None:
    """The ranking runs on the search device alone: a request for more
    devices is clamped to one with a warning, so a spec written for a
    multi-device host still runs."""
    if rank_devices and rank_devices > 1:
        warnings.warn(
            f"torch_nsga2: rank_devices={rank_devices} but the ranking runs "
            f"on one device; using 1", stacklevel=3)


def _pop_gen(ctx: SearchContext) -> Tuple[int, int]:
    """Population/generation budget: explicit settings, else scaled."""
    pop, n_gen = ctx.settings.pop_size, ctx.settings.n_gen
    if pop is None or n_gen is None:
        dpop, dgen = scaled_nsga_defaults(len(ctx.candidates), ctx.n_cuts,
                                          ctx.depth)
        pop, n_gen = pop or dpop, n_gen or dgen
    return pop, n_gen


def _cuts_to_genes(cuts: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Map cut-position rows onto nearest gene-table indices.

    A drifted system keeps the same gene table (the online path pins the
    candidate list), but warm cuts may in general fall between entries —
    each cut snaps to the index of the nearest table value.
    """
    cuts = np.asarray(cuts, dtype=int)
    idx = np.clip(np.searchsorted(table, cuts), 0, len(table) - 1)
    left = np.maximum(idx - 1, 0)
    use_left = (np.abs(table[left] - cuts) <= np.abs(table[idx] - cuts))
    return np.where(use_left, left, idx)


def _warm_genes(ctx: SearchContext, table: np.ndarray) -> Optional[np.ndarray]:
    """Previous-front cut rows as gene rows, or None when warm starting is
    disabled/unavailable."""
    if not ctx.settings.warm_start or ctx.warm_cuts is None:
        return None
    warm = np.asarray(ctx.warm_cuts, dtype=int).reshape(-1, ctx.n_cuts)
    if not len(warm):
        return None
    return _cuts_to_genes(warm, table)


class NSGA2Search:
    """NSGA-II over gene indices into the candidate table (§IV)."""

    name = "nsga2"

    def search(self, ctx: SearchContext) -> StrategyOutput:
        """NumPy NSGA-II over gene indices; honors ``ctx.warm_cuts`` as
        seed individuals."""
        cands = ctx.candidates
        if not cands:
            return StrategyOutput([])
        evaluator = ctx.evaluator
        table = _gene_table(ctx)
        n_cuts = ctx.n_cuts

        def _decode(G: np.ndarray) -> np.ndarray:
            return np.sort(table[G], axis=1)

        def _eval(G: np.ndarray):
            # one vectorized call per generation — the NSGA-II hot path
            be = evaluator.evaluate_batch(_decode(G), ctx.constraints)
            return be.as_objectives(ctx.objectives), be.violation

        pop, n_gen = _pop_gen(ctx)
        seeds = _gene_seeds(cands, table, n_cuts)
        warm = _warm_genes(ctx, table)
        if warm is not None:
            # previous-front rows join the seed pool (nsga2 injects up to
            # pop//2 seed individuals into the initial population)
            seeds = [list(r) for r in warm] + seeds
        res = nsga2(_eval, n_var=n_cuts, lower=0, upper=len(table) - 1,
                    seed=ctx.settings.seed, candidates=seeds,
                    pop_size=pop, n_gen=n_gen)
        evals: List[PartitionEval] = []
        if len(res.pareto_X):
            evals = evaluator.evaluate_batch(
                _decode(res.pareto_X), ctx.constraints).to_evals()
        return StrategyOutput(evals, nsga=res,
                              n_evaluated=pop * (n_gen + 1),
                              strategy_used=self.name)


class TorchNSGA2Search:
    """NSGA-II with the whole generation loop as tensor code on a device.

    The evaluator's prefix-sum cost/memory/link tables are exported once as
    tensors on the search device (:meth:`PartitionEvaluator.torch_tables`),
    the gene decode (indices into the candidate table → sorted cut vectors)
    happens on the device, and selection/variation run as the fixed-shape
    operator twins of ``repro_torch.core.nsga2_torch`` — so 10k+-individual
    populations are scored and ranked on the device.

    The final front is re-scored through the exact NumPy
    ``evaluate_batch``, so reported metrics carry no float32 drift.  When
    accuracy is searched (objective or ``min_accuracy``) but the evaluator's
    oracle is not a tensor proxy (no ``proxy_arrays``), falls back to
    :class:`NSGA2Search` with a warning rather than silently dropping the
    accuracy term.

    Scaling knobs from :class:`~repro_torch.explore.spec.SearchSettings`:
    ``rank_block``/``rank_impl`` select the tiled Pareto-ranking primitive
    (``repro_torch.kernels.pareto_rank``) that keeps 10k–100k+ populations
    inside O(pop · rank_block) working memory, ``n_restarts`` runs that many
    independently seeded searches and merges their fronts, and
    ``rank_devices`` > 1 is clamped to the one search device.

    Each search records, in :func:`repro_torch.obs.metrics.default_registry`,
    its wall (histogram ``search_wall_s``, from the evaluation set-up until
    X/F/CV are on the host) and, when it is seeded from a previous front, one
    ``search_warm_starts``.  The reference's compiled-runner counters
    (``search_jit_runner_cache_hits``/``_misses``) and its compile time
    (``search_jit_compile_s``) have no counterpart: nothing is compiled here.

    With ``ctx.obs`` on, it records on the ``search`` track
    ``search.tables`` (the gene table and ``torch_tables``, up to where
    ``search_wall_s`` starts), ``search.run`` (on ``search_wall_s``'s two
    clock reads: the loop's spans lie inside it) and ``search.final_front``
    (the final front's mask and its exact re-scoring), and passes the
    handle to the loop and to ``pareto_indices_blocked``.
    """

    name = "torch_nsga2"

    # above this population the final front mask comes from the tiled
    # dominator-count kernel instead of the dense host-side sort
    _DENSE_PARETO_MAX = 8192

    def search(self, ctx: SearchContext) -> StrategyOutput:
        """Tensor NSGA-II on ``ctx.device``: gene table + EvalTables as
        arguments of the evaluation, warm start from ``ctx.warm_cuts``;
        falls back to the NumPy path for measured accuracy oracles
        (reported via ``strategy_used``)."""
        cands = ctx.candidates
        if not cands:
            return StrategyOutput([])
        evaluator = ctx.evaluator
        settings = ctx.settings
        needs_acc = ("accuracy" in ctx.objectives
                     or bool(ctx.constraints.min_accuracy))
        if needs_acc and not hasattr(evaluator.accuracy_fn, "proxy_arrays"):
            warnings.warn(
                "torch_nsga2: accuracy objective/constraint with a non-proxy "
                "accuracy oracle cannot run on the device; falling back to "
                "the NumPy 'nsga2' strategy", stacklevel=2)
            return NSGA2Search().search(ctx)

        import torch

        from repro_torch.core.nsga2_torch import (TRACK,
                                                  pareto_indices_blocked,
                                                  torch_nsga2,
                                                  torch_nsga2_restarts,
                                                  warm_population)
        from repro_torch.core.partition_torch import make_runtime_eval_fn

        obs = ctx.obs
        if obs.enabled:
            t_tables = time.perf_counter()
        table = _gene_table(ctx)
        n_cuts = ctx.n_cuts
        pop, n_gen = _pop_gen(ctx)
        n_restarts = settings.n_restarts
        _rank_devices(settings.rank_devices)
        tables = evaluator.torch_tables(ctx.device)
        reg = default_registry()
        t_search = time.perf_counter()
        if obs.enabled:
            obs.tracer.complete("search.tables", track=TRACK, start=t_tables,
                                end=t_search)
        eval_cuts = make_runtime_eval_fn(tables, ctx.objectives,
                                         ctx.constraints)

        def _eval_genes(G, gene_table, t):
            return eval_cuts(torch.sort(gene_table[G], dim=1).values, t)

        knobs = dict(
            n_var=n_cuts, lower=0, upper=len(table) - 1, pop_size=pop,
            n_gen=n_gen, candidates=_gene_seeds(cands, table, n_cuts),
            eval_args=(torch.as_tensor(table, dtype=torch.int64,
                                       device=ctx.device), tables),
            rank_block=settings.rank_block, rank_impl=settings.rank_impl,
            device=ctx.device, obs=obs)
        warm = _warm_genes(ctx, table)
        if warm is not None:
            reg.counter("search_warm_starts").inc()
        if n_restarts > 1:
            X0s = None
            if warm is not None:
                X0s = np.stack([
                    warm_population(
                        np.random.default_rng(settings.seed + i), pop,
                        n_cuts, 0, len(table) - 1, warm)
                    for i in range(n_restarts)])
            X, F, CV = torch_nsga2_restarts(
                _eval_genes, n_restarts=n_restarts, seed=settings.seed,
                X0s=X0s, **knobs)
        else:
            X0 = None
            if warm is not None:
                X0 = warm_population(np.random.default_rng(settings.seed),
                                     pop, n_cuts, 0, len(table) - 1, warm)
            X, F, CV = torch_nsga2(_eval_genes, seed=settings.seed, X0=X0,
                                   **knobs)
        t_end = time.perf_counter()
        reg.histogram("search_wall_s").observe(t_end - t_search)
        if obs.enabled:
            obs.tracer.complete("search.run", track=TRACK, start=t_search,
                                end=t_end)
        if len(X) > self._DENSE_PARETO_MAX:
            p_idx = pareto_indices_blocked(X, F, CV,
                                           block=settings.rank_block or 2048,
                                           impl=settings.rank_impl,
                                           device=ctx.device, obs=obs)
        else:
            p_idx = pareto_indices(X, F, CV)
        res = NSGA2Result(X=X, F=F, CV=CV, pareto_idx=p_idx, history=[])
        evals: List[PartitionEval] = []
        if len(res.pareto_X):
            evals = evaluator.evaluate_batch(
                np.sort(table[res.pareto_X], axis=1),
                ctx.constraints).to_evals()
        if obs.enabled:
            obs.tracer.complete("search.final_front", track=TRACK,
                                start=t_end, end=time.perf_counter())
        return StrategyOutput(evals, nsga=res,
                              n_evaluated=n_restarts * pop * (n_gen + 1),
                              strategy_used=self.name)


STRATEGIES: Dict[str, Type] = {
    "exhaustive": ExhaustiveSearch,
    "multicut": MultiCutScan,
    "nsga2": NSGA2Search,
    "torch_nsga2": TorchNSGA2Search,
}


def register_strategy(name: str, cls: Type, override: bool = False) -> None:
    """Register a custom :class:`SearchStrategy` implementation.

    Name collisions raise unless ``override=True`` — re-registering an
    existing name silently would reroute every spec that selects it.
    """
    if name in STRATEGIES and not override:
        raise ValueError(
            f"strategy {name!r} is already registered "
            f"({STRATEGIES[name].__qualname__}); pass override=True to "
            f"replace it")
    STRATEGIES[name] = cls


def resolve_strategies(settings: SearchSettings, n_cuts: int,
                       n_candidates: int) -> List[SearchStrategy]:
    """Map a strategy name to concrete instances.

    ``auto`` reproduces the legacy policy: exhaustive scan for single-cut
    systems, plus NSGA-II when ``n_cuts > 1`` or the candidate list is
    large (``settings.use_nsga`` overrides).
    """
    if settings.strategy == "auto":
        out: List[SearchStrategy] = []
        if n_cuts == 1:
            out.append(ExhaustiveSearch())
        use = settings.use_nsga
        if use is None:
            use = n_cuts > 1 or n_candidates > 64
        if use:
            out.append(NSGA2Search())
        return out
    try:
        return [STRATEGIES[settings.strategy]()]
    except KeyError:
        raise ValueError(f"unknown strategy {settings.strategy!r}; "
                         f"have {['auto'] + sorted(STRATEGIES)}")
