"""Back-to-back partition searches: ``explore/runner.py::run_spec`` with
``torch_nsga2`` on the card (a closed loop, one search at a time).

Each search takes its own seed, derived from the run's.  The window ends
with the first search that finishes after ``--seconds``; the rate is the
cut vectors evaluated, population x (generations + 1) a search, over the
whole window.  The two Pareto kernels' wrappers are wrapped so that the
inputs and output of the last launch stay referenced for the check, and,
in the traced search, every launch's inputs for the work counts.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from bench.lib import seeds
from bench.lib.harness import Check


def _spec(config: dict, traffic: dict, seed: int):
    from repro_torch.explore import (ExplorationSpec, ModelRef, PlatformSpec,
                                     SearchSettings, SystemSpec)
    m = config["model"]
    return ExplorationSpec(
        model=ModelRef("cnn", m["name"], {"in_hw": config["image_size"],
                                          "w": config.get("width", 1.0),
                                          "n_classes": config["num_classes"]}),
        system=SystemSpec(
            platforms=tuple(PlatformSpec(p["name"], p["arch"], bits=p["bits"])
                            for p in config["platforms"]),
            links=tuple(config["links"])),
        objectives=tuple(config["objectives"]),
        schedule_policy=config["schedule_policy"],
        search=SearchSettings(strategy="torch_nsga2",
                              pop_size=traffic["pop_size"],
                              n_gen=traffic["n_gen"],
                              rank_block=traffic.get("rank_block"),
                              seed=seed))


def search_seed(seed: int, i: int) -> int:
    """The seed of the run's ``i``-th search (-1: the warm-up's)."""
    return seeds.derive(seed, 7, i + 1)


class Keeper:
    """Wraps the domination primitives where ``ops`` calls them: the
    CUDA wrappers on a card, their plain versions on the CPU."""

    def __init__(self, device):
        from repro_torch.kernels import pareto_rank, ref
        self.mod = pareto_rank if device.type == "cuda" else ref
        self.orig = (self.mod.packed_domination, self.mod.domination_counts)
        self.last = None          # (f_rows, cv_rows, f_cols, cv_cols, words)
        self.log = None           # [(kind, tensors)] while tracing
        keeper = self

        def packed_domination(f_rows, cv_rows, f_cols, cv_cols, *a, **k):
            out = keeper.orig[0](f_rows, cv_rows, f_cols, cv_cols, *a, **k)
            keeper.last = (f_rows, cv_rows, f_cols, cv_cols, out)
            if keeper.log is not None:
                keeper.log.append(("K1", f_rows, cv_rows, f_cols, cv_cols))
            return out

        def domination_counts(F, CV, alive, *a, **k):
            out = keeper.orig[1](F, CV, alive, *a, **k)
            if keeper.log is not None:
                keeper.log.append(("K2", F, CV, F, CV))
            return out

        # the wrappers count their launches in an attribute of the name
        # they are called by
        packed_domination.launches = domination_counts.launches = 0
        self.mod.packed_domination = packed_domination
        self.mod.domination_counts = domination_counts

    def restore(self):
        self.mod.packed_domination, self.mod.domination_counts = self.orig


@dataclasses.dataclass
class State:
    spec: object
    keeper: Keeper
    result: object = None


def setup(run):
    from repro_torch.explore import run_spec
    traffic = run.cell["traffic"]
    spec = _spec(run.config, traffic, search_seed(run.seed, -1))
    keeper = Keeper(run.device)
    run_spec(spec, device=str(run.device))        # warm-up: same shapes
    return State(spec, keeper)


def window(state: State, run) -> dict:
    from repro_torch.explore import run_spec
    traffic = run.cell["traffic"]
    per_search = traffic["pop_size"] * (traffic["n_gen"] + 1)
    t0 = time.perf_counter()
    n = 0
    launches = []
    while True:
        spec = dataclasses.replace(state.spec, search=dataclasses.replace(
            state.spec.search, seed=search_seed(run.seed, n)))
        traced = run.trace and n == 0
        if traced:
            state.keeper.log = []
            run.tracer.begin()
        res = run_spec(spec, device=str(run.device))
        if traced:
            run.tracer.end()
            launches, state.keeper.log = state.keeper.log, None
        state.result = res
        n += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    elapsed = time.perf_counter() - t0
    return {"attempted": n, "failed": 0,
            "e2e": {"search_evals_per_s": per_search * n / elapsed},
            "traced_searches": 1 if run.trace else 0,
            "work": [_work(*launch) for launch in launches]}


def _work(kind, f_rows, cv_rows, f_cols, cv_cols):
    """(kind, operations, bytes) of one launch, from its inputs."""
    from bench.lib import work
    r, m = f_rows.shape
    n = f_cols.shape[0]
    fr, fc = int((cv_rows <= 0).sum()), int((cv_cols <= 0).sum())
    ops = work.domination_ops(m, fr, r, fc, n)
    nbytes = (work.packed_domination_bytes(r, n, m) if kind == "K1"
              else work.domination_counts_bytes(n, m))
    return kind, ops, nbytes


def _chain(config: dict):
    """The plain cost model's chain for the configuration."""
    from bench.reference.costmodel.cnn_graph import effnet_b0_graph
    from bench.reference.costmodel.evaluate import build_chain
    graph, _ = effnet_b0_graph(config["image_size"], config.get("width", 1.0),
                               config["num_classes"],
                               [tuple(s) for s in config["stages"]])
    return build_chain(graph, config["platforms"], config["links"],
                       config["schedule_policy"])


SIGN = {"latency": ("latency_s", 1), "energy": ("energy_j", 1),
        "throughput": ("throughput", -1)}


def front_rel_gap(chain, front) -> float:
    """Largest relative gap of the front's values (objectives, link bytes,
    memory, violation) against the plain cost model, summed layer by
    layer in float64."""
    from bench.reference.costmodel.evaluate import evaluate
    gap = 0.0
    for p in front:
        ref = evaluate(chain, p.cuts, np.float64)
        pairs = [(p.latency_s, ref["latency_s"]), (p.energy_j, ref["energy_j"]),
                 (p.throughput, ref["throughput"]),
                 (p.link_bytes, ref["link_bytes"])]
        pairs += list(zip(p.memory_bytes, ref["memory_bytes"]))
        for got, want in pairs:
            gap = max(gap, abs(got - want) / max(abs(want), 1e-300))
        gap = max(gap, abs(p.violation - ref["violation"]))
    return gap


def population_front_diff(chain, config: dict, res, tol: float,
                          device) -> int:
    """The returned front against the first front of the final population
    and the single-platform baselines, every one of which the plain cost
    model scores again: the genes decoded by the plain candidate table,
    values within the relative ``tol`` read as equal, since the search
    ranks its population on float32 objectives."""
    from bench.reference import pareto
    from bench.reference.costmodel.evaluate import candidates, evaluate_many
    L = len(chain.schedule)
    table = np.array([-1] + candidates(chain) + [L - 1])
    X = np.asarray(res.nsga.X)
    if X.size and X.max() >= len(table):
        return len(X)                      # genes the plain table lacks
    alone = [[-1] * k + [L - 1] * (X.shape[1] - k)     # each platform alone
             for k in range(X.shape[1] + 1)]
    C = np.unique(np.concatenate([np.sort(table[X], axis=1), alone]), axis=0)
    ref = evaluate_many(chain, C)
    F = np.stack([k * ref[key] for key, k in
                  (SIGN[o] for o in config["objectives"])], axis=1)
    front = {tuple(int(c) for c in p.cuts) for p in res.pareto}
    return pareto.front_diff(C, F, ref["violation"], front, tol, device)


def check(state: State, run, out, control: bool = False) -> list:
    """The front's values against the float64 cost model, the front
    against the final population's plain front, and K1's last launch
    against the plain domination test.  ``control``: the float32 cost
    model's values in the program's place."""
    from bench.reference import pareto
    from bench.reference.costmodel.evaluate import evaluate
    limits = run.cell["limits"]
    res, last = state.result, state.keeper.last
    state.keeper.restore()
    chain = _chain(run.config)
    front = res.pareto
    if control:
        front = []
        for p in res.pareto:
            r = evaluate(chain, p.cuts, np.float32)
            front.append(dataclasses.replace(
                p, latency_s=r["latency_s"], energy_j=r["energy_j"],
                throughput=r["throughput"], link_bytes=r["link_bytes"],
                memory_bytes=tuple(r["memory_bytes"]),
                violation=r["violation"]))
    # K1 does the ranking at this population: a run in which no launch
    # was seen has lost its check, and fails it
    bad = (float("inf") if last is None
           else pareto.packed_bits_mismatch(last[4], *last[:4]))
    return [Check("front_rel_gap", front_rel_gap(chain, front),
                  limits["front_rel_gap"]),
            Check("final_front_diff", population_front_diff(
                chain, run.config, res, run.cell["ranking_rel_tol"],
                run.device), limits["final_front_diff"]),
            Check("k1_bits_diff", bad, limits["k1_bits_diff"])]
