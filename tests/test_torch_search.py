"""The port's search slice end to end on the CPU: ``torch_nsga2`` against
the JAX package's ``jit_nsga2`` at the Pareto-front level on the
EfficientNet-B0 four-platform setup, the tiled ranking against a dense
oracle inside the strategy, ``rank_block`` inert, merged restarts, exact re-scoring of the front, the
measured-accuracy fallback, the spec plumbing, and the default ``cuda``
device refusing to run without a card."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core.accuracy import ProxyAccuracy as JProxy  # noqa: E402
from repro.core.graph import linearize as jlinearize  # noqa: E402
from repro.core.partition import PartitionEvaluator as JEvaluator  # noqa: E402
from repro.explore import PlatformSpec as JPlatformSpec  # noqa: E402
from repro.explore import ExplorationSpec as JSpec  # noqa: E402
from repro.explore import ModelRef as JModelRef  # noqa: E402
from repro.explore import SearchSettings as JSettings  # noqa: E402
from repro.explore import SystemSpec as JSystemSpec  # noqa: E402
from repro.explore import run_search as jrun_search  # noqa: E402
from repro.models.cnn.zoo import build_cnn as jbuild  # noqa: E402
from repro_torch.core import nsga2_torch as T  # noqa: E402
from repro_torch.core.accuracy import MeasuredAccuracy, ProxyAccuracy  # noqa: E402
from repro_torch.core.graph import linearize  # noqa: E402
from repro_torch.core.partition import PartitionEvaluator  # noqa: E402
from repro_torch.explore import (ExplorationSpec, ModelRef,  # noqa: E402
                                 PlatformSpec, SearchSettings, SweepSpec,
                                 SystemSpec, TorchNSGA2Search, run_search,
                                 run_spec)
from repro_torch.explore.strategies import STRATEGIES  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models.cnn.zoo import build_cnn  # noqa: E402

torch.set_num_threads(2)

PLATS = (("A0", "eyr", 16), ("A1", "eyr", 16), ("B0", "smb", 8),
         ("B1", "smb", 8))
FOUR_PLATFORM = SystemSpec(
    platforms=tuple(PlatformSpec(n, a, bits=b) for n, a, b in PLATS),
    links=("gige", "gige", "gige"))
OBJECTIVES = ("latency", "energy", "throughput")


@pytest.fixture(scope="module")
def evaluator():
    graph = build_cnn("efficientnet_b0", in_hw=64).to_graph()
    system = FOUR_PLATFORM.build()
    schedule = linearize(graph, "min_memory")
    return PartitionEvaluator(graph, schedule, system,
                              accuracy_fn=ProxyAccuracy(schedule, system))


def search(evaluator, **kw):
    settings = SearchSettings(strategy="torch_nsga2", **kw)
    return run_search(evaluator, objectives=OBJECTIVES, settings=settings,
                      device="cpu")


def _no_clear_domination(Fa, Fb, scale, tol=0.02):
    """No point of Fa dominates any point of Fb by more than tol of the
    per-objective range."""
    for f in Fa:
        margin_dom = np.all(f <= Fb - tol * scale, axis=1)
        assert not margin_dom.any(), (
            f"front point {f} clearly dominates {Fb[margin_dom][0]}")


def test_front_equivalent_to_jax_jit_nsga2():
    """Seeded torch_nsga2 (CPU) and the reference jit_nsga2 converge to
    equivalent Pareto fronts on the EfficientNet-B0 four-platform schedule
    (the budget and tolerances of the reference's own jit-vs-NumPy test)."""
    jsys = JSystemSpec(platforms=tuple(JPlatformSpec(n, a, bits=b)
                                       for n, a, b in PLATS),
                       links=("gige",) * 3).build()
    jg = jbuild("efficientnet_b0", in_hw=64).to_graph()
    js = jlinearize(jg, "min_memory")
    jev = JEvaluator(jg, js, jsys, accuracy_fn=JProxy(js, jsys))
    res_j = jrun_search(jev, objectives=OBJECTIVES, settings=JSettings(
        strategy="jit_nsga2", seed=0, pop_size=256, n_gen=100))

    graph = build_cnn("efficientnet_b0", in_hw=64).to_graph()
    system = FOUR_PLATFORM.build()
    schedule = linearize(graph, "min_memory")
    ev = PartitionEvaluator(graph, schedule, system,
                            accuracy_fn=ProxyAccuracy(schedule, system))
    res_t = search(ev, seed=0, pop_size=256, n_gen=100)
    assert res_t.strategy_used == "torch_nsga2"
    assert len(res_t.pareto) >= 1
    Fj = np.array([e.as_objectives(OBJECTIVES) for e in res_j.pareto])
    Ft = np.array([e.as_objectives(OBJECTIVES) for e in res_t.pareto])
    scale = np.ptp(np.concatenate([Fj, Ft]), axis=0) + 1e-12
    _no_clear_domination(Fj, Ft, scale)
    _no_clear_domination(Ft, Fj, scale)
    assert (np.abs(Ft.min(axis=0) - Fj.min(axis=0)) <= 0.08 * scale).all()


def test_blocked_ranking_leaves_search_unchanged(evaluator, monkeypatch):
    """The dense oracle (the whole domination matrix packed, every
    individual peeled) in the ranking's place gives the same search."""
    blocked = search(evaluator, seed=2, pop_size=64, n_gen=6)
    caps = []

    def dense_rank(F, CV, cap=None, **kw):
        caps.append(cap)
        n = F.shape[0]
        words = ref.pack_bits(T.domination_matrix(F, CV))
        alive = torch.ones(n, dtype=torch.bool)
        return ref.peel_fronts(words, alive, n if cap is None
                               else min(cap, n))[0]
    monkeypatch.setattr(T, "nondominated_rank", dense_rank)
    dense = search(evaluator, seed=2, pop_size=64, n_gen=6)
    assert caps == [None] + [64] * 6
    for a, b in ((dense.nsga.X, blocked.nsga.X), (dense.nsga.F, blocked.nsga.F),
                 (dense.nsga.CV, blocked.nsga.CV)):
        assert (a == b).all()


@pytest.mark.parametrize("rank_block", (None, 0, 128))
def test_rank_block_is_inert(evaluator, rank_block):
    """Any ``rank_block`` gives the same search, and the field still
    round-trips through a spec's plain-dict form."""
    want = search(evaluator, seed=3, pop_size=48, n_gen=3)
    got = search(evaluator, seed=3, pop_size=48, n_gen=3,
                 rank_block=rank_block)
    assert [p.cuts for p in got.pareto] == [p.cuts for p in want.pareto]
    for a, b in ((got.nsga.X, want.nsga.X), (got.nsga.F, want.nsga.F),
                 (got.nsga.CV, want.nsga.CV)):
        assert (a == b).all()
    spec = ExplorationSpec(
        model=ModelRef("cnn", "squeezenet11", {"in_hw": 64}),
        system=FOUR_PLATFORM,
        search=SearchSettings(strategy="torch_nsga2", rank_block=rank_block))
    d = spec.to_dict()
    assert d["search"]["rank_block"] == rank_block
    assert ExplorationSpec.from_dict(d) == spec
    assert ExplorationSpec.from_dict(d).to_dict() == d


def test_restarts_merge_seed_runs(evaluator):
    one = search(evaluator, seed=5, pop_size=64, n_gen=4)
    two = search(evaluator, seed=5, pop_size=64, n_gen=4, n_restarts=2)
    assert two.n_evaluated == 2 * 64 * 5
    assert (two.nsga.X[:64] == one.nsga.X).all()     # restart 0 == seed 5
    F1 = np.array([e.as_objectives(OBJECTIVES) for e in one.pareto])
    F2 = np.array([e.as_objectives(OBJECTIVES) for e in two.pareto])
    for f in F2:
        assert not (F1 < f - 1e-12).all(axis=1).any()


def test_front_points_are_exactly_scored(evaluator):
    """Reported points come from the float64 NumPy evaluator (bit for bit
    its batch path; the scalar path sums in another order), not from the
    float32 tensor scores the search ranked by."""
    res = search(evaluator, seed=1, pop_size=64, n_gen=10)
    assert res.pareto
    cuts = np.array([ev.cuts for ev in res.pareto])
    exact = evaluator.evaluate_batch(cuts).to_evals()
    assert res.pareto == exact
    for ev in res.pareto:
        scalar = evaluator.evaluate(ev.cuts)
        assert ev.memory_bytes == scalar.memory_bytes
        assert ev.link_bytes == scalar.link_bytes
        np.testing.assert_allclose(
            [ev.latency_s, ev.energy_j, ev.throughput],
            [scalar.latency_s, scalar.energy_j, scalar.throughput],
            rtol=1e-12)


def test_measured_accuracy_falls_back_with_warning(evaluator):
    ev = PartitionEvaluator(evaluator.graph, evaluator.schedule,
                            evaluator.system,
                            accuracy_fn=MeasuredAccuracy(lambda c: 0.75))
    with pytest.warns(UserWarning, match="falling back"):
        res = run_search(ev, objectives=("latency", "accuracy"),
                         settings=SearchSettings(strategy="torch_nsga2",
                                                 seed=0, pop_size=32,
                                                 n_gen=3),
                         device="cpu")
    assert res.strategy_used == "nsga2"
    assert len(res.pareto) >= 1


def test_rank_devices_clamps_with_warning(evaluator):
    with pytest.warns(UserWarning, match="rank_devices=4"):
        res = search(evaluator, seed=0, pop_size=32, n_gen=2, rank_devices=4)
    assert res.strategy_used == "torch_nsga2"


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ExplorationSpec(
        model=ModelRef("cnn", "squeezenet11", {"in_hw": 64}),
        system=FOUR_PLATFORM,
        search=SearchSettings(strategy="torch_nsga2", pop_size=32, n_gen=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_spec(spec)


def test_spec_roundtrip_and_validation():
    spec = ExplorationSpec(
        model=ModelRef("cnn", "squeezenet11", {"in_hw": 64}),
        system=FOUR_PLATFORM, objectives=("latency", "energy"),
        search=SearchSettings(strategy="torch_nsga2", seed=0, pop_size=48,
                              n_gen=3, rank_block=64, rank_impl="ref"))
    spec2 = ExplorationSpec.from_json(spec.to_json())
    assert spec2 == spec
    res = run_spec(spec2, device="cpu")
    assert res.strategy == "torch_nsga2" and res.nsga is not None
    assert res.n_evaluated == 48 * 4
    assert STRATEGIES["torch_nsga2"] is TorchNSGA2Search
    with pytest.raises(ValueError, match="rank_impl"):
        SearchSettings(rank_impl="triton")
    with pytest.raises(ValueError, match="unknown strategy"):
        SearchSettings(strategy="jit_nsga3")
    graph, shared = ModelRef("registry", "smollm-360m", {"seq": 64}).build()
    assert shared is None and len(graph.nodes) == 2 + 2 * 32


# -- the reference's names for the search settings ------------------------------

def test_reference_settings_load_with_the_ports_names():
    d = dataclasses.asdict(JSettings(strategy="jit_nsga2", rank_impl="pallas",
                                     pop_size=64, rank_block=128))
    got = SearchSettings(**d)
    assert (got.strategy, got.rank_impl) == ("torch_nsga2", "cuda")
    assert got == SearchSettings(strategy="torch_nsga2", rank_impl="cuda",
                                 pop_size=64, rank_block=128)
    assert SearchSettings(rank_impl="pallas").strategy == "auto"


def test_reference_spec_json_loads_and_hashes_like_the_ports():
    plats = tuple(JPlatformSpec(n, a, bits=b) for n, a, b in PLATS)
    jspec = JSpec(model=JModelRef("cnn", "efficientnet_b0", {"in_hw": 64}),
                  system=JSystemSpec(platforms=plats,
                                     links=("gige", "gige", "gige")),
                  objectives=OBJECTIVES,
                  search=JSettings(strategy="jit_nsga2", rank_impl="pallas",
                                   pop_size=256, n_gen=4, seed=3))
    got = ExplorationSpec.from_json(jspec.to_json())
    want = ExplorationSpec(
        model=ModelRef("cnn", "efficientnet_b0", {"in_hw": 64}),
        system=FOUR_PLATFORM, objectives=OBJECTIVES,
        search=SearchSettings(strategy="torch_nsga2", rank_impl="cuda",
                              pop_size=256, n_gen=4, seed=3))
    assert got == want
    assert got.to_json() == want.to_json()
    assert (SweepSpec(template=got).spec_hash()
            == SweepSpec(template=want).spec_hash())
    assert '"jit_nsga2"' in jspec.to_json() and "jit_nsga2" not in got.to_json()


@pytest.mark.parametrize("field,name", [("strategy", "jit_nsga"),
                                        ("strategy", "pallas"),
                                        ("rank_impl", "jit_nsga2"),
                                        ("rank_impl", "interpret")])
def test_unknown_search_names_still_raise(field, name):
    with pytest.raises(ValueError, match="unknown"):
        SearchSettings(**{field: name})
