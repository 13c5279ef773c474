"""The port's online re-partitioning (``repro_torch.explore.online``) on the
CPU: the reference's cases of ``tests/test_online.py`` with ``torch_nsga2``,
one parity case against the reference's ``OnlineRepartitioner``, the search
metrics it feeds, its trace, and the default device refusing to run without
a card.

Where the reference checks its compiled-runner cache, the port checks what
takes its place: drifted systems keep the baseline's table shape signature
and go through one evaluation function.  The reference's "warm updates are
faster than the cold one" timing assertion is left out: it measures the XLA
compilation the cold update pays, and the port compiles nothing (its cold
update carries only the process's first use of the device)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.explore as jexplore  # noqa: E402
import repro_torch.explore as texplore  # noqa: E402

from repro.explore import ExplorationSpec as JSpec  # noqa: E402
from repro.explore import ModelRef as JModelRef  # noqa: E402
from repro.explore import OnlineRepartitioner as JOnline  # noqa: E402
from repro.explore import SearchSettings as JSettings  # noqa: E402
from repro.explore import degrade_link as jdegrade_link  # noqa: E402
from repro.explore import drop_node as jdrop_node  # noqa: E402
from repro_torch.core.accuracy import ProxyAccuracy  # noqa: E402
from repro_torch.core.graph import linearize  # noqa: E402
from repro_torch.core.nsga2_torch import warm_population  # noqa: E402
from repro_torch.core.partition import PartitionEvaluator  # noqa: E402
from repro_torch.core.partition_torch import (build_eval_tables,  # noqa: E402
                                              make_runtime_eval_fn)
from repro_torch.explore import (ExplorationSpec, ModelRef,  # noqa: E402
                                 OnlineRepartitioner, SearchSettings,
                                 degrade_link, drop_node, run_search)
from repro_torch.explore.strategies import _cuts_to_genes  # noqa: E402
from repro_torch.obs import Obs, to_chrome_trace, validate_chrome_trace  # noqa: E402
from repro_torch.obs.metrics import default_registry  # noqa: E402

torch.set_num_threads(2)


def small_system(n_plat=2, m=texplore):
    """``n_plat`` platforms over gige links, as ``m``'s SystemSpec."""
    plats = tuple([m.PlatformSpec(f"EYR{i}", "eyr", bits=16)
                   for i in range(n_plat // 2)] +
                  [m.PlatformSpec(f"SMB{i}", "smb", bits=8)
                   for i in range(n_plat - n_plat // 2)])
    return m.SystemSpec(platforms=plats, links=("gige",) * (n_plat - 1))


OBJECTIVES = ("latency", "energy", "throughput")


def small_spec(system, pop=48, n_gen=6, **kw):
    # throughput (Def. 4) rewards pipelined splits, so link drift actually
    # moves the front — latency/energy alone collapse to one platform
    return ExplorationSpec(
        model=ModelRef("cnn", "squeezenet11", {"in_hw": 64}),
        system=system,
        objectives=OBJECTIVES,
        search=SearchSettings(strategy="torch_nsga2", seed=0,
                              pop_size=pop, n_gen=n_gen, **kw))


def evaluator_for(spec, system):
    graph, shared = spec.model.build()
    schedule = linearize(graph, spec.schedule_policy)
    built = system.build()
    return PartitionEvaluator(graph, schedule, built,
                              accuracy_fn=ProxyAccuracy(schedule, built),
                              shared_groups=shared)


def search_front(spec, system, candidates=None, warm_cuts=None):
    """run_search on ``system`` with ``spec``'s model/settings; -> result."""
    return run_search(evaluator_for(spec, system),
                      objectives=spec.objectives, settings=spec.search,
                      candidates=candidates, warm_cuts=warm_cuts,
                      device="cpu")


def front_set(res):
    return sorted(e.cuts for e in res.pareto)


# -- one evaluation function across same-shape systems ------------------------

def test_same_shape_systems_share_a_signature_and_match_cold():
    """Same-shape drifted systems give equal ``shape_signature()``, one
    evaluation function built for the baseline's tables scores the drifted
    tables exactly as the drifted system's own, and the front of a run that
    follows the baseline's search equals a cold one."""
    base = small_system()
    slow = degrade_link(base, 0, 16.0)
    spec = small_spec(base)
    t_base = build_eval_tables(evaluator_for(spec, base), "cpu")
    t_slow = build_eval_tables(evaluator_for(spec, slow), "cpu")
    assert t_base.shape_signature() == t_slow.shape_signature()
    shared_fn = make_runtime_eval_fn(t_base, OBJECTIVES, None)
    own_fn = make_runtime_eval_fn(t_slow, OBJECTIVES, None)
    L = t_base.L
    cuts = torch.arange(-1, L - 1, dtype=torch.int64)[:, None]
    for a, b in zip(shared_fn(cuts, t_slow), own_fn(cuts, t_slow)):
        assert torch.equal(a, b)

    res_base = search_front(spec, base)
    res_slow = search_front(spec, slow)         # after the baseline's search
    assert res_base.strategy_used == "torch_nsga2"
    res_cold = search_front(spec, slow)         # and on its own
    assert front_set(res_slow) == front_set(res_cold)
    assert res_slow.pareto == res_cold.pareto

    # and the perturbation must actually matter: objectives differ from base
    def objs(res):
        return [e.as_objectives(OBJECTIVES) for e in res.pareto]
    assert (objs(res_slow) != objs(res_base)
            or front_set(res_slow) != front_set(res_base))


def test_value_only_drift_keeps_shape_signature():
    base = small_system(4)
    spec = small_spec(base)

    def sig(system_spec):
        return build_eval_tables(evaluator_for(spec, system_spec),
                                 "cpu").shape_signature()

    s0 = sig(base)
    assert sig(degrade_link(base, 1, 64.0)) == s0
    assert sig(drop_node(base, 2)) == s0
    assert isinstance(hash(s0), int)


# -- warm start --------------------------------------------------------------

def hypervolume(front, ref):
    """Exact hypervolume (minimization) by recursive slicing — fine for
    the tiny fronts these searches produce."""
    pts = sorted({tuple(p) for p in front
                  if all(f <= r for f, r in zip(p, ref))})
    if not pts:
        return 0.0
    if len(ref) == 1:
        return ref[0] - pts[0][0]
    hv = 0.0
    for i, p in enumerate(pts):
        hi = pts[i + 1][0] if i + 1 < len(pts) else ref[0]
        width = hi - p[0]
        if width > 0:
            hv += width * hypervolume([q[1:] for q in pts[:i + 1]], ref[1:])
    return hv


def test_warm_hypervolume_not_worse_at_equal_budget():
    base = small_system(4)
    drifted = degrade_link(base, 1, 32.0)
    spec = small_spec(base, pop=48, n_gen=4)

    res_base = search_front(spec, base)
    warm_cuts = [e.cuts for e in res_base.pareto]

    res_cold = search_front(spec, drifted)
    res_warm = search_front(spec, drifted, warm_cuts=warm_cuts)

    def objs(res):
        return [e.as_objectives(OBJECTIVES) for e in res.pareto]
    allobjs = objs(res_cold) + objs(res_warm)
    ref = tuple(max(o[k] for o in allobjs) + abs(max(o[k] for o in allobjs))
                * 0.1 + 1e-12 for k in range(len(OBJECTIVES)))
    hv_cold = hypervolume(objs(res_cold), ref)
    hv_warm = hypervolume(objs(res_warm), ref)
    assert hv_warm >= hv_cold * (1 - 1e-9), \
        f"warm start regressed hypervolume: {hv_warm} < {hv_cold}"


def test_warm_start_off_ignores_seeds():
    base = small_system()
    spec = small_spec(base, warm_start=False)
    res_a = search_front(spec, base)
    # junk warm cuts must be ignored entirely when warm_start=False
    res_b = search_front(spec, base, warm_cuts=[(0,)] * 8)
    assert front_set(res_a) == front_set(res_b)


def test_warm_population_composition():
    rng = np.random.default_rng(0)
    warm = np.array([[3, 7], [10, 2]])
    X0 = warm_population(rng, 8, 2, 0, 15, warm)
    assert X0.shape == (8, 2) and X0.dtype.kind == "i"
    # elites lead, verbatim
    np.testing.assert_array_equal(X0[:2], warm)
    # jittered copies stay within +/-2 of an elite row, clipped to bounds
    for row in X0[2:4]:
        assert any(np.all(np.abs(row - w) <= 2) for w in warm)
    assert X0.min() >= 0 and X0.max() <= 15

    # no seeds -> uniform population, in bounds, deterministic per rng seed
    X0a = warm_population(np.random.default_rng(1), 8, 2, 0, 15, None)
    X0b = warm_population(np.random.default_rng(1), 8, 2, 0, 15,
                          np.empty((0, 2), dtype=int))
    np.testing.assert_array_equal(X0a, X0b)


def test_cuts_to_genes_snaps_to_nearest():
    table = np.array([2, 5, 9, 14])
    cuts = np.array([[2, 9], [3, 13], [0, 20]])
    genes = _cuts_to_genes(cuts, table)
    np.testing.assert_array_equal(genes, [[0, 2], [0, 3], [0, 3]])


def test_warm_start_json_round_trip():
    spec = small_spec(small_system(), warm_start=False)
    back = ExplorationSpec.from_json(spec.to_json())
    assert back.search.warm_start is False
    assert back == spec
    default = SearchSettings()
    assert default.warm_start is True


# -- strategy_used reporting -------------------------------------------------

def test_measured_accuracy_fallback_is_reported():
    base = small_system()
    spec = small_spec(base)
    graph, shared = spec.model.build()
    schedule = linearize(graph, spec.schedule_policy)
    # a bare callable oracle has no proxy_arrays -> no tensor tables
    ev = PartitionEvaluator(graph, schedule, base.build(),
                            accuracy_fn=lambda cuts: 0.9,
                            shared_groups=shared)
    with pytest.warns(UserWarning, match="falling back"):
        res = run_search(ev, objectives=("latency", "accuracy"),
                         settings=spec.search, device="cpu")
    assert res.strategy == "torch_nsga2"        # what was requested
    assert res.strategy_used == "nsga2"         # what actually ran
    assert res.to_report()["strategy_used"] == "nsga2"


# -- the drift loop ----------------------------------------------------------

@pytest.fixture(scope="module")
def drift_run():
    base = small_system(4)
    spec = small_spec(base, pop=48, n_gen=6)
    events = [degrade_link(base, 0, 8.0), drop_node(base, 1)]
    reg = default_registry()
    walls = reg.histogram("search_wall_s").count
    warms = reg.counter("search_warm_starts").value
    rp = OnlineRepartitioner(spec, device="cpu")
    first = rp.update(base)
    rest = list(rp.watch(events))
    fed = (reg.histogram("search_wall_s").count - walls,
           reg.counter("search_warm_starts").value - warms)
    return base, spec, rp, first, rest, events, fed


def test_online_repartitioner_bookkeeping(drift_run):
    base, spec, rp, first, rest, events, _ = drift_run
    sigs = {build_eval_tables(rp._evaluator(s.build()),
                              "cpu").shape_signature()
            for s in [base] + events}
    assert len(sigs) == 1, "drift changed a table shape"
    assert first.step == 0 and first.changed and first.feasible
    assert all(d.repartition_ms > 0 for d in [first] + rest)
    assert all(d.strategy_used == "torch_nsga2" for d in [first] + rest)
    assert rp.decisions == [first] + rest
    assert rp.device == "cpu"


def test_online_feeds_the_search_metrics(drift_run):
    """Every update records its search wall; the warm ones (all but the
    first) count a warm start each."""
    *_, fed = drift_run
    assert fed == (3, 2)


def test_online_dropout_routes_off_dead_node(drift_run):
    base, spec, rp, first, rest, *_ = drift_run
    dropped = rest[-1]
    assert dropped.feasible
    b = [-1] + list(dropped.cuts)
    assert b[2] <= b[1], \
        f"stage on dead platform 1 still has layers: {dropped.cuts}"


def test_online_decisions_deterministic(drift_run):
    base, spec, rp, first, rest, *_ = drift_run
    rp2 = OnlineRepartitioner(spec, device="cpu")
    replay = [rp2.update(base)] + list(
        rp2.watch([degrade_link(base, 0, 8.0), drop_node(base, 1)]))
    assert [d.cuts for d in replay] == [d.cuts for d in [first] + rest]


def test_warm_front_bounded_by_crowding_distance():
    """The carried warm seed is capped at ``max_warm_front`` rows chosen
    by crowding distance, and the cap holds across drift steps (a long
    mission must not grow the seed without bound)."""
    base = small_system(4)
    spec = small_spec(base)
    rp = OnlineRepartitioner(spec, max_warm_front=2, device="cpu")
    d0 = rp.update(base)
    assert d0.trigger == "event"                   # default provenance
    assert rp._front_cuts is not None and len(rp._front_cuts) <= 2
    # every carried row is a member of the front it was truncated from
    front = {tuple(e.cuts) for e in d0.result.pareto}
    assert all(tuple(int(c) for c in row) in front
               for row in rp._front_cuts)
    d1 = rp.update(degrade_link(base, 0, 8.0), trigger="measured")
    assert d1.trigger == "measured"                # observed, not told
    assert len(rp._front_cuts) <= 2
    with pytest.raises(ValueError, match="max_warm_front"):
        OnlineRepartitioner(spec, max_warm_front=0, device="cpu")


def test_online_forces_torch_strategy():
    spec = small_spec(small_system())
    spec = dataclasses.replace(
        spec, search=dataclasses.replace(spec.search, strategy="nsga2"))
    rp = OnlineRepartitioner(spec, device="cpu")
    assert rp.settings.strategy == "torch_nsga2"


def test_perturbation_validation():
    base = small_system()
    with pytest.raises(IndexError):
        degrade_link(base, 5, 2.0)
    with pytest.raises(ValueError):
        degrade_link(base, 0, 0.0)
    with pytest.raises(IndexError):
        drop_node(base, 9)
    assert base.links[0].build().rate_bps == \
        degrade_link(base, 0, 4.0).links[0].build().rate_bps * 4


# -- the port's own ------------------------------------------------------------

def test_decisions_traced_and_counted():
    """With a live ``Obs`` every decision lands as an instant on the
    ``health/repartition`` track and in the handle's counters; the trace
    validates."""
    obs = Obs.on()
    base = small_system()
    rp = OnlineRepartitioner(small_spec(base, pop=32, n_gen=2), obs=obs,
                             device="cpu")
    for s in (base, degrade_link(base, 0, 8.0)):
        rp.update(s)
    spans = obs.tracer.spans()
    assert [(s.name, s.track, s.ph) for s in spans] == [
        ("repartition", "health/repartition", "i")] * 2
    snap = obs.metrics.snapshot()
    assert snap["repartition_decisions"] == 2
    assert snap["repartition_ms.count"] == 2
    assert snap.get("repartition_changes", 0) >= 1
    assert validate_chrome_trace(to_chrome_trace(spans)) == []


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OnlineRepartitioner(small_spec(small_system()))


def test_decisions_match_the_reference_repartitioner():
    """On a two-platform chain, where a population of 48 over 32 candidate
    cuts reaches the true front, every decision of the mission has the
    reference's front (each against the other as the search tests compare
    fronts, then as sets of cut vectors) and the reference's selection."""
    jbase = small_system(2, jexplore)
    jspec = JSpec(model=JModelRef("cnn", "squeezenet11", {"in_hw": 64}),
                  system=jbase, objectives=OBJECTIVES,
                  search=JSettings(strategy="jit_nsga2", seed=0,
                                   pop_size=48, n_gen=6))
    jrp = JOnline(jspec)
    jmission = [jbase, jdegrade_link(jbase, 0, 8.0), jdrop_node(jbase, 1)]
    want = [jrp.update(s) for s in jmission]

    base = small_system(2)
    rp = OnlineRepartitioner(small_spec(base, pop=48, n_gen=6),
                             device="cpu")
    mission = [base, degrade_link(base, 0, 8.0), drop_node(base, 1)]
    got = [rp.update(s) for s in mission]
    assert len(rp.candidates) == len(jrp.candidates) == 32
    for system, g, w in zip(mission, got, want):
        # the true front, by an exhaustive scan of the drifted system
        exact = run_search(evaluator_for(rp.spec, system),
                           objectives=OBJECTIVES,
                           settings=SearchSettings(strategy="exhaustive"),
                           candidates=rp.candidates, device="cpu")
        Fg = np.array([e.as_objectives(OBJECTIVES) for e in g.result.pareto])
        Fw = np.array([e.as_objectives(OBJECTIVES) for e in w.result.pareto])
        scale = np.ptp(np.concatenate([Fg, Fw]), axis=0) + 1e-12
        for Fa, Fb in ((Fg, Fw), (Fw, Fg)):
            for f in Fa:
                assert not np.all(f <= Fb - 0.02 * scale, axis=1).any()
        assert (front_set(g.result) == front_set(exact)
                == sorted(e.cuts for e in w.result.pareto))
        assert (g.cuts, g.changed, g.feasible) == (w.cuts, w.changed,
                                                   w.feasible)
        np.testing.assert_allclose(Fg, Fw, rtol=1e-12)
