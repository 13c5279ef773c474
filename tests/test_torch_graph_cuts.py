"""The port's cut analysis (``repro_torch.core.graph`` live sets, clean
cuts, ``all_cuts``, cut bytes, branch regions, and the evaluator's
per-position link elements) against the JAX package's per-position rescan:
the six zoo CNNs at full size under three schedules, the EfficientNet-B0
four-platform search spec, and random DAGs under topological,
non-topological and partial schedules.  Then a work guard: the analysis
walks the edge list a constant number of times, whatever the schedule's
length, and never calls ``succs``."""

import random

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import layers as JL  # noqa: E402
from repro.core.graph import LayerGraph as JGraph  # noqa: E402
from repro.core.graph import linearize as jlinearize  # noqa: E402
from repro.core.partition import PartitionEvaluator as JEvaluator  # noqa: E402
from repro.core.partition import single_platform_eval as jsingle  # noqa: E402
from repro.explore import ModelRef as JModelRef  # noqa: E402
from repro.explore import PlatformSpec as JPlatformSpec  # noqa: E402
from repro.explore import SystemSpec as JSystemSpec  # noqa: E402
from repro.explore.filters import candidate_positions as jcandidates  # noqa: E402
from repro.models.cnn.zoo import CNN_ZOO as J_ZOO  # noqa: E402
from repro.models.cnn.zoo import build_cnn as jbuild  # noqa: E402
from repro_torch.core import layers as TL  # noqa: E402
from repro_torch.core.graph import LayerGraph, linearize  # noqa: E402
from repro_torch.core.partition import (PartitionEvaluator,  # noqa: E402
                                        single_platform_eval)
from repro_torch.explore import ModelRef, PlatformSpec, SystemSpec  # noqa: E402
from repro_torch.explore.filters import candidate_positions  # noqa: E402
from repro_torch.models.cnn.zoo import CNN_ZOO, build_cnn  # noqa: E402

POLICIES = ("insertion", "min_memory", "random")
BPES = (0.5, 1.0, 2.0, 4.0)
MAX_LIVE = (1, 4, 8)

# the search cell's system: the paper's four-platform chain
PLATS = (("cam0", "eyr", 16), ("cam1", "eyr", 16), ("edge", "smb", 8),
         ("central", "smb", 8))
LINKS = ("gige",) * 3
EFFNET = ("cnn", "efficientnet_b0", {"in_hw": 224, "w": 1.0,
                                     "n_classes": 1000})

_ZOO = {}


def zoo_pair(name, policy):
    """(port graph, port schedule, reference graph, reference schedule)
    for one zoo CNN at full size, built once per module."""
    if (name, policy) not in _ZOO:
        tg, jg = build_cnn(name).to_graph(), jbuild(name).to_graph()
        seed = 0 if policy == "random" else None
        ts = linearize(tg, policy, seed=seed)
        js = jlinearize(jg, policy, seed=seed)
        assert [l.name for l in ts] == [l.name for l in js]
        _ZOO[name, policy] = (tg, ts, jg, js)
    return _ZOO[name, policy]


ZOO_CASES = [(n, p) for n in sorted(CNN_ZOO) for p in POLICIES]


def test_zoo_matches_reference():
    assert sorted(CNN_ZOO) == sorted(J_ZOO)


@pytest.mark.parametrize("name,policy", ZOO_CASES)
def test_zoo_live_sets(name, policy):
    tg, ts, jg, js = zoo_pair(name, policy)
    want = [jg.live_set(js, p) for p in range(len(js) - 1)]
    assert tg.live_sets(ts) == want
    assert [tg.live_set(ts, p) for p in range(len(ts) - 1)] == want


@pytest.mark.parametrize("name,policy", ZOO_CASES)
def test_zoo_clean_cuts_and_branch_regions(name, policy):
    tg, ts, jg, js = zoo_pair(name, policy)
    assert tg.clean_cuts(ts) == jg.clean_cuts(js)
    assert tg.branch_regions(ts) == jg.branch_regions(js)


@pytest.mark.parametrize("max_live", MAX_LIVE)
@pytest.mark.parametrize("name,policy", ZOO_CASES)
def test_zoo_all_cuts(name, policy, max_live):
    tg, ts, jg, js = zoo_pair(name, policy)
    assert tg.all_cuts(ts, max_live) == jg.all_cuts(js, max_live)


@pytest.mark.parametrize("bpe", BPES)
@pytest.mark.parametrize("name,policy", ZOO_CASES)
def test_zoo_cut_bytes(name, policy, bpe):
    tg, ts, jg, js = zoo_pair(name, policy)
    assert ([tg.cut_bytes(ts, p, bpe) for p in range(len(ts) - 1)]
            == [jg.cut_bytes(js, p, bpe) for p in range(len(js) - 1)])


# -- the search cell's spec ---------------------------------------------------

_SPEC = {}


def spec_evaluators():
    """The port's and the reference's evaluators for EfficientNet-B0 at 224
    on the four-platform chain under ``min_memory``, as the search cell
    resolves its spec."""
    if not _SPEC:
        out = []
        for ref, spec, mref, lin, ev in (
                (JModelRef, JSystemSpec, JPlatformSpec, jlinearize, JEvaluator),
                (ModelRef, SystemSpec, PlatformSpec, linearize,
                 PartitionEvaluator)):
            graph, shared = ref(*EFFNET).build()
            system = spec(platforms=tuple(mref(n, a, bits=b)
                                          for n, a, b in PLATS),
                          links=LINKS).build()
            sched = lin(graph, "min_memory")
            out.append(ev(graph, sched, system, shared_groups=shared))
        _SPEC["j"], _SPEC["t"] = out
    return _SPEC["j"], _SPEC["t"]


def test_spec_cut_elements_and_candidates():
    jev, tev = spec_evaluators()
    want = jev.cut_elements()
    got = tev.cut_elements()
    assert got.dtype == np.int64 and want.shape == got.shape
    np.testing.assert_array_equal(got, want)
    assert candidate_positions(tev) == jcandidates(jev)
    assert (candidate_positions(tev, allow_multi_tensor_cuts=True)
            == jcandidates(jev, allow_multi_tensor_cuts=True))


def spec_cut_rows():
    """32 seeded sorted cut vectors over every position, -1 and L-1."""
    jev, _ = spec_evaluators()
    L = len(jev.schedule)
    rng = np.random.default_rng(0)
    return np.sort(rng.integers(-1, L, size=(32, len(LINKS))), axis=1)


@pytest.mark.parametrize("platform", range(len(PLATS)))
def test_spec_baseline_link_bytes(platform):
    jev, tev = spec_evaluators()
    want = jsingle(jev, platform)
    got = single_platform_eval(tev, platform)
    assert got.cuts == want.cuts
    assert got.link_bytes == want.link_bytes


@pytest.mark.parametrize("row", range(32))
def test_spec_evaluate_link_bytes(row):
    jev, tev = spec_evaluators()
    cuts = tuple(int(c) for c in spec_cut_rows()[row])
    want, got = jev.evaluate(cuts), tev.evaluate(cuts)
    assert got.link_bytes == want.link_bytes
    assert got.link_latency_s == want.link_latency_s


def test_spec_evaluate_batch_link_bytes():
    jev, tev = spec_evaluators()
    C = spec_cut_rows()
    np.testing.assert_array_equal(tev.evaluate_batch(C).link_bytes,
                                  jev.evaluate_batch(C).link_bytes)


# -- random DAGs ---------------------------------------------------------------

def random_dag_pair(seed):
    """The same random DAG as a port graph and a reference graph, drawn as
    ``tests/test_graph.py::random_dag`` draws it (3-12 nodes, each with
    1-3 earlier predecessors): sinks and multi-consumer nodes abound."""
    rng = random.Random(seed)
    n = rng.randint(3, 12)
    tg, jg = LayerGraph(name="rand"), JGraph(name="rand")
    for i in range(n):
        preds = []
        if i > 0:
            k = rng.randint(1, min(3, i))
            preds = sorted({rng.randint(0, i - 1) for _ in range(k)})
        after = [f"n{p}" for p in preds] or None
        shape = (rng.randint(1, 4), 4, 4)
        tg.add(TL.elementwise_layer(f"n{i}", TL.RELU, shape), after=after)
        jg.add(JL.elementwise_layer(f"n{i}", JL.RELU, shape), after=after)
    return tg, jg


def schedules(tg, jg, seed):
    """(kind, port schedule, reference schedule) pairs over the same names:
    topological ones, a shuffled one that breaks edges, and partial ones
    that leave consumers (or producers) out."""
    rng = random.Random(seed)
    names = list(tg.nodes)
    topo = [l.name for l in tg.topo_sort(seed=seed)]
    shuffled = names[:]
    rng.shuffle(shuffled)
    keep = sorted(rng.sample(range(len(topo)), rng.randint(1, len(topo))))
    out = [("insertion", [l.name for l in tg.topo_sort()]),
           ("random_topo", topo),
           ("shuffled", shuffled),
           ("partial_topo", [topo[i] for i in keep]),
           ("partial_prefix", topo[:rng.randint(1, len(topo))]),
           ("partial_shuffled", shuffled[:rng.randint(1, len(shuffled))]),
           ("empty", [])]
    return [(kind, [tg.nodes[n] for n in s], [jg.nodes[n] for n in s])
            for kind, s in out]


def test_random_dags_cover_sinks_and_fanout():
    multi_sink = fanout = broken = 0
    for seed in range(64):
        tg, _ = random_dag_pair(seed)
        producers = [u for u, _ in tg.edges]
        multi_sink += sum(1 for n in tg.nodes if n not in producers) > 1
        fanout += any(producers.count(u) > 1 for u in set(producers))
        kind, shuffled, _ = schedules(tg, tg, seed)[2]
        assert kind == "shuffled"
        broken += not tg.validate_schedule(shuffled)
    assert multi_sink and fanout and broken


@pytest.mark.parametrize("seed", range(64))
def test_random_dag_cut_analysis(seed):
    tg, jg = random_dag_pair(seed)
    for kind, ts, js in schedules(tg, jg, seed):
        n = len(ts)
        want = [jg.live_set(js, p) for p in range(n - 1)]
        assert tg.live_sets(ts) == want, kind
        # every position the single-position form takes, out of range too
        for p in range(-n - 1, n + 2):
            assert tg.live_set(ts, p) == jg.live_set(js, p), (kind, p)
            for bpe in BPES:
                assert (tg.cut_bytes(ts, p, bpe)
                        == jg.cut_bytes(js, p, bpe)), (kind, p, bpe)
        assert tg.clean_cuts(ts) == jg.clean_cuts(js), kind
        assert tg.branch_regions(ts) == jg.branch_regions(js), kind
        for m in MAX_LIVE:
            assert tg.all_cuts(ts, m) == jg.all_cuts(js, m), (kind, m)


# -- the work guard ------------------------------------------------------------

class CountingEdges(list):
    """An edge list that counts the walks over it."""

    walks = 0

    def __iter__(self):
        self.walks += 1
        return super().__iter__()


def counted_chain(n, monkeypatch):
    """A chain of ``n`` layers whose edge walks and ``succs`` calls are
    counted, its schedule, and an evaluator on the four-platform chain."""
    g = LayerGraph(name="chain")
    g.chain([TL.elementwise_layer(f"l{i}", TL.RELU, (4, 8, 8))
             for i in range(n)])
    sched = linearize(g)
    system = SystemSpec(platforms=tuple(PlatformSpec(nm, a, bits=b)
                                        for nm, a, b in PLATS),
                        links=LINKS).build()
    ev = PartitionEvaluator(g, sched, system)
    calls = []
    succs = LayerGraph.succs

    def counting_succs(self, name):
        calls.append(name)
        return succs(self, name)

    monkeypatch.setattr(LayerGraph, "succs", counting_succs)
    g.edges = CountingEdges(g.edges)
    return g, sched, ev, calls


def walks(fn, g):
    g.edges.walks = 0
    fn()
    return g.edges.walks


def test_cut_analysis_walks_edges_a_constant_number_of_times(monkeypatch):
    counts = {}
    for n in (50, 500):
        g, sched, ev, calls = counted_chain(n, monkeypatch)
        counts[n] = (walks(lambda: g.clean_cuts(sched), g),
                     walks(lambda: g.all_cuts(sched), g),
                     walks(lambda: g.live_set(sched, n // 2), g),
                     walks(lambda: g.cut_bytes(sched, n // 2, 1.0), g),
                     walks(ev.cut_elements, g))
        assert g.clean_cuts(sched) == list(range(n - 1))
        assert ev.cut_elements().tolist() == [4 * 8 * 8] * (n - 1)
        assert calls == []
    assert counts[50] == counts[500]
    assert all(0 < c <= 2 for c in counts[50]), counts


def test_evaluate_reads_link_bytes_without_walking_edges(monkeypatch):
    g, sched, ev, calls = counted_chain(50, monkeypatch)
    ev.cut_elements()
    cuts = (9, 19, 29)
    assert walks(lambda: ev.evaluate(cuts), g) == 0
    assert ev.evaluate(cuts).link_bytes == 4 * 8 * 8 * 2      # 16 bits
    assert calls == []
