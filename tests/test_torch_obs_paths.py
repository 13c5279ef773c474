"""The spans and counters of the port's search and accuracy-oracle paths
(``repro_torch.obs`` threaded through ``explore/runner.py``,
``TorchNSGA2Search``, ``core/nsga2_torch.py``, ``quantize/evaluate.py``
and ``PartitionedCNNRunner``): how they nest, what their ``args`` count,
the host reads counted against a count taken at the tensors themselves,
outputs unchanged with the handle on, and with the default handle no span
and no clock read at a guarded site.  No JAX."""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import nsga2_torch as T  # noqa: E402
from repro_torch.core.graph import linearize  # noqa: E402
from repro_torch.core.quant import QuantSpec  # noqa: E402
from repro_torch.data.synthetic import SyntheticImages  # noqa: E402
from repro_torch.explore import (ExplorationSpec, ModelRef,  # noqa: E402
                                 PlatformSpec, SearchSettings, SystemSpec,
                                 TorchNSGA2Search, run_spec)
from repro_torch.models.cnn.zoo import reduced_cnn  # noqa: E402
from repro_torch.obs import NOOP_OBS, Laps, Obs, Tracer  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.quantize.evaluate import cnn_measured_accuracy  # noqa: E402

torch.set_num_threads(2)

BLOCKS = {"dense": 0, "tiled": 64}
# every Tensor method that copies a value to the host
READS = ("__int__", "__float__", "__bool__", "item", "cpu", "tolist")


def toy_eval(X):
    f1 = X.sum(dim=1).to(torch.float32)
    f2 = ((X - 20) ** 2).sum(dim=1).to(torch.float32)
    cv = torch.clamp(15.0 - X[:, 0].to(torch.float32), min=0.0)
    return torch.stack([f1, f2], dim=1), cv


def search(rank_block, obs=None, pop=48, n_gen=4):
    return T.torch_nsga2(toy_eval, 3, 0, 40, pop, n_gen, seed=3,
                         rank_block=rank_block, device="cpu", obs=obs)


def count_reads(monkeypatch):
    """Counts every host read made through a Tensor method from now on."""
    n = collections.Counter()
    for name in READS:
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **k):
            n[_name] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    return n


def count_clock(monkeypatch):
    """Counts ``time.perf_counter`` reads from now on."""
    import time
    n = [0]
    orig = time.perf_counter

    def counted():
        n[0] += 1
        return orig()
    monkeypatch.setattr(time, "perf_counter", counted)
    return n


def parent(spans, s):
    """The innermost other span on ``s``'s track that holds ``s``."""
    held = [p for p in spans if p is not s and p.track == s.track
            and p.ts <= s.ts and s.end <= p.end
            and (p.dur > s.dur or p.ts < s.ts)]
    return min(held, key=lambda p: p.dur, default=None)


def names(spans):
    return collections.Counter(s.name for s in spans)


# -- the generation loop ------------------------------------------------------------

@pytest.mark.parametrize("path", BLOCKS)
def test_loop_spans_nest(path):
    obs = Obs.on()
    search(BLOCKS[path], obs)
    sp = obs.tracer.spans()
    n_gen = 4
    got = names(sp)
    assert got["search.generation"] == got["search.rank"] == n_gen + 1
    assert got["search.evaluate"] == got["search.crowding"] == n_gen + 1
    assert got["search.offspring"] == got["search.survivors"] == n_gen
    first = "search.k1" if BLOCKS[path] else "search.dominance"
    assert got[first] == n_gen + 1
    assert got["search.infeasible_tail"] == (n_gen + 1 if BLOCKS[path] else 0)
    assert {s.track for s in sp} == {T.TRACK} and obs.tracer.dropped == 0
    for s in sp:
        up = parent(sp, s)
        if s.name == "search.front":
            assert up.name == "search.peel"
            assert parent(sp, up).name == "search.rank"
            assert parent(sp, parent(sp, up)).name == "search.generation"
        elif s.name in ("search.k1", "search.dominance", "search.peel",
                        "search.infeasible_tail"):
            assert up.name == "search.rank"
        elif s.name == "search.generation":
            assert up is None
        else:
            assert up.name == "search.generation", s.name
    gens = [s.args["gen"] for s in sp if s.name == "search.generation"]
    assert gens == list(range(n_gen + 1))


@pytest.mark.parametrize("path", BLOCKS)
def test_peel_fronts_equal_its_front_spans(path):
    obs = Obs.on()
    search(BLOCKS[path], obs)
    sp = obs.tracer.spans()
    peels = [s for s in sp if s.name == "search.peel"]
    assert peels
    for p in peels:
        fronts = [s for s in sp if s.name == "search.front"
                  and parent(sp, s) is p]
        assert p.args["fronts"] == len(fronts) >= 1
        assert p.args["ranked"] == sum(f.args["k"] for f in fronts)
        alive = [f.args["alive"] for f in fronts]
        assert alive == sorted(alive, reverse=True)
    for r in (s for s in sp if s.name == "search.rank"):
        assert r.args["m"] == 2 and r.args["block"] == BLOCKS[path]
        if BLOCKS[path]:
            assert r.args["impl"] == "ref"
            assert 0 <= r.args["feasible"] <= r.args["n"]
        else:
            assert r.args["impl"] == "dense" and r.args["feasible"] is None


@pytest.mark.parametrize("path", BLOCKS)
def test_host_reads_equal_the_reads_counted_at_the_tensors(path, monkeypatch):
    obs = Obs.on()
    n = count_reads(monkeypatch)
    search(BLOCKS[path], obs)
    monkeypatch.undo()
    assert set(n) <= {"__int__", "cpu"}
    sp = obs.tracer.spans()
    peels = [s for s in sp if s.name == "search.peel"]
    by_hand = len(peels) + sum(p.args["fronts"] for p in peels) + 3
    assert n["__int__"] + n["cpu"] == by_hand
    assert obs.metrics.snapshot()[T.HOST_READS] == by_hand


@pytest.mark.parametrize("path", BLOCKS)
def test_outputs_identical_with_the_handle_on_and_off(path):
    on, off = search(BLOCKS[path], Obs.on()), search(BLOCKS[path])
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    F, CV = toy_eval(torch.randint(0, 41, (97, 3),
                                   generator=torch.Generator().manual_seed(1)))
    for cap in (None, 40):
        assert torch.equal(
            T.nondominated_rank(F, CV, cap, rank_block=BLOCKS[path],
                                obs=Obs.on()),
            T.nondominated_rank(F, CV, cap, rank_block=BLOCKS[path]))


@pytest.mark.parametrize("path", BLOCKS)
def test_default_handle_records_nothing_and_reads_no_clock(path,
                                                          monkeypatch):
    def refused(*a, **k):
        raise AssertionError("recorded with the handle off")
    monkeypatch.setattr(T, "Laps", refused)
    monkeypatch.setattr(obs_trace.NullTracer, "complete", refused)
    clock = count_clock(monkeypatch)
    search(BLOCKS[path])
    search(BLOCKS[path], NOOP_OBS)
    assert clock[0] == 0
    assert NOOP_OBS.metrics.snapshot() == {}


# -- the search's entry points ---------------------------------------------------------

def spec(pop=48):
    plats = (("A0", "eyr", 16), ("A1", "eyr", 16), ("B0", "smb", 8))
    return ExplorationSpec(
        model=ModelRef("cnn", "squeezenet11", {"in_hw": 64}),
        system=SystemSpec(platforms=tuple(PlatformSpec(n, a, bits=b)
                                          for n, a, b in plats),
                          links=("gige", "gige")),
        objectives=("latency", "energy", "throughput"),
        search=SearchSettings(strategy="torch_nsga2", seed=0, pop_size=pop,
                              n_gen=2, rank_block=32, rank_impl="ref"))


def test_run_spec_spans_cover_the_search(monkeypatch):
    # the tiled final-front mask (K2's path) at this small population
    monkeypatch.setattr(TorchNSGA2Search, "_DENSE_PARETO_MAX", 16)
    obs = Obs.on()
    run_spec(spec(), device="cpu", obs=obs)
    sp = obs.tracer.spans()
    top = [s for s in sp if parent(sp, s) is None]
    assert [s.name for s in top] == [
        "search.build", "search.build", "search.prepare", "search.tables",
        "search.run", "search.final_front"]
    for a, b in zip(top, top[1:]):
        assert a.end <= b.ts
    run = top[4]
    loop = [s for s in sp if s.name == "search.generation"]
    assert len(loop) == 3 and all(parent(sp, s) is run for s in loop)
    peels = [s for s in sp if s.name == "search.peel"]
    # the peels' reads, X, F and CV, and the final-front counts
    want = len(peels) + sum(p.args["fronts"] for p in peels) + 3 + 1
    assert obs.metrics.snapshot()[T.HOST_READS] == want


def test_run_spec_off_reads_only_the_search_wall(monkeypatch):
    res_off = run_spec(spec(), device="cpu")
    clock = count_clock(monkeypatch)
    again = run_spec(spec(), device="cpu")
    assert clock[0] == 2                # search_wall_s's two reads
    monkeypatch.undo()
    res_on = run_spec(spec(), device="cpu", obs=Obs.on())
    for r in (again, res_on):
        assert [p.cuts for p in r.pareto] == [p.cuts for p in res_off.pareto]
        assert np.array_equal(r.nsga.X, res_off.nsga.X)
        assert np.array_equal(r.nsga.F, res_off.nsga.F)


# -- the measured accuracy oracle --------------------------------------------------------

@pytest.fixture(scope="module")
def oracle_inputs():
    m = reduced_cnn("efficientnet_b0").init_weights(device="cpu")
    vx, vy = SyntheticImages(n_classes=10, hw=32).eval_set(16)
    sched = linearize(m.to_graph())
    specs = [QuantSpec(b) for b in (16, 16, 8, 8)]
    return m, sched, vx, vy, specs


def test_oracle_fresh_vector_spans(oracle_inputs):
    m, sched, vx, vy, specs = oracle_inputs
    obs = Obs.on()
    measure = cnn_measured_accuracy(m, sched, vx, vy, specs, obs=obs)
    cuts = (5, 20, len(sched) - 3)
    acc = measure(cuts)
    sp = obs.tracer.spans()
    top, = [s for s in sp if parent(sp, s) is None]
    assert top.name == "oracle.measure"
    assert top.args == {"cuts": cuts, "cached": False}
    assert {s.track for s in sp} == {"oracle"}
    n_stages = 4
    got = names(sp)
    assert got == {"oracle.measure": 1, "oracle.quantize": n_stages,
                   "oracle.stage": n_stages, "oracle.link": n_stages - 1,
                   "oracle.read": 1}
    assert all(parent(sp, s) is top for s in sp if s is not top)
    q = [s.args for s in sp if s.name == "oracle.quantize"]
    assert [a["stage"] for a in q] == list(range(n_stages))
    assert [a["bits"] for a in q] == [16, 16, 8, 8]
    assert all(a["tensors"] > 0 for a in q)
    assert all(s.args["bytes"] > 0 for s in sp if s.name == "oracle.link")
    assert max(s.end for s in sp) == top.end
    assert acc == cnn_measured_accuracy(m, sched, vx, vy, specs)(cuts)


def test_oracle_repeated_vector_is_one_cached_span(oracle_inputs):
    m, sched, vx, vy, specs = oracle_inputs
    obs = Obs.on()
    measure = cnn_measured_accuracy(m, sched, vx, vy, specs, obs=obs)
    cuts = (-1, 30, 60)
    first = measure(cuts)
    n_first = len(obs.tracer.spans())
    assert measure(cuts) == first
    sp = obs.tracer.spans()[n_first:]
    assert len(sp) == 1 and sp[0].name == "oracle.measure"
    assert sp[0].args == {"cuts": cuts, "cached": True}


def test_oracle_default_handle_records_nothing(oracle_inputs, monkeypatch):
    m, sched, vx, vy, specs = oracle_inputs
    measure = cnn_measured_accuracy(m, sched, vx, vy, specs)

    def refused(*a, **k):
        raise AssertionError("recorded with the handle off")
    monkeypatch.setattr(obs_trace.NullTracer, "complete", refused)
    clock = count_clock(monkeypatch)
    measure((10, 40, 80))
    # only the runner's stage timer, two reads a stage
    assert clock[0] == 2 * 4


# -- the laps helper -----------------------------------------------------------------

def test_laps_share_their_clock_reads(monkeypatch):
    tracer = Tracer()
    ticks = iter(float(t) for t in range(100, 110))
    import time
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    laps = Laps(tracer, "parent", "trk", {"a": 1})      # 100
    laps.lap("one", {"b": 2})                           # 101
    laps.lap()                                          # 102: skipped
    laps.lap("two")                                     # 103
    laps.close()
    got = [(s.name, round(s.ts + tracer.epoch, 6), round(s.dur, 6), s.args)
           for s in tracer.spans()]
    assert sorted(got) == sorted([("parent", 100.0, 3.0, {"a": 1}),
                                  ("one", 100.0, 1.0, {"b": 2}),
                                  ("two", 102.0, 1.0, None)])
