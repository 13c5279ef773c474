"""The port's evaluator tables and tensor evaluator
(``repro_torch.core.partition_torch``) against the JAX package: EvalTables
field for field against ``jax_tables()`` (exact), the batch evaluation
against JAX ``make_batch_eval_fn`` and NumPy ``evaluate_batch`` with
constraints active (float32 tolerance), the same on tables carried across
by ``tables_from_numpy``, and the port's CNN graphs against the
reference's for all six models at full size."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.accuracy import ProxyAccuracy as JProxy  # noqa: E402
from repro.core.graph import linearize as jlinearize  # noqa: E402
from repro.core.partition import Constraints as JConstraints  # noqa: E402
from repro.core.partition import PartitionEvaluator as JEvaluator  # noqa: E402
from repro.core.partition_jax import (  # noqa: E402
    _TABLE_ARRAYS, _TABLE_STATICS)
from repro.core.partition_jax import make_batch_eval_fn as jmake  # noqa: E402
from repro.explore import PlatformSpec as JPlatformSpec  # noqa: E402
from repro.explore import SystemSpec as JSystemSpec  # noqa: E402
from repro.models.cnn.zoo import CNN_ZOO as J_ZOO  # noqa: E402
from repro.models.cnn.zoo import build_cnn as jbuild  # noqa: E402
from repro_torch.core.accuracy import MeasuredAccuracy, ProxyAccuracy  # noqa: E402
from repro_torch.core.graph import linearize  # noqa: E402
from repro_torch.core.partition import Constraints, PartitionEvaluator  # noqa: E402
from repro_torch.core.partition_torch import (  # noqa: E402
    TABLE_ARRAYS, TABLE_STATICS, make_batch_eval_fn, tables_from_numpy)
from repro_torch.explore import PlatformSpec, SystemSpec  # noqa: E402
from repro_torch.models.cnn.zoo import CNN_ZOO, build_cnn  # noqa: E402

torch.set_num_threads(2)

PLATS = (("A0", "eyr", 16), ("A1", "eyr", 16), ("B0", "smb", 8),
         ("B1", "smb", 8))
ALL_OBJECTIVES = ("latency", "energy", "throughput", "bandwidth",
                  "memory", "accuracy")
CONS = dict(max_link_bytes=200_000, min_accuracy=0.9, max_latency_s=0.05,
            max_energy_j=0.05, min_throughput=10.0)


def systems(mem_capacity=None):
    j = JSystemSpec(platforms=tuple(JPlatformSpec(n, a, bits=b,
                                                  mem_capacity=mem_capacity)
                                    for n, a, b in PLATS),
                    links=("gige",) * 3).build()
    t = SystemSpec(platforms=tuple(PlatformSpec(n, a, bits=b,
                                                mem_capacity=mem_capacity)
                                   for n, a, b in PLATS),
                   links=("gige",) * 3).build()
    return j, t


def evaluators(mem_capacity=None):
    """The same EfficientNet-B0 (in_hw=64) four-platform evaluator built by
    each package."""
    jsys, tsys = systems(mem_capacity)
    jg = jbuild("efficientnet_b0", in_hw=64).to_graph()
    js = jlinearize(jg, "min_memory")
    tg = build_cnn("efficientnet_b0", in_hw=64).to_graph()
    ts = linearize(tg, "min_memory")
    return (JEvaluator(jg, js, jsys, accuracy_fn=JProxy(js, jsys)),
            PartitionEvaluator(tg, ts, tsys, accuracy_fn=ProxyAccuracy(ts, tsys)))


@pytest.fixture(scope="module")
def pair():
    return evaluators()


def random_cuts(L, n, seed=0):
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(-1, L, size=(n, 3)), axis=1)


def assert_tables_equal(jt, tt):
    assert TABLE_ARRAYS == _TABLE_ARRAYS and TABLE_STATICS == _TABLE_STATICS
    for f in TABLE_STATICS:
        assert getattr(tt, f) == getattr(jt, f), f
    for f in TABLE_ARRAYS:
        a, b = getattr(jt, f), getattr(tt, f)
        if a is None:
            assert b is None, f
            continue
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)
        assert b.dtype == torch.float32, f
    assert len(tt.mem_groups) == len(jt.mem_groups)
    for (jp, jg), (tp, tg) in zip(jt.mem_groups, tt.mem_groups):
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


def jax_arrays(jt):
    arrays = {f: (None if getattr(jt, f) is None
                  else np.asarray(getattr(jt, f))) for f in _TABLE_ARRAYS}
    arrays["mem_groups"] = [(np.asarray(p), np.asarray(g))
                            for p, g in jt.mem_groups]
    return arrays, {f: getattr(jt, f) for f in _TABLE_STATICS}


def test_eval_tables_match_jax_tables(pair):
    jev, tev = pair
    assert [l.name for l in tev.schedule] == [l.name for l in jev.schedule]
    tt = tev.torch_tables("cpu")
    assert tev.torch_tables("cpu") is tt            # cached per device
    assert_tables_equal(jev.jax_tables(), tt)
    assert tt.to("cpu").shape_signature() == tt.shape_signature()


def test_tables_carried_across_equal_jax_tables(pair):
    jev, _ = pair
    jt = jev.jax_tables()
    assert_tables_equal(jt, tables_from_numpy(*jax_arrays(jt), "cpu"))


def test_batch_eval_matches_jax_and_numpy(pair):
    jev, tev = pair
    C = random_cuts(len(tev.schedule), 256)
    jcons, tcons = JConstraints(**CONS), Constraints(**CONS)
    be = jev.evaluate_batch(C, jcons)
    F_np, CV_np = be.as_objectives(ALL_OBJECTIVES), be.violation
    F_j, CV_j = (np.asarray(x) for x in jax.jit(jmake(
        jev.jax_tables(), ALL_OBJECTIVES, jcons))(jnp.asarray(C)))
    assert CV_np.max() > 0, "constraints must actually bite in this test"
    for tables in (tev.torch_tables("cpu"),
                   tables_from_numpy(*jax_arrays(jev.jax_tables()), "cpu")):
        F_t, CV_t = (x.numpy() for x in make_batch_eval_fn(
            tables, ALL_OBJECTIVES, tcons)(torch.from_numpy(C)))
        np.testing.assert_allclose(F_t, F_np, rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(CV_t, CV_np, rtol=2e-5, atol=1e-5)
        np.testing.assert_allclose(F_t, F_j, rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(CV_t, CV_j, rtol=2e-5, atol=1e-5)


def test_batch_eval_memory_capacity_violation():
    jev, tev = evaluators(mem_capacity=300_000)
    C = random_cuts(len(tev.schedule), 256, seed=3)
    be = jev.evaluate_batch(C)
    F_t, CV_t = (x.numpy() for x in make_batch_eval_fn(
        tev.torch_tables("cpu"), ("latency", "memory"))(torch.from_numpy(C)))
    assert be.violation.max() > 0
    np.testing.assert_allclose(CV_t, be.violation, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(F_t[:, 1], be.memory_bytes.max(axis=1),
                               rtol=2e-5)


def test_batch_eval_requires_proxy_for_accuracy(pair):
    _, tev = pair
    ev = PartitionEvaluator(tev.graph, tev.schedule, tev.system,
                            accuracy_fn=MeasuredAccuracy(lambda c: 0.5))
    with pytest.raises(ValueError, match="proxy"):
        make_batch_eval_fn(ev.torch_tables("cpu"), ("latency", "accuracy"))


def layer_record(l):
    return tuple((f.name, getattr(l, f.name))
                 for f in dataclasses.fields(l))


@pytest.mark.parametrize("name", sorted(J_ZOO))
def test_full_size_graphs_equal_reference(name):
    assert sorted(CNN_ZOO) == sorted(J_ZOO)
    jg = jbuild(name).to_graph()
    tg = build_cnn(name).to_graph()
    assert tg.name == jg.name
    assert list(tg.nodes) == list(jg.nodes)                   # names, order
    assert ([layer_record(l) for l in tg.nodes.values()]
            == [layer_record(l) for l in jg.nodes.values()])
    assert tg.edges == jg.edges
    assert ([l.name for l in linearize(tg, "min_memory")]
            == [l.name for l in jlinearize(jg, "min_memory")])
