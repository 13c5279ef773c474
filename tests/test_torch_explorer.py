"""The port's deprecated ``Explorer`` shim (``repro_torch.core.explorer``)
against the JAX package's on the CPU: the same candidates, front and
selection on SqueezeNet 1.1 at 64 x 64 over two platforms, by the
exhaustive scan and by the default strategy, the memory and link filters,
and the ``DeprecationWarning``.  The fronts are the NumPy evaluator's on
both sides, compared exactly."""

import warnings

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import Constraints as JConstraints  # noqa: E402
from repro.core import Explorer as JExplorer  # noqa: E402
from repro.core import Platform as JPlatform  # noqa: E402
from repro.core import QuantSpec as JQuantSpec  # noqa: E402
from repro.core import SystemConfig as JSystemConfig  # noqa: E402
from repro.core import get_link as jget_link  # noqa: E402
from repro.core.hwmodel import EYERISS_LIKE as JEYR  # noqa: E402
from repro.core.hwmodel import SIMBA_LIKE as JSMB  # noqa: E402
from repro.models.cnn.zoo import build_cnn as jbuild_cnn  # noqa: E402
from repro_torch.core import (Constraints, Explorer, Platform,  # noqa: E402
                              QuantSpec, SystemConfig, get_link)
from repro_torch.core.hwmodel.arch import EYERISS_LIKE, SIMBA_LIKE  # noqa: E402
from repro_torch.explore import ExplorationResult  # noqa: E402
from repro_torch.models.cnn.zoo import build_cnn  # noqa: E402


def systems(mem=None):
    kw = {} if mem is None else {"mem_capacity": mem}
    port = SystemConfig([Platform("A", EYERISS_LIKE, QuantSpec(16), **kw),
                         Platform("B", SIMBA_LIKE, QuantSpec(8))],
                        [get_link("gige")])
    ref = JSystemConfig([JPlatform("A", JEYR, JQuantSpec(16), **kw),
                         JPlatform("B", JSMB, JQuantSpec(8))],
                        [jget_link("gige")])
    return port, ref


def pair(mem=None, **kw):
    port_sys, ref_sys = systems(mem)
    jkw = dict(kw)
    if "constraints" in kw:
        jkw["constraints"] = JConstraints(**kw["constraints"])
        kw["constraints"] = Constraints(**kw["constraints"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = JExplorer(jbuild_cnn("squeezenet11", in_hw=64).to_graph(),
                        ref_sys, **jkw)
        port = Explorer(build_cnn("squeezenet11", in_hw=64).to_graph(),
                        port_sys, device="cpu", **kw)
    return port, ref


def test_shim_warns_and_names_the_port():
    port_sys, _ = systems()
    with pytest.warns(DeprecationWarning, match="repro_torch.explore"):
        Explorer(build_cnn("squeezenet11", in_hw=64).to_graph(), port_sys,
                 device="cpu")


@pytest.mark.parametrize("use_nsga", [False, None])
def test_shim_front_equals_reference(use_nsga):
    objectives = ("latency", "energy", "throughput", "accuracy")
    port, ref = pair(objectives=objectives)
    want = ref.run(seed=0, use_nsga=use_nsga)
    got = port.run(seed=0, use_nsga=use_nsga)
    assert isinstance(got, ExplorationResult)
    assert got.candidates == want.candidates == port.candidate_cuts()
    assert [e.cuts for e in got.pareto] == [e.cuts for e in want.pareto]
    for a, b in zip(got.pareto, want.pareto):
        assert a.as_objectives(objectives) == b.as_objectives(objectives)
    assert got.selected.cuts == want.selected.cuts
    assert port._select(got.pareto).cuts == got.selected.cuts


def test_shim_filters_equal_reference():
    port, ref = pair(mem=40_000)
    cands = list(range(len(port.schedule) - 1))
    assert port._memory_filter(cands) == ref._memory_filter(cands)
    assert port.candidate_cuts() == ref.candidate_cuts()
    port, ref = pair(constraints={"max_link_bytes": 20_000})
    assert port._link_filter(cands) == ref._link_filter(cands)
    assert port.candidate_cuts() == ref.candidate_cuts()


def test_shim_default_device_raises_without_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port_sys, _ = systems()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ex = Explorer(build_cnn("squeezenet11", in_hw=64).to_graph(),
                      port_sys)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.run(seed=0)
