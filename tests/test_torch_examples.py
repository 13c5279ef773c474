"""The five example twins (``examples/*_torch.py``) on the CPU, against the
JAX package where they compute the same thing: the automotive chain and
the pod campaign at full size with the reference API's selected cuts and
fronts, the quickstart's steps 1-3 equal to the reference's and its tensor
search at a small population equivalent at the Pareto-front level, the
whole quickstart tour at small populations (fleet workers, the analyzer
gate, partitioned serving), QAT and the serve launcher at a few steps, the
command line from a clean working directory, and the default device
raising without a card."""

import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.explore as jexplore  # noqa: E402
from repro.fleet import report_fingerprint as jreport_fingerprint  # noqa: E402
from repro_torch.fleet import report_fingerprint  # noqa: E402
from test_torch_search import _no_clear_domination  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
NAMES = ("quickstart", "automotive_chain", "partition_llm_pods",
         "serve_partitioned", "train_qat")

torch.set_num_threads(1)


def load(name):
    """The example twin ``examples/<name>_torch.py`` as a module."""
    path = EXAMPLES / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_spec(spec):
    """The reference's spec of the same JSON."""
    return jexplore.ExplorationSpec.from_json(spec.to_json())


def assert_same_result(port, ref):
    """Same candidates, front and selection; metrics within the parity
    tolerance of the reference's own tests."""
    assert list(port.candidates) == list(ref.candidates)
    assert [e.cuts for e in port.pareto] == [e.cuts for e in ref.pareto]
    assert port.selected.cuts == ref.selected.cuts
    for a, b in zip(port.pareto, ref.pareto):
        np.testing.assert_allclose(
            [a.latency_s, a.energy_j, a.throughput],
            [b.latency_s, b.energy_j, b.throughput], rtol=2e-5)


def test_automotive_chain_matches_reference():
    ex = load("automotive_chain")
    results = ex.main(device="cpu")
    assert tuple(results) == ex.MODELS
    for name, res in results.items():
        assert res.strategy == "multicut"
        assert_same_result(res, jexplore.run_spec(
            reference_spec(ex.make_spec(name))))


def test_partition_llm_pods_matches_reference():
    ex = load("partition_llm_pods")
    result = ex.main(device="cpu")
    spec = ex.make_spec()
    systems = [reference_spec(dataclasses.replace(spec, system=s)).system
               for s in ex.SYSTEMS]
    ref = jexplore.Campaign(reference_spec(spec), systems=systems).run()
    assert report_fingerprint(result.report) == \
        jreport_fingerprint(ref.report)
    for a, b in zip(result.entries, ref.entries):
        assert a.system == b.system
        assert a.result.selected.cuts == b.result.selected.cuts


def test_quickstart_steps_1_to_3_match_reference(capsys):
    ex = load("quickstart")
    spec = ex.make_spec()
    jspec = reference_spec(spec)
    assert jspec.to_json() == spec.to_json()
    assert "spec: " + spec.to_json() in capsys.readouterr().out
    assert_same_result(ex.search(spec, "cpu"), jexplore.run_spec(jspec))
    _, report = ex.campaign(spec, "cpu")
    ref = jexplore.Campaign(jspec, models=[
        jexplore.ModelRef("cnn", n) for n in ("squeezenet11", "resnet50",
                                              "efficientnet_b0")]).run()
    assert report_fingerprint(report) == jreport_fingerprint(ref.report)


def test_quickstart_tensor_search_front_matches_reference_jit():
    """Step 4 at population 128 x 20: ``torch_nsga2`` and the reference's
    ``jit_nsga2`` reach equivalent fronts (they differ by RNG), by
    ``tests/test_torch_search.py``'s criterion."""
    ex = load("quickstart")
    spec = ex.make_spec()
    res_t = ex.tensor_search(spec, "cpu", pop_size=128, n_gen=20)
    assert res_t.strategy_used == "torch_nsga2"
    res_j = jexplore.run_spec(dataclasses.replace(
        reference_spec(spec), search=jexplore.SearchSettings(
            strategy="jit_nsga2", pop_size=128, n_gen=20)))
    objectives = spec.objectives
    Ft = np.array([e.as_objectives(objectives) for e in res_t.pareto])
    Fj = np.array([e.as_objectives(objectives) for e in res_j.pareto])
    scale = np.ptp(np.concatenate([Ft, Fj]), axis=0) + 1e-12
    _no_clear_domination(Ft, Fj, scale)
    _no_clear_domination(Fj, Ft, scale)
    assert (np.abs(Ft.min(axis=0) - Fj.min(axis=0)) <= 0.08 * scale).all()


def test_quickstart_tour_runs_on_the_cpu(capsys):
    """Steps 1-8 with steps 4-5 at small populations: the fleet's two
    worker processes on the CPU merge to the serial report, the analyzer
    gate exits 0, every request is served, and no kernel launches on the
    CPU."""
    load("quickstart").main(device="cpu", pop_size=64, n_gen=3,
                            scale_pop=64, scale_gen=2)
    out = capsys.readouterr().out
    assert "fleet merged report == serial campaign report" in out
    assert "0 finding(s)" in out
    assert "serve: 8 request(s)" in out
    for step in (4, 5):
        assert (f'step {step} kernel launches: {{"packed_domination": 0, '
                f'"domination_counts": 0}}') in out


def test_train_qat_runs_and_recovers():
    """50 training and 8 QAT steps (the example's defaults are 300 and
    80): the float model learns, and the example's gates hold."""
    acc_fp, acc_q, acc_qat = load("train_qat").main(device="cpu", steps=50,
                                                    qat_steps=8)
    assert acc_fp > 0.15                     # chance = 0.10
    assert acc_qat >= acc_q


def test_serve_partitioned_serves_every_request(capsys):
    assert load("serve_partitioned").main(device="cpu", warm_steps=2) == 0
    out = capsys.readouterr().out
    assert "8 request(s)" in out and "dropped" not in out


def test_example_command_line_from_a_clean_directory(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(EXAMPLES / "partition_llm_pods_torch.py"),
         "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "4pods over dci:" in out.stdout
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("name", NAMES)
def test_default_device_raises_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(name).main()
