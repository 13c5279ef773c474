"""The harness finds every piece by name, counts work as a hand count
does, keeps the yardstick's references free of the program and of JAX,
and its plain references agree with the program at a small size."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench.lib import harness, work

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


# -- found by name -------------------------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    w, cell, config = harness.cell_files(name)
    assert cell["config"] == w["config"] and cell["why"] == w["why"]
    assert cell["traffic"]["name"] == w["traffic"]
    drv = harness.driver_module(cell["driver"])
    for fn in ("setup", "window", "check"):
        assert callable(getattr(drv, fn))
    e2e = harness.cell_metrics(BENCHMARK, name, "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    per_layer = harness.cell_metrics(BENCHMARK, name, "per_layer")
    assert per_layer
    for m in per_layer:
        assert callable(harness.metric_module(m["name"]).read)


def test_configs_files_and_names():
    for c in BENCHMARK["configs"]:
        assert c["file"] == f"bench/configs/{c['name']}.json"
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    names = [m["name"] for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_new_cell_found_without_edit(tmp_path):
    """A cell, traffic and metric added as new files (and entries) only."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = "oracle.effnetb0-4plat.repeats"
    bench["workloads"].append({"name": name, "config": "effnetb0-4plat",
                               "traffic": "repeats", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "oracle_cutvecs_per_s":
            m["workloads"].append(name)
    bench["per_layer"].append({"name": "cache_hits.oracle", "unit": "%",
                               "better": "higher", "source": "program_counter",
                               "layer": "oracle cache",
                               "moves": "oracle_cutvecs_per_s",
                               "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = json.loads((BENCH / "cells" / "oracle.effnetb0-4plat.distinct.json")
                      .read_text())
    cell["traffic"]["name"] = "repeats"
    (root / "bench" / "cells" / f"{name}.json").write_text(json.dumps(cell))
    (root / "bench" / "metrics" / "cache_hits.oracle.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    w, got, config = harness.cell_files(name, root)
    assert got["traffic"]["name"] == "repeats"
    assert config["name"] == "effnetb0-4plat"
    bench2 = harness.load_benchmark(root)
    assert [m["name"] for m in harness.cell_metrics(bench2, name, "per_layer")
            ] == ["cache_hits.oracle"]
    assert {m["name"] for m in harness.cell_metrics(bench2, name, "end_to_end")
            } == {"oracle_cutvecs_per_s", "setup_s"}
    assert harness.metric_module("cache_hits.oracle", root).read(None) == 1.0


# -- counts against hand counts ---------------------------------------------------

def test_domination_counts_hand_count():
    # 3 objectives; rows: 2 feasible of 5; cols: 3 feasible of 4
    assert work.domination_ops(3, 2, 5, 3, 4) == 2 * 3 * 6 + 3 * 1 + 5 + 4
    assert work.packed_domination_bytes(33, 4, 3) == 4 * (37 * 4 + 2 * 4)


def test_domination_ops_match_the_plain_test():
    """The compares counted are those the plain Deb test makes."""
    rng = np.random.default_rng(0)
    F = rng.random((40, 3)).astype(np.float32)
    CV = np.where(rng.random(40) < 0.3, 1.0, 0.0).astype(np.float32)
    feas = int((CV <= 0).sum())
    ops = 0
    for i in range(40):
        for j in range(40):
            fi, fj = CV[i] <= 0, CV[j] <= 0
            ops += 2 * 3 if fi and fj else (1 if not fi and not fj else 0)
    assert work.domination_ops(3, feas, 40, feas, 40) == ops + 80


def test_effnet_flops_match_the_graph():
    from bench.reference.costmodel.cnn_graph import effnet_b0_graph
    cfg = json.loads((BENCH / "configs" / "effnetb0-4plat.json").read_text())
    graph, _ = effnet_b0_graph(224)
    macs = sum(l.macs for l in graph.nodes.values())
    assert work.effnet_flops_per_image(cfg) == 2 * macs
    assert 0.38e9 < macs < 0.41e9          # EfficientNet-B0's 0.39 GMACs


# -- the yardstick imports neither JAX, the JAX package, nor (in the
#    references) the program -----------------------------------------------------

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _closure(paths):
    """Top-level names imported by ``paths`` and by every bench module
    they import, transitively."""
    seen, names, todo = set(), set(), list(paths)
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        for mod in _imports(p):
            names.add(mod.split(".")[0])
            if mod.split(".")[0] == "bench":
                parts = mod.split(".")
                cand = ROOT.joinpath(*parts).with_suffix(".py")
                pkg = ROOT.joinpath(*parts, "__init__.py")
                todo += [c for c in (cand, pkg) if c.exists()]
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
    assert "repro_torch".split(".")[0] not in FORBIDDEN


def test_references_import_no_program():
    refs = list((BENCH / "reference").rglob("*.py"))
    names = _closure(refs)
    assert not names & (FORBIDDEN | {"repro_torch"}), names


def test_references_load_with_the_program_blocked():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "for m in ('repro_torch', 'repro', 'jax', 'jaxlib', 'flax'):\n"
            "    sys.modules[m] = None\n"
            "import bench.reference.effnet, bench.reference.precision\n"
            "import bench.reference.pareto\n"
            "import bench.reference.costmodel.evaluate\n"
            "import bench.reference.costmodel.cnn_graph\n" % str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_run_refuses_without_a_card(tmp_path):
    """No result line and a non-zero exit without CUDA, also in a
    directory that holds only BENCHMARK.json and the benchmark."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
            shutil.copytree(BENCH, tmp_path / "bench",
                            ignore=shutil.ignore_patterns("__pycache__"))
        p = subprocess.run(
            [sys.executable, "bench/run.py", "--workload", CELLS[0],
             "--seed", "1", "--seconds", "1", "--trace", "0"],
            cwd=cwd, capture_output=True, text=True, timeout=300)
        assert p.returncode != 0 and p.stdout.strip() == ""


# -- the plain references agree with the program at a small size ----------------

def test_cost_model_copy_matches_the_program():
    from bench.reference.costmodel.cnn_graph import cut_to_block, effnet_b0_graph
    from bench.reference.costmodel.evaluate import build_chain, evaluate
    from repro_torch.core.graph import linearize
    from repro_torch.core.partition import PartitionEvaluator
    from repro_torch.explore import PlatformSpec, SystemSpec
    from repro_torch.models.cnn.zoo import build_cnn
    cfg = json.loads((BENCH / "configs" / "effnetb0-4plat.json").read_text())
    graph, ends = effnet_b0_graph(224)
    chain = build_chain(graph, cfg["platforms"], cfg["links"],
                        cfg["schedule_policy"])
    model = build_cnn("efficientnet_b0", in_hw=224, w=1.0, n_classes=1000)
    pgraph = model.to_graph()
    psched = linearize(pgraph, "min_memory")
    assert [l.name for l in psched] == [l.name for l in chain.schedule]
    assert len(psched) == 207
    system = SystemSpec(tuple(PlatformSpec(p["name"], p["arch"], bits=p["bits"])
                              for p in cfg["platforms"]),
                        tuple(cfg["links"])).build()
    ev = PartitionEvaluator(pgraph, psched, system)
    rng = np.random.default_rng(3)
    cuts = np.sort(rng.integers(-1, 207, size=(200, 3)), axis=1)
    got = ev.evaluate_batch(cuts).to_evals()
    for c, g in zip(cuts, got):
        r = evaluate(chain, c)
        assert g.memory_bytes == tuple(r["memory_bytes"])
        assert g.link_bytes == r["link_bytes"]
        np.testing.assert_allclose(
            [g.latency_s, g.energy_j, g.throughput, g.violation],
            [r["latency_s"], r["energy_j"], r["throughput"], r["violation"]],
            rtol=1e-12, atol=1e-300)
        assert all(cut_to_block(chain.schedule, ends, int(x))
                   == model.cut_to_block(psched, int(x)) for x in c if x >= 0)


def test_population_scoring_matches_the_layer_sums():
    """The population's plain scores (running sums) agree with the front's
    (layer sums) to rounding, and in memory, bytes and violation exactly."""
    from bench.drivers.search import _chain
    from bench.reference.costmodel.evaluate import evaluate, evaluate_many
    cfg = json.loads((BENCH / "configs" / "effnetb0-4plat.json").read_text())
    chain = _chain(cfg)
    rng = np.random.default_rng(4)
    cuts = np.sort(rng.integers(-1, 207, size=(300, 3)), axis=1)
    cuts[:30, 1] = cuts[:30, 0]                # empty middle platforms
    cuts[30:60, 2] = 206                       # the last platform idle
    many = evaluate_many(chain, cuts)
    for i, c in enumerate(cuts):
        r = evaluate(chain, c)
        assert list(many["memory_bytes"][i]) == list(r["memory_bytes"])
        assert many["link_bytes"][i] == r["link_bytes"]
        assert many["violation"][i] == r["violation"]
        np.testing.assert_allclose(
            [many[k][i] for k in ("latency_s", "energy_j", "throughput")],
            [r[k] for k in ("latency_s", "energy_j", "throughput")],
            rtol=1e-13)


def test_candidate_table_matches_the_program():
    from bench.drivers.search import _chain
    from bench.reference.costmodel.evaluate import candidates
    from repro_torch.core.graph import linearize
    from repro_torch.core.partition import PartitionEvaluator
    from repro_torch.explore import PlatformSpec, SystemSpec
    from repro_torch.explore.filters import candidate_positions
    from repro_torch.models.cnn.zoo import build_cnn
    cfg = json.loads((BENCH / "configs" / "effnetb0-4plat.json").read_text())
    pgraph = build_cnn("efficientnet_b0", in_hw=224, w=1.0,
                       n_classes=1000).to_graph()
    system = SystemSpec(tuple(PlatformSpec(p["name"], p["arch"], bits=p["bits"])
                              for p in cfg["platforms"]),
                        tuple(cfg["links"])).build()
    ev = PartitionEvaluator(pgraph, linearize(pgraph, "min_memory"), system)
    assert candidates(_chain(cfg)) == candidate_positions(ev)


def test_front_diff_reads_ties_and_misses():
    """Two cut vectors whose values differ by rounding are one point; a
    front member another row beats, a row left out, and an infeasible
    member beside feasible rows each count once."""
    from bench.reference.pareto import front_diff
    C = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3], [2, 3, 4]])
    F = np.array([[1.0, 4.0], [1.0 + 1e-15, 4.0], [2.0, 2.0], [3.0, 3.0],
                  [0.5, 0.5]])
    V = np.array([0.0, 0.0, 0.0, 0.0, 1.0])
    front = {(0, 1, 2), (0, 2, 3)}
    assert front_diff(C, F, V, front, 1e-10) == 0
    assert front_diff(C, F, V, front | {(0, 1, 3)}, 1e-10) == 0
    assert front_diff(C, F, V, {(0, 1, 2)}, 1e-10) == 1        # (0,2,3) out
    assert front_diff(C, F, V, front | {(1, 2, 3)}, 1e-10) == 1  # beaten
    assert front_diff(C, F, V, front | {(2, 3, 4)}, 1e-10) == 1  # infeasible
    assert front_diff(C, F, V, front | {(9, 9, 9)}, 1e-10) == 1  # not there
    # without the tolerance the twin (0, 1, 3) is beaten by (0, 1, 2)
    assert front_diff(C, F, V, front | {(0, 1, 3)}, 0.0) == 1


def test_effnet_reference_matches_the_oracle():
    from bench.lib.models import build_cnn, cnn_inputs
    from bench.reference.effnet import Partitioned
    from bench.tests.small import OVERRIDES
    from repro_torch.core.graph import linearize
    from repro_torch.core.quant import QuantSpec
    from repro_torch.quantize.evaluate import cnn_measured_accuracy
    cfg = dict(json.loads((BENCH / "configs" / "effnetb0-4plat.json")
                          .read_text()),
               **OVERRIDES["oracle.effnetb0-4plat.distinct"]["config"])
    t = OVERRIDES["oracle.effnetb0-4plat.distinct"]["cell"]["traffic"]
    w, images, labels = cnn_inputs(cfg, t, 3, "cpu")
    model = build_cnn(cfg, w, "cpu")
    sched = linearize(model.to_graph(), "min_memory")
    measure = cnn_measured_accuracy(
        model, sched, images, labels,
        [QuantSpec(bits=p["bits"]) for p in cfg["platforms"]])
    ref = Partitioned(cfg)
    w2, images2, labels2 = cnn_inputs(cfg, t, 3, "cpu")
    for cuts in [(-1, -1, -1), (10, 80, 150), (0, 0, 206), (40, 41, 42),
                 (100, 150, 206)]:
        assert measure(cuts) == ref.accuracy(w2, images2, labels2, cuts)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "reprox", types.ModuleType("reprox"))
    assert "reprox" not in harness.forbidden_modules()
    assert not [m for m in harness.forbidden_modules()
                if m.startswith("repro_torch")]
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert "repro.core" in harness.forbidden_modules()


def test_run_refuses_once_jax_is_loaded(monkeypatch):
    import types

    from bench.tests.small import run_small
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit, match="jax"):
        run_small("oracle.effnetb0-4plat.distinct")


def test_trace_busy_union_and_idle_gaps():
    """Two streams overlapping count once; an idle gap is named by the
    latest-starting host operation running at its middle."""
    from bench.lib.trace import Trace
    ev = [
        {"cat": "kernel", "name": "k1", "ts": 0, "dur": 10, "ph": "X"},
        {"cat": "kernel", "name": "k2", "ts": 5, "dur": 10, "ph": "X"},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)",
         "ts": 40, "dur": 5, "ph": "X"},
        {"cat": "kernel", "name": "k1", "ts": 100, "dur": 20, "ph": "X"},
        {"cat": "cpu_op", "name": "outer", "ts": 0, "dur": 200, "ph": "X"},
        {"cat": "cpu_op", "name": "aten::item", "ts": 16, "dur": 30,
         "ph": "X"},
    ]
    tr = Trace(ev, window_s=200e-6)
    assert tr.busy_intervals() == [(0.0, 15.0), (40.0, 45.0), (100.0, 120.0)]
    assert tr.busy_s == pytest.approx(40e-6)
    assert tr.device_to_host_copies() == 1
    assert tr.device_ops()[0] == ["k1", pytest.approx(30e-6)]
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::item"] == pytest.approx(25e-6)      # 15 .. 40
    assert gaps["outer"] == pytest.approx(55e-6)           # 45 .. 100
