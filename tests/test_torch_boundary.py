"""The import boundary of the port: nothing under ``src/repro_torch``, in
the example twins ``examples/*_torch.py`` or in ``chip_smoke.py``,
``chip_profile.py``, ``chip_variants.py`` or
``tools/cuda_host_shim/rehearse.py`` imports JAX or the JAX package
``repro``, and a CPU search, an LM generation, an SSM forward and
generation, a CNN's measured accuracy, an online re-partition, a
two-cell campaign, a served burst, a train step, a checkpoint, a
DeepSeek-V3 (MoE, MLA, MTP) train step and generation and the deprecated
``Explorer`` run in a process where JAX cannot be imported at all."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _files():
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert len(examples) == 5, examples
    files = sorted(PORT.rglob("*.py")) + examples + [
        ROOT / "chip_smoke.py", ROOT / "chip_profile.py",
        ROOT / "chip_variants.py",
        ROOT / "tools" / "cuda_host_shim" / "rehearse.py"]
    assert len(files) > 20 and all(f.exists() for f in files)
    return files


def _violations(path: Path, root: Path = ROOT):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif isinstance(node, ast.Attribute) and isinstance(
                node.value, ast.Name) and node.value.id in FORBIDDEN:
            names = [node.value.id]                    # e.g. jax.numpy
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names = [str(node.args[0].value)]
        else:
            continue
        bad += [f"{path.relative_to(root)}:{node.lineno}: {n}" for n in names
                if n.split(".")[0] in FORBIDDEN]
    return bad


def test_no_jax_or_repro_imports():
    bad = [v for f in _files() for v in _violations(f)]
    assert not bad, "\n".join(bad)


def test_scanner_catches_forbidden_imports(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\nfrom repro.core import graph\n"
                 "import repro_torch\nx = jax.jit\n")
    got = [v.split(": ")[1] for v in _violations(p, tmp_path)]
    assert sorted(got) == ["jax", "jax.numpy", "repro.core"]


def test_cpu_search_runs_with_jax_blocked():
    code = """
        import dataclasses
        import sys
        sys.modules["jax"] = None          # any `import jax` now fails
        import numpy as np
        import repro_torch
        from repro_torch.explore import (ExplorationSpec, ModelRef,
                                         PlatformSpec, SearchSettings,
                                         SystemSpec, run_spec)
        spec = ExplorationSpec(
            model=ModelRef("cnn", "efficientnet_b0", {"in_hw": 64}),
            system=SystemSpec(
                platforms=(PlatformSpec("cam0", "eyr", bits=16),
                           PlatformSpec("cam1", "eyr", bits=16),
                           PlatformSpec("edge", "smb", bits=8),
                           PlatformSpec("central", "smb", bits=8)),
                links=("gige", "gige", "gige")),
            objectives=("latency", "energy", "throughput"),
            search=SearchSettings(strategy="torch_nsga2", pop_size=32,
                                  n_gen=2, seed=0))
        res = run_spec(spec, device="cpu")
        assert res.strategy_used == "torch_nsga2" and res.pareto
        from repro_torch.models.registry import build_model, get_config
        from repro_torch.serving import GenerationEngine
        model = build_model(get_config("smollm-360m").reduced(), device="cpu")
        gen = GenerationEngine(model, max_seq=16).generate(
            np.zeros((1, 4), np.int64), max_new=2)
        assert gen.tokens.shape == (1, 2)
        ssm = build_model(get_config("mamba2-370m").reduced(), device="cpu")
        logits = ssm({"tokens": np.zeros((1, 40), np.int64)}, impl="auto")
        assert logits.shape == (1, 40, 512)
        gen = GenerationEngine(ssm, max_seq=16).generate(
            np.zeros((1, 4), np.int64), max_new=3)
        assert gen.tokens.shape == (1, 3)
        from repro_torch.core.graph import linearize
        from repro_torch.core.quant import QuantSpec
        from repro_torch.data import SyntheticImages
        from repro_torch.models.cnn.zoo import reduced_cnn
        from repro_torch.quantize import cnn_measured_accuracy
        cnn = reduced_cnn("efficientnet_b0").init_weights(device="cpu")
        vx, vy = SyntheticImages(n_classes=10, hw=32).eval_set(8)
        acc = cnn_measured_accuracy(cnn, linearize(cnn.to_graph()), vx, vy,
                                    [QuantSpec(16), QuantSpec(8)])((40,))
        assert 0.0 <= acc <= 1.0
        from repro_torch.explore import (Campaign, OnlineRepartitioner,
                                         degrade_link)
        small = dataclasses.replace(
            spec, model=ModelRef("cnn", "squeezenet11", {"in_hw": 64}),
            search=SearchSettings(strategy="torch_nsga2", pop_size=16,
                                  n_gen=1, seed=0))
        rp = OnlineRepartitioner(small, device="cpu")
        d = rp.update(degrade_link(small.system, 0, 4.0))
        assert d.strategy_used == "torch_nsga2" and d.cuts is not None
        camp = Campaign(small, models=[small.model, ModelRef(
            "cnn", "vgg16", {"in_hw": 64})]).run(device="cpu")
        assert len(camp.report.entries) == 2
        from repro_torch.serve import (PipelineServeEngine, ReplicaRouter,
                                       poisson_traffic)
        from repro_torch.serving import PartitionedLMRunner
        served = ReplicaRouter([PipelineServeEngine(
            PartitionedLMRunner(model, [0]), n_slots=2, n_groups=1,
            capacity=16)]).serve(poisson_traffic(
                2, rate_rps=1000.0, vocab=512, prompt_len=4, max_new=2),
            realtime=False)
        assert served.n_done == 2 and served.total_tokens == 4
        from repro_torch.checkpoint import restore, save
        from repro_torch.data.synthetic import make_batch_for
        from repro_torch.models.convert import reference_params
        from repro_torch.optim import adamw
        from repro_torch.training import init_params, make_train_step
        import tempfile
        opt = adamw(1e-3)
        state, m = make_train_step(model, model.cfg, opt)(
            opt.init(init_params(model)), make_batch_for(model.cfg, 2, 8))
        assert np.isfinite(float(m["loss"]))
        with tempfile.TemporaryDirectory() as tmp:
            save(tmp, {"params": reference_params(model), "opt": state}, 1)
            assert restore(tmp, {"opt": state})["opt"]["step"] == 1
        v3 = build_model(get_config("deepseek-v3-671b").reduced(),
                         device="cpu")
        opt = adamw(1e-3)
        _, m = make_train_step(v3, v3.cfg, opt)(
            opt.init(init_params(v3)), make_batch_for(v3.cfg, 2, 8))
        assert {"lb_loss", "mtp"} <= set(m) and np.isfinite(float(m["loss"]))
        gen = GenerationEngine(v3, max_seq=16).generate(
            np.zeros((2, 4), np.int64), max_new=2)
        assert gen.tokens.shape == (2, 2)
        import warnings
        from repro_torch.core import Explorer
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            ex = Explorer(small.model.build()[0], small.system.build(),
                          device="cpu")
        assert ex.run(seed=0).pareto
        leaked = sorted(m for m in sys.modules
                        if m == "repro" or m.startswith("repro."))
        assert not leaked, leaked
        print("BOUNDARY_OK")
    """
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=str(ROOT))
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    assert "BOUNDARY_OK" in out.stdout
