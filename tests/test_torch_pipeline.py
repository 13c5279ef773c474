"""The port's pipeline (``launch/pipeline.py``) against its monolithic
forward and against the JAX package's ``pipelined_apply``, on the CPU.

The reference's pipeline needs a mesh with a ``pod`` axis of S devices,
so it runs in a subprocess with 8 fake CPU devices (as
``tests/test_pipeline_multidev.py`` runs it), on weights it draws and
hands over (``load_reference_params``) with its inputs and logits.
Tolerances: 2e-4 against the monolithic forward (the reference test's
bound; on the CPU the stages repeat the monolithic forward's operations
and agree bit for bit), 2e-5 against the reference (float32, summed in
other orders by XLA and torch).

The reference cannot pipeline the vlm family: its stages get 2-D
positions, and M-RoPE asserts (3, B, T).  The port splits the (3, B, T)
positions per microbatch, so its pipelined vlm logits are held to the
reference's monolithic ones instead.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.launch import pipeline as jpipe  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.launch import pipeline as tpipe  # noqa: E402
from repro_torch.launch.mesh import make_stage_mesh  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import load_reference_params  # noqa: E402

torch.set_num_threads(2)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MONO_TOL = 2e-4
REF_TOL = 2e-5
B, T = 4, 16


def reduced(arch, get_config):
    return dataclasses.replace(get_config(arch).reduced(), n_layers=4)


REFERENCE = """
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.models.registry import get_config, build_model
from repro.launch.pipeline import pipelined_apply, stack_stages

out = {}
for arch in ("smollm-360m", "musicgen-large", "qwen2-vl-7b"):
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=4)
    model = build_model(cfg)
    params, state = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    if cfg.family == "audio":
        batch = {"codes": rng.integers(0, cfg.vocab, (%(B)d, cfg.n_codebooks,
                                                      %(T)d)).astype(np.int32)}
    elif cfg.family == "vlm":
        p = cfg.n_patches
        batch = {"tokens": rng.integers(0, cfg.vocab, (%(B)d, %(T)d)).astype(
                     np.int32),
                 "vision_embeds": rng.standard_normal(
                     (%(B)d, p, cfg.d_model)).astype(np.float32),
                 "positions3": np.broadcast_to(
                     np.arange(p + %(T)d)[None, None], (3, %(B)d, p + %(T)d)
                 ).astype(np.int32).copy()}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab, (%(B)d, %(T)d)).astype(
            np.int32)}
    mono, _ = model.apply(params, state, batch, train=False)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, v in flat:
        out[arch + ":param:" + "/".join(str(k.key) for k in path)] = np.asarray(v)
    for k, v in batch.items():
        out[arch + ":batch:" + k] = v
    out[arch + ":mono"] = np.asarray(mono)
    for s in (2, 4):
        devs = np.asarray(jax.devices()[:8]).reshape(s, 8 // s // 2, 2)
        mesh = Mesh(devs, ("pod", "data", "model"))
        try:
            with mesh:
                piped = pipelined_apply(model, stack_stages(params, s), batch,
                                        mesh, n_microbatches=2)
            out[arch + ":piped%%d" %% s] = np.asarray(piped)
        except AssertionError as e:
            out[arch + ":raised%%d" %% s] = np.asarray(str(e))
np.savez(sys.argv[1], **out)
""" % {"B": B, "T": T}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's weights, inputs, monolithic logits and pipelined
    logits (or the assertion it raised) of three families, S = 2 and 4,
    M = 2, from a subprocess with 8 CPU devices."""
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                          str(path)], capture_output=True, text=True,
                         timeout=600, env=env)
    assert run.returncode == 0, run.stderr
    data = dict(np.load(path))

    def of(arch):
        pre = arch + ":"
        return {k[len(pre):]: v for k, v in data.items() if k.startswith(pre)}
    return of


def port_model(arch, ref):
    """The port's reduced model on the reference's weights, and the batch."""
    model = registry.build_model(reduced(arch, registry.get_config),
                                 device="cpu")
    load_reference_params(model, {k[len("param:"):]: v for k, v in
                                  ref.items() if k.startswith("param:")})
    batch = {k[len("batch:"):]: torch.from_numpy(v) for k, v in ref.items()
             if k.startswith("batch:")}
    return model, batch


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_stack_stages_is_the_reference_reshape(n_stages):
    """Stage k's blocks hold the reference's ``stack_stages(params,
    S)["blocks_dense"][leaf][k]``, layer for layer, without a copy."""
    arch = "smollm-360m"
    jm = jreg.build_model(reduced(arch, jreg.get_config))
    params, _ = jm.init(jax.random.PRNGKey(0))
    staged = jpipe.stack_stages(params, n_stages)["blocks_dense"]
    flat = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    model = registry.build_model(reduced(arch, registry.get_config),
                                 device="cpu")
    load_reference_params(model, flat)
    stages = tpipe.stack_stages(model, n_stages)
    assert [len(s) for s in stages] == [4 // n_stages] * n_stages
    for k, stage in enumerate(stages):
        for j, blk in enumerate(stage):
            assert blk is model.blocks[k * len(stage) + j]
            for name, p in blk.named_parameters():
                leaf = staged
                for part in name.split("."):
                    leaf = leaf[part]
                np.testing.assert_array_equal(p.numpy(),
                                              np.asarray(leaf[k, j]))
    with pytest.raises(ValueError, match="do not split"):
        tpipe.stack_stages(model, 3)


@pytest.mark.parametrize("n_stages", [2, 4])
@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_pipelined_matches_monolithic(n_stages, n_micro):
    cfg = reduced("smollm-360m", registry.get_config)
    model = registry.build_model(cfg, device="cpu")
    rng = np.random.default_rng(n_stages * 10 + n_micro)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, T)))
    for batch in ({"tokens": toks},
                  {"tokens": toks, "positions": 3 + torch.arange(T).expand(
                      B, T)}):
        mono = model(batch)
        piped = tpipe.pipelined_apply(model, tpipe.stack_stages(
            model, n_stages), batch, make_stage_mesh(n_stages, "cpu"),
            n_micro)
        assert piped.shape == mono.shape
        close(piped, mono, MONO_TOL)
        assert torch.equal(piped, mono)     # the same operations, in order


@pytest.mark.parametrize("arch", ["smollm-360m", "musicgen-large"])
@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipelined_matches_reference(reference, arch, n_stages):
    ref = reference(arch)
    model, batch = port_model(arch, ref)
    piped = tpipe.pipelined_apply(model, tpipe.stack_stages(model, n_stages),
                                  batch, make_stage_mesh(n_stages, "cpu"), 2)
    close(piped, ref[f"piped{n_stages}"], REF_TOL)
    close(model(batch), ref["mono"], REF_TOL)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_vlm_pipeline_where_the_reference_asserts(reference, n_stages):
    """The reference's stages get (mb, T) positions and its M-RoPE
    asserts; the port's pipelined vlm logits equal the reference's
    monolithic ones (and the port's)."""
    ref = reference("qwen2-vl-7b")
    assert "M-RoPE" in str(ref[f"raised{n_stages}"])
    assert f"piped{n_stages}" not in ref
    model, batch = port_model("qwen2-vl-7b", ref)
    piped = tpipe.pipelined_apply(model, tpipe.stack_stages(model, n_stages),
                                  batch, make_stage_mesh(n_stages, "cpu"), 2)
    close(piped, ref["mono"], REF_TOL)
    close(piped, model(batch), MONO_TOL)


def test_pipeline_refuses_a_moe_model_and_bad_shapes():
    cfg = reduced("deepseek-moe-16b", registry.get_config)
    moe = registry.build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="moe"):
        tpipe.stack_stages(moe, 2)
    with pytest.raises(ValueError, match="moe"):
        tpipe.pipelined_apply(moe, [moe.blocks[:2], moe.blocks[2:]],
                              {"tokens": torch.zeros(2, 4, dtype=torch.long)},
                              make_stage_mesh(2, "cpu"), 1)
    dense = registry.build_model(reduced("smollm-360m", registry.get_config),
                                 device="cpu")
    toks = {"tokens": torch.zeros(3, 4, dtype=torch.long)}
    with pytest.raises(ValueError, match="microbatches"):
        tpipe.pipelined_apply(dense, tpipe.stack_stages(dense, 2), toks,
                              make_stage_mesh(2, "cpu"), 2)
    with pytest.raises(ValueError, match="stage axis"):
        tpipe.pipelined_apply(dense, tpipe.stack_stages(dense, 2), toks,
                              make_stage_mesh(4, "cpu"), 1)


@pytest.mark.parametrize("arch,seq,n_stages", [
    ("smollm-360m", 8192, 2), ("smollm-360m", 8192, 4),
    ("qwen3-14b", 4096, 2)])
def test_explorer_stage_boundary_matches_reference(arch, seq, n_stages):
    got, res = tpipe.explorer_stage_boundary(registry.get_config(arch), seq,
                                             n_stages, device="cpu")
    want, jres = jpipe.explorer_stage_boundary(jreg.get_config(arch), seq,
                                               n_stages)
    assert got == want
    assert res.strategy_used == jres.strategy_used
    assert (res.selected is None) == (jres.selected is None)
    if res.selected is not None:
        assert res.selected.cuts == jres.selected.cuts
