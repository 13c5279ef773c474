"""The port's pod tooling (``nn/sharding.py``, ``launch/{mesh,rules,specs,
steps,hlo_analysis,roofline,dryrun,diagnose,hillclimb_capture}.py``)
against the JAX package on the CPU, and the two rule-driven options the
models read (``softmax_low``, ``remat_dots``).

Specs are compared as strings (the port's ``PartitionSpec`` prints as
JAX's), shardings spec for spec over the reference's logical 16 x 16 and
2 x 16 x 16 meshes (``jax.sharding.AbstractMesh`` on the reference's
side), argument stand-ins leaf for leaf (path, shape, dtype) against the
reference's ``jax.eval_shape`` leaves on reduced configs of every family.
The dispatch counter's FLOPs of a reduced smollm-360m train, prefill and
decode step are held to the reference's loop-aware HLO analysis on a
one-CPU host mesh within 2 %; they agree exactly, because both count
the same matrix products (no convolution, and XLA rewrote no product
here) and neither counts elementwise work.  Write bytes are not compared:
XLA's estimate counts only materialising ops after fusion, the port's
every op of an eager step.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs.base import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch import rules as jrules  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn import sharding as jshd  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES, ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun, hillclimb_capture  # noqa: E402
from repro_torch.launch import hlo_analysis as hlo  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.launch import rules  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.diagnose import diagnose  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import (load_reference_params,  # noqa: E402
                                        reference_leaves)
from repro_torch.nn import attention as tattn  # noqa: E402
from repro_torch.nn import sharding as shd  # noqa: E402

torch.set_num_threads(2)

# one config of every family, each with its features (MLA and MTP on the
# moe one, the hybrid's shared block, the audio codebooks, M-RoPE)
FAMILIES = {"dense": "smollm-360m", "moe": "deepseek-v3-671b",
            "ssm": "mamba2-370m", "hybrid": "zamba2-2.7b",
            "audio": "musicgen-large", "vlm": "qwen2-vl-7b"}
KINDS = ("train", "prefill", "decode")


def jpaths(tree):
    """A JAX pytree's leaves by their '/'-joined path."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in leaves}


def tpaths(tree):
    """A port tree's leaves by their '/'-joined path."""
    out = {}
    rules.tree_map_with_path(lambda p, leaf: out.__setitem__(p, leaf), tree)
    return out


def jdtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def logical_meshes():
    return [(False, shd.Mesh(("data", "model"), (16, 16)),
             AbstractMesh((16, 16), ("data", "model"))),
            (True, shd.Mesh(("pod", "data", "model"), (2, 16, 16)),
             AbstractMesh((2, 16, 16), ("pod", "data", "model")))]


@pytest.fixture(autouse=True)
def no_rules_left():
    """Every test starts and ends with no mesh and no rules installed, in
    either package."""
    yield
    shd.set_mesh(None)
    jshd.set_mesh(None)


# -- nn/sharding.py and launch/mesh.py ----------------------------------------

def test_partition_spec_prints_and_compares_as_jax():
    from jax.sharding import PartitionSpec as JP
    for parts in ((), (None,), ("data", None), (("pod", "data"), None, "model")):
        assert str(shd.P(*parts)) == str(JP(*parts))
        assert shd.P(*parts) == tuple(parts)
    assert shd.DEFAULT_RULES == jshd.DEFAULT_RULES
    assert shd.MULTIPOD_RULES == jshd.MULTIPOD_RULES


@pytest.mark.parametrize("axes", [("batch", "seq", "embed"),
                                  ("batch", "seq", "act_embed"),
                                  ("embed", "vocab"), ("vocab", "embed"),
                                  ("layers", "embed", "mlp"),
                                  ("batch", None, "heads", None),
                                  ("experts", "embed", "mlp"),
                                  ("batch", "kv_seq", "kv_heads", None)])
@pytest.mark.parametrize("opts", [(), ("fsdp",), ("expert_ep",),
                                  ("attn_heads", "mla_latent")])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_logical_to_spec_matches_reference(axes, opts, multi_pod):
    table = jrules.activation_rules("train", multi_pod, True, opts)
    assert str(shd.logical_to_spec(axes, table)) == str(
        jshd.logical_to_spec(axes, table))


def test_logical_to_spec_dedup():
    # the reference's case (tests/test_hlo_and_rules.py)
    table = dict(shd.DEFAULT_RULES, batch=("pod", "data"), embed="data")
    spec = shd.logical_to_spec(("batch", "seq", "embed"), table)
    assert spec[0] == ("pod", "data")
    assert spec[2] is None


def test_mesh_context_axis_size_and_identity_hints():
    x = torch.ones(2, 3)
    assert shd.current_mesh() is None and shd.axis_size("batch") == 1
    assert shd.shard(x, ("batch",)) is x        # no mesh: nothing checked
    assert shd.named_sharding(("batch", None)) is None
    mesh = tmesh.make_production_mesh(multi_pod=True)
    table = rules.activation_rules("train", True, True, ("softmax_low",))
    with shd.mesh_context(mesh, table):
        assert shd.current_rules() == table
        assert shd.axis_size("batch") == 32 and shd.axis_size("seq") == 16
        assert shd.shard(x, ("batch", "seq")) is x
        with pytest.raises(ValueError, match="logical axes"):
            shd.shard(x, ("batch",))
        ns = shd.named_sharding(("batch", "embed"))
        assert str(ns.spec) == "PartitionSpec(('pod', 'data'), None)"
        assert ns.shard_count() == 32
    assert shd.current_mesh() is None
    assert shd.current_rules() == shd.DEFAULT_RULES


def test_meshes():
    for multi_pod in (False, True):
        got = tmesh.make_production_mesh(multi_pod=multi_pod)
        shape = (2, 16, 16) if multi_pod else (16, 16)
        want = AbstractMesh(shape, ("pod", "data", "model")[-len(shape):])
        assert got.shape == dict(want.shape) and got.devices is None
        assert got.size == int(np.prod(shape))
        with pytest.raises(ValueError, match="logical"):
            got.axis_devices("data")
    host = tmesh.make_host_mesh(device="cpu")
    jhost = jmesh.make_host_mesh()
    assert host.shape == dict(jhost.shape)
    assert host.devices == (torch.device("cpu"),)
    stages = tmesh.make_stage_mesh(4, device="cpu")
    assert stages.shape == {"pod": 4, "data": 1, "model": 1}
    assert stages.axis_devices("pod") == (torch.device("cpu"),) * 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_host_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_stage_mesh(2)


def test_shard_map_runs_only_on_a_mesh_of_one_device():
    def f(x):
        return x + 1
    one = tmesh.make_host_mesh(device="cpu")
    g = shd.shard_map(f, mesh=one, in_specs=(shd.P(),), out_specs=shd.P(),
                      check_vma=False)
    assert torch.equal(g(torch.zeros(3)), torch.ones(3))
    with pytest.raises(ValueError, match="one device"):
        shd.shard_map(f, mesh=tmesh.make_production_mesh(),
                      in_specs=(shd.P(),), out_specs=shd.P())


# -- launch/rules.py ------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("divisible", [False, True])
def test_activation_rules_match_reference_for_every_opt(kind, multi_pod,
                                                        divisible):
    for opts in [()] + [(o,) for o in dryrun.OPTS] + [tuple(dryrun.OPTS)]:
        got = rules.activation_rules(kind, multi_pod, divisible, opts)
        want = jrules.activation_rules(kind, multi_pod, divisible, opts)
        assert got == want, opts


def test_param_spec_paths():
    # the reference's cases (tests/test_hlo_and_rules.py), and its answers
    cases = [(("blocks_dense/attn/wq", 3), {}), (("blocks_dense/moe/w_gate", 4), {}),
             (("embed", 2), {}), (("blocks_dense/ln1", 2), {}),
             (("blocks/mixer/w_in", 4), {"hybrid": True}),
             (("shared/attn/wq", 2), {}), (("blocks_dense/mlp/w_gate", 3), {}),
             (("blocks_moe/moe/w_down", 4), {})]
    for args, kw in cases:
        assert str(rules.param_spec(*args, **kw)) == str(
            jrules.param_spec(*args, **kw))
    assert rules.param_spec("blocks_dense/attn/wq", 3) == (None, "data",
                                                           "model")
    assert rules.param_spec("blocks_moe/moe/w_down", 4) == (None, "model",
                                                            None, "data")


@pytest.mark.parametrize("shape", [(10, 10), (16, 48), (32, 8, 4), (7,)])
def test_divides_clears_nondivisible(shape):
    one = tmesh.make_host_mesh(device="cpu")
    assert rules._divides((10, 10), shd.P("data", "model"), one) == \
        ("data", "model")                  # 1 divides everything
    for _, tm, jm in logical_meshes():
        for spec in (("data", "model"), (("data", "model"), None),
                     ("model", None, "data"), (None,)):
            got = rules._divides(shape, shd.P(*spec), tm)
            want = jrules._divides(shape, jax.sharding.PartitionSpec(*spec),
                                   jm)
            assert str(got) == str(want)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_param_spec_of_every_leaf_matches_reference(family):
    cfg = registry.get_config(FAMILIES[family])
    model = registry.build_model(cfg, device="meta")
    hybrid = family == "hybrid"
    jparams, _ = jax.eval_shape(jreg.build_model(jreg.get_config(
        FAMILIES[family])).init, jax.random.PRNGKey(0))
    want = jpaths(jparams)
    got = reference_leaves(model)
    assert set(got) == set(want)
    for key, leaf in got.items():
        assert leaf.shape == want[key].shape, key
        assert str(rules.param_spec(key, len(leaf.shape), hybrid)) == str(
            jrules.param_spec(key, len(leaf.shape), hybrid)), key


def reference_setup_shapes(kind, arch, shape):
    """The reference's (run config, params, batch, caches) shape trees of
    one pair, as ``jax.eval_shape`` gives them (no mesh needed)."""
    cfg = jspecs.run_config(jreg.get_config(arch), shape)
    model = jreg.build_model(cfg)
    params, _ = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    if kind == "decode":
        cap = jspecs.cache_capacity(cfg, shape)
        caches = jax.eval_shape(lambda: model.init_caches(
            shape.global_batch, cap, jnp.bfloat16))
        return params, jspecs.decode_specs(cfg, shape), caches
    batch = jspecs.input_specs(cfg, shape)
    if kind == "prefill":
        batch.pop("labels")
    return params, batch, None


@pytest.mark.parametrize("arch,shape_name", [
    ("smollm-360m", "train_4k"), ("deepseek-v3-671b", "decode_32k"),
    ("deepseek-moe-16b", "prefill_32k"), ("zamba2-2.7b", "decode_32k"),
    ("mamba2-370m", "long_500k"), ("qwen2-vl-7b", "train_4k"),
    ("musicgen-large", "decode_32k"), ("qwen2-72b", "decode_32k")])
@pytest.mark.parametrize("opts", [(), ("expert_ep", "mla_latent")])
def test_shardings_match_reference_on_the_pod_meshes(arch, shape_name, opts):
    """params_shardings (of the parameters and of the optimizer state),
    batch_shardings and cache_shardings at full size, spec for spec."""
    shape = INPUT_SHAPES[shape_name]
    jshape = JSHAPES[shape_name]
    for multi_pod, tm, jm in logical_meshes():
        nb = tm.shape.get("pod", 1) * tm.shape["data"]
        table = rules.activation_rules(shape.kind, multi_pod,
                                       shape.global_batch % nb == 0, opts)
        jparams, jbatch, jcaches = reference_setup_shapes(shape.kind, arch,
                                                          jshape)
        jshd.set_mesh(jm, table)
        hybrid = registry.get_config(arch).family == "hybrid"
        want = {"p": jpaths(jrules.params_shardings(jparams, jm, hybrid)),
                "b": jpaths(jrules.batch_shardings(
                    jbatch, jm, multi_pod, shape.global_batch))}
        if jcaches is not None:
            want["c"] = jpaths(jrules.cache_shardings(
                jcaches, jm, multi_pod, shape.global_batch))
        jshd.set_mesh(None)
        with shd.mesh_context(tm, table):
            setup = steps.build_setup(shape.kind, registry.get_config(arch),
                                      shape, tm, multi_pod)
        got = {"p": tpaths(setup.in_shardings[0]),
               "b": tpaths(setup.in_shardings[-1])}
        if jcaches is not None:
            got["c"] = tpaths(setup.in_shardings[1])
        if shape.kind == "train":
            # the optimizer state's leaves take the parameters' specs
            opt = {k.split("/", 1)[1]: s for k, s in
                   tpaths(setup.in_shardings[1]).items() if "/" in k}
            assert opt and all(str(s.spec) == str(got["p"][k].spec)
                               for k, s in opt.items() if k in got["p"])
        for part in want:
            assert set(got[part]) == set(want[part]), part
            for k in want[part]:
                assert str(got[part][k].spec) == str(want[part][k].spec), \
                    (multi_pod, part, k)


def test_per_device_bytes_are_exact():
    mesh = tmesh.make_production_mesh()
    shapes = {"w": specs.stand_in((64, 48), torch.float32),
              "b": specs.stand_in((10,), torch.bfloat16)}
    shard = {"w": shd.NamedSharding(mesh, shd.P("data", "model")),
             "b": shd.NamedSharding(mesh, shd.P(None))}
    assert rules.per_device_bytes(shapes, shard) == 64 * 48 * 4 // 256 + 20


# -- launch/specs.py and launch/steps.py ----------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
def test_input_and_decode_specs_match_reference(family, shape_name):
    cfg = registry.get_config(FAMILIES[family])
    jcfg = jreg.get_config(FAMILIES[family])
    shape, jshape = INPUT_SHAPES[shape_name], JSHAPES[shape_name]
    got = dataclasses.asdict(specs.run_config(cfg, shape))
    want = dataclasses.asdict(jspecs.run_config(jcfg, jshape))
    # the port's own config fields (configs/base.py) hold their defaults
    own = {f.name: f.default for f in dataclasses.fields(cfg)
           if f.name not in want}
    assert {k: got.pop(k) for k in own} == own
    assert got == want
    assert specs.cache_capacity(cfg, shape) == jspecs.cache_capacity(
        jcfg, jshape)
    for got, want in ((specs.input_specs(cfg, shape),
                       jspecs.input_specs(jcfg, jshape)),
                      (specs.decode_specs(cfg, shape),
                       jspecs.decode_specs(jcfg, jshape))):
        assert list(got) == list(want)
        for k in got:
            assert got[k].is_meta
            assert tuple(got[k].shape) == want[k].shape, k
            assert jdtype(got[k]) == str(want[k].dtype), k


def test_eval_shapes_runs_on_meta_only():
    x = specs.stand_in((3, 4), torch.float32)
    out = specs.eval_shapes(lambda a: a @ a.T, x)
    assert out.is_meta and tuple(out.shape) == (3, 3)
    with pytest.raises(ValueError, match="meta"):
        specs.eval_shapes(lambda a: a, torch.zeros(2))


def small_shape(kind):
    return ShapeConfig("small", 64, 4, kind), JShapeConfig("small", 64, 4,
                                                           kind)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("kind", KINDS)
def test_setup_arg_shapes_match_reference(family, kind):
    """Every leaf of ``Setup.arg_shapes`` (path, shape, dtype) and its
    input sharding's spec against the reference's ``build_setup`` on a
    one-CPU host mesh, reduced configs."""
    shape, jshape = small_shape(kind)
    cfg = registry.get_config(FAMILIES[family]).reduced()
    jcfg = jreg.get_config(FAMILIES[family]).reduced()
    jm = jmesh.make_host_mesh()
    with jm:
        want = jsteps.build_setup(kind, jcfg, jshape, jm)
    tm = tmesh.make_host_mesh(device="cpu")
    got = steps.build_setup(kind, cfg, shape, tm)
    assert got.model.device.type == "meta"
    gp, wp = tpaths(got.arg_shapes), jpaths(want.arg_shapes)
    assert set(gp) == set(wp)
    for k in wp:
        assert tuple(gp[k].shape) == wp[k].shape, k
        assert jdtype(gp[k]) == str(wp[k].dtype), k
    gs, ws = tpaths(got.in_shardings), jpaths(want.in_shardings)
    assert set(gs) == set(ws)
    for k in ws:
        assert str(gs[k].spec) == str(ws[k].spec), k
    # the outputs' stand-ins against the reference's eval_shape
    jout = jax.eval_shape(want.step_fn, *want.arg_shapes)
    go, wo = tpaths(got.out_shapes), jpaths(jout)
    if kind == "train":            # metrics: the port's are its own names
        go = {k: v for k, v in go.items() if not k.startswith("3/")}
        wo = {k: v for k, v in wo.items() if not k.startswith("3/")}
    assert set(go) == set(wo)
    for k in wo:
        assert tuple(go[k].shape) == wo[k].shape, k


# -- launch/hlo_analysis.py -------------------------------------------------------

def hlo_texts():
    """The reference test's HLO (tests/test_hlo_and_rules.py:14-57)."""
    def f_scan(x, w):
        y, _ = jax.lax.scan(lambda c, _: (c @ w, None), x, None, length=7)
        return y

    def f_single(x, w):
        return x @ w

    def f_nested(x, w):
        def outer(c, _):
            def inner(c2, _):
                return c2 @ w, None
            c, _ = jax.lax.scan(inner, c, None, length=3)
            return c, None
        y, _ = jax.lax.scan(outer, x, None, length=5)
        return y

    def f_batched(a, b):
        return jnp.einsum("bij,bjk->bik", a, b)
    x64, x32 = jnp.ones((64, 64)), jnp.ones((32, 32))
    return {
        "scan7": jax.jit(f_scan).lower(x64, x64).compile().as_text(),
        "single": jax.jit(f_single).lower(x64, x64).compile().as_text(),
        "nested": jax.jit(f_nested).lower(x32, x32).compile().as_text(),
        "batched": jax.jit(f_batched).lower(
            jnp.ones((4, 16, 32)), jnp.ones((4, 32, 8))).compile().as_text(),
    }


def test_analyze_text_matches_reference_exactly():
    texts = hlo_texts()
    for name, text in texts.items():
        got, want = hlo.analyze_text(text), jhlo.analyze_text(text)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    assert hlo.analyze_text(texts["single"]).flops == 2 * 64 ** 3
    assert hlo.analyze_text(texts["scan7"]).flops == pytest.approx(
        7 * 2 * 64 ** 3, rel=0.05)
    assert hlo.analyze_text(texts["nested"]).flops == pytest.approx(
        15 * 2 * 32 ** 3, rel=0.05)
    assert hlo.analyze_text(texts["batched"]).flops == 2 * 4 * 16 * 32 * 8


def test_collective_parsers_match_reference():
    text = "\n".join([
        "HloModule m",
        "ENTRY %main (p: f32[8,16]) -> f32[8,16] {",
        "  %p = f32[8,16]{1,0} parameter(0)",
        '  %all-gather.3 = bf16[16,512]{1,0} all-gather(%p), '
        'metadata={op_name="gather_w"}',
        "  %ar = (f32[8,16]{1,0}, f32[4]{0}) all-reduce(%p, %p), "
        "to_apply=%add",
        "  ROOT %cp = f32[8,16]{1,0} collective-permute(%p)",
        "}"])
    got, want = hlo.analyze_text(text), jhlo.analyze_text(text)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.coll_bytes > 0


def test_counter_counts_products_writes_and_live_bytes():
    a = torch.ones(64, 32)
    w = torch.ones(32, 16)
    with hlo.CostCounter() as c:
        y = a @ w                       # 2 * 64 * 32 * 16, 4 KiB out
        v = y.view(16, 64)              # a view: nothing written
        v.add_(1.0)                     # in place: 4 KiB written
        z = torch.relu(y)               # elementwise: no FLOPs, 4 KiB
        del y, v
    assert c.flops == 2 * 64 * 32 * 16
    assert c.write_bytes == 3 * 64 * 16 * 4
    assert c.peak_bytes == 2 * 64 * 16 * 4
    assert c.live_bytes == 64 * 16 * 4          # z alone
    assert c.costs().coll_bytes == 0 and c.coll_by_kind == {}
    assert [r[1] for r in hlo.top_ops(c, by="flops")] == ["aten.mm"]
    assert z.shape == (64, 16)
    out, counter = hlo.count_costs(torch.matmul, a, w)
    assert counter.flops == 2 * 64 * 32 * 16 and out.shape == (64, 16)


@pytest.mark.parametrize("kind", KINDS)
def test_counter_flops_match_reference_analysis(kind):
    """Reduced smollm-360m's step on a one-CPU host mesh: the port's
    dispatch counter (its step on meta) against the reference's
    ``roofline.analyze`` of the compiled step, within 2 %; argument bytes
    against XLA's ``memory_analysis`` exactly."""
    shape, jshape = ShapeConfig("small", 128, 4, kind), JShapeConfig(
        "small", 128, 4, kind)
    jcfg = jreg.get_config("smollm-360m").reduced()
    jm = jmesh.make_host_mesh()
    jshd.set_mesh(jm, jrules.activation_rules(kind, False, True))
    with jm:
        su = jsteps.build_setup(kind, jcfg, jshape, jm)
        compiled = jax.jit(su.step_fn, in_shardings=su.in_shardings,
                           out_shardings=su.out_shardings).lower(
            *su.arg_shapes).compile()
        want = jroof.analyze(compiled, su.cfg, jshape, 1)
    jshd.set_mesh(None)
    tm = tmesh.make_host_mesh(device="cpu")
    cfg = registry.get_config("smollm-360m").reduced()
    with shd.mesh_context(tm, dryrun.run_rules(tm, shape, False)):
        counter = hlo.CostCounter()
        setup = steps.build_setup(kind, cfg, shape, tm, counter=counter)
        memory, roof = dryrun.account(setup, counter, shape, tm)
    assert counter.flops == pytest.approx(want.flops_per_device, rel=0.02)
    assert roof.flops_per_device == counter.flops
    assert roof.model_flops == want.model_flops
    assert memory["argument_bytes"] == \
        compiled.memory_analysis().argument_size_in_bytes
    assert roof.coll_bytes_per_device == 0.0 and roof.n_devices == 1


# -- launch/roofline.py -------------------------------------------------------------

@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_model_flops_and_active_params_are_exact(arch):
    cfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    assert troof.active_params(cfg) == jroof.active_params(jcfg)
    for name in INPUT_SHAPES:
        n = troof.active_params(cfg)
        assert troof.model_flops(cfg, INPUT_SHAPES[name], n) == \
            jroof.model_flops(jcfg, JSHAPES[name], n)


def test_roofline_terms_use_h100_peaks():
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    costs = hlo.HloCosts(989e12, 0.0, {}, 2 * 3.35e12)
    cfg = registry.get_config("smollm-360m")
    one = troof.analyze(costs, cfg, INPUT_SHAPES["train_4k"], 1)
    assert one.compute_s == 1.0 and one.memory_s == 2.0
    assert one.dominant == "memory" and one.bound_s == 2.0
    assert one.collective_s == 0.0
    pod = troof.analyze(costs, cfg, INPUT_SHAPES["train_4k"], 256)
    assert pod.collective_s is None and pod.coll_breakdown is None
    assert pod.bound_s == 2.0 / 256 and pod.row()["collective_s"] is None


# -- launch/dryrun.py, diagnose.py, hillclimb_capture.py ---------------------------

# the keys of the reference's dry-run row
ROW_KEYS = {"arch", "shape", "kind", "multi_pod", "n_devices", "opts",
            "memory", "compute_s", "memory_s", "collective_s", "dominant",
            "bound_s", "flops_per_device", "hbm_bytes_per_device",
            "coll_bytes_per_device", "coll_breakdown", "model_flops",
            "useful_flops_ratio", "peak_memory_bytes"}


@pytest.mark.parametrize("arch,shape_name,multi_pod", [
    ("smollm-360m", "decode_32k", False), ("mamba2-370m", "train_4k", True)])
def test_dryrun_one_rows(arch, shape_name, multi_pod):
    """The reference's two smoke pairs (tests/test_pipeline_multidev.py)."""
    row = dryrun.dryrun_one(arch, shape_name, multi_pod=multi_pod,
                            verbose=False)
    assert "error" not in row, row
    assert ROW_KEYS <= set(row)
    assert row["kind"] == INPUT_SHAPES[shape_name].kind
    assert row["n_devices"] == (512 if multi_pod else 256)
    assert row["flops_per_device"] > 0 and row["step_flops"] > 0
    assert row["collective_s"] is None and "collectives" in row["not_modelled"]
    assert row["memory"]["argument_bytes"] > 0
    assert row["memory"]["step_peak_bytes"] > row["memory"]["argument_bytes"]
    assert row["bound_s"] == max(row["compute_s"], row["memory_s"])
    json.dumps(row)


def test_dryrun_skips_and_cli(tmp_path, capsys):
    row = dryrun.dryrun_one("qwen2-72b", "long_500k", verbose=False)
    assert "error" not in row
    row = dryrun.dryrun_one("deepseek-moe-16b", "long_500k", verbose=False)
    assert row["skipped"]
    out = tmp_path / "rows.json"
    assert dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                        "--opt", "softmax_low", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert len(rows) == 1 and rows[0]["opts"] == ["softmax_low"]
    assert "1 ok, 0 skipped, 0 errors" in capsys.readouterr().out


def test_diagnose_prints_top_ops(capsys):
    counter, roof = diagnose("smollm-360m", "decode_32k", k=3)
    text = capsys.readouterr().out
    assert "top ops by flops" in text and "aten.bmm" in text
    assert roof.flops_per_device * 256 == counter.flops > 0


def test_hillclimb_capture_writes_rows(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(hillclimb_capture, "PAIRS", [
        ("smollm-360m", "decode_32k", ("fsdp",)),
        ("qwen2-72b", "long_500k", ())])
    out = hillclimb_capture.main()
    written = json.loads((tmp_path / hillclimb_capture.OUT).read_text())
    assert [r["arch"] for r in written] == ["smollm-360m", "qwen2-72b"]
    for r in out:
        assert "error" not in r["baseline"] and "error" not in r["optimized"]
        assert ROW_KEYS <= set(r["baseline"])
        assert r["speedup_on_bound"] > 0


# -- the rule-driven options the models read ------------------------------------------

def test_softmax_low_follows_reference_in_bfloat16():
    """``chunked_sdpa`` in bfloat16 under the ``softmax_low`` rules takes
    the softmax of the bfloat16 scores (no float32 copy of them is
    made), as the reference's; under no rules it takes it in float32.
    Both against the reference's at the reference's attention tolerance
    (2e-4, tests/test_kernels.py) counted in bfloat16 steps at the
    outputs' magnitude: each package rounds its products to bfloat16 in
    its own order (and torch's bfloat16 softmax sums in float32 inside,
    where XLA's stays in bfloat16)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 256, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 256, 2, 32)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    table = rules.activation_rules("train", False, True, ("softmax_low",))
    base, c_base = hlo.count_costs(tattn.chunked_sdpa, tq, tk, tv, 100,
                                   chunk_q=64)
    jbase = np.asarray(jattn.chunked_sdpa(jq, jk, jv, 100, chunk_q=64),
                       np.float32)
    with shd.mesh_context(tmesh.make_host_mesh(device="cpu"), table):
        low, c_low = hlo.count_costs(tattn.chunked_sdpa, tq, tk, tv, 100,
                                     chunk_q=64)
    jshd.set_mesh(jmesh.make_host_mesh(), table)
    jlow = np.asarray(jattn.chunked_sdpa(jq, jk, jv, 100, chunk_q=64),
                      np.float32)
    jshd.set_mesh(None)
    assert "aten._to_copy" in c_base.ops and "aten._to_copy" not in c_low.ops
    assert c_low.write_bytes < c_base.write_bytes
    assert low.dtype == base.dtype == torch.bfloat16
    step = 2.0 ** -8 * float(np.abs(jlow).max())     # bfloat16's ulp there
    assert float(np.abs(jlow - jbase).max()) > 0     # the option matters
    for got, want in ((low, jlow), (base, jbase)):
        assert float(np.abs(got.float().numpy() - want).max()) <= 2 * step


def test_remat_dots_gradients_equal_plain_remat():
    """One SGD step's gradients of reduced smollm-360m with remat (float32,
    CPU): saving the matrix products' outputs (``remat_dots``) changes what
    is recomputed, not the gradients.  Counted over the forward and the
    backward: plain remat runs the blocks' products again in the
    backward's recompute; under ``remat_dots`` the recompute takes the
    saved outputs and runs no product, so the step runs exactly as many as
    it does without remat (the reference's ``checkpoint_dots``)."""
    from repro_torch.nn.module import trainable
    from repro_torch.training.train_lib import lm_loss
    cfg = dataclasses.replace(registry.get_config("smollm-360m").reduced(),
                              remat=True)
    jparams, _ = jreg.build_model(jreg.get_config("smollm-360m").reduced()
                                  ).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}

    def grads(table, remat=True):
        model = registry.build_model(dataclasses.replace(cfg, remat=remat),
                                     device="cpu")
        load_reference_params(model, {k: np.asarray(v) for k, v in
                                      jpaths(jparams).items()})
        trainable(model)
        with shd.mesh_context(tmesh.make_host_mesh(device="cpu"), table), \
                hlo.CostCounter() as counter:
            logits, aux = model.forward_aux(batch, train=True)
            lm_loss(cfg, logits, batch, aux)[0].backward()
        products = {op: counter.ops[op].calls if op in counter.ops else 0
                    for op in DOTS}
        return {n: p.grad for n, p in model.named_parameters()}, products
    plain, n_plain = grads(rules.activation_rules("train", False, True))
    dots, n_dots = grads(rules.activation_rules("train", False, True,
                                                ("remat_dots",)))
    _, n_kept = grads(rules.activation_rules("train", False, True), False)
    assert set(plain) == set(dots)
    for n in plain:
        torch.testing.assert_close(dots[n], plain[n], rtol=0, atol=1e-7)
    assert n_dots == n_kept
    for op in ("aten.mm", "aten.bmm"):
        assert n_plain[op] > n_dots[op] > 0, (op, n_plain, n_dots)


# the matrix-product ops that ``remat_dots`` saves (models/decoder.py)
DOTS = ("aten.mm", "aten.addmm", "aten.bmm")


def test_no_rules_means_no_option():
    assert "softmax_dtype" not in shd.current_rules()
    assert "remat_policy" not in shd.current_rules()
