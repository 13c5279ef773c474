"""The port's LM inference slice against the JAX package on the CPU, on the
same weights (the reference's pytree carried over by
``repro_torch.models.convert``) and the same numpy inputs: configs and
registry, RoPE / RMS norm / chunked attention / KV caches, the full
forward (port ``"auto"`` — the sliding-window kernel's plain version —
against the reference's Pallas kernel in interpret mode, and ``"ref"``
against ``"ref"``), the partitioned runner, the generation engine, the
explorer-to-deployment cut mapping and the partitioner's graphs.

The model is smollm-360m reduced (2 layers, d 256, 4 heads over 2 KV
heads) with ``window=128`` and 256 tokens: at the reduced config's own
window of 64 the reference's dispatch would fall back to its plain version
and the Pallas kernel would never run.  Tolerance of float results: 2e-5
absolute on logits of magnitude ~1.5 (float32, summed in other orders by
XLA and by torch)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.explore import ModelRef as JModelRef  # noqa: E402
from repro.explore.deploy import lm_block_cuts as jlm_block_cuts  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.nn import attention as ja  # noqa: E402
from repro.nn.layers import rms_norm as jrms_norm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import pipeline as jpipeline  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.quant import QuantSpec  # noqa: E402
from repro_torch.explore import ModelRef, lm_block_cuts  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import load_reference_params  # noqa: E402
from repro_torch.models.decoder import DecoderLM  # noqa: E402
from repro_torch.nn import attention as ta  # noqa: E402
from repro_torch.nn.layers import RMSNorm, rms_norm  # noqa: E402
from repro_torch.serving import (GenerationEngine,  # noqa: E402
                                 PartitionedLMRunner, def4_throughput,
                                 link_transfer_bytes, pipeline_report,
                                 valid_token_count)

torch.set_num_threads(2)

ATOL = 2e-5
T = 256
DENSE = ("smollm-360m", "qwen2-72b", "qwen3-14b", "stablelm-12b")


def flat_params(tree):
    """The reference's parameter pytree as numpy arrays, ``/``-joined keys."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in leaves}


def small_cfg(get_config):
    return dataclasses.replace(get_config("smollm-360m").reduced(), window=128)


@pytest.fixture(scope="module")
def lm():
    """(reference model, its params, port model on the same weights)."""
    jcfg = small_cfg(jreg.get_config)
    jm = jreg.build_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(0))
    tm = DecoderLM(small_cfg(registry.get_config), device="cpu")
    load_reference_params(tm, flat_params(params))
    return jm, params, tm


def tokens(vocab, b, t, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=atol,
                               atol=atol)


# -- configs and registry -----------------------------------------------------

# the port's own config fields, after the reference's (configs/base.py)
PORT_FIELDS = ("layer_types", "embedding_multiplier", "residual_multiplier",
               "logits_scaling", "attention_scale", "rope", "norm_eps",
               "experts_held", "rope_scaling", "n_group", "topk_group",
               "routed_scaling_factor", "graph_mla")


def reference_part(cfg):
    """``cfg``'s fields that the reference's config has, after checking
    that the port's own fields hold their defaults (today's behaviour)."""
    d = dataclasses.asdict(cfg)
    own = {k: d.pop(k) for k in PORT_FIELDS}
    assert own == {f.name: f.default for f in dataclasses.fields(ModelConfig)
                   if f.name in PORT_FIELDS}
    return d


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_configs_equal_reference(arch):
    """The reference's configs equal, field for field; the port's fields
    are the reference's followed by its own, at their defaults in every
    one of the reference's configs."""
    assert registry.ARCH_IDS == jreg.ARCH_IDS
    got, want = registry.get_config(arch), jreg.get_config(arch)
    assert [f.name for f in dataclasses.fields(ModelConfig)] == [
        f.name for f in dataclasses.fields(JModelConfig)] + list(PORT_FIELDS)
    assert reference_part(got) == dataclasses.asdict(want)
    assert reference_part(got.reduced()) == dataclasses.asdict(
        want.reduced())
    for name in ("train_4k", "long_500k"):
        assert registry.supports_shape(got, registry.shape_config(name)) == \
            jreg.supports_shape(want, jreg.shape_config(name))
    assert got.param_count() == want.param_count()


@pytest.mark.parametrize("arch", DENSE)
def test_dense_graphs_equal_reference_without_weights(arch):
    cfg = registry.get_config(arch)
    model = DecoderLM(cfg, device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    tg = model.to_graph(4096)
    jg = jreg.build_model(jreg.get_config(arch)).to_graph(4096)
    assert tg.name == jg.name and list(tg.nodes) == list(jg.nodes)
    assert ([dataclasses.astuple(n) for n in tg.nodes.values()]
            == [dataclasses.astuple(n) for n in jg.nodes.values()])
    assert tg.edges == jg.edges
    assert tg.total_params == jg.total_params


def test_registry_model_ref_builds_graph():
    for opts in ({"seq": 64}, {"seq": 256, "reduced": True}):
        tg, shared = ModelRef("registry", "smollm-360m", opts).build()
        jg, _ = JModelRef("registry", "smollm-360m", opts).build()
        assert shared is None
        assert list(tg.nodes) == list(jg.nodes)
        assert tg.total_params == jg.total_params
    tg, shared = ModelRef("registry", "mamba2-370m", {"seq": 64}).build()
    jg, _ = JModelRef("registry", "mamba2-370m", {"seq": 64}).build()
    assert shared is None and list(tg.nodes) == list(jg.nodes)


@pytest.mark.parametrize("arch", ["musicgen-large", "qwen2-vl-7b"])
def test_build_model_builds_audio_and_vlm(arch):
    cfg = registry.get_config(arch).reduced()
    model = registry.build_model(cfg, device="cpu")
    assert isinstance(model, DecoderLM) and model.device.type == "cpu"
    jparams, _ = jreg.build_model(jreg.get_config(arch).reduced()).init(
        jax.random.PRNGKey(0))
    assert sum(p.numel() for p in model.parameters()) == sum(
        v.size for v in jax.tree_util.tree_leaves(jparams))
    assert hasattr(model, "vis_proj") == (cfg.family == "vlm")
    full = registry.build_model(registry.get_config(arch), device="meta")
    assert sum(p.numel() for p in full.parameters()) == sum(
        v.size for v in jax.tree_util.tree_leaves(jax.eval_shape(
            lambda: jreg.build_model(jreg.get_config(arch)).init(
                jax.random.PRNGKey(0))[0])))


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v3-671b"])
def test_build_model_builds_moe_families(arch):
    cfg = registry.get_config(arch).reduced()
    model = registry.build_model(cfg, device="cpu")
    assert isinstance(model, DecoderLM) and model.device.type == "cpu"
    assert (model.n_dense, model.n_moe) == (1, 1)
    assert [b.kind for b in model.blocks] == ["dense", "moe"]
    jparams, _ = jreg.build_model(jreg.get_config(arch).reduced()).init(
        jax.random.PRNGKey(0))
    assert sum(p.numel() for p in model.parameters()) == sum(
        v.size for v in jax.tree_util.tree_leaves(jparams))
    assert hasattr(model, "mtp_block") == bool(cfg.mtp)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_build_model_builds_ssm_families(arch):
    from repro_torch.models.ssm_lm import SSMLM
    cfg = registry.get_config(arch).reduced()
    model = registry.build_model(cfg, device="cpu")
    assert isinstance(model, SSMLM) and model.device.type == "cpu"
    jparams, _ = jreg.build_model(jreg.get_config(arch).reduced()).init(
        jax.random.PRNGKey(0))
    assert sum(p.numel() for p in model.parameters()) == sum(
        v.size for v in jax.tree_util.tree_leaves(jparams))
    with pytest.raises(ValueError, match="SSMLM"):
        DecoderLM(cfg, device="cpu")


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-370m"])
def test_default_device_raises_without_a_card(monkeypatch, arch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.build_model(registry.get_config(arch).reduced())


def test_seeded_init_is_reproducible():
    cfg = registry.get_config("smollm-360m").reduced()
    a, b = (DecoderLM(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        assert not p.requires_grad
    assert float(a.embed.std()) == pytest.approx(0.02, rel=0.05)
    w = a.blocks[0].attn.wq
    assert float(w.std()) == pytest.approx(cfg.d_model ** -0.5, rel=0.05)


def test_convert_rejects_mismatched_parameters(lm):
    _, params, _ = lm
    flat = flat_params(params)
    tm = DecoderLM(small_cfg(registry.get_config), device="cpu")
    with pytest.raises(KeyError, match="missing"):
        load_reference_params(tm, {k: v for k, v in flat.items()
                                   if k != "final_norm"})
    with pytest.raises(KeyError, match="unexpected"):
        load_reference_params(tm, dict(flat, head=flat["embed"].T))
    with pytest.raises(ValueError, match="leading axis"):
        load_reference_params(tm, dict(
            flat, **{"blocks_dense/ln1": flat["blocks_dense/ln1"][:1]}))
    with pytest.raises(NotImplementedError,
                       match="not a parameter of a dense model"):
        load_reference_params(tm, dict(flat, **{"blocks_moe/x": flat["embed"]}))
    # a moe model's second stack loads
    jcfg = jreg.get_config("deepseek-moe-16b").reduced()
    jflat = flat_params(jreg.build_model(jcfg).init(jax.random.PRNGKey(1))[0])
    assert any(k.startswith("blocks_moe/") for k in jflat)
    moe = registry.build_model(registry.get_config(
        "deepseek-moe-16b").reduced(), device="cpu")
    load_reference_params(moe, jflat)
    assert torch.equal(moe.blocks[1].moe.router,
                       torch.from_numpy(np.array(jflat["blocks_moe/moe/router"][0])))


# -- layers ---------------------------------------------------------------------

@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 300, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 8192, (2, 300))
    got = ta.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = ja.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    close(got, want, 1e-4)     # angles up to 8191 rad: cos/sin lose ~1e-5


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 5, 96)) * 4).astype(np.float32)
    s = rng.standard_normal(96).astype(np.float32)
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(s))
    close(got, jrms_norm(jnp.asarray(x), jnp.asarray(s)), 1e-6)
    norm = RMSNorm(96)
    norm.scale.copy_(torch.from_numpy(s))
    assert torch.equal(norm(torch.from_numpy(x)), got)


@pytest.mark.parametrize("window", [None, 100])
def test_chunked_sdpa_matches_reference(window):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 256, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 256, 2, 32)).astype(np.float32)
            for _ in range(2))
    got = ta.chunked_sdpa(*map(torch.from_numpy, (q, k, v)), window,
                          chunk_q=64)
    want = ja.chunked_sdpa(*map(jnp.asarray, (q, k, v)), window, chunk_q=64)
    close(got, want)
    pos = torch.arange(256)
    close(got, ta.sdpa(*map(torch.from_numpy, (q, k, v)),
                       ta.causal_mask(pos, pos, window)))


@pytest.mark.parametrize("ring", [True, False])
def test_cache_update_and_positions_match_reference(ring):
    rng = np.random.default_rng(4)
    cap, steps = 16, (5, 1, 3, 1, 6, 2) if not ring else (5, 7, 1, 9, 3, 16)
    tc = ta.init_cache(2, 2, cap, 8, dtype=torch.float32)
    jc = ja.init_cache(2, 2, cap, 8, dtype=jnp.float32)
    for t_new in steps:
        k, v = (rng.standard_normal((2, t_new, 2, 8)).astype(np.float32)
                for _ in range(2))
        tc = ta.cache_update(tc, torch.from_numpy(k), torch.from_numpy(v),
                             ring=ring)
        jc = ja.cache_update(jc, jnp.asarray(k), jnp.asarray(v), ring=ring)
        for name in ("k", "v", "pos"):
            assert (tc[name].numpy() == np.asarray(jc[name])).all(), name
        assert (ta.cache_positions(tc, ring).numpy()
                == np.asarray(ja.cache_positions(jc, ring))).all()
    if not ring:
        with pytest.raises(ValueError, match="capacity"):
            ta.cache_update(tc, torch.zeros(2, cap + 1, 2, 8),
                            torch.zeros(2, cap + 1, 2, 8), ring=False)


def test_unknown_impl_raises(lm):
    _, _, tm = lm
    with pytest.raises(ValueError, match="valid choices"):
        tm({"tokens": tokens(512, 1, 8)}, impl="pallas")


# -- forward, partitioned runner, generation --------------------------------------

@pytest.mark.parametrize("jimpl,timpl", [("pallas", "auto"), ("ref", "ref")])
def test_forward_matches_reference(lm, jimpl, timpl):
    jm, params, tm = lm
    tok = tokens(512, 2, T, seed=5)
    want, _ = jm.apply(params, {}, {"tokens": jnp.asarray(tok)}, impl=jimpl)
    got = tm({"tokens": torch.from_numpy(tok)}, impl=timpl)
    assert got.shape == (2, T, 512) and torch.isfinite(got).all()
    close(got, want)


@pytest.mark.parametrize("cuts", [[0], []])
def test_partitioned_runner_matches_reference(lm, cuts):
    jm, params, tm = lm
    tok = tokens(512, 2, 64, seed=6)
    runner = PartitionedLMRunner(tm, cuts)
    got, rep = runner.forward({"tokens": torch.from_numpy(tok)})
    want, jrep = jpipeline.PartitionedLMRunner(jm, params, cuts).forward(
        {"tokens": jnp.asarray(tok)})
    close(got, want)
    assert torch.equal(got, tm({"tokens": torch.from_numpy(tok)}))
    assert runner.n_stages == len(cuts) + 1
    assert rep.link_bytes == jrep.link_bytes
    assert len(rep.latency_s) == runner.n_stages
    assert all(t > 0 for t in rep.latency_s) and rep.throughput() > 0


# the quantized runner: weights fake-quantized as the reference quantizes
# them are equal bit for bit (the same min/max over the same stacked leaf,
# the same rounding), so with float links the logits differ only by
# summation order (2e-5 of the LM tests).  A link fake-quantized from
# activations that differ by ~1e-6 can round an element one step (max|x| /
# 127 at 8 bits) apart, which moves the next stage's logits by up to ~3e-3
# of their max (measured 2.4e-3 at 8 bits): the bound there is 1e-2 of
# max|logits|, with 99 % of the top-1 equal; a wrong stage or scale moves
# them by O(1)
@pytest.mark.parametrize("cuts,bits,link_quant,per_channel", [
    ([0], (16, 8), False, False), ([0], (8, 8), True, False),
    ([0], (4, 8), True, True), ([], (8,), False, True)])
def test_quantized_runner_matches_reference(lm, cuts, bits, link_quant,
                                            per_channel):
    jm, params, tm = lm
    from repro.core.quant import QuantSpec as JQuantSpec
    specs = [QuantSpec(b, per_channel=per_channel) for b in bits]
    jspecs = [JQuantSpec(b, per_channel=per_channel) for b in bits]
    tok = tokens(512, 2, 64, seed=4)
    jr = jpipeline.PartitionedLMRunner(jm, params, cuts, jspecs,
                                       link_quant=link_quant)
    want, jrep = jr.forward({"tokens": jnp.asarray(tok)})
    runner = PartitionedLMRunner(tm, cuts, specs, link_quant=link_quant)
    got, rep = runner.forward({"tokens": torch.from_numpy(tok)})
    want, got = np.asarray(want), got.numpy()
    if link_quant and cuts:
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
        assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.99
    else:
        close(got, want)
    assert rep.link_bytes == jrep.link_bytes
    with torch.no_grad():
        mono = tm({"tokens": torch.from_numpy(tok)}).numpy()
    assert np.abs(got - mono).max() > 1e-3 * np.abs(mono).max()
    # stage weights: the reference's stacked quantized leaves, bit for bit
    for si in range(runner.n_stages):
        jw, tw = jr.stage_weights(si), runner.stage_weights(si)
        assert sorted(jw) == sorted(tw)
        jb = flat_params(jw["blocks"])
        for key, want_leaf in jb.items():
            name = key.replace("/", ".")
            stacked = torch.stack([b.params[name] for b in tw["blocks"]])
            np.testing.assert_array_equal(stacked.numpy(), want_leaf,
                                          err_msg=key)
    # the model's own weights stay float
    assert torch.equal(tm.blocks[0].attn.wq, torch.from_numpy(np.array(
        params["blocks_dense"]["attn"]["wq"][0])))


def test_quantized_stage_step_matches_runner(lm):
    """A prefill through ``stage_step_fn`` over the quantized
    ``stage_weights`` gives the quantized runner's last-position logits
    (the serve runtime's path)."""
    _, _, tm = lm
    runner = PartitionedLMRunner(tm, [0], [QuantSpec(8), QuantSpec(4)])
    tok = tokens(512, 2, 20, seed=5)
    want, _ = runner.forward({"tokens": torch.from_numpy(tok)})
    x = torch.from_numpy(tok).long()
    for si in range(runner.n_stages):
        caches = runner.init_stage_caches(si, 2, 32)
        x, caches = runner.stage_step_fn(si)(runner.stage_weights(si),
                                             caches, x)
        assert int(caches["pos"][0]) == 20
    close(x[:, -1].numpy(), want[:, -1].numpy())


def test_runner_rejects_moe_and_a_wrong_number_of_specs(lm):
    """The reference's runner takes homogeneous stacks (dense, vlm, audio)
    and refuses a moe model by its assertion; the port's cuts a moe model
    at the search's positions (its chain of units), so there a moe model
    raises only on a wrong number of specs, as a dense one does."""
    _, _, tm = lm
    with pytest.raises(ValueError, match="3 quant specs for 2 stages"):
        PartitionedLMRunner(tm, [0], [QuantSpec(8)] * 3)
    moe = registry.build_model(registry.get_config(
        "deepseek-moe-16b").reduced(), device="cpu")
    with pytest.raises(ValueError, match="3 quant specs for 2 platforms"):
        PartitionedLMRunner(moe, [0], [QuantSpec(8)] * 3)
    assert PartitionedLMRunner(moe, [0], [QuantSpec(8), None]).n_stages == 2
    jm = jreg.build_model(jreg.get_config("deepseek-moe-16b").reduced())
    with pytest.raises(AssertionError):
        jpipeline.PartitionedLMRunner(jm, {}, [0])


def test_partitioned_runner_stage_pieces(lm):
    _, _, tm = lm
    runner = PartitionedLMRunner(tm, [0])
    w0, w1 = runner.stage_weights(0), runner.stage_weights(1)
    assert list(w0) == ["blocks", "embed"] and w0["embed"] is tm.embed
    assert sorted(w1) == ["blocks", "embed", "final_norm"]   # tied
    assert w0["blocks"][0] is tm.blocks[0] and w1["blocks"][0] is tm.blocks[1]
    c = runner.init_stage_caches(1, batch=3, capacity=512)
    assert c["k"].shape == (1, 3, 128, 2, 64)          # capped at the window
    assert c["k"].dtype == torch.float32 and int(c["pos"].sum()) == 0
    q = PartitionedLMRunner(tm, [0], quant_specs=[QuantSpec(8), None])
    qb = q.stage_weights(0)["blocks"]
    assert len(qb) == 1 and qb[0].block is tm.blocks[0]
    assert not torch.equal(qb[0].params["attn.wq"], tm.blocks[0].attn.wq)
    assert q.stage_weights(1)["blocks"][0] is tm.blocks[1]


def test_generation_matches_reference(lm):
    jm, params, tm = lm
    prompts = tokens(512, 3, 16, seed=7)
    want = jengine.GenerationEngine(jm, params, max_seq=64,
                                    cache_dtype=jnp.float32).generate(
        prompts, max_new=12)
    eng = GenerationEngine(tm, max_seq=64)
    got = eng.generate(prompts, max_new=12)
    assert got.tokens.shape == (3, 12)
    assert (got.tokens == want.tokens).all()
    assert got.n_valid == want.n_valid == 36

    first, caches = eng.prefill(prompts)
    jcaches = jm.init_caches(3, 64, jnp.float32)
    jlogits, jcaches = jm.decode_step(params, jcaches,
                                      {"tokens": jnp.asarray(prompts)})
    close(first, jlogits[:, -1])
    close(first, tm({"tokens": torch.from_numpy(prompts)})[:, -1])
    assert (caches["dense"]["pos"].numpy() == 16).all()
    close(caches["dense"]["k"], jcaches["dense"]["k"])


def test_generation_eos_masking_and_sampling(lm):
    _, _, tm = lm
    eng = GenerationEngine(tm, max_seq=64)
    prompts = tokens(512, 3, 8, seed=8)
    free = eng.generate(prompts, max_new=8)
    eos = int(free.tokens[0, 1])
    res = eng.generate(prompts, max_new=8, eos=eos)
    for row in res.tokens:
        hits = np.flatnonzero(row == eos)
        if hits.size:
            assert (row[hits[0]:] == eos).all()
    assert res.n_valid == valid_token_count(res.tokens, eos)
    a, b = (eng.generate(prompts, max_new=6, temperature=1.0, seed=11)
            for _ in range(2))
    assert (a.tokens == b.tokens).all()
    assert ((a.tokens >= 0) & (a.tokens < 512)).all()


def test_pipeline_helpers_match_reference():
    toks = np.array([[3, 7, 7, 7], [1, 2, 3, 7], [1, 2, 3, 4]])
    for eos in (7, None):
        assert valid_token_count(toks, eos) == jengine.valid_token_count(
            toks, eos)
    lat, links = [0.2, 0.5, 0.0], [0.1, 0.7]
    assert def4_throughput(lat, links) == jpipeline.def4_throughput(lat, links)
    assert pipeline_report(lat, links) == jpipeline.pipeline_report(lat, links)
    from repro.core.quant import QuantSpec as JQuantSpec
    for bits in (None, 4, 8, 16):
        t = QuantSpec(bits) if bits else None
        j = JQuantSpec(bits) if bits else None
        assert link_transfer_bytes(1001, t) == jpipeline.link_transfer_bytes(
            1001, j)


# -- explorer to deployment -------------------------------------------------------

@pytest.mark.parametrize("cuts,n_layers", [
    ((-1,), 32), ((1,), 32), ((47,), 32), ((64, 2, 2), 32), ((0, 65), 32),
    ((-1, -1), 2), ((5, 9, 13), 8)])
def test_lm_block_cuts_match_reference(cuts, n_layers):
    assert lm_block_cuts(cuts, n_layers) == jlm_block_cuts(cuts, n_layers)
