"""The port's SSM inference slice against the JAX package on the CPU, on the
same numpy inputs and on the same weights (the reference's pytree carried
over by ``repro_torch.models.convert``): the SSD primitives (``segsum``,
``ssd_chunked``, ``ssd_step``), the SSD scan dispatch (the port's plain
version against the reference's Pallas kernel in interpret mode, its
``ref`` and the token-by-token recurrence), the three branches of
``Mamba2Mixer``, reduced mamba2-370m and zamba2-2.7b (forward, decode,
prefill against stepwise, generation), the partitioner's graphs and shared
groups, and the weight conversion's errors.

Tolerances, all float32 on both sides with sums taken in other orders by
XLA and by torch: 2e-4 for the SSD scan at the reference's sweep and 1e-4
against the recurrence (the reference's own, ``tests/test_kernels.py``);
1e-5 for the primitives and the mixer (outputs of magnitude ~1-10);
2e-5 on the reduced models' logits (magnitude ~1.5-4.5); 2e-3 and 3e-3
for prefill against stepwise decode (the reference's own,
``tests/test_validation_extra.py``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.explore import ModelRef as JModelRef  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as pl_ssd_scan  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.nn import ssm as jssm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.explore import ModelRef  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import registry, ssm_lm  # noqa: E402
from repro_torch.models.convert import load_reference_params  # noqa: E402
from repro_torch.nn import ssm as tssm  # noqa: E402
from repro_torch.serving import GenerationEngine  # noqa: E402

torch.set_num_threads(2)

SSM_ARCHS = ("mamba2-370m", "zamba2-2.7b")
SWEEP = [(t, chunk, h, p, n) for t, chunk in ((128, 32), (256, 64), (192, 64))
         for h, p, n in ((2, 16, 8), (3, 32, 16))]


def flat_params(tree):
    """The reference's parameter pytree as numpy arrays, ``/``-joined keys."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in leaves}


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=atol,
                               atol=atol)


def ssd_inputs(b, t, h, p, n, seed, dt_shift=-1.0):
    """The distribution of the reference's tests, made with numpy: dt =
    softplus(N(0, 1) + dt_shift)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)) + dt_shift))
    A = -np.exp(rng.standard_normal(h) * 0.3)
    B = rng.standard_normal((b, t, n)) * 0.5
    C = rng.standard_normal((b, t, n)) * 0.5
    return [a.astype(np.float32) for a in (x, dt, A, B, C)]


def both(arrays):
    return ([torch.from_numpy(a) for a in arrays],
            [jnp.asarray(a) for a in arrays])


def tokens(vocab, b, t, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


@pytest.fixture(scope="module", params=SSM_ARCHS)
def lm(request):
    """(arch, reference model, its params, port model on the same weights)
    at the reduced config."""
    arch = request.param
    jm = jreg.build_model(jreg.get_config(arch).reduced())
    params, _ = jm.init(jax.random.PRNGKey(0))
    tm = registry.build_model(registry.get_config(arch).reduced(),
                              device="cpu")
    load_reference_params(tm, flat_params(params))
    return arch, jm, params, tm


# -- SSD primitives ---------------------------------------------------------------

def test_segsum_matches_reference():
    a = np.random.default_rng(0).standard_normal((3, 2, 17)).astype(
        np.float32) * 0.3
    got = tssm.segsum(torch.from_numpy(a)).numpy()
    want = np.asarray(jssm.segsum(jnp.asarray(a)))
    assert (np.isneginf(got) == np.isneginf(want)).all()
    fin = np.isfinite(want)
    close(got[fin], want[fin], 1e-5)


@pytest.mark.parametrize("with_d", [False, True])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_matches_reference(with_d, with_init):
    x, dt, A, B, C = ssd_inputs(2, 96, 3, 16, 8, 1)
    rng = np.random.default_rng(2)
    D = rng.standard_normal(3).astype(np.float32) if with_d else None
    h0 = (rng.standard_normal((2, 3, 16, 8)).astype(np.float32)
          if with_init else None)
    extra = [a for a in (D, h0) if a is not None]
    (tx, tdt, tA, tB, tC, *textra), (jx, jdt, jA, jB, jC, *jextra) = both(
        [x, dt, A, B, C, *extra])
    kw_t = dict(zip([k for k, a in (("D", D), ("init_state", h0))
                     if a is not None], textra))
    kw_j = dict(zip(kw_t, jextra))
    y, st = tssm.ssd_chunked(tx, tdt, tA, tB, tC, 32, **kw_t)
    jy, jst = jssm.ssd_chunked(jx, jdt, jA, jB, jC, 32, **kw_j)
    close(y, jy, 1e-5)
    close(st, jst, 1e-5)


def test_ssd_chunked_rejects_ragged_length():
    x, dt, A, B, C = (torch.from_numpy(a) for a in ssd_inputs(1, 40, 2, 4, 4, 0))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tssm.ssd_chunked(x, dt, A, B, C, 32)


def test_ssd_step_matches_reference():
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((2, 3, 8, 4), (2, 3, 8), (2, 3), (3,), (2, 4), (2, 4),
                        (3,))]
    arrays[2] = np.abs(arrays[2])           # dt > 0
    arrays[3] = -np.abs(arrays[3])          # A < 0
    (st, x, dt, A, B, C, D), (jst, jx, jdt, jA, jB, jC, jD) = both(arrays)
    for d, jd in ((None, None), (D, jD)):
        y, new = tssm.ssd_step(st, x, dt, A, B, C, D=d)
        jy, jnew = jssm.ssd_step(jst, jx, jdt, jA, jB, jC, D=jd)
        close(y, jy, 1e-5)
        close(new, jnew, 1e-5)


# -- the SSD scan dispatch -----------------------------------------------------------

@pytest.mark.parametrize("t,chunk,h,p,n", SWEEP)
def test_ssd_scan_ref_matches_reference_kernel(t, chunk, h, p, n):
    (tx, tdt, tA, tB, tC), (jx, jdt, jA, jB, jC) = both(
        ssd_inputs(2, t, h, p, n, t + h))
    y, st = ops.ssd_scan(tx, tdt, tA, tB, tC, chunk, impl="ref")
    y_pl, st_pl = pl_ssd_scan(jx, jdt, jA, jB, jC, chunk=chunk)
    y_ref, st_ref = jref.ssd_scan(jx, jdt, jA, jB, jC, chunk)
    for want_y, want_st in ((y_pl, st_pl), (y_ref, st_ref)):
        close(y, want_y, 2e-4)
        close(st, want_st, 2e-4)
    # "auto" on a CPU tensor is the plain version
    y_auto, st_auto = ops.ssd_scan(tx, tdt, tA, tB, tC, chunk)
    assert torch.equal(y_auto, y) and torch.equal(st_auto, st)


def test_ssd_scan_matches_sequential_recurrence():
    tx, tdt, tA, tB, tC = (torch.from_numpy(a) for a in ssd_inputs(
        1, 64, 2, 8, 4, 9, dt_shift=0.0))
    y, st = ops.ssd_scan(tx, tdt, tA, tB, tC, 16, impl="ref")
    state = torch.zeros((1, 2, 8, 4))
    ys = []
    for i in range(64):
        y_i, state = tssm.ssd_step(state, tx[:, i], tdt[:, i], tA, tB[:, i],
                                   tC[:, i])
        ys.append(y_i)
    close(y, torch.stack(ys, 1), 1e-4)
    close(st, state, 1e-4)


def test_ssd_scan_cuda_impl_needs_cuda_tensors():
    args = [torch.from_numpy(a) for a in ssd_inputs(1, 32, 2, 4, 4, 0)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.ssd_scan(*args, 32, impl="cuda")
    with pytest.raises(ValueError, match="valid choices"):
        ops.ssd_scan(*args, 32, impl="pallas")


# -- Mamba2Mixer ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixer():
    """(reference mixer, its params, port mixer on the same weights)."""
    jm = jssm.Mamba2Mixer(64, d_state=16, expand=2, headdim=16, chunk=32)
    params, _ = jm.init(jax.random.PRNGKey(1))
    tm = tssm.Mamba2Mixer(64, d_state=16, expand=2, headdim=16, chunk=32,
                          device="cpu")
    with torch.no_grad():
        for k, v in params.items():
            getattr(tm, k).copy_(torch.from_numpy(np.array(v)))
    return jm, params, tm


def mixer_input(t, seed):
    return np.random.default_rng(seed).standard_normal((2, t, 64)).astype(
        np.float32)


@pytest.mark.parametrize("t", [64, 50])
@pytest.mark.parametrize("jimpl,timpl", [("pallas", "auto"), ("ref", "ref")])
def test_mixer_forward_matches_reference(mixer, t, jimpl, timpl):
    jm, params, tm = mixer
    u = mixer_input(t, t)
    y, cache = tm(torch.from_numpy(u), impl=timpl)
    jy, _ = jm.apply(params, {}, jnp.asarray(u), impl=jimpl)
    assert cache is None and y.shape == (2, t, 64)
    close(y, jy, 1e-5)


def _caches_close(tc, jc, atol):
    for k in ("conv", "ssm", "pos"):
        close(tc[k], jc[k], atol)


@pytest.mark.parametrize("t", [64, 50])
def test_mixer_cached_prefill_and_step_match_reference(mixer, t):
    jm, params, tm = mixer
    tc = tssm.init_ssm_cache(2, tm)
    jc = jssm.init_ssm_cache(2, jm)
    # two prefills (the second starts from a non-zero state), then steps
    for step, u in enumerate((mixer_input(t, 1), mixer_input(t, 2),
                              mixer_input(1, 3), mixer_input(1, 4))):
        y, tc = tm(torch.from_numpy(u), cache=tc)
        jy, jc = jm.apply(params, {}, jnp.asarray(u), cache=jc)
        close(y, jy, 1e-5)
        _caches_close(tc, jc, 1e-5)
    assert int(tc["pos"]) == 2 * t + 2


def test_mixer_unknown_impl_raises(mixer):
    with pytest.raises(ValueError, match="valid choices"):
        mixer[2](torch.zeros(1, 4, 64), impl="pallas")


# -- reduced models ------------------------------------------------------------------

@pytest.mark.parametrize("t", [64, 50])
@pytest.mark.parametrize("jimpl,timpl", [("pallas", "auto"), ("ref", "ref")])
def test_forward_matches_reference(lm, t, jimpl, timpl):
    _, jm, params, tm = lm
    tok = tokens(512, 2, t, seed=t)
    want, _ = jm.apply(params, {}, {"tokens": jnp.asarray(tok)}, impl=jimpl)
    got = tm({"tokens": torch.from_numpy(tok)}, impl=timpl)
    assert got.shape == (2, t, 512) and torch.isfinite(got).all()
    close(got, want, 2e-5)


def test_decode_step_matches_reference(lm):
    _, jm, params, tm = lm
    tc = tm.init_caches(2, 32, torch.float32)
    jc = jm.init_caches(2, 32, jnp.float32)
    tok = tokens(512, 2, 12, seed=5)
    for a, b in ((0, 9), (9, 10), (10, 11), (11, 12)):
        got, tc = tm.decode_step(tc, {"tokens": torch.from_numpy(tok[:, a:b])})
        want, jc = jm.decode_step(params, jc, {"tokens": jnp.asarray(
            tok[:, a:b])})
        close(got, want, 2e-5)
    flat_t = {"/".join(str(k.key) for k in path): v for path, v in
              jax.tree_util.tree_flatten_with_path(jc)[0]}
    for key, want in flat_t.items():
        group, name = key.split("/")
        assert tuple(tc[group][name].shape) == want.shape, key
        close(tc[group][name], want, 2e-5)


def test_caches_layout_and_dtypes(lm):
    arch, jm, _, tm = lm
    tc = tm.init_caches(3, 16, torch.bfloat16)
    jc = jm.init_caches(3, 16, jnp.bfloat16)
    assert set(tc) == set(jc)
    for group in tc:
        for name, v in tc[group].items():
            want = jc[group][name]
            assert tuple(v.shape) == want.shape, (group, name)
            assert str(v.dtype).split(".")[-1] == str(want.dtype), (group,
                                                                    name)
            assert not v.any()


@pytest.mark.parametrize("arch,atol", [("mamba2-370m", 2e-3),
                                       ("zamba2-2.7b", 3e-3)])
def test_prefill_equals_stepwise(arch, atol):
    cfg = registry.get_config(arch).reduced()
    model = registry.build_model(cfg, device="cpu")
    b, t = (2, 10) if arch == "mamba2-370m" else (1, 8)
    tok = torch.from_numpy(tokens(cfg.vocab, b, t, seed=1))
    logits_pre, caches_pre = model.decode_step(
        model.init_caches(b, 32, torch.float32), {"tokens": tok})
    caches = model.init_caches(b, 32, torch.float32)
    outs = []
    for i in range(t):
        lg, caches = model.decode_step(caches, {"tokens": tok[:, i:i + 1]})
        outs.append(lg[:, 0])
    close(logits_pre, torch.stack(outs, 1), atol)
    close(caches_pre["mamba"]["ssm"], caches["mamba"]["ssm"], atol)
    close(logits_pre, model({"tokens": tok}), atol)


def test_generation_matches_reference(lm):
    _, jm, params, tm = lm
    prompts = tokens(512, 3, 16, seed=7)
    want = jengine.GenerationEngine(jm, params, max_seq=64,
                                    cache_dtype=jnp.float32).generate(
        prompts, max_new=8)
    got = GenerationEngine(tm, max_seq=64).generate(prompts, max_new=8)
    assert got.tokens.shape == (3, 8)
    assert (got.tokens == want.tokens).all()


# -- graphs, shared groups, explorer ------------------------------------------------------

@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_graphs_and_shared_groups_equal_reference(arch, reduced):
    cfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    jm = jreg.build_model(jcfg)
    for tg in (ssm_lm.ssm_graph(cfg, 512), registry.model_graph(cfg, 512),
               ssm_lm.SSMLM(cfg, device="meta").to_graph(512)):
        jg = jm.to_graph(512)
        assert tg.name == jg.name and list(tg.nodes) == list(jg.nodes)
        assert ([dataclasses.astuple(n) for n in tg.nodes.values()]
                == [dataclasses.astuple(n) for n in jg.nodes.values()])
        assert tg.edges == jg.edges
    assert ssm_lm.shared_groups(cfg) == jm.shared_groups()
    assert ssm_lm.SSMLM(cfg, device="meta").shared_groups() == \
        jm.shared_groups()
    assert cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_registry_model_ref_matches_reference(arch):
    for opts in ({"seq": 64}, {"seq": 256, "reduced": True}):
        tg, shared = ModelRef("registry", arch, opts).build()
        jg, jshared = JModelRef("registry", arch, opts).build()
        assert list(tg.nodes) == list(jg.nodes)
        assert tg.total_params == jg.total_params
        # the reference returns {} for a model without a shared block, the
        # port None (as for dense models); the memory model reads both as
        # no shared groups
        assert (shared or {}) == jshared
        assert (shared is None) == (arch == "mamba2-370m")


def test_hybrid_shared_block_counts_once():
    cfg = registry.get_config("zamba2-2.7b").reduced()
    model = ssm_lm.SSMLM(cfg, device="meta")
    groups = ssm_lm.shared_groups(cfg)
    assert sorted(set(groups.values())) == ["shared_attn", "shared_mlp"]
    n_apply = cfg.n_layers // cfg.attn_every
    assert len(groups) == 2 * n_apply
    assert sum(1 for n, _ in model.named_parameters()
               if n.startswith("shared.")) == 9     # 4 attn + 3 mlp + 2 norms


# -- weight conversion -----------------------------------------------------------------

def test_convert_rejects_mismatched_parameters(lm):
    arch, _, params, tm = lm
    flat = flat_params(params)
    with pytest.raises(KeyError, match="missing"):
        load_reference_params(tm, {k: v for k, v in flat.items()
                                   if k != "blocks/mixer/D"})
    with pytest.raises(KeyError, match="unexpected"):
        load_reference_params(tm, dict(
            flat, **{"blocks/mixer/extra": flat["blocks/ln"]}))
    with pytest.raises(ValueError, match="leading axis"):
        load_reference_params(tm, dict(
            flat, **{"blocks/ln": flat["blocks/ln"][None]}))
    with pytest.raises(ValueError, match="shape"):
        load_reference_params(tm, dict(
            flat, **{"blocks/mixer/D": flat["blocks/mixer/D"][..., :1]}))
    with pytest.raises(NotImplementedError, match="not a"):
        load_reference_params(tm, dict(flat, **{"blocks_dense/x":
                                                flat["embed"]}))
    if arch == "mamba2-370m":
        with pytest.raises(NotImplementedError, match="not a"):
            load_reference_params(tm, dict(flat, **{"shared/ln1":
                                                    flat["final_norm"]}))
