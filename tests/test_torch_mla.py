"""The port's multi-head latent attention and multi-token prediction against
the JAX package on the CPU: ``MLAAttention``'s decompressed path (the
plain and the chunked attention) and its absorbed decode path over the
latent cache (scalar and lane positions, the clamped write), and
``init_mla_cache``; then the reduced deepseek-v3-671b (MLA in every block,
a dense first block and a MoE block with a sigmoid gate, one MTP block) on
the reference's weights: logits, ``mtp_logits`` and the aux terms, decode
and generation, one SGD step and one Adafactor step.

Tolerances: attention outputs (magnitude ~1) within 1e-5; logits and
``mtp_logits`` (magnitude ~1.5) within 2e-5, the LM tests' bound; losses
within 1e-5 relative, parameters after one SGD step within 1e-5 (the
training tests' bounds) and after one Adafactor step within 1e-5 (its
update is the gradient over the root of its factored second moment,
clipped by its RMS: no sign of a vanishing gradient is taken)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as jreg  # noqa: E402
from repro.nn import attention as ja  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.training import train_lib as jtl  # noqa: E402
from repro_torch.data.synthetic import make_batch_for  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import (load_reference_params,  # noqa: E402
                                        reference_params)
from repro_torch.nn import attention as ta  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.serving import GenerationEngine  # noqa: E402
from repro_torch.serving.engine import SlotDecoder  # noqa: E402
from repro_torch.training import train_lib as ttl  # noqa: E402

torch.set_num_threads(2)

ARCH = "deepseek-v3-671b"
ATTN_ATOL, LOGIT_ATOL, LOSS_REL, PARAM_TOL = 1e-5, 2e-5, 1e-5, 1e-5
CFG = dict(d_model=48, n_heads=3, q_lora_rank=24, kv_lora_rank=16,
           qk_nope_dim=8, qk_rope_dim=4, v_head_dim=12, rope_theta=1e4)


def flat_params(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in leaves}


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=atol,
                               atol=atol)


@pytest.fixture(scope="module")
def mla():
    """(reference MLAAttention, its params, port MLAAttention on them)."""
    jm = ja.MLAAttention(ja.MLAConfig(**CFG))
    params, _ = jm.init(jax.random.PRNGKey(0))
    tm = ta.MLAAttention(ta.MLAConfig(**CFG), device="cpu")
    assert {n for n, _ in tm.named_parameters()} == set(params)
    with torch.no_grad():
        for name, v in params.items():
            getattr(tm, name).copy_(torch.from_numpy(np.array(v)))
    return jm, params, tm


def inputs(b, t, seed=0):
    return np.random.default_rng(seed).standard_normal((b, t, 48)).astype(
        np.float32)


@pytest.mark.parametrize("t", [1, 37, 2048])
def test_decompressed_path_matches_reference(mla, t):
    """Prefill/train: the plain attention below 2048 tokens, the chunked
    one from 2048, as the reference switches."""
    jm, params, tm = mla
    x = inputs(2, t)
    want = jm.apply(params, {}, jnp.asarray(x))[0]
    with torch.no_grad():
        got, cache = tm(torch.from_numpy(x))
    assert cache is None
    close(got.numpy(), want, ATTN_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_mla_cache_matches_reference(dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    want = ja.init_mla_cache(3, 20, ja.MLAConfig(**CFG), jdt)
    got = ta.init_mla_cache(3, 20, ta.MLAConfig(**CFG), dtype)
    assert set(got) == set(want) == {"ckv", "kr", "pos"}
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert not got[key].any()
    assert got["ckv"].dtype == got["kr"].dtype == dtype
    assert got["pos"].dtype == torch.int32
    lanes = ta.init_mla_cache(3, 20, ta.MLAConfig(**CFG), dtype, lanes=True)
    assert lanes["pos"].shape == (3,)


def test_absorbed_decode_matches_reference(mla):
    """A prefill into the cache, then decode steps; the last steps write
    past the capacity, where the clamped write overwrites the last slot
    as the reference's ``dynamic_update_slice`` does."""
    jm, params, tm = mla
    cap = 12
    jc = ja.init_mla_cache(2, cap, ja.MLAConfig(**CFG), jnp.float32)
    tc = ta.init_mla_cache(2, cap, ta.MLAConfig(**CFG), torch.float32)
    x = inputs(2, 15, seed=1)
    with torch.no_grad():
        for a, b in ((0, 7),) + tuple((i, i + 1) for i in range(7, 15)):
            pos = np.tile(np.arange(a, b), (2, 1))
            jy, jc = jm.apply(params, {}, jnp.asarray(x[:, a:b]),
                              positions=jnp.asarray(pos), cache=jc)
            ty, tc = tm(torch.from_numpy(x[:, a:b]),
                        positions=torch.from_numpy(pos), cache=tc)
            close(ty.numpy(), jy, ATTN_ATOL)
            assert int(tc["pos"]) == int(jc["pos"]) == b
    close(tc["ckv"].numpy(), jc["ckv"], ATTN_ATOL)
    close(tc["kr"].numpy(), jc["kr"], ATTN_ATOL)


def test_absorbed_decode_equals_decompressed(mla):
    """The absorbed step over the cache computes the decompressed
    attention's last position."""
    _, _, tm = mla
    x = torch.from_numpy(inputs(2, 9, seed=2))
    c = ta.init_mla_cache(2, 16, ta.MLAConfig(**CFG), torch.float32)
    with torch.no_grad():
        full, _ = tm(x)
        _, c = tm(x[:, :8], cache=c)
        pos = torch.full((2, 1), 8)
        last, _ = tm(x[:, 8:], positions=pos, cache=c)
    close(last[:, 0].numpy(), full[:, -1].numpy(), ATTN_ATOL)


def test_lane_cache_matches_vmapped_reference(mla):
    """Lanes at different positions: one batched step against the
    reference's step ``vmap``ped over batch-1 caches."""
    jm, params, tm = mla
    cap, plens = 10, (3, 6, 9)
    xs = [inputs(1, n + 2, seed=10 + i) for i, n in enumerate(plens)]
    jcs, tc = [], ta.init_mla_cache(3, cap, ta.MLAConfig(**CFG),
                                    torch.float32, lanes=True)
    with torch.no_grad():
        for lane, (x, n) in enumerate(zip(xs, plens)):
            jc = ja.init_mla_cache(1, cap, ja.MLAConfig(**CFG), jnp.float32)
            _, jc = jm.apply(params, {}, jnp.asarray(x[:, :n]), cache=jc)
            jcs.append(jc)
            one = ta.init_mla_cache(1, cap, ta.MLAConfig(**CFG),
                                    torch.float32)
            _, one = tm(torch.from_numpy(x[:, :n]), cache=one)
            tc["ckv"][lane], tc["kr"][lane] = one["ckv"][0], one["kr"][0]
            tc["pos"][lane] = one["pos"]
        jc = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *jcs)
        step = jax.vmap(lambda c, xx, p: jm.apply(
            params, {}, xx, positions=p, cache=c))
        for s in range(2):
            x = np.stack([xs[i][:, n + s:n + s + 1]
                          for i, n in enumerate(plens)])      # (3, 1, 1, D)
            pos = np.array([[[n + s]] for n in plens])
            jy, jc = step(jc, jnp.asarray(x), jnp.asarray(pos))
            ty, tc = tm(torch.from_numpy(x[:, 0]), positions=torch.from_numpy(
                pos[:, 0]), cache=tc)
            close(ty.numpy(), np.asarray(jy)[:, 0], ATTN_ATOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


# -- the reduced deepseek-v3-671b ----------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    jm = jreg.build_model(jreg.get_config(ARCH).reduced())
    params, _ = jm.init(jax.random.PRNGKey(0))
    tm = registry.build_model(registry.get_config(ARCH).reduced(),
                              device="cpu")
    load_reference_params(tm, flat_params(params))
    return jm, params, tm


def tokens(b, t, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (b, t)).astype(
        np.int32)


@pytest.mark.parametrize("train", [False, True])
def test_logits_mtp_and_aux_match_reference(lm, train):
    """``mtp_logits`` only when ``train`` is set, as in the reference."""
    jm, params, tm = lm
    tok = tokens(2, 33)
    jl, jaux = jm.apply(params, {}, {"tokens": jnp.asarray(tok)},
                        train=train)
    with torch.no_grad():
        tl, taux = tm.forward_aux({"tokens": torch.from_numpy(tok)},
                                  train=train)
    close(tl.numpy(), jl, LOGIT_ATOL)
    assert set(taux) == set(jaux)
    assert ("mtp_logits" in taux) == train
    for key, v in jaux.items():
        close(taux[key].numpy(), v, LOGIT_ATOL)


def test_decode_and_generation_match_reference(lm):
    """Absorbed decode through the model's latent caches, and greedy
    generation."""
    jm, params, tm = lm
    tok = tokens(2, 10, seed=1)
    jc = jm.init_caches(2, 16, jnp.float32)
    tc = tm.init_caches(2, 16, torch.float32)
    assert set(tc) == set(jc) == {"dense", "moe"}
    assert tc["moe"]["ckv"].shape == jc["moe"]["ckv"].shape
    with torch.no_grad():
        for a, b in ((0, 6), (6, 7), (7, 8)):
            jl, jc = jm.decode_step(params, jc, {"tokens": jnp.asarray(
                tok[:, a:b])})
            tl, tc = tm.decode_step(tc, {"tokens": torch.from_numpy(
                tok[:, a:b])})
            close(tl.numpy(), jl, LOGIT_ATOL)
    prompts = tokens(3, 8, seed=2)
    want = jengine.GenerationEngine(jm, params, max_seq=24,
                                    cache_dtype=jnp.float32).generate(
        prompts, max_new=8)
    got = GenerationEngine(tm, max_seq=24).generate(prompts, max_new=8)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_slot_decoder_takes_mla_lanes(lm):
    """``SlotDecoder`` over MLA's latent lane caches against the
    reference's ``vmap``ped lanes."""
    jm, params, tm = lm
    jsd = jengine.SlotDecoder(jm, params, n_slots=2, max_seq=16,
                              cache_dtype=jnp.float32)
    tsd = SlotDecoder(tm, n_slots=2, max_seq=16)
    toks = np.zeros(2, np.int32)
    for slot, plen in ((0, 5), (1, 3)):
        prompt = tokens(1, plen, seed=20 + slot)[0]
        want, got = jsd.prefill(slot, prompt), tsd.prefill(slot, prompt)
        close(got, want, LOGIT_ATOL)
        toks[slot] = int(np.argmax(got))
        for _ in range(3):
            want, got = jsd.decode(toks), tsd.decode(toks)
            close(got, want, LOGIT_ATOL)
            toks = got.argmax(-1).astype(np.int32)


def train_pair(lm, jopt_, topt_, batch):
    jm, params, _ = lm
    jcfg = jreg.get_config(ARCH).reduced()
    step = jax.jit(jtl.make_train_step(jm, jcfg, jopt_, clip_norm=None))
    jp, _, _, jmet = step(params, jopt_.init(params), {},
                          {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = registry.get_config(ARCH).reduced()
    tm = registry.build_model(cfg, device="cpu")
    load_reference_params(tm, flat_params(params))
    tstep = ttl.make_train_step(tm, cfg, topt_, clip_norm=None)
    _, tmet = tstep(topt_.init(ttl.init_params(tm)), batch)
    return (jp, {k: float(v) for k, v in jmet.items()}), (
        tm, {k: float(v) for k, v in tmet.items()})


@pytest.mark.parametrize("opt", ["sgd", "adafactor"])
def test_train_step_matches_reference(lm, opt):
    """One step with the balance, z-loss and MTP terms in the loss."""
    batch = make_batch_for(registry.get_config(ARCH).reduced(), 4, 16, 0)
    if opt == "sgd":
        opts = jopt.sgd(0.1, momentum=0.0), topt.sgd(0.1, momentum=0.0)
    else:
        opts = jopt.adafactor(1e-2), topt.adafactor(1e-2)
    (jp, jm_), (tm, tm_) = train_pair(lm, *opts, batch)
    assert set(tm_) == set(jm_) and {"mtp", "lb_loss"} <= set(tm_)
    for key in jm_:
        np.testing.assert_allclose(tm_[key], jm_[key], rtol=LOSS_REL,
                                   atol=1e-7, err_msg=key)
    got, want = reference_params(tm), flat_params(jp)
    assert set(got) == set(want) and "mtp_block/attn/w_uk" in got
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=PARAM_TOL, err_msg=k)
