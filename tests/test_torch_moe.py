"""The port's mixture-of-experts slice against the JAX package on the CPU:
``nn/moe.py`` (routing positions, dispatch and combine, ``MoEFFN``'s output
and aux terms) and the reduced deepseek-moe-16b (a dense first block and a
MoE block, 4 experts top-2 plus 1 shared expert) on the reference's weights
(carried by ``repro_torch.models.convert``): the forward and its aux, prefill
and decode, ``GenerationEngine``'s tokens, ``SlotDecoder``'s lanes against
the reference's ``vmap``ped batch-1 lanes, one SGD step and four-microbatch
accumulation, and the weights and checkpoints crossing both ways with the
model's two stacks.

Tolerances: routing slots and ``keep`` are integers and booleans, compared
exactly.  Float results are float32 summed in other orders by XLA and by
torch: ``MoEFFN`` outputs (magnitude ~1) within 1e-5 and its aux terms
within 1e-5 relative; the model's logits (magnitude ~1.5) within 2e-5,
the LM tests' bound; losses within 1e-5 relative and parameters after one
SGD step within 1e-5, the training tests' bounds."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.training import train_lib as jtl  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.data.synthetic import make_batch_for  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import (load_reference_params,  # noqa: E402
                                        reference_leaves, reference_params)
from repro_torch.nn import moe as tmoe  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.serving import GenerationEngine  # noqa: E402
from repro_torch.serving.engine import SlotDecoder  # noqa: E402
from repro_torch.training import train_lib as ttl  # noqa: E402

torch.set_num_threads(2)

ARCH = "deepseek-moe-16b"
FFN_ATOL, AUX_REL, LOGIT_ATOL = 1e-5, 1e-5, 2e-5
LOSS_REL, PARAM_TOL = 1e-5, 1e-5


def flat_params(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in leaves}


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=atol,
                               atol=atol)


# -- routing ----------------------------------------------------------------------

@pytest.mark.parametrize("b,t,k,e,cap", [
    (1, 16, 2, 4, 8), (2, 33, 2, 4, 4), (3, 64, 6, 64, 4),
    (2, 128, 8, 16, 70), (4, 7, 3, 5, 1)])
def test_route_positions_bit_exact(b, t, k, e, cap):
    """Slots and ``keep`` exactly the reference's, dropped choices in the
    sink slot ``e * cap``; choices skewed to two experts so that some
    overflow."""
    rng = np.random.default_rng(b * 1000 + t)
    p = np.full(e, 1.0)
    p[:2] = 4.0 * e
    idx = rng.choice(e, size=(b, t, k), p=p / p.sum()).astype(np.int32)
    js, jk = jmoe._route_positions(jnp.asarray(idx), cap, e, k)
    ts, tk = tmoe.route_positions(torch.from_numpy(idx).long(), cap, e, k)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert (~tk).any() == (np.bincount(idx.ravel(), minlength=e).max() > cap
                           or b * t * k > b * e * cap)


def test_capacity_is_the_reference_formula():
    for tg, k, e, cf in ((2048, 6, 64, 1.25), (1, 8, 256, 1.25),
                         (8, 6, 64, 1.25), (16, 2, 4, 0.3)):
        assert tmoe.capacity(tg, k, e, cf) == max(int(tg * k * cf / e), 4)


# -- MoEFFN ----------------------------------------------------------------------

def moe_pair(sigmoid, shared, cf, d=32, ff=24, e=4, k=2, seed=0):
    """(reference MoEFFN, its params, port MoEFFN on the same weights)."""
    jm = jmoe.MoEFFN(d, ff, e, k, shared, capacity_factor=cf,
                     sigmoid_gate=sigmoid)
    params, _ = jm.init(jax.random.PRNGKey(seed))
    tm = tmoe.MoEFFN(d, ff, e, k, shared, capacity_factor=cf,
                     sigmoid_gate=sigmoid, device="cpu")
    assert {n for n, _ in tm.named_parameters()} == set(params)
    with torch.no_grad():
        for name, v in params.items():
            getattr(tm, name).copy_(torch.from_numpy(np.array(v)))
    return jm, params, tm


def check_ffn(got, want):
    (ty, taux), (jy, jaux) = got, want
    close(ty.numpy(), jy, FFN_ATOL)
    assert set(taux) == set(jaux) == {"lb_loss", "z_loss", "dropped"}
    for key in jaux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=AUX_REL, atol=1e-7, err_msg=key)


@pytest.mark.parametrize("sigmoid", [False, True])
@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("cf", [1.25, 0.3])
def test_moe_ffn_matches_reference(sigmoid, shared, cf):
    """Output and aux against the reference for softmax and sigmoid gates,
    with and without shared experts, at the default capacity factor and at
    one small enough that tokens drop (with groups of 40 tokens, top-2 of 4
    experts: 0.3 gives a capacity of 6 of the ~20 choices an expert
    gets)."""
    jm, params, tm = moe_pair(sigmoid, shared, cf)
    x = np.random.default_rng(3).standard_normal((2, 40, 32)).astype(
        np.float32)
    want = jm.apply(params, {}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    check_ffn(got, want)
    if cf < 1:
        assert float(got[1]["dropped"]) > 0.3


@pytest.mark.parametrize("sigmoid", [False, True])
def test_moe_ffn_decode_step_is_one_group(sigmoid):
    """t == 1, b > 1: all rows route as one group, as in the reference
    (8 tokens, top-2 of 4 experts: capacity 5, so a popular expert drops
    some)."""
    jm, params, tm = moe_pair(sigmoid, 1, 1.25, seed=1)
    x = np.random.default_rng(4).standard_normal((8, 1, 32)).astype(
        np.float32)
    want = jm.apply(params, {}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    check_ffn(got, want)


def test_moe_ffn_lanes_route_each_row_alone():
    """``lanes``: each row its own group, as the reference's step ``vmap``ped
    over batch-1 lanes (each row through the reference alone)."""
    jm, params, tm = moe_pair(False, 1, 1.25, seed=2)
    x = np.random.default_rng(5).standard_normal((6, 1, 32)).astype(
        np.float32)
    want = np.concatenate([np.asarray(jm.apply(params, {}, jnp.asarray(
        x[i:i + 1]))[0]) for i in range(6)])
    with torch.no_grad():
        got, aux = tm(torch.from_numpy(x), lanes=True)
    close(got.numpy(), want, FFN_ATOL)
    assert float(aux["dropped"]) == 0.0          # capacity 4 per lane


def test_moe_ffn_gradients_match_reference():
    """The gradient of the output and of the balance and z losses with
    respect to the input and every weight, with tokens dropped."""
    jm, params, tm = moe_pair(False, 1, 0.5, seed=3)
    x = np.random.default_rng(6).standard_normal((2, 24, 32)).astype(
        np.float32)

    def jloss(p, xx):
        y, aux = jm.apply(p, {}, xx)
        return (y ** 2).mean() + aux["lb_loss"] + 1e-3 * aux["z_loss"]
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tm.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tm(tx)
    ((y ** 2).mean() + aux["lb_loss"] + 1e-3 * aux["z_loss"]).backward()
    close(tx.grad.numpy(), jgx, FFN_ATOL)
    for name, g in jg.items():
        close(getattr(tm, name).grad.numpy(), g, FFN_ATOL)


# -- the reduced deepseek-moe-16b ------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    """(reference model, its params, port model on the same weights)."""
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
def test_forward_and_aux_match_reference(lm, train):
    jm, params, tm = lm
    tok = tokens(3, 40)
    jl, jaux = jm.apply(params, {}, {"tokens": jnp.asarray(tok)},
                        train=train)
    with torch.no_grad():
        tl, taux = tm.forward_aux({"tokens": torch.from_numpy(tok)},
                                  train=train)
    close(tl.numpy(), jl, LOGIT_ATOL)
    assert set(taux) == set(jaux) == {"lb_loss", "z_loss", "dropped"}
    for key in jaux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=AUX_REL, atol=1e-7, err_msg=key)
    with torch.no_grad():
        assert torch.equal(tm({"tokens": torch.from_numpy(tok)}), tl)


def test_decode_steps_match_reference(lm):
    """Prefill (per-row groups) then decode steps (one group of the three
    rows) against the reference's, caches keyed by stack."""
    jm, params, tm = lm
    tok = tokens(3, 12, seed=1)
    jc = jm.init_caches(3, 16, jnp.float32)
    tc = tm.init_caches(3, 16, torch.float32)
    assert set(tc) == set(jc) == {"dense", "moe"}
    for key in jc:
        assert tc[key]["k"].shape == jc[key]["k"].shape
    with torch.no_grad():
        for a, b in ((0, 8), (8, 9), (9, 10), (10, 11)):
            jl, jc = jm.decode_step(params, jc, {"tokens": jnp.asarray(
                tok[:, a:b])})
            tl, tc = tm.decode_step(tc, {"tokens": torch.from_numpy(
                tok[:, a:b])})
            close(tl.numpy(), jl, LOGIT_ATOL)
    for key in jc:
        np.testing.assert_array_equal(tc[key]["pos"].numpy(),
                                      np.asarray(jc[key]["pos"]))
        close(tc[key]["k"].numpy(), jc[key]["k"], LOGIT_ATOL)


def test_generation_matches_reference(lm):
    jm, params, tm = lm
    prompts = tokens(4, 10, seed=2)
    want = jengine.GenerationEngine(jm, params, max_seq=32,
                                    cache_dtype=jnp.float32).generate(
        prompts, max_new=10)
    got = GenerationEngine(tm, max_seq=32).generate(prompts, max_new=10)
    assert got.tokens.shape == (4, 10)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_slot_decoder_matches_reference(lm):
    """Lanes admitted at different times with prompts of different lengths
    against the reference's ``SlotDecoder`` (batch-1 lanes under
    ``vmap``: each lane's MoE tokens route as their own group)."""
    jm, params, tm = lm
    rng = np.random.default_rng(11)
    n_slots, cap = 3, 24
    jsd = jengine.SlotDecoder(jm, params, n_slots=n_slots, max_seq=cap,
                              cache_dtype=jnp.float32)
    tsd = SlotDecoder(tm, n_slots=n_slots, max_seq=cap)
    toks = np.zeros(n_slots, np.int32)
    for step, (slot, plen) in enumerate([(0, 6), (2, 3), (1, 9)]):
        prompt = rng.integers(0, 512, plen).astype(np.int32)
        want, got = jsd.prefill(slot, prompt), tsd.prefill(slot, prompt)
        close(got, want, LOGIT_ATOL)
        toks[slot] = int(np.argmax(got))
        for _ in range(3 + step):
            want, got = jsd.decode(toks), tsd.decode(toks)
            close(got, want, LOGIT_ATOL)
            toks = got.argmax(-1).astype(np.int32)
    for key in ("dense", "moe"):
        assert (tsd.caches[key]["pos"].numpy()
                == np.asarray(jsd.caches[key]["pos"]).T).all()
    tsd.free(1)
    jsd.free(1)
    assert (tsd.caches["moe"]["pos"].numpy()
            == np.asarray(jsd.caches["moe"]["pos"]).T).all()


# -- training ----------------------------------------------------------------------

def run_ref(jm, cfg, params, opt, batch, **kw):
    step = jax.jit(jtl.make_train_step(jm, cfg, opt, **kw))
    p, _, _, m = step(params, opt.init(params), {},
                      {k: jnp.asarray(v) for k, v in batch.items()})
    return p, {k: float(v) for k, v in m.items()}


def run_port(params, opt, batch, **kw):
    cfg = registry.get_config(ARCH).reduced()
    tm = registry.build_model(cfg, device="cpu")
    load_reference_params(tm, flat_params(params))
    step = ttl.make_train_step(tm, cfg, opt, **kw)
    _, m = step(opt.init(ttl.init_params(tm)), batch)
    return tm, {k: float(v) for k, v in m.items()}


def params_close(tm, jparams, atol):
    got, want = reference_params(tm), flat_params(jparams)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("grad_accum", [1, 4])
def test_sgd_step_matches_reference(lm, grad_accum):
    """One SGD step (momentum 0, no clip), the loss with the balance and
    z-loss terms: metrics within 1e-5, parameters within 1e-5; with four
    microbatches each microbatch routes on its own, as the reference's
    ``lax.scan`` does."""
    jm, params, _ = lm
    cfg = jreg.get_config(ARCH).reduced()
    batch = make_batch_for(registry.get_config(ARCH).reduced(), 8, 16, 0)
    opt_j, opt_t = jopt.sgd(0.1, momentum=0.0), topt.sgd(0.1, momentum=0.0)
    jp, jm_ = run_ref(jm, cfg, params, opt_j, batch, clip_norm=None,
                      grad_accum=grad_accum)
    tm, tm_ = run_port(params, opt_t, batch, clip_norm=None,
                       grad_accum=grad_accum)
    assert set(tm_) == set(jm_) and {"lb_loss", "dropped"} <= set(tm_)
    for key in jm_:
        np.testing.assert_allclose(tm_[key], jm_[key], rtol=LOSS_REL,
                                   atol=1e-7, err_msg=key)
    params_close(tm, jp, PARAM_TOL)


def test_grad_accum_within_the_reference_moe_bound(lm):
    """Four microbatches against one: the routing of a microbatch differs
    from the whole batch's, so the reference's own bound for MoE,
    tests/test_grad_accum.py's 0.15 on parameters."""
    _, params, _ = lm
    batch = make_batch_for(registry.get_config(ARCH).reduced(), 8, 16, 0)
    out = [run_port(params, topt.sgd(0.1, momentum=0.0), batch,
                    clip_norm=None, grad_accum=ga) for ga in (1, 4)]
    (a, la), (b, lb) = out
    assert abs(la["loss"] - lb["loss"]) < 0.15 * 10
    pa, pb = reference_params(a), reference_params(b)
    assert max(float((pa[k] - pb[k]).abs().max()) for k in pa) < 0.15


def test_reference_leaves_follow_both_stacks(lm):
    _, params, tm = lm
    leaves = reference_leaves(tm)
    want = {k: v.shape for k, v in flat_params(params).items()}
    assert {k: leaf.shape for k, leaf in leaves.items()} == want
    assert leaves["blocks_moe/moe/w_gate"].params[0] is tm.blocks[1].moe.w_gate
    assert leaves["blocks_dense/mlp/w_up"].params[0] is tm.blocks[0].mlp.w_up


def test_checkpoints_cross_both_ways(lm, tmp_path):
    """The port's checkpoint restores into the reference's tree with both
    stacks, and the reference's restores into the port; the forwards
    agree."""
    jm, params, tm = lm
    tckpt.save(str(tmp_path / "port"), reference_params(tm), step=1)
    back = jckpt.restore(str(tmp_path / "port"), params)
    for k, v in flat_params(back).items():
        np.testing.assert_array_equal(v, flat_params(params)[k])
    jckpt.save(str(tmp_path / "ref"), params, step=2)
    fresh = registry.build_model(dataclasses.replace(tm.cfg), device="cpu",
                                 generator=torch.Generator().manual_seed(4))
    like = {k: v.numpy() for k, v in reference_params(fresh).items()}
    load_reference_params(fresh, tckpt.restore(str(tmp_path / "ref"), like))
    tok = tokens(2, 12, seed=3)
    with torch.no_grad():
        got = fresh({"tokens": torch.from_numpy(tok)}).numpy()
    want = jm.apply(params, {}, {"tokens": jnp.asarray(tok)})[0]
    close(got, want, LOGIT_ATOL)
