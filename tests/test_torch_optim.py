"""The port's optimizers and schedules (``repro_torch.optim``) against the
JAX package's on the CPU, on the same numpy-drawn gradients: the three
schedules, ``sgd`` (momentum, Nesterov), ``adamw`` and ``adafactor`` over
three updates, ``clip_by_global_norm``, ``get_optimizer``'s ``KeyError``;
the per-leaf rules decided per *reference* leaf on reduced smollm-360m and
mamba2-370m, whose block parameters are separate modules in the port and
one stacked leaf in the reference (AdamW's decay of the stacked norm
scales and ``A_log``, Adafactor's update RMS over the whole stacked leaf);
and Adafactor's symmetry under the transpose of a Dense weight.

Tolerance: 1e-6 absolute on updates and states of magnitude <= ~1e-2 (the
same float32 operations; only the sums' orders differ)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as jreg  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import (load_reference_params,  # noqa: E402
                                        reference_leaves)
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-6
# a 1-D leaf, a small 2-D one, a factored (>= 128 x 128) stacked one and
# a 2-D one factored on one side only
SHAPES = {"b": (7,), "w": (5, 6), "blocks/wq": (2, 130, 140),
          "wide": (3, 200)}


def draws(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def as_j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def as_t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def close(t_tree, j_tree, atol=TOL):
    assert set(t_tree) == set(j_tree)
    for k in j_tree:
        np.testing.assert_allclose(np.asarray(t_tree[k]), np.asarray(j_tree[k]),
                                   rtol=0, atol=atol, err_msg=k)


def flat_params(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in leaves}


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)),
    ("cosine_decay", (1e-3, 10)),
    ("cosine_decay", (1e-3, 10, 0.0)),
    ("warmup_cosine", (2e-3, 3, 12)),
    ("warmup_cosine", (3e-4, 0, 10)),
])
def test_schedules_match_reference(name, args):
    steps = np.arange(0, 16, dtype=np.int32)
    jf, tf = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    want = [float(jf(jnp.asarray(s))) for s in steps]
    got = [float(tf(torch.tensor(int(s), dtype=torch.int32))) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


OPTIMIZERS = [
    ("sgd", dict(momentum=0.9)),
    ("sgd", dict(momentum=0.9, nesterov=True)),
    ("sgd", dict(momentum=0.0)),
    ("adamw", {}),
    ("adamw", dict(weight_decay=0.0)),
    ("adafactor", {}),
    ("adafactor", dict(weight_decay=0.1)),
]


@pytest.mark.parametrize("name,kw", OPTIMIZERS)
def test_three_updates_match_reference(name, kw):
    """Three updates of the same gradients from the same parameters, each
    update's tensors and the final state within TOL."""
    lr_j = jsched.warmup_cosine(1e-2, 1, 5)
    lr_t = tsched.warmup_cosine(1e-2, 1, 5)
    jo = getattr(jopt, name)(lr_j, **kw)
    to = getattr(topt, name)(lr_t, **kw)
    params = draws(0)
    jp, tp = as_j(params), as_t(params)
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        g = draws(10 + i, scale=0.1)
        ju, js = jo.update(as_j(g), js, jp)
        tu, ts = to.update(as_t(g), ts, tp)
        close(tu, ju)
        jp = jopt.apply_updates(jp, ju)
        tp = {k: tp[k] + tu[k] for k in tp}
    close(tp, jp)
    assert int(ts["step"]) == int(js["step"]) == 3
    if name == "adafactor":
        for k in SHAPES:
            close(ts["slots"][k], js["slots"][k])
        assert set(ts["slots"]["blocks/wq"]) == {"vr", "vc"}
        assert set(ts["slots"]["wide"]) == {"v"}
    else:
        for part in ("mu",) if name == "sgd" else ("m", "v"):
            close(ts[part], js[part])


def test_clip_by_global_norm_matches_reference():
    g = draws(3)
    for max_norm in (0.5, 1e6):
        jc, jn = jopt.clip_by_global_norm(as_j(g), max_norm)
        tc, tn = topt.clip_by_global_norm(as_t(g), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        close(tc, jc, atol=1e-6 * max(1.0, float(jn)))


def test_get_optimizer_names():
    assert topt.get_optimizer("sgd", 0.1).init is not None
    assert topt.get_optimizer("adafactor", 0.1, weight_decay=0.1)
    with pytest.raises(KeyError, match="unknown optimizer 'lion'"):
        topt.get_optimizer("lion", 1e-3)


# -- the stacked-leaf rule ------------------------------------------------------

def lm_pair(arch):
    jcfg = jreg.get_config(arch).reduced()
    params, _ = jreg.build_model(jcfg).init(jax.random.PRNGKey(0))
    tm = registry.build_model(registry.get_config(arch).reduced(),
                              device="cpu")
    load_reference_params(tm, flat_params(params))
    return flat_params(params), tm


def leaf_grads(leaves, seed, layer_scale=(1.0, 100.0)):
    """Gradients of the reference leaves' shapes, each stacked layer scaled
    by its own factor, so a per-layer RMS differs from the leaf's."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, leaf in leaves.items():
        g = rng.normal(size=leaf.shape).astype(np.float32) * 1e-2
        if len(leaf.params) > 1:
            g = g.reshape(len(leaf.params), -1)
            g *= np.resize(np.asarray(layer_scale, np.float32),
                           len(leaf.params))[:, None]
            g = g.reshape(leaf.shape)
        out[k] = g
    return out


@pytest.mark.parametrize("arch,decayed", [
    ("smollm-360m", ("blocks_dense/ln1", "blocks_dense/ln2")),
    ("mamba2-370m", ("blocks/ln", "blocks/mixer/A_log", "blocks/mixer/D",
                     "blocks/mixer/dt_bias")),
])
def test_adamw_decays_stacked_leaves_as_the_reference(arch, decayed):
    """AdamW decays leaves of >= 2 dimensions: a stacked norm scale or
    ``A_log`` is (L, ...) in the reference, one 1-D tensor a block in the
    port, and is decayed all the same; ``final_norm`` is 1-D in both and
    is not."""
    flat, tm = lm_pair(arch)
    leaves = reference_leaves(tm)
    assert set(leaves) == set(flat)
    for k in decayed:
        assert len(leaves[k].shape) >= 2 and leaves[k].params[0].dim() == 1, k
    for zero_grads in (True, False):
        g = leaf_grads(leaves, 1)
        if zero_grads:
            g = {k: np.zeros_like(v) for k, v in g.items()}
        jo, to = jopt.adamw(1e-2, weight_decay=0.1), topt.adamw(
            1e-2, weight_decay=0.1)
        tp = topt.stacked_params(leaves)
        ju, _ = jo.update(as_j(g), jo.init(as_j(flat)), as_j(flat))
        tu, _ = to.update(as_t(g), to.init(tp), tp)
        close(tu, ju)
        if zero_grads:       # the update is the decay alone
            for k in decayed:
                np.testing.assert_allclose(
                    tu[k].numpy(), -1e-2 * 0.1 * flat[k], rtol=1e-6)
            assert not tu["final_norm"].any()


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-370m"])
def test_adafactor_rms_over_the_stacked_leaf(arch):
    """Adafactor clips each update by its RMS over the reference's whole
    (stacked) leaf and factors by the leaf's trailing dimensions.  The
    second gradients grow 10x in one layer and shrink 10x in the other, so
    a clip per layer would scale that update otherwise."""
    flat, tm = lm_pair(arch)
    leaves = reference_leaves(tm)
    gs = [leaf_grads(leaves, 2, (1.0, 1.0)), leaf_grads(leaves, 3, (10.0, 0.1))]

    def two_updates(opt, params, grads):
        state, ups = opt.init(params), []
        for g in grads:
            u, state = opt.update(g, state, params)
            ups.append(u)
        return ups[-1]

    jo = jopt.adafactor(1e-2, weight_decay=0.1)
    to = topt.adafactor(1e-2, weight_decay=0.1)
    tp = topt.stacked_params(leaves)
    close(two_updates(to, tp, [as_t(g) for g in gs]),
          two_updates(jo, as_j(flat), [as_j(g) for g in gs]))
    key = next(k for k, l in leaves.items() if len(l.params) > 1
               and l.params[0].dim() == 2)
    whole = two_updates(to, {key: tp[key]}, [{key: torch.from_numpy(
        g[key])} for g in gs])[key]
    per_layer = torch.stack([two_updates(
        to, {key: tp[key][i]}, [{key: torch.from_numpy(g[key][i])}
                                for g in gs])[key]
        for i in range(len(leaves[key].params))])
    assert float((per_layer - whole).abs().max()) > 1e-2 * float(
        whole.abs().max())


def test_adafactor_is_symmetric_under_transpose():
    """A Dense weight is (out, in) in the port and (in, out) in the
    reference: the factored second moment's row and column means swap, the
    normaliser (mean of the row means = mean of the column means) does
    not, so the update is the transpose."""
    rng = np.random.default_rng(5)
    p = rng.normal(size=(160, 300)).astype(np.float32)
    opt = topt.adafactor(1e-2, weight_decay=0.1)
    a = {"w": torch.from_numpy(p)}
    b = {"w": torch.from_numpy(np.ascontiguousarray(p.T))}
    sa, sb = opt.init(a), opt.init(b)
    for i in range(3):
        g = rng.normal(size=p.shape).astype(np.float32) * (i + 1)
        ua, sa = opt.update({"w": torch.from_numpy(g)}, sa, a)
        ub, sb = opt.update({"w": torch.from_numpy(np.ascontiguousarray(
            g.T))}, sb, b)
        np.testing.assert_allclose(ua["w"].numpy(), ub["w"].numpy().T,
                                   rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(sa["slots"]["w"]["vr"].numpy(),
                               sb["slots"]["w"]["vc"].numpy(), rtol=1e-6)
