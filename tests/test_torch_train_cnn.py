"""The port's CNN training against the JAX package on the CPU, on the same
weights (drawn with numpy in the reference's scheme and carried by
``models.convert.load_reference_cnn``) and the same synthetic images: the
classifier train step of reduced SqueezeNet, EfficientNet-B0 and
ResNet-50 (BatchNorm on the batch's statistics, its running statistics
updated as the reference updates them) and QAT at 4 bits.

Tolerances: losses 1e-5 relative; parameters 1e-5 absolute and BatchNorm
running statistics 1e-5 relative and absolute after two SGD steps (the
convolutions' backward and the batch variances sum in other orders: a
variance of ~3 moved by 1.2e-5).  QAT: one step's parameters and state as
the classifier step's; after several steps the quantized models' losses
within 1e-3, since a weight on a rounding boundary may land in the other
bin."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.quant import QuantSpec as JQ  # noqa: E402
from repro.data.synthetic import SyntheticImages as JImages  # noqa: E402
from repro.data.synthetic import batch_iterator as jbatch_iterator  # noqa: E402
from repro.models.cnn.zoo import reduced_cnn as jreduced  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.quantize import evaluate as jevaluate  # noqa: E402
from repro.training import train_lib as jtl  # noqa: E402
from repro_torch.core.quant import QuantSpec  # noqa: E402
from repro_torch.data.synthetic import (SyntheticImages,  # noqa: E402
                                        batch_iterator)
from repro_torch.models.cnn.zoo import reduced_cnn  # noqa: E402
from repro_torch.models.convert import (load_reference_cnn,  # noqa: E402
                                        reference_params)
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.quantize import evaluate as tevaluate  # noqa: E402
from repro_torch.training import train_lib as ttl  # noqa: E402

torch.set_num_threads(2)

LOSS_REL = 1e-5


def flat_params(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in leaves}


def params_close(model, jparams, atol):
    got, want = reference_params(model), flat_params(jparams)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=atol, err_msg=k)


def _init_like(tree, rng):
    """The reference's initialisation scheme drawn with numpy (its eager
    ``init`` costs seconds of XLA compiles): He-normal weights (fan-in the
    first axis of a Dense (in, out) weight, the trailing axes of a
    conv's), zero biases, BatchNorm scale 1, bias 0, mean 0, variance 1."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _init_like(v, rng)
            continue
        if k == "w":
            fan = v.shape[0] if len(v.shape) == 2 else int(np.prod(v.shape[1:]))
            a = rng.normal(size=v.shape) * (2.0 / fan) ** 0.5
        else:
            a = np.full(v.shape, 1.0 if k in ("scale", "var") else 0.0)
        out[k] = jnp.asarray(a.astype(np.float32))
    return out


def cnn_pair(name):
    jm = jreduced(name)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    p, s = _init_like(shapes[0], rng), _init_like(shapes[1], rng)
    tm = reduced_cnn(name).init_weights(device="cpu")
    load_reference_cnn(tm, p, s)
    return jm, p, s, tm


def state_close(tm, js, tol):
    """BatchNorm running statistics within ``tol``, relative and absolute:
    a variance of ~3 moves by ~1e-5 with its sum's order."""
    for name, buf in tm.named_buffers():
        node = js
        for part in name.split("."):
            node = node[part]
        np.testing.assert_allclose(buf.numpy(), np.asarray(node), rtol=tol,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("name", ["squeezenet11", "efficientnet_b0",
                                  "resnet50"])
def test_classifier_step_matches_reference(name):
    """Two SGD steps (momentum 0.9, clip 1.0) of the reduced CNN: loss and
    accuracy of each, parameters and BatchNorm state after."""
    jm, p, s, tm = cnn_pair(name)
    jo, to = jopt.sgd(0.05), topt.sgd(0.05)
    jstep = jax.jit(jtl.make_classifier_train_step(jm, jo))
    tstep = ttl.make_classifier_train_step(tm, to)
    ds = JImages(noise=0.2)
    js_, ts_ = jo.init(p), to.init(ttl.init_params(tm))
    for i in range(2):
        x, y = ds.batch(16, i)
        p, js_, s, jmt = jstep(p, js_, s, jnp.asarray(x), jnp.asarray(y))
        ts_, tmt = tstep(ts_, x, y)
        np.testing.assert_allclose(float(tmt["loss"]), float(jmt["loss"]),
                                   rtol=LOSS_REL)
        assert float(tmt["acc"]) == float(jmt["acc"])
    assert not tm.training
    params_close(tm, p, 1e-5)
    state_close(tm, s, 1e-5)
    vx, vy = ds.eval_set(32)
    with torch.no_grad():
        want = float((tm(torch.from_numpy(vx)).argmax(-1).numpy() == vy)
                     .mean())
    assert ttl.evaluate_classifier(tm, vx, vy) == want


def test_qat_finetune_matches_reference():
    """One QAT step at 4 bits: parameters and state within 1e-5.  Several
    steps: the quantized models' losses within 1e-3 (a weight on a rounding
    boundary may land in the other bin)."""
    spec = (4, False)
    for steps in (1, 3):
        jm, p, s, tm = cnn_pair("squeezenet11")
        ds = JImages(noise=0.2)
        jp, jstate = jevaluate.qat_finetune(
            jm, p, s, JQ(bits=spec[0]), jopt.adamw(5e-4),
            jbatch_iterator(ds, 16, start_seed=500), steps=steps)
        out = tevaluate.qat_finetune(
            tm, QuantSpec(bits=spec[0]), topt.adamw(5e-4),
            batch_iterator(SyntheticImages(noise=0.2), 16, start_seed=500),
            steps=steps)
        assert out is tm and not tm.training
        if steps == 1:
            params_close(tm, jp, 1e-5)
            state_close(tm, jstate, 1e-5)
        x, y = ds.batch(32, 7)
        jl = float(jax.jit(lambda p, s, x, y: jtl.cross_entropy(jm.apply(
            jevaluate.quantize_pytree(p, JQ(bits=4)), s, x)[0], y))(
                jp, jstate, jnp.asarray(x), jnp.asarray(y)))
        with torch.no_grad():
            tl = float(ttl.cross_entropy(torch.func.functional_call(
                tm, tevaluate.quantize_pytree(tm, QuantSpec(bits=4)),
                (torch.from_numpy(x),)), torch.from_numpy(y)))
        assert abs(tl - jl) <= 1e-3, (steps, tl, jl)
