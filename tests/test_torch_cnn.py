"""The port's CNN path — layers, the six zoo models' forward passes, weight
conversion, ``PartitionedCNNRunner`` and the measured-accuracy oracle —
against the JAX package on the same weights and the same numpy inputs.

Weights: drawn from numpy into the reference's parameter and state trees
(He-normal weights as the reference initialises them, and nonzero biases
and non-trivial BatchNorm scales and statistics, so that the norms do
work), carried into the port by ``load_reference_cnn``.

Tolerances: logits within ``rtol = 1e-4`` and ``atol = 1e-5 * max|logits|``
(float32 throughout; the convolutions sum in another order than XLA's,
and differences of ~1e-6 relative are observed).  The partitioned runner
repeats the monolithic forward's operations: bit-identical.  Quantized
runs: weights fake-quantized identically (``test_torch_quant.py``), but
an upstream difference of 1e-6 can move a link activation across a
rounding tie, one quantization step; the stated bound is ``1e-3 *
max|logits|`` with identical top-1, against a quantization effect of 1-5 %
of the logits' scale.  Measured accuracy agrees within one sample of 64."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.graph import linearize as jlinearize  # noqa: E402
from repro.core.quant import QuantSpec as JQ  # noqa: E402
from repro.data.synthetic import SyntheticImages as JImages  # noqa: E402
from repro.models.cnn.zoo import CNN_ZOO as J_ZOO  # noqa: E402
from repro.models.cnn.zoo import reduced_cnn as jreduced  # noqa: E402
from repro.nn import layers as jlayers  # noqa: E402
from repro.nn import module as jmodule  # noqa: E402
from repro.quantize import evaluate as jevaluate  # noqa: E402
from repro.serving.pipeline import PartitionedCNNRunner as JRunner  # noqa: E402
from repro_torch.core.graph import linearize  # noqa: E402
from repro_torch.core.quant import QuantSpec as TQ  # noqa: E402
from repro_torch.data.synthetic import SyntheticImages  # noqa: E402
from repro_torch.models.cnn.zoo import CNN_ZOO, build_cnn, reduced_cnn  # noqa: E402
from repro_torch.models.convert import flatten_tree, load_reference_cnn  # noqa: E402
from repro_torch.nn import layers, module  # noqa: E402
from repro_torch.quantize import evaluate  # noqa: E402
from repro_torch.serving import PartitionedCNNRunner  # noqa: E402

torch.set_num_threads(2)

NAMES = sorted(J_ZOO)


def _draw(tree, rng):
    """A tree of the shapes of ``tree`` filled from numpy: He-normal
    weights (fan-in the first axis of a Dense (in, out) weight, the
    trailing axes of a conv's), nonzero biases, BatchNorm scales around 1,
    means around 0, variances in [0.5, 2]."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _draw(v, rng)
            continue
        shape = v.shape
        if k == "w":
            fan = shape[0] if len(shape) == 2 else int(np.prod(shape[1:]))
            v = rng.normal(size=shape) * (2.0 / fan) ** 0.5
        elif k == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        elif k in ("bias", "b", "mean"):
            v = rng.normal(0.0, 0.1, shape)
        elif k == "var":
            v = rng.uniform(0.5, 2.0, shape)
        out[k] = jnp.asarray(v.astype(np.float32))
    return out


_PAIRS = {}


def pair(name):
    """(reference model, params, state, port model on the CPU) for the
    reduced ``name``, on the same weights."""
    if name not in _PAIRS:
        jm = jreduced(name)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        p, s = _draw(shapes[0], rng), _draw(shapes[1], rng)
        tm = reduced_cnn(name).init_weights(device="cpu")
        load_reference_cnn(tm, p, s)
        _PAIRS[name] = (jm, p, s, tm)
    return _PAIRS[name]


def jforward(jm, p, s, x):
    """The reference's eval forward, compiled once."""
    fn = jax.jit(lambda p, s, x: jm.apply(p, s, x, train=False)[0])
    return np.asarray(fn(p, s, jnp.asarray(x)))


def images(n, hw=32, seed=1):
    return np.random.default_rng(seed).normal(size=(n, 3, hw, hw)).astype(
        np.float32)


def close_logits(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


# -- the forward passes ----------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_reduced_forward_matches_reference(name):
    jm, p, s, tm = pair(name)
    x = images(2)
    want = jforward(jm, p, s, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, 10)
    close_logits(got.numpy(), want)


@pytest.mark.parametrize("name", NAMES)
def test_full_size_model_and_graph_allocate_no_weights(name):
    m = build_cnn(name)
    g = m.to_graph()
    assert g.nodes and m.graph_boundaries
    tensors = list(m.parameters()) + list(m.buffers())
    assert tensors and all(t.is_meta for t in tensors)
    assert sorted(CNN_ZOO) == NAMES


def test_layers_match_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, 7, 9)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    for k, s, pad in ((3, 2, 1), (2, None, 0), (3, 1, 1), (3, 2, 0)):
        np.testing.assert_array_equal(
            jlayers.max_pool(xj, k, s, pad), layers.max_pool(xt, k, s, pad))
        np.testing.assert_allclose(
            jlayers.avg_pool(xj, k, s, pad), layers.avg_pool(xt, k, s, pad),
            rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(jlayers.global_avg_pool(xj),
                               layers.global_avg_pool(xt), rtol=1e-6)
    # exp and tanh differ in their last bits between XLA and torch
    for name in ("relu", "silu", "gelu", "sigmoid", "swish", "identity"):
        want, _ = jlayers.act_module(name)({}, {}, xj)
        np.testing.assert_allclose(layers.act_module(name)(xt), want,
                                   rtol=1e-5, atol=1e-6)
    se_j = jlayers.SqueezeExcite(4, 2)
    se_p, _ = se_j.init(jax.random.PRNGKey(3))
    se_t = layers.SqueezeExcite(4, 2).to_empty(device="cpu")
    load_reference_cnn(se_t, se_p, {})
    want, _ = se_j.apply(se_p, {}, xj)
    np.testing.assert_allclose(se_t(xt), want, rtol=1e-5, atol=1e-6)


def test_init_weights_follows_reference_scheme():
    m = reduced_cnn("efficientnet_b0").init_weights(
        torch.Generator().manual_seed(0), device="cpu")
    again = reduced_cnn("efficientnet_b0").init_weights(
        torch.Generator().manual_seed(0), device="cpu")
    for (n, a), b in zip(m.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), n
    assert torch.equal(m.stem.bn.scale, torch.ones(8))
    assert torch.equal(m.stem.bn.var, torch.ones(8))
    assert not m.stem.bn.mean.any() and not m.stem.bn.bias.any()
    assert not m.cls.head.b.any() and not m.s1b0.se.fc1.b.any()
    w = m.head.conv.w                       # (320, 80, 1, 1): fan_in 80
    assert float(w.std()) == pytest.approx((2 / 80) ** 0.5, rel=0.05)
    assert all(not p.requires_grad for p in m.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            reduced_cnn("squeezenet11").init_weights()


def test_module_helpers_match_reference():
    _, p, s, tm = pair("efficientnet_b0")
    assert module.param_count(tm) == jmodule.param_count(p)
    assert module.param_count(dict(tm.named_parameters())) == \
        jmodule.param_count(p)
    shape = (64, 3, 5, 5)
    assert module.kaiming(shape, generator=torch.Generator().manual_seed(1)
                          ).std().item() == pytest.approx(
        (2 / 75) ** 0.5, rel=0.05)
    assert module.kaiming((300, 200)).std().item() == pytest.approx(
        (2 / 300) ** 0.5, rel=0.05)
    tree = {"a": torch.ones(2), "b": [torch.ones(1, dtype=torch.int32),
                                      torch.zeros(3)]}
    half = module.cast_floats(tree, torch.bfloat16)
    assert half["a"].dtype == torch.bfloat16
    assert half["b"][0].dtype == torch.int32
    assert half["b"][1].dtype == torch.bfloat16


def test_load_reference_cnn_rejects_what_does_not_fit():
    _, p, s, _ = pair("squeezenet11")
    fresh = reduced_cnn("squeezenet11").init_weights(device="cpu")
    flat = flatten_tree(p)
    missing = dict(flat)
    missing.pop("stem/conv/w")
    with pytest.raises(KeyError, match="missing"):
        load_reference_cnn(fresh, missing, s)
    with pytest.raises(KeyError, match="unexpected"):
        load_reference_cnn(fresh, {**flat, "extra/w": np.zeros(1)}, s)
    bad = dict(flat)
    bad["stem/conv/w"] = np.zeros((1, 2, 3, 3), np.float32)
    with pytest.raises(ValueError, match="does not fit"):
        load_reference_cnn(fresh, bad, s)
    with pytest.raises(ValueError, match="init_weights"):
        load_reference_cnn(reduced_cnn("squeezenet11"), flat, s)


def test_synthetic_images_are_the_reference_copy():
    for hw, n_classes in ((32, 10), (16, 1000)):
        want = JImages(n_classes=n_classes, hw=hw).batch(5, seed=3)
        got = SyntheticImages(n_classes=n_classes, hw=hw).batch(5, seed=3)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# -- the partitioned runner -------------------------------------------------------

@pytest.mark.parametrize("name", ["squeezenet11", "efficientnet_b0"])
@pytest.mark.parametrize("cuts", [[2], [1, 4]])
def test_partitioned_equals_monolithic(name, cuts):
    _, _, _, tm = pair(name)
    x = torch.from_numpy(images(4))
    with torch.no_grad():
        mono = tm(x)
    runner = PartitionedCNNRunner(tm, cuts, [None] * (len(cuts) + 1))
    part, rep = runner.run(x, time_stages=True)
    assert torch.equal(part, mono)
    assert len(rep.latency_s) == len(cuts) + 1 == runner.n_stages
    with torch.no_grad():       # float32 links: 4 bytes an element
        assert rep.link_bytes == [4 * _prefix(tm, c, x).numel()
                                  for c in cuts]


def _prefix(tm, c, x):
    for _, b in tm.blocks[:c + 1]:
        x = b(x)
    return x


@pytest.mark.parametrize("name", ["squeezenet11", "efficientnet_b0"])
@pytest.mark.parametrize("cuts,bits", [([4], (16, 8)), ([2, 6], (16, 8, 8)),
                                       ([1, 4], (8, 4, 8))])
def test_quantized_runner_matches_reference(name, cuts, bits):
    jm, p, s, tm = pair(name)
    x = images(16)
    want, jrep = JRunner(jm, p, s, cuts, [JQ(b) for b in bits]).run(
        jnp.asarray(x))
    want = np.asarray(want)
    runner = PartitionedCNNRunner(tm, cuts, [TQ(b) for b in bits])
    got, rep = runner.run(torch.from_numpy(x))
    got = got.numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-3 * scale
    assert (got.argmax(-1) == want.argmax(-1)).all()
    assert rep.link_bytes == jrep.link_bytes
    mono = jforward(jm, p, s, x)
    # the quantization itself moves the logits far more than the bound
    assert np.abs(want - mono).max() > 3e-3 * scale
    # the model's own weights stay float
    assert torch.equal(tm.stem.conv.w, torch.from_numpy(
        np.array(p["stem"]["conv"]["w"])))


def test_runner_rejects_a_wrong_number_of_specs():
    _, _, _, tm = pair("squeezenet11")
    with pytest.raises(ValueError, match="3 quant specs for 2 stages"):
        PartitionedCNNRunner(tm, [2], [TQ(8)] * 3)


# -- measured accuracy --------------------------------------------------------------

def test_measured_accuracy_matches_reference():
    jm, p, s, tm = pair("efficientnet_b0")
    vx, vy = SyntheticImages(n_classes=10, hw=32).eval_set(64)
    sched, jsched = linearize(tm.to_graph()), jlinearize(jm.to_graph())
    assert [l.name for l in sched] == [l.name for l in jsched]
    n = len(sched)
    specs = (16, 16, 8, 8)
    want = jevaluate.cnn_measured_accuracy(jm, p, s, jsched, vx, vy,
                                           [JQ(b) for b in specs])
    got = evaluate.cnn_measured_accuracy(tm, sched, vx, vy,
                                         [TQ(b) for b in specs])
    for cuts in ((-1, -1, -1), (5, 20, n - 3), (10, 10, 30), (-1, 15, -1),
                 (3, 40, 60)):
        assert abs(got(cuts) - want(cuts)) <= 1 / 64, cuts
    assert got((5, 20, n - 3)) == got((5, 20, n - 3))      # cached
    for bits in (4, 8):
        assert abs(evaluate.quantized_eval(tm, vx, vy, TQ(bits))
                   - jevaluate.quantized_eval(jm, p, s, vx, vy, JQ(bits))) \
            <= 1 / 64
