"""The port's quantization (``repro_torch.core.quant``) and its fake-quant
int8 product (``kernels.ops.quant_matmul`` through its plain version)
against the JAX package, on the same numpy inputs.

Tolerances: calibration by min/max, scales, zero points, fake-quant,
``quantize_tensor`` and ``quantize_pytree`` repeat the reference's float32
operations in its order, so they are compared exactly.  Percentile
calibration is compared with NumPy's percentile (the definition) to 1e-6,
and with JAX's within 5e-5 of the tensor's largest magnitude: XLA
evaluates the reference's ``q / 100`` as ``q * 0.01``, which moves the
interpolation point by ~1e-4 of a rank; a fake-quant built on that range
is then within one quantization step.  The product's plain version is
held to the reference's own ``rtol = atol = 1e-5``
(``tests/test_kernels.py``)."""

import dataclasses
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import quant as jq  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.quant_matmul import quant_matmul as pl_quant_matmul  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.kernels import ops, quant_matmul  # noqa: E402
from repro_torch.nn.layers import Conv2d, Dense  # noqa: E402

torch.set_num_threads(2)

SPECS = [(bits, sym) for bits in (4, 8, 16) for sym in (True, False)]
CHANNELS = [(False, 0), (True, 0), (True, 1), (True, 3)]


def spread(shape, seed=0):
    """Normal values whose leading-axis slices span three decades."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) * np.logspace(-2, 1, shape[0]).reshape(
        (-1,) + (1,) * (len(shape) - 1))
    return x.astype(np.float32)


def specs(bits, sym, per_channel=False, axis=0):
    return (jq.QuantSpec(bits, sym, per_channel, axis),
            tq.QuantSpec(bits, sym, per_channel, axis))


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


# -- calibration, scales, fake-quant: exact -------------------------------------

@pytest.mark.parametrize("bits,sym", SPECS)
@pytest.mark.parametrize("per_channel,axis", CHANNELS)
def test_minmax_quantization_matches_reference_exactly(bits, sym, per_channel,
                                                       axis):
    x = spread((16, 8, 3, 5), seed=bits)
    js, ts = specs(bits, sym, per_channel, axis)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    lo_j, hi_j = jq.calibrate(xj, js)
    lo_t, hi_t = tq.calibrate(xt, ts)
    same(lo_j, lo_t.numpy())
    same(hi_j, hi_t.numpy())
    sc_j, zp_j = jq.compute_scale_zp(lo_j, hi_j, js)
    sc_t, zp_t = tq.compute_scale_zp(lo_t, hi_t, ts)
    same(sc_j, sc_t.numpy())
    same(zp_j, zp_t.numpy())
    same(jq.fake_quant(xj, sc_j, zp_j, js), tq.fake_quant(xt, sc_t, zp_t, ts))
    same(jq.quantize_tensor(xj, js), tq.quantize_tensor(xt, ts))
    assert tq.quantization_error(xt, ts) == pytest.approx(
        jq.quantization_error(xj, js), rel=1e-6)


@pytest.mark.parametrize("per_channel,axis", [(False, 0), (True, 0), (True, 1)])
@pytest.mark.parametrize("pct", [99.9, 90.0])
def test_percentile_calibration_matches_numpy_and_reference(per_channel, axis,
                                                            pct):
    x = spread((16, 120), seed=3)
    js, ts = specs(8, True, per_channel, axis)
    lo_t, hi_t = tq.calibrate(torch.from_numpy(x), ts, pct)
    lo_j, hi_j = jq.calibrate(jnp.asarray(x), js, pct)
    flat = np.moveaxis(x, axis, 0).reshape(x.shape[axis], -1) \
        if per_channel else x.reshape(-1)
    ax = 1 if per_channel else None
    for got, want_np, want_j, q in ((lo_t, lo_j, lo_j, 100 - pct),
                                    (hi_t, hi_j, hi_j, pct)):
        want_np = np.percentile(flat, q, axis=ax).reshape(got.shape)
        np.testing.assert_allclose(got.numpy(), want_np, rtol=1e-6, atol=0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_j), rtol=0,
                                   atol=5e-5 * np.abs(x).max())
    got = tq.quantize_tensor(torch.from_numpy(x), ts, pct).numpy()
    want = np.asarray(jq.quantize_tensor(jnp.asarray(x), js, pct))
    step, _ = jq.compute_scale_zp(lo_j, hi_j, js)
    assert (np.abs(got - want) <= 1.001 * np.asarray(step)).all()


def test_percentile_takes_more_than_2_pow_24_elements():
    x = torch.arange(2 ** 24 + 3, dtype=torch.float32)
    assert float(tq._percentile(x, 50.0)) == float(np.percentile(
        x.numpy(), 50.0))
    lo, hi = tq.calibrate(x, tq.QuantSpec(8), 99.0)
    assert float(lo) < float(hi)


@pytest.mark.parametrize("v", [0.5, -3.0, 0.004, 7.0])
def test_ste_gradient_is_identity(v):
    """The straight-through estimator: gradient 1 everywhere (the
    reference's ``x + stop_gradient(dq - x)``), inside the range and out."""
    js, ts = specs(8, True)
    scale, zp = 0.01, 0.0
    g_j = jax.grad(lambda x: jq.fake_quant(
        x, jnp.asarray(scale), jnp.asarray(zp), js).sum())(jnp.asarray(v))
    x = torch.tensor(v, requires_grad=True)
    y = tq.fake_quant(x, torch.tensor(scale), torch.tensor(zp), ts)
    y.sum().backward()
    assert float(x.grad) == float(g_j) == 1.0
    want = jq.fake_quant(jnp.asarray(v), jnp.asarray(scale), jnp.asarray(zp),
                         js)
    assert float(y.detach()) == float(want)


def test_observer_matches_reference():
    js, ts = specs(8, True)
    jo, to = jq.ActObserver(js), tq.ActObserver(ts)
    rng = np.random.default_rng(5)
    for i in range(3):
        a = (rng.normal(size=(4, 9)) * (i + 1)).astype(np.float32)
        jo.update(jnp.asarray(a))
        to.update(torch.from_numpy(a))
    same(jo.lo, to.lo.numpy())
    same(jo.hi, to.hi.numpy())
    probe = rng.normal(size=(50,)).astype(np.float32) * 3
    same(jo.quantizer()(jnp.asarray(probe)),
         to.quantizer()(torch.from_numpy(probe)))
    # the reference's own case (tests/test_quant.py)
    obs = tq.ActObserver(ts)
    obs.update(torch.tensor([-1.0, 1.0]))
    obs.update(torch.tensor([-3.0, 0.5]))
    assert float(obs.lo) == -3.0 and float(obs.hi) == 1.0
    assert abs(float(obs.quantizer()(torch.tensor([2.9]))[0]) - 2.9) < 0.05
    with pytest.raises(RuntimeError, match="never saw"):
        tq.ActObserver(ts).quantizer()


class _Pair(torch.nn.Module):
    """A Dense and a Conv2d with storage: the two weight layouts."""

    def __init__(self, seed):
        super().__init__()
        self.fc = Dense(6, 5)
        self.conv = Conv2d(4, 3, 3)
        self.to_empty(device="cpu")
        rng = np.random.default_rng(seed)
        self.ref = {"fc": {"w": spread((6, 5), seed), "b": spread((5,), seed)},
                    "conv": {"w": spread((3, 4, 3, 3), seed + 1),
                             "b": spread((3,), seed + 1)}}
        with torch.no_grad():
            self.fc.w.copy_(torch.from_numpy(self.ref["fc"]["w"].T.copy()))
            self.fc.b.copy_(torch.from_numpy(self.ref["fc"]["b"]))
            self.conv.w.copy_(torch.from_numpy(self.ref["conv"]["w"]))
            self.conv.b.copy_(torch.from_numpy(self.ref["conv"]["b"]))
        self.register_buffer("stat", torch.from_numpy(rng.normal(
            size=(2, 2)).astype(np.float32)))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("per_channel", [False, True])
def test_quantize_pytree_picks_the_reference_axis_by_meaning(bits,
                                                             per_channel):
    """Per channel the reference quantizes along each weight's last axis in
    its own layout: d_out of a Dense (axis 0 of the port's (out, in)) and kw
    of an OIHW conv (a quirk kept).  1-D leaves stay float, buffers are not
    parameters."""
    m = _Pair(bits)
    js, ts = specs(bits, True, per_channel)
    want = jq.quantize_pytree(jax.tree_util.tree_map(jnp.asarray, m.ref), js)
    got = tq.quantize_pytree(m, ts)
    assert sorted(got) == ["conv.b", "conv.w", "fc.b", "fc.w"]
    same(want["fc"]["w"], got["fc.w"].numpy().T)
    same(want["conv"]["w"], got["conv.w"].numpy())
    assert got["fc.b"] is m.fc.b and got["conv.b"] is m.conv.b
    assert not torch.equal(got["fc.w"], m.fc.w)     # copies; the model's stay
    assert torch.equal(m.fc.w, torch.from_numpy(m.ref["fc"]["w"].T.copy()))


def test_reference_cases_hold():
    """The reference's ``tests/test_quant.py`` cases on the port."""
    x = torch.linspace(-1.0, 1.0, 1001)
    assert float((tq.quantize_tensor(x, tq.QuantSpec(8)) - x).abs().max()) \
        <= 2.0 / 254 / 2 + 1e-6
    g = torch.from_numpy(np.random.default_rng(0).normal(size=512).astype(
        np.float32))
    errs = [tq.quantization_error(g, tq.QuantSpec(bits=b)) for b in (4, 8, 16)]
    assert errs[0] > errs[1] > errs[2]
    w = torch.from_numpy(spread((8, 64), seed=1))
    assert tq.quantization_error(w, tq.QuantSpec(8, per_channel=True)) < \
        tq.quantization_error(w, tq.QuantSpec(8))


@pytest.mark.parametrize("bits", [4, 8, 12, 16])
@pytest.mark.parametrize("mag", [0.1, 3.0, 100.0])
def test_error_bounded_by_half_step(bits, mag):
    x = torch.linspace(-mag, mag, 257)
    xq = tq.quantize_tensor(x, tq.QuantSpec(bits=bits))
    step = 2 * mag / (2 ** (bits - 1) - 1)
    assert float((xq - x).abs().max()) <= step / 2 + 1e-5 * mag


# -- quant_matmul: the plain version against the reference ----------------------

def qmm_inputs(m, k, n, bf16=False, seed=0):
    """The reference sweep's distribution (tests/test_kernels.py), from
    numpy: x normal (optionally rounded through bf16), per-column int8
    weights, x_scale = max|x| / 127."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    if bf16:
        x = torch.from_numpy(x).bfloat16().float().numpy()
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
    w_scale = (np.abs(w).max(axis=0) / np.float32(127.0)).astype(np.float32)
    w_q = np.clip(np.round(w / w_scale[None, :]), -128, 127).astype(np.int8)
    x_scale = np.float32(np.abs(x).max() / np.float32(127.0))
    return x, w_q, w_scale, x_scale


def as_torch(x, w_q, w_scale, x_scale):
    return (torch.from_numpy(x), torch.from_numpy(w_q),
            torch.from_numpy(w_scale), torch.tensor(x_scale))


def as_jax(x, w_q, w_scale, x_scale):
    return (jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(w_scale),
            jnp.asarray(x_scale))


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 128),
                                   (128, 256, 256), (256, 256, 256)])
@pytest.mark.parametrize("bf16", [False, True])
def test_quant_matmul_plain_matches_pallas_interpret(m, k, n, bf16):
    args = qmm_inputs(m, k, n, bf16, seed=m + k + n)
    got = ops.quant_matmul(*as_torch(*args), impl="ref").numpy()
    want = np.asarray(pl_quant_matmul(*as_jax(*args)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    same(jref.quant_matmul(*as_jax(*args)), got)


def test_quant_matmul_ragged_matches_reference_fallback():
    """(100, 96, 50) is off the reference's 128 grid: its ops send it to
    the oracle; the port's CPU path is the plain version for every shape
    (and its card launches the kernel, ``test_torch_cuda.py``)."""
    args = qmm_inputs(100, 96, 50, seed=9)
    before = quant_matmul.quant_matmul.launches
    got = ops.quant_matmul(*as_torch(*args)).numpy()
    want = np.asarray(jops.quant_matmul(*as_jax(*args)))
    assert got.shape == (100, 50)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert quant_matmul.quant_matmul.launches == before   # no kernel on CPU


def test_quant_matmul_dispatch_rules():
    x, w_q, w_scale, x_scale = as_torch(*qmm_inputs(4, 8, 3))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.quant_matmul(x, w_q, w_scale, x_scale, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.quant_matmul(x, w_q, w_scale, x_scale, impl="pallas")
    # a Python float scale is taken as a tensor on x's device
    same(ops.quant_matmul(x, w_q, w_scale, float(x_scale)).numpy(),
         ops.quant_matmul(x, w_q, w_scale, x_scale).numpy())
    # ties round half to even, codes clip to [-128, 127]
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, 300.0, -300.0]])
    y = ops.quant_matmul(x, torch.eye(6, dtype=torch.int8),
                         torch.ones(6), torch.tensor(1.0))
    assert y.tolist() == [[0.0, 2.0, 2.0, -0.0, 127.0, -128.0]]


def test_quant_spec_fields_match_reference():
    assert [f.name for f in dataclasses.fields(tq.QuantSpec)] == \
        [f.name for f in dataclasses.fields(jq.QuantSpec)]
    for bits, sym in SPECS:
        js, ts = specs(bits, sym)
        assert (ts.qmin, ts.qmax) == (js.qmin, js.qmax)


# -- the stage-wide entry and K7's plain version ------------------------------------

FQ_SPECS = [tq.QuantSpec(16), tq.QuantSpec(8), tq.QuantSpec(8, symmetric=False),
            tq.QuantSpec(8, per_channel=True)]
FQ_IDS = ["sym16", "sym8", "affine8", "per_channel8"]


@pytest.fixture(scope="module")
def effnet_b0():
    """Full-size EfficientNet-B0 on weights drawn on the CPU."""
    from repro_torch.models.cnn.zoo import build_cnn
    return build_cnn("efficientnet_b0").init_weights(
        torch.Generator().manual_seed(0), torch.device("cpu")).eval()


@pytest.mark.parametrize("spec", FQ_SPECS, ids=FQ_IDS)
def test_quantize_modules_equals_quantize_leaf_on_effnet_b0(effnet_b0, spec):
    """The stage-wide entry on all 19 blocks at once gives each block's
    parameters exactly as ``quantize_leaf`` gives them one by one."""
    blocks = [b for _, b in effnet_b0.blocks]
    got = tq.quantize_modules(blocks, spec)
    assert len(got) == len(blocks) == 19
    for block, params in zip(blocks, got):
        want = {}
        for mname, mod in block.named_modules():
            for pname, p in mod.named_parameters(recurse=False):
                want[f"{mname}.{pname}" if mname else pname] = tq.quantize_leaf(
                    p, spec, None, tq.reference_channel_axis(mod, p))
        assert list(params) == list(want)
        for name, w in want.items():
            assert torch.equal(params[name], w), name
            assert (params[name] is w) == (w.dim() <= 1)
    assert sum(t.dim() > 1 for p in got for t in p.values()) == 82


class _Spy:
    """Counts the calls of ``kernels.ops.fake_quant_tensors`` (and the
    tensors each takes), passing them on."""

    def __init__(self, monkeypatch):
        self.calls = []
        self.real = ops.fake_quant_tensors
        monkeypatch.setattr(tq._kops, "fake_quant_tensors", self)

    def __call__(self, xs, spec, **kw):
        self.calls.append(len(xs))
        return self.real(xs, spec, **kw)


def test_a_stage_is_one_call_and_per_channel_percentile_take_the_chain(
        monkeypatch, effnet_b0):
    """Per tensor by min/max a stage's leaves go to the kernel's dispatch
    in one call (a link in a call of one); per channel and by percentile
    they never reach it, on any device."""
    spy = _Spy(monkeypatch)
    blocks = [b for _, b in effnet_b0.blocks[:5]]
    tq.quantize_modules(blocks, tq.QuantSpec(8))
    x = torch.from_numpy(spread((6, 40), seed=3))
    tq.quantize_tensor(x, tq.QuantSpec(8))
    assert spy.calls == [sum(p.dim() > 1 for b in blocks
                             for p in b.parameters()), 1]
    spy.calls.clear()
    tq.quantize_modules(blocks, tq.QuantSpec(8, per_channel=True))
    tq.quantize_modules(blocks, tq.QuantSpec(8), percentile=99.9)
    tq.quantize_tensor(x, tq.QuantSpec(8), percentile=99.0)
    tq.quantize_tensor(x, tq.QuantSpec(8, per_channel=True))
    assert spy.calls == []


@pytest.mark.parametrize("route", ["cuda", "ref"])
def test_the_route_and_its_count_depend_on_the_spec_alone(monkeypatch, route):
    """``quantize_tensors`` picks the route from the spec alone: per tensor
    by min/max, a list of any dtype goes to the kernel's dispatch in one
    call with the impl the device resolves to, and is counted under that
    impl; per channel or by percentile it takes the chain and is counted
    ``.ref``, whatever the device."""
    from repro_torch.kernels import ref
    from repro_torch.obs import Obs
    calls = []

    def dispatch(xs, spec, *, impl):
        calls.append((len(xs), impl))
        return ref.fake_quant_tensors(xs, spec)

    monkeypatch.setattr(tq._kops, "resolve_impl", lambda impl, x: route)
    monkeypatch.setattr(tq._kops, "fake_quant_tensors", dispatch)
    obs = Obs.on()
    xs = [torch.from_numpy(spread((6, 40), seed=3)),
          torch.from_numpy(spread((3, 5), seed=4)).double()]
    tq.quantize_tensors(xs, tq.QuantSpec(8), obs=obs)
    tq.quantize_tensor(xs[1], tq.QuantSpec(4, symmetric=False), obs=obs)
    assert calls == [(2, route), (1, route)]
    tq.quantize_tensors(xs, tq.QuantSpec(8, per_channel=True), obs=obs)
    tq.quantize_tensor(xs[0], tq.QuantSpec(8), percentile=99.0, obs=obs)
    assert len(calls) == 2
    want = collections.Counter({f"{tq.FAKE_QUANT_TENSORS}.{route}": 3})
    want[f"{tq.FAKE_QUANT_TENSORS}.ref"] += 3
    assert obs.metrics.snapshot() == dict(want)


@pytest.mark.parametrize("spec", FQ_SPECS[:3], ids=FQ_IDS[:3])
def test_fake_quant_plain_version_is_the_chain(spec):
    """``kernels.ref.fake_quant_tensors`` (K7's plain version, which
    ``ops`` takes on the CPU) is ``core.quant``'s chain on each tensor, each
    on its own range; per channel it refuses, and ``impl="cuda"`` needs a
    CUDA tensor."""
    from repro_torch.kernels import ref
    xs = [torch.from_numpy(spread(s, seed=i)) for i, s in
          enumerate(((3, 5), (7, 2, 3), (1, 1), (40, 30)))]
    xs.append(torch.full((4, 4), -0.0))
    for got in (ref.fake_quant_tensors(xs, spec),
                ops.fake_quant_tensors(xs, spec),
                tq.quantize_tensors(xs, spec)):
        for g, x in zip(got, xs):
            lo, hi = tq.calibrate(x, spec)
            scale, zp = tq.compute_scale_zp(lo, hi, spec)
            assert torch.equal(g.view(torch.int32),
                               tq.fake_quant(x, scale, zp, spec).view(
                                   torch.int32))
    assert ops.fake_quant_tensors([], spec) == []
    with pytest.raises(ValueError, match="per channel"):
        ref.fake_quant_tensors(xs, tq.QuantSpec(8, per_channel=True))
    with pytest.raises(ValueError, match="CUDA"):
        ops.fake_quant_tensors(xs, spec, impl="cuda")


def test_straight_through_function_gradient_is_identity():
    """``fake_quant.StraightThrough`` (K7 under autograd; on the CPU its
    forward is the plain version): the chain's values, the identity
    gradient to the inputs that require one, none for the others."""
    from repro_torch.kernels import fake_quant
    spec = tq.QuantSpec(8)
    x = torch.from_numpy(spread((6, 9), seed=4)).requires_grad_()
    b = torch.from_numpy(spread((3, 3), seed=5))
    w = torch.from_numpy(spread((6, 9), seed=6))
    y, z = fake_quant.StraightThrough.apply(spec, x, b)
    assert y.requires_grad and not z.requires_grad
    (y * w).sum().backward()
    assert torch.equal(x.grad, w)
    assert torch.equal(y.detach(), tq.quantize_tensor(x.detach(), spec))
    assert torch.equal(z, tq.quantize_tensor(b, spec))


def test_runner_counts_fake_quant_tensors_under_the_documented_names(
        effnet_b0):
    """``PartitionedCNNRunner`` counts the weight tensors and the link
    activations it fake-quantizes by route; on the CPU all take the chain
    (``fake_quant_tensors.ref``).  The names are the ones ``repro_torch.obs``
    lists."""
    import repro_torch.obs as obs_mod
    from repro_torch.obs import Obs
    from repro_torch.serving import PartitionedCNNRunner
    from repro_torch.core.quant import FAKE_QUANT_TENSORS
    for route in ("cuda", "ref"):
        assert f"``{FAKE_QUANT_TENSORS}.{route}``" in obs_mod.__doc__
    obs = Obs.on()
    cuts = [3, 9, 14]
    specs = [tq.QuantSpec(16), tq.QuantSpec(16), None, tq.QuantSpec(8)]
    runner = PartitionedCNNRunner(effnet_b0, cuts, specs, obs=obs)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 3, 64, 64)).astype(np.float32))
    runner.run(x)
    weights = sum(p.dim() > 1 for (a, b), s in zip(
        [(0, 4), (4, 10), (10, 15), (15, 19)], specs) if s is not None
        for _, blk in effnet_b0.blocks[a:b] for p in blk.parameters())
    assert obs.metrics.snapshot() == {f"{FAKE_QUANT_TENSORS}.ref":
                                      weights + 2, "mbconv_dw.ref": 16}
