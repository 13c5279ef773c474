"""The MBConv depthwise unit (K8's plain version and the block's route) on
the CPU: ``kernels.ref.mbconv_dw`` is the block's chain of ops bit for bit
at EfficientNet-B0's 16 block shapes; eval with grad disabled takes it,
training mode or grad enabled the layers one by one; the partitioned
runner counts the blocks by route.  No JAX: the chain is the port's own."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import mbconv_dw as mb  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.cnn.blocks import MBConv  # noqa: E402
from repro_torch.models.cnn.zoo import efficientnet_b0  # noqa: E402
from repro_torch.nn.layers import BatchNorm2d, global_avg_pool  # noqa: E402
from repro_torch.obs import Obs  # noqa: E402
from repro_torch.serving import PartitionedCNNRunner  # noqa: E402

N_BLOCKS = 16     # EfficientNet-B0's MBConv blocks


def draw_statistics(model, seed):
    """Every BatchNorm's running statistics, scale and bias drawn, so that
    each normalisation moves its input (the init's are the identity)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.mean.copy_(torch.randn(m.c, generator=g) * 0.5)
                m.var.copy_(torch.rand(m.c, generator=g) * 2 + 0.2)
                m.scale.copy_(torch.rand(m.c, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.c, generator=g) * 0.2)
    return model


def small_b0(in_hw, w=0.25, seed=0):
    model = efficientnet_b0(n_classes=10, in_hw=in_hw, w=w).init_weights(
        torch.Generator().manual_seed(seed), torch.device("cpu"))
    return draw_statistics(model, seed).eval()


@pytest.fixture(scope="module")
def b0_inputs():
    """EfficientNet-B0 at 224 and a quarter of its width, and each MBConv
    block's input for two images (planes 112 down to 7)."""
    model = small_b0(224)
    blocks = [b for _, b in model.blocks if isinstance(b, MBConv)]
    seen = []
    hooks = [b.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
             for b in blocks]
    x = torch.randn((2, 3, 224, 224), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return blocks, seen


def chain(block, x):
    """The depthwise unit layer by layer, as the block ran it before K8."""
    y = block.exp(x) if block.exp is not None else x
    d = block.dw(y)
    return d, global_avg_pool(d)


def twin(block, x):
    e = block.exp.conv(x) if block.exp is not None else x
    return ref.mbconv_dw(e, block.dw.conv.w, block.dw.conv.stride,
                         block.dw.bn.inference(),
                         block.exp.bn.inference() if block.exp else None)


@pytest.mark.parametrize("i", range(N_BLOCKS))
def test_twin_equals_the_block_chain_bit_for_bit(b0_inputs, i):
    blocks, inputs = b0_inputs
    block, x = blocks[i], inputs[i]
    with torch.no_grad():
        d, m = twin(block, x)
        want_d, want_m = chain(block, x)
    assert torch.equal(d, want_d) and torch.equal(m, want_m)
    assert d.shape[-1] == (x.shape[-1] - 1) // block.dw.conv.stride + 1


def test_the_sixteen_shapes_cover_the_kernels_cases(b0_inputs):
    """k 3 and 5, stride 1 and 2, the prologue on and off, planes of 112
    down to the odd 7 (and 14 under stride 2, to 7)."""
    blocks, inputs = b0_inputs
    assert len(blocks) == N_BLOCKS
    cases = {(b.dw.conv.k, b.dw.conv.stride, b.exp is not None,
              x.shape[-1]) for b, x in zip(blocks, inputs)}
    assert {c[0] for c in cases} == {3, 5}
    assert {c[1] for c in cases} == {1, 2}
    assert {c[2] for c in cases} == {True, False}
    assert {c[3] for c in cases} == {112, 56, 28, 14, 7}
    assert (5, 2, True, 14) in cases and (5, 1, True, 7) in cases


class Counting:
    """A counting stand-in for ``kernels.ref.mbconv_dw``."""

    def __init__(self, monkeypatch):
        self.calls = 0
        self.fn = ref.mbconv_dw
        monkeypatch.setattr(ref, "mbconv_dw", self)

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


def test_eval_without_grad_takes_the_twin(b0_inputs, monkeypatch):
    blocks, inputs = b0_inputs
    block, x = blocks[3], inputs[3]
    with torch.no_grad():
        want = block.proj(block.se(chain(block, x)[0]))
        want = want + x if block.skip else want
    twin_calls = Counting(monkeypatch)
    with torch.no_grad():
        got = block(x)
    assert twin_calls.calls == 1
    assert block.dw_route(x) == "ref"
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["train", "grad"])
def test_training_or_grad_takes_the_chain(mode, monkeypatch):
    block = small_b0(32).blocks[4][1]
    x = torch.randn((2, block.exp.conv.cin, 8, 8),
                    generator=torch.Generator().manual_seed(2))
    twin_calls = Counting(monkeypatch)
    if mode == "train":
        block.train()
        with torch.no_grad():
            block(x)
        block.eval()
    else:
        out = block(x.requires_grad_())
        out.sum().backward()
        assert x.grad is not None
    assert twin_calls.calls == 0


def test_whole_model_same_on_both_routes():
    """The forward without grad (the twin) equals the forward with grad
    (the layers one by one) bit for bit on the CPU."""
    model = small_b0(64, seed=3)
    x = torch.randn((2, 3, 64, 64), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        fused = model(x)
    layered = model(x).detach()
    assert torch.equal(fused, layered)


@pytest.mark.parametrize("cuts", [[], [3, 9], [0, 5, 16]])
def test_runner_counts_sixteen_blocks_a_forward(cuts):
    model = small_b0(32, seed=4)
    x = torch.randn((2, 3, 32, 32), generator=torch.Generator().manual_seed(4))
    obs = Obs.on()
    runner = PartitionedCNNRunner(model, cuts, obs=obs)
    for forwards in (1, 2):
        out, _ = runner.run(x)
        snap = obs.metrics.snapshot()
        assert snap["mbconv_dw.ref"] == N_BLOCKS * forwards
        assert "mbconv_dw.cuda" not in snap
    with torch.no_grad():
        assert torch.equal(out, model(x))


def test_runner_counts_nothing_when_off():
    model = small_b0(32, seed=5)
    runner = PartitionedCNNRunner(model, [3])
    runner.run(torch.zeros((1, 3, 32, 32)))
    assert not runner.obs.enabled


def test_excite_with_the_mean_equals_forward():
    block = small_b0(32).blocks[2][1]
    y = torch.randn((2, block.mid, 5, 5),
                    generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        assert torch.equal(block.se.excite(y, y.mean(dim=(2, 3))),
                           block.se(y))


def bn_args(c, seed=7):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(c, generator=g), torch.rand(c, generator=g) + 0.1,
            torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g),
            1e-5)


def test_wrapper_runs_the_twin_on_cpu_and_counts_no_launch():
    e = torch.randn((2, 6, 9, 9), generator=torch.Generator().manual_seed(8))
    w = torch.randn((6, 1, 5, 5), generator=torch.Generator().manual_seed(9))
    before = mb.mbconv_dw.launches
    for pre in (None, bn_args(6, 10)):
        got = mb.mbconv_dw(e, w, 2, bn_args(6), pre)
        for a, b in zip(got, ref.mbconv_dw(e, w, 2, bn_args(6), pre)):
            assert torch.equal(a, b)
        for a, b in zip(ops.mbconv_dw(e, w, 2, bn_args(6), pre),
                        ops.mbconv_dw(e, w, 2, bn_args(6), pre,
                                      impl="ref")):
            assert torch.equal(a, b)
    assert mb.mbconv_dw.launches == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.mbconv_dw(e, w, 1, bn_args(6), impl="cuda")


@pytest.mark.parametrize("bad,err,match", [
    ("float64", TypeError, "float32"),
    ("k7", ValueError, "k in"),
    ("stride3", ValueError, "stride"),
    ("bn_shape", ValueError, r"\(6,\)"),
    ("pre_float64", TypeError, "float32"),
    ("rank3", ValueError, r"\(N, C, H, W\)"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, err, match):
    """The checks the CUDA route makes before any launch (here called
    directly on CPU tensors)."""
    e = torch.zeros((2, 6, 9, 9))
    w, stride, bn, pre = torch.zeros((6, 1, 3, 3)), 1, bn_args(6), None
    if bad == "float64":
        e = e.double()
    elif bad == "k7":
        w = torch.zeros((6, 1, 7, 7))
    elif bad == "stride3":
        stride = 3
    elif bad == "bn_shape":
        bn = (torch.zeros(5),) + bn[1:]
    elif bad == "pre_float64":
        pre = (bn[0].double(),) + bn[1:]
    elif bad == "rank3":
        e = e[0]
    bns = [("bn", bn)] + ([("pre", pre)] if pre is not None else [])
    with pytest.raises(err, match=match):
        mb._validate(e, w, stride, bns)
