"""The port's CUDA kernels against their plain PyTorch versions (bit for
bit where the result is integer), and a train step on the card against
the same step on the CPU, on a CUDA device (every test here is marked
``cuda`` and skips without one).  This file imports only torch, numpy and the port, so it runs
on a machine that has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.nsga2_torch import nondominated_rank  # noqa: E402
from repro_torch.kernels import (ops, pareto_rank,  # noqa: E402
                                 quant_matmul, ref, ssd_scan, window_attn)
from repro_torch import testing  # noqa: E402
from repro_torch.models.decoder import DecoderLM  # noqa: E402
from repro_torch.models.cnn.zoo import reduced_cnn  # noqa: E402
from repro_torch.models.registry import build_model, get_config  # noqa: E402
from repro_torch.serving import PartitionedCNNRunner  # noqa: E402

SIZES = (33, 97, 130, 4096, 4099)


def population(n, m=3, infeas=0.3, seed=0):
    rng = np.random.default_rng(seed)
    F = rng.random((n, m)).astype(np.float32)
    F[n // 2:] = F[rng.integers(0, n // 2, n - n // 2)]
    CV = np.where(rng.random(n) < infeas, (rng.random(n) * 3).round(1),
                  0.0).astype(np.float32)
    return F, CV


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the CUDA kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("infeas", (0.0, 0.3, 1.0))
def test_kernels_match_plain_versions(cuda_device, n, infeas):
    """The search's populations and the edge cases of
    ``testing.edge_population`` (NaN objectives and violations, -0.0, +inf,
    equal violations, duplicates) at m = 1, 3 and 8, over row and column
    tiles."""
    alive = torch.from_numpy(np.random.default_rng(n).random(n) < 0.5).to(
        cuda_device)
    inputs = [tuple(torch.from_numpy(a) for a in population(
        n, infeas=infeas, seed=n))]
    inputs += [testing.edge_population(n, m, infeas, seed=n + m)
               for m in (1, 3, 8)]
    for F, CV in inputs:
        F, CV = F.to(cuda_device), CV.to(cuda_device)
        for block, bq in ((32, 256), (64, 32), (2048, 256), (2048, 1024)):
            got = pareto_rank.packed_domination(F, CV, F, CV, bq=bq,
                                                bp=ops._row_tile(block))
            assert torch.equal(got,
                               ref.packed_domination(F, CV, F, CV, block))
        for mask in (torch.ones_like(alive), alive):
            assert torch.equal(pareto_rank.domination_counts(F, CV, mask),
                               ref.domination_counts(F, CV, mask))


@pytest.mark.cuda
def test_kernels_count_launches_and_reject_bad_inputs(cuda_device):
    F, CV = (torch.from_numpy(a).to(cuda_device) for a in population(64))
    before = pareto_rank.packed_domination.launches
    pareto_rank.packed_domination(F, CV, F, CV, bp=32)
    assert pareto_rank.packed_domination.launches == before + 1
    with pytest.raises(TypeError, match="float32"):
        pareto_rank.packed_domination(F.double(), CV, F, CV)
    with pytest.raises(ValueError, match="contiguous"):
        pareto_rank.packed_domination(F.t().contiguous().t(), CV, F, CV)
    with pytest.raises(ValueError, match="multiple of 32"):
        pareto_rank.packed_domination(F, CV, F, CV, bp=48)
    with pytest.raises(ValueError, match="multiple of 32"):
        pareto_rank.packed_domination(F, CV, F, CV, bq=2048)
    with pytest.raises(ValueError, match="objectives exceed"):
        G = torch.zeros((64, 9), device=cuda_device)
        pareto_rank.packed_domination(G, CV, G, CV)


@pytest.mark.cuda
def test_pareto_kernels_pack_and_count_by_warp_vote(cuda_device):
    """Both Pareto kernels vote (VOTE) in their SASS; the counting kernel
    takes the vote's popcount (POPC)."""
    from repro_torch.kernels import _build
    votes = _build.opcode_counts("pareto_rank.cu", "VOTE")
    if votes is None:
        pytest.skip("the CUDA toolkit has no cuobjdump to read the SASS")
    popc = _build.opcode_counts("pareto_rank.cu", "POPC")
    for kernel in ("packed_domination_kernel", "domination_counts_kernel"):
        mine = {k: v for k, v in votes.items() if k.startswith(kernel)}
        assert mine and all(v > 0 for v in mine.values()), votes
    assert all(v > 0 for k, v in popc.items()
               if k.startswith("domination_counts_kernel")), popc


@pytest.mark.cuda
def test_tiled_rank_on_card_equals_dense_rank_on_cpu(cuda_device):
    F, CV = population(1500, seed=7)
    want = nondominated_rank(torch.from_numpy(F), torch.from_numpy(CV), 700)
    got = nondominated_rank(torch.from_numpy(F).to(cuda_device),
                            torch.from_numpy(CV).to(cuda_device), 700,
                            rank_block=256).cpu()
    assert torch.equal(got, want)


# -- window_attn ------------------------------------------------------------------

def qkv(b, t, h, kv, hd, seed, device):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(device) for s in ((b, t, h, hd), (b, t, kv, hd),
                                       (b, t, kv, hd)))


# float32 on both sides, summed in another order (online softmax over key
# tiles against one softmax over the full row): the reference's own
# tolerance for its window kernel, 2e-5, at these lengths
@pytest.mark.cuda
@pytest.mark.parametrize("t", (1, 100, 128, 1000))
@pytest.mark.parametrize("window", (1, 64, 100, 5000))
def test_window_attn_kernel_matches_plain_version(cuda_device, t, window):
    for group, hd in ((1, 32), (3, 64), (3, 32), (1, 64)):
        q, k, v = qkv(2, t, 2 * group, 2, hd, t + window + hd, cuda_device)
        got = window_attn.window_attn(q, k, v, window)
        want = ops.window_attn(q, k, v, window, impl="ref")
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


# the head dims above 64 (one 16-row slice a warp, 32-key tiles at 160)
# and smollm-360m's 15 query / 5 KV heads, at the same tolerance
@pytest.mark.cuda
@pytest.mark.parametrize("h,kv,hd,t,window", [(4, 2, 128, 300, 100),
                                              (4, 2, 160, 300, 100),
                                              (3, 1, 160, 129, 200),
                                              (15, 5, 64, 1000, 300)])
def test_window_attn_kernel_head_dims_and_smollm_heads(cuda_device, h, kv,
                                                       hd, t, window):
    q, k, v = qkv(2, t, h, kv, hd, t + hd, cuda_device)
    got = window_attn.window_attn(q, k, v, window)
    want = ops.window_attn(q, k, v, window, impl="ref")
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


# qwen2-vl-7b's head dim 128 and group 7 (28 query heads over 4 KV heads),
# and head dim 160 at group 7, at the same tolerance
@pytest.mark.cuda
@pytest.mark.parametrize("h,kv,hd,t,window", [(7, 1, 128, 300, 100),
                                              (14, 2, 128, 1000, 300),
                                              (28, 4, 128, 640, 256),
                                              (7, 1, 160, 300, 100),
                                              (14, 2, 160, 129, 1000)])
def test_window_attn_kernel_head_dim_128_160_group_7(cuda_device, h, kv, hd,
                                                     t, window):
    q, k, v = qkv(2, t, h, kv, hd, t + hd + h, cuda_device)
    got = window_attn.window_attn(q, k, v, window)
    want = ops.window_attn(q, k, v, window, impl="ref")
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


# a NaN in q or k reaches the rows that see it, as in the plain version:
# the 3xTF32 split rounds hi by an integer add, which turns a NaN whose
# payload fills the mantissa (the card's canonical 0x7fffffff) into -0, so
# lo = x - hi takes the cvt, which keeps the NaN
@pytest.mark.cuda
@pytest.mark.parametrize("which", ["q", "k"])
@pytest.mark.parametrize("word", [0x7FFFFFFF, -1, 0x7FC00000])
def test_window_attn_kernel_propagates_nan(cuda_device, which, word):
    q, k, v = qkv(1, 200, 2, 2, 64, 5, cuda_device)
    x = q if which == "q" else k
    x.view(torch.int32)[0, 70, 1, 3] = word      # -1: 0xffffffff
    got = window_attn.window_attn(q, k, v, 50)
    want = ops.window_attn(q, k, v, 50, impl="ref")
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert int(torch.isnan(got).sum()) > 0
    finite = ~torch.isnan(want)
    torch.testing.assert_close(got[finite], want[finite], rtol=2e-5,
                               atol=2e-5)


@pytest.mark.cuda
def test_window_attn_counts_launches_and_rejects_bad_inputs(cuda_device):
    q, k, v = qkv(1, 64, 4, 2, 64, 0, cuda_device)
    before = window_attn.window_attn.launches
    ops.window_attn(q, k, v, 16, impl="cuda")
    assert window_attn.window_attn.launches == before + 1
    with pytest.raises(TypeError, match="float32"):
        window_attn.window_attn(q.double(), k, v, 16)
    with pytest.raises(ValueError, match="contiguous"):
        window_attn.window_attn(q.transpose(1, 2).contiguous().transpose(1, 2),
                                k, v, 16)
    with pytest.raises(ValueError, match="multiple"):
        window_attn.window_attn(q[:, :, :3].contiguous(), k, v, 16)
    with pytest.raises(ValueError, match="window"):
        window_attn.window_attn(q, k, v, 0)
    with pytest.raises(ValueError, match="head dim"):
        a, b, c = qkv(1, 8, 2, 2, 48, 0, cuda_device)
        window_attn.window_attn(a, b, c, 4)


@pytest.mark.cuda
def test_lm_forward_through_the_kernel_matches_ref(cuda_device):
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(), window=128)
    model = DecoderLM(cfg, device=cuda_device)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 256))).to(cuda_device)
    before = window_attn.window_attn.launches
    got = model({"tokens": tok}, impl="cuda")
    assert window_attn.window_attn.launches == before + cfg.n_layers
    torch.testing.assert_close(got, model({"tokens": tok}, impl="ref"),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,sections", [(None, (8, 12, 12)),
                                               (128, (16, 24, 24))])
def test_vlm_forward_through_the_kernel_matches_ref(cuda_device, head_dim,
                                                    sections):
    """Reduced qwen2-vl-7b (window 128) with 16 vision patches at Qwen2-VL's
    grid positions and 2032 tokens, at head dim 64 and at the model's 128:
    the kernel in every block against ``impl="ref"``, which at 2048
    positions takes ``chunked_sdpa``.  Both mask by the row index (below
    2048 the ``sdpa`` branch masks by the temporal ids, as the
    reference's)."""
    cfg = dataclasses.replace(get_config("qwen2-vl-7b").reduced(),
                              window=128, head_dim=head_dim,
                              mrope_sections=sections)
    model = DecoderLM(cfg, device=cuda_device)
    rng = np.random.default_rng(0)
    rows, cols = np.divmod(np.arange(16), 4)
    text = 4 + np.arange(2032)
    pos = np.stack([np.concatenate([np.zeros(16, int), text]),
                    np.concatenate([rows, text]),
                    np.concatenate([cols, text])])
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 2032)))
             .to(cuda_device),
             "vision_embeds": torch.from_numpy(rng.standard_normal(
                 (2, 16, cfg.d_model)).astype(np.float32)).to(cuda_device),
             "positions3": torch.from_numpy(np.broadcast_to(
                 pos[:, None], (3, 2, 2048)).copy()).to(cuda_device)}
    before = window_attn.window_attn.launches
    got = model(batch, impl="cuda")
    assert window_attn.window_attn.launches == before + cfg.n_layers
    assert got.shape == (2, 2048, cfg.vocab)
    torch.testing.assert_close(got, model(batch, impl="ref"), rtol=1e-4,
                               atol=1e-4)


# -- ssd_scan ---------------------------------------------------------------------

def ssd_inputs(b, t, h, p, n, seed, device):
    """The distribution of the reference's sweep (tests/test_kernels.py),
    made with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)) - 1))
    A = -np.exp(rng.standard_normal(h) * 0.3)
    B = rng.standard_normal((b, t, n)) * 0.5
    C = rng.standard_normal((b, t, n)) * 0.5
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device)
                 for a in (x, dt, A, B, C))


# float32 on both sides, the sums taken in other orders: the reference's own
# tolerance for its SSD kernel, 2e-4, at the reference's sweep and at
# zamba2's head and state sizes (h 80, n 64) and mamba2's (p 64, n 128)
@pytest.mark.cuda
@pytest.mark.parametrize("t,chunk", [(128, 32), (256, 64), (192, 64),
                                     (256, 128), (200, 100), (64, 16)])
@pytest.mark.parametrize("h,p,n", [(2, 16, 8), (3, 32, 16), (80, 64, 64),
                                   (4, 64, 128)])
def test_ssd_scan_kernel_matches_plain_version(cuda_device, t, chunk, h, p,
                                               n):
    args = ssd_inputs(2, t, h, p, n, t + chunk + h, cuda_device)
    y, state = ssd_scan.ssd_scan(*args, chunk)
    y_ref, state_ref = ops.ssd_scan(*args, chunk, impl="ref")
    torch.testing.assert_close(y, y_ref, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(state, state_ref, rtol=2e-4, atol=2e-4)


# P and N that are not multiples of 8 (4-float copies where they are not
# multiples of 4), a chunk of 256 (its factor arrays past the 64-row tiles),
# and zamba2's N 64 and mamba2's N 128 state tiles
@pytest.mark.cuda
@pytest.mark.parametrize("t,chunk,h,p,n", [(256, 64, 2, 20, 12),
                                           (192, 64, 3, 7, 5),
                                           (512, 256, 2, 64, 128),
                                           (512, 256, 3, 20, 12),
                                           (300, 100, 2, 70, 66),
                                           (256, 128, 2, 64, 64)])
def test_ssd_scan_kernel_ragged_widths_and_long_chunks(cuda_device, t,
                                                       chunk, h, p, n):
    args = ssd_inputs(2, t, h, p, n, t + p + n, cuda_device)
    y, state = ssd_scan.ssd_scan(*args, chunk)
    y_ref, state_ref = ops.ssd_scan(*args, chunk, impl="ref")
    torch.testing.assert_close(y, y_ref, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(state, state_ref, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("source,kernels", [
    ("window_attn.cu", ("window_attn_kernel",)),
    ("ssd_scan.cu", ("ssd_cb_kernel", "ssd_state_kernel", "ssd_out_kernel"))])
def test_products_run_on_tensor_cores(cuda_device, source, kernels):
    """Every instance of the kernels that hold K5's and K4's products
    contains HMMA (tensor-core) instructions in its SASS."""
    from repro_torch.kernels import _build
    counts = _build.opcode_counts(source, "HMMA")
    if counts is None:
        pytest.skip("the CUDA toolkit has no cuobjdump to read the SASS")
    mine = {k: v for k, v in counts.items() if k.startswith(kernels)}
    assert mine and all(v > 0 for v in mine.values()), counts


@pytest.mark.cuda
def test_ssd_scan_counts_launches_and_rejects_bad_inputs(cuda_device):
    x, dt, A, B, C = ssd_inputs(1, 64, 2, 16, 8, 0, cuda_device)
    before = ssd_scan.ssd_scan.launches
    ops.ssd_scan(x, dt, A, B, C, 32, impl="cuda")
    assert ssd_scan.ssd_scan.launches == before + 1
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.ssd_scan(*(a.cpu() for a in (x, dt, A, B, C)), 32, impl="cuda")
    with pytest.raises(TypeError, match="float32"):
        ssd_scan.ssd_scan(x.double(), dt, A, B, C, 32)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2),
                          dt, A, B, C, 32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan.ssd_scan(x, dt, A, B, C, 48)
    with pytest.raises(ValueError, match="do not match"):
        ssd_scan.ssd_scan(x, dt[:, :, :1].contiguous(), A, B, C, 32)
    assert ssd_scan.ssd_scan.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_ssm_forward_through_the_kernel_matches_ref(cuda_device, arch):
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device=cuda_device)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 100))).to(cuda_device)
    before = ssd_scan.ssd_scan.launches
    got = model({"tokens": tok}, impl="cuda")
    assert ssd_scan.ssd_scan.launches == before + cfg.n_layers
    torch.testing.assert_close(got, model({"tokens": tok}, impl="ref"),
                               rtol=1e-4, atol=1e-4)


# -- quant_matmul -----------------------------------------------------------------

def qmm_inputs(m, k, n, bf16, seed, device):
    """The reference sweep's distribution (tests/test_kernels.py), made with
    numpy: x normal (optionally rounded through bf16), per-column int8
    weights, x_scale = max|x| / 127 as a 0-d tensor on the device."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    if bf16:
        x = x.bfloat16().float()
    w = torch.from_numpy((rng.standard_normal((k, n)) * 0.05).astype(
        np.float32))
    w_scale = w.abs().amax(dim=0) / 127.0
    w_q = torch.clamp(torch.round(w / w_scale[None, :]), -128, 127).to(
        torch.int8)
    x_scale = x.abs().max() / 127.0
    return tuple(a.to(device) for a in (x, w_q, w_scale, x_scale))


# int32 sums are exact and the plain version's float32 sums of integer
# products are exact while they stay below 2^24 (they do at these shapes),
# the epilogue is the same two products: the reference's tolerance, 1e-5,
# at its sweep, ragged shapes and EfficientNet-B0's head; at K = 25088
# (VGG-16's first classifier layer) a relative bound of 1e-6 of max|y|.
# Against the exact reference (the sum in float64, rounded once) the kernel
# is equal bit for bit at every shape.
@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 128),
                                   (128, 256, 256), (256, 256, 256),
                                   (100, 96, 50), (1, 1, 1), (3, 5, 7),
                                   (65, 130, 67), (256, 1280, 1000),
                                   (1, 1280, 1000), (5, 40, 1000),
                                   (70, 443, 129)])
@pytest.mark.parametrize("bf16", [False, True])
def test_quant_matmul_kernel_matches_plain_version(cuda_device, m, k, n,
                                                   bf16):
    args = qmm_inputs(m, k, n, bf16, m + k + n, cuda_device)
    got = quant_matmul.quant_matmul(*args)
    torch.testing.assert_close(got, ops.quant_matmul(*args, impl="ref"),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got, testing.quant_matmul_exact(*args))


@pytest.mark.cuda
def test_quant_matmul_kernel_at_vgg16_depth(cuda_device):
    args = qmm_inputs(256, 25088, 512, False, 1, cuda_device)
    got = quant_matmul.quant_matmul(*args)
    want = ops.quant_matmul(*args, impl="ref")
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert torch.equal(got, testing.quant_matmul_exact(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(256, 1280, 1000), (130, 443, 260),
                                   (3, 25088, 7)])
@pytest.mark.parametrize("splits", [1, 2, 3, 7, 64])
def test_quant_matmul_every_split_gives_the_same_bits(cuda_device, m, k, n,
                                                      splits):
    args = qmm_inputs(m, k, n, False, splits, cuda_device)
    got = quant_matmul.quant_matmul(*args, splits=splits)
    assert torch.equal(got, testing.quant_matmul_exact(*args))


@pytest.mark.cuda
def test_quant_matmul_two_calls_agree_on_one_and_on_two_streams(cuda_device):
    args = qmm_inputs(256, 1280, 1000, False, 3, cuda_device)
    want = testing.quant_matmul_exact(*args)
    assert torch.equal(quant_matmul.quant_matmul(*args), want)
    assert torch.equal(quant_matmul.quant_matmul(*args), want)
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    torch.cuda.synchronize()
    outs = []
    for _ in range(4):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(quant_matmul.quant_matmul(*args))
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)


@pytest.mark.cuda
def test_quant_matmul_product_runs_on_int8_tensor_cores(cuda_device):
    """The product kernel's SASS holds IMMA (int8 tensor-core) instructions
    and no IDP4A (the CUDA cores' 4-way dot product)."""
    from repro_torch.kernels import _build
    imma = _build.opcode_counts("quant_matmul.cu", "IMMA")
    if imma is None:
        pytest.skip("the CUDA toolkit has no cuobjdump to read the SASS")
    dp4a = _build.opcode_counts("quant_matmul.cu", "IDP4A")
    product = [k for k in imma if k.startswith("qmm_product_kernel")]
    assert product and all(imma[k] > 0 and dp4a[k] == 0 for k in product), (
        imma, dp4a)


@pytest.mark.cuda
def test_quant_matmul_counts_launches_and_rejects_bad_inputs(cuda_device):
    x, w_q, w_scale, x_scale = qmm_inputs(8, 12, 5, False, 0, cuda_device)
    before = quant_matmul.quant_matmul.launches
    ops.quant_matmul(x, w_q, w_scale, x_scale, impl="cuda")
    assert quant_matmul.quant_matmul.launches == before + 1
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.quant_matmul(x.cpu(), w_q.cpu(), w_scale.cpu(), x_scale.cpu(),
                         impl="cuda")
    with pytest.raises(TypeError, match="int8"):
        quant_matmul.quant_matmul(x, w_q.float(), w_scale, x_scale)
    with pytest.raises(TypeError, match="float32"):
        quant_matmul.quant_matmul(x.double(), w_q, w_scale, x_scale)
    with pytest.raises(ValueError, match="not \\(M, K\\) and \\(K, N\\)"):
        quant_matmul.quant_matmul(x[:, :8].contiguous(), w_q, w_scale,
                                  x_scale)
    with pytest.raises(ValueError, match="contiguous"):
        quant_matmul.quant_matmul(x.t().contiguous().t(), w_q, w_scale,
                                  x_scale)
    with pytest.raises(ValueError, match="w_scale"):
        quant_matmul.quant_matmul(x, w_q, w_scale[:3].contiguous(), x_scale)
    with pytest.raises(ValueError, match="scalar"):
        quant_matmul.quant_matmul(x, w_q, w_scale, x_scale.repeat(2))
    assert quant_matmul.quant_matmul.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("cuts", [[2], [1, 4]])
def test_cnn_runner_on_card_equals_monolithic(cuda_device, cuts):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    model = reduced_cnn("efficientnet_b0").init_weights(
        torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 3, 32, 32)).astype(np.float32)).to(cuda_device)
    with torch.no_grad():
        mono = model(x)
    part, rep = PartitionedCNNRunner(model, cuts).run(x, time_stages=True)
    assert torch.equal(part, mono)
    assert len(rep.latency_s) == len(cuts) + 1


# -- the serve runtime ------------------------------------------------------------

@pytest.mark.cuda
def test_served_tokens_async_equal_serial_on_card(cuda_device):
    """A reduced smollm-360m served on the card through two stages, each
    on its own stream: the async pipeline gives the serial handoff's
    greedy tokens exactly (the same stage programs at the same shapes)."""
    from repro_torch.serve import (PipelineServeEngine, Request,
                                   poisson_traffic, stream_of)
    from repro_torch.serving import PartitionedLMRunner
    cfg = get_config("smollm-360m").reduced()
    model = DecoderLM(cfg, device=cuda_device)
    runner = PartitionedLMRunner(model, cuts=[0])
    reqs = [Request(r.rid, r.prompt, r.max_new, 0.0) for r in poisson_traffic(
        8, rate_rps=1000.0, vocab=cfg.vocab, prompt_len=12, max_new=8,
        seed=1)]
    tokens = {}
    for mode in ("serial", "async"):
        eng = PipelineServeEngine(runner, n_slots=4, n_groups=2, mode=mode,
                                  capacity=32)
        assert all(st.stream is not None for st in eng.stages)
        eng.warmup(prompt_len=12)
        rep = eng.run(stream_of(reqs), max_wall_s=120.0)
        assert rep.n_done == len(reqs)
        tokens[mode] = {r.rid: r.tokens for r in rep.records}
    assert tokens["async"] == tokens["serial"]


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_train_step_on_card_matches_cpu(cuda_device, remat):
    """One SGD step (momentum 0, no clip) of reduced smollm-360m on the
    card against the port's own step on the CPU from the same weights:
    loss within 1e-5 relative, parameters within 1e-5 (float32 sums in
    other orders; the embedding's backward adds by atomics on the card)."""
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.optim import sgd
    from repro_torch.training import init_params, make_train_step

    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              remat=remat)
    cpu = build_model(cfg, device="cpu")
    card = build_model(cfg, device="meta")
    card.to_empty(device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    batch = make_batch_for(cfg, 4, 32, seed=0)
    losses = []
    for m in (cpu, card):
        opt = sgd(0.1, momentum=0.0)
        step = make_train_step(m, cfg, opt, clip_norm=None)
        _, metrics = step(opt.init(init_params(m)), batch)
        assert metrics["loss"].device == m.device
        losses.append(float(metrics["loss"]))
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0]), losses
    for (n, a), (_, b) in zip(cpu.named_parameters(),
                              card.named_parameters()):
        assert float((a - b.cpu()).abs().max()) <= 1e-5, n


# -- MoE and MLA (deepseek-moe-16b, deepseek-v3-671b) ------------------------------

def _moe_input(model, batch):
    """The first MoE block's FFN input, captured by a forward hook."""
    got = {}
    moe = model.blocks[model.n_dense].moe

    def keep(mod, args, out):
        got["h"] = args[0].detach()
    handle = moe.register_forward_hook(keep)
    try:
        with torch.no_grad():
            model(batch)
    finally:
        handle.remove()
    return moe, got["h"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v3-671b"])
def test_moe_model_on_card_matches_cpu(cuda_device, arch):
    """The reduced model on the card against the same weights on the CPU:
    the router's top-k indices equal wherever the k-th and (k+1)-th scores
    are more than 1e-5 apart (a nearer tie may order the other way in
    float32 sums of other orders), the logits, ``mtp_logits`` and aux
    within 2e-5, and one SGD step's loss within 1e-5 relative and
    parameters within 1e-5."""
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.optim import sgd
    from repro_torch.training import init_params, make_train_step

    cfg = get_config(arch).reduced()
    cpu = build_model(cfg, device="cpu")
    card = build_model(cfg, device="meta")
    card.to_empty(device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    batch = make_batch_for(cfg, 4, 32, seed=0)
    tok = {"tokens": batch["tokens"]}
    (m_cpu, h_cpu), (m_card, h_card) = (_moe_input(m, tok)
                                        for m in (cpu, card))
    torch.testing.assert_close(h_card.cpu(), h_cpu, rtol=2e-5, atol=2e-5)
    with torch.no_grad():
        _, s_cpu, _, i_cpu = m_cpu.route(h_cpu)
        _, _, _, i_card = m_card.route(h_cpu.to(cuda_device))
    top = torch.topk(s_cpu, cfg.top_k + 1, dim=-1).values
    clear = (top[..., -2] - top[..., -1]) > 1e-5
    assert bool(clear.float().mean() > 0.9)
    assert torch.equal(i_card.cpu()[clear], i_cpu[clear])
    with torch.no_grad():
        got = card.forward_aux(tok, train=True)
        want = cpu.forward_aux(tok, train=True)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=2e-5, atol=2e-5)
    assert set(got[1]) == set(want[1])
    for key in want[1]:
        torch.testing.assert_close(got[1][key].cpu(), want[1][key],
                                   rtol=2e-5, atol=2e-5)
    losses = []
    for m in (cpu, card):
        opt = sgd(0.1, momentum=0.0)
        step = make_train_step(m, cfg, opt, clip_norm=None)
        _, metrics = step(opt.init(init_params(m)), batch)
        losses.append(float(metrics["loss"]))
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0]), losses
    for (n, a), (_, b) in zip(cpu.named_parameters(),
                              card.named_parameters()):
        assert float((a - b.cpu()).abs().max()) <= 1e-5, n


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v3-671b"])
def test_moe_decode_on_card_matches_forward(cuda_device, arch):
    """``GenerationEngine``'s first-step logits (the cache path: MLA's
    absorbed decode for deepseek-v3-671b) against the forward on the card
    within 2e-5, and ``SlotDecoder``'s lane prefill against the same."""
    from repro_torch.serving import GenerationEngine
    from repro_torch.serving.engine import SlotDecoder
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device=cuda_device)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (3, 12))
    first, _ = GenerationEngine(model, max_seq=24).prefill(prompts)
    with torch.no_grad():
        want = model({"tokens": torch.from_numpy(prompts).to(cuda_device)})
    torch.testing.assert_close(first, want[:, -1], rtol=2e-5, atol=2e-5)
    sd = SlotDecoder(model, n_slots=3, max_seq=24)
    for slot in (2, 0):
        got = sd.prefill(slot, prompts[slot])
        np.testing.assert_allclose(got, want[slot, -1].cpu().numpy(),
                                   rtol=2e-5, atol=2e-5)
    assert sd.decode(np.zeros(3, np.int32)).shape == (3, cfg.vocab)


# -- the pipeline and the dry-run's estimate (launch/) --------------------------

def pipeline_model(device):
    """Reduced smollm-360m at 4 layers, window 128, and 4 x 512 tokens (T
    above the window, so K5 is taken)."""
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              window=128, n_layers=4)
    model = build_model(cfg, device=device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 512))).to(device)
    return cfg, model, {"tokens": toks}


@pytest.mark.cuda
@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipelined_forward_through_the_kernel_matches_ref(cuda_device,
                                                         n_stages):
    """Stage streams on one card, K5 in every block: the logits of the
    monolithic forward at ``impl="ref"`` within the reference test's
    bound (tests/test_pipeline_multidev.py)."""
    from repro_torch.launch.mesh import make_stage_mesh
    from repro_torch.launch.pipeline import pipelined_apply, stack_stages
    cfg, model, batch = pipeline_model(cuda_device)
    with torch.no_grad():
        want = model(batch, impl="ref")
    got = pipelined_apply(model, stack_stages(model, n_stages), batch,
                          make_stage_mesh(n_stages, cuda_device), 4,
                          impl="cuda")
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_pipeline_launches_the_kernel_per_block_and_microbatch(cuda_device):
    from repro_torch.launch.mesh import make_stage_mesh
    from repro_torch.launch.pipeline import pipelined_apply, stack_stages
    cfg, model, batch = pipeline_model(cuda_device)
    for n_micro in (1, 2, 4):
        before = window_attn.window_attn.launches
        pipelined_apply(model, stack_stages(model, 4), batch,
                        make_stage_mesh(4, cuda_device), n_micro)
        assert window_attn.window_attn.launches - before == \
            cfg.n_layers * n_micro


@pytest.mark.cuda
def test_train_setup_argument_bytes_match_the_allocator(cuda_device):
    """The dry-run's argument bytes of a reduced smollm-360m AdamW step
    (built on meta) within 1 % of what the allocator holds after the same
    setup is built on the card with its batch."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.rules import per_device_bytes
    from repro_torch.launch.steps import build_train_setup
    cfg = get_config("smollm-360m").reduced()
    shape = ShapeConfig("small", 64, 4, "train")
    mesh = make_host_mesh(device=cuda_device)
    est = build_train_setup(cfg, shape, mesh)
    want = per_device_bytes(est.arg_shapes, est.in_shardings)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    setup = build_train_setup(cfg, shape, mesh, device=cuda_device)
    batch = {k: torch.zeros((4, 64), dtype=torch.int32, device=cuda_device)
             for k in ("tokens", "labels")}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    assert abs(held - want) <= 0.01 * held, (held, want)
    params, opt_state, metrics = setup.args[0], setup.args[1], None
    out = setup.step_fn(params, opt_state, {}, batch)
    metrics = out[3]
    assert torch.isfinite(metrics["loss"])
