"""The numeric design of the port's tensor-core products, emulated with numpy.

``src/repro_torch/kernels/csrc/mma_tf32x3.cuh`` takes each float32 product
of the sliding-window attention (K5) and SSD scan (K4) kernels as three
TF32 products: every operand x is split into hi = rna(x) and lo = rna(x -
hi), TF32 values (10 mantissa bits), and a.b = lo.hi + hi.lo + hi.hi,
summed in float32 per 8-deep ``mma.sync`` step, small terms first.  No
kernel runs here: these tests hold the rounding (``cvt.rna.tf32.f32`` and
its integer form), the split's error, and the two kernels' algorithms with
emulated products against their plain versions, at the tolerances that
``chip_smoke.py`` gates on the card.  They also show why one TF32 product
is not enough.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402

WA_TOL = 2e-5          # chip_smoke.WA_TOL: window_attn against its plain version
SSD_TOL = 2e-4         # chip_smoke.SSD_TOL: ssd_scan at the reference's sweep
SPLIT_REL = 1e-6       # the 3-term split against float64, relative to sum |a||b|
LOG2E = 1.4426950408889634


# -- rounding -------------------------------------------------------------------

def to_tf32(x):
    """``cvt.rna.tf32.f32``: the nearest value with 10 mantissa bits, ties
    away from zero; inf and NaN pass through."""
    u = np.asarray(x, np.float32).view(np.uint32)
    special = (u & 0x7F800000) == 0x7F800000
    r = ((u.astype(np.uint64) + 0x1000) & 0xFFFFE000).astype(np.uint32)
    return np.where(special, u, r).view(np.float32)


def to_tf32_non_nan(x):
    """The kernels' integer form of the same rounding (``to_tf32_non_nan``):
    add half a TF32 ulp to the bits, clear the 13 low ones, in uint32."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    x = np.asarray(x, np.float32)
    hi = to_tf32(x)
    return hi, to_tf32_non_nan(x - hi)


def bits(*words):
    return np.array(words, np.uint32).view(np.float32)


ROUNDING = [
    # (input bits, cvt.rna result bits)
    (0x3F801000, 0x3F802000),   # 1 + 2^-11: a tie, away from zero (up)
    (0xBF801000, 0xBF802000),   # its negative: away from zero (down)
    (0x3F803000, 0x3F804000),   # 1 + 3 2^-11: a tie whose even neighbour is below
    (0x3F800FFF, 0x3F800000),   # below the tie
    (0x3F801001, 0x3F802000),   # above the tie
    (0xC0123456, 0xC0124000),   # a negative value, rounded in magnitude
    (0x3FFFFFFF, 0x40000000),   # the carry reaches the exponent
    (0x7F7FFFFF, 0x7F800000),   # the largest float32 rounds to inf
    (0x00000FFF, 0x00000000),   # subnormal below half a TF32 ulp
    (0x00001000, 0x00002000),   # subnormal tie, away from zero
    (0x807FF000, 0x80800000),   # negative subnormal carried into the normals
    (0x00000000, 0x00000000),
    (0x80000000, 0x80000000),
    (0x7F800000, 0x7F800000),   # inf
    (0xFF800000, 0xFF800000),   # -inf
]


@pytest.mark.parametrize("word,want", ROUNDING)
def test_cvt_rna_emulation_on_chosen_bit_patterns(word, want):
    got = to_tf32(bits(word)).view(np.uint32)[0]
    assert got == want, (hex(word), hex(got), hex(want))
    assert to_tf32_non_nan(bits(word)).view(np.uint32)[0] == want


@pytest.mark.parametrize("word", [0x7FC00000, 0x7FFFFFFF, 0xFFFFFFFF,
                                  0x7F800001])
def test_nan_passes_the_cvt_but_not_the_integer_form(word):
    assert to_tf32(bits(word)).view(np.uint32)[0] == word
    # the card's canonical NaN carries into the sign bit: this is why the
    # kernels split hi with the cvt and keep the integer form for lo = x -
    # hi, which is NaN only where hi already is NaN or inf
    if word in (0x7FFFFFFF, 0xFFFFFFFF):
        assert to_tf32_non_nan(bits(word))[0] == 0.0


def test_integer_rounding_equals_cvt_on_every_non_nan_pattern():
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2 ** 32, 1 << 20, dtype=np.uint64).astype(np.uint32)
    x = u.view(np.float32)
    keep = ~np.isnan(x)
    got, want = to_tf32_non_nan(x[keep]), to_tf32(x[keep])
    assert (got.view(np.uint32) == want.view(np.uint32)).all()
    assert (want.view(np.uint32) & 0x1FFF == 0).all()
    finite = np.isfinite(want)
    # nearest TF32 value: within half a TF32 ulp of x
    err = np.abs(want[finite].astype(np.float64) - x[keep][finite])
    ulp = np.spacing(np.abs(x[keep][finite])).astype(np.float64) * 2 ** 13
    assert (err <= ulp / 2).all()


def test_split_is_exact_to_tf32_width():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(1 << 16) * np.exp(rng.uniform(-30, 30, 1 << 16))
         ).astype(np.float32)
    hi, lo = split(x)
    assert ((hi.view(np.uint32) & 0x1FFF) == 0).all()
    assert ((lo.view(np.uint32) & 0x1FFF) == 0).all()
    rel = np.abs((hi.astype(np.float64) + lo) - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -21   # hi + lo keeps 22 of x's 24 bits


# -- products -------------------------------------------------------------------

def mma(a, b, terms):
    """a (M, K) @ b (K, N) as ``mma.sync`` m16n8k8 steps sum it: each
    8-deep step adds its exact TF32 products to a float32 accumulator, one
    product after the other; ``terms`` is 1 (hi.hi) or 3 (lo.hi, hi.lo,
    hi.hi)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    k = a.shape[1]
    pad = (-k) % 8
    a = np.pad(a, ((0, 0), (0, pad)))
    b = np.pad(b, ((0, pad), (0, 0)))
    if terms == 3:
        (ah, al), (bh, bl) = split(a), split(b)
        pairs = ((al, bh), (ah, bl), (ah, bh))
    else:
        pairs = ((to_tf32(a), to_tf32(b)),)
    d = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in pairs:
            step = x[:, k0:k0 + 8].astype(np.float64) @ y[k0:k0 + 8].astype(
                np.float64)
            d = (d + step).astype(np.float32)
    return d


@pytest.mark.parametrize("depth", [32, 64, 128, 160, 256])
def test_three_term_split_error_against_float64(depth):
    """K5 reduces over hd (32-160) and 64 keys, K4 over chunk 128 and N 128."""
    rng = np.random.default_rng(depth)
    a = rng.standard_normal((64, depth)).astype(np.float32)
    b = rng.standard_normal((depth, 64)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    err3 = np.abs(mma(a, b, 3) - exact) / scale
    err1 = np.abs(mma(a, b, 1) - exact) / scale
    assert err3.max() <= SPLIT_REL, err3.max()
    assert err1.max() > 30 * SPLIT_REL, err1.max()   # one TF32 product


# -- the kernels' algorithms with emulated products ----------------------------

def window_attn_emulated(q, k, v, window, terms, block_k=64):
    """``window_attn.cu``'s arithmetic: base-2 scores from Q scaled by
    log2(e)/sqrt(hd), an online softmax over 64-key tiles (invalid scores
    selected to -1e30, their p to 0), O += P V, the denominator clamped at
    1e-20; both products through :func:`mma`."""
    b, t, h, hd = q.shape
    group = h // k.shape[2]
    scale = np.float32(LOG2E / math.sqrt(hd))
    out = np.zeros_like(q)
    pos = np.arange(t)
    for bi in range(b):
        for hi in range(h):
            qs = q[bi, :, hi] * scale
            kh, vh = k[bi, :, hi // group], v[bi, :, hi // group]
            m = np.full(t, -1e30, np.float32)
            l = np.zeros(t, np.float32)
            acc = np.zeros((t, hd), np.float32)
            for k0 in range(0, t, block_k):
                kp = pos[k0:k0 + block_k]
                s = mma(qs, kh[k0:k0 + block_k].T, terms)
                valid = (kp[None] <= pos[:, None]) & (
                    kp[None] > pos[:, None] - window)
                s = np.where(valid, s, np.float32(-1e30))
                m_new = np.maximum(m, s.max(axis=1))
                alpha = np.exp2(m - m_new)
                p = np.where(valid, np.exp2(s - m_new[:, None]),
                             np.float32(0))
                l = l * alpha + p.sum(axis=1, dtype=np.float32)
                acc = acc * alpha[:, None] + mma(p, vh[k0:k0 + block_k],
                                                 terms)
                m = m_new
            out[bi, :, hi] = acc / np.maximum(l, np.float32(1e-20))[:, None]
    return out


def qkv(b, t, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, t, h, hd), (b, t, kv, hd), (b, t, kv, hd)))


def window_ref(q, k, v, window):
    return ref.window_attn_gqa(*map(torch.from_numpy, (q, k, v)),
                               window).numpy()


@pytest.mark.parametrize("t,window", [(1, 1), (100, 1), (100, 64),
                                      (130, 100), (200, 300)])
@pytest.mark.parametrize("group", [1, 3])
def test_window_attn_with_emulated_products_matches_plain(t, window, group):
    q, k, v = qkv(2, t, 2 * group, 2, 32, t + window + group)
    got = window_attn_emulated(q, k, v, window, terms=3)
    np.testing.assert_allclose(got, window_ref(q, k, v, window), rtol=WA_TOL,
                               atol=WA_TOL)


def test_one_tf32_product_misses_the_window_attn_gate():
    """The reason for the split: at hd 64 one TF32 product per float32
    product is off by more than 1e-4, five times ``WA_TOL``."""
    q, k, v = qkv(1, 512, 2, 2, 64, 7)
    want = window_ref(q, k, v, 256)
    err1 = np.abs(window_attn_emulated(q, k, v, 256, terms=1) - want).max()
    err3 = np.abs(window_attn_emulated(q, k, v, 256, terms=3) - want).max()
    assert err1 > 1e-4, err1
    assert err3 < WA_TOL, err3


def ssd_scan_emulated(x, dt, A, B, C, chunk):
    """``ssd_scan.cu``'s arithmetic: the in-order cumulative decay, C.B^T,
    the chunk states x dt exp(cs_end - cs) B, the carried states, and the
    output [L o CB | exp(cs) C] . [dt x ; H^T], the three products through
    :func:`mma`, the decay above the diagonal selected to 0."""
    b, t, h, p = x.shape
    n = B.shape[-1]
    nc = t // chunk
    y = np.zeros_like(x)
    final = np.zeros((b, h, p, n), np.float32)
    for bi in range(b):
        for hi in range(h):
            carry = np.zeros((p, n), np.float32)
            for z in range(nc):
                rows = slice(z * chunk, (z + 1) * chunk)
                da = dt[bi, rows, hi] * A[hi]
                cs = np.zeros(chunk, np.float32)
                acc = np.float32(0)
                for i in range(chunk):
                    acc = np.float32(acc + da[i])
                    cs[i] = acc
                xc, dtc = x[bi, rows, hi], dt[bi, rows, hi]
                Bc, Cc = B[bi, rows], C[bi, rows]
                cb = mma(Cc, Bc.T, 3)
                tri = np.tril(np.ones((chunk, chunk), bool))
                with np.errstate(over="ignore"):
                    decay = np.exp(cs[:, None] - cs[None, :])
                lcb = np.where(tri, cb * decay, np.float32(0))
                xdt = xc * dtc[:, None]
                dec = np.exp(cs[-1] - cs)
                state = mma((xdt * dec[:, None]).T, Bc, 3)
                lhs = np.concatenate([lcb, Cc * np.exp(cs)[:, None]], axis=1)
                rhs = np.concatenate([xdt, carry.T], axis=0)
                y[bi, rows, hi] = mma(lhs, rhs, 3)
                carry = carry * np.exp(cs[-1]) + state
            final[bi, hi] = carry
    return y, final


SSD_SWEEP = [(t, chunk, h, p, n) for t, chunk in ((128, 32), (256, 64),
                                                  (192, 64))
             for h, p, n in ((2, 16, 8), (3, 32, 16))]


@pytest.mark.parametrize("t,chunk,h,p,n", SSD_SWEEP)
def test_ssd_scan_with_emulated_products_matches_plain(t, chunk, h, p, n):
    """The reference's sweep shapes and input distribution
    (tests/test_kernels.py), at its tolerance."""
    rng = np.random.default_rng(t + chunk + h)
    x = rng.standard_normal((2, t, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((2, t, h)) - 1))
    A = -np.exp(rng.standard_normal(h) * 0.3)
    B = rng.standard_normal((2, t, n)) * 0.5
    C = rng.standard_normal((2, t, n)) * 0.5
    args = [a.astype(np.float32) for a in (x, dt, A, B, C)]
    y, final = ssd_scan_emulated(*args, chunk)
    y_ref, final_ref = ref.ssd_scan(*map(torch.from_numpy, args), chunk)
    np.testing.assert_allclose(y, y_ref.numpy(), rtol=SSD_TOL, atol=SSD_TOL)
    np.testing.assert_allclose(final, final_ref.numpy(), rtol=SSD_TOL,
                               atol=SSD_TOL)
