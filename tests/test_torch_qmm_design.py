"""The design of ``csrc/quant_matmul.cu`` (K3 on the int8 tensor cores)
emulated with numpy, held bit for bit against
``repro_torch.testing.quant_matmul_exact`` (no kernel runs here):

* the mma.sync m16n8k32 s8 fragment layout of ``csrc/mma_s8.cuh`` against
  CUTLASS's ``SM80_16x8x32_S32S8S8S32_TN`` traits, and the kernel's k
  permutation (a whole A fragment from one 16-byte load of the codes in
  their fragment order, two k32 products' B fragments from one of a
  transposed row) against a numpy product;
* the 4 x 4 byte transpose by ``__byte_perm`` selectors on random bytes;
* the shared-memory layouts (swizzled staging rows, swapped transposed
  rows, 64-byte fragment rows) free of bank conflicts for every access;
* the copy of w_q's tile at the width the row stride and address allow:
  no byte read past w_q, every byte of the tile in range copied once;
* the split-K walk: each k-step in one split, the splits' int32 adds in
  any order, one epilogue writer per output; the split count chosen per
  launch;
* the whole kernel (quantize into the fragment order, staging, transpose,
  fragments, splits, int32 sums, epilogue) at small shapes, bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import quant_matmul as qm, ref  # noqa: E402
from repro_torch.testing import quant_matmul_exact  # noqa: E402

BM = BN = 128
BK = 64
THREADS = 256


def byte_perm(x, y, s):
    """``__byte_perm(x, y, s)`` (PTX prmt, default mode) on uint32 arrays:
    byte i of the result is byte ``(s >> 4i) & 7`` of the 8 bytes y:x."""
    v = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(x, np.uint64)
    r = np.zeros(np.shape(v), np.uint64)
    for i in range(4):
        sel = np.uint64((s >> (4 * i)) & 7)
        r |= ((v >> (np.uint64(8) * sel)) & np.uint64(0xff)) << np.uint64(8 * i)
    return r.astype(np.uint32)


def words(buf, offsets, n):
    """``n`` little-endian uint32 words at each byte offset of ``buf``."""
    idx = np.asarray(offsets)[..., None] + np.arange(4 * n)
    return buf[idx].reshape(*np.shape(offsets), n, 4).copy().view(
        np.uint32)[..., 0]


# -- the fragment layout ------------------------------------------------------------

# mma_s8.cuh, per (lane, register, byte): the (m, k) of A, (k, n) of B
LANE, REG, BYTE = np.meshgrid(np.arange(32), np.arange(4), np.arange(4),
                              indexing="ij")
A_M = LANE // 4 + 8 * (REG % 2)
A_K = 4 * (LANE % 4) + BYTE + 16 * (REG // 2)
B_K = (4 * (LANE % 4) + BYTE + 16 * REG)[:, :2]
B_N = (LANE // 4)[:, :2]
C_LANE, C_REG = np.meshgrid(np.arange(32), np.arange(4), indexing="ij")
C_M = C_LANE // 4 + 8 * (C_REG // 2)
C_N = 2 * (C_LANE % 4) + C_REG % 2


def cute(shape, stride, thr, val):
    """A CuTe layout ((thread modes), (value modes)) evaluated at flat
    thread and value indices (column-major within each mode)."""
    idx = 0
    for modes, strides, i in ((shape[0], stride[0], thr),
                              (shape[1], stride[1], val)):
        for s, d in zip(modes, strides):
            idx = idx + (i % s) * d
            i = i // s
    return idx


def test_fragment_layout_is_cutlass_sm80_16x8x32_s8_traits():
    t = np.arange(32)[:, None]
    v = np.arange(16)[None, :]
    a = cute(((4, 8), (4, 2, 2)), ((64, 1), (16, 8, 256)), t, v)
    assert np.array_equal(a % 16, A_M.reshape(32, 16))
    assert np.array_equal(a // 16, A_K.reshape(32, 16))
    b = cute(((4, 8), (4, 2)), ((32, 1), (8, 128)), t, v[:, :8])
    assert np.array_equal(b % 8, B_N.reshape(32, 8))
    assert np.array_equal(b // 8, B_K.reshape(32, 8))
    c = cute(((4, 8), (2, 2)), ((32, 1), (16, 8)), t, v[:, :4])
    assert np.array_equal(c % 16, C_M)
    assert np.array_equal(c // 16, C_N)
    # each element of A, B and C held by exactly one (lane, register, byte)
    assert len(set(zip(A_M.ravel(), A_K.ravel()))) == 16 * 32
    assert len(set(zip(B_K.ravel(), B_N.ravel()))) == 32 * 8
    assert len(set(zip(C_M.ravel(), C_N.ravel()))) == 16 * 8


def mma(acc, a, b):
    """mma.sync m16n8k32 s32.s8.s8.s32 over the layout above: acc (..., 32,
    4) int64, a (..., 32, 4) and b (..., 32, 2) uint32 registers."""
    ab = a.view(np.int8).reshape(*a.shape, 4)
    bb = b.view(np.int8).reshape(*b.shape, 4)
    A = np.zeros((*a.shape[:-2], 16, 32), np.int64)
    B = np.zeros((*b.shape[:-2], 32, 8), np.int64)
    A[..., A_M, A_K] = ab
    B[..., B_K, B_N] = bb
    C = A @ B
    return acc + C[..., C_M, C_N]


def chunk_row_k(idx, steps):
    """The first row and k of 16-byte chunk ``idx`` of the codes
    (``chunk_row`` and ``chunk_k`` of quant_matmul.cu): 8 KB blocks per
    (128-row tile, 64-deep k-step), 1 KB per 16 rows, lane (g, t)'s chunk of
    k32 product s at ((s * 8 + g) * 4 + t) * 16."""
    block, c = idx // 512, idx % 512
    row = block // steps * BM + 16 * (c // 64) + (c // 4) % 8
    k = block % steps * BK + 16 * (c % 4) + 8 * (c % 64 // 32)
    return row, k


def fragment_order(codes):
    """(Mp, Kp) int8 codes (Mp a multiple of 128, Kp of 64) in the order
    the quantize launch writes them: each chunk rows r, r + 8 word by word
    at k..k+3, then at k+4..k+7."""
    mp, kp = codes.shape
    row, k = chunk_row_k(np.arange(mp * kp // 16), kp // BK)
    b = codes.view(np.uint8)
    parts = [b[row[:, None], k[:, None] + np.arange(4)],
             b[row[:, None] + 8, k[:, None] + np.arange(4)],
             b[row[:, None], k[:, None] + 4 + np.arange(4)],
             b[row[:, None] + 8, k[:, None] + 4 + np.arange(4)]]
    return np.concatenate(parts, 1).ravel()


def test_fragment_order_holds_every_code_once():
    codes = np.arange(256 * 128).astype(np.int64)
    row, k = chunk_row_k(np.arange(256 * 128 // 16), 2)
    cells = {(r + 8 * h, kk + 4 * q + b) for r, kk in zip(row, k)
             for h in (0, 1) for q in (0, 1) for b in range(4)}
    assert len(cells) == codes.size
    assert cells == {(r, kk) for r in range(256) for kk in range(128)}


@pytest.mark.parametrize("seed", range(3))
def test_one_load_per_lane_feeds_a_whole_fragment(seed):
    """A 16 x 64 by 64 x 8 product: each lane's A fragment of k32 product s
    is one 16-byte load of the codes' fragment order, its B fragments of
    both products one 16-byte load of its K-contiguous column at byte 16t
    (words 0, 1: b0/b1 of the first product, words 2, 3 of the second)."""
    rng = np.random.default_rng(seed)
    A = np.zeros((BM, BK), np.int8)
    A[:16] = rng.integers(-128, 128, (16, 64))
    Bt = rng.integers(-128, 128, (8, 64)).astype(np.int8)   # [n][k]
    g, t = np.arange(32) // 4, np.arange(32) % 4
    a_flat, b_flat = fragment_order(A), Bt.view(np.uint8).ravel()
    b = words(b_flat, g * 64 + 16 * t, 4)
    acc = np.zeros((32, 4), np.int64)
    for s in range(2):
        a_regs = words(a_flat, ((s * 8 + g) * 4 + t) * 16, 4)
        acc = mma(acc, a_regs, b[:, 2 * s:2 * s + 2])
    want = A[:16].astype(np.int64) @ Bt.astype(np.int64).T
    assert np.array_equal(acc, want[C_M, C_N])
    # one k32 product alone covers half the k: the other half is missing
    half = mma(np.zeros((32, 4), np.int64),
               words(a_flat, (g * 4 + t) * 16, 4), b[:, :2])
    ks = np.concatenate([np.arange(16 * q, 16 * q + 8) for q in range(4)])
    assert np.array_equal(half, (A[:16, ks].astype(np.int64)
                                 @ Bt[:, ks].astype(np.int64).T)[C_M, C_N])


# -- the transpose ------------------------------------------------------------------

def transpose4x4(q0, q1, q2, q3):
    """The kernel's eight selectors: four words of one column group's 4
    rows -> four words of one column's 4 rows."""
    lo01, lo23 = byte_perm(q0, q1, 0x5140), byte_perm(q2, q3, 0x5140)
    hi01, hi23 = byte_perm(q0, q1, 0x7362), byte_perm(q2, q3, 0x7362)
    return (byte_perm(lo01, lo23, 0x5410), byte_perm(lo01, lo23, 0x7632),
            byte_perm(hi01, hi23, 0x5410), byte_perm(hi01, hi23, 0x7632))


@pytest.mark.parametrize("seed", range(4))
def test_byte_perm_selectors_transpose_4x4_bytes(seed):
    rows = np.random.default_rng(seed).integers(0, 256, (1000, 4, 4)).astype(
        np.uint8)                                  # [block][row][column]
    q = rows.copy().view(np.uint32)[..., 0]        # a word per row
    cols = np.stack(transpose4x4(*q.T), -1)        # a word per column
    assert np.array_equal(cols[..., None].view(np.uint8),
                          rows.transpose(0, 2, 1))


def raw_offset(r, b):
    return r * BN + ((((b >> 4) ^ (r >> 3)) & 7) << 4) + (b & 15)


def bt_row(n):
    return n ^ ((n >> 2) & 1)


def transpose_tile(raw):
    """The kernel's transpose of a staged (64 k, 128 n) tile, every thread
    at once; returns the (128 n, 64 k) tile as bytes and the write count of
    each byte."""
    tid = np.arange(THREADS)
    lane, warp = tid % 32, tid // 32
    kq, c = lane % 8, 4 * warp + lane // 8
    r = [words(raw, raw_offset(8 * kq + i, 4 * c), 1)[:, 0] for i in range(8)]
    bt = np.zeros(BN * BK, np.uint8)
    writes = np.zeros(BN * BK, np.int64)
    lo, hi = transpose4x4(*r[:4]), transpose4x4(*r[4:])
    for j in range(4):
        pair = np.stack([lo[j], hi[j]], -1).copy().view(np.uint8)
        at = (bt_row(4 * c + j) * BK + 8 * kq)[:, None] + np.arange(8)
        bt[at] = pair
        np.add.at(writes, at, 1)
    return bt, writes


def test_staged_tile_transposes_to_k_contiguous_rows():
    tile = np.random.default_rng(0).integers(0, 256, (BK, BN)).astype(np.uint8)
    raw = np.zeros(BK * BN, np.uint8)
    r, b = np.meshgrid(np.arange(BK), np.arange(BN), indexing="ij")
    raw[raw_offset(r, b)] = tile
    bt, writes = transpose_tile(raw)
    assert (writes == 1).all()
    n = np.arange(BN)
    assert np.array_equal(bt.reshape(BN, BK)[bt_row(n)], tile.T)


# -- bank conflicts -----------------------------------------------------------------

def wavefronts(addrs, width):
    """Shared-memory wavefronts of one warp's access of ``width`` bytes a
    lane (4: all 32 lanes at once; 8: half-warps; 16: quarter-warps): per
    group, the most distinct 4-byte words that meet one bank."""
    group = 128 // width
    worst = 0
    for g0 in range(0, 32, group):
        banks = {}
        for a in addrs[g0:g0 + group]:
            for w in range(a // 4, (a + width) // 4):
                banks.setdefault(w % 32, set()).add(w)
        worst = max(worst, max(len(v) for v in banks.values()))
    return worst


def test_shared_layouts_are_free_of_bank_conflicts():
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for warp in range(8):
        wm, wn = warp % 2, warp // 2
        for mt in range(4):   # A fragments: 16 bytes of the fragment order
            for s in range(2):
                assert wavefronts((4 * wm + mt) * 1024
                                  + ((s * 8 + g) * 4 + t) * 16, 16) == 1
        for nt in range(4):   # B fragments from the transposed tile
            assert wavefronts(bt_row(32 * wn + 8 * nt + g) * BK + 16 * t,
                              16) == 1
        kq, c = lane % 8, 4 * warp + lane // 8
        for i in range(8):    # the transpose's reads of the staged tile
            assert wavefronts(raw_offset(8 * kq + i, 4 * c), 4) == 1
        for j in range(4):    # ... and its 8-byte stores
            assert wavefronts(bt_row(4 * c + j) * BK + 8 * kq, 8) == 1
    for c0 in range(0, BM * BK // 16, 32):   # cp.async of the codes
        assert wavefronts(16 * (c0 + lane), 16) == 1
    for vec in (16, 8, 4):                   # ... and of w_q's rows
        pieces = BN // vec
        for c0 in range(0, BK * pieces, 32):
            c = c0 + lane
            assert wavefronts(raw_offset(c // pieces, (c % pieces) * vec),
                              vec) == 1
    # without the swizzle the transpose's reads meet 8 rows on one bank
    kq, c = lane % 8, lane // 8
    assert wavefronts((8 * kq) * BN + 4 * c, 4) == 8


# -- the copy of w_q ----------------------------------------------------------------

def copy_width(address, n):
    """``quant_matmul_copy_width``: the widest of 16, 8, 4 bytes dividing
    both w_q's address and its row stride N, else 1."""
    a = address | n
    return 16 if a % 16 == 0 else 8 if a % 8 == 0 else 4 if a % 4 == 0 else 1


def stage_w(w, address, K, N, n0, k0):
    """The kernel's copy of w_q's (64, 128) tile at (k0, n0) into a staged
    tile (bytes of the row-major w_q at its ``address``); asserts every
    piece read lies inside w_q and returns (tile [k][n], copies a byte)."""
    vec = copy_width(address, N)
    pieces = BN // vec
    tile = np.zeros((BK, BN), np.uint8)
    copies = np.zeros((BK, BN), np.int64)
    for c in range(BK * pieces):
        r, b = c // pieces, (c % pieces) * vec
        if k0 + r < K and n0 + b < N:
            src = (k0 + r) * N + n0 + b
            assert (address + src) % vec == 0
            assert 0 <= src and src + vec <= K * N
            tile[r, b:b + vec] = w[src:src + vec]
            copies[r, b:b + vec] += 1
    return tile, copies


@pytest.mark.parametrize("N", (1, 7, 50, 67, 100, 1000, 1001, 4096))
@pytest.mark.parametrize("offset", (0, 1, 4, 8))
def test_w_copy_width_reads_only_w_q(N, offset):
    K = 70
    address = 256 + offset                 # an allocation's start, offset
    vec = copy_width(address, N)
    assert N % vec == 0 and address % vec == 0
    assert vec == 16 or (N | address) % (2 * vec) != 0 or vec == 1
    w = np.random.default_rng(N).integers(0, 256, K * N).astype(np.uint8)
    for n0 in range(0, N, BN):
        for k0 in range(0, K, BK):
            tile, copies = stage_w(w, address, K, N, n0, k0)
            k, n = np.meshgrid(np.arange(k0, k0 + BK), np.arange(n0, n0 + BN),
                               indexing="ij")
            inside = (k < K) & (n < N)
            assert np.array_equal(copies, inside.astype(np.int64))
            want = np.where(inside, w[np.minimum(k, K - 1) * N
                                      + np.minimum(n, N - 1)], 0)
            assert np.array_equal(tile, want)


def test_copy_widths_of_the_zoos_classifiers():
    assert copy_width(0, 1000) == 8        # EfficientNet-B0's head, VGG fc2
    assert copy_width(0, 4096) == 16       # VGG-16's fc0, fc1
    assert copy_width(1000 * 3, 1000) == 8


# -- the split-K walk ---------------------------------------------------------------

def split_ranges(steps, splits):
    return [(steps * z // splits, steps * (z + 1) // splits)
            for z in range(splits)]


@pytest.mark.parametrize("steps,splits", [(1, 1), (7, 3), (20, 10), (392, 4),
                                          (1, 3), (64, 16), (5, 5)])
def test_split_ranges_cover_each_k_step_once(steps, splits):
    seen = np.zeros(steps, np.int64)
    for first, end in split_ranges(steps, splits):
        assert end >= first
        seen[first:end] += 1
    assert (seen == 1).all()
    sizes = [e - f for f, e in split_ranges(steps, splits)]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("seed", range(3))
def test_split_adds_in_any_order_give_the_exact_sums(seed):
    """The split blocks' int32 atomicAdds to the sums (zeroed by the
    quantize launch of the same call) arrive in any order: the sums are the
    same exact integers, which the epilogue launch scales once each."""
    rng = np.random.default_rng(seed)
    tiles = rng.integers(-2 ** 26, 2 ** 26, (8, 3, 5))   # (splits, m, n)
    sums = np.zeros((3, 5), np.int32)
    adds = [(z, i, j) for z in range(8) for i in range(3) for j in range(5)]
    for a in rng.permutation(len(adds)):
        z, i, j = adds[a]
        sums[i, j] += np.int32(tiles[z, i, j])
    assert np.array_equal(sums, tiles.sum(0))


@pytest.mark.parametrize("m,k,n,want", [(256, 25088, 4096, 4),
                                        (256, 4096, 4096, 4),
                                        (256, 4096, 1000, 8),
                                        (256, 1280, 1000, 8),
                                        (256, 384, 1000, 3),
                                        (1, 1, 1, 1), (1, 64, 1, 1),
                                        (1, 25088, 1, 8), (4096, 4096, 4096,
                                                           1)])
def test_split_count_fills_the_card_once(m, k, n, want):
    sms = 132
    splits = qm.split_count(m, k, n, sms)
    assert splits == want
    tiles = -(-m // BM) * -(-n // BN)
    steps = -(-k // BK)
    assert splits == 1 or (tiles * splits <= qm.BLOCKS_PER_SM * sms
                           and steps // splits >= qm.MIN_STEPS
                           and splits <= qm.MAX_SPLITS)
    assert qm.split_count(0, k, n, sms) == 1


# -- the whole kernel ---------------------------------------------------------------

def kernel(x, w_q, w_scale, x_scale, splits):
    """quant_matmul.cu in numpy: the quantize launch into the fragment
    order, each block's staging, transpose, fragments and mma, the splits'
    int32 tiles added to the sums, the epilogue."""
    M, K = x.shape
    N = w_q.shape[1]
    Mp, Kp = -(-M // BM) * BM, -(-K // BK) * BK
    steps = Kp // BK
    xs = np.float32(x_scale)
    codes = np.zeros((Mp, Kp), np.int8)
    codes[:M, :K] = np.clip(np.rint(x / xs), -128, 127)
    xq = fragment_order(codes)
    w = w_q.view(np.uint8).ravel()
    sums = np.zeros((M, N), np.int64)
    out = np.full((M, N), np.nan, np.float32)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for bx in range(Mp // BM):
        for by in range(-(-N // BN)):
            m0, n0 = bx * BM, by * BN
            tile = np.zeros((BM, BN), np.int64)
            for first, end in split_ranges(steps, splits):
                acc = np.zeros((8, 4, 4, 32, 4), np.int64)
                for step in range(first, end):
                    k0 = step * BK
                    block = (bx * steps + step) * BM * BK
                    a = xq[block:block + BM * BK]
                    staged, _ = stage_w(w, 0, K, N, n0, k0)
                    raw = np.zeros(BK * BN, np.uint8)
                    r, b = np.meshgrid(np.arange(BK), np.arange(BN),
                                       indexing="ij")
                    raw[raw_offset(r, b)] = staged
                    bt, _ = transpose_tile(raw)
                    for warp in range(8):
                        wm, wn = warp % 2, warp // 2
                        bw = [words(bt, bt_row(32 * wn + 8 * nt + g) * BK
                                    + 16 * t, 4) for nt in range(4)]
                        for mt in range(4):
                            for s in range(2):
                                regs = words(a, (4 * wm + mt) * 1024
                                             + ((s * 8 + g) * 4 + t) * 16, 4)
                                for nt in range(4):
                                    acc[warp, mt, nt] = mma(
                                        acc[warp, mt, nt], regs,
                                        bw[nt][:, 2 * s:2 * s + 2])
                part = np.zeros((BM, BN), np.int64)
                for warp in range(8):
                    wm, wn = warp % 2, warp // 2
                    for mt in range(4):
                        for nt in range(4):
                            part[64 * wm + 16 * mt + C_M,
                                 32 * wn + 8 * nt + C_N] += acc[warp, mt, nt]
                tile += part
            assert (np.abs(tile) < 2 ** 31).all()
            mm, nn = min(BM, M - m0), min(BN, N - n0)
            sums[m0:m0 + mm, n0:n0 + nn] = tile[:mm, :nn]
    y = (sums.astype(np.float32) * xs).astype(np.float32)
    out[:] = y * w_scale[None, :]
    return out


@pytest.mark.parametrize("m,k,n,splits", [(3, 5, 7, 1), (65, 130, 67, 2),
                                          (20, 443, 40, 3), (4, 64, 16, 3),
                                          (130, 200, 140, 2)])
def test_kernel_emulation_is_bit_exact(m, k, n, splits):
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w_q = rng.integers(-128, 128, (k, n)).astype(np.int8)
    w_scale = (rng.random(n) * 1e-2 + 1e-3).astype(np.float32)
    x_scale = np.float32(np.abs(x).max() / np.float32(127))
    got = kernel(x, w_q, w_scale, x_scale, splits)
    want = quant_matmul_exact(*(torch.from_numpy(a) for a in (
        x, w_q, w_scale, np.array(x_scale))))
    assert np.array_equal(got, want.numpy())


# -- the exact reference ------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(8, 12, 5), (64, 384, 128), (3, 1280, 10)])
def test_exact_reference_equals_plain_version_below_2_24(m, k, n):
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w_q = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    w_scale = torch.from_numpy(rng.random(n).astype(np.float32))
    x_scale = x.abs().max() / 127.0
    assert torch.equal(quant_matmul_exact(x, w_q, w_scale, x_scale),
                       ref.quant_matmul(x, w_q, w_scale, x_scale))


def test_exact_reference_rounds_once_at_vgg16_depth():
    """At K = 25088 the sums pass 2^24: the exact reference rounds the
    int64 sum once (numpy), the float32 plain version more often."""
    rng = np.random.default_rng(0)
    k = 25088
    x = np.abs(rng.standard_normal((2, k))).astype(np.float32)
    w_q = rng.integers(0, 128, (k, 3)).astype(np.int8)
    w_scale = np.array([1e-3, 2e-3, 3e-3], np.float32)
    xs = np.float32(np.abs(x).max() / np.float32(127))
    codes = np.clip(np.rint(x / xs), -128, 127).astype(np.int64)
    acc = codes @ w_q.astype(np.int64)
    assert np.abs(acc).max() > 2 ** 24
    want = (acc.astype(np.float32) * xs).astype(np.float32) * w_scale
    got = quant_matmul_exact(*(torch.from_numpy(a) for a in (
        x, w_q, w_scale, np.array(xs))))
    assert np.array_equal(got.numpy(), want)
