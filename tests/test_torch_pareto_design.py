"""The design of ``csrc/pareto_rank.cu`` emulated with numpy, held against
the plain versions in ``kernels/ref.py`` bit for bit (no kernel runs here):

* the branch-free Deb test, both as the predicate formula
  ``(fp & !fq) | (!fp & !fq & cv_p < cv_q) | (fp & fq & all_le & any_lt)``
  and in the kernels' folded form (an infeasible point's first objective
  NaN, a key of -inf / violation / -FLT_MAX), on chosen bit patterns: NaN
  objectives and violations, -0.0 and +0.0, +inf padding, equal infeasible
  violations, duplicate rows, m = 1, 3 and 8 (padded to M = 3 or 8);
* the warp vote as the packed word (lane j -> bit j, bit 31 carried by the
  int32's sign);
* K1's walk (8 warps a block, R word rows a warp, columns staged per block,
  ragged rows and columns padded, one writer per word) and K2's row splits
  combined by atomic adds or by a second pass, under an alive mask.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.testing import edge_population  # noqa: E402

NAN = np.float32(np.nan)
PINF, NINF = np.float32(np.inf), np.float32(-np.inf)
NMAX = np.float32(-np.finfo(np.float32).max)
WARPS = 8


def padded_m(m):
    return 3 if m <= 3 else 8


def load_points(F, CV, column, alive=None):
    """``load_point`` of the kernel for every point: (n, M + 1) float32."""
    n, m = F.shape
    M = padded_m(m)
    X = np.zeros((n, M + 1), np.float32)
    X[:, :m] = F
    feas = CV <= 0
    X[:, 0] = np.where(feas, X[:, 0], NAN)
    X[:, M] = np.where(feas, NINF,
                       np.where(column & np.isnan(CV), NMAX, CV))
    if alive is not None:
        X[~alive] = padding(1, M, column)
    return X


def padding(k, M, column):
    X = np.zeros((k, M + 1), np.float32)
    X[:, 0] = NAN
    X[:, M] = NINF if column else PINF
    return X


def folded_dominates(P, Q):
    """(rows, cols) of the folded test: (all_le & any_lt) | key_p < key_q."""
    M = P.shape[1] - 1
    a, b = P[:, None, :M], Q[None, :, :M]
    return (((a <= b).all(-1) & (a < b).any(-1))
            | (P[:, None, M] < Q[None, :, M]))


def formula_dominates(Fp, cvp, Fq, cvq):
    """The predicate formula on the raw points, no branch."""
    a, b = Fp[:, None, :], Fq[None, :, :]
    all_le, any_lt = (a <= b).all(-1), (a < b).any(-1)
    fp, fq = (cvp <= 0)[:, None], (cvq <= 0)[None, :]
    cv_lt = cvp[:, None] < cvq[None, :]
    return (fp & ~fq) | (~fp & ~fq & cv_lt) | (fp & fq & all_le & any_lt)


def plain(Fp, cvp, Fq, cvq):
    return ref.dominates_tile(*(torch.from_numpy(x) for x in
                                (Fp, cvp, Fq, cvq))).numpy()


def ballot(dom):
    """(32, k) bools of 32 lanes -> k words as int32: bit j is lane j."""
    bits = (dom.astype(np.uint64) << np.arange(32, dtype=np.uint64)[:, None])
    return bits.sum(0).astype(np.uint32).view(np.int32)


def popcount(words):
    """``__popc`` of each int32 word's bit pattern, as int64."""
    return np.unpackbits(words.view(np.uint8).reshape(-1, 4),
                         axis=1).sum(1).astype(np.int64)


def chosen_points(m):
    """Every violation class against every other, each objective pattern
    repeated: NaN objectives, ties, duplicates."""
    cvs = np.array([0.0, -0.0, -1.0, 0.5, 0.5, 2.0, np.inf, np.nan],
                   np.float32)
    objs = np.array([[0.0] * m, [0.5] * m, [1.0] * m, [0.5] * m,
                     [np.nan] + [0.0] * (m - 1), [0.0] * (m - 1) + [np.nan],
                     [0.25 * (j % 3) for j in range(m)],
                     [-0.0] * m], np.float32)
    F = np.repeat(objs, len(cvs), axis=0)
    CV = np.tile(cvs, len(objs))
    return F, CV


# -- the pair test ----------------------------------------------------------------

@pytest.mark.parametrize("m", (1, 3, 8))
def test_branch_free_formula_and_folded_test_on_chosen_bit_patterns(m):
    F, CV = chosen_points(m)
    want = plain(F, CV, F, CV)
    assert want.any() and not want.all()
    assert np.array_equal(formula_dominates(F, CV, F, CV), want)
    got = folded_dominates(load_points(F, CV, False), load_points(F, CV, True))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("m", (1, 2, 3, 5, 8))
@pytest.mark.parametrize("infeas", (0.0, 0.3, 1.0))
def test_folded_test_on_edge_populations(m, infeas):
    F, CV = (t.numpy() for t in edge_population(97, m, infeas, seed=m))
    want = plain(F, CV, F, CV)
    got = folded_dominates(load_points(F, CV, False), load_points(F, CV, True))
    assert np.array_equal(got, want)
    assert np.array_equal(formula_dominates(F, CV, F, CV), want)


@pytest.mark.parametrize("m", (1, 3, 8))
def test_padding_rows_dominate_nothing_and_padding_columns_nothing_dominates(m):
    F, CV = chosen_points(m)
    M = padded_m(m)
    rows, cols = load_points(F, CV, False), load_points(F, CV, True)
    assert not folded_dominates(padding(4, M, False), cols).any()
    assert not folded_dominates(rows, padding(4, M, True)).any()
    # the plain version pads rows with +inf violations: the same rows
    Fp, cvp = ref._pad_rows(torch.from_numpy(F), torch.from_numpy(CV),
                            len(F) + (-len(F)) % 32 + 32)
    assert not plain(Fp.numpy()[len(F):], cvp.numpy()[len(F):], F, CV).any()


def test_dead_rows_fold_in_as_padding():
    F, CV = (t.numpy() for t in edge_population(64, 3, 0.3, seed=4))
    alive = np.random.default_rng(4).random(64) < 0.5
    got = folded_dominates(load_points(F, CV, False, alive),
                           load_points(F, CV, True))
    assert np.array_equal(got, plain(F, CV, F, CV) & alive[:, None])


# -- the vote as the packed word --------------------------------------------------

def test_ballot_is_the_packed_word_with_bit_31_in_the_sign():
    dom = np.zeros((32, 4), bool)
    dom[31, 0] = True            # bit 31 alone: the int32's sign
    dom[:, 1] = True             # every bit: -1
    dom[0, 2] = dom[5, 2] = True
    words = ballot(dom)
    assert list(words) == [np.int32(-2 ** 31), -1, 1 + 32, 0]
    want = ref._pack_rows(torch.from_numpy(dom)).numpy()[0]
    assert np.array_equal(words, want)


@pytest.mark.parametrize("m", (1, 3, 8))
def test_ballots_of_32_lanes_pack_like_the_plain_version(m):
    F, CV = chosen_points(m)          # 64 points: two words of rows
    rows, cols = load_points(F, CV, False), load_points(F, CV, True)
    words = np.stack([ballot(folded_dominates(rows[32 * w:32 * w + 32], cols))
                      for w in range(len(F) // 32)])
    want = ref.packed_domination(*(torch.from_numpy(x)
                                   for x in (F, CV, F, CV)))
    assert np.array_equal(words, want.numpy())


# -- the kernels' walks -------------------------------------------------------------

def k1_walk(F, CV, bp, bq, R):
    """packed_domination_kernel's grid, warps and stores; every word written
    exactly once."""
    n = len(F)
    r = n
    M = padded_m(F.shape[1])
    rows_all = load_points(F, CV, False)
    cols_all = load_points(F, CV, True)
    out = np.zeros(((r + 31) // 32, n), np.int32)
    writes = np.zeros(out.shape, np.int32)
    for bx in range(-(-n // bq)):
        q0 = bx * bq
        n_cols = min(bq, n - q0)
        staged = np.concatenate([cols_all[q0:q0 + n_cols],
                                 padding(bq - n_cols, M, True)])
        for by in range(-(-r // bp)):
            row0 = by * bp
            row_end = min(row0 + bp, r)
            for warp in range(WARPS):
                for base in range(row0 + warp * R * 32, row_end,
                                  WARPS * R * 32):
                    for k in range(R):
                        i = np.arange(base + 32 * k, base + 32 * k + 32)
                        lanes = np.where((i < row_end)[:, None],
                                         rows_all[np.minimum(i, r - 1)],
                                         padding(32, M, False))
                        w = base // 32 + k
                        for c0 in range(0, n_cols, 32):
                            word = ballot(folded_dominates(
                                lanes, staged[c0:c0 + 32]))
                            q = q0 + c0 + np.arange(32)
                            ok = (q < n) & (w * 32 < row_end)
                            if not ok.any():
                                continue
                            out[w, q[ok]] = word[ok]
                            writes[w, q[ok]] += 1
    assert (writes == 1).all()
    return out


def k2_walk(F, CV, alive, split_rows, cols, R, atomics, seed=0):
    """domination_counts_kernel's grid: per block the warps' popcounts
    summed per column, then the splits combined by atomic adds (in a
    shuffled order) or by a second pass over (splits, n) partials."""
    n = len(F)
    M = padded_m(F.shape[1])
    rows_all = load_points(F, CV, False, alive)
    cols_all = load_points(F, CV, True)
    splits = -(-n // split_rows)
    partial = np.full((splits, n), -1, np.int64)
    adds = []
    for bx in range(-(-n // cols)):
        q0 = bx * cols
        n_cols = min(cols, n - q0)
        staged = np.concatenate([cols_all[q0:q0 + n_cols],
                                 padding(cols - n_cols, M, True)])
        for by in range(splits):
            row0 = by * split_rows
            row_end = min(row0 + split_rows, n)
            s_count = np.zeros(cols, np.int64)
            for warp in range(WARPS):
                for base in range(row0 + warp * R * 32, row_end,
                                  WARPS * R * 32):
                    i = np.arange(base, base + 32 * R)
                    lanes = np.where((i < row_end)[:, None],
                                     rows_all[np.minimum(i, n - 1)],
                                     padding(len(i), M, False))
                    for c0 in range(0, n_cols, 32):
                        dom = folded_dominates(lanes, staged[c0:c0 + 32])
                        popc = sum(popcount(ballot(dom[32 * k:32 * k + 32]))
                                   for k in range(R))
                        q = q0 + c0 + np.arange(32)
                        s_count[c0:c0 + 32] += np.where(q < n, popc, 0)
            for c in range(n_cols):
                adds.append((q0 + c, s_count[c]))
                partial[by, q0 + c] = s_count[c]
    if atomics:
        out = np.zeros(n, np.int64)
        for j in np.random.default_rng(seed).permutation(len(adds)):
            out[adds[j][0]] += adds[j][1]
    else:
        assert (partial >= 0).all()       # one writer per partial
        out = partial.sum(0)
    return out.astype(np.int32)


@pytest.mark.parametrize("n,m,bp,bq,R", [(33, 3, 2048, 256, 4),
                                         (97, 3, 32, 32, 4),
                                         (130, 1, 64, 96, 2),
                                         (130, 8, 96, 64, 1),
                                         (300, 3, 128, 1024, 4),
                                         (1100, 3, 1024, 256, 4),
                                         (1100, 5, 2048, 128, 8)])
def test_k1_walk_matches_plain_packed_domination(n, m, bp, bq, R):
    F, CV = (t.numpy() for t in edge_population(n, m, 0.3, seed=n))
    want = ref.packed_domination(*(torch.from_numpy(x)
                                   for x in (F, CV, F, CV)))
    assert np.array_equal(k1_walk(F, CV, bp, bq, R), want.numpy())


@pytest.mark.parametrize("n,m,split_rows,cols,R", [(33, 3, 1024, 256, 4),
                                                   (97, 3, 64, 32, 2),
                                                   (130, 8, 256, 64, 4),
                                                   (1000, 3, 256, 256, 4),
                                                   (1001, 2, 1024, 96, 1)])
@pytest.mark.parametrize("atomics", (True, False))
def test_k2_splits_and_combine_match_plain_counts(n, m, split_rows, cols, R,
                                                  atomics):
    F, CV = (t.numpy() for t in edge_population(n, m, 0.3, seed=n + 1))
    alive = np.random.default_rng(n).random(n) < 0.6
    for mask in (np.ones(n, bool), alive):
        want = ref.domination_counts(torch.from_numpy(F),
                                     torch.from_numpy(CV),
                                     torch.from_numpy(mask)).numpy()
        got = k2_walk(F, CV, mask, split_rows, cols, R, atomics)
        assert np.array_equal(got, want)
