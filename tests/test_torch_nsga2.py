"""The port's NSGA-II operators (``repro_torch.core.nsga2_torch``) against
the JAX package's ``nsga2_jax``: dense and blocked ranking (exact, with
caps, ragged sizes, infeasible shares and duplicate-CV groups), crowding
(to float32 tolerance, same inf pattern), repair and the survivor lexsort
(exact), plus the loop-level properties the reference holds itself to:
blocked ranking leaves the whole run unchanged, restart i equals seed+i,
and the blocked final-front mask equals the dense one."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import nsga2_jax  # noqa: E402
from repro.core.nsga2 import _repair_batch, pareto_indices  # noqa: E402
from repro_torch.core import nsga2_torch as T  # noqa: E402

torch.set_num_threads(2)

SIZES = (33, 97, 130)
INFEAS = (0.0, 0.5, 1.0)


def population(n, m=3, infeas=0.3, dup=False, seed=0):
    rng = np.random.default_rng(seed)
    F = rng.random((n, m)).astype(np.float32)
    if dup:
        F[n // 2:] = F[rng.integers(0, n // 2, n - n // 2)]
    CV = np.where(rng.random(n) < infeas, (rng.random(n) * 3).round(1),
                  0.0).astype(np.float32)
    return F, CV


def jax_ranks(Fs, CVs, cap):
    """Reference dense ranks of a stack of same-size populations (one
    compilation for the stack)."""
    fn = jax.jit(jax.vmap(lambda f, c: nsga2_jax.nondominated_rank(
        f, c, cap=cap)))
    return np.asarray(fn(jnp.asarray(Fs), jnp.asarray(CVs)))


@pytest.mark.parametrize("n", SIZES)
def test_rank_dense_and_blocked_match_jax(n):
    pops = [population(n, infeas=p, dup=True, seed=n) for p in INFEAS]
    Fs = np.stack([f for f, _ in pops])
    CVs = np.stack([c for _, c in pops])
    for cap in (None, n // 3, n):
        want = jax_ranks(Fs, CVs, cap)
        for i, (F, CV) in enumerate(pops):
            Ft, CVt = torch.from_numpy(F), torch.from_numpy(CV)
            dense = T.nondominated_rank(Ft, CVt, cap).numpy()
            blocked = T.nondominated_rank(Ft, CVt, cap, rank_block=64,
                                          rank_impl="ref").numpy()
            assert (dense == want[i]).all(), (n, INFEAS[i], cap)
            assert (blocked == want[i]).all(), (n, INFEAS[i], cap)


def test_blocked_rank_duplicate_cv_groups():
    F = np.random.default_rng(0).random((40, 2)).astype(np.float32)
    CV = np.tile([0.0, 0.5, 0.5, 1.5], 10).astype(np.float32)
    want = np.asarray(nsga2_jax.nondominated_rank(jnp.asarray(F),
                                                  jnp.asarray(CV)))
    got = T.nondominated_rank(torch.from_numpy(F), torch.from_numpy(CV),
                              rank_block=32).numpy()
    assert (got == want).all()


def test_crowding_matches_jax():
    rng = np.random.default_rng(7)
    n = 300
    F = rng.random((n, 3)).astype(np.float32)
    F[100:150] = F[:50]                       # ties inside groups
    CV = np.where(rng.random(n) < 0.3, rng.random(n), 0.0).astype(np.float32)
    rank = np.asarray(nsga2_jax.nondominated_rank(jnp.asarray(F),
                                                  jnp.asarray(CV)))
    want = np.asarray(nsga2_jax.crowding_by_rank(jnp.asarray(F),
                                                 jnp.asarray(rank)))
    got = T.crowding_by_rank(torch.from_numpy(F),
                             torch.from_numpy(rank.astype(np.int64))).numpy()
    finite = np.isfinite(want)
    assert (np.isfinite(got) == finite).all()
    np.testing.assert_allclose(got[finite], want[finite], atol=1e-5)


def test_survivor_lexsort_with_ties_matches_jax():
    rng = np.random.default_rng(3)
    n, k = 200, 90
    rank = rng.integers(0, 6, n)
    crowd = rng.choice(np.array([0.0, 0.25, 1.0, np.inf], np.float32), n)
    want = np.asarray(jnp.lexsort((-jnp.asarray(crowd),
                                   jnp.asarray(rank))))[:k]
    got = T.survivors(torch.from_numpy(rank), torch.from_numpy(crowd),
                      k).numpy()
    assert (got == want).all()


def test_repair_matches_jax_and_numpy():
    rng = np.random.default_rng(2)
    X = rng.integers(-5, 40, size=(64, 4))
    want = _repair_batch(X.copy(), 0, 30)
    ref = np.asarray(nsga2_jax.repair(jnp.asarray(X, jnp.int32), 0, 30))
    got = T.repair(torch.from_numpy(X), 0, 30).numpy()
    assert (got == want).all() and (got == ref).all()


def test_pack_bits_matches_jax():
    B = np.random.default_rng(1).random((70, 9)) < 0.5
    want = np.asarray(nsga2_jax._pack_bits(jnp.asarray(B)))
    got = T._pack_bits(torch.from_numpy(B)).numpy().view(np.uint32)
    assert (got == want).all()


# -- the generation loop ------------------------------------------------------

def toy_eval(X):
    f1 = X.sum(dim=1).to(torch.float32)
    f2 = ((X - 20) ** 2).sum(dim=1).to(torch.float32)
    cv = torch.clamp(15.0 - X[:, 0].to(torch.float32), min=0.0)
    return torch.stack([f1, f2], dim=1), cv


def test_blocked_run_equals_dense_run():
    args = dict(n_var=3, lower=0, upper=40, pop_size=48, n_gen=8, seed=3,
                device="cpu")
    dense = T.torch_nsga2(toy_eval, rank_block=0, **args)
    blocked = T.torch_nsga2(toy_eval, rank_block=64, **args)
    for a, b in zip(dense, blocked):
        assert (a == b).all()


def test_restart_i_equals_seed_plus_i():
    R, pop, n_gen, seed = 3, 48, 6, 7
    cands = [[1, 2, 3], [4, 5, 6]]
    Xr, Fr, CVr = T.torch_nsga2_restarts(toy_eval, 3, 0, 40, pop, n_gen, R,
                                         seed=seed, candidates=cands,
                                         device="cpu")
    assert Xr.shape == (R * pop, 3)
    for i in range(R):
        Xi, Fi, CVi = T.torch_nsga2(toy_eval, 3, 0, 40, pop, n_gen,
                                    seed=seed + i, candidates=cands,
                                    device="cpu")
        sl = slice(i * pop, (i + 1) * pop)
        assert (Xr[sl] == Xi).all()
        assert (Fr[sl] == Fi).all()
        assert (CVr[sl] == CVi).all()


def test_initial_population_is_the_reference_draw():
    rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
    cands = [[1, 2, 3], [4, 5, 6], [0, 9, 9]]
    assert (T._init_population(rng_a, 32, 3, 0, 40, cands)
            == nsga2_jax._init_population(rng_b, 32, 3, 0, 40, cands)).all()
    warm = np.array([[3, 5, 7], [1, 1, 2]])
    assert (T.warm_population(np.random.default_rng(5), 32, 3, 0, 40, warm)
            == nsga2_jax.warm_population(np.random.default_rng(5), 32, 3, 0,
                                         40, warm)).all()


def test_pareto_indices_blocked_matches_dense():
    rng = np.random.default_rng(4)
    X = rng.integers(0, 6, size=(200, 3))
    F = rng.random((200, 2))
    F[50:100] = F[:50]                       # duplicate decision ties
    CV = np.where(rng.random(200) < 0.4, rng.random(200), 0.0)
    want = pareto_indices(X, F, CV)
    got = T.pareto_indices_blocked(X, F, CV, block=64, device="cpu")
    assert (got == want).all()
