"""NSGA-II for the partition-point search (§IV, [14] pymoo replacement).

Decision variables are integer vectors (sorted cut positions). Implements:
fast non-dominated sorting, crowding distance, constrained-domination binary
tournament, uniform + blend integer crossover, reset mutation, elitism.

All objectives are minimized.  Constraints are "violation amounts":
``g_i(x) <= 0`` feasible; total violation = Σ max(0, g_i).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


# -- non-dominated sorting ----------------------------------------------------

def dominates(f: np.ndarray, g: np.ndarray) -> bool:
    """True iff f Pareto-dominates g (minimization)."""
    return bool(np.all(f <= g) and np.any(f < g))


def constrained_dominates(f: np.ndarray, cv_f: float,
                          g: np.ndarray, cv_g: float) -> bool:
    """Deb's constraint-domination."""
    if cv_f <= 0 < cv_g:
        return True
    if cv_g <= 0 < cv_f:
        return False
    if cv_f > 0 and cv_g > 0:
        return cv_f < cv_g
    return dominates(f, g)


def _constrained_dominates_vec(Fa: np.ndarray, cva: np.ndarray,
                               Fb: np.ndarray, cvb: np.ndarray) -> np.ndarray:
    """Row-wise Deb constraint-domination: does a[i] dominate b[i]?"""
    feas_a, feas_b = cva <= 0, cvb <= 0
    dom = np.all(Fa <= Fb, axis=-1) & np.any(Fa < Fb, axis=-1)
    return np.where(feas_a & ~feas_b, True,
                    np.where(feas_b & ~feas_a, False,
                             np.where(~feas_a & ~feas_b, cva < cvb, dom)))


def _domination_matrix(F: np.ndarray, CV: np.ndarray) -> np.ndarray:
    """D[p, q] = p constraint-dominates q, for the whole population."""
    D = _constrained_dominates_vec(F[:, None, :], CV[:, None],
                                   F[None, :, :], CV[None, :])
    np.fill_diagonal(D, False)
    return D


def dominates_matrix(Fa: np.ndarray, CVa: np.ndarray,
                     Fb: np.ndarray, CVb: np.ndarray) -> np.ndarray:
    """(len(a), len(b)) matrix of constrained domination a[i] ≻ b[j]."""
    return _constrained_dominates_vec(
        np.asarray(Fa, dtype=float)[:, None, :],
        np.asarray(CVa, dtype=float)[:, None],
        np.asarray(Fb, dtype=float)[None, :, :],
        np.asarray(CVb, dtype=float)[None, :])


def non_dominated_mask(F: np.ndarray,
                       CV: Optional[np.ndarray] = None) -> np.ndarray:
    """Boolean mask of the first (constrained) non-dominated front only.

    One broadcast domination matrix, no front peeling — the cheap primitive
    for streaming archives that never need ranks beyond the first front.
    """
    F = np.asarray(F, dtype=float)
    n = len(F)
    if n == 0:
        return np.zeros(0, dtype=bool)
    if CV is None:
        CV = np.zeros(n)
    D = _domination_matrix(F, np.asarray(CV, dtype=float))
    return D.sum(axis=0) == 0


def fast_non_dominated_sort(F: np.ndarray,
                            CV: Optional[np.ndarray] = None) -> List[np.ndarray]:
    """Return fronts (lists of indices), best front first.

    Builds the full pairwise domination matrix with one broadcast compare
    and peels fronts by domination count — no Python-level pair loop.
    """
    F = np.asarray(F, dtype=float)
    n = len(F)
    if CV is None:
        CV = np.zeros(n)
    D = _domination_matrix(F, np.asarray(CV, dtype=float))
    n_dom = D.sum(axis=0)          # how many dominate each q
    assigned = np.zeros(n, dtype=bool)
    fronts: List[np.ndarray] = []
    while not assigned.all():
        front = np.flatnonzero((n_dom == 0) & ~assigned)
        if not len(front):         # numerical safety: cannot happen for a DAG
            front = np.flatnonzero(~assigned)
        assigned[front] = True
        n_dom = n_dom - D[front].sum(axis=0)
        fronts.append(front)
    return fronts


def crowding_distance(F: np.ndarray) -> np.ndarray:
    """Crowding distance of points in one front."""
    n, m = F.shape
    if n <= 2:
        return np.full(n, np.inf)
    d = np.zeros(n)
    for j in range(m):
        idx = np.argsort(F[:, j], kind="stable")
        fmin, fmax = F[idx[0], j], F[idx[-1], j]
        d[idx[0]] = d[idx[-1]] = np.inf
        if fmax - fmin <= 0:
            continue
        d[idx[1:-1]] += (F[idx[2:], j] - F[idx[:-2], j]) / (fmax - fmin)
    return d


# -- GA machinery -------------------------------------------------------------

@dataclasses.dataclass
class NSGA2Result:
    X: np.ndarray            # population decision vectors
    F: np.ndarray            # objectives
    CV: np.ndarray           # constraint violations
    pareto_idx: np.ndarray   # indices of the final first front (feasible)
    history: List[dict]

    @property
    def pareto_X(self) -> np.ndarray:
        return self.X[self.pareto_idx]

    @property
    def pareto_F(self) -> np.ndarray:
        return self.F[self.pareto_idx]


def _tournament_batch(rng, F, CV, crowd, n: int) -> np.ndarray:
    """n independent binary tournaments, returned as winner indices."""
    a = rng.integers(0, len(F), size=n)
    b = rng.integers(0, len(F), size=n)
    a_dom = _constrained_dominates_vec(F[a], CV[a], F[b], CV[b])
    b_dom = _constrained_dominates_vec(F[b], CV[b], F[a], CV[a])
    pick_a = a_dom | (~b_dom & (crowd[a] >= crowd[b]))
    return np.where(pick_a, a, b)


def _repair_batch(X: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Clip to bounds, sort, and de-duplicate cut vectors (strictly
    increasing positions) for a whole (N, n_var) population — the scans run
    over the short n_var axis, the work per step is vectorized over N."""
    X = np.clip(np.sort(X, axis=1), lo, hi)
    n_var = X.shape[1]
    for i in range(1, n_var):
        X[:, i] = np.where(X[:, i] <= X[:, i - 1],
                           np.minimum(hi, X[:, i - 1] + 1), X[:, i])
    for i in range(n_var - 2, -1, -1):   # if saturated at hi, push left
        X[:, i] = np.where(X[:, i] >= X[:, i + 1],
                           np.maximum(lo, X[:, i + 1] - 1), X[:, i])
    return X


def _repair(x: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Single-vector convenience wrapper around :func:`_repair_batch`."""
    return _repair_batch(np.asarray(x)[None, :], lo, hi)[0]


def nsga2(evaluate: Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]],
          n_var: int, lower: int, upper: int,
          pop_size: Optional[int] = None, n_gen: Optional[int] = None,
          seed: int = 0, candidates: Optional[Sequence[Sequence[int]]] = None,
          ) -> NSGA2Result:
    """Run NSGA-II over integer cut vectors in [lower, upper]^n_var.

    ``evaluate`` is *batch-eval-aware*: it always receives the whole
    population as one (pop, n_var) matrix and must return (F, CV) — an
    objectives matrix (pop, n_obj) and a violation vector (pop,).  Pair it
    with ``PartitionEvaluator.evaluate_batch`` so a generation costs one
    vectorized evaluation instead of pop_size Python calls.  ``candidates``
    optionally seeds the population (e.g. the feasible-filtered cut list
    from the explorer).

    The paper sizes population/generations by layer count; we mirror that:
    pop = clip(4·L_range^0.5, 16, 96) rounded to 4, gens = clip(L/2, 10, 60).
    """
    rng = np.random.default_rng(seed)
    span = upper - lower + 1
    if pop_size is None:
        pop_size = int(np.clip(4 * np.sqrt(span * n_var), 16, 96)) // 4 * 4
    if n_gen is None:
        n_gen = int(np.clip(span // 2, 10, 60))

    # init population
    X = rng.integers(lower, upper + 1, size=(pop_size, n_var))
    if candidates is not None and len(candidates):
        cand = np.asarray(list(candidates), dtype=int)
        k = min(len(cand), pop_size // 2)
        X[:k] = cand[rng.permutation(len(cand))[:k]]
    X = _repair_batch(X, lower, upper)
    F, CV = evaluate(X)
    history: List[dict] = []
    nv = max(n_var, 1)

    for gen in range(n_gen):
        fronts = fast_non_dominated_sort(F, CV)
        crowd = np.zeros(len(F))
        for fr in fronts:
            crowd[fr] = crowding_distance(F[fr])
        # offspring: vectorized tournaments, uniform crossover, blend step
        # and reset/local-step mutation for the whole brood at once
        half = (pop_size + 1) // 2
        P1 = X[_tournament_batch(rng, F, CV, crowd, half)]
        P2 = X[_tournament_batch(rng, F, CV, crowd, half)]
        mask = rng.random((half, n_var)) < 0.5
        Xc = np.concatenate([np.where(mask, P1, P2),
                             np.where(mask, P2, P1)])[:pop_size]
        par1 = np.concatenate([P1, P1])[:pop_size]
        par2 = np.concatenate([P2, P2])[:pop_size]
        if n_var > 0:
            # blend step: move a coordinate toward the midpoint sometimes
            blend = rng.random(pop_size) < 0.3
            j = rng.integers(n_var, size=pop_size)
            rows = np.arange(pop_size)
            mid = (par1[rows, j] + par2[rows, j]) // 2
            Xc[rows[blend], j[blend]] = mid[blend]
        # mutation: random reset or +-local step
        r = rng.random((pop_size, n_var))
        reset = r < 0.5 / nv
        step = ~reset & (r < 2.0 / nv)
        Xc = np.where(reset,
                      rng.integers(lower, upper + 1, size=Xc.shape), Xc)
        Xc = np.where(step, Xc + rng.integers(-3, 4, size=Xc.shape), Xc)
        Xc = _repair_batch(Xc, lower, upper)
        Fc, CVc = evaluate(Xc)
        # elitist environmental selection
        Xall = np.concatenate([X, Xc])
        Fall = np.concatenate([F, Fc])
        CVall = np.concatenate([CV, CVc])
        fronts = fast_non_dominated_sort(Fall, CVall)
        keep: List[int] = []
        for fr in fronts:
            if len(keep) + len(fr) <= pop_size:
                keep.extend(fr.tolist())
            else:
                cd = crowding_distance(Fall[fr])
                order = np.argsort(-cd, kind="stable")
                keep.extend(fr[order[: pop_size - len(keep)]].tolist())
                break
        keep_arr = np.asarray(keep)
        X, F, CV = Xall[keep_arr], Fall[keep_arr], CVall[keep_arr]
        history.append({"gen": gen,
                        "best": F.min(axis=0).tolist(),
                        "feasible": int((CV <= 0).sum())})

    return NSGA2Result(X=X, F=F, CV=CV, pareto_idx=pareto_indices(X, F, CV),
                       history=history)


def pareto_indices(X: np.ndarray, F: np.ndarray, CV: np.ndarray) -> np.ndarray:
    """Final-front extraction shared by the NumPy and JIT search paths:
    first constrained front, feasible subset when non-empty, unique decision
    vectors (first occurrence wins, ascending index order)."""
    fronts = fast_non_dominated_sort(F, CV)
    first = fronts[0]
    feas = first[CV[first] <= 0]
    pareto = feas if len(feas) else first
    _, uniq = np.unique(X[pareto], axis=0, return_index=True)
    return pareto[np.sort(uniq)]
