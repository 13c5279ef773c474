"""Tensor NSGA-II operators and the generation loop on a device.

Twins of the NumPy operators in ``repro_torch.core.nsga2``: non-dominated
ranking, crowding, binary tournaments, crossover, mutation, repair and the
batched metric evaluation all run as fixed-shape tensor code over the whole
population, on the device the population lives on (:func:`torch_nsga2`).

Differences from the NumPy implementation, by construction:

* randomness comes from one ``torch.Generator`` on the search device, drawn
  in a fixed order (different stream than ``np.random.default_rng``), so
  runs are seeded and reproducible but not identical to the NumPy search —
  equivalence is at the Pareto-front level (tested);
* front peeling stops once ``pop_size`` individuals are ranked (the only
  ranks environmental selection can consume); the tail keeps rank ``n``;
* crowding is computed per rank group over the combined parent+offspring
  population and carried into the next generation's tournaments instead of
  being recomputed on the survivors.

The loops over fronts and generations are Python loops; each peeled front
reads one count back to the host to decide whether to go on.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor
EvalFn = Callable[..., Tuple[Tensor, Tensor]]


# -- domination / ranking / crowding --------------------------------------------

def constrained_dominates(Fa: Tensor, cva: Tensor,
                          Fb: Tensor, cvb: Tensor) -> Tensor:
    """Broadcasting Deb constraint-domination (twin of the NumPy version)."""
    feas_a, feas_b = cva <= 0, cvb <= 0
    dom = (Fa <= Fb).all(dim=-1) & (Fa < Fb).any(dim=-1)
    return torch.where(feas_a & ~feas_b, True,
                       torch.where(feas_b & ~feas_a, False,
                                   torch.where(~feas_a & ~feas_b, cva < cvb,
                                               dom)))


def domination_matrix(F: Tensor, CV: Tensor) -> Tensor:
    """D[p, q] = p constraint-dominates q, diagonal cleared."""
    n = F.shape[0]
    D = constrained_dominates(F[:, None, :], CV[:, None],
                              F[None, :, :], CV[None, :])
    return D & ~torch.eye(n, dtype=torch.bool, device=F.device)


def _pack_bits(B: Tensor) -> Tensor:
    """Pack a boolean (n, m) matrix into (ceil(n/32), m) int32 words along
    axis 0, carrying the uint32 bit pattern (bit j of word w, column q =
    B[32w + j, q])."""
    n, m = B.shape
    pad = (-n) % 32
    if pad:
        B = torch.cat([B, B.new_zeros((pad, m))])
    W = B.reshape(-1, 32, m).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=B.device) << torch.arange(
        32, dtype=torch.int64, device=B.device)
    words = (W * weights[None, :, None]).sum(dim=1)        # in [0, 2**32)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def popcount32(x: Tensor) -> Tensor:
    """Set bits of each int32 word (its uint32 bit pattern), as int32.

    SWAR count on the low 31 bits — non-negative, so no shift drags the
    sign bit in and no sum overflows — plus the sign bit counted apart.
    """
    y = x & 0x7FFFFFFF
    y = y - ((y >> 1) & 0x55555555)
    y = (y & 0x33333333) + ((y >> 2) & 0x33333333)
    y = (y + (y >> 4)) & 0x0F0F0F0F
    y = y + (y >> 8)
    y = (y + (y >> 16)) & 0x3F
    return y + (x < 0).to(torch.int32)


def _peel(Dp: Tensor, alive: Tensor, cap: int) -> Tuple[Tensor, int, int]:
    """Peel fronts off the packed domination words ``Dp`` among the
    ``alive`` individuals until at least ``cap`` are ranked or none are
    left; returns (rank, number of fronts, number ranked).  Unranked
    individuals keep rank n."""
    n = alive.shape[0]
    rank = torch.full((n,), n, dtype=torch.int64, device=alive.device)
    n_alive = int(alive.sum())
    r = done = 0
    while n_alive and done < cap:
        alive_p = _pack_bits(alive[:, None])[:, 0]
        n_dom = popcount32(Dp & alive_p[:, None]).sum(dim=0)
        front = alive & (n_dom == 0)
        k = int(front.sum())                  # the one host sync per front
        if k == 0:                            # numerical safety
            front, k = alive, n_alive
        rank = torch.where(front, r, rank)
        alive = alive & ~front
        n_alive -= k
        done += k
        r += 1
    return rank, r, done


def nondominated_rank(F: Tensor, CV: Tensor,
                      cap: Optional[int] = None, *,
                      rank_block: Optional[int] = None,
                      rank_impl: str = "auto") -> Tensor:
    """Front index per individual (0 = first front), peeled until at least
    ``cap`` individuals are ranked (default: all).  The unpeeled tail keeps
    rank ``n`` — environmental selection never reaches it.

    With ``rank_block`` unset/0 the dense path runs: the full domination
    matrix is built in one broadcast, bit-packed (32 individuals per word),
    and each peel step counts surviving dominators with a popcount over a
    (n/32, n) word matrix.

    ``rank_block > 0`` switches to the tiled primitive
    (``repro_torch.kernels.ops.packed_domination``): the packed words are
    built (rank_block, n)-tile by tile so the dense (n, n[, m]) booleans
    never exist, and only *feasible* Pareto layers are peeled — Deb
    domination totally orders infeasible individuals by violation, so their
    ranks (the equal-CV groups, appended after the feasible layers) come in
    closed form.  Ranks are bit-identical to the dense path.
    """
    n = F.shape[0]
    cap = n if cap is None else min(cap, n)
    if rank_block:
        return _rank_blocked(F, CV, cap, rank_block, rank_impl)
    Dp = _pack_bits(domination_matrix(F, CV))
    return _peel(Dp, torch.ones(n, dtype=torch.bool, device=F.device), cap)[0]


def _rank_blocked(F: Tensor, CV: Tensor, cap: int, block: int,
                  impl: str) -> Tensor:
    """Tiled non-dominated ranking; see :func:`nondominated_rank`."""
    from repro_torch.kernels import ops
    n = F.shape[0]
    dev = F.device
    Dp = ops.packed_domination(F, CV, block=block, impl=impl)
    feas = CV <= 0
    rank, n_feas_fronts, done = _peel(Dp, feas, cap)
    # infeasible tail: every feasible individual dominates every infeasible
    # one and infeasible pairs compare by violation alone, so the remaining
    # fronts are the equal-CV groups in ascending order.  A group is peeled
    # iff the count ranked before it is still under the cap — exactly the
    # dense loop's stopping rule.
    cvs = torch.where(feas, float("inf"), CV)
    order = torch.argsort(cvs, stable=True)
    scv = cvs[order]
    new_grp = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                         scv[1:] != scv[:-1]])
    grp_sorted = torch.cumsum(new_grp.to(torch.int64), dim=0)
    grp = torch.empty(n, dtype=torch.int64, device=dev)
    grp[order] = grp_sorted
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    first_idx = torch.zeros(n, dtype=torch.int64, device=dev).scatter_reduce(
        0, grp_sorted, pos, "amin", include_self=False)
    before = done + first_idx[grp]              # ranked before my group
    include = ~feas & (before < cap)
    return torch.where(include, n_feas_fronts + grp, rank)


def crowding_by_rank(F: Tensor, rank: Tensor) -> Tensor:
    """Crowding distance within each rank group (twin of
    ``crowding_distance`` applied per front, without materializing fronts).

    Per objective: sort by (rank, value); interior points accumulate the
    neighbour gap normalized by their group's value span (segment min/max),
    group boundaries get ``inf`` — exactly the NumPy accounting.
    """
    n, m = F.shape
    dev = F.device
    crowd = torch.zeros(n, dtype=F.dtype, device=dev)
    false1 = torch.zeros(1, dtype=torch.bool, device=dev)
    for j in range(m):
        f = F[:, j]
        # lexsort by (rank, f): stable sort by f, then stable sort by rank
        by_f = torch.argsort(f, stable=True)
        order = by_f[torch.argsort(rank[by_f], stable=True)]
        sr, sf = rank[order], f[order]
        seg_max = f.new_zeros(n + 1).scatter_reduce(
            0, rank, f, "amax", include_self=False)
        seg_min = f.new_zeros(n + 1).scatter_reduce(
            0, rank, f, "amin", include_self=False)
        span = (seg_max - seg_min)[sr]
        same = sr[1:] == sr[:-1]
        interior = torch.cat([false1, same]) & torch.cat([same, false1])
        gap = torch.cat([sf[1:], sf[-1:]]) - torch.cat([sf[:1], sf[:-1]])
        contrib = torch.where(
            interior,
            torch.where(span > 0, gap / torch.where(span > 0, span, 1.0), 0.0),
            float("inf"))
        crowd.index_add_(0, order, contrib)
    return crowd


def survivors(rank: Tensor, crowd: Tensor, k: int) -> Tensor:
    """Indices of the ``k`` individuals environmental selection keeps:
    whole fronts in rank order, the boundary front tie-broken by crowding
    (largest first), remaining ties by index — a lexsort by
    (rank, -crowd)."""
    by_crowd = torch.argsort(-crowd, stable=True)
    return by_crowd[torch.argsort(rank[by_crowd], stable=True)][:k]


# -- GA operators ---------------------------------------------------------------

def tournament(gen: torch.Generator, F: Tensor, CV: Tensor, crowd: Tensor,
               n: int) -> Tensor:
    """n independent binary tournaments → winner indices."""
    N, dev = F.shape[0], F.device
    a = torch.randint(0, N, (n,), generator=gen, device=dev)
    b = torch.randint(0, N, (n,), generator=gen, device=dev)
    a_dom = constrained_dominates(F[a], CV[a], F[b], CV[b])
    b_dom = constrained_dominates(F[b], CV[b], F[a], CV[a])
    return torch.where(a_dom | (~b_dom & (crowd[a] >= crowd[b])), a, b)


def repair(X: Tensor, lo: int, hi: int) -> Tensor:
    """Clip/sort/de-duplicate cut vectors — twin of ``_repair_batch`` (the
    scans run over the short n_var axis)."""
    X = torch.clamp(torch.sort(X, dim=1).values, lo, hi)
    n_var = X.shape[1]
    for i in range(1, n_var):
        X[:, i] = torch.where(X[:, i] <= X[:, i - 1],
                              torch.clamp(X[:, i - 1] + 1, max=hi), X[:, i])
    for i in range(n_var - 2, -1, -1):     # if saturated at hi, push left
        X[:, i] = torch.where(X[:, i] >= X[:, i + 1],
                              torch.clamp(X[:, i + 1] - 1, min=lo), X[:, i])
    return X


def make_offspring(gen: torch.Generator, X: Tensor, F: Tensor, CV: Tensor,
                   crowd: Tensor, lo: int, hi: int) -> Tensor:
    """Tournaments → uniform crossover → blend step → reset/local-step
    mutation → repair, mirroring the NumPy brood construction.  Draws
    from ``gen`` in a fixed order: both tournaments, the crossover mask,
    the blend coin, the blend coordinate, the mutation coin, the reset
    values, the step values."""
    pop, n_var = X.shape
    dev = X.device
    half = (pop + 1) // 2
    P1 = X[tournament(gen, F, CV, crowd, half)]
    P2 = X[tournament(gen, F, CV, crowd, half)]
    mask = torch.rand((half, n_var), generator=gen, device=dev) < 0.5
    Xc = torch.cat([torch.where(mask, P1, P2),
                    torch.where(mask, P2, P1)])[:pop]
    if n_var > 0:
        par1 = torch.cat([P1, P1])[:pop]
        par2 = torch.cat([P2, P2])[:pop]
        blend = torch.rand(pop, generator=gen, device=dev) < 0.3
        j = torch.randint(0, n_var, (pop,), generator=gen, device=dev)
        rows = torch.arange(pop, device=dev)
        mid = (par1[rows, j] + par2[rows, j]) // 2
        Xc[rows, j] = torch.where(blend, mid, Xc[rows, j])
    nv = max(n_var, 1)
    r = torch.rand((pop, n_var), generator=gen, device=dev)
    reset = r < 0.5 / nv
    step = ~reset & (r < 2.0 / nv)
    Xc = torch.where(reset, torch.randint(lo, hi + 1, Xc.shape, generator=gen,
                                          device=dev), Xc)
    Xc = torch.where(step, Xc + torch.randint(-3, 4, Xc.shape, generator=gen,
                                              device=dev), Xc)
    return repair(Xc, lo, hi)


# -- the generation loop ----------------------------------------------------------

# auto rank_block policy: combined (2·pop) populations at/below the
# threshold keep the dense packed path (fastest there, memory irrelevant);
# beyond it the tiled path runs with the default tile rows
_AUTO_DENSE_MAX = 4096
_AUTO_RANK_BLOCK = 2048


def _resolve_rank_block(rank_block: Optional[int], pop_size: int) -> int:
    """None → auto (dense ≤ ``_AUTO_DENSE_MAX`` combined, else 2048-row
    tiles); 0 forces dense; a positive int is the tile row count."""
    if rank_block is None:
        return 0 if 2 * pop_size <= _AUTO_DENSE_MAX else _AUTO_RANK_BLOCK
    return rank_block


def _run(eval_fn: EvalFn, gen: torch.Generator, X0: Tensor, n_gen: int,
         lo: int, hi: int, pop_size: int, rank_block: int, rank_impl: str,
         eval_args: Tuple) -> Tuple[Tensor, Tensor, Tensor]:
    """The whole search on X0's device; ``eval_args`` are forwarded to
    every ``eval_fn(X, *eval_args)`` call."""
    def rank_of(F, CV, cap=None):
        return nondominated_rank(F, CV, cap, rank_block=rank_block,
                                 rank_impl=rank_impl)

    X = repair(X0, lo, hi)
    F, CV = eval_fn(X, *eval_args)
    crowd = crowding_by_rank(F, rank_of(F, CV))
    for _ in range(n_gen):
        Xc = make_offspring(gen, X, F, CV, crowd, lo, hi)
        Fc, CVc = eval_fn(Xc, *eval_args)
        Xall = torch.cat([X, Xc])
        Fall = torch.cat([F, Fc])
        CVall = torch.cat([CV, CVc])
        # elitist environmental selection: whole fronts in rank order, the
        # boundary front tie-broken by crowding
        rank = rank_of(Fall, CVall, pop_size)
        crowd_all = crowding_by_rank(Fall, rank)
        keep = survivors(rank, crowd_all, pop_size)
        X, F, CV, crowd = Xall[keep], Fall[keep], CVall[keep], crowd_all[keep]
    return X, F, CV


def _init_population(rng: np.random.Generator, pop_size: int, n_var: int,
                     lower: int, upper: int,
                     candidates: Optional[Sequence[Sequence[int]]]
                     ) -> np.ndarray:
    """Host-side population init — matches the NumPy
    :func:`repro_torch.core.nsga2.nsga2` draw-for-draw."""
    X0 = rng.integers(lower, upper + 1, size=(pop_size, n_var))
    if candidates is not None and len(candidates):
        cand = np.asarray(list(candidates), dtype=int)
        k = min(len(cand), pop_size // 2)
        X0[:k] = cand[rng.permutation(len(cand))[:k]]
    return X0


def warm_population(rng: np.random.Generator, pop_size: int, n_var: int,
                    lower: int, upper: int,
                    warm: Optional[np.ndarray]) -> np.ndarray:
    """Host-side warm-started population: previous-front rows verbatim,
    then jitter-mutated copies, then a random tail.

    Layout (all counts deterministic given ``pop_size`` and ``len(warm)``):

    * up to ``pop_size // 2`` rows are ``warm`` rows copied verbatim — the
      elites the re-search refines;
    * up to ``pop_size // 4`` rows are elites plus a small integer jitter
      (uniform in [-2, 2] per gene, clipped to bounds) — local exploration
      around the previous optimum, where a drifted system's new optimum
      usually lives;
    * the remainder is uniform random in [lower, upper] — global escape
      hatch so a warm start can never trap the search.

    An empty (or ``None``) ``warm`` degenerates to the cold uniform init.
    """
    if warm is None:
        warm = np.empty((0, n_var), dtype=int)
    warm = np.asarray(warm, dtype=int).reshape(-1, n_var)
    if len(warm) == 0:
        return rng.integers(lower, upper + 1, size=(pop_size, n_var))
    n_elite = min(len(warm), max(pop_size // 2, 1))
    elite = np.clip(warm[:n_elite], lower, upper)
    n_jit = min(pop_size - n_elite, pop_size // 4)
    base = elite[rng.integers(0, n_elite, size=n_jit)]
    jittered = np.clip(base + rng.integers(-2, 3, size=base.shape),
                       lower, upper)
    n_rand = pop_size - n_elite - n_jit
    rand = rng.integers(lower, upper + 1, size=(n_rand, n_var))
    return np.concatenate([elite, jittered, rand])[:pop_size]


def torch_nsga2(eval_fn: EvalFn, n_var: int, lower: int, upper: int,
                pop_size: int, n_gen: int, seed: int = 0,
                candidates: Optional[Sequence[Sequence[int]]] = None,
                X0: Optional[np.ndarray] = None, eval_args: Tuple = (),
                rank_block: Optional[int] = None, rank_impl: str = "auto",
                device="cuda") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run the NSGA-II loop on ``device``; returns host (X, F, CV) arrays.

    Population init (including ``candidates`` seeding) matches the NumPy
    :func:`repro_torch.core.nsga2.nsga2` exactly and stays host-side;
    everything after the first transfer runs on the device.  Pass an
    explicit ``X0`` (pop_size, n_var) to override the uniform init (warm
    starts — see :func:`warm_population`) and ``eval_args`` to forward
    runtime table values to ``eval_fn(X, *eval_args)``.
    ``rank_block``/``rank_impl`` select the ranking primitive (see
    :func:`nondominated_rank`): the auto policy keeps the dense packed
    matrix for combined populations ≤ 4096 and tiles beyond.
    """
    if X0 is None:
        X0 = _init_population(np.random.default_rng(seed), pop_size, n_var,
                              lower, upper, candidates)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    X, F, CV = _run(eval_fn, gen,
                    torch.as_tensor(np.asarray(X0), dtype=torch.int64,
                                    device=device),
                    n_gen, lower, upper, pop_size,
                    _resolve_rank_block(rank_block, pop_size), rank_impl,
                    eval_args)
    return (X.cpu().numpy().astype(np.int64),
            F.cpu().numpy().astype(np.float64),
            CV.cpu().numpy().astype(np.float64))


def torch_nsga2_restarts(eval_fn: EvalFn, n_var: int, lower: int, upper: int,
                         pop_size: int, n_gen: int, n_restarts: int,
                         seed: int = 0,
                         candidates: Optional[Sequence[Sequence[int]]] = None,
                         X0s: Optional[np.ndarray] = None,
                         eval_args: Tuple = (),
                         rank_block: Optional[int] = None,
                         rank_impl: str = "auto", device="cuda"
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Multi-restart search: ``n_restarts`` independently seeded runs, one
    after the other.

    Restart ``i`` reproduces ``torch_nsga2(..., seed=seed + i)`` bit for bit
    (same host init stream, same generator seed), so the merged output's
    non-dominated front equals the union of the per-seed fronts after one
    final non-dominated filter.  Returns host (X, F, CV) with the restarts
    stacked into ``n_restarts * pop_size`` rows.  ``X0s`` overrides the
    per-restart init (shape (n_restarts, pop_size, n_var)).
    """
    outs = [torch_nsga2(eval_fn, n_var, lower, upper, pop_size, n_gen,
                        seed=seed + i, candidates=candidates,
                        X0=None if X0s is None else X0s[i],
                        eval_args=eval_args, rank_block=rank_block,
                        rank_impl=rank_impl, device=device)
            for i in range(n_restarts)]
    return tuple(np.concatenate(parts) for parts in zip(*outs))


def pareto_indices_blocked(X: np.ndarray, F: np.ndarray, CV: np.ndarray,
                           block: int = 2048, impl: str = "auto",
                           device="cuda") -> np.ndarray:
    """Memory-bounded twin of :func:`repro_torch.core.nsga2.pareto_indices`:
    the first-front mask comes from the tiled dominator-count primitive on
    ``device`` instead of the dense host-side sort, then the same
    feasible-subset / unique-decision-vector selection applies."""
    from repro_torch.kernels import ops
    counts = ops.domination_counts(
        torch.as_tensor(F, dtype=torch.float32, device=device),
        torch.as_tensor(CV, dtype=torch.float32, device=device),
        block=block, impl=impl).cpu().numpy()
    first = np.flatnonzero(counts == 0)
    if not len(first):                    # numerical safety, as in the dense
        first = np.arange(len(F))
    feas = first[CV[first] <= 0]
    pareto = feas if len(feas) else first
    _, uniq = np.unique(X[pareto], axis=0, return_index=True)
    return pareto[np.sort(uniq)]
