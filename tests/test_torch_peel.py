"""The peel of a ranking: ``kernels.ops.peel_fronts``, its plain loop
(``kernels.ref.peel_fronts``) and the peel kernel (``peel_fronts_kernel``
in ``kernels/csrc/pareto_rank.cu``).

On the CPU: the plain loop against the loop as ``nsga2_torch._peel`` ran
it before it moved (:func:`frozen_peel`), over edge populations at m = 1,
3 and 8, caps, alive masks with dead whole words, ragged n and a
domination cycle; the kernel's design emulated in torch (one cooperative
grid of blocks, 32-column slices, the list of live word rows, warps that
stop early, the double-buffered alive words, three counters in turn, the
stop test every block takes alike) against the same loop; and the kernel
path's spans and host reads, with the wrapper's plain version standing in
for the kernel.  On a CUDA device (marked ``cuda``, skipped without one):
the kernel against the plain loop bit for bit, at the search's shapes too,
a search that returns the same population with either, and the spans and
reads of the kernel path.  No JAX.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import nsga2_torch as T  # noqa: E402
from repro_torch.kernels import ops, pareto_rank, ref  # noqa: E402
from repro_torch.obs import Obs  # noqa: E402
from repro_torch.testing import edge_population  # noqa: E402

MASKS = ("all", "random", "dead_words")


def frozen_peel(Dp, alive, cap):
    """The front loop as ``nsga2_torch._peel`` ran it before it moved to
    ``kernels.ref.peel_fronts``, kept here as the yardstick."""
    n = alive.shape[0]
    rank = torch.full((n,), n, dtype=torch.int64, device=alive.device)
    n_alive = int(alive.sum())
    r = done = 0
    while n_alive and done < cap:
        alive_p = ref.pack_bits(alive[:, None])[:, 0]
        n_dom = ref.popcount32(Dp & alive_p[:, None]).sum(dim=0)
        front = alive & (n_dom == 0)
        k = int(front.sum())
        if k == 0:
            front, k = alive, n_alive
        rank = torch.where(front, r, rank)
        alive = alive & ~front
        n_alive -= k
        done += k
        r += 1
    return rank, r, done


def cycle_words(n):
    """Rows 0 and 1 dominate each other and every other row: no individual
    is free of an alive dominator, so the first front is empty and the
    numerical-safety rule ranks everyone alive in it."""
    B = torch.zeros((n, n), dtype=torch.bool)
    B[0, 1:] = True
    B[1, 0] = B[1, 2:] = True
    return ref.pack_bits(B)


def alive_mask(n, mask, seed):
    alive = torch.ones(n, dtype=torch.bool)
    if mask != "all":
        alive = torch.from_numpy(np.random.default_rng(seed).random(n) < 0.7)
    if mask == "dead_words":
        for w in range(0, (n + 31) // 32, 2):
            alive[32 * w:32 * w + 32] = False
    return alive


def case(n, m, mask, seed=0, infeas=0.3):
    """K1's words (through the plain version) of an edge population, or of
    a domination cycle for ``m == 0``, and an alive mask."""
    if m == 0:
        words = cycle_words(n)
    else:
        F, CV = edge_population(n, m, infeas, seed)
        words = ref.packed_domination(F, CV, F, CV)
    return words, alive_mask(n, mask, seed + 1)


def caps(n):
    return (None, 1, n // 2)


CASES = [(n, m) for n in (33, 97, 130) for m in (1, 3, 8)] + [
    (5, 0), (40, 0)]


# -- the plain loop -------------------------------------------------------------------

@pytest.mark.parametrize("n,m", CASES)
@pytest.mark.parametrize("mask", MASKS)
def test_plain_loop_equals_the_loop_before_it_moved(n, m, mask):
    words, alive = case(n, m, mask, seed=n + m)
    for cap in caps(n):
        rank, fronts, done, entry = ops.peel_fronts(words, alive, cap,
                                                    impl="ref")
        want = frozen_peel(words, alive, n if cap is None else cap)
        assert torch.equal(rank, want[0]) and (fronts, done) == want[1:]
        assert entry == int(alive.sum())


def test_a_domination_cycle_takes_the_numerical_safety_branch():
    words = cycle_words(40)
    alive = torch.ones(40, dtype=torch.bool)
    rank, fronts, done, entry = ops.peel_fronts(words, alive, impl="ref")
    assert (fronts, done, entry) == (1, 40, 40)
    assert torch.equal(rank, torch.zeros(40, dtype=torch.int64))


def test_plain_loop_reports_each_read():
    words, alive = case(97, 3, "random", seed=4)
    seen = []
    rank, fronts, done, entry = ops.peel_fronts(
        words, alive, impl="ref", on_read=lambda k, a: seen.append((k, a)))
    assert seen[0] == (None, entry) and len(seen) == fronts + 1
    assert sum(k for k, _ in seen[1:]) == done
    assert [a for _, a in seen[1:]] == sorted(
        (a for _, a in seen[1:]), reverse=True)


# -- the kernel's design, emulated ------------------------------------------------------

def u32(words):
    return words.to(torch.int64) & 0xFFFFFFFF


def popc(x):
    return bin(int(x)).count("1")


def emulate_k6(words, alive, cap, grid, warps=8, unroll=8, seed=0,
               shuffle=True):
    """``peel_fronts_kernel`` step by step: returns (rank, [fronts, ranked,
    alive at entry], words loaded).  The scratch starts as garbage.  With
    ``shuffle`` the warps of a block take their steps in a random order and
    each block lists its live word rows in its own order, as the kernel's
    atomics may; without, in ascending order."""
    gen = torch.Generator().manual_seed(seed)
    n = alive.shape[0]
    W = (n + 31) // 32
    D = u32(words)
    lanes = torch.arange(32)
    rank = torch.full((n,), -7, dtype=torch.int64)
    bufs = [torch.randint(0, 2 ** 32, (W,), generator=gen) for _ in range(2)]
    counts = [-5, 11, 3]
    # entry: pack the alive mask, every rank n, the counters zeroed
    for s in range(W):
        q = 32 * s + lanes
        bits = (q < n) & alive[torch.clamp(q, max=n - 1)]
        bufs[0][s] = int((bits.to(torch.int64) << lanes).sum())
        rank[q[q < n]] = n
    counts[:] = [0, 0, 0]
    cur, nxt = 0, 1
    r = done = entry = loads = 0
    while True:
        s_alive = bufs[cur].clone()
        live = [int(w) for w in torch.nonzero(s_alive).flatten()]
        n_alive = sum(popc(a) for a in s_alive)
        if r == 0:
            entry = n_alive
        if n_alive == 0 or done >= cap:
            break
        k_blocks = []
        for b in range(grid):
            order = ([live[i] for i in torch.randperm(len(live),
                                                      generator=gen)]
                     if shuffle else live)
            k_block = 0
            for s in range(b, W, grid):
                cols = int(s_alive[s])
                if cols == 0:
                    bufs[nxt][s] = 0
                    continue
                col_bits = (cols >> lanes) & 1
                q = torch.clamp(32 * s + lanes, max=n - 1)
                s_dom = 0
                settled = [col_bits == 0 for _ in range(warps)]
                active = list(range(warps))
                step = 0
                while active:
                    turn = (torch.randperm(len(active), generator=gen)
                            if shuffle else range(len(active)))
                    for g in [active[i] for i in turn]:
                        i0 = g * unroll + step * warps * unroll
                        if i0 >= len(order):
                            active.remove(g)
                            continue
                        hit = torch.zeros(32, dtype=torch.int64)
                        need = ~settled[g]
                        for w in order[i0:i0 + unroll]:
                            assert int(s_alive[w]) != 0      # live rows only
                            hit |= torch.where(need, D[w, q] & int(s_alive[w]),
                                               0)
                            loads += int(need.sum())
                        dom = int(((hit != 0).to(torch.int64) << lanes).sum())
                        s_dom |= dom
                        settled[g] = settled[g] | (hit != 0) | (
                            ((s_dom >> lanes) & 1) == 1)
                        if bool(settled[g].all()):
                            active.remove(g)
                    step += 1
                front = cols & ~s_dom
                members = 32 * s + lanes[((front >> lanes) & 1) == 1]
                rank[members] = r
                bufs[nxt][s] = cols & ~front
                k_block += popc(front)
            k_blocks.append(k_block)
        counts[r % 3] += sum(k_blocks)
        counts[(r + 1) % 3] = 0
        # the grid barrier: every block reads the same counter
        k = counts[r % 3]
        if k == 0:                                    # numerical safety
            for s in range(W):
                a = int(s_alive[s])
                rank[32 * s + lanes[((a >> lanes) & 1) == 1]] = r
            done += n_alive
            r += 1
            break
        done += k
        r += 1
        cur, nxt = nxt, cur
    return rank, [r, done, entry], loads


@pytest.mark.parametrize("n,m", [(33, 3), (97, 1), (130, 8), (300, 3),
                                 (40, 0)])
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("grid", (1, 3))
def test_k6_design_equals_the_plain_loop(n, m, mask, grid):
    words, alive = case(n, m, mask, seed=n + m)
    for cap in caps(n):
        cap = n if cap is None else cap
        rank, info, loads = emulate_k6(words, alive, cap, grid,
                                       seed=n + grid)
        want = ref.peel_fronts(words, alive, cap)
        assert torch.equal(rank, want[0]) and info == list(want[1:])
        # the bound: each front reads at most the alive columns of the
        # alive word rows
        W_alive = sum(1 for w in range(0, n, 32) if alive[w:w + 32].any())
        assert loads <= info[0] * W_alive * int(alive.sum())


def test_k6_design_stops_a_column_at_its_first_alive_dominator():
    """Row 0 dominates every other row.  One warp, one word row a step, the
    live rows in order: on front 0 every column but 0 stops after word row
    0, column 0 reads all 8; on front 1 nothing dominates anyone, and each
    of the 255 columns reads all 8 word rows."""
    n = 256
    B = torch.zeros((n, n), dtype=torch.bool)
    B[0, 1:] = True
    words = ref.pack_bits(B)
    alive = torch.ones(n, dtype=torch.bool)
    rank, info, loads = emulate_k6(words, alive, n, grid=2, warps=1,
                                   unroll=1, shuffle=False)
    assert info == [2, n, n] and int(rank[0]) == 0
    assert bool((rank[1:] == 1).all())
    assert loads == (8 * 32 + 7) + (n - 1) * 8


# -- the kernel path's spans and reads, on the CPU -------------------------------------

def toy_eval(X):
    """Infeasible individuals among the feasible ones, their violations
    whole numbers, so that equal-violation groups form."""
    f1 = X.sum(dim=1).to(torch.float32)
    f2 = ((X - 20) ** 2).sum(dim=1).to(torch.float32)
    cv = torch.clamp(15.0 - X[:, 0].to(torch.float32), min=0.0)
    return torch.stack([f1, f2], dim=1), cv


def feasible_eval(X):
    F, cv = toy_eval(X)
    return F, torch.zeros_like(cv)


# a population that is all feasible (the peel ranks everyone) and one
# with an infeasible tail ranked in closed form
EVALS = {"feasible": feasible_eval, "infeasible": toy_eval}


def search(path, obs=None, pop=48, n_gen=4, device="cpu",
           rank_impl="auto"):
    return T.torch_nsga2(EVALS[path], 3, 0, 40, pop, n_gen, seed=3,
                         rank_impl=rank_impl, device=device, obs=obs)


def kernel_path_checks(obs, n_gen, impl):
    sp = obs.tracer.spans()
    peels = [s for s in sp if s.name == "search.peel"]
    assert len(peels) == n_gen + 1
    assert all(p.args["impl"] == impl for p in peels)
    assert not [s for s in sp if s.name == "search.front"]
    ranks = [s for s in sp if s.name == "search.rank"]
    for p, r in zip(peels, ranks):
        assert r.ts <= p.ts and p.end <= r.end
        assert p.args["ranked"] >= 1 and p.args["fronts"] >= 1
    # one read a ranking, then X, F and CV
    assert obs.metrics.snapshot()[T.HOST_READS] == len(peels) + 3


@pytest.mark.parametrize("path", EVALS)
def test_kernel_path_spans_and_reads_on_the_cpu(path, monkeypatch):
    """``impl`` resolved to ``cuda`` on CPU tensors: the wrapper takes its
    plain version, and the peel is accounted as the kernel's (no front
    spans, one read a ranking), with the same population as ``ref``."""
    want = search(path, rank_impl="ref")
    resolve = ops.resolve_impl
    monkeypatch.setattr(ops, "resolve_impl",
                        lambda impl, x: "cuda" if impl != "ref"
                        else resolve(impl, x))
    obs = Obs.on()
    got = search(path, obs)
    kernel_path_checks(obs, 4, "cuda")
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


# -- on a CUDA device ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the CUDA kernels")
    return torch.device("cuda")


def population(n, m=3, infeas=0.3, seed=0):
    rng = np.random.default_rng(seed)
    F = rng.random((n, m)).astype(np.float32)
    F[n // 2:] = F[rng.integers(0, n // 2, n - n // 2)]
    CV = np.where(rng.random(n) < infeas, (rng.random(n) * 3).round(1),
                  0.0).astype(np.float32)
    return torch.from_numpy(F), torch.from_numpy(CV)


def kernel_equals_plain(words, alive, cap):
    before = pareto_rank.peel_fronts.launches
    got = ops.peel_fronts(words, alive, cap, impl="cuda")
    want = ops.peel_fronts(words, alive, cap, impl="ref")
    assert pareto_rank.peel_fronts.launches == before + 1
    assert torch.equal(got[0], want[0]) and got[1:] == want[1:]
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", CASES + [(4099, 3), (1, 3), (32, 8)])
@pytest.mark.parametrize("mask", MASKS)
def test_kernel_matches_plain_loop(cuda_device, n, m, mask):
    words, alive = case(n, m, mask, seed=n + m)
    for cap in caps(n) + (0, n + 5):
        kernel_equals_plain(words.to(cuda_device), alive.to(cuda_device),
                            cap)


@pytest.mark.cuda
@pytest.mark.parametrize("n,cap", [(32768, 16384), (16384, None)])
def test_kernel_matches_plain_loop_at_the_search_shape(cuda_device, n, cap):
    """The ranking's words (K1) of a search-sized population, the
    feasible individuals alive."""
    F, CV = (a.to(cuda_device) for a in population(n, seed=n))
    words = ops.packed_domination(F, CV)
    fronts = kernel_equals_plain(words, CV <= 0, cap)[1]
    assert fronts > 10


@pytest.mark.cuda
@pytest.mark.parametrize("cap", (None, 2048))
def test_kernel_matches_plain_loop_on_the_dense_path(cuda_device, cap):
    F, CV = (a.to(cuda_device) for a in population(4096, seed=5))
    words = ref.pack_bits(T.domination_matrix(F, CV))
    kernel_equals_plain(words, torch.ones(4096, dtype=torch.bool,
                                          device=cuda_device), cap)


@pytest.mark.cuda
@pytest.mark.parametrize("path", EVALS)
def test_search_on_card_is_the_same_with_the_kernel_and_the_plain_loop(
        cuda_device, path):
    """pop 1024 x 5, all feasible and with an infeasible tail; the GA
    draws the same numbers in the same order, so X, F and CV are
    identical, and the kernel launches once a ranking."""
    before = pareto_rank.peel_fronts.launches
    got = search(path, pop=1024, n_gen=5, device="cuda", rank_impl="cuda")
    assert pareto_rank.peel_fronts.launches == before + 6
    want = search(path, pop=1024, n_gen=5, device="cuda", rank_impl="ref")
    assert pareto_rank.peel_fronts.launches == before + 6
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("path", EVALS)
def test_kernel_path_spans_and_reads_on_card(cuda_device, path,
                                             monkeypatch):
    """``search.peel`` carries ``impl="cuda"``, ``fronts`` and ``ranked``
    and holds no ``search.front``; the reads counted at the tensors are
    one a ranking and X, F and CV; the outputs equal the handle off."""
    off = search(path, pop=1024, n_gen=4, device="cuda")
    n = collections.Counter()
    for name in ("__int__", "__float__", "__bool__", "item", "cpu",
                 "tolist"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **k):
            n[_name] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    obs = Obs.on()
    on = search(path, obs, pop=1024, n_gen=4, device="cuda")
    monkeypatch.undo()
    kernel_path_checks(obs, 4, "cuda")
    assert sum(n.values()) == obs.metrics.snapshot()[T.HOST_READS]
    for a, b in zip(on, off):
        assert np.array_equal(a, b)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda_device):
    words, alive = (a.to(cuda_device) for a in case(64, 3, "all"))
    with pytest.raises(TypeError, match="int32"):
        pareto_rank.peel_fronts(words.to(torch.int64), alive, 64)
    with pytest.raises(TypeError, match="bool"):
        pareto_rank.peel_fronts(words, alive.to(torch.uint8), 64)
    with pytest.raises(ValueError, match="shapes"):
        pareto_rank.peel_fronts(words[:1], alive, 64)
    with pytest.raises(ValueError, match="on cuda"):
        pareto_rank.peel_fronts(words, alive.cpu(), 64)
    with pytest.raises(ValueError, match="needs CUDA"):
        ops.peel_fronts(words.cpu(), alive.cpu(), impl="cuda")
