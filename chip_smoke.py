"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It imports the port (``src/repro_torch``) and nothing of the JAX package,
builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` and then:

1. holds every kernel of the search path against its plain PyTorch version
   on the card, bit for bit (packed domination words and dominator counts
   are integers: tolerance 0), at the main path's shapes and at ragged
   sizes, and times kernel, plain version and the kernel's lower bound;
2. checks the tiled ranking on the card against the dense ranking on the
   CPU on a small population (exact ranks);
3. drives the main path once through ``repro_torch.explore.run_spec``:
   the full-size EfficientNet-B0 on a four-platform chain, searched by
   ``torch_nsga2`` at population 16384 for 10 generations, with each
   kernel's launch count set to 0 just before and read just after; checks
   the front against the exact NumPy evaluator.

It prints one line per kernel, a JSON line ``{"kernels": [...]}``, the
card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result line; so does a machine without a CUDA
device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12

POP, N_GEN, SEED = 16384, 10, 0
RANK_BLOCK = 2048            # the auto policy's tile rows at this population
RAGGED = (33, 97, 130)


def population(n, m=3, infeas=0.3, seed=0):
    """Objectives with duplicated rows (ties) and a share of infeasible
    individuals with repeated violations, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    F = rng.random((n, m)).astype(np.float32)
    F[n // 2:] = F[rng.integers(0, n // 2, n - n // 2)]
    CV = np.where(rng.random(n) < infeas, (rng.random(n) * 3).round(1),
                  0.0).astype(np.float32)
    return F, CV


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` on the card over ``reps`` calls, after
    one warm-up call, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def pair_ops(F, CV, rows_alive=None):
    """Float32 compares the domination test needs on these inputs: 2m per
    (feasible row, feasible column) pair, 1 per (infeasible, infeasible)
    pair, none for a mixed pair (decided by the feasibility bits), plus one
    feasibility compare per row and column."""
    m = F.shape[1]
    feas = CV <= 0
    rows = feas if rows_alive is None else feas[rows_alive]
    n_rows = len(rows)
    fr, fc = int(rows.sum()), int(feas.sum())
    ir, ic = n_rows - fr, len(feas) - fc
    return fr * fc * 2 * m + ir * ic + n_rows + len(feas)


def bound(n_bytes, ops):
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a, b):
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def check_kernels(dev):
    """Phase 1: each kernel against its plain version on the card; returns
    the per-kernel records (launches filled in after the main path)."""
    from repro_torch.kernels import ops, pareto_rank, ref

    cases = [(n, p, s) for n in RAGGED for p, s in ((0.3, n), (1.0, n + 1),
                                                    (0.0, n + 2))]
    for n, infeas, seed in cases:
        F, CV = (torch.from_numpy(a).to(dev) for a in population(
            n, infeas=infeas, seed=seed))
        alive = torch.from_numpy(np.random.default_rng(seed).random(n)
                                 < 0.5).to(dev)
        for block in (32, 64):
            got = pareto_rank.packed_domination(
                F, CV, F, CV, bp=ops._row_tile(block), bq=ops._COL_TILE)
            want = ref.packed_domination(F, CV, F, CV, block)
            assert torch.equal(got, want), ("packed_domination", n, infeas)
        for mask in (torch.ones_like(alive), alive):
            assert torch.equal(pareto_rank.domination_counts(F, CV, mask),
                               ref.domination_counts(F, CV, mask)), (
                "domination_counts", n, infeas)
    print(f"ragged sizes {RAGGED} x infeasible share (0.3, 1.0, 0.0): "
          f"both kernels bit-exact")

    records = []
    # K1 at the main path's shape: the combined population of a generation
    n2 = 2 * POP
    Fh, CVh = population(n2, seed=1)
    F, CV = torch.from_numpy(Fh).to(dev), torch.from_numpy(CVh).to(dev)
    tile = dict(bp=ops._row_tile(RANK_BLOCK), bq=ops._COL_TILE)
    got = pareto_rank.packed_domination(F, CV, F, CV, **tile)
    want = ref.packed_domination(F, CV, F, CV, RANK_BLOCK)
    err = max_abs_err(got, want)
    assert err == 0 and torch.equal(got, want), "packed_domination differs"
    ms = cuda_ms(lambda: pareto_rank.packed_domination(F, CV, F, CV, **tile),
                 20)
    plain = cuda_ms(lambda: ref.packed_domination(F, CV, F, CV, RANK_BLOCK),
                    3)
    m = Fh.shape[1]
    n_bytes = 2 * n2 * (m + 1) * 4 + got.numel() * 4
    b_ms, b_by = bound(n_bytes, pair_ops(Fh, CVh))
    records.append(dict(
        name="packed_domination", route="cuda",
        source="src/repro_torch/kernels/csrc/pareto_rank.cu",
        replaces="src/repro/kernels/pareto_rank.py:50",
        shape=f"F ({n2}, {m}) f32 -> words {tuple(got.shape)} int32",
        launches=0, max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None))

    # K2 at the main path's shape: the final population, every row alive,
    # and again under an alive mask
    Fh, CVh = population(POP, seed=2)
    F, CV = torch.from_numpy(Fh).to(dev), torch.from_numpy(CVh).to(dev)
    mask_h = np.random.default_rng(3).random(POP) < 0.5
    ones = torch.ones(POP, dtype=torch.bool, device=dev)
    err = 0
    for mask in (ones, torch.from_numpy(mask_h).to(dev)):
        got = pareto_rank.domination_counts(F, CV, mask)
        want = ref.domination_counts(F, CV, mask, RANK_BLOCK)
        err = max(err, max_abs_err(got, want))
        assert torch.equal(got, want), "domination_counts differs"
    ms = cuda_ms(lambda: pareto_rank.domination_counts(F, CV, ones), 20)
    plain = cuda_ms(lambda: ref.domination_counts(F, CV, ones, RANK_BLOCK), 3)
    n_bytes = POP * (m + 1) * 4 + POP * 4 + POP * 4
    b_ms, b_by = bound(n_bytes, pair_ops(Fh, CVh))
    records.append(dict(
        name="domination_counts", route="cuda",
        source="src/repro_torch/kernels/csrc/pareto_rank.cu",
        replaces="src/repro/kernels/pareto_rank.py:94",
        shape=f"F ({POP}, {m}) f32, all alive -> counts ({POP},) int32",
        launches=0, max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None))
    return records


def check_ranking(dev):
    """Phase 2: tiled ranking through the kernel on the card equals the
    dense ranking on the CPU on a small population."""
    from repro_torch.core.nsga2_torch import nondominated_rank
    n = 3000
    Fh, CVh = population(n, seed=4)
    cpu = [nondominated_rank(torch.from_numpy(Fh), torch.from_numpy(CVh), cap)
           for cap in (None, n // 2)]
    Fd, CVd = torch.from_numpy(Fh).to(dev), torch.from_numpy(CVh).to(dev)
    for want, cap in zip(cpu, (None, n // 2)):
        got = nondominated_rank(Fd, CVd, cap, rank_block=512).cpu()
        assert torch.equal(got, want), ("rank", cap)
    print(f"tiled ranking on the card == dense ranking on the CPU "
          f"(n={n}, caps None and {n // 2})")


def main_spec():
    """The main path's spec: full-size EfficientNet-B0 on the four-platform
    chain, searched by ``torch_nsga2`` at population 16384."""
    from repro_torch.explore import (ExplorationSpec, ModelRef, PlatformSpec,
                                     SearchSettings, SystemSpec)
    return ExplorationSpec(
        model=ModelRef("cnn", "efficientnet_b0", {"in_hw": 224, "w": 1.0}),
        system=SystemSpec(
            platforms=(PlatformSpec("cam0", "eyr", bits=16),
                       PlatformSpec("cam1", "eyr", bits=16),
                       PlatformSpec("edge", "smb", bits=8),
                       PlatformSpec("central", "smb", bits=8)),
            links=("gige", "gige", "gige")),
        objectives=("latency", "energy", "throughput"),
        search=SearchSettings(strategy="torch_nsga2", pop_size=POP,
                              n_gen=N_GEN, seed=SEED))


def main_path(dev, records):
    """Phase 3: the port's main path once, with the launch counts read."""
    from repro_torch.core.accuracy import ProxyAccuracy
    from repro_torch.core.graph import linearize
    from repro_torch.core.partition import PartitionEvaluator
    from repro_torch.explore import run_spec
    from repro_torch.kernels import pareto_rank

    spec = main_spec()
    kernels = {"packed_domination": pareto_rank.packed_domination,
               "domination_counts": pareto_rank.domination_counts}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    res = run_spec(spec, device=str(dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    assert all(v > 0 for v in launches.values()), launches
    assert res.strategy_used == "torch_nsga2", res.strategy_used
    assert res.pareto, "empty front"
    assert len(res.schedule) == 207, len(res.schedule)

    # the front against the exact NumPy evaluator on the same cuts
    graph, _ = spec.model.build()
    system = spec.system.build()
    schedule = linearize(graph, spec.schedule_policy)
    assert [l.name for l in schedule] == [l.name for l in res.schedule]
    ev = PartitionEvaluator(graph, schedule, system,
                            accuracy_fn=ProxyAccuracy(schedule, system))
    cuts = np.array([p.cuts for p in res.pareto])
    assert res.pareto == ev.evaluate_batch(cuts).to_evals()
    for p in res.pareto:
        exact = ev.evaluate(p.cuts)
        assert p.memory_bytes == exact.memory_bytes
        assert p.link_bytes == exact.link_bytes
        np.testing.assert_allclose(
            [p.latency_s, p.energy_j, p.throughput, p.accuracy],
            [exact.latency_s, exact.energy_j, exact.throughput,
             exact.accuracy], rtol=1e-12)
    F = np.array([p.as_objectives(spec.objectives) for p in res.pareto])
    assert np.isfinite(F).all() and F.shape == (len(res.pareto), 3)
    evals_s = POP * (N_GEN + 1) / wall
    print(f"main path: efficientnet_b0 224 ({len(res.schedule)} positions), "
          f"4 platforms, torch_nsga2 pop {POP} x {N_GEN} gen: "
          f"wall {wall:.3f} s, {evals_s:.0f} evals/s, front "
          f"{len(res.pareto)} points, launches {launches}, peak device "
          f"memory {torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MiB")
    return wall, evals_s


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    records = check_kernels(dev)
    check_ranking(dev)
    main_path(dev, records)
    for r in records:
        print(f"{r['name']}: {r['shape']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), launches on the main path "
              f"{r['launches']}, max_abs_err {r['max_abs_err']}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
