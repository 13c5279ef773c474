"""The measured accuracy oracle (§IV-C) in a closed loop:
``quantize/evaluate.py::cnn_measured_accuracy``'s ``measure`` on cut
vectors drawn from the seed, each scored once.

A cut vector is three sorted positions of the model's schedule, each
drawn uniformly from -1 (no cut) to the last position, as the search
encodes them; no two in a run are equal, so the oracle's cache never
answers.  Each ``measure`` builds the cut's stages with their weights
fake-quantized to the platforms' widths and runs the evaluation images
through them.
"""

from __future__ import annotations

import dataclasses
import time

from bench.lib import seeds
from bench.lib.harness import Check


@dataclasses.dataclass
class State:
    measure: object
    cuts: object
    scored: list = dataclasses.field(default_factory=list)
    model: object = None


def draw_cuts(n_positions: int, n_cuts: int, seed: int):
    """Distinct sorted cut vectors, without end, each position uniform
    over -1 .. n_positions - 1."""
    rng = seeds.rng(seed, 11)
    seen = set()
    while True:
        c = tuple(sorted(int(x) for x in rng.integers(
            -1, n_positions, size=n_cuts)))
        if c not in seen:
            seen.add(c)
            yield c


def setup(run):
    from bench.lib.models import build_cnn, cnn_inputs
    from repro_torch.core.graph import linearize
    from repro_torch.core.quant import QuantSpec
    from repro_torch.quantize.evaluate import cnn_measured_accuracy
    config, traffic = run.config, run.cell["traffic"]
    w, images, labels = cnn_inputs(config, traffic, run.seed, run.device)
    model = build_cnn(config, w, run.device)
    schedule = linearize(model.to_graph(), config["schedule_policy"])
    specs = [QuantSpec(bits=p["bits"]) for p in config["platforms"]]
    measure = cnn_measured_accuracy(model, schedule, images, labels, specs)
    cuts = draw_cuts(len(schedule), len(specs) - 1, run.seed)
    for _ in range(traffic["warmup_vectors"]):     # never drawn again
        measure(next(cuts))
    measure((-1, -1, -1))
    return State(measure, cuts, model=model)


def window(state: State, run) -> dict:
    traffic = run.cell["traffic"]
    t0 = time.perf_counter()
    n = 0
    traced = 0
    while True:
        if run.trace and n == 1:
            run.tracer.begin()
        cut = next(state.cuts)
        state.scored.append((cut, state.measure(cut)))
        n += 1
        if run.trace and n == 1 + traffic["traced_vectors"]:
            run.tracer.end()
            traced = traffic["traced_vectors"]
        if time.perf_counter() - t0 >= run.seconds:
            break
    elapsed = time.perf_counter() - t0
    run.tracer.end()
    if run.trace and not traced:
        traced = n - 1
    return {"attempted": n, "failed": 0, "scored": n,
            "traced_vectors": traced, "images": traffic["images"],
            "e2e": {"oracle_cutvecs_per_s": n / elapsed}}


def _sample(state: State, run):
    rng = seeds.rng(run.seed, 13)
    k = min(run.cell["traffic"]["check_vectors"], len(state.scored))
    idx = rng.choice(len(state.scored), k, replace=False)
    return [state.scored[i] for i in sorted(idx)]


def _free(state: State, run):
    import torch
    state.measure = state.model = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def _reference(state: State, run, picked, precision="float32"):
    from bench.lib.models import cnn_inputs
    from bench.reference.effnet import Partitioned
    w, images, labels = cnn_inputs(run.config, run.cell["traffic"], run.seed,
                                   run.device)
    model = Partitioned(run.config)
    return [model.accuracy(w, images, labels, c, precision)
            for c, _ in picked], images.shape[0]


def check(state: State, run, out, control: bool = False) -> list:
    """The sampled vectors' accuracies against the plain partitioned,
    fake-quantized forward in float32.  ``control``: that forward in TF32
    in the program's place."""
    limits = run.cell["limits"]
    picked = _sample(state, run)
    _free(state, run)
    accs, n_img = _reference(state, run, picked)
    got = ([a for _, a in picked] if not control
           else _reference(state, run, picked, "tf32")[0])
    gap = max((abs(a - r) * n_img for a, r in zip(got, accs)),
              default=float("inf"))
    return [Check("acc_gap_images", gap, limits["acc_gap_images"])]
