"""The measured accuracy oracle (§IV-C) on a hybrid LM, in a closed loop:
``quantize/evaluate.py::lm_measured_accuracy``'s ``measure`` on cut
vectors drawn from the seed, each scored once.

A cut vector is three sorted positions of the model's chain (the
embedding, each layer's mixer and MLP, the head), each drawn uniformly
from -1 to the last position as ``bench/drivers/oracle.py`` draws them.
Each ``measure`` builds the cut's stages with their weights
fake-quantized to the platforms' widths, runs the evaluation sequences
through them, the activations crossing the links fake-quantized at the
producer's width, and scores the share of next-token positions whose
top-1 is the float model's.  Check vectors, chosen from the seed before
the window opens, keep their logits at seeded positions and their top-1
at every position; ``check`` compares them, after the program's state is
freed, with the plain reference (``bench/reference/granite_hybrid.py``).
Under ``--trace 1`` the program's spans and counters (``Obs.on()``) are
recorded over the traced vectors and returned with the window's output.
"""

from __future__ import annotations

import dataclasses
import time

from bench.drivers.oracle import draw_cuts
from bench.lib import granite
from bench.lib.harness import Check


@dataclasses.dataclass
class State:
    measure: object
    cuts: object
    tokens: object
    labels: object
    keep: object
    check_at: list
    obs: object = None
    model: object = None
    accs: dict = dataclasses.field(default_factory=dict)


def _bits(config):
    return [p["bits"] for p in config["platforms"]]


def _reference(run, w, tokens, cut, keep, precision="float32"):
    from bench.reference import granite_hybrid
    return granite_hybrid.forward(
        run.config, w, tokens, cut, _bits(run.config),
        run.cell["traffic"]["link_quant"], keep, precision)


def setup(run):
    from bench.lib import weights
    from bench.lib.models import float32_products
    from bench.reference import granite_hybrid
    from repro_torch.core.graph import linearize
    from repro_torch.core.quant import QuantSpec
    from repro_torch.models.ssm_lm import MixedLM
    from repro_torch.obs import Obs
    from repro_torch.quantize.evaluate import lm_measured_accuracy
    config, traffic = run.config, run.cell["traffic"]
    cfg = granite.port_config(config)
    float32_products()
    w = weights.draw(granite.leaves(config), run.seed, run.device)
    tokens = granite.tokens(config, traffic, run.seed, run.device)
    labels = granite_hybrid.forward(config, w, tokens)[0][:, :-1]
    # built on the device and given the drawn weights (on ``meta`` the
    # build would load torch's meta kernels, seconds of set-up)
    model = MixedLM(cfg, device=run.device)
    model.load_state_dict(w, assign=True)
    del w
    schedule = linearize(model.to_graph(traffic["tokens"]),
                         config["schedule_policy"])
    specs = [QuantSpec(bits=b) for b in _bits(config)]
    obs = None
    if run.trace:
        obs = Obs.on()
        obs.enabled = False        # on over the traced vectors only
    measure = lm_measured_accuracy(model, schedule, tokens, labels, specs,
                                   link_quant=traffic["link_quant"],
                                   obs=obs)
    cuts = draw_cuts(len(schedule), len(specs) - 1, run.seed)
    for _ in range(traffic["warmup_vectors"]):     # never drawn again
        measure(next(cuts))
    measure((-1, -1, -1))
    return State(measure, cuts, tokens, labels,
                 granite.kept_positions(traffic, run.seed, run.device),
                 granite.check_indices(traffic, run.seed), obs, model)


def _spans(obs):
    return [{"name": s.name, "dur": s.dur, "args": s.args}
            for s in obs.tracer.spans()]


def window(state: State, run) -> dict:
    traffic = run.cell["traffic"]
    traced_n = traffic["traced_vectors"]
    t0 = time.perf_counter()
    n = 0
    out = {"traced_vectors": 0, "spans": [], "counters": {}}
    while True:
        if run.trace and n == 1:
            run.tracer.begin()
            state.obs.enabled = True
        cut = next(state.cuts)
        if n in state.check_at:
            state.accs[cut] = state.measure(cut, keep=state.keep)
        else:
            state.measure(cut)
        n += 1
        if run.trace and n == 1 + traced_n:
            run.tracer.end()
            state.obs.enabled = False
            out.update(traced_vectors=traced_n, spans=_spans(state.obs),
                       counters=state.obs.metrics.snapshot())
        if time.perf_counter() - t0 >= run.seconds:
            break
    elapsed = time.perf_counter() - t0
    run.tracer.end()
    if run.trace and not out["traced_vectors"]:
        state.obs.enabled = False
        out.update(traced_vectors=n - 1, spans=_spans(state.obs),
                   counters=state.obs.metrics.snapshot())
    b, t = state.tokens.shape
    out.update(attempted=n, failed=0, scored=n, sequences=b, tokens=t,
               e2e={"oracle_cutvecs_per_s": n / elapsed})
    return out


def position_errors(got, ref):
    """Each kept position's largest |Δ| over the vocabulary, over the
    largest |reference logit| of the vector."""
    return (got - ref).abs().amax(-1) / ref.abs().max()


def check(state: State, run, out, control: bool = False) -> list:
    """The check vectors against the plain partitioned, fake-quantized
    forward in float32; ``control``: that forward with TF32 products in
    the program's place.  Each number is the largest over the vectors:

    * ``logit_rel_err``: the largest of :func:`position_errors` over the
      kept positions (any fault that reaches a kept logit);
    * ``logit_median_rel_err``: their median (the error of a typical
      position, which separates float32 from TF32 products more widely
      than the largest does);
    * ``agree_gap_positions``: the difference of agreement counts (top-1
      equal to the label) over every position, inf where the program's
      score is not its own top-1's agreement: a fault at the positions
      whose logits are not kept, or in the score itself."""
    import torch

    from bench.lib import weights
    limits = run.cell["limits"]
    kept, labels, tokens = state.measure.kept, state.labels, state.tokens
    keep = state.keep
    state.measure = state.model = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    w = weights.draw(granite.leaves(run.config), run.seed, run.device)
    rel = med = gap = float("-inf") if kept else float("inf")
    for cut, got in kept.items():
        top1, logits = _reference(run, w, tokens, cut, keep)
        if control:
            ptop1, plogits = _reference(run, w, tokens, cut, keep, "tf32")
        else:
            ptop1, plogits = got["top1"], got["logits"]
        err = position_errors(plogits, logits).double()
        rel = max(rel, float(err.max()))
        med = max(med, float(err.median()))
        agree = int((top1[:, :-1] == labels).sum())
        pagree = int((ptop1[:, :-1] == labels).sum())
        if not control and abs(state.accs[cut] * labels.numel()
                               - pagree) > 0.5:
            pagree = float("inf")
        gap = max(gap, abs(pagree - agree))
    return [Check("logit_rel_err", rel, limits["logit_rel_err"]),
            Check("logit_median_rel_err", med,
                  limits["logit_median_rel_err"]),
            Check("agree_gap_positions", gap, limits["agree_gap_positions"])]
