"""The measured accuracy oracle (§IV-C) on any LM the port's registry
builds, in a closed loop: ``bench/drivers/lm_oracle.py``'s loop, window
and checks, on the model of the configuration and against the plain
reference that the cell names.

The cell's ``lib`` names the module of ``bench/lib`` that knows the
configuration (``port_config(config)``, the port's ``ModelConfig``;
``leaves(config)``, the weights to draw), and its ``reference`` the
module of ``bench/reference`` with the plain forward
(``forward(config, w, tokens, cuts, bits, link_quant, keep, precision)``
→ (top-1, kept logits)).  ``oracle.deepseek-v3-4plat.t16384`` runs here
with ``deepseek_v3`` for both.

Under ``--trace 1`` the program's spans and counters (``Obs.on()``) are
recorded over the traced vectors: each ``oracle.stage`` with what the
runner records for the model's units (MLA's ``mla_ms``, the expert
layers' ``moe_ms``), ``oracle.quantize``, and the counters
``moe_rows.held`` and ``moe_rows.routed``.
"""

from __future__ import annotations

import importlib

from bench.drivers.lm_oracle import State, _bits, position_errors
from bench.drivers.lm_oracle import window  # noqa: F401
from bench.drivers.oracle import draw_cuts
from bench.lib import granite
from bench.lib.harness import Check


def _lib(run):
    return importlib.import_module(f"bench.lib.{run.cell['lib']}")


def _plain(run):
    return importlib.import_module(f"bench.reference.{run.cell['reference']}")


def _reference(run, w, tokens, cut, keep, precision="float32"):
    return _plain(run).forward(run.config, w, tokens, cut, _bits(run.config),
                               run.cell["traffic"]["link_quant"], keep,
                               precision)


def setup(run):
    from bench.lib import weights
    from bench.lib.models import float32_products
    from repro_torch.core.graph import linearize
    from repro_torch.core.quant import QuantSpec
    from repro_torch.models.registry import build_model
    from repro_torch.obs import Obs
    from repro_torch.quantize.evaluate import lm_measured_accuracy
    config, traffic = run.config, run.cell["traffic"]
    lib = _lib(run)
    cfg = lib.port_config(config)
    float32_products()
    w = weights.draw(lib.leaves(config), run.seed, run.device)
    tokens = granite.tokens(config, traffic, run.seed, run.device)
    labels = _plain(run).forward(config, w, tokens)[0][:, :-1]
    model = build_model(cfg, device=run.device)
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


def check(state: State, run, out, control: bool = False) -> list:
    """``lm_oracle.check``'s three numbers, the check vectors against the
    cell's plain reference (``control``: that reference with TF32
    products in the program's place)."""
    import gc

    import torch

    from bench.lib import weights
    limits = run.cell["limits"]
    kept, labels, tokens = state.measure.kept, state.labels, state.tokens
    keep = state.keep
    state.measure = state.model = None
    gc.collect()           # the oracle's closure holds the model in a cycle
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    w = weights.draw(_lib(run).leaves(run.config), run.seed, run.device)
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
