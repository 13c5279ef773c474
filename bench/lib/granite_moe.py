"""What the granite cells with experts add to ``bench/lib/granite.py``:
the configuration file read as the port's ``ModelConfig`` with its held
share of experts, the weights' leaves with each layer's expert layer, and
the work of a forward counted with the rows its held experts compute.

The configuration file holds the published ``config.json``'s keys (IBM
Granite 4.0-H Small), ``num_local_experts`` cut to the experts one device
holds, and beside them ``experts_published`` (the router's outputs, the
published expert count) and ``experts_first`` (the first expert held).
``intermediate_size`` is one expert's width and
``shared_intermediate_size`` the shared expert's, the MLP of the models
without experts.  Leaves are named as the port names its parameters
(``blocks.<l>.ffn.moe.router``, ``...moe.w_gate``, ``...moe.sh_gate``,
...), so that ``bench/lib/weights.py`` draws them and the program and the
plain reference (``bench/reference/granite_moe_hybrid.py``) each take
them by name.

Work is counted once, as ``granite.py`` counts it: the router's product
at every token, each held expert's gated product at the rows routed to
it, the shared expert at every token.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from bench.lib import granite
from bench.lib.weights import Leaf

def shared_config(config: dict) -> dict:
    """The file with the shared expert's width as ``intermediate_size``:
    what ``granite.py`` reads as each layer's MLP."""
    return dict(config, intermediate_size=config["shared_intermediate_size"])


def port_config(config: dict):
    """The port's ``ModelConfig`` of the configuration file: the registry's
    configuration of ``config["model"]["name"]`` with the file's widths,
    the router over ``experts_published`` experts, ``num_local_experts`` of
    them held from ``experts_first``.  Raises as ``granite.port_config``
    does, and on a file without experts."""
    c = config
    if not c["num_local_experts"] or not c["num_experts_per_tok"]:
        raise ValueError("the configuration has no experts")
    return dataclasses.replace(
        granite.port_config(shared_config(c)),
        n_experts=c["experts_published"], top_k=c["num_experts_per_tok"],
        n_shared=1, moe_d_ff=c["intermediate_size"],
        experts_held=(c["experts_first"], c["num_local_experts"]))


def experts(prefix: str, config: dict) -> List[Leaf]:
    """An expert layer's router and held experts: N(0, 1/fan_in), as every
    projection."""
    d, ff = config["hidden_size"], config["intermediate_size"]
    e, h = config["experts_published"], config["num_local_experts"]
    return [(prefix + "router", (d, e), "normal", d ** -0.5),
            (prefix + "w_gate", (h, d, ff), "normal", d ** -0.5),
            (prefix + "w_up", (h, d, ff), "normal", d ** -0.5),
            (prefix + "w_down", (h, ff, d), "normal", ff ** -0.5)]


def leaves(config: dict) -> List[Leaf]:
    """Every weight: ``granite.leaves`` of the model with each layer's MLP
    (at the shared expert's width) become its expert layer's shared
    expert, the router and the held experts before it."""
    out: List[Leaf] = []
    for leaf in granite.leaves(shared_config(config)):
        name = leaf[0]
        if ".ffn.mlp." not in name:
            out.append(leaf)
            continue
        prefix, w = name.split(".mlp.")
        if w == "w_gate":
            out += experts(prefix + ".moe.", config)
        out.append((f"{prefix}.moe.sh_{w[2:]}",) + tuple(leaf[1:]))
    return out


def expected_rows(config: dict, b: int, t: int) -> float:
    """The rows the held experts compute in one forward under uniform
    routing: tokens x top-k x held / published, a layer."""
    c = config
    return (c["num_hidden_layers"] * b * t * c["num_experts_per_tok"]
            * c["num_local_experts"] / c["experts_published"])


def forward_flops(config: dict, b: int, t: int,
                  held_rows: Optional[float] = None) -> float:
    """The products of one forward of (b, t) tokens: ``granite.py``'s count
    with the shared expert as each layer's MLP, the routers, and the held
    experts' gated products at ``held_rows`` rows (the rows the forward's
    expert layers computed; :func:`expected_rows` when None)."""
    c = config
    d, ff = c["hidden_size"], c["intermediate_size"]
    rows = expected_rows(c, b, t) if held_rows is None else held_rows
    router = c["num_hidden_layers"] * b * t * d * c["experts_published"]
    return (granite.forward_flops(shared_config(c), b, t)
            + 2 * router + 2 * 3 * d * ff * rows)
