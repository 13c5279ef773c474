"""A plain IBM Granite 4.0-H forward with experts (granite-4.0-h-small,
model type ``granitemoehybrid``, public ``config.json``) on one device's
share of the experts, and its partitioned, fake-quantized forward over a
cut vector, in plain PyTorch: no kernel, no cache, nothing of the program
under test.

The model is ``granite_hybrid.py``'s (its Mamba2 mixers, attention, norms,
multipliers, stages and fake quantization are used as they are) with each
layer's MLP replaced by an expert layer::

    v = RMSNorm(h)
    h = h + r · (MoE(v) + Shared(v))
    MoE(v):    logits = v W_router (all ``experts_published`` outputs);
               the top ``num_experts_per_tok`` logits, g = softmax over the
               chosen; Σ over the chosen experts that this device holds
               (``experts_first`` .. + ``num_local_experts`` - 1) of
               g_e · W_down,e(silu(v W_gate,e) ⊙ v W_up,e).  Every choice
               is kept (dropless); a choice of an expert not held adds
               nothing, as on a device of an expert-parallel deployment
               before the exchange.
    Shared(v): W_down(silu(v W_gate) ⊙ v W_up), width
               ``shared_intermediate_size``

The weights are ``granite_hybrid.py``'s, each ``blocks.<l>.ffn.mlp.<w>``
now ``blocks.<l>.ffn.moe.sh_<gate, up, down>``, beside
``blocks.<l>.ffn.moe.router`` (d, E) and the held experts'
``blocks.<l>.ffn.moe.<w_gate, w_up>`` (H, d, ff) and ``w_down`` (H, ff,
d).  A platform with a width quantizes each of them stacked over its
expert layers whole, per tensor, as ``granite_hybrid.stage_weights`` does
every unit kind's.  The routing, placed as the public ``transformers``
``GraniteMoeHybrid`` model places it (top-k of the logits, then the
softmax of the k), is recalled, not read here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from bench.reference.granite_hybrid import (_Products, _unit, attention,
                                            fake_quant, layout, mamba, mlp,
                                            precision_of, rms_norm,
                                            stage_weights)


def moe(cfg, p, v, P: _Products):
    """``MoE(v) + Shared(v)`` of the module docstring, on ``v`` (b, T, d)
    and one expert layer's weights ``p`` (by their last names)."""
    b, T, d = v.shape
    flat = v.reshape(b * T, d)
    top, idx = P.mm(flat, p["router"]).topk(cfg["num_experts_per_tok"], -1)
    gate = torch.softmax(top, -1)
    first = cfg["experts_first"]
    out = torch.zeros_like(flat)
    for j in range(p["w_gate"].shape[0]):
        hit = idx == first + j               # at most one choice a token
        rows = hit.any(-1).nonzero().squeeze(1)
        if len(rows):
            g = (gate * hit)[rows].sum(-1)
            y = mlp({"w_gate": p["w_gate"][j], "w_up": p["w_up"][j],
                     "w_down": p["w_down"][j]}, flat[rows], P)
            out[rows] += y * g[:, None]
    shared = mlp({"w_gate": p["sh_gate"], "w_up": p["sh_up"],
                  "w_down": p["sh_down"]}, flat, P)
    return (out + shared).reshape(b, T, d)


@torch.no_grad()
def forward(cfg, w, tokens, cuts: Sequence[int] = (),
            bits: Sequence[Optional[int]] = (None,), link_quant: bool = True,
            keep: Optional[torch.Tensor] = None, precision: str = "float32",
            block: int = 1024):
    """As ``granite_hybrid.forward``: the top-1 at every position (B, T)
    and the logits at the flat positions ``keep`` (or None) of the forward
    partitioned by ``cuts`` with the platforms' widths ``bits``; each
    layer's MLP position holds its expert layer."""
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    L = cfg["num_hidden_layers"]
    plats = layout(L, cuts, bits)
    with precision_of(precision, tokens.device) as em:
        P = _Products(em)
        h = w["embed"][tokens] * cfg["embedding_multiplier"]
        for k, (first, last, width) in enumerate(plats):
            pos = range(max(first, 1), min(last, 2 * L) + 1)
            for p, unit in zip(pos, stage_weights(cfg, w, first, last,
                                                  width)):
                _, kind = _unit(cfg, p)
                x = rms_norm(h, unit["ln"], eps)
                if kind == "mlp":
                    y = moe(cfg, unit, x, P)
                elif kind == "attention":
                    y = attention(cfg, unit, x, P, block)
                else:
                    y = mamba(cfg, unit, x, P)
                h = h + r * y
            if k < len(plats) - 1 and link_quant and width is not None:
                h = fake_quant(h, width)
        b, T, d = h.shape
        flat = h.reshape(b * T, d)
        top1 = torch.empty(b * T, dtype=torch.long, device=h.device)
        kept = None if keep is None else h.new_empty(
            (len(keep), w["embed"].shape[0]))
        for s in range(0, b * T, block):
            logits = P.mm(rms_norm(flat[s:s + block], w["final_norm"], eps),
                          w["embed"].T) / cfg["logits_scaling"]
            top1[s:s + block] = logits.argmax(-1)
            if keep is not None:
                sel = (keep >= s) & (keep < s + block)
                kept[sel] = logits[keep[sel] - s]
    return top1.reshape(b, T), kept
