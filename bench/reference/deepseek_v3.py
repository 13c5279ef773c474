"""A plain DeepSeek-V3 forward (model type ``deepseek_v3``, public
``config.json``) on one device's share of the routed experts, and its
partitioned, fake-quantized forward over a cut vector, in plain PyTorch:
no kernel, no cache, nothing of the program under test.

The configuration is a dict under the published ``config.json``'s keys
(``num_hidden_layers``, ``first_k_dense_replace``, ``hidden_size``,
``intermediate_size``, ``moe_intermediate_size``, ``num_attention_heads``,
``q_lora_rank``, ``kv_lora_rank``, ``qk_nope_head_dim``,
``qk_rope_head_dim``, ``v_head_dim``, ``rope_theta``, ``rope_scaling``,
``n_group``, ``topk_group``, ``num_experts_per_tok``,
``routed_scaling_factor``, ``n_shared_experts``, ``rms_norm_eps``), with
``experts_published`` (the router's outputs, the published
``n_routed_experts``), ``experts_first`` and ``n_routed_experts`` (the
experts this device holds) beside them.  The weights are a dict of
tensors in (in, out) layouts (``x @ w``): ``embed``, ``final_norm``,
``head``, ``blocks.<l>.ln1``, ``blocks.<l>.attn.<w_dq, q_norm, w_uq,
w_dkv, kv_norm, w_kr, w_uk, w_uv, wo>``, ``blocks.<l>.ln2`` and
``blocks.<l>.mlp.<w_gate, w_up, w_down>`` for a dense layer or
``blocks.<l>.moe.<router, router_bias, w_gate, w_up, w_down, sh_gate,
sh_up, sh_down>`` for an expert layer (the held experts' stacked (H, ...)).

Every RMSNorm at ``rms_norm_eps``, H heads, n = qk_nope_head_dim, r =
qk_rope_head_dim, v = v_head_dim::

    h = E[tokens]
    for l in 0 .. L-1:
        h = h + MLA(RMSNorm(h))
        u = RMSNorm(h)
        h = h + (W_down(silu(u W_gate) ⊙ u W_up)   if l < first_k_dense_replace
                 else MoE(u) + Shared(u))
    logits = RMSNorm(h) W_head
    MLA(x):    c_q = RMSNorm(x W_dq); [q_n | q_r] = c_q W_uq  (per head n, r)
               c_kv = RMSNorm(x W_dkv); k_r = x W_kr          (one for all heads)
               k_n = c_kv W_uk, v = c_kv W_uv                 (per head n, v)
               q_r, k_r rotated by YaRN's RoPE at positions 0 .. T-1;
               causal softmax((q_n k_nᵀ + q_r k_rᵀ) · s) v, then W_o
    YaRN:      f_i = θ^(-2i/r), i < r/2; d(ρ) = r ln(L₀ / (2π ρ)) / (2 ln θ)
               with L₀ = original_max_position_embeddings; lo = max(floor(
               d(beta_fast)), 0), hi = min(ceil(d(beta_slow)), r - 1);
               μ_i = 1 - clamp((i - lo) / (hi - lo), 0, 1);
               inv_freq_i = 1 / (factor θ^(2i/r)) · (1 - μ_i) + f_i · μ_i;
               cos, sin of (position · inv_freq) times m(factor, mscale) /
               m(factor, mscale_all_dim), m(f, μ) = 0.1 μ ln f + 1
    s:         (n + r)^-½ · m(factor, mscale_all_dim)²
    MoE(u):    σ = sigmoid(u W_router) over all ``experts_published``
               experts; c = σ + router_bias; the experts in n_group equal
               groups, a group's score the sum of its two best c; the best
               topk_group groups kept and the top ``num_experts_per_tok`` c
               within them chosen; the weight of a chosen expert its σ over
               the chosen σ's sum, × routed_scaling_factor; Σ over the
               chosen experts this device holds of weight ·
               W_down,e(silu(u W_gate,e) ⊙ u W_up,e).  Every choice is kept
               (dropless); a choice of an expert not held adds nothing, as
               on a device of an expert-parallel deployment before the
               exchange.
    Shared(u): W_down(silu(u W_gate) ⊙ u W_up), width n_shared_experts ×
               moe_intermediate_size

The equations of YaRN and the softmax scale are those of the published
checkpoint's ``modeling_deepseek.py``, and the ``noaux_tc`` route that of
DeepSeek's own inference code (the masked groups' experts at -inf before
the top-k), recalled without network.  Departures from the published
model: float32 weights and activations in place of FP8/bfloat16; the RoPE
pairs taken as the first and second halves of the rope dims (the
published checkpoint's layout is interleaved, a fixed permutation of the
same dims); attention and the head computed in blocks of positions (the
same sums, in less memory); prefill only, no cache; no
multi-token-prediction module.

``reorder``: the same equations in other float32 sums, as a valid
implementation may take them: YaRN's frequencies in the closed form
f_i (ρ_i / factor + 1 - ρ_i), ρ_i = 1 - μ_i (by default, the published
code's terms), attention over the causal triangle only, with each score's
non-rotary and rotary parts separate products (by default, every (query,
key) pair at n + r, the later keys masked).  The cell's limits are set
from the program against this order (PERF.md, section 4).

A cut vector holds positions of the model's chain (0 the embedding,
1 + 2l layer l's attention, 2 + 2l its MLP or expert layer, 2L + 1 the
head; -1 before the first): platform k holds the positions
``cuts[k-1] + 1 .. cuts[k]``, and a platform that holds nothing drops out
with its width.  A platform with a width runs its units on weights
fake-quantized per tensor (symmetric, from the min and max): each weight
stacked over the platform's units of one kind (attentions, dense MLPs,
expert layers) and quantized whole, the stacked one-dimensional weights
(norm scales, the correction bias) too; the embedding and the head stay
float.  With link quantization the activation leaving a platform for the
next is fake-quantized the same way at the producer's width.

``precision``: ``"float32"`` (products with TF32 off, as the configuration
states) or ``"tf32"`` (TF32 products, emulated on the CPU).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from bench.reference.granite_hybrid import (_Products, fake_quant, layout,
                                            mlp, precision_of, rms_norm)


def _unit(cfg, pos: int) -> Tuple[str, str, str]:
    """(norm name, weight prefix, kind) of the chain position ``pos``."""
    layer, ffn = divmod(pos - 1, 2)
    if not ffn:
        return f"blocks.{layer}.ln1", f"blocks.{layer}.attn.", "mla"
    if layer < cfg["first_k_dense_replace"]:
        return f"blocks.{layer}.ln2", f"blocks.{layer}.mlp.", "mlp"
    return f"blocks.{layer}.ln2", f"blocks.{layer}.moe.", "moe"


def stage_weights(cfg, w, first: int, last: int, bits) -> List[Dict]:
    """Each unit's weights of the positions ``first .. last`` by their last
    name (the norm as ``ln``), quantized as the module docstring says when
    ``bits`` is given."""
    n = 2 * cfg["num_hidden_layers"]
    units = [_unit(cfg, p) for p in range(max(first, 1), min(last, n) + 1)]
    out = []
    for ln, pre, _ in units:
        d = {"ln": w[ln]}
        d.update((k[len(pre):], t) for k, t in w.items()
                 if k.startswith(pre))
        out.append(d)
    if bits is None:
        return out
    for kind in {k for _, _, k in units}:
        idx = [i for i, u in enumerate(units) if u[2] == kind]
        for name in list(out[idx[0]]):
            q = fake_quant(torch.stack([out[i][name] for i in idx]), bits)
            for i, t in zip(idx, q.unbind(0)):
                out[i][name] = t
    return out


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_cos_sin(cfg, T: int, device, reorder: bool = False):
    """YaRN's cos and sin (T, r/2) at positions 0 .. T-1 (``reorder``: the
    frequencies in the closed form)."""
    rs = cfg["rope_scaling"]
    r, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    L0, factor = rs["original_max_position_embeddings"], rs["factor"]

    def dim_of(rot):
        return r * math.log(L0 / (rot * 2 * math.pi)) / (2 * math.log(base))
    lo = max(math.floor(dim_of(rs["beta_fast"])), 0)
    hi = min(math.ceil(dim_of(rs["beta_slow"])), r - 1)
    if lo == hi:
        hi += 0.001
    i = torch.arange(0, r, 2, dtype=torch.float32, device=device)
    extra = 1.0 / base ** (i / r)
    inter = 1.0 / (factor * base ** (i / r))
    mask = 1.0 - ((torch.arange(r // 2, dtype=torch.float32, device=device)
                   - lo) / (hi - lo)).clamp(0, 1)
    inv_freq = inter * (1 - mask) + extra * mask
    if reorder:
        inv_freq = extra * ((1 - mask) / factor + mask)
    ang = torch.outer(torch.arange(T, dtype=torch.float32, device=device),
                      inv_freq)
    m = (yarn_mscale(factor, rs["mscale"])
         / yarn_mscale(factor, rs["mscale_all_dim"]))
    return torch.cos(ang) * m, torch.sin(ang) * m


def rotate(x, cos, sin):
    """x (b, T, heads, r) rotated: its first and second halves paired."""
    a, b = x[..., :x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    c, s = cos[None, :, None], sin[None, :, None]
    return torch.cat([a * c - b * s, b * c + a * s], -1)


def softmax_scale(cfg) -> float:
    rs = cfg["rope_scaling"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return qk ** -0.5 * yarn_mscale(rs["factor"], rs["mscale_all_dim"]) ** 2


def mla(cfg, p, x, P: _Products, block: int, reorder: bool = False):
    """``MLA(x)`` of the module docstring on ``x`` (b, T, d): the scores
    of ``block`` queries at a time against every position, the later ones
    masked (``reorder``: against the keys up to the block's last, each
    score's non-rotary part per head and rotary part against the one
    rotary key all heads share as two products)."""
    b, T, _ = x.shape
    H, n = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    r, v_dim, eps = cfg["qk_rope_head_dim"], cfg["v_head_dim"], \
        cfg["rms_norm_eps"]
    q = P.mm(rms_norm(P.mm(x, p["w_dq"]), p["q_norm"], eps),
             p["w_uq"]).reshape(b, T, H, n + r)
    ckv = rms_norm(P.mm(x, p["w_dkv"]), p["kv_norm"], eps)
    cos, sin = yarn_cos_sin(cfg, T, x.device, reorder)
    q = torch.cat([q[..., :n], rotate(q[..., n:], cos, sin)], -1)
    k_r = rotate(P.mm(x, p["w_kr"])[:, :, None], cos, sin)
    k_n = P.mm(ckv, p["w_uk"]).reshape(b, T, H, n)
    v = P.mm(ckv, p["w_uv"]).reshape(b, T, H, v_dim)
    s = softmax_scale(cfg)
    if reorder:
        return P.mm(_triangle(q, k_n, k_r[:, :, 0], v, s, block, P)
                    .reshape(b, T, H * v_dim), p["wo"])
    k = torch.cat([k_n, k_r.expand(b, T, H, r)], -1)
    block = T if T % block else block
    out = x.new_empty((b, T, H, v_dim))
    pos = torch.arange(T, device=x.device)
    for q0 in range(0, T, block):
        q_blk = q[:, q0:q0 + block].reshape(b, block, H, 1, n + r)
        sc = P.ein("bckgh,bskh->bkgcs", q_blk, k) * s
        sc.masked_fill_(pos[None] > pos[q0:q0 + block, None],
                        float("-inf"))
        o = P.ein("bkgcs,bskh->bckgh", torch.softmax(sc, -1), v)
        out[:, q0:q0 + block] = o.reshape(b, block, H, v_dim)
        del sc
    return P.mm(out.reshape(b, T, H * v_dim), p["wo"])


def _triangle(q, k_n, k_r, v, s: float, block: int, P: _Products):
    """The reordered attention of :func:`mla`: ``q`` (b, T, H, n + r),
    ``k_n`` (b, T, H, n), the shared ``k_r`` (b, T, r), ``v`` (b, T, H,
    v); ``block`` queries at a time (the last block shorter)."""
    b, T, H, n = k_n.shape
    out = q.new_empty((b, T, H, v.shape[-1]))
    for q0 in range(0, T, block):
        q1 = min(q0 + block, T)
        sc = (P.ein("bchn,bshn->bhcs", q[:, q0:q1, :, :n], k_n[:, :q1])
              + P.ein("bchr,bsr->bhcs", q[:, q0:q1, :, n:], k_r[:, :q1])
              ) * s
        later = (torch.arange(q1, device=q.device)[None]
                 > torch.arange(q0, q1, device=q.device)[:, None])
        sc.masked_fill_(later, float("-inf"))
        out[:, q0:q1] = P.ein("bhcs,bshv->bchv", torch.softmax(sc, -1),
                              v[:, :q1])
        del sc
    return out


def route(cfg, p, u, P: _Products):
    """The chosen experts (N, k) and their weights (N, k) of the rows ``u``
    (N, d), by the ``noaux_tc`` route of the module docstring."""
    sig = torch.sigmoid(P.mm(u, p["router"]))              # (N, E)
    c = sig + p["router_bias"]
    N, E = c.shape
    G = cfg["n_group"]
    best2 = c.reshape(N, G, E // G).sort(-1, descending=True).values
    group_score = best2[..., 0] + best2[..., 1]
    order = group_score.argsort(-1, descending=True)
    kept = torch.zeros((N, G), dtype=torch.bool, device=u.device)
    kept.scatter_(1, order[:, :cfg["topk_group"]], True)
    c = torch.where(kept.repeat_interleave(E // G, 1), c, float("-inf"))
    idx = c.argsort(-1, descending=True)[:, :cfg["num_experts_per_tok"]]
    chosen = sig.gather(1, idx)
    return idx, chosen / chosen.sum(-1, keepdim=True) * \
        cfg["routed_scaling_factor"]


def moe(cfg, p, u, P: _Products):
    """``MoE(u) + Shared(u)`` of the module docstring on ``u`` (b, T, d)."""
    b, T, d = u.shape
    flat = u.reshape(b * T, d)
    idx, weight = route(cfg, p, flat, P)
    first = cfg["experts_first"]
    out = torch.zeros_like(flat)
    for j in range(p["w_gate"].shape[0]):
        hit = idx == first + j               # at most one choice a row
        rows = hit.any(-1).nonzero().squeeze(1)
        if len(rows):
            g = (weight * hit)[rows].sum(-1)
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
            block: int = 512, reorder: bool = False):
    """The top-1 at every position (B, T) and, at the flat positions
    ``keep`` (of the B x T), the logits (or None), of the forward
    partitioned by ``cuts`` with the platforms' widths ``bits`` (None: a
    float platform).  Without cuts: the float model.  Attention takes
    ``block`` queries at a time (all T where ``block`` does not divide T),
    the head ``2 * block`` positions.  ``reorder``: the module
    docstring's other float32 sums."""
    eps = cfg["rms_norm_eps"]
    L = cfg["num_hidden_layers"]
    plats = layout(L, cuts, bits)
    with precision_of(precision, tokens.device) as em:
        P = _Products(em)
        h = w["embed"][tokens]
        for k, (first, last, width) in enumerate(plats):
            pos = range(max(first, 1), min(last, 2 * L) + 1)
            for p, unit in zip(pos, stage_weights(cfg, w, first, last,
                                                  width)):
                kind = _unit(cfg, p)[2]
                x = rms_norm(h, unit["ln"], eps)
                if kind == "mla":
                    y = mla(cfg, unit, x, P, block, reorder)
                elif kind == "mlp":
                    y = mlp(unit, x, P)
                else:
                    y = moe(cfg, unit, x, P)
                h = h + y
            if k < len(plats) - 1 and link_quant and width is not None:
                h = fake_quant(h, width)
        b, T, d = h.shape
        flat = h.reshape(b * T, d)
        top1 = torch.empty(b * T, dtype=torch.long, device=h.device)
        kept = None if keep is None else h.new_empty(
            (len(keep), w["head"].shape[1]))
        for s in range(0, b * T, 2 * block):
            logits = P.mm(rms_norm(flat[s:s + 2 * block], w["final_norm"],
                                   eps), w["head"])
            top1[s:s + 2 * block] = logits.argmax(-1)
            if keep is not None:
                sel = (keep >= s) & (keep < s + 2 * block)
                kept[sel] = logits[keep[sel] - s]
    return top1.reshape(b, T), kept
