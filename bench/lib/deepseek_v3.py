"""What the DeepSeek-V3 cell needs beside ``bench/lib/granite.py``'s inputs:
the configuration file read as the port's ``ModelConfig`` with its held
share of experts, the weights' leaves, and the work of a forward counted
with the rows its held experts compute.

The configuration file holds the published ``config.json``'s keys
(DeepSeek-V3), ``num_hidden_layers`` cut to the layers one pipeline group
holds and ``n_routed_experts`` to the experts one device holds, and beside
them ``experts_published`` (the router's outputs, the published count) and
``experts_first`` (the first expert held).  Leaves are named as the port
names its parameters (``blocks.<l>.attn.w_dq``, ``blocks.<l>.moe.router``,
...), so that ``bench/lib/weights.py`` draws them and the program and the
plain reference (``bench/reference/deepseek_v3.py``) each take them by
name.

Work is counted once: a product 2 x its multiply-adds; every projection
at every token; MLA's causal core, q kᵀ at qk_nope + qk_rope and p v at
v_head_dim, on and below the diagonal; the routers at every token; each
held expert's gated product at the rows routed to it; the shared expert at
every token; the head.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from bench.lib.weights import Leaf

SPREAD = (0.5, 1.5)      # norm scales, spread as a trained model's are
BIAS_STD = 0.1           # the routers' correction bias


def port_config(config: dict):
    """The port's ``ModelConfig`` of the configuration file: the registry's
    configuration of ``config["model"]["name"]`` with the file's widths,
    YaRN and route, the router over ``experts_published`` experts,
    ``n_routed_experts`` of them held from ``experts_first``.  Raises on a
    program that does not know the model, and on a file whose route,
    scaling or layers the port's model does not compute."""
    from repro_torch.configs.base import RopeScaling
    from repro_torch.models.registry import get_config
    c = config
    rs = c["rope_scaling"]
    if (c["topk_method"], c["scoring_func"], c["norm_topk_prob"],
            rs["type"], c["moe_layer_freq"], c["hidden_act"],
            c["attention_bias"], c["num_nextn_predict_layers"]) != (
            "noaux_tc", "sigmoid", True, "yarn", 1, "silu", False, 0):
        raise ValueError("the port computes the noaux_tc route of sigmoid "
                         "scores, renormalised, YaRN, an expert layer after "
                         "every dense one, silu, no attention bias and no "
                         "multi-token-prediction module on the scored "
                         "forward")
    return dataclasses.replace(
        get_config(c["model"]["name"]),
        n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        vocab=c["vocab_size"], n_heads=c["num_attention_heads"],
        n_kv=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        moe_d_ff=c["moe_intermediate_size"],
        n_experts=c["experts_published"], top_k=c["num_experts_per_tok"],
        n_shared=c["n_shared_experts"],
        first_dense=c["first_k_dense_replace"],
        q_lora_rank=c["q_lora_rank"], kv_lora_rank=c["kv_lora_rank"],
        qk_nope_dim=c["qk_nope_head_dim"], qk_rope_dim=c["qk_rope_head_dim"],
        v_head_dim=c["v_head_dim"], rope_theta=float(c["rope_theta"]),
        tied_embeddings=c["tie_word_embeddings"],
        norm_eps=float(c["rms_norm_eps"]), mtp=0, dtype=c["dtype"],
        rope_scaling=RopeScaling(
            factor=float(rs["factor"]),
            original_max_position_embeddings=rs[
                "original_max_position_embeddings"],
            beta_fast=float(rs["beta_fast"]), beta_slow=float(rs["beta_slow"]),
            mscale=float(rs["mscale"]),
            mscale_all_dim=float(rs["mscale_all_dim"])),
        n_group=c["n_group"], topk_group=c["topk_group"],
        routed_scaling_factor=float(c["routed_scaling_factor"]),
        experts_held=(c["experts_first"], c["n_routed_experts"]))


def _proj(name, fan_in, fan_out) -> Leaf:
    return (name, (fan_in, fan_out), "normal", fan_in ** -0.5)


def leaves(config: dict) -> List[Leaf]:
    """Every weight: projections N(0, 1/fan_in), the embedding N(0,
    0.02^2), norm scales U(0.5, 1.5), each router's correction bias N(0,
    0.1^2); an expert layer's held experts stacked (H, ...), its shared
    expert of n_shared_experts x moe_intermediate_size."""
    c = config
    d, V, H = c["hidden_size"], c["vocab_size"], c["num_attention_heads"]
    ql, kvl = c["q_lora_rank"], c["kv_lora_rank"]
    nope, rd, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                    c["v_head_dim"])
    ff, mff = c["intermediate_size"], c["moe_intermediate_size"]
    E, held = c["experts_published"], c["n_routed_experts"]
    sff = c["n_shared_experts"] * mff
    out: List[Leaf] = [("embed", (V, d), "normal", 0.02),
                       ("final_norm", (d,), "uniform", SPREAD),
                       _proj("head", d, V)]
    for layer in range(c["num_hidden_layers"]):
        p = f"blocks.{layer}."
        out += [(p + "ln1", (d,), "uniform", SPREAD),
                (p + "ln2", (d,), "uniform", SPREAD),
                _proj(p + "attn.w_dq", d, ql),
                (p + "attn.q_norm", (ql,), "uniform", SPREAD),
                _proj(p + "attn.w_uq", ql, H * (nope + rd)),
                _proj(p + "attn.w_dkv", d, kvl),
                (p + "attn.kv_norm", (kvl,), "uniform", SPREAD),
                _proj(p + "attn.w_kr", d, rd),
                _proj(p + "attn.w_uk", kvl, H * nope),
                _proj(p + "attn.w_uv", kvl, H * vd),
                _proj(p + "attn.wo", H * vd, d)]
        if layer < c["first_k_dense_replace"]:
            out += [_proj(p + "mlp.w_gate", d, ff), _proj(p + "mlp.w_up", d, ff),
                    _proj(p + "mlp.w_down", ff, d)]
            continue
        p += "moe."
        out += [_proj(p + "router", d, E),
                (p + "router_bias", (E,), "normal", BIAS_STD),
                (p + "w_gate", (held, d, mff), "normal", d ** -0.5),
                (p + "w_up", (held, d, mff), "normal", d ** -0.5),
                (p + "w_down", (held, mff, d), "normal", mff ** -0.5),
                _proj(p + "sh_gate", d, sff), _proj(p + "sh_up", d, sff),
                _proj(p + "sh_down", sff, d)]
    return out


def expected_rows(config: dict, b: int, t: int) -> float:
    """The rows the held experts compute in one forward under uniform
    routing: tokens x top-k x held / published, an expert layer."""
    c = config
    moe_layers = c["num_hidden_layers"] - c["first_k_dense_replace"]
    return (moe_layers * b * t * c["num_experts_per_tok"]
            * c["n_routed_experts"] / c["experts_published"])


def mla_macs(config: dict, b: int, t: int) -> dict:
    """One MLA layer's multiply-adds over (b, t) tokens: ``proj`` (the
    latent projections, decompressions and W_o at every token) and
    ``core`` (the causal q kᵀ and p v)."""
    c = config
    d, H = c["hidden_size"], c["num_attention_heads"]
    ql, kvl = c["q_lora_rank"], c["kv_lora_rank"]
    nope, rd, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                    c["v_head_dim"])
    per_token = (d * (ql + kvl + rd) + ql * H * (nope + rd)
                 + kvl * H * (nope + vd) + H * vd * d)
    return {"proj": b * t * per_token,
            "core": b * H * t * (t + 1) // 2 * (nope + rd + vd)}


def forward_flops(config: dict, b: int, t: int,
                  held_rows: Optional[float] = None) -> float:
    """The products of one forward of (b, t) tokens (the module
    docstring's count), the held experts' at ``held_rows`` rows (the rows
    the forward's expert layers computed; :func:`expected_rows` when
    None)."""
    c = config
    d, V = c["hidden_size"], c["vocab_size"]
    ff, mff = c["intermediate_size"], c["moe_intermediate_size"]
    L, dense = c["num_hidden_layers"], c["first_k_dense_replace"]
    tok = b * t
    rows = expected_rows(c, b, t) if held_rows is None else held_rows
    mla = mla_macs(c, b, t)
    macs = (L * (mla["proj"] + mla["core"])
            + dense * tok * 3 * d * ff
            + (L - dense) * tok * (d * c["experts_published"]
                                   + 3 * d * c["n_shared_experts"] * mff)
            + 3 * d * mff * rows
            + tok * d * V)
    return 2 * macs
