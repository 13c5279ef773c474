"""What the granite cells share: the configuration file read as the
port's ``ModelConfig``, the weights' leaves, the inputs drawn from the
seed, and the work a partitioned forward needs, counted from the shapes.

The configuration file holds the published ``config.json``'s keys (IBM
Granite 4.0-H).  Leaves are named as the port names its parameters
(``blocks.<l>.mix.mixer.w_in``, ...), so that ``bench/lib/weights.py``
draws them and the program and the plain reference
(``bench/reference/granite_hybrid.py``) each take them by name.

Work is counted once: a product 2 x its multiply-adds; the SSD scan's
products as the chunked algorithm needs them (C.Bᵀ on and below each
chunk's diagonal, the intra-chunk and inter-chunk outputs, the chunk
states, the carried states' update), its bytes each input read once and
each output written once; causal attention's qkᵀ and pv on and below the
diagonal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch

from bench.lib import seeds
from bench.lib.weights import Leaf


def port_config(config: dict):
    """The port's ``ModelConfig`` of the configuration file: the registry's
    configuration of ``config["model"]["name"]`` with the file's widths
    (a tiny file gives a tiny model).  Raises on a program that does not
    know the model, and on widths the port's mixer cannot take."""
    from repro_torch.models.registry import get_config
    c = config
    heads = c["mamba_expand"] * c["hidden_size"] // c["mamba_d_head"]
    if (c["mamba_n_groups"], c["mamba_d_conv"], c["mamba_n_heads"],
            c["mamba_conv_bias"]) != (1, 4, heads, True):
        raise ValueError("the port's Mamba2 mixer takes one group, a "
                         "convolution of 4 with bias and expand x hidden / "
                         "head dim heads")
    return dataclasses.replace(
        get_config(c["model"]["name"]),
        n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        vocab=c["vocab_size"], n_heads=c["num_attention_heads"],
        n_kv=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        tied_embeddings=c["tie_word_embeddings"],
        ssm_state=c["mamba_d_state"], ssm_expand=c["mamba_expand"],
        ssm_headdim=c["mamba_d_head"], ssm_chunk=c["mamba_chunk_size"],
        layer_types=tuple(c["layer_types"]),
        embedding_multiplier=float(c["embedding_multiplier"]),
        residual_multiplier=float(c["residual_multiplier"]),
        logits_scaling=float(c["logits_scaling"]),
        attention_scale=float(c["attention_multiplier"]),
        rope=c["position_embedding_type"] != "nope",
        norm_eps=float(c["rms_norm_eps"]), dtype=c["dtype"])


def leaves(config: dict) -> List[Leaf]:
    """Every weight: projections N(0, 1/fan_in), the embedding N(0,
    0.02^2), the convolution N(0, 0.5^2) and its bias N(0, 0.1^2), norm
    scales and D U(0.5, 1.5), A_log U(0, ln 16), dt_bias U(ln(e^0.001 - 1),
    ln(e^0.1 - 1)): the ranges of a Mamba2 initialisation, with norm scales
    and D spread as a trained model's are."""
    c = config
    d, ff, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    H, hd, n = c["mamba_n_heads"], c["mamba_d_head"], c["mamba_d_state"]
    di, k = H * hd, c["mamba_d_conv"]
    qh, kv = c["num_attention_heads"], c["num_key_value_heads"]
    ahd = d // qh
    spread = (0.5, 1.5)
    out: List[Leaf] = [("embed", (V, d), "normal", 0.02)]
    for layer, kind in enumerate(c["layer_types"]):
        p = f"blocks.{layer}.mix."
        out.append((p + "ln", (d,), "uniform", spread))
        p += "mixer."
        if kind == "mamba":
            out += [(p + "w_in", (d, 2 * di + 2 * n + H), "normal",
                     d ** -0.5),
                    (p + "conv_w", (k, di + 2 * n), "normal", 0.5),
                    (p + "conv_b", (di + 2 * n,), "normal", 0.1),
                    (p + "A_log", (H,), "uniform", (0.0, math.log(16.0))),
                    (p + "dt_bias", (H,), "uniform",
                     (math.log(math.expm1(1e-3)), math.log(math.expm1(0.1)))),
                    (p + "D", (H,), "uniform", spread),
                    (p + "norm", (di,), "uniform", spread),
                    (p + "w_out", (di, d), "normal", di ** -0.5)]
        else:
            out += [(p + "wq", (d, qh * ahd), "normal", d ** -0.5),
                    (p + "wk", (d, kv * ahd), "normal", d ** -0.5),
                    (p + "wv", (d, kv * ahd), "normal", d ** -0.5),
                    (p + "wo", (qh * ahd, d), "normal", (qh * ahd) ** -0.5)]
        p = f"blocks.{layer}.ffn."
        out += [(p + "ln", (d,), "uniform", spread),
                (p + "mlp.w_gate", (d, ff), "normal", d ** -0.5),
                (p + "mlp.w_up", (d, ff), "normal", d ** -0.5),
                (p + "mlp.w_down", (ff, d), "normal", ff ** -0.5)]
    out.append(("final_norm", (d,), "uniform", spread))
    return out


def tokens(config: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """The evaluation sequences (B, T), ids uniform over the vocabulary."""
    g = torch.Generator(device=device)
    g.manual_seed(seeds.derive(seed, 29, bits=63))
    return torch.randint(0, config["vocab_size"],
                         (traffic["sequences"], traffic["tokens"]),
                         generator=g, device=device)


def kept_positions(traffic: dict, seed: int, device) -> torch.Tensor:
    """The flat positions (of the B x T) whose logits a check vector keeps."""
    n = traffic["sequences"] * traffic["tokens"]
    idx = seeds.rng(seed, 31).choice(n, traffic["kept_positions"],
                                     replace=False)
    return torch.as_tensor(sorted(int(i) for i in idx), device=device)


def check_indices(traffic: dict, seed: int) -> List[int]:
    """Which vectors of the window (0 the first) are check vectors."""
    idx = seeds.rng(seed, 37).choice(traffic["check_among"],
                                     traffic["check_vectors"], replace=False)
    return sorted(int(i) for i in idx)


# -- work ---------------------------------------------------------------------

def ssd_work(b: int, t: int, h: int, p: int, n: int,
             chunk: int) -> Dict[str, int]:
    """One SSD scan's operations and bytes (T padded to the chunk)."""
    nc = -(-t // chunk)
    tri = chunk * (chunk + 1) // 2
    macs = (b * nc * tri * n             # C.B^T on and below the diagonal
            + b * nc * h * tri * p       # intra-chunk outputs
            + b * nc * h * chunk * p * n   # chunk states
            + b * nc * h * chunk * p * n   # inter-chunk outputs
            + b * nc * h * p * n)          # carried states
    tp = nc * chunk
    n_bytes = 4 * (b * tp * h * p * 2     # x read, y written
                   + b * tp * h + h       # dt, A
                   + 2 * b * tp * n       # B, C
                   + b * h * p * n)       # final state
    return {"ops": 2 * macs, "bytes": n_bytes}


def forward_flops(config: dict, b: int, t: int) -> int:
    """The products of one forward of (b, t) tokens: the projections, the
    MLPs, the head, the SSD scans and causal attention."""
    c = config
    d, ff, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    H, hd, n = c["mamba_n_heads"], c["mamba_d_head"], c["mamba_d_state"]
    di = H * hd
    qh, kv = c["num_attention_heads"], c["num_key_value_heads"]
    ahd = d // qh
    tok = b * t
    macs = tok * d * V                                   # head
    flops = 0
    for kind in c["layer_types"]:
        macs += tok * 3 * d * ff                          # MLP
        if kind == "mamba":
            macs += tok * (d * (2 * di + 2 * n + H) + di * d)
            flops += ssd_work(b, t, H, hd, n, c["mamba_chunk_size"])["ops"]
        else:
            macs += tok * (d * (qh + 2 * kv) * ahd + qh * ahd * d)
            macs += 2 * b * qh * ahd * t * (t + 1) // 2   # qk^T and pv
    return 2 * macs + flops
