"""A plain IBM Granite 4.0-H forward (granite-4.0-h-micro, model type
``granitemoehybrid``, public ``config.json``), and its partitioned,
fake-quantized forward over a cut vector, in plain PyTorch: no kernel, no
cache, nothing of the program under test.

The configuration is a dict under the published ``config.json``'s keys:
``num_hidden_layers``, ``hidden_size``, ``intermediate_size``, ``layer_types``,
``num_attention_heads``, ``num_key_value_heads``, ``mamba_n_heads``,
``mamba_d_head``, ``mamba_d_state``, ``mamba_n_groups`` (1 here),
``mamba_d_conv``, ``mamba_chunk_size``, ``embedding_multiplier``,
``residual_multiplier``, ``logits_scaling``, ``attention_multiplier``,
``rms_norm_eps``; the embeddings are tied.  The weights are a dict of
tensors in (in, out) layouts (``x @ w``), named ``embed``, ``final_norm``,
``blocks.<l>.mix.ln``, ``blocks.<l>.mix.mixer.<w_in, conv_w, conv_b,
A_log, dt_bias, D, norm, w_out>`` for a Mamba2 layer or
``blocks.<l>.mix.mixer.<wq, wk, wv, wo>`` for an attention layer, and
``blocks.<l>.ffn.ln``, ``blocks.<l>.ffn.mlp.<w_gate, w_up, w_down>``.

With e, r, s the embedding, residual and logits multipliers, every RMSNorm
at ``rms_norm_eps``::

    h = e · E[tokens]
    for l in 0 .. L-1:
        u = RMSNorm(h)
        h = h + r · (Attn(u) if layer_types[l] == "attention" else Mamba2(u))
        v = RMSNorm(h)
        h = h + r · W_down(silu(v W_gate) ⊙ v W_up)
    logits = RMSNorm(h) Eᵀ / s
    Attn(u):   q = u W_q, k = u W_k, v = u W_v, no positional encoding;
               causal softmax(q kᵀ · attention_multiplier) v, each KV head
               shared by its group of query heads; then W_o
    Mamba2(u): [z | xBC | dt] = u W_in; xBC = silu(causal depthwise
               conv(xBC) + b_conv) -> x (heads × head dim), B, C;
               dt = softplus(dt + dt_bias); A = -exp(A_log);
               y = SSD(x, dt, A, B, C) + D ⊙ x, the state-space recurrence
               h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_tᵀ, y_t = h_t C_t,
               here in its chunked quadratic form;
               out = RMSNorm(y ⊙ silu(z)) W_out

The multipliers sit where the public ``transformers`` ``GraniteMoeHybrid``
model puts them (recalled, not read here).  Departures from the published
model: float32 weights and activations in place of bfloat16; attention and
the head computed in blocks of positions (the same sums, in less memory);
prefill only, no cache.

A cut vector holds positions of the model's chain (0 the embedding, 1 + 2l
layer l's mixer, 2 + 2l its MLP, 2L + 1 the head; -1 before the first):
platform k holds the positions ``cuts[k-1] + 1 .. cuts[k]``, and a
platform that holds nothing drops out with its width.  A platform with a
width runs its units on weights fake-quantized per tensor (symmetric,
from the min and max): each weight stacked over the platform's units of
one kind (Mamba2 mixers, attention mixers, MLPs) and quantized whole, the
stacked one-dimensional weights too; the embedding and the head stay
float.  With link quantization the activation leaving a platform for the
next is fake-quantized the same way at the producer's width.

``precision``: ``"float32"`` (products with TF32 off, as the configuration
states) or ``"tf32"`` (TF32 products: cuBLAS's own on a card, emulated on
the CPU by rounding the products' operands to TF32's 10-bit mantissa).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest with
    ties away from zero."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def precision_of(precision: str, device: torch.device):
    """Products in float32 with TF32 off, or in TF32; yields whether TF32
    has to be emulated (on the CPU)."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield on and device.type != "cuda"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


class _Products:
    """Matrix products, with the operands rounded to TF32 when emulated."""

    def __init__(self, emulate: bool):
        self.em = emulate

    def _r(self, t):
        return round_tf32(t) if self.em else t

    def mm(self, a, b):
        return self._r(a) @ self._r(b)

    def ein(self, eq, *ops):
        return torch.einsum(eq, *(self._r(o) for o in ops))


def fake_quant(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric per-tensor quantize then dequantize; the result formed as
    x + (dq - x), the value the straight-through form gives in float."""
    qmax = 2 ** (bits - 1) - 1
    amax = torch.maximum(x.min().abs(), x.max().abs())
    scale = torch.clamp_min(amax / qmax, 1e-12)
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax)
    return x + (q * scale - x)


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def layout(n_layers: int, cuts: Sequence[int],
           bits: Sequence[Optional[int]]) -> List[Tuple[int, int, object]]:
    """(first, last, width) of each platform that holds a position."""
    head = 2 * n_layers + 1
    bounds = [-1] + [int(c) for c in cuts] + [head]
    return [(bounds[k] + 1, bounds[k + 1], bits[k])
            for k in range(len(bits)) if bounds[k + 1] > bounds[k]]


def _unit(cfg, pos: int) -> Tuple[str, str]:
    """(weight-name prefix, kind) of the chain position ``pos``."""
    layer, mlp = divmod(pos - 1, 2)
    if mlp:
        return f"blocks.{layer}.ffn.", "mlp"
    return f"blocks.{layer}.mix.", cfg["layer_types"][layer]


def stage_weights(cfg, w, first: int, last: int, bits) -> List[Dict]:
    """Each unit's weights (by their last name: ``ln``, ``w_in``, ...) of
    the positions
    ``first .. last``; quantized as the module docstring says when
    ``bits`` is given."""
    n = 2 * cfg["num_hidden_layers"]
    units = [_unit(cfg, p) for p in range(max(first, 1), min(last, n) + 1)]
    out = [{n.rsplit(".", 1)[1]: t for n, t in w.items()
            if n.startswith(pre)} for pre, _ in units]
    if bits is None:
        return out
    for kind in {k for _, k in units}:
        idx = [i for i, (_, k) in enumerate(units) if k == kind]
        for name in list(out[idx[0]]):
            q = fake_quant(torch.stack([out[i][name] for i in idx]), bits)
            for i, t in zip(idx, q.unbind(0)):
                out[i][name] = t
    return out


def ssd(x, dt, A, Bm, Cm, chunk: int, P: _Products):
    """The SSD recurrence over the whole sequence, in its chunked quadratic
    form: x (b, T, h, p), dt (b, T, h), A (h,), B, C (b, T, n)."""
    b, T, h, p = x.shape
    n = Bm.shape[-1]
    pad = (-T) % chunk
    if pad:
        x, dt, Bm, Cm = (torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])],
                                   1) for t in (x, dt, Bm, Cm))
    Z = x.shape[1] // chunk
    xc = x.reshape(b, Z, chunk, h, p)
    dtc = dt.reshape(b, Z, chunk, h)
    Bc, Cc = Bm.reshape(b, Z, chunk, n), Cm.reshape(b, Z, chunk, n)
    cs = torch.cumsum(dtc * A, dim=2)                       # (b, Z, c, h)
    xdt = xc * dtc[..., None]
    # within a chunk: sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]      # (b, Z, i, j, h)
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()
    decay = torch.exp(torch.where(causal[:, :, None], seg, float("-inf")))
    del seg
    mix = P.ein("bzin,bzjn->bzij", Cc, Bc)[..., None] * decay
    del decay
    y = P.ein("bzijh,bzjhp->bzihp", mix, xdt)
    del mix
    # each chunk's own state, then the states carried into each chunk
    to_end = torch.exp(cs[:, :, -1:, :] - cs)
    S = P.ein("bzjn,bzjhp->bzhpn", Bc, xdt * to_end[..., None])
    state = x.new_zeros((b, h, p, n))
    before = []
    for z in range(Z):
        before.append(state)
        state = state * torch.exp(cs[:, z, -1, :])[..., None, None] + S[:, z]
    y = y + P.ein("bzin,bzhpn->bzihp", Cc, torch.stack(before, 1)) * \
        torch.exp(cs)[..., None]
    return y.reshape(b, Z * chunk, h, p)[:, :T]


def mamba(cfg, p, u, P: _Products):
    b, T, _ = u.shape
    H, hd = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    n, k = cfg["mamba_d_state"], cfg["mamba_d_conv"]
    di = H * hd
    proj = P.mm(u, p["w_in"])
    z, xBC, dt = proj[..., :di], proj[..., di:2 * di + 2 * n], \
        proj[..., 2 * di + 2 * n:]
    xpad = torch.cat([xBC.new_zeros((b, k - 1, xBC.shape[-1])), xBC], 1)
    conv = p["conv_w"][0] * xpad[:, 0:T]
    for i in range(1, k):
        conv = conv + p["conv_w"][i] * xpad[:, i:i + T]
    xBC = F.silu(conv + p["conv_b"])
    x = xBC[..., :di].reshape(b, T, H, hd)
    Bm, Cm = xBC[..., di:di + n], xBC[..., di + n:]
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = ssd(x, dt, A, Bm, Cm, cfg["mamba_chunk_size"], P)
    y = (y + x * p["D"][:, None]).reshape(b, T, di)
    y = rms_norm(y * F.silu(z), p["norm"], cfg["rms_norm_eps"])
    return P.mm(y, p["w_out"])


def attention(cfg, p, u, P: _Products, block: int):
    b, T, _ = u.shape
    H, Kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // H
    q = P.mm(u, p["wq"]).reshape(b, T, Kv, H // Kv, hd)
    k = P.mm(u, p["wk"]).reshape(b, T, Kv, hd)
    v = P.mm(u, p["wv"]).reshape(b, T, Kv, hd)
    out = u.new_empty((b, T, Kv, H // Kv, hd))
    pos = torch.arange(T, device=u.device)
    for s in range(0, T, block):
        e = min(T, s + block)
        sc = P.ein("bikgd,bjkd->bkgij", q[:, s:e], k[:, :e]) * \
            cfg["attention_multiplier"]
        sc = torch.where(pos[:e][None] <= pos[s:e][:, None], sc,
                         float("-inf"))
        out[:, s:e] = P.ein("bkgij,bjkd->bikgd", torch.softmax(sc, -1),
                            v[:, :e])
    return P.mm(out.reshape(b, T, H * hd), p["wo"])


def mlp(p, v, P: _Products):
    return P.mm(F.silu(P.mm(v, p["w_gate"])) * P.mm(v, p["w_up"]),
                p["w_down"])


@torch.no_grad()
def forward(cfg, w, tokens, cuts: Sequence[int] = (),
            bits: Sequence[Optional[int]] = (None,), link_quant: bool = True,
            keep: Optional[torch.Tensor] = None, precision: str = "float32",
            block: int = 1024):
    """The top-1 at every position (B, T) and, at the flat positions
    ``keep`` (of the B x T), the logits (or None), of the forward
    partitioned by ``cuts`` with the platforms' widths ``bits`` (None: a
    float platform).  Without cuts: the float model."""
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
                    y = mlp(unit, x, P)
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
