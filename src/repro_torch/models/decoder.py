"""Decoder-only LM, dense family (the JAX package's ``repro.models.decoder``).

The reference stacks its layers' parameters and runs them under
``lax.scan``; here the blocks are an ``nn.ModuleList`` walked by a loop
(:func:`run_blocks`), every weight in the reference's (in, out) layout
(``x @ w``), so weights carry over by copying (``models.convert``) and a
pipeline stage is ``blocks[a:b]``.

API, against the reference's:

=====================================  =====================================
reference (``params`` explicit)        port (weights held by the module)
=====================================  =====================================
``init(key)``                          ``DecoderLM(cfg, device=, generator=)``
``apply(params, state, batch)``        ``model(batch, impl=)`` -> logits
``init_caches(b, capacity, dtype)``    ``init_caches(b, capacity, dtype)``
``decode_step(params, caches, batch)`` ``decode_step(caches, batch, impl=)``
``to_graph(seq)``                      ``to_graph(seq)`` (config only)
=====================================  =====================================

Caches keep the reference's stacked layout, ``{"dense": {"k": (L, B, S,
Kv, hd), "v": ..., "pos": (L,)}}``, and are written in place.  Lane caches
(``stacked_caches(..., lanes=True)``) give every batch row its own write
position, ``pos`` (L, B): the reference's per-slot batch-1 caches under
``jax.vmap``, as one batch.  Only the dense family is carried here
(``cfg.family == "dense"``, no MLA; the ssm and hybrid families are
``models.ssm_lm.SSMLM``); the graph
(:func:`lm_graph`) covers every family the reference's ``DecoderLM`` does,
since it needs the configuration only.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import layers as GL
from repro_torch.core.graph import LayerGraph
from repro_torch.nn.attention import GQAAttention
from repro_torch.nn.layers import rms_norm
from repro_torch.nn.module import constant, normal_init

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def unsupported(cfg: ModelConfig) -> Optional[str]:
    """Why this port cannot build ``cfg``'s weights yet (the ``ROADMAP.md``
    item that brings it), or None for a decoder it can build."""
    if cfg.use_mla:
        return "MLA attention comes with ROADMAP.md C7"
    if cfg.family == "moe":
        return "MoE feed-forward blocks come with ROADMAP.md C8"
    if cfg.family == "audio":
        return "the audio (multi-codebook) family comes with ROADMAP.md C9"
    if cfg.family == "vlm":
        return "the vlm family (M-RoPE, vision projector) comes with ROADMAP.md C10"
    return None


def gated_mlp(params: Mapping[str, torch.Tensor], x: torch.Tensor):
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


def gated_mlp_init(d: int, ff: int, **init) -> nn.ParameterDict:
    """The gated MLP's weights (the reference's ``gated_mlp_init``);
    ``init``: ``generator``, ``device``, ``dtype`` of ``normal_init``."""
    return nn.ParameterDict({
        "w_gate": normal_init((d, ff), d ** -0.5, **init),
        "w_up": normal_init((d, ff), d ** -0.5, **init),
        "w_down": normal_init((ff, d), ff ** -0.5, **init)})


class DecoderBlock(nn.Module):
    """Pre-norm attention + gated-MLP block (the reference's dense kind)."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dt = _DTYPES[cfg.dtype]
        d, ff = cfg.d_model, cfg.d_ff
        self.ln1 = constant((d,), 1.0, device=device, dtype=dt)
        self.ln2 = constant((d,), 1.0, device=device, dtype=dt)
        self.attn = GQAAttention(
            d, cfg.n_heads, cfg.n_kv, cfg.resolved_head_dim,
            qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm, window=cfg.window,
            rope_theta=cfg.rope_theta, dtype=dt, device=device,
            generator=generator)
        self.mlp = gated_mlp_init(d, ff, generator=generator, device=device,
                                  dtype=dt)

    def forward(self, x, *, positions, cache=None, impl="ref"):
        a, new_cache = self.attn(rms_norm(x, self.ln1), positions=positions,
                                 cache=cache, impl=impl)
        x = x + a
        x = x + gated_mlp(self.mlp, rms_norm(x, self.ln2))
        return x, new_cache


def block_out(blk: nn.Module, x: torch.Tensor, **kw) -> torch.Tensor:
    """A block's output without its cache (what ``remat`` checkpoints)."""
    return blk(x, **kw)[0]


def remat_block(blk: nn.Module, x: torch.Tensor, **kw) -> torch.Tensor:
    """``block_out`` under ``torch.utils.checkpoint``: the block's
    activations are recomputed in the backward instead of kept (the
    reference's ``jax.checkpoint`` of its scan body)."""
    return checkpoint(block_out, blk, x, use_reentrant=False, **kw)


def run_blocks(blocks: Sequence[DecoderBlock], x: torch.Tensor,
               positions: torch.Tensor, caches: Optional[Dict] = None,
               impl: str = "ref", remat: bool = False):
    """Run ``x`` through ``blocks`` in order (the reference's
    ``_scan_blocks``).  ``caches``: stacked ``{"k", "v", "pos"}`` with a
    leading axis over these blocks, or None.  ``remat`` (no caches):
    checkpoint each block.  Returns ``(x, new_caches)``."""
    if caches is None:
        run = remat_block if remat else block_out
        for blk in blocks:
            x = run(blk, x, positions=positions, impl=impl)
        return x, None
    pos = []
    for i, blk in enumerate(blocks):
        layer = {"k": caches["k"][i], "v": caches["v"][i],
                 "pos": caches["pos"][i]}
        x, new = blk(x, positions=positions, cache=layer, impl=impl)
        pos.append(new["pos"])
    return x, {"k": caches["k"], "v": caches["v"], "pos": torch.stack(pos)}


def stacked_caches(cfg: ModelConfig, n_layers: int, batch_size: int,
                   capacity: int, dtype=torch.bfloat16, device=None,
                   lanes: bool = False) -> Dict:
    """Fresh stacked KV caches for ``n_layers`` blocks (``pos`` = 0); the
    capacity is capped at the window, as the reference's ``init_caches``.
    ``lanes``: one write position per batch row, ``pos`` (L, B)."""
    if cfg.window is not None:
        capacity = min(capacity, cfg.window)
    shape = (n_layers, batch_size, capacity, cfg.n_kv, cfg.resolved_head_dim)
    pos_shape = (n_layers, batch_size) if lanes else (n_layers,)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros(pos_shape, dtype=torch.int32, device=device)}


def step_positions(pos0: Optional[torch.Tensor], b: int, t: int,
                   device) -> torch.Tensor:
    """Positions (B, T) of ``t`` tokens appended at ``pos0``: a device
    scalar (the batch's write position), a (B,) tensor (each lane's), or
    None (from 0)."""
    positions = torch.arange(t, device=device)
    if pos0 is not None and pos0.dim():
        return pos0[:, None] + positions[None]
    if pos0 is not None:
        positions = positions + pos0
    return positions[None].expand(b, t)


class TokenLM(nn.Module):
    """What the port's LMs share: the token embedding ``embed`` (vocab, D),
    the ``final_norm`` and the tied or own ``head`` (D, vocab), which a
    subclass creates."""

    cfg: ModelConfig

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def embed_tokens(self, batch, pos0=None):
        """Token embeddings (B, T, D) and the batch's positions (B, T): when
        the batch has none, ``pos0 + arange(T)`` (``pos0`` a device scalar
        or one position per row of shape (B,), 0 when None)."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        x = F.embedding(tokens, self.embed)
        positions = batch.get("positions")
        if positions is None:
            positions = step_positions(pos0, *tokens.shape, self.device)
        return x, positions

    def head_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and the (tied or own) LM head."""
        x = rms_norm(x, self.final_norm)
        return x @ (self.embed.T if self.cfg.tied_embeddings else self.head)


class DecoderLM(TokenLM):
    """Dense decoder-only LM.  Weights are drawn from ``generator`` (a
    generator on ``device`` seeded 0 when None); on ``device="meta"``
    nothing is allocated.  Runs on the CUDA device unless the caller passes
    another ``device``."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family in ("ssm", "hybrid"):
            raise ValueError(f"{cfg.arch_id}: {cfg.family} models are built "
                             f"by models.ssm_lm.SSMLM")
        why = unsupported(cfg)
        if why:
            raise NotImplementedError(f"{cfg.arch_id}: {why}")
        from repro_torch.explore.runner import resolve_device
        device = resolve_device(device)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
        self.cfg = cfg
        dt = _DTYPES[cfg.dtype]
        init = dict(generator=generator, device=device, dtype=dt)
        self.embed = normal_init((cfg.vocab, cfg.d_model), 0.02, **init)
        self.final_norm = constant((cfg.d_model,), 1.0, device=device,
                                   dtype=dt)
        self.blocks = nn.ModuleList(
            DecoderBlock(cfg, device=device, generator=generator)
            for _ in range(cfg.n_layers))
        if not cfg.tied_embeddings:
            self.head = normal_init((cfg.d_model, cfg.vocab),
                                    cfg.d_model ** -0.5, **init)

    # -- forward ----------------------------------------------------------------
    def forward(self, batch, *, impl: str = "ref",
                train: bool = False) -> torch.Tensor:
        """Logits (B, T, vocab) of ``batch["tokens"]`` (the reference's
        ``apply``).  ``impl="cuda"``/``"auto"`` takes the sliding-window
        kernel in every block; ``train`` checkpoints every block when the
        config asks for ``remat``."""
        x, positions = self.embed_tokens(batch)
        x, _ = run_blocks(self.blocks, x, positions, impl=impl,
                          remat=train and self.cfg.remat)
        return self.head_logits(x)

    # -- serving ------------------------------------------------------------------
    def init_caches(self, batch_size: int, capacity: int,
                    dtype=torch.bfloat16, lanes: bool = False) -> Dict:
        """Fresh caches; ``lanes``: one write position per batch row."""
        return {"dense": stacked_caches(self.cfg, self.cfg.n_layers,
                                        batch_size, capacity, dtype,
                                        self.device, lanes)}

    def decode_step(self, caches, batch, *, impl: str = "ref"):
        """Append ``batch["tokens"]`` (B, T) to the caches and return
        ``(logits, new_caches)``.  Positions continue from the caches' write
        position (each lane's own with lane caches), which stays on the
        device (no host sync)."""
        x, positions = self.embed_tokens(batch, caches["dense"]["pos"][0])
        x, new = run_blocks(self.blocks, x, positions, caches=caches["dense"],
                            impl=impl)
        return self.head_logits(x), {"dense": new}

    # -- partitioner view ------------------------------------------------------------
    def to_graph(self, seq: int) -> LayerGraph:
        return lm_graph(self.cfg, seq)


def lm_graph(cfg: ModelConfig, seq: int) -> LayerGraph:
    """The partitioner's per-block layer graph of a decoder LM, from the
    configuration alone (no weights)."""
    g = LayerGraph(name=cfg.arch_id)
    prev = g.add(GL.embed_layer("Embed_0", cfg.vocab * max(cfg.n_codebooks, 1),
                                cfg.d_model, seq)).name
    for i in range(cfg.n_layers):
        kind = "moe" if (cfg.family == "moe" and i >= cfg.first_dense) else "dense"
        attn = GL.attention_layer(
            f"Attention_{i}", cfg.d_model, cfg.n_heads or 1,
            cfg.n_kv or 1, seq, cfg.resolved_head_dim,
            qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm, window=cfg.window)
        prev = g.add(attn, after=[prev]).name
        if kind == "moe":
            ffn = GL.moe_layer(f"MoE_{i}", cfg.d_model, cfg.moe_d_ff, seq,
                               cfg.n_experts, cfg.top_k, cfg.n_shared)
        else:
            ffn = GL.mlp_layer(f"Mlp_{i}", cfg.d_model, cfg.d_ff, seq)
        prev = g.add(ffn, after=[prev]).name
    g.add(GL.lm_head_layer("Head_0", cfg.d_model,
                           cfg.vocab * max(cfg.n_codebooks, 1), seq,
                           tied=cfg.tied_embeddings), after=[prev])
    return g
