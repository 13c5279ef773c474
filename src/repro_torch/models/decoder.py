"""Decoder-only LM: the dense, moe, audio and vlm families (the JAX
package's ``repro.models.decoder``).

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
``apply(params, state, batch)``        ``model.forward_aux(batch, impl=,
                                       train=)`` -> ``(logits, aux)``;
                                       ``model(batch, ...)`` -> logits
``init_caches(b, capacity, dtype)``    ``init_caches(b, capacity, dtype)``
``decode_step(params, caches, batch)`` ``decode_step(caches, batch, impl=)``
``to_graph(seq)``                      ``to_graph(seq)`` (config only)
=====================================  =====================================

A moe model keeps the reference's two stacks in one list: ``blocks[:
first_dense]`` are dense blocks (the reference's ``blocks_dense``) and the
rest MoE blocks (``blocks_moe``); ``aux`` holds the MoE stack's
``lb_loss``, ``z_loss`` and ``dropped``, each the mean over its blocks.
With ``cfg.mtp`` (DeepSeek-V3) the ``mtp_block`` stack and ``mtp_proj``
give ``aux["mtp_logits"]`` when ``train`` is set.  ``cfg.use_mla`` puts
multi-head latent attention in every block (with ``cfg.rope_scaling``,
YaRN's).  With ``cfg.n_group`` the MoE blocks route by ``noaux_tc``,
dropless over ``cfg.experts_held`` (``nn.moe.MoEFFN``; their ``aux`` is
empty).

:meth:`DecoderLM.units` splits every block into an attention unit and an
FFN unit (:class:`AttnUnit`, kind ``"mla"`` or ``"attention"``;
:class:`FfnUnit`, kind ``"mlp"`` or ``"moe"``) on the block's own
parameters: the chain of the partitioner's graph, which the partitioned
runner cuts for the moe family (``serving.pipeline``).

Caches keep the reference's stacked layout, one entry a stack:
``{"dense": {"k": (L, B, S, Kv, hd), "v": ..., "pos": (L,)}, "moe":
...}``, MLA's ``{"ckv": (L, B, S, r), "kr": (L, B, S, rd), "pos": ...}``,
written in place.  Lane caches (``init_caches(..., lanes=True)``) give
every batch row its own write position, ``pos`` (L, B): the reference's
per-slot batch-1 caches under ``jax.vmap``, as one batch (and a MoE block
routes every lane as its own group, as there).  The ssm and hybrid
families are ``models.ssm_lm.SSMLM``.  The graph (:func:`lm_graph`)
needs the configuration only.

The audio family (MusicGen) embeds ``codes`` (B, K, T) of K codebooks:
the embedding has ``vocab * K`` rows, codebook k's codes offset by ``k *
vocab``, and the K embeddings summed; its head gives logits (B, T, K,
vocab).  The vlm family (Qwen2-VL) puts ``vision_embeds`` (B, P, D),
projected by ``vis_proj`` (D, D), before the text tokens' embeddings, with
M-RoPE positions ``positions3`` (3, B, P + T); positions of shape (B, T)
are stacked three times where the config has ``mrope_sections``
(:meth:`DecoderLM.embed_batch`).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.core import layers as GL
from repro_torch.core.graph import LayerGraph
from repro_torch.nn.attention import GQAAttention, MLAAttention, MLAConfig
from repro_torch.nn.layers import rms_norm
from repro_torch.nn.moe import MoEFFN
from repro_torch.nn.module import constant, normal_init
from repro_torch.nn.sharding import current_rules

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def mla_config(cfg: ModelConfig) -> MLAConfig:
    return MLAConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, q_lora_rank=cfg.q_lora_rank,
        kv_lora_rank=cfg.kv_lora_rank, qk_nope_dim=cfg.qk_nope_dim,
        qk_rope_dim=cfg.qk_rope_dim, v_head_dim=cfg.v_head_dim,
        rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
        rope_scaling=cfg.rope_scaling)


class DecoderBlock(nn.Module):
    """Pre-norm attention + FFN block.  ``kind``: ``"dense"`` (a gated MLP,
    ``mlp``) or ``"moe"`` (``moe``, a ``MoEFFN``); the attention is MLA
    when the config asks for it, else GQA."""

    def __init__(self, cfg: ModelConfig, kind: str = "dense", *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kind = kind
        self.eps = cfg.norm_eps
        dt = _DTYPES[cfg.dtype]
        d = cfg.d_model
        init = dict(dtype=dt, device=device, generator=generator)
        self.ln1 = constant((d,), 1.0, device=device, dtype=dt)
        self.ln2 = constant((d,), 1.0, device=device, dtype=dt)
        if cfg.use_mla:
            self.attn = MLAAttention(mla_config(cfg), **init)
        else:
            self.attn = GQAAttention(
                d, cfg.n_heads, cfg.n_kv, cfg.resolved_head_dim,
                qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
                window=cfg.window, rope_theta=cfg.rope_theta,
                mrope_sections=cfg.mrope_sections, rope=cfg.rope,
                scale=cfg.attention_scale, norm_eps=cfg.norm_eps, **init)
        if kind == "moe" and cfg.n_group:
            # the noaux_tc route, dropless over the held share
            self.moe = MoEFFN(d, cfg.moe_d_ff, cfg.n_experts, cfg.top_k,
                              cfg.n_shared, capacity_factor=None,
                              router_scale=cfg.routed_scaling_factor,
                              sigmoid_gate=True, held=cfg.experts_held,
                              n_group=cfg.n_group,
                              topk_group=cfg.topk_group, **init)
        elif kind == "moe":
            self.moe = MoEFFN(d, cfg.moe_d_ff, cfg.n_experts, cfg.top_k,
                              cfg.n_shared, sigmoid_gate=cfg.sigmoid_gate,
                              **init)
        else:
            self.mlp = gated_mlp_init(d, cfg.d_ff, generator=generator,
                                      device=device, dtype=dt)

    def forward(self, x, *, positions, cache=None, impl="ref"):
        """``(x, new_cache, aux)``: ``aux`` is the MoE FFN's (empty for a
        dense block).  A lane cache (``pos`` of shape (B,)) routes every
        row as its own group."""
        a, new_cache = self.attn(rms_norm(x, self.ln1, self.eps),
                                 positions=positions, cache=cache, impl=impl)
        x = x + a
        h = rms_norm(x, self.ln2, self.eps)
        if self.kind == "moe":
            lanes = cache is not None and cache["pos"].dim() > 0
            f, aux = self.moe(h, lanes=lanes)
            if self.moe.cap_f is None:
                aux = {}        # the dropless route's row count: no loss term
        else:
            f, aux = gated_mlp(self.mlp, h), {}
        return x + f, new_cache, aux


MOE_ROWS = "moe_rows"   # counters .held / .routed: the expert layers' rows


def count_moe_rows(obs, aux: Dict, tokens: int, k: int) -> None:
    """With ``obs`` switched on: ``aux["rows"]``, the rows a dropless
    expert layer's held experts computed, in ``moe_rows.held``, and the
    token-expert choices, ``tokens`` x top-``k``, in ``moe_rows.routed``."""
    if obs is not None and obs.enabled:
        obs.metrics.counter(f"{MOE_ROWS}.held").inc(aux["rows"])
        obs.metrics.counter(f"{MOE_ROWS}.routed").inc(tokens * k)


class AttnUnit(nn.Module):
    """``h + attn(RMSNorm(h))``: a decoder block's attention half on the
    block's own ``ln1`` and ``attn`` (no copies; ``ln`` and ``attn``
    here).  ``kind``: ``"mla"`` or ``"attention"`` (GQA).  Takes the
    keywords every chain unit takes, ``obs`` unread."""

    def __init__(self, blk: DecoderBlock):
        super().__init__()
        self.kind = ("mla" if isinstance(blk.attn, MLAAttention)
                     else "attention")
        self.eps = blk.eps
        self.ln = blk.ln1
        self.attn = blk.attn

    def forward(self, x, *, positions=None, impl="ref", obs=None):
        """``x`` (B, T, d) after the attention's residual branch, as
        :class:`DecoderBlock` computes it without a cache."""
        a, _ = self.attn(rms_norm(x, self.ln, self.eps), positions=positions,
                         impl=impl)
        return x + a


class FfnUnit(nn.Module):
    """``h + f(RMSNorm(h))``: a decoder block's FFN half on the block's own
    ``ln2`` and ``mlp`` (``kind`` ``"mlp"``) or ``moe`` (``"moe"``): no
    copies.  On the dropless route an ``obs`` switched on counts the held
    experts' rows (:func:`count_moe_rows`)."""

    def __init__(self, blk: DecoderBlock):
        super().__init__()
        self.kind = "moe" if blk.kind == "moe" else "mlp"
        self.eps = blk.eps
        self.ln = blk.ln2
        if self.kind == "moe":
            self.moe = blk.moe
        else:
            self.mlp = blk.mlp

    def forward(self, x, *, positions=None, impl="ref", obs=None):
        """``x`` (B, T, d) after the FFN's residual branch, as
        :class:`DecoderBlock` computes it."""
        h = rms_norm(x, self.ln, self.eps)
        if self.kind == "mlp":
            return x + gated_mlp(self.mlp, h)
        f, aux = self.moe(h)
        if self.moe.cap_f is None:
            count_moe_rows(obs, aux, x.shape[0] * x.shape[1], self.moe.k)
        return x + f


def block_out(blk: nn.Module, x: torch.Tensor, **kw) -> torch.Tensor:
    """A block's output without its cache (what ``remat`` checkpoints)."""
    return blk(x, **kw)[0]


def block_aux(blk: nn.Module, x: torch.Tensor, **kw):
    """A decoder block's output and aux, without its cache."""
    out = blk(x, **kw)
    return out[0], out[2]


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy == "dots"``: keep the
    matrix products' outputs, recompute the rest (the reference's
    ``jax.checkpoint_policies.checkpoint_dots``)."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_block(fn, blk: nn.Module, x: torch.Tensor, remat: bool, **kw):
    """``fn(blk, x, **kw)``; with ``remat`` under
    ``torch.utils.checkpoint``: the block's activations are recomputed in
    the backward instead of kept (the reference's ``jax.checkpoint`` of its
    scan body), all but the matrix products' outputs when the installed
    rules say ``remat_policy == "dots"`` (``--opt remat_dots``)."""
    if not remat:
        return fn(blk, x, **kw)
    policy = {}
    if current_rules().get("remat_policy") == "dots":
        policy["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return checkpoint(fn, blk, x, use_reentrant=False, **policy, **kw)


def mean_aux(auxes: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The blocks' aux terms, each the mean over the blocks that have it
    (the reference's mean over its scanned stack)."""
    auxes = [a for a in auxes if a]
    if not auxes:
        return {}
    return {k: torch.stack([a[k] for a in auxes]).mean() for k in auxes[0]}


def run_blocks(blocks: Sequence[DecoderBlock], x: torch.Tensor,
               positions: torch.Tensor, caches: Optional[Dict] = None,
               impl: str = "ref", remat: bool = False):
    """Run ``x`` through ``blocks`` in order (the reference's
    ``_scan_blocks``).  ``caches``: one stack's caches (``{"k", "v",
    "pos"}`` or MLA's ``{"ckv", "kr", "pos"}``) with a leading axis over
    these blocks, or None.  ``remat`` (no caches): checkpoint each block.
    Returns ``(x, new_caches, aux)``, ``aux`` the mean of the MoE blocks'
    aux terms (empty without MoE blocks)."""
    auxes = []
    if caches is None:
        for blk in blocks:
            x, aux = remat_block(block_aux, blk, x, remat,
                                 positions=positions, impl=impl)
            auxes.append(aux)
        return x, None, mean_aux(auxes)
    pos = []
    for i, blk in enumerate(blocks):
        layer = {k: v[i] for k, v in caches.items()}
        x, new, aux = blk(x, positions=positions, cache=layer, impl=impl)
        pos.append(new["pos"])
        auxes.append(aux)
    return x, {**caches, "pos": torch.stack(pos)}, mean_aux(auxes)


def stacked_caches(cfg: ModelConfig, n_layers: int, batch_size: int,
                   capacity: int, dtype=torch.bfloat16, device=None,
                   lanes: bool = False) -> Dict:
    """Fresh stacked caches for ``n_layers`` blocks (``pos`` = 0): KV
    caches, or MLA's latent caches when the config uses MLA; the capacity
    is capped at the window, as the reference's ``init_caches``.
    ``lanes``: one write position per batch row, ``pos`` (L, B)."""
    if cfg.window is not None:
        capacity = min(capacity, cfg.window)
    pos_shape = (n_layers, batch_size) if lanes else (n_layers,)
    pos = torch.zeros(pos_shape, dtype=torch.int32, device=device)
    lead = (n_layers, batch_size, capacity)
    if cfg.use_mla:
        return {"ckv": torch.zeros(lead + (cfg.kv_lora_rank,), dtype=dtype,
                                   device=device),
                "kr": torch.zeros(lead + (cfg.qk_rope_dim,), dtype=dtype,
                                  device=device), "pos": pos}
    shape = lead + (cfg.n_kv, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "pos": pos}


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

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """The (tied or own) LM head."""
        return x @ (self.embed.T if self.cfg.tied_embeddings else self.head)

    def head_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and the (tied or own) LM head."""
        return self.project(rms_norm(x, self.final_norm, self.cfg.norm_eps))

    def forward_aux(self, batch, *, impl: str = "ref", train: bool = False):
        """``(logits, aux)``, the reference's ``apply``: a model without aux
        terms gives ``{}``."""
        return self(batch, impl=impl, train=train), {}


class DecoderLM(TokenLM):
    """Decoder-only LM of the dense, moe, audio or vlm family.  Weights are
    drawn from ``generator`` (a generator on ``device`` seeded 0 when
    None); on ``device="meta"`` nothing is allocated.  Runs on the CUDA
    device unless the caller passes another ``device``."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family in ("ssm", "hybrid"):
            raise ValueError(f"{cfg.arch_id}: {cfg.family} models are built "
                             f"by models.ssm_lm.SSMLM")
        from repro_torch.explore.runner import resolve_device
        device = resolve_device(device)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
        self.cfg = cfg
        moe = cfg.family == "moe"
        self.n_dense = cfg.first_dense if moe else cfg.n_layers
        self.n_moe = cfg.n_layers - self.n_dense
        dt = _DTYPES[cfg.dtype]
        init = dict(generator=generator, device=device, dtype=dt)
        blk = dict(device=device, generator=generator)
        vocab_rows = cfg.vocab * max(cfg.n_codebooks, 1)
        self.embed = normal_init((vocab_rows, cfg.d_model), 0.02, **init)
        self.final_norm = constant((cfg.d_model,), 1.0, device=device,
                                   dtype=dt)
        self.blocks = nn.ModuleList(
            [DecoderBlock(cfg, "dense", **blk) for _ in range(self.n_dense)]
            + [DecoderBlock(cfg, "moe", **blk) for _ in range(self.n_moe)])
        if not cfg.tied_embeddings:
            self.head = normal_init((cfg.d_model, vocab_rows),
                                    cfg.d_model ** -0.5, **init)
        if cfg.family == "vlm":
            # the projector stub: frontend patch embeddings into d_model
            self.vis_proj = normal_init((cfg.d_model, cfg.d_model),
                                        cfg.d_model ** -0.5, **init)
        if cfg.mtp:
            self.mtp_block = nn.ModuleList(
                DecoderBlock(cfg, "dense", **blk) for _ in range(cfg.mtp))
            self.mtp_proj = normal_init((2 * cfg.d_model, cfg.d_model),
                                        (2 * cfg.d_model) ** -0.5, **init)

    def units(self) -> List[nn.Module]:
        """Each block's attention unit and FFN unit, in order, on the
        blocks' own parameters (:class:`AttnUnit`, :class:`FfnUnit`, made
        anew at each call): the graph's positions 1 .. 2L (position 0 the
        embedding, 2L + 1 the head), the partitioned runner's chain."""
        return [u for blk in self.blocks
                for u in (AttnUnit(blk), FfnUnit(blk))]

    def stacks(self) -> List[Tuple[str, Sequence[DecoderBlock]]]:
        """The reference's block stacks in order, by cache key: ``dense``
        (the first ``n_dense`` blocks) and ``moe`` (the rest), each where it
        has blocks."""
        out = [("dense", self.blocks[:self.n_dense]),
               ("moe", self.blocks[self.n_dense:])]
        return [(name, blocks) for name, blocks in out if len(blocks)]

    # -- embedding and head per family ----------------------------------------
    def embed_batch(self, batch, pos0=None):
        """The batch's input embeddings (B, T, D) and positions, by family
        (the reference's ``_embed``, with its positions filled in as its
        ``apply`` and ``decode_step`` fill them): audio sums the K
        codebooks' embeddings of ``codes`` (B, K, T); vlm with
        ``vision_embeds`` (B, P, D) puts them, projected by ``vis_proj``,
        before the tokens' embeddings and takes ``positions3``; otherwise
        ``positions3`` or ``positions``.  Missing positions are ``pos0 +
        arange(T)`` (``pos0`` as in :meth:`embed_tokens`), and (B, T)
        positions are stacked to (3, B, T) when the config has
        ``mrope_sections``."""
        cfg = self.cfg
        dev = self.device
        positions = None
        if cfg.family == "audio":
            codes = torch.as_tensor(batch["codes"], device=dev)  # (B, K, T)
            offs = torch.arange(cfg.n_codebooks, device=dev) * cfg.vocab
            x = F.embedding(codes + offs[None, :, None].to(codes.dtype),
                            self.embed).sum(dim=1)
        elif cfg.family == "vlm" and "vision_embeds" in batch:
            vis = torch.as_tensor(batch["vision_embeds"], device=dev)
            tokens = torch.as_tensor(batch["tokens"], device=dev)
            x = torch.cat([vis.to(self.embed.dtype) @ self.vis_proj,
                           F.embedding(tokens, self.embed)], dim=1)
            positions = batch.get("positions3")
        else:
            tokens = torch.as_tensor(batch["tokens"], device=dev)
            x = F.embedding(tokens, self.embed)
            positions = batch.get("positions3", batch.get("positions"))
        if positions is None:
            positions = step_positions(pos0, x.shape[0], x.shape[1], dev)
        else:
            positions = torch.as_tensor(positions, device=dev)
        if cfg.mrope_sections is not None and positions.dim() == 2:
            positions = torch.stack([positions] * 3)
        return x, positions

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """The (tied or own) LM head; the audio family's logits are (B, T,
        K, vocab)."""
        logits = super().project(x)
        if self.cfg.family == "audio":
            b, t, _ = logits.shape
            return logits.reshape(b, t, self.cfg.n_codebooks, self.cfg.vocab)
        return logits

    # -- forward ----------------------------------------------------------------
    def forward_aux(self, batch, *, impl: str = "ref", train: bool = False):
        """``(logits, aux)`` of the batch (the reference's ``apply``):
        logits (B, T, vocab), the audio family's (B, T, K, vocab), the vlm
        family's over its vision and text positions; ``aux`` the MoE
        stack's mean ``lb_loss``, ``z_loss`` and ``dropped``, and with
        ``train`` and ``cfg.mtp`` the multi-token-prediction logits
        ``mtp_logits``.
        ``impl="cuda"``/``"auto"`` takes the sliding-window kernel in every
        windowed block; ``train`` checkpoints every block when the config
        asks for ``remat``."""
        cfg = self.cfg
        emb, positions = self.embed_batch(batch)
        x, _, aux = run_blocks(self.blocks, emb, positions, impl=impl,
                               remat=train and cfg.remat)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        logits = self.project(x)
        if cfg.mtp and train:
            # multi-token prediction: one more dense stack over the final
            # hidden state and the next token's embedding
            h = torch.cat([x, torch.roll(emb, -1, dims=1)], dim=-1)
            h, _, _ = run_blocks(self.mtp_block, h @ self.mtp_proj,
                                 positions, impl=impl)
            aux = {**aux, "mtp_logits": self.head_logits(h)}
        return logits, aux

    def forward(self, batch, *, impl: str = "ref",
                train: bool = False) -> torch.Tensor:
        """The batch's logits (:meth:`forward_aux` without the aux)."""
        return self.forward_aux(batch, impl=impl, train=train)[0]

    # -- serving ------------------------------------------------------------------
    def init_caches(self, batch_size: int, capacity: int,
                    dtype=torch.bfloat16, lanes: bool = False) -> Dict:
        """Fresh caches, one entry a stack (``dense``, ``moe``); ``lanes``:
        one write position per batch row."""
        return {name: stacked_caches(self.cfg, len(blocks), batch_size,
                                     capacity, dtype, self.device, lanes)
                for name, blocks in self.stacks()}

    def decode_step(self, caches, batch, *, impl: str = "ref"):
        """Append the batch (``tokens`` (B, T); the audio family's
        ``codes`` (B, K, T); the vlm family's may hold ``vision_embeds``)
        to the caches and return ``(logits, new_caches)``.  Positions not
        in the batch continue from the first stack's write position (each
        lane's own with lane caches), which stays on the device (no host
        sync)."""
        first = caches["dense"] if "dense" in caches else caches["moe"]
        x, positions = self.embed_batch(batch, first["pos"][0])
        new = {}
        for name, blocks in self.stacks():
            x, new[name], _ = run_blocks(blocks, x, positions,
                                         caches=caches[name], impl=impl)
        return self.head_logits(x), new

    # -- partitioner view ------------------------------------------------------------
    def to_graph(self, seq: int) -> LayerGraph:
        """The partitioner's layer graph at ``seq`` tokens."""
        return lm_graph(self.cfg, seq)


def lm_graph(cfg: ModelConfig, seq: int) -> LayerGraph:
    """The partitioner's per-block layer graph of a decoder LM, from the
    configuration alone (no weights): ``Embed_0``, per layer
    ``Attention_l`` then ``Mlp_l`` or ``MoE_l``, ``Head_0``, the chain of
    :meth:`DecoderLM.units`.  With ``cfg.graph_mla`` an MLA layer is
    :func:`~repro_torch.core.layers.mla_layer`; without it the JAX
    package's count, which takes MLA for GQA.  An expert node counts the
    held share and the ``noaux_tc`` route's correction bias."""
    mla = cfg.use_mla and cfg.graph_mla
    held = None if cfg.experts_held is None else cfg.experts_held[1]
    g = LayerGraph(name=cfg.arch_id)
    prev = g.add(GL.embed_layer("Embed_0", cfg.vocab * max(cfg.n_codebooks, 1),
                                cfg.d_model, seq)).name
    for i in range(cfg.n_layers):
        kind = "moe" if (cfg.family == "moe" and i >= cfg.first_dense) else "dense"
        if mla:
            attn = GL.mla_layer(
                f"Attention_{i}", cfg.d_model, cfg.n_heads, seq,
                cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_nope_dim,
                cfg.qk_rope_dim, cfg.v_head_dim)
        else:
            attn = GL.attention_layer(
                f"Attention_{i}", cfg.d_model, cfg.n_heads or 1,
                cfg.n_kv or 1, seq, cfg.resolved_head_dim,
                qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
                window=cfg.window)
        prev = g.add(attn, after=[prev]).name
        if kind == "moe":
            ffn = GL.moe_layer(f"MoE_{i}", cfg.d_model, cfg.moe_d_ff, seq,
                               cfg.n_experts, cfg.top_k, cfg.n_shared,
                               held=held, router_bias=cfg.n_group > 0)
        else:
            ffn = GL.mlp_layer(f"Mlp_{i}", cfg.d_model, cfg.d_ff, seq)
        prev = g.add(ffn, after=[prev]).name
    g.add(GL.lm_head_layer("Head_0", cfg.d_model,
                           cfg.vocab * max(cfg.n_codebooks, 1), seq,
                           tied=cfg.tied_embeddings), after=[prev])
    return g
