"""SSM and hybrid decoder LMs: Mamba2 (SSD) and the Zamba2-style hybrid
(the JAX package's ``repro.models.ssm_lm``), and the port's own ``mixed``
family (IBM Granite 4.0-H, :class:`MixedLM`).

Mamba2 LM: embed -> L x [norm -> Mamba2Mixer] -> norm -> (tied) head.

Hybrid (Zamba2): a Mamba2 backbone; after every ``attn_every`` Mamba blocks
one SHARED attention + MLP block runs, with the same parameters at every
application.  Its parameters exist once (``SSMLM.shared``); the memory model
sees them through :func:`shared_groups`.

As in ``models.decoder``, the reference's scans over stacked parameters
become a loop over an ``nn.ModuleList`` (``blocks[g * attn_every + j]`` is
the reference's ``blocks[g, j]``), and caches keep the reference's stacked
layout:

* ``ssm``: ``{"mamba": {"conv": (L, B, ck-1, ch), "ssm": (L, B, h, p, n),
  "pos": (L,)}}``;
* ``hybrid``: ``{"mamba": {... (G, E, ...)}, "attn": {"k": (G, B, S, Kv,
  hd), "v": ..., "pos": (G,)}}``, one KV cache per application of the
  shared block.

The SSM state and the convolution history are float32 whatever the
attention cache's dtype.  Caches are written in place.

Mixed (Granite 4.0-H; ``layer_types`` names each layer's mixer), with e
the ``embedding_multiplier``, r the ``residual_multiplier``, s the
``logits_scaling``, every RMSNorm at ``norm_eps``::

    h = e · E[tokens]
    for l in 0 .. L-1:
        h = h + r · (Attn(RMSNorm(h)) if layer_types[l] == "attention"
                     else Mamba2(RMSNorm(h)))                  # MixerUnit
        v = RMSNorm(h)
        h = h + r · W_down(silu(v W_gate) ⊙ v W_up)            # MlpUnit
          (with experts: h + r · (MoE(v) + Shared(v))          # MoeUnit)
    logits = RMSNorm(h) Eᵀ / s                  (the head, tied or own)
    Attn(u):   q = u W_q, k = u W_k, v = u W_v (GQA; RoPE unless
               ``rope`` is False); causal softmax(q kᵀ · attention_scale) v,
               then W_o
    Mamba2(u): [z | xBC | dt] = u W_in; xBC = silu(causal depthwise
               conv(xBC) + b_conv) -> x (heads × headdim), B, C (one group);
               dt = softplus(dt + dt_bias); A = -exp(A_log);
               y = SSD(x, dt, A, B, C; chunk) + D ⊙ x;
               out = RMSNorm(y ⊙ silu(z)) W_out
    MoE(v):    the top ``top_k`` of the router logits v W_r (all
               ``n_experts``), softmax over the chosen; the sum of each
               chosen held expert's W_down(silu(v W_gate) ⊙ v W_up) times
               its weight (dropless; a choice of an expert not held adds
               nothing, ``experts_held``)
    Shared(v): the shared gated MLP of width ``d_ff``

(the multipliers placed as the public ``transformers`` ``GraniteMoeHybrid``
model places them).  A layer's mixer and its MLP or expert layer are
modules of their own, ``blocks[l].mix`` and ``blocks[l].ffn``:
:meth:`MixedLM.units` lists them in the order of the partitioner's chain
(:func:`ssm_graph`: ``Embed_0``, per layer ``SSM_l`` or ``Attention_l``
then ``Mlp_l`` or ``Moe_l``, ``Head_0``), so that a stage can end between
a mixer and its MLP or expert layer.  On a CUDA tensor with
``impl`` ``"cuda"`` or ``"auto"`` every Mamba2 mixer of the cacheless
forward takes the SSD scan kernel, and the attention without a window
takes ``chunked_sdpa`` from 2048 tokens.  The family has no caches yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import layers as GL
from repro_torch.core.graph import LayerGraph
from repro_torch.models.decoder import (_DTYPES, TokenLM, block_out,
                                        count_moe_rows, gated_mlp,
                                        gated_mlp_init, remat_block)
from repro_torch.nn.attention import GQAAttention, init_cache
from repro_torch.nn.layers import rms_norm
from repro_torch.nn.module import constant, normal_init
from repro_torch.nn.moe import MoEFFN
from repro_torch.nn.ssm import Mamba2Mixer, init_ssm_cache

FAMILIES = ("ssm", "hybrid")     # SSMLM's; MixedLM builds "mixed"


def mamba_mixer(cfg: ModelConfig, *, device=None,
                generator: Optional[torch.Generator] = None) -> Mamba2Mixer:
    """The Mamba2 mixer of ``cfg``'s widths."""
    return Mamba2Mixer(cfg.d_model, cfg.ssm_state, cfg.ssm_expand,
                       cfg.ssm_headdim, chunk=cfg.ssm_chunk,
                       norm_eps=cfg.norm_eps, dtype=_DTYPES[cfg.dtype],
                       device=device, generator=generator)


class MambaBlock(nn.Module):
    """Pre-norm Mamba2 mixer with a residual."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dt = _DTYPES[cfg.dtype]
        self.eps = cfg.norm_eps
        self.ln = constant((cfg.d_model,), 1.0, device=device, dtype=dt)
        self.mixer = mamba_mixer(cfg, device=device, generator=generator)

    def forward(self, x, *, cache=None, impl="ref"):
        y, new_cache = self.mixer(rms_norm(x, self.ln, self.eps),
                                  cache=cache, impl=impl)
        return x + y.to(x.dtype), new_cache


class SharedAttnBlock(nn.Module):
    """Zamba2's shared transformer block (attention + gated MLP)."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dt = _DTYPES[cfg.dtype]
        d, ff = cfg.d_model, cfg.d_ff
        self.eps = cfg.norm_eps
        self.ln1 = constant((d,), 1.0, device=device, dtype=dt)
        self.ln2 = constant((d,), 1.0, device=device, dtype=dt)
        self.attn = GQAAttention(d, cfg.n_heads, cfg.n_kv,
                                 cfg.resolved_head_dim, rope=cfg.rope,
                                 scale=cfg.attention_scale,
                                 norm_eps=cfg.norm_eps, dtype=dt,
                                 device=device, generator=generator)
        self.mlp = gated_mlp_init(d, ff, generator=generator, device=device,
                                  dtype=dt)

    def forward(self, x, *, positions, cache=None, impl="ref"):
        a, new_cache = self.attn(rms_norm(x, self.ln1, self.eps),
                                 positions=positions, cache=cache, impl=impl)
        x = x + a
        x = x + gated_mlp(self.mlp, rms_norm(x, self.ln2, self.eps))
        return x, new_cache


def _layer_cache(stacked: Dict, idx) -> Dict:
    return {k: v[idx] for k, v in stacked.items()}


def _write_back(stacked: Dict, idx, new: Dict) -> None:
    """Copy a layer's new SSM state and convolution history into the
    stacked cache (the position is stacked by the caller)."""
    stacked["conv"][idx].copy_(new["conv"])
    stacked["ssm"][idx].copy_(new["ssm"])


class SSMLM(TokenLM):
    """Mamba2 (``family='ssm'``) or Zamba2 hybrid (``family='hybrid'``).
    Weights are drawn from ``generator`` (a generator on ``device`` seeded
    0 when None); on ``device="meta"`` nothing is allocated.  Runs on the
    CUDA device unless the caller passes another ``device``."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"{cfg.arch_id}: SSMLM builds the ssm and "
                             f"hybrid families, not {cfg.family!r}")
        self.hybrid = cfg.family == "hybrid"
        if self.hybrid and (cfg.attn_every < 1
                            or cfg.n_layers % cfg.attn_every):
            raise ValueError(f"{cfg.arch_id}: {cfg.n_layers} layers are not "
                             f"groups of attn_every={cfg.attn_every}")
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
            MambaBlock(cfg, device=device, generator=generator)
            for _ in range(cfg.n_layers))
        if self.hybrid:
            self.n_groups = cfg.n_layers // cfg.attn_every
            self.shared = SharedAttnBlock(cfg, device=device,
                                          generator=generator)
        if not cfg.tied_embeddings:
            self.head = normal_init((cfg.d_model, cfg.vocab),
                                    cfg.d_model ** -0.5, **init)

    def _run(self, x, positions, caches=None, impl="ref", remat=False):
        every = self.cfg.attn_every
        if caches is None:
            for i, blk in enumerate(self.blocks):
                x = remat_block(block_out, blk, x, remat, impl=impl)
                if self.hybrid and (i + 1) % every == 0:
                    x = remat_block(block_out, self.shared, x, remat,
                                    positions=positions, impl=impl)
            return x, None
        mamba = caches["mamba"]
        if not self.hybrid:
            pos = []
            for i, blk in enumerate(self.blocks):
                x, new = blk(x, cache=_layer_cache(mamba, i), impl=impl)
                _write_back(mamba, i, new)
                pos.append(new["pos"])
            return x, {"mamba": dict(mamba, pos=torch.stack(pos))}
        attn = caches["attn"]
        mpos, apos = [], []
        for g in range(self.n_groups):
            for j in range(every):
                blk = self.blocks[g * every + j]
                x, new = blk(x, cache=_layer_cache(mamba, (g, j)), impl=impl)
                _write_back(mamba, (g, j), new)
                mpos.append(new["pos"])
            x, new = self.shared(x, positions=positions,
                                 cache=_layer_cache(attn, g), impl=impl)
            apos.append(new["pos"])
        return x, {
            "mamba": dict(mamba, pos=torch.stack(mpos).reshape(
                self.n_groups, every)),
            "attn": dict(attn, pos=torch.stack(apos))}

    def forward(self, batch, *, impl: str = "ref",
                train: bool = False) -> torch.Tensor:
        """Logits (B, T, vocab) of ``batch["tokens"]`` (the reference's
        ``apply``).  ``impl="cuda"``/``"auto"`` takes the SSD scan kernel in
        every Mamba block; ``train`` checkpoints every block (and every
        application of the shared block) when the config asks for
        ``remat``."""
        x, positions = self.embed_tokens(batch)
        x, _ = self._run(x, positions, impl=impl,
                         remat=train and self.cfg.remat)
        return self.head_logits(x)

    # -- serving ------------------------------------------------------------------
    def init_caches(self, batch_size: int, capacity: int,
                    dtype=torch.bfloat16) -> Dict:
        """Fresh stacked caches: SSM state and convolution history in
        float32, the shared block's KV caches in ``dtype``."""
        cfg = self.cfg
        ssm_one = init_ssm_cache(batch_size, self.blocks[0].mixer,
                                 torch.float32, self.device)
        if not self.hybrid:
            return {"mamba": {k: torch.stack([v] * cfg.n_layers)
                              for k, v in ssm_one.items()}}
        attn_one = init_cache(batch_size, cfg.n_kv, capacity,
                              cfg.resolved_head_dim, dtype, self.device)
        shape = (self.n_groups, cfg.attn_every)
        return {"mamba": {k: v.expand(*shape, *v.shape).clone()
                          for k, v in ssm_one.items()},
                "attn": {k: torch.stack([v] * self.n_groups)
                         for k, v in attn_one.items()}}

    def decode_step(self, caches, batch, *, impl: str = "ref"):
        """Append ``batch["tokens"]`` (B, T) to the caches and return
        ``(logits, new_caches)``.  Positions continue from the caches' write
        position, which stays on the device (no host sync)."""
        pos0 = (caches["attn"]["pos"][0] if self.hybrid
                else caches["mamba"]["pos"][0])
        x, positions = self.embed_tokens(batch, pos0)
        x, new = self._run(x, positions, caches=caches, impl=impl)
        return self.head_logits(x), new

    # -- partitioner view ------------------------------------------------------------
    def to_graph(self, seq: int) -> LayerGraph:
        """The partitioner's layer graph at ``seq`` tokens."""
        return ssm_graph(self.cfg, seq)

    def shared_groups(self) -> Dict[str, str]:
        """The shared block's layers by weight group (:func:`shared_groups`)."""
        return shared_groups(self.cfg)


# -- the mixed family (Granite 4.0-H) ---------------------------------------------

class MixerUnit(nn.Module):
    """``h + r · mixer(RMSNorm(h))``, r the residual multiplier: a layer's
    Mamba2 mixer (``kind`` ``"mamba"``) or GQA attention
    (``"attention"``)."""

    def __init__(self, cfg: ModelConfig, kind: str, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dt = _DTYPES[cfg.dtype]
        self.kind, self.r, self.eps = (kind, cfg.residual_multiplier,
                                       cfg.norm_eps)
        self.ln = constant((cfg.d_model,), 1.0, device=device, dtype=dt)
        if kind == "mamba":
            self.mixer = mamba_mixer(cfg, device=device, generator=generator)
        else:
            self.mixer = GQAAttention(
                cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.resolved_head_dim,
                qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
                window=cfg.window, rope_theta=cfg.rope_theta, rope=cfg.rope,
                scale=cfg.attention_scale, norm_eps=cfg.norm_eps, dtype=dt,
                device=device, generator=generator)

    def forward(self, x, *, positions=None, impl="ref", obs=None):
        u = rms_norm(x, self.ln, self.eps)
        if self.kind == "mamba":
            y, _ = self.mixer(u, impl=impl)
        else:
            y, _ = self.mixer(u, positions=positions, impl=impl)
        return x + self.r * y.to(x.dtype)


class MlpUnit(nn.Module):
    """``h + r · W_down(silu(v W_gate) ⊙ v W_up)``, ``v = RMSNorm(h)``: a
    layer's own gated MLP.  Takes (and ignores) the mixer's keywords, so
    that a stage calls every unit alike (as does the mixer unit with
    ``obs``)."""

    kind = "mlp"

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dt = _DTYPES[cfg.dtype]
        self.r, self.eps = cfg.residual_multiplier, cfg.norm_eps
        self.ln = constant((cfg.d_model,), 1.0, device=device, dtype=dt)
        self.mlp = gated_mlp_init(cfg.d_model, cfg.d_ff, generator=generator,
                                  device=device, dtype=dt)

    def forward(self, x, *, positions=None, impl="ref", obs=None):
        return x + self.r * gated_mlp(self.mlp, rms_norm(x, self.ln, self.eps))


class MoeUnit(nn.Module):
    """``h + r · (MoE(v) + Shared(v))``, ``v = RMSNorm(h)``: a layer's
    expert layer (``moe``, a dropless :class:`~repro_torch.nn.moe.MoEFFN`
    holding ``cfg.experts_held`` of the ``n_experts`` routed experts, its
    shared expert of width ``d_ff``).  Takes the mixer's keywords as the
    MLP unit does; ``obs`` switched on counts the rows the held experts
    computed in ``moe_rows.held`` and the token-expert choices, tokens x
    ``top_k``, in ``moe_rows.routed``."""

    kind = "moe"

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dt = _DTYPES[cfg.dtype]
        self.r, self.eps = cfg.residual_multiplier, cfg.norm_eps
        self.ln = constant((cfg.d_model,), 1.0, device=device, dtype=dt)
        self.moe = MoEFFN(cfg.d_model, cfg.moe_d_ff, cfg.n_experts,
                          cfg.top_k, cfg.n_shared, capacity_factor=None,
                          held=cfg.experts_held, shared_d_ff=cfg.d_ff,
                          dtype=dt, device=device, generator=generator)

    def forward(self, x, *, positions=None, impl="ref", obs=None):
        """``x`` (B, T, d) after the expert layer's residual branch."""
        y, aux = self.moe(rms_norm(x, self.ln, self.eps))
        count_moe_rows(obs, aux, x.shape[0] * x.shape[1], self.moe.k)
        return x + self.r * y


class MixedLayer(nn.Module):
    """One layer of the mixed family: its mixer unit, then its MLP unit,
    or its expert unit where the config has experts."""

    def __init__(self, cfg: ModelConfig, kind: str, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mix = MixerUnit(cfg, kind, device=device, generator=generator)
        ffn = MoeUnit if cfg.n_experts else MlpUnit
        self.ffn = ffn(cfg, device=device, generator=generator)

    def forward(self, x, *, positions=None, impl="ref"):
        return self.ffn(self.mix(x, positions=positions, impl=impl))


def _layer_out(blk: nn.Module, x: torch.Tensor, **kw) -> torch.Tensor:
    return blk(x, **kw)


class MixedLM(TokenLM):
    """The mixed family (``family='mixed'``): a Mamba2 mixer or a GQA
    attention in each layer, as ``cfg.layer_types`` says, each followed by
    the layer's own gated MLP, with scaled embeddings, residual branches
    and logits (the module docstring's equations).  Weights are drawn from
    ``generator`` (a generator on ``device`` seeded 0 when None); on
    ``device="meta"`` nothing is allocated.  Runs on the CUDA device unless
    the caller passes another ``device``."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family != "mixed":
            raise ValueError(f"{cfg.arch_id}: MixedLM builds the mixed "
                             f"family, not {cfg.family!r}")
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
            MixedLayer(cfg, kind, device=device, generator=generator)
            for kind in cfg.layer_types)
        if not cfg.tied_embeddings:
            self.head = normal_init((cfg.d_model, cfg.vocab),
                                    cfg.d_model ** -0.5, **init)

    def units(self) -> List[nn.Module]:
        """Each layer's mixer unit and MLP (or expert) unit, in order: the
        graph's positions 1 .. 2L (position 0 the embedding, 2L + 1 the
        head)."""
        return [u for blk in self.blocks for u in (blk.mix, blk.ffn)]

    def embed_tokens(self, batch, pos0=None):
        """Token embeddings times the embedding multiplier, and the
        positions (as :meth:`TokenLM.embed_tokens`)."""
        x, positions = super().embed_tokens(batch, pos0)
        return x * self.cfg.embedding_multiplier, positions

    def head_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and the head, divided by the logits scaling."""
        return super().head_logits(x) / self.cfg.logits_scaling

    def forward(self, batch, *, impl: str = "ref",
                train: bool = False) -> torch.Tensor:
        """Logits (B, T, vocab) of ``batch["tokens"]``.
        ``impl="cuda"``/``"auto"`` takes the SSD scan kernel in every Mamba2
        mixer; ``train`` checkpoints every layer when the config asks for
        ``remat``."""
        x, positions = self.embed_tokens(batch)
        for blk in self.blocks:
            x = remat_block(_layer_out, blk, x, train and self.cfg.remat,
                            positions=positions, impl=impl)
        return self.head_logits(x)

    def to_graph(self, seq: int) -> LayerGraph:
        """The partitioner's layer graph at ``seq`` tokens."""
        return ssm_graph(self.cfg, seq)


def _mixed_graph(cfg: ModelConfig, seq: int) -> LayerGraph:
    g = LayerGraph(name=cfg.arch_id)
    prev = g.add(GL.embed_layer("Embed_0", cfg.vocab, cfg.d_model,
                                seq)).name
    for i, kind in enumerate(cfg.layer_types):
        if kind == "mamba":
            mixer = GL.ssm_layer(f"SSM_{i}", cfg.d_model, cfg.ssm_state, seq,
                                 cfg.ssm_expand, headdim=cfg.ssm_headdim,
                                 conv_bias=True, d_skip=True)
        else:
            mixer = GL.attention_layer(
                f"Attention_{i}", cfg.d_model, cfg.n_heads, cfg.n_kv, seq,
                cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias,
                qk_norm=cfg.qk_norm, window=cfg.window)
        prev = g.add(mixer, after=[prev]).name
        if cfg.n_experts:
            held = cfg.experts_held
            ffn = GL.moe_layer(f"Moe_{i}", cfg.d_model, cfg.moe_d_ff, seq,
                               cfg.n_experts, cfg.top_k, cfg.n_shared,
                               held=None if held is None else held[1],
                               shared_d_ff=cfg.d_ff)
        else:
            ffn = GL.mlp_layer(f"Mlp_{i}", cfg.d_model, cfg.d_ff, seq)
        prev = g.add(ffn, after=[prev]).name
    g.add(GL.lm_head_layer("Head_0", cfg.d_model, cfg.vocab, seq,
                           tied=cfg.tied_embeddings), after=[prev])
    return g


def ssm_graph(cfg: ModelConfig, seq: int) -> LayerGraph:
    """The partitioner's per-block layer graph of an SSM, hybrid or mixed
    LM, from the configuration alone (no weights).  The mixed family's is
    a chain of 2L + 2 nodes: ``Embed_0``; per layer ``SSM_l`` (its
    convolution bias and ``D`` counted: the mixed family's mixers have
    both) or ``Attention_l``, then ``Mlp_l``, or ``Moe_l`` where the
    config has experts (:func:`~repro_torch.core.layers.moe_layer` at the
    held share); ``Head_0``."""
    if cfg.family == "mixed":
        return _mixed_graph(cfg, seq)
    hybrid = cfg.family == "hybrid"
    g = LayerGraph(name=cfg.arch_id)
    prev = g.add(GL.embed_layer("Embed_0", cfg.vocab, cfg.d_model,
                                seq)).name
    for i in range(cfg.n_layers):
        ssm = GL.ssm_layer(f"SSM_{i}", cfg.d_model, cfg.ssm_state, seq,
                           cfg.ssm_expand, headdim=cfg.ssm_headdim)
        prev = g.add(ssm, after=[prev]).name
        if hybrid and (i + 1) % cfg.attn_every == 0:
            a = GL.attention_layer(f"SharedAttn_{i}", cfg.d_model,
                                   cfg.n_heads, cfg.n_kv, seq,
                                   cfg.resolved_head_dim)
            prev = g.add(a, after=[prev]).name
            m = GL.mlp_layer(f"SharedMlp_{i}", cfg.d_model, cfg.d_ff, seq)
            prev = g.add(m, after=[prev]).name
    g.add(GL.lm_head_layer("Head_0", cfg.d_model, cfg.vocab, seq,
                           tied=cfg.tied_embeddings), after=[prev])
    return g


def shared_groups(cfg: ModelConfig) -> Dict[str, str]:
    """Map the shared block's layer names to one weight group each (the
    memory model counts a group's parameters once); empty unless hybrid."""
    if cfg.family != "hybrid":
        return {}
    out = {}
    for i in range(cfg.n_layers):
        if (i + 1) % cfg.attn_every == 0:
            out[f"SharedAttn_{i}"] = "shared_attn"
            out[f"SharedMlp_{i}"] = "shared_mlp"
    return out
