"""Attention machinery of the LM path: RoPE and M-RoPE, GQA, qk-norm,
sliding windows, KV caches (full and ring-buffer window) and DeepSeek-V3's
multi-head latent attention (MLA) with its latent cache.

Shapes as in the JAX package's ``repro.nn.attention``: activations
(B, T, D); caches (B, S, n_kv, hd), S the cache capacity (full sequence or
sliding window).  Decode is T=1 against a cache.

Differences from the reference:

* The sharding hooks of ``chunked_sdpa`` and ``GQAAttention`` (logical-axis
  hints, KV-head duplication for an ``attn_kv`` mesh axis) are no-ops on
  one device and are left out; the rule-driven ``softmax_dtype`` of
  ``nn.sharding.current_rules`` is kept.
* ``cache_update`` writes into the cache's ``k`` and ``v`` in place (one
  copy of the cache on the device) and returns the cache with its new
  position.
* A cache's ``pos`` is a scalar (one write position for the whole batch,
  as the reference's) or of shape (B,): one write position per row, a
  *lane*.  The reference gives each lane a batch-1 cache and ``jax.vmap``s
  the step over them (``SlotDecoder``, the serve runtime); here the lanes
  are the batch rows of one cache, so a step over every lane is one
  batched call.  The MLA latent cache (:func:`init_mla_cache`) takes lanes
  the same way, and is written in place too.
* ``impl``: ``"ref"`` (the default) is the reference's ``"ref"``;
  ``"cuda"`` and ``"auto"`` take the reference's ``"pallas"`` branch, the
  sliding-window kernel of ``kernels.ops.window_attn``.

With M-RoPE (``mrope_sections``) positions are (3, B, T): temporal,
height and width ids.  As in the reference, the ``sdpa`` branch and the
cache branch mask by the temporal ids (``positions[0]``), while
``chunked_sdpa`` and the window kernel mask by the row index.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.nn.layers import rms_norm
from repro_torch.nn.module import constant, normal_init
from repro_torch.nn.sharding import current_rules

Cache = Dict[str, torch.Tensor]
NEG_INF = -1e30


# -- rotary embeddings --------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, device=device,
                        dtype=torch.float32) / head_dim
    return 1.0 / (theta ** exps)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor ``0.1 · mscale · ln(factor) + 1`` (1 where
    ``factor`` <= 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(head_dim: int, theta: float, scaling,
                  device=None) -> torch.Tensor:
    """YaRN's rotary frequencies (hd/2,) for ``scaling`` (a
    ``configs.base.RopeScaling``): with f_i = theta^(-2i/hd) the plain
    frequencies, d(r) = hd · ln(L / (2π r)) / (2 ln theta) the half-dim
    that turns r times over the original length L, low = max(floor(
    d(beta_fast)), 0) and high = min(ceil(d(beta_slow)), hd - 1), the
    ramp ρ_i = clamp((i - low) / (high - low), 0, 1) and its complement
    μ_i = 1 - ρ_i::

        inv_freq_i = 1 / (factor · theta^(2i/hd)) · (1 - μ_i) + f_i · μ_i

    (the fast dims below ``low`` extrapolated, the slow ones above ``high``
    interpolated by ``factor``; the terms formed as the published
    ``modeling_deepseek.py`` forms them)."""
    length = scaling.original_max_position_embeddings

    def turns_dim(r):
        return (head_dim * math.log(length / (r * 2 * math.pi))
                / (2 * math.log(theta)))
    low = max(math.floor(turns_dim(scaling.beta_fast)), 0)
    high = min(math.ceil(turns_dim(scaling.beta_slow)), head_dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(head_dim // 2, device=device, dtype=torch.float32)
             - low) / (high - low)).clamp(0, 1)
    extra = rope_freqs(head_dim, theta, device=device)
    exps = torch.arange(0, head_dim, 2, device=device,
                        dtype=torch.float32) / head_dim
    inter = 1.0 / (scaling.factor * theta ** exps)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, scaling=None) -> torch.Tensor:
    """x: (B, T, H, hd); positions: (B, T) integer positions.
    ``scaling``: YaRN's (a ``configs.base.RopeScaling``): its frequencies
    (:func:`yarn_inv_freq`), and cos and sin times ``yarn_mscale(factor,
    mscale) / yarn_mscale(factor, mscale_all_dim)``."""
    if scaling is None:
        freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # (hd/2,)
    else:
        freqs = yarn_inv_freq(x.shape[-1], theta, scaling, device=x.device)
    ang = positions[..., None].float() * freqs                  # (B, T, hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    if scaling is not None:
        m = (yarn_mscale(scaling.factor, scaling.mscale)
             / yarn_mscale(scaling.factor, scaling.mscale_all_dim))
        cos, sin = cos * m, sin * m
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin,
                      x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections: Tuple[int, ...],
                theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: (B, T, H, hd); positions3: (3, B, T),
    the temporal, height and width ids; ``sections``: each axis's band of
    the half-dims, summing to hd/2.  Band a of the angles is taken from
    axis a, and the one concatenated angle rotates both halves."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim/2 = {hd // 2}")
    freqs = rope_freqs(hd, theta, device=x.device)              # (hd/2,)
    ang_all = positions3[..., None].float() * freqs             # (3,B,T,hd/2)
    bands = torch.split(ang_all, list(sections), dim=-1)
    ang = torch.cat([band[axis] for axis, band in enumerate(bands)], dim=-1)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin,
                      x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# -- masking ------------------------------------------------------------------

def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                window: Optional[int] = None) -> torch.Tensor:
    """(..., Tq, Tk) boolean mask: True = attend."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m &= k_pos[..., None, :] > q_pos[..., :, None] - window
    return m


def sdpa(q, k, v, mask, scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,T,H,hd), k: (B,S,Kv,hd), v: (B,S,Kv,vd), mask: (B,T,S)/(T,S).
    ``scale``: the scores' factor, None for 1/sqrt(hd)."""
    b, t, h, hd = q.shape
    kv = k.shape[2]
    vd = v.shape[-1]
    qg = q.reshape(b, t, kv, h // kv, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qg, k)
    scores = scores / math.sqrt(hd) if scale is None else scores * scale
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    p = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", p, v)
    return out.reshape(b, t, h, vd)


SCORE_CHUNK_BYTES = 1 << 30   # one sequence's (H, chunk, S) scores, at most


def score_chunk(chunk_q: int, heads: int, keys: int) -> int:
    """``chunk_q`` halved while one sequence's float32 scores (``heads``,
    chunk, ``keys``) pass ``SCORE_CHUNK_BYTES``: at DeepSeek-V3's 128
    heads over 16k keys a 512-query chunk would be 4 GiB, and the few such
    blocks alive at once must find room in the card's caching allocator
    among the other transients (its stage copies); 128 queries make 1 GiB.
    At 32 heads over 8k keys (granite) 512 queries stay."""
    while chunk_q % 2 == 0 and heads * chunk_q * keys * 4 > SCORE_CHUNK_BYTES:
        chunk_q //= 2
    return chunk_q


def chunked_sdpa(q, k, v, window: Optional[int] = None,
                 chunk_q: int = 512,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Memory-bounded causal attention: a loop over query chunks.

    Never materializes the (T, T) score matrix: per step it is
    (chunk_q, S), so long prefills need O(T * chunk) intermediates.  On a
    card the chunk is :func:`score_chunk`'s; elsewhere (the CPU, the
    ``meta`` device of a dry run) it is ``chunk_q``.
    q: (B,T,H,hd); k/v: (B,S,Kv,hd-like); ``scale`` as :func:`sdpa`'s.  The softmax runs in float32,
    or in q's dtype when the installed rules say ``softmax_dtype ==
    "compute"`` (``--opt softmax_low``), as the reference's.
    """
    b, t, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    group = h // kv
    if t % chunk_q:
        chunk_q = t  # fallback: single chunk
    if q.is_cuda:
        chunk_q = score_chunk(chunk_q, h, s)
    k_pos = torch.arange(s, device=q.device)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    low = current_rules().get("softmax_dtype") == "compute"
    out = q.new_empty((b, t, h, vd))
    for q0 in range(0, t, chunk_q):
        q_blk = q[:, q0:q0 + chunk_q].reshape(b, chunk_q, kv, group, hd)
        q_pos = q0 + torch.arange(chunk_q, device=q.device)
        mask = causal_mask(q_pos, k_pos, window)
        sc = torch.einsum("bckgh,bskh->bkgcs", q_blk, k) * scale
        sc = torch.where(mask[None, None, None], sc, NEG_INF)
        # §Perf "softmax_low": keep the softmax in the compute dtype
        if low:
            p = torch.softmax(sc, dim=-1)
        else:
            p = torch.softmax(sc.float(), dim=-1).to(q.dtype)
        o = torch.einsum("bkgcs,bskh->bckgh", p, v)
        out[:, q0:q0 + chunk_q] = o.reshape(b, chunk_q, h, vd)
    return out


# -- KV caches ----------------------------------------------------------------

def init_cache(batch: int, n_kv: int, capacity: int, head_dim: int,
               dtype=torch.bfloat16, device=None,
               lanes: bool = False) -> Cache:
    """Zero cache; ``lanes``: one write position per batch row (``pos`` of
    shape (B,)), else one for the batch (a scalar ``pos``)."""
    return {
        "k": torch.zeros((batch, capacity, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, capacity, n_kv, head_dim), dtype=dtype,
                         device=device),
        "pos": torch.zeros((batch,) if lanes else (), dtype=torch.int32,
                           device=device),
    }


def cache_update(cache: Cache, k_new: torch.Tensor, v_new: torch.Tensor,
                 ring: bool) -> Cache:
    """Append T_new tokens, writing ``cache["k"]``/``["v"]`` in place.
    ``ring``: wrap around (sliding-window cache).  Without ``ring`` the
    write starts at ``min(pos, capacity - T_new)``, as the reference's
    ``dynamic_update_slice`` clamps it.  The position stays on the device.
    With lanes (``pos`` of shape (B,)) each row is written from its own
    position, as the reference's update ``vmap``ped over batch-1 lanes."""
    cap = cache["k"].shape[1]
    t_new = k_new.shape[1]
    pos = cache["pos"]
    if not ring and t_new > cap:
        raise ValueError(f"cache_update: {t_new} new tokens exceed the "
                         f"cache's capacity {cap}")
    step = torch.arange(t_new, device=pos.device)
    if pos.dim():
        start = pos[:, None] if ring else torch.clamp(
            pos, max=cap - t_new)[:, None]
        idx = start + step                                      # (B, T)
        if ring:
            idx = idx % cap
        rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
        cache["k"][rows, idx] = k_new.to(cache["k"].dtype)
        cache["v"][rows, idx] = v_new.to(cache["v"].dtype)
        return {"k": cache["k"], "v": cache["v"], "pos": pos + t_new}
    if ring:
        idx = (pos + step) % cap
    else:
        idx = torch.clamp(pos, max=cap - t_new) + step
    cache["k"].index_copy_(1, idx, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(1, idx, v_new.to(cache["v"].dtype))
    return {"k": cache["k"], "v": cache["v"], "pos": pos + t_new}


def cache_positions(cache: Cache, ring: bool) -> torch.Tensor:
    """Absolute position of each cache slot (-1 = empty): (S,) for a scalar
    ``pos``, (B, S) for lanes."""
    cap = cache["k"].shape[1]
    pos = cache["pos"]
    slots = torch.arange(cap, device=pos.device)
    if pos.dim():
        pos = pos[:, None]
    if ring:
        # slot s holds absolute position: the last `cap` tokens
        n_wraps = torch.clamp((pos - 1 - slots) // cap, min=0)
        abs_pos = slots + n_wraps * cap
        return torch.where(abs_pos < pos, abs_pos, -1)
    return torch.where(slots < pos, slots, -1)


# -- GQA attention block -------------------------------------------------------

class GQAAttention(nn.Module):
    """Grouped-query attention with RoPE or M-RoPE, qk-norm and an optional
    window.  With ``mrope_sections`` the positions must be (3, B, T).
    ``rope=False`` leaves q and k without positional encoding; ``scale``
    is the scores' factor (None: 1/sqrt(head_dim)), which the window
    kernel does not take.  ``norm_eps``: the qk-norm's eps.

    Weights keep the reference's (in, out) layout (``x @ wq``)."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int,
                 head_dim: Optional[int] = None, qkv_bias: bool = False,
                 qk_norm: bool = False, window: Optional[int] = None,
                 rope_theta: float = 10000.0,
                 mrope_sections: Optional[Tuple[int, ...]] = None, *,
                 rope: bool = True, scale: Optional[float] = None,
                 norm_eps: float = 1e-6,
                 dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if window is not None and scale is not None:
            raise ValueError("GQAAttention: the window kernel scales the "
                             "scores by 1/sqrt(head_dim); no other scale "
                             "with a window")
        self.d = d_model
        self.h, self.kv = n_heads, n_kv
        self.hd = head_dim or d_model // n_heads
        self.qkv_bias, self.qk_norm = qkv_bias, qk_norm
        self.window = window
        self.theta = rope_theta
        self.mrope_sections = mrope_sections
        self.rope, self.scale, self.eps = rope, scale, norm_eps
        d, h, kv, hd = self.d, self.h, self.kv, self.hd
        init = dict(generator=generator, device=device, dtype=dtype)
        self.wq = normal_init((d, h * hd), d ** -0.5, **init)
        self.wk = normal_init((d, kv * hd), d ** -0.5, **init)
        self.wv = normal_init((d, kv * hd), d ** -0.5, **init)
        self.wo = normal_init((h * hd, d), (h * hd) ** -0.5, **init)
        fixed = dict(device=device, dtype=dtype)
        if qkv_bias:
            self.bq = constant((h * hd,), 0.0, **fixed)
            self.bk = constant((kv * hd,), 0.0, **fixed)
            self.bv = constant((kv * hd,), 0.0, **fixed)
        if qk_norm:
            self.q_norm = constant((hd,), 1.0, **fixed)
            self.k_norm = constant((hd,), 1.0, **fixed)

    def _qkv(self, x, positions):
        b, t, _ = x.shape
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        if self.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = q.reshape(b, t, self.h, self.hd)
        k = k.reshape(b, t, self.kv, self.hd)
        v = v.reshape(b, t, self.kv, self.hd)
        if self.qk_norm:
            q = rms_norm(q, self.q_norm, self.eps)
            k = rms_norm(k, self.k_norm, self.eps)
        if not self.rope:
            return q, k, v
        if self.mrope_sections is not None:
            if positions.dim() != 3:
                raise ValueError("M-RoPE needs (3, B, T) positions, got "
                                 f"{tuple(positions.shape)}")
            q = apply_mrope(q, positions, self.mrope_sections, self.theta)
            k = apply_mrope(k, positions, self.mrope_sections, self.theta)
        else:
            q = apply_rope(q, positions, self.theta)
            k = apply_rope(k, positions, self.theta)
        return q, k, v

    def forward(self, x: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None, impl: str = "ref"):
        """Prefill when ``cache`` is None; otherwise append to the cache and
        attend over it (decode, or a prefill that fills it).  Returns
        ``(y, new_cache)``, ``new_cache`` None without a cache.  The
        masks of the ``sdpa`` and cache branches read the temporal ids of
        (3, B, T) positions, as the reference's do."""
        if impl not in kops.IMPLS:
            raise ValueError(f"unknown impl {impl!r}; valid choices: "
                             f"{', '.join(kops.IMPLS)}")
        b, t, _ = x.shape
        if positions is None:
            positions = torch.arange(t, device=x.device)[None].expand(b, t)
        q, k, v = self._qkv(x, positions)

        new_cache = None
        q_pos = positions if positions.dim() == 2 else positions[0]
        if cache is None:
            if self.window is not None and impl != "ref":
                y = kops.window_attn(q, k, v, self.window, impl=impl)
            elif t >= 2048:
                y = chunked_sdpa(q, k, v, self.window, scale=self.scale)
            else:
                y = sdpa(q, k, v, causal_mask(q_pos, q_pos, self.window),
                         self.scale)
        else:
            ring = self.window is not None and cache["k"].shape[1] <= self.window
            new_cache = cache_update(cache, k, v, ring=ring)
            kpos = cache_positions(new_cache, ring)        # (S,) or (B, S)
            kpos = (kpos if kpos.dim() == 2 else kpos[None])[:, None, :]
            mask = (kpos >= 0) & (kpos <= q_pos[:, :, None])
            if self.window is not None:
                mask &= kpos > q_pos[:, :, None] - self.window
            y = sdpa(q, new_cache["k"].to(q.dtype),
                     new_cache["v"].to(q.dtype), mask, self.scale)
        return y.reshape(b, t, self.h * self.hd) @ self.wo, new_cache


# -- DeepSeek-V3 multi-head latent attention ----------------------------------

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6          # the latents' RMSNorms (the port's own)
    rope_scaling: Optional[object] = None   # YaRN (the port's own)


def init_mla_cache(batch: int, capacity: int, cfg: MLAConfig,
                   dtype=torch.bfloat16, device=None,
                   lanes: bool = False) -> Cache:
    """Zero latent cache: ``ckv`` (B, S, kv_lora_rank), ``kr`` (B, S,
    qk_rope_dim) and ``pos``, a scalar or, with ``lanes``, one write
    position per batch row (B,)."""
    return {
        "ckv": torch.zeros((batch, capacity, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "kr": torch.zeros((batch, capacity, cfg.qk_rope_dim), dtype=dtype,
                          device=device),
        "pos": torch.zeros((batch,) if lanes else (), dtype=torch.int32,
                           device=device),
    }


def _write_at(buf: torch.Tensor, new: torch.Tensor, pos: torch.Tensor
              ) -> None:
    """Write ``new`` (B, T, ...) into ``buf`` (B, S, ...) in place from
    ``min(pos, S - T)`` (the reference's clamped ``dynamic_update_slice``):
    ``pos`` a scalar, or one position per row (B,)."""
    cap, t_new = buf.shape[1], new.shape[1]
    if t_new > cap:
        raise ValueError(f"{t_new} new tokens exceed the cache's capacity "
                         f"{cap}")
    step = torch.arange(t_new, device=pos.device)
    start = torch.clamp(pos, max=cap - t_new)
    if pos.dim():
        rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
        buf[rows, start[:, None] + step] = new.to(buf.dtype)
    else:
        buf.index_copy_(1, start + step, new.to(buf.dtype))


class MLAAttention(nn.Module):
    """Multi-head latent attention (DeepSeek-V2/V3).

    The cache holds the compressed latent ``ckv`` (kv_lora_rank) and the
    shared rope key ``kr`` (qk_rope_dim) per token.  Prefill and training
    use the decompressed form; decode with a cache uses the absorbed form
    (the query projected into the latent space, attention over
    kv_lora_rank dimensions).  Weights in the reference's (in, out)
    layout.

    With ``cfg.rope_scaling`` (YaRN, DeepSeek-V3) the rotary part of q and
    k turns at YaRN's frequencies with cos and sin scaled
    (:func:`apply_rope`), and the softmax scale is ``(qk_nope + qk_rope)^-½
    · yarn_mscale(factor, mscale_all_dim)²`` on every path; without it the
    scale is ``(qk_nope + qk_rope)^-½`` as in the reference."""

    def __init__(self, cfg: MLAConfig, *, dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = c = cfg
        d, h = c.d_model, c.n_heads
        qk = c.qk_nope_dim + c.qk_rope_dim
        std = d ** -0.5
        init = dict(generator=generator, device=device, dtype=dtype)
        fixed = dict(device=device, dtype=dtype)
        self.w_dq = normal_init((d, c.q_lora_rank), std, **init)
        self.q_norm = constant((c.q_lora_rank,), 1.0, **fixed)
        self.w_uq = normal_init((c.q_lora_rank, h * qk),
                                c.q_lora_rank ** -0.5, **init)
        self.w_dkv = normal_init((d, c.kv_lora_rank), std, **init)
        self.kv_norm = constant((c.kv_lora_rank,), 1.0, **fixed)
        self.w_kr = normal_init((d, c.qk_rope_dim), std, **init)
        self.w_uk = normal_init((c.kv_lora_rank, h * c.qk_nope_dim),
                                c.kv_lora_rank ** -0.5, **init)
        self.w_uv = normal_init((c.kv_lora_rank, h * c.v_head_dim),
                                c.kv_lora_rank ** -0.5, **init)
        self.wo = normal_init((h * c.v_head_dim, d),
                              (h * c.v_head_dim) ** -0.5, **init)
        rs = c.rope_scaling
        # None: sdpa's own 1/sqrt(qk), bit for bit the reference's
        self.scale = None if rs is None else (
            qk ** -0.5 * yarn_mscale(rs.factor, rs.mscale_all_dim) ** 2)

    def _latents(self, x, positions):
        c = self.cfg
        b, t, _ = x.shape
        cq = rms_norm(x @ self.w_dq, self.q_norm, c.norm_eps)
        q = (cq @ self.w_uq).reshape(b, t, c.n_heads,
                                     c.qk_nope_dim + c.qk_rope_dim)
        q_nope, q_rope = q[..., :c.qk_nope_dim], q[..., c.qk_nope_dim:]
        q_rope = apply_rope(q_rope, positions, c.rope_theta, c.rope_scaling)
        ckv = rms_norm(x @ self.w_dkv, self.kv_norm, c.norm_eps)  # (B,T,r)
        k_rope = apply_rope((x @ self.w_kr)[:, :, None, :], positions,
                            c.rope_theta, c.rope_scaling)[:, :, 0]  # (B,T,rd)
        return q_nope, q_rope, ckv, k_rope

    def forward(self, x: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None, impl: str = "ref"):
        """Returns ``(y, new_cache)``, ``new_cache`` None without a cache.
        No kernel is on this path (``impl`` is checked and otherwise
        unused, as in the reference)."""
        if impl not in kops.IMPLS:
            raise ValueError(f"unknown impl {impl!r}; valid choices: "
                             f"{', '.join(kops.IMPLS)}")
        c = self.cfg
        b, t, _ = x.shape
        if positions is None:
            positions = torch.arange(t, device=x.device)[None].expand(b, t)
        q_nope, q_rope, ckv, k_rope = self._latents(x, positions)

        new_cache = None
        if cache is None:
            # decompressed prefill/train path
            k_nope = (ckv @ self.w_uk).reshape(b, t, c.n_heads, c.qk_nope_dim)
            v = (ckv @ self.w_uv).reshape(b, t, c.n_heads, c.v_head_dim)
            k = torch.cat([k_nope, k_rope[:, :, None].expand(
                b, t, c.n_heads, c.qk_rope_dim)], dim=-1)
            q = torch.cat([q_nope, q_rope], dim=-1)
            if t >= 2048:
                y = chunked_sdpa(q, k, v, scale=self.scale)
            else:
                y = sdpa(q, k, v, causal_mask(positions, positions),
                         self.scale)
        else:
            # absorbed decode path: attention in the latent space
            pos = cache["pos"]
            _write_at(cache["ckv"], ckv, pos)
            _write_at(cache["kr"], k_rope, pos)
            new_cache = {"ckv": cache["ckv"], "kr": cache["kr"],
                         "pos": pos + t}
            ckv_all = cache["ckv"].to(x.dtype)
            kr_all = cache["kr"].to(x.dtype)
            w_uk = self.w_uk.reshape(c.kv_lora_rank, c.n_heads, c.qk_nope_dim)
            q_lat = torch.einsum("bthn,rhn->bthr", q_nope, w_uk)
            scale = (1.0 / math.sqrt(c.qk_nope_dim + c.qk_rope_dim)
                     if self.scale is None else self.scale)
            scores = (torch.einsum("bthr,bsr->bhts", q_lat, ckv_all)
                      + torch.einsum("bthn,bsn->bhts", q_rope, kr_all))
            kpos = torch.arange(ckv_all.shape[1], device=x.device)
            end = new_cache["pos"]
            end = end[:, None, None, None] if end.dim() else end
            mask = (kpos < end) & (kpos <= positions[:, None, :, None])
            scores = torch.where(mask, scores * scale, NEG_INF)
            p_att = torch.softmax(scores.float(), dim=-1).to(x.dtype)
            o_lat = torch.einsum("bhts,bsr->bthr", p_att, ckv_all)
            w_uv = self.w_uv.reshape(c.kv_lora_rank, c.n_heads, c.v_head_dim)
            y = torch.einsum("bthr,rhv->bthv", o_lat, w_uv)
        return y.reshape(b, t, -1) @ self.wo, new_cache
