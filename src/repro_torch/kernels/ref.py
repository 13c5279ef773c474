"""Plain PyTorch versions of the port's kernels (the ground truth).

Pareto half: Deb constrained domination, tiled and bit-packed exactly as
the CUDA kernels in ``kernels/csrc/pareto_rank.cu`` compute it, and the
front loop that peels ranks off the packed words (:func:`peel_fronts`).
Packed words are int32 tensors carrying the uint32 bit pattern: bit j of
word (w, q) means row 32w+j dominates column q (view them with
``.numpy().view(np.uint32)``).  These functions run on any device; the
CPU tests use them, and on the card they are what the kernels are held
against.

Attention half: :func:`window_attn_gqa`, the sliding-window attention that
``kernels/csrc/window_attn.cu`` computes tile by tile, here as one masked
softmax over the full (T, T) scores.

SSD half: :func:`ssd_scan`, the Mamba2 chunked scan that
``kernels/csrc/ssd_scan.cu`` computes, here as ``nn.ssm.ssd_chunked``
without the D skip.

Quantized half: :func:`quant_matmul`, the fake-quant int8 product that
``kernels/csrc/quant_matmul.cu`` computes in integers, here in float32;
:func:`fake_quant_tensors`, the per-tensor fake quantization that
``kernels/csrc/fake_quant.cu`` computes for many tensors in two launches,
here the chain of ATen ops on each tensor (:func:`scale_zp` and
:func:`fake_quant`, which ``core.quant`` calls on every route).

CNN half: :func:`mbconv_dw`, the MBConv depthwise unit that
``kernels/csrc/mbconv_dw.cu`` computes in one pass, here the chain of ops
the block runs (BatchNorm, SiLU, depthwise convolution, BatchNorm, SiLU,
the squeeze-excite mean).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F


# -- pareto_rank ---------------------------------------------------------------

def dominates_tile(Fp: torch.Tensor, cvp: torch.Tensor,
                   Fq: torch.Tensor, cvq: torch.Tensor) -> torch.Tensor:
    """Deb constrained-domination tile: out[i, j] = (Fp[i], cvp[i]) dominates
    (Fq[j], cvq[j]).  The objective loop is unrolled over the (small)
    objective count so no (rows, cols, m) temporary is ever materialized."""
    rows, cols = Fp.shape[0], Fq.shape[0]
    all_le = torch.ones((rows, cols), dtype=torch.bool, device=Fp.device)
    any_lt = torch.zeros((rows, cols), dtype=torch.bool, device=Fp.device)
    for j in range(Fp.shape[1]):
        a, b = Fp[:, j, None], Fq[None, :, j]
        all_le &= a <= b
        any_lt |= a < b
    feas_p, feas_q = (cvp <= 0)[:, None], (cvq <= 0)[None, :]
    cv_lt = cvp[:, None] < cvq[None, :]
    return torch.where(feas_p & ~feas_q, True,
                       torch.where(feas_q & ~feas_p, False,
                                   torch.where(~feas_p & ~feas_q, cv_lt,
                                               all_le & any_lt)))


def _pack_rows(B: torch.Tensor) -> torch.Tensor:
    """Pack a (rows, n) bool tile into (rows // 32, n) int32 words carrying
    the uint32 bit pattern (bit j of word w = B[32w + j])."""
    rows, n = B.shape
    W = B.reshape(rows // 32, 32, n).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=B.device) << torch.arange(
        32, dtype=torch.int64, device=B.device)
    words = (W * weights[None, :, None]).sum(dim=1)        # in [0, 2**32)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def _pad_rows(Fr: torch.Tensor, cvr: torch.Tensor,
              rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    pad = (-Fr.shape[0]) % rows
    if pad:
        # +inf violation: padding rows dominate nothing, so their bits are 0
        Fr = torch.cat([Fr, Fr.new_zeros((pad, Fr.shape[1]))])
        cvr = torch.cat([cvr, cvr.new_full((pad,), float("inf"))])
    return Fr, cvr


def packed_domination(Fr: torch.Tensor, cvr: torch.Tensor,
                      Fq: torch.Tensor, cvq: torch.Tensor,
                      block: int = 1024) -> torch.Tensor:
    """Bit-packed constrained-domination rows, built tile by tile.

    Returns (ceil(len(Fr)/32), len(Fq)) int32 words — bit for bit the
    packing of the dense domination matrix rows, with O(len(Fq) * block)
    working memory: a loop walks row tiles of dominators against the full
    column set.
    """
    r = Fr.shape[0]
    rows = max(32, min(block, r + (-r) % 32) // 32 * 32)
    Fr, cvr = _pad_rows(Fr, cvr, rows)
    words = [_pack_rows(dominates_tile(Fr[i:i + rows], cvr[i:i + rows],
                                       Fq, cvq))
             for i in range(0, Fr.shape[0], rows)]
    return torch.cat(words)[: (r + 31) // 32]


def domination_counts(F: torch.Tensor, CV: torch.Tensor,
                      alive: Optional[torch.Tensor] = None,
                      block: int = 1024) -> torch.Tensor:
    """Per-individual count of (alive) constrained dominators, accumulated
    tile by tile over dominator row blocks — O(n * block) peak memory, the
    streaming version of ``domination_matrix(...).sum(axis=0)``.  (n,)
    int32."""
    n = F.shape[0]
    if alive is None:
        alive = torch.ones(n, dtype=torch.bool, device=F.device)
    rows = max(32, min(block, n + (-n) % 32) // 32 * 32)
    acc = torch.zeros(n, dtype=torch.int32, device=F.device)
    for i in range(0, n, rows):
        d = dominates_tile(F[i:i + rows], CV[i:i + rows], F, CV)
        d &= alive[i:i + rows, None].to(torch.bool)
        acc += d.sum(dim=0, dtype=torch.int32)
    return acc


def pack_bits(B: torch.Tensor) -> torch.Tensor:
    """Pack a boolean (n, m) matrix into (ceil(n/32), m) int32 words along
    axis 0, carrying the uint32 bit pattern (bit j of word w, column q =
    B[32w + j, q])."""
    n, m = B.shape
    pad = (-n) % 32
    if pad:
        B = torch.cat([B, B.new_zeros((pad, m))])
    W = B.reshape(-1, 32, m).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=B.device) << torch.arange(
        32, dtype=torch.int64, device=B.device)
    words = (W * weights[None, :, None]).sum(dim=1)        # in [0, 2**32)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (its uint32 bit pattern), as int32.

    SWAR count on the low 31 bits — non-negative, so no shift drags the
    sign bit in and no sum overflows — plus the sign bit counted apart.
    """
    y = x & 0x7FFFFFFF
    y = y - ((y >> 1) & 0x55555555)
    y = (y & 0x33333333) + ((y >> 2) & 0x33333333)
    y = (y + (y >> 4)) & 0x0F0F0F0F
    y = y + (y >> 8)
    y = (y + (y >> 16)) & 0x3F
    return y + (x < 0).to(torch.int32)


def peel_fronts(Dp: torch.Tensor, alive: torch.Tensor, cap: int,
                on_read: Optional[Callable[[Optional[int], int], None]] = None
                ) -> Tuple[torch.Tensor, int, int, int]:
    """Peel fronts off the packed domination words ``Dp`` (ceil(n/32), n)
    among the ``alive`` (n,) individuals until at least ``cap`` are ranked
    or none are left; returns (rank (n,) int64, number of fronts, number
    ranked, alive count at entry).  Unranked individuals keep rank n.  A
    front with no member (only a domination cycle makes one) takes every
    alive individual.

    Each front costs ten elementwise passes over the words and one host
    read; ``on_read(k, n_alive)`` is called after each read: at entry (k
    None, the alive count), then after each front (k ranked, ``n_alive``
    alive before it)."""
    n = alive.shape[0]
    rank = torch.full((n,), n, dtype=torch.int64, device=alive.device)
    n_alive = entry = int(alive.sum())        # host read: the alive count
    if on_read is not None:
        on_read(None, n_alive)
    r = done = 0
    while n_alive and done < cap:
        alive_p = pack_bits(alive[:, None])[:, 0]
        n_dom = popcount32(Dp & alive_p[:, None]).sum(dim=0)
        front = alive & (n_dom == 0)
        k = int(front.sum())                  # host read: one a front
        if k == 0:                            # numerical safety
            front, k = alive, n_alive
        rank = torch.where(front, r, rank)
        alive = alive & ~front
        if on_read is not None:
            on_read(k, n_alive)
        n_alive -= k
        done += k
        r += 1
    return rank, r, done, entry


# -- window_attn ----------------------------------------------------------------

def window_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                window: int) -> torch.Tensor:
    """Sliding-window causal attention.

    q, k, v: (B, T, H, hd) (same head count: GQA expansion happens in the
    caller).  Position i attends to j in (i-window, i].  Returns (B,T,H,hd).
    """
    t, hd = q.shape[1], q.shape[3]
    pos = torch.arange(t, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    scores = torch.einsum("bihd,bjhd->bhij", q, k) / math.sqrt(hd)
    scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhij,bjhd->bihd", p, v)


def window_attn_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int) -> torch.Tensor:
    """:func:`window_attn` with k/v (B, T, Kv, hd) expanded to q's H heads
    (query head h reads KV head h // (H // Kv))."""
    group = q.shape[2] // k.shape[2]
    return window_attn(q, k.repeat_interleave(group, 2),
                       v.repeat_interleave(group, 2), window)


# -- ssd_scan ---------------------------------------------------------------------

def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD without the D skip term (the caller adds it).

    Shapes as in ``repro_torch.nn.ssm.ssd_chunked``.  Returns
    (y, final_state)."""
    from repro_torch.nn.ssm import ssd_chunked
    return ssd_chunked(x, dt, A, B, C, chunk, D=None, init_state=init_state)


# -- quant_matmul -----------------------------------------------------------------

def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                 x_scale: torch.Tensor) -> torch.Tensor:
    """Fake-quant product ``q(x) @ (w_q * w_scale)``: x (M, K) float32 is
    quantized symmetric 8-bit with ``x_scale`` (round half to even, clip to
    [-128, 127]), multiplied by w_q (K, N) int8 in float32 (exact while the
    partial sums stay below 2^24), then scaled by ``x_scale`` and
    ``w_scale`` (N,), in that order.  Returns (M, N) float32."""
    xq = torch.clamp(torch.round(x / x_scale), -128, 127)
    acc = xq @ w_q.to(torch.float32)
    return acc * x_scale * w_scale[None, :]


# -- fake_quant -------------------------------------------------------------------

def scale_zp(lo: torch.Tensor, hi: torch.Tensor, spec
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale and zero-point from calibrated ranges under ``spec`` (a
    ``core.quant.QuantSpec``), the reference's ops in its order; ``lo`` and
    ``hi`` scalars, or per channel of any shape."""
    if spec.symmetric:
        amax = torch.maximum(lo.abs(), hi.abs())
        scale = torch.clamp_min(amax / spec.qmax, 1e-12)
        zp = torch.zeros_like(scale)
    else:
        lo = torch.clamp_max(lo, 0.0)
        hi = torch.clamp_min(hi, 0.0)
        scale = torch.clamp_min((hi - lo) / (spec.qmax - spec.qmin), 1e-12)
        zp = torch.round(spec.qmin - lo / scale)
    return scale, zp


def fake_quant(x: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor,
               spec) -> torch.Tensor:
    """Quantize→dequantize with straight-through gradients: the value is
    the dequantized one, the gradient the identity."""
    q = torch.clamp(torch.round(x / scale + zp), spec.qmin, spec.qmax)
    dq = (q - zp) * scale
    return x + (dq - x).detach()


def fake_quant_tensors(xs, spec) -> list:
    """Each of ``xs`` fake-quantized per tensor by its own min/max range
    under ``spec`` (not per channel): min, max, :func:`scale_zp` and
    :func:`fake_quant` on each, the ATen ops that K7 reproduces bit for
    bit on the card."""
    if spec.per_channel:
        raise ValueError("fake_quant_tensors quantizes per tensor, not per "
                         "channel")
    return [fake_quant(x, *scale_zp(x.min(), x.max(), spec), spec)
            for x in xs]


# -- mbconv_dw ----------------------------------------------------------------------

def mbconv_dw(e: torch.Tensor, w: torch.Tensor, stride: int, bn,
              pre=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MBConv depthwise unit as the block's chain of ops: with ``pre``
    the expansion's inference BatchNorm and SiLU on ``e`` (N, C, H, W),
    then the k x k depthwise convolution by ``w`` (C, 1, k, k) at
    ``stride``, padded k // 2, and ``bn``'s BatchNorm and SiLU.  ``bn`` and
    ``pre`` are (running mean, running variance, scale, bias, eps).
    Returns (D, D's mean over each plane, (N, C))."""
    if pre is not None:
        e = F.silu(F.batch_norm(e, pre[0], pre[1], pre[2], pre[3], False,
                                0.0, pre[4]))
    k = w.shape[-1]
    d = F.conv2d(e, w, None, stride, k // 2, 1, e.shape[1])
    d = F.silu(F.batch_norm(d, bn[0], bn[1], bn[2], bn[3], False, 0.0,
                            bn[4]))
    return d, d.mean(dim=(2, 3))
