"""Plain PyTorch versions of the port's kernels (the ground truth).

Pareto half: Deb constrained domination, tiled and bit-packed exactly as
the CUDA kernels in ``kernels/csrc/pareto_rank.cu`` compute it.  Packed
words are int32 tensors carrying the uint32 bit pattern: bit j of word
(w, q) means row 32w+j dominates column q (view them with
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
``kernels/csrc/quant_matmul.cu`` computes in integers, here in float32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


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
