"""Kernel dispatch for the Pareto-ranking, attention, SSD-scan and
fake-quant product primitives.

``impl`` resolution: ``'cuda'`` launches the hand-written kernel (the
tensors must lie on a CUDA device, else it raises), ``'ref'`` runs the
plain PyTorch version on whatever device the tensors are on, ``'auto'``
picks the kernel for a CUDA tensor and ``ref`` for a CPU tensor.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import pareto_rank as _kern
from repro_torch.kernels import quant_matmul as _qm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd_scan as _ss
from repro_torch.kernels import window_attn as _wa

IMPLS = ("auto", "ref", "cuda")


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """The concrete impl (``'ref'`` or ``'cuda'``) for tensors like ``x``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; valid choices: "
                         f"{', '.join(IMPLS)}")
    if impl == "auto":
        return "cuda" if x.is_cuda else "ref"
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(f"impl 'cuda' needs CUDA tensors, got a tensor on "
                         f"{x.device}")
    return impl


# -- pareto_rank ----------------------------------------------------------------

# columns a packed-domination block stages in shared memory; its rows follow
# the caller's block.  The kernel's time is flat over 64-1024 columns and
# 1024-4096 rows at the search's shape (chip_variants.py --pareto)
_COL_TILE = 256


def _row_tile(block: int) -> int:
    return max(32, block // 32 * 32)


def packed_domination(F, CV, *, block: int = 1024,
                      impl: str = "auto") -> torch.Tensor:
    """Bit-packed constrained-domination matrix, built tile by tile.

    Returns (ceil(n/32), n) int32 words carrying the uint32 bit pattern of
    the ``nsga2_torch._pack_bits`` layout — bit-identical to packing the
    dense ``domination_matrix``, but the dense (n, n[, m]) temporaries never
    exist.
    """
    F = torch.as_tensor(F, dtype=torch.float32).contiguous()
    CV = torch.as_tensor(CV, dtype=torch.float32,
                         device=F.device).contiguous()
    if resolve_impl(impl, F) == "ref":
        return _ref.packed_domination(F, CV, F, CV, block)
    return _kern.packed_domination(F, CV, F, CV, bp=_row_tile(block),
                                   bq=_COL_TILE)


def domination_counts(F, CV, alive: Optional[torch.Tensor] = None, *,
                      block: int = 1024, impl: str = "auto") -> torch.Tensor:
    """(n,) int32 count of alive constrained dominators per individual.
    ``counts == 0`` is the first constrained front."""
    F = torch.as_tensor(F, dtype=torch.float32).contiguous()
    CV = torch.as_tensor(CV, dtype=torch.float32,
                         device=F.device).contiguous()
    n = F.shape[0]
    if alive is None:
        alive = torch.ones(n, dtype=torch.bool, device=F.device)
    if resolve_impl(impl, F) == "ref":
        return _ref.domination_counts(F, CV, alive.to(torch.bool), block)
    return _kern.domination_counts(F, CV, alive)


# -- window_attn ----------------------------------------------------------------

def window_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                window: int, *, impl: str = "auto") -> torch.Tensor:
    """Causal sliding-window attention, q (B, T, H, hd), k/v (B, T, Kv, hd).

    Unlike the JAX package's dispatch, no shape falls back to ``ref``: the
    CUDA kernel masks the ragged edge itself, so a CUDA tensor launches it
    for every ``t`` and every window."""
    if resolve_impl(impl, q) == "ref":
        return _ref.window_attn_gqa(q, k, v, window)
    return _wa.window_attn(q, k, v, window)


# -- ssd_scan -------------------------------------------------------------------

def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int = 128, *,
             impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 chunked SSD without the D skip: x (b, T, h, p), dt (b, T, h),
    A (h,), B/C (b, T, n), T a multiple of ``chunk``.  Returns (y,
    final_state (b, h, p, n)).  The kernel takes contiguous copies of
    strided inputs (the mixer's x, B and C are slices of one projection)."""
    if resolve_impl(impl, x) == "ref":
        return _ref.ssd_scan(x, dt, A, B, C, chunk)
    return _ss.ssd_scan(*(a.contiguous() for a in (x, dt, A, B, C)), chunk)


# -- quant_matmul -----------------------------------------------------------------

def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                 x_scale, *, impl: str = "auto") -> torch.Tensor:
    """Fake-quant int8 product: x (M, K) float32 quantized with ``x_scale``
    (a scalar, kept on x's device) times w_q (K, N) int8, scaled by
    ``x_scale * w_scale[None, :]``; returns (M, N) float32.

    Unlike the JAX package's dispatch, no shape falls back to ``ref``: the
    CUDA kernel masks ragged M, K and N itself, so a CUDA tensor launches
    it for every shape."""
    x_scale = torch.as_tensor(x_scale, dtype=torch.float32, device=x.device)
    if resolve_impl(impl, x) == "ref":
        return _ref.quant_matmul(x, w_q, w_scale, x_scale)
    return _qm.quant_matmul(x, w_q, w_scale, x_scale)
