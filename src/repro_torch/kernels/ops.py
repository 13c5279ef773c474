"""Kernel dispatch for the Pareto-ranking, attention, SSD-scan,
fake-quant product, per-tensor fake-quantization and MBConv depthwise-unit
primitives.

``impl`` resolution: ``'cuda'`` launches the hand-written kernel (the
tensors must lie on a CUDA device, else it raises), ``'ref'`` runs the
plain PyTorch version on whatever device the tensors are on, ``'auto'``
picks the kernel for a CUDA tensor and ``ref`` for a CPU tensor.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import fake_quant as _fq
from repro_torch.kernels import mbconv_dw as _mb
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

# the plain versions' working-memory tile (rows of dominators at a time);
# the kernels fix their own tiles in csrc/pareto_rank.cu
_REF_BLOCK = 2048


def packed_domination(F, CV, *, block: int = _REF_BLOCK,
                      impl: str = "auto") -> torch.Tensor:
    """Bit-packed constrained-domination matrix, built tile by tile.

    Returns (ceil(n/32), n) int32 words carrying the uint32 bit pattern of
    the ``kernels.ref.pack_bits`` layout — bit-identical to packing the
    dense ``domination_matrix``, but the dense (n, n[, m]) temporaries never
    exist.  ``block`` is the plain version's row tile; the kernel's tiles
    are fixed.
    """
    F = torch.as_tensor(F, dtype=torch.float32).contiguous()
    CV = torch.as_tensor(CV, dtype=torch.float32,
                         device=F.device).contiguous()
    if resolve_impl(impl, F) == "ref":
        return _ref.packed_domination(F, CV, F, CV, block)
    return _kern.packed_domination(F, CV, F, CV)


def domination_counts(F, CV, alive: Optional[torch.Tensor] = None, *,
                      block: int = _REF_BLOCK,
                      impl: str = "auto") -> torch.Tensor:
    """(n,) int32 count of alive constrained dominators per individual.
    ``counts == 0`` is the first constrained front.  ``block`` is the plain
    version's row tile; the kernel's tiles are fixed."""
    F = torch.as_tensor(F, dtype=torch.float32).contiguous()
    CV = torch.as_tensor(CV, dtype=torch.float32,
                         device=F.device).contiguous()
    n = F.shape[0]
    if alive is None:
        alive = torch.ones(n, dtype=torch.bool, device=F.device)
    if resolve_impl(impl, F) == "ref":
        return _ref.domination_counts(F, CV, alive.to(torch.bool), block)
    return _kern.domination_counts(F, CV, alive)


def peel_fronts(Dp: torch.Tensor, alive: torch.Tensor,
                cap: Optional[int] = None, *, impl: str = "auto",
                on_read: Optional[Callable[[Optional[int], int], None]] = None
                ) -> Tuple[torch.Tensor, int, int, int]:
    """Peel fronts off the packed domination words ``Dp`` (ceil(n/32), n)
    among the ``alive`` (n,) individuals until at least ``cap`` (default
    n) are ranked or none are left.  Returns (rank (n,) int64, unranked
    ones n; fronts peeled, individuals ranked, alive count at entry).

    The kernel runs every front in one launch and the host reads its three
    counts once; the plain loop reads the alive count at entry and one
    count a front.  ``on_read(k, n_alive)`` follows each host read: (None,
    the alive count at entry) for the entry read and the kernel's one
    read, (k ranked, alive before it) after each front of the plain loop.
    """
    n = alive.shape[0]
    cap = n if cap is None else cap
    if resolve_impl(impl, Dp) == "ref":
        return _ref.peel_fronts(Dp, alive, cap, on_read)
    rank, info = _kern.peel_fronts(Dp.contiguous(), alive.contiguous(), cap)
    fronts, done, n_alive = info.tolist()     # host read: one a ranking
    if on_read is not None:
        on_read(None, n_alive)
    return rank, fronts, done, n_alive


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


# -- fake_quant -------------------------------------------------------------------

def fake_quant_tensors(xs: Sequence[torch.Tensor], spec, *,
                       impl: str = "auto") -> List[torch.Tensor]:
    """Each of ``xs`` (float32, one device) fake-quantized per tensor by
    its own min/max range under ``spec`` (a ``QuantSpec``, not per
    channel), bit for bit ``core.quant``'s chain.  The kernel pair takes
    the whole list in two launches a batch of ``fake_quant.MAX_TENSORS``;
    with grad enabled on an input that requires it, under
    ``fake_quant.StraightThrough`` (identity gradient).  ``ref`` keeps
    the straight-through form of the chain itself."""
    if not xs:
        return []
    if resolve_impl(impl, xs[0]) == "ref":
        return _ref.fake_quant_tensors(xs, spec)
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return list(_fq.StraightThrough.apply(spec, *xs))
    return _fq.fake_quant_tensors(xs, spec)


# -- mbconv_dw --------------------------------------------------------------------

def mbconv_dw(e: torch.Tensor, w: torch.Tensor, stride: int, bn: Sequence,
              pre: Optional[Sequence] = None, *, impl: str = "auto"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MBConv depthwise unit: with ``pre`` the expansion's inference
    BatchNorm and SiLU on ``e`` (N, C, H, W) float32 (the expansion
    convolution's raw output), then the k x k depthwise convolution by
    ``w`` (C, 1, k, k; k 3 or 5) at ``stride`` (1 or 2) padded k // 2,
    ``bn``'s BatchNorm and SiLU; ``bn`` and ``pre`` are (running mean,
    running variance, scale, bias, eps).  Returns (D, D's mean over each
    plane (N, C)).  The kernel (K8) does it in one launch, bit for bit
    the chain of ops on the card, with no gradient; ``ref`` is that
    chain."""
    if resolve_impl(impl, e) == "ref":
        return _ref.mbconv_dw(e, w, stride, bn, pre)
    return _mb.mbconv_dw(e, w, stride, bn, pre)
