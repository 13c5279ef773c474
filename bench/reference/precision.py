"""The precisions the references compute in: float32 products with TF32
off, as the configurations state, or TF32 products, the control that a
cell's comparison has to reject.  On a card TF32 is cuBLAS's and cuDNN's
own; on the CPU it is emulated by rounding the operands' mantissas to
TF32's ten bits first.
"""

from __future__ import annotations

import contextlib

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest with
    ties away from zero (``cvt.rna.tf32.f32``)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


@contextlib.contextmanager
def precision_of(precision: str, device: torch.device):
    """Float32 products with TF32 off, or TF32 products."""
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
