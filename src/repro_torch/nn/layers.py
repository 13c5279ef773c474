"""Basic layers of the LM path: RMS normalisation.

The CNN layers of the JAX package's ``repro.nn.layers`` (Dense, Conv2d,
the norms, pools, SqueezeExcite) come with the accuracy-exploration slice.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.nn.module import constant


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x / sqrt(mean(x^2) + eps) * scale, the variance taken in float32."""
    var = x.float().pow(2).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.d, self.eps = d, eps
        self.scale = constant((d,), 1.0, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale, self.eps)
