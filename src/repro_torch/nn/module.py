"""Parameter initialisation shared by the port's modules.

The JAX package keeps parameters in pytrees built by ``init(key)``; the
port keeps them in ``torch.nn.Module``s.  This slice serves inference only,
so every parameter is created with ``requires_grad=False``: no autograd
graph is recorded and a forward keeps no activations alive.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


def frozen(t: torch.Tensor) -> nn.Parameter:
    """``t`` as a parameter that takes no gradient."""
    return nn.Parameter(t, requires_grad=False)


def normal_init(shape: Sequence[int], std: float = 0.02, *,
                generator: Optional[torch.Generator] = None,
                device=None, dtype=torch.float32) -> nn.Parameter:
    """N(0, 1) * std drawn from ``generator`` (the distribution of the JAX
    package's ``normal_init``; the numbers differ, the generator being
    torch's).  On the ``meta`` device nothing is drawn."""
    t = torch.empty(tuple(shape), device=device, dtype=dtype)
    if t.device.type != "meta":
        t.normal_(0.0, std, generator=generator)
    return frozen(t)


def constant(shape: Sequence[int], value: float, *, device=None,
             dtype=torch.float32) -> nn.Parameter:
    return frozen(torch.full(tuple(shape), value, device=device, dtype=dtype))
