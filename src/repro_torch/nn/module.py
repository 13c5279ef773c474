"""Parameter initialisation shared by the port's modules.

The JAX package keeps parameters in pytrees built by ``init(key)``; the
port keeps them in ``torch.nn.Module``s.  Every parameter is created with
``requires_grad=False``, so that serving records no autograd graph and a
forward keeps no activations alive; the train steps make a model
trainable (:func:`trainable`), and the serving entry points run their
forwards under ``torch.no_grad()`` whatever the model.  Random
initialisers draw from an explicit ``torch.Generator`` (the JAX package's
distributions; the numbers differ, the generator being torch's).
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch
from torch import nn


def frozen(t: torch.Tensor) -> nn.Parameter:
    """``t`` as a parameter that takes no gradient."""
    return nn.Parameter(t, requires_grad=False)


def trainable(model: nn.Module) -> nn.Module:
    """Let every parameter of ``model`` take gradients (the train steps'
    factories call it).  Returns ``model``."""
    return model.requires_grad_(True)


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


def kaiming(shape: Sequence[int], fan_in: Optional[int] = None, *,
            generator: Optional[torch.Generator] = None, device=None,
            dtype=torch.float32) -> torch.Tensor:
    """He-normal N(0, 2 / fan_in) of ``shape``; ``fan_in`` defaults, as in
    the reference, to ``shape[0]`` for rank <= 2 and to the product of the
    trailing axes otherwise."""
    if fan_in is None:
        fan_in = shape[0] if len(shape) <= 2 else math.prod(shape[1:])
    std = (2.0 / max(fan_in, 1)) ** 0.5
    t = torch.empty(tuple(shape), device=device, dtype=dtype)
    return t.normal_(0.0, std, generator=generator)


def param_count(tree: Any) -> int:
    """Elements of every parameter of a module, or of every tensor of a
    (nested dict / list of) tensors."""
    if isinstance(tree, nn.Module):
        return sum(p.numel() for p in tree.parameters())
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    if isinstance(tree, dict):
        tree = tree.values()
    return sum(param_count(t) for t in tree)


def cast_floats(tree: Any, dtype: torch.dtype) -> Any:
    """``tree`` (a tensor or a nested dict / list / tuple of tensors) with
    every floating-point tensor cast to ``dtype``; other leaves kept."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    return tree
