"""Learning-rate schedules (the JAX package's ``repro.optim.schedules``).

A schedule maps the optimizer's step, a 0-d int32 tensor on the
parameters' device, to a 0-d float32 tensor on the same device, so that
the optimizer step reads no number back to the host.
"""

from __future__ import annotations

import math

import torch


def constant(lr: float):
    """``lr`` at every step."""
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    """Cosine decay from ``lr`` to ``final_frac * lr`` over
    ``total_steps``."""
    def f(step):
        t = torch.clamp(step.float() / total_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return f


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup to ``lr`` over ``warmup_steps``, then cosine decay to
    ``final_frac * lr`` at ``total_steps``."""
    def f(step):
        s = step.float()
        warm = lr * s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                        0.0, 1.0)
        cos = lr * (final_frac + (1 - final_frac) * 0.5
                    * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup_steps, warm, cos)
    return f
