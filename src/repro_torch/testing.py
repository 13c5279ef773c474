"""Inputs made to reach every tie rule of the port's kernels, and the
exact result of the int8 product.

Shared by the tests, the host-shim rehearsal and ``chip_smoke.py``, which
hold the Pareto kernels against their plain versions
(``kernels/ref.py``) on these inputs, and the int8 product kernel against
:func:`quant_matmul_exact` bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def edge_population(n: int, m: int = 3, infeas: float = 0.3,
                    seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(F (n, m), CV (n,)) float32 that reach every rule of
    :func:`repro_torch.kernels.ref.dominates_tile`: objectives on a coarse
    grid (ties), the second half duplicating the first, a NaN in ~3 % of
    the objectives; feasible violations 0.0, -0.0 and -1.0, infeasible ones
    (a share ``infeas``) repeated values, +inf and NaN.  Made with numpy
    from ``seed``."""
    rng = np.random.default_rng(seed)
    F = (rng.integers(0, 5, (n, m)) / 4).astype(np.float32)
    F[n // 2:] = F[rng.integers(0, max(n // 2, 1), n - n // 2)]
    F[rng.random((n, m)) < 0.03] = np.nan
    feas = np.array([0.0, -0.0, -1.0], np.float32)
    bad = np.array([0.5, 1.0, 1.0, 2.5, np.inf, np.nan], np.float32)
    CV = np.where(rng.random(n) < infeas, bad[rng.integers(0, 6, n)],
                  feas[rng.integers(0, 3, n)]).astype(np.float32)
    return torch.from_numpy(F), torch.from_numpy(CV)


def quant_matmul_exact(x: torch.Tensor, w_q: torch.Tensor,
                       w_scale: torch.Tensor,
                       x_scale: torch.Tensor) -> torch.Tensor:
    """The fake-quant int8 product as the kernel computes it: codes
    ``clamp(round(x / x_scale), -128, 127)``, their sum of products with
    w_q taken in float64 (exact: |sum| <= K * 128 * 128 < 2^53) and rounded
    once to float32, then ``* x_scale * w_scale`` in that order.  Where
    ``kernels.ref.quant_matmul`` sums in float32 (exact only below 2^24),
    this equals the kernel bit for bit at every K the kernel takes."""
    codes = torch.clamp(torch.round(x / x_scale), -128, 127)
    acc = (codes.double() @ w_q.double()).float()
    return acc * x_scale * w_scale[None, :]
