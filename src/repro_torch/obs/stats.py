"""One latency-statistics definition for every report in the repo.

Percentiles used to be computed ad hoc wherever a report needed them
(``np.percentile`` with its interpolating default in ``ServeReport``,
hand-rolled tail means in the serve engine), so two artifacts could
disagree about "p95" on the same samples.  This module is the single
definition — **nearest rank**: the p-th percentile of ``n`` sorted values
is the value at 1-based rank ``ceil(p/100 * n)`` (rank 1 for p = 0).  It
always returns an observed sample, never an interpolated one, and matches
NumPy's ``method='inverted_cdf'`` exactly (property-tested in
``tests/test_obs.py``).

Everything here is pure stdlib so the serve runtime, the benchmarks, and
the ``python -m repro_torch.obs`` CLI can all share it without importing NumPy.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of ``values`` (``0 <= q <= 100``).

    Returns the sorted sample at 1-based rank ``ceil(q/100 * n)`` (the
    minimum for ``q=0``, the maximum for ``q=100``) — identical to
    ``np.percentile(values, q, method='inverted_cdf')``.  Raises
    ``ValueError`` on an empty sequence or an out-of-range ``q``.
    """
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    vals = sorted(float(v) for v in values)
    if not vals:
        raise ValueError("percentile of an empty sequence")
    rank = math.ceil(q / 100.0 * len(vals))
    return vals[max(rank, 1) - 1]


def mean_tail(values: Sequence[float], skip: int) -> float:
    """Mean of ``values[skip:]``, falling back to the full sequence when
    fewer than ``skip`` samples exist (0.0 when empty).  This is the
    warm-up-dropping mean the serve engine feeds Def. 4."""
    tail = list(values[skip:]) or list(values)
    return sum(tail) / len(tail) if tail else 0.0


def latency_summary(values: Sequence[float],
                    unit: float = 1.0) -> Dict[str, float]:
    """Standard latency digest of ``values``: ``p50`` / ``p95`` (nearest
    rank), ``mean`` and ``max``, each scaled by ``unit`` (pass ``1e3`` for
    seconds -> milliseconds).  Returns ``{}`` for an empty sequence."""
    vals = [float(v) for v in values]
    if not vals:
        return {}
    return {
        "p50": percentile(vals, 50) * unit,
        "p95": percentile(vals, 95) * unit,
        "mean": sum(vals) / len(vals) * unit,
        "max": max(vals) * unit,
    }
