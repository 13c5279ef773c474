"""Accuracy oracles for the exploration (§IV-C).

Two implementations of the ``accuracy_fn(cuts) -> float`` protocol:

* :class:`ProxyAccuracy` — analytic noise model, used when no trained model
  is attached (fast path, and the only option during early filtering).
  Quantizing a layer to ``b`` bits injects noise ~ 2^-b weighted by a
  per-layer sensitivity (default: parameter count share — heavier layers
  hurt more).  This reproduces the paper's qualitative finding that later
  cuts (more layers on the 16-bit platform) give higher top-1.

* :class:`MeasuredAccuracy` — wraps a measured ``measure(cuts)`` callable
  (e.g. fake-quant inference of a trained model on a validation set for
  each platform assignment).  Results are cached per cut vector.

The built-in ``cnn_fakequant`` measure, which trains a CNN, is not part of
this package yet; the ``table`` measure is.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import numpy as np

from repro_torch.core.layers import LayerInfo
from repro_torch.core.partition import SystemConfig


@dataclasses.dataclass
class ProxyAccuracy:
    schedule: Sequence[LayerInfo]
    system: SystemConfig
    base_accuracy: float = 1.0
    noise_scale: float = 4.0      # accuracy points lost per unit noise

    def __post_init__(self):
        total = sum(max(l.params, 1) for l in self.schedule) or 1
        self._weight = [max(l.params, 1) / total for l in self.schedule]
        self._weight_prefix = np.concatenate([[0.0], np.cumsum(self._weight)])

    @staticmethod
    def _noise(bits: int) -> float:
        return 2.0 ** (-bits + 4)   # 8b -> 1/16, 16b -> ~6e-5

    def __call__(self, cuts: Sequence[int]) -> float:
        bounds = [-1] + [max(int(c), -1) for c in cuts] + [len(self.schedule) - 1]
        loss = 0.0
        for k, plat in enumerate(self.system.platforms):
            n = self._noise(plat.quant.bits)
            for i in range(bounds[k] + 1, bounds[k + 1] + 1):
                loss += self._weight[i] * n
        return max(0.0, self.base_accuracy - self.noise_scale * loss)

    def proxy_arrays(self):
        """Arrays for the tensor evaluator fast-path: the per-layer weight
        prefix, per-platform noise, and the (base, scale) affine map.  Any
        accuracy oracle exposing this protocol can run inside
        ``TorchNSGA2Search``; measured oracles cannot and fall back to the
        NumPy strategy."""
        noise = np.array([self._noise(p.quant.bits)
                          for p in self.system.platforms])
        return self._weight_prefix, noise, self.base_accuracy, self.noise_scale

    def evaluate_batch(self, cuts: np.ndarray) -> np.ndarray:
        """Vectorized proxy accuracy for a whole (N, n_cuts) matrix.

        Same model as ``__call__`` but with the per-segment weight sums read
        off a prefix-sum table — one gather per platform instead of a Python
        loop over layers per candidate.
        """
        C = np.maximum(np.asarray(cuts, dtype=np.int64), -1)
        n = C.shape[0]
        tail = np.full((n, 1), len(self.schedule) - 1, dtype=np.int64)
        bounds = np.concatenate(
            [np.full((n, 1), -1, dtype=np.int64), C, tail], axis=1)
        wpre = self._weight_prefix
        loss = np.zeros(n)
        for k, plat in enumerate(self.system.platforms):
            loss += self._noise(plat.quant.bits) * (
                wpre[bounds[:, k + 1] + 1] - wpre[bounds[:, k] + 1])
        return np.maximum(0.0, self.base_accuracy - self.noise_scale * loss)


@dataclasses.dataclass
class MeasuredAccuracy:
    """Wraps an expensive measured evaluation with caching.

    ``measure(cuts)`` should run calibrated fake-quant inference (and QAT if
    enabled) for the platform assignment implied by ``cuts`` and return
    top-1 accuracy in [0, 1].
    """
    measure: Callable[[Tuple[int, ...]], float]
    _cache: Dict[Tuple[int, ...], float] = dataclasses.field(default_factory=dict)

    def __call__(self, cuts: Sequence[int]) -> float:
        key = tuple(int(c) for c in cuts)
        if key not in self._cache:
            self._cache[key] = float(self.measure(key))
        return self._cache[key]

    def evaluate_batch(self, cuts: np.ndarray) -> np.ndarray:
        """Batch protocol shared with :class:`ProxyAccuracy`; measurements
        are inherently per-assignment, so this is a cached scalar loop."""
        return np.array([self(row) for row in np.asarray(cuts)])


# -- measured-oracle registry (declarative path) ------------------------------
#
# A spec is pure data, so ``accuracy: {kind: "measured", measure: <name>}``
# references a factory registered here.  A factory is called as
# ``factory(graph=..., schedule=..., system=..., **options)`` and returns the
# ``measure(cuts) -> float`` callable that MeasuredAccuracy wraps (so every
# declarative measured oracle gets per-cut caching for free).

ACCURACY_MEASURES: Dict[str, Callable] = {}


def register_accuracy_measure(name: str, factory: Callable,
                              override: bool = False) -> None:
    """Register a measured-accuracy factory under ``name``.

    Name collisions raise unless ``override=True`` — silently re-registering
    would reroute every spec that selects the name.
    """
    if name in ACCURACY_MEASURES and not override:
        raise ValueError(
            f"accuracy measure {name!r} is already registered; "
            f"pass override=True to replace it")
    ACCURACY_MEASURES[name] = factory


def get_accuracy_measure(name: str) -> Callable:
    try:
        return ACCURACY_MEASURES[name]
    except KeyError:
        raise ValueError(
            f"unknown accuracy measure {name!r}; registered: "
            f"{sorted(ACCURACY_MEASURES)} "
            f"(see repro_torch.core.accuracy.register_accuracy_measure)")


def _table_measure(graph=None, schedule=None, system=None, *,
                   table: Dict[str, float], default: float = 0.0):
    """Measured oracle backed by an explicit ``{"c0,c1": acc}`` table —
    pre-recorded measurements (e.g. a lab sweep) replayed declaratively."""
    lut = {tuple(int(t) for t in k.split(",")): float(v)
           for k, v in table.items()}

    def measure(cuts):
        return lut.get(tuple(int(c) for c in cuts), float(default))

    return measure


register_accuracy_measure("table", _table_measure)
