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

Three measured oracles are registered by name: ``cnn_fakequant``, which
trains a CNN and scores partitioned fake-quant inference, ``lm_fakequant``,
which scores a mixed-family LM's partitioned fake-quant inference against
its float top-1, and ``table``.
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
# ``factory(graph=..., schedule=..., system=..., device=..., **options)``,
# ``device`` being the one the search runs on, and returns the
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


def train_oracle_cnn(name: str, steps: int = 200, device="cuda",
                     **build_opts):
    """The ``cnn_fakequant`` oracle's model: ``build_cnn(name,
    **build_opts)`` on ``device`` (weights from a generator seeded 0),
    trained ``steps`` steps of AdamW on a warmup-cosine schedule (peak
    2e-3, a tenth of the steps warm) at batch 64 of
    ``SyntheticImages(noise=0.2)``.  Returns ``(model, dataset)``."""
    import torch

    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.explore.runner import resolve_device
    from repro_torch.models.cnn.zoo import build_cnn
    from repro_torch.optim.optimizers import adamw
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.training.train_lib import (init_params,
                                                make_classifier_train_step)

    dev = resolve_device(device)
    m = build_cnn(name, **build_opts).init_weights(
        torch.Generator(device=dev).manual_seed(0), device=dev)
    ds = SyntheticImages(noise=0.2)
    opt = adamw(warmup_cosine(2e-3, max(steps // 10, 1), steps))
    os_ = opt.init(init_params(m))
    step = make_classifier_train_step(m, opt)
    for i in range(steps):
        x, y = ds.batch(64, i)
        os_, _ = step(os_, x, y)
    return m, ds


def _cnn_fakequant_measure(graph=None, schedule=None, system=None,
                           device="cuda", *, name: str, steps: int = 200,
                           eval_size: int = 256, **build_opts):
    """Built-in measured oracle: trains a CNN-zoo model on the synthetic
    task (:func:`train_oracle_cnn`, on the search's ``device``) and scores
    real partitioned fake-quant inference per cut vector
    (``repro_torch.quantize.evaluate.cnn_measured_accuracy``), weights at
    each platform's bit width.  ``build_opts`` must mirror the spec's
    ``ModelRef`` options (e.g. ``in_hw``/``w``/``n_classes``) so the trained
    model's graph matches the explorer schedule the cut indices refer to.
    Heavy — meant for §IV-C-style studies, not the search inner loop
    (MeasuredAccuracy caches per cut vector on top).  The returned callable
    carries the trained ``model`` and its ``dataset``, for a caller that
    fine-tunes the model further (QAT)."""
    from repro_torch.quantize.evaluate import cnn_measured_accuracy

    m, ds = train_oracle_cnn(name, steps, device, **build_opts)
    vx, vy = ds.eval_set(eval_size)
    sched = schedule if schedule is not None else m.to_graph().topo_sort()
    specs = [plat.quant for plat in system.platforms]
    measure = cnn_measured_accuracy(m, sched, vx, vy, specs)
    measure.model, measure.dataset = m, ds
    return measure


def _lm_fakequant_measure(graph=None, schedule=None, system=None,
                          device="cuda", *, name: str, seq: int,
                          batch: int = 1, reduced: bool = False):
    """Built-in measured oracle for an LM of the mixed family: the registry
    model ``name`` (``reduced()`` when asked) on the search's ``device``,
    weights drawn from a generator seeded 0, ``batch`` sequences of ``seq``
    tokens drawn uniformly from the vocabulary by the same generator,
    the labels the float model's top-1 at each next-token position, and
    per cut vector the partitioned fake-quant inference
    (``repro_torch.quantize.evaluate.lm_measured_accuracy``), weights at
    each platform's bit width and the links' activations at the
    producer's.  ``seq`` and ``reduced`` must be the spec's ``ModelRef``
    options, so that the model's chain is the schedule the cut indices
    refer to.  The returned callable carries the ``model``."""
    import torch

    from repro_torch.explore.runner import resolve_device
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.quantize.evaluate import lm_measured_accuracy

    dev = resolve_device(device)
    cfg = get_config(name)
    if reduced:
        cfg = cfg.reduced()
    g = torch.Generator(device=dev).manual_seed(0)
    m = build_model(cfg, device=dev, generator=g)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=g,
                           device=dev)
    with torch.no_grad():
        labels = m({"tokens": tokens}, impl="auto").argmax(-1)[:, :-1]
    sched = schedule if schedule is not None else m.to_graph(seq).topo_sort()
    specs = [plat.quant for plat in system.platforms]
    measure = lm_measured_accuracy(m, sched, tokens, labels, specs)
    measure.model = m
    return measure


def _table_measure(graph=None, schedule=None, system=None, device=None, *,
                   table: Dict[str, float], default: float = 0.0):
    """Measured oracle backed by an explicit ``{"c0,c1": acc}`` table —
    pre-recorded measurements (e.g. a lab sweep) replayed declaratively."""
    lut = {tuple(int(t) for t in k.split(",")): float(v)
           for k, v in table.items()}

    def measure(cuts):
        return lut.get(tuple(int(c) for c in cuts), float(default))

    return measure


register_accuracy_measure("cnn_fakequant", _cnn_fakequant_measure)
register_accuracy_measure("lm_fakequant", _lm_fakequant_measure)
register_accuracy_measure("table", _table_measure)
