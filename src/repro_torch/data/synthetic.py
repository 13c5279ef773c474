"""Synthetic datasets — a copy of the JAX package's ``repro.data.synthetic``
(NumPy only).

Synthetic datasets (offline stand-ins with *learnable structure*).

``SyntheticImages``: class-conditional images from fixed random per-class
templates + structured noise — a model that learns the templates reaches
high accuracy, an untrained one sits at chance, and quantization noise
measurably degrades it.  This preserves the paper's accuracy-exploration
dynamics without ImageNet.  The templates live in host memory as float32:
``n_classes * channels * hw * hw * 4`` bytes, 602 MB at ``n_classes=1000,
hw=224``.

The reference module's token streams and batch helpers are not copied:
no slice of the port uses them yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticImages:
    n_classes: int = 10
    hw: int = 32
    channels: int = 3
    noise: float = 0.35
    seed: int = 1234

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.templates = rng.normal(
            size=(self.n_classes, self.channels, self.hw, self.hw)
        ).astype(np.float32)

    def batch(self, batch_size: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(seed)
        labels = rng.integers(0, self.n_classes, size=batch_size)
        x = self.templates[labels]
        # structured nuisance: random shift + additive noise
        shift = rng.integers(-2, 3, size=(batch_size, 2))
        x = np.stack([np.roll(np.roll(img, s[0], axis=1), s[1], axis=2)
                      for img, s in zip(x, shift)])
        x = x + self.noise * rng.normal(size=x.shape).astype(np.float32)
        return x.astype(np.float32), labels.astype(np.int32)

    def eval_set(self, n: int, seed: int = 999):
        return self.batch(n, seed)
