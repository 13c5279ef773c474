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

``SyntheticTokens``: Zipf-ish Markov token streams for LM training —
a learnable bigram process so training loss actually drops.  The serve
runtime's ``poisson_traffic`` draws its prompts from it.

``batch_iterator`` and ``make_batch_for`` give host (numpy) batches; the
train steps move them to the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig


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


@dataclasses.dataclass
class SyntheticTokens:
    vocab: int
    order: int = 1
    seed: int = 7

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = min(self.vocab, 2048)      # transition table cap
        self._v = v
        # sparse-ish bigram transition: each token prefers ~8 successors
        succ = rng.integers(0, v, size=(v, 8))
        self._succ = succ

    def batch(self, batch_size: int, seq_len: int, seed: int) -> np.ndarray:
        rng = np.random.default_rng(seed)
        out = np.empty((batch_size, seq_len + 1), np.int32)
        cur = rng.integers(0, self._v, size=batch_size)
        out[:, 0] = cur
        for t in range(1, seq_len + 1):
            choice = rng.integers(0, 8, size=batch_size)
            nxt = self._succ[cur, choice]
            # occasional random jump keeps entropy non-zero
            jump = rng.random(batch_size) < 0.1
            nxt = np.where(jump, rng.integers(0, self._v, size=batch_size), nxt)
            out[:, t] = nxt
            cur = nxt
        return out


def batch_iterator(ds, batch_size: int, seq_len: Optional[int] = None,
                   start_seed: int = 0) -> Iterator:
    seed = start_seed
    while True:
        if isinstance(ds, SyntheticTokens):
            yield ds.batch(batch_size, seq_len, seed)
        else:
            yield ds.batch(batch_size, seed)
        seed += 1


def make_batch_for(cfg: ModelConfig, batch_size: int, seq_len: int,
                   seed: int = 0, kind: str = "train") -> Dict[str, np.ndarray]:
    """Concrete (host) batch for a model config — used by smoke tests and
    the quickstart examples. Training batches include next-token labels."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        codes = rng.integers(0, cfg.vocab,
                             size=(batch_size, cfg.n_codebooks, seq_len + 1))
        return {"codes": codes[:, :, :-1].astype(np.int32),
                "labels": codes[:, :, 1:].astype(np.int32)}
    toks = SyntheticTokens(cfg.vocab).batch(batch_size, seq_len, seed)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.normal(
            size=(batch_size, cfg.n_patches, cfg.d_model)).astype(np.float32)
        total = cfg.n_patches + seq_len
        pos = np.broadcast_to(np.arange(total), (batch_size, total))
        batch["positions3"] = np.broadcast_to(
            pos, (3, batch_size, total)).astype(np.int32)
        # labels only over the text positions; pad vision region with -100
        pad = np.full((batch_size, cfg.n_patches), -100, np.int32)
        batch["labels"] = np.concatenate([pad, batch["labels"]], axis=1)
    return batch
