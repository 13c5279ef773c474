"""Streams derived from a run's ``--seed`` (any whole number)."""

from __future__ import annotations

import numpy as np


def sequence(seed: int, *keys: int) -> np.random.SeedSequence:
    """The seed sequence of ``seed`` for the purpose ``keys``."""
    return np.random.SeedSequence([int(seed) % 2 ** 64]
                                  + [int(k) for k in keys])


def rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(sequence(seed, *keys))


def derive(seed: int, *keys: int, bits: int = 31) -> int:
    """A whole number below 2**bits for the purpose ``keys``."""
    return int(sequence(seed, *keys).generate_state(2, np.uint64)[0]
               % (2 ** bits))
