"""Shape stand-ins for every (arch x input-shape) pair (the JAX package's
``repro.launch.specs``): tensors on the ``meta`` device, which hold a
shape and a dtype and no memory, in place of ``jax.ShapeDtypeStruct``.

``run_config`` derives the shape-adapted model config:

* ``long_500k`` keeps the sliding-window attention variant (the
  sub-quadratic mode); every other shape uses full attention;
* every pod-scale run computes in bfloat16.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


def stand_in(shape, dtype=torch.int32) -> torch.Tensor:
    """A shape-and-dtype stand-in: an empty tensor on ``meta``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def run_config(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    window = cfg.window if shape.name == "long_500k" else None
    return dataclasses.replace(cfg, window=window, dtype="bfloat16")


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """Batch stand-ins of a train/prefill step (full sequences)."""
    b, t = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        return {"codes": stand_in((b, cfg.n_codebooks, t)),
                "labels": stand_in((b, cfg.n_codebooks, t))}
    specs = {"tokens": stand_in((b, t)), "labels": stand_in((b, t))}
    if cfg.family == "vlm":
        # the ViT frontend stub delivers patch embeddings; text fills the rest
        tv = cfg.n_patches
        specs = {"tokens": stand_in((b, t - tv)),
                 "labels": stand_in((b, t)),
                 "vision_embeds": stand_in((b, tv, cfg.d_model),
                                           torch.bfloat16),
                 "positions3": stand_in((3, b, t))}
    return specs


def decode_specs(cfg: ModelConfig, shape: ShapeConfig
                 ) -> Dict[str, torch.Tensor]:
    """One-token decode batch."""
    b = shape.global_batch
    if cfg.family == "audio":
        return {"codes": stand_in((b, cfg.n_codebooks, 1))}
    out = {"tokens": stand_in((b, 1))}
    if cfg.family == "vlm":
        out["positions3"] = stand_in((3, b, 1))
    return out


def cache_capacity(cfg: ModelConfig, shape: ShapeConfig) -> int:
    cap = shape.seq_len
    if cfg.window is not None:
        cap = min(cap, cfg.window)
    return cap


def eval_shapes(fn, *args, **kw):
    """``fn``'s output for stand-in arguments: ``fn`` runs on ``meta``,
    where every operation computes shapes and dtypes only.  Raises on an
    argument tensor that is not on ``meta``."""
    from repro_torch.launch.rules import tree_leaves
    for leaf in tree_leaves((args, kw)):
        if isinstance(leaf, torch.Tensor) and not leaf.is_meta:
            raise ValueError(f"eval_shapes takes meta tensors, got one on "
                             f"{leaf.device}")
    return fn(*args, **kw)
