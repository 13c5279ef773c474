"""Checkpointing: flat .npz save/restore in the JAX package's layout
(``repro.checkpoint.ckpt``), so that either package reads the other's.

A tree (nested dicts, lists and tuples of tensors or arrays) is flattened
with ``/``-joined key paths — a dict key as it is, a sequence index as
``#i`` — into ``ckpt_{step:08d}.npz``.  A ``None`` is an empty subtree,
as in the reference's ``tree_flatten_with_path``: nothing is written for
it, and restore gives ``None`` back.  Shapes and values round-trip
exactly; a bfloat16 tensor is stored as float32 (which holds it exactly)
and cast back on restore.  A port model's parameters go in as
``models.convert.reference_params(model)``, the reference's flat layout,
and come back through ``models.convert.load_reference_params``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(key, leaf)`` of every leaf of ``tree``, keys ``/``-joined; a
    ``None`` has no leaves."""
    if tree is None:
        return
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((f"#{i}", v) for i, v in enumerate(tree))
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _leaves(v, f"{prefix}/{k}" if prefix else k)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in _leaves(tree)}


def save(path: str, tree, step: Optional[int] = None) -> str:
    """Save ``tree``; returns the file written."""
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"ckpt_{step or 0:08d}.npz")
    np.savez(fname, **_flatten(tree))
    return fname


def _like(arr: np.ndarray, leaf):
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, np.ndarray):
        return arr.astype(leaf.dtype, copy=False)
    return arr


def _rebuild(tree, data, prefix: str = ""):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, data, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _rebuild(v, data, f"{prefix}/#{i}" if prefix else f"#{i}")
            for i, v in enumerate(tree))
    return _like(data[prefix], tree)


def restore(path: str, like, step: Optional[int] = None):
    """Restore into the structure of ``like`` (a template tree): each leaf
    takes the template's dtype, and a tensor its device."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    fname = os.path.join(path, f"ckpt_{step:08d}.npz")
    with np.load(fname) as data:
        return _rebuild(like, data)


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = []
    for f in os.listdir(path):
        m = re.match(r"ckpt_(\d+)\.npz$", f)
        if m:
            steps.append(int(m.group(1)))
    return max(steps) if steps else None
