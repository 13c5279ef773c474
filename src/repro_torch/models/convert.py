"""Carry the JAX package's weights into the port: an LM's into
``DecoderLM`` and ``SSMLM`` (:func:`load_reference_params`), a CNN's into
``CNNModel`` (:func:`load_reference_cnn`).

The reference keeps an LM's parameters as a pytree whose block leaves are
stacked over layers: ``embed`` (vocab, D), ``final_norm`` (D), ``head``
(D, vocab) unless the embeddings are tied (an audio model's embed and head
span ``vocab * n_codebooks``), a vlm model's ``vis_proj`` (D, D), and

* dense decoder: ``blocks_dense/<path>`` of shape (L, ...);
* moe decoder: ``blocks_dense/<path>`` of shape (first_dense, ...) and
  ``blocks_moe/<path>`` of shape (L - first_dense, ...) (either left out
  when it has no layers), and with ``mtp`` the multi-token-prediction
  stack ``mtp_block/<path>`` of shape (mtp, ...) and ``mtp_proj``;
* ssm (Mamba2): ``blocks/<path>`` of shape (L, ...);
* hybrid (Zamba2): ``blocks/<path>`` of shape (groups, attn_every, ...) and
  the shared block's ``shared/<path>``, given once.

Given that pytree flattened to numpy arrays under ``/``-joined keys,
:func:`load_reference_params` splits each stacked leaf per layer and copies
it into the port's parameter of the same path (``blocks.<i>.<path>``, the
moe stack's layer j at ``i = first_dense + j``, the hybrid's group g,
block j at ``i = g * attn_every + j``; ``mtp_block.<j>.<path>``;
``shared.<path>``).
Both packages keep (in, out) layouts, so every copy is one to one.

A CNN's parameters and BatchNorm state are nested dicts keyed by block
and layer (``s1b0/exp/conv/w``, state ``s1b0/exp/bn/mean``); the port's
parameter or buffer of the same path (``s1b0.exp.conv.w``) takes each.
Both packages keep convolutions NCHW with OIHW weights, copied as they
are; a Dense weight is (in, out) there and (out, in) here, so it is
transposed.

The other way round, :func:`reference_leaves` lists a port model's
parameters as the reference's leaves (key, the port parameters that make
it up in stacking order, the leaf's shape: what the optimizers decide
their per-leaf rules on), and :func:`reference_params` gives the
reference's flat parameters, block leaves stacked again and Dense weights
transposed back, so that a checkpoint of either package loads in the
other.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.decoder import TokenLM
from repro_torch.nn.layers import Dense

_TOP = ("embed", "final_norm", "head", "vis_proj", "mtp_proj")


@dataclasses.dataclass(frozen=True)
class Stack:
    """One stacked leaf group of the reference: its key (``blocks_dense``),
    the port's module list (``blocks``), the first of its port blocks and
    the leaves' leading axes (their product is the number of blocks)."""
    key: str
    port: str
    start: int
    lead: Tuple[int, ...]

    @property
    def n(self) -> int:
        return int(np.prod(self.lead))


def stacks(cfg: ModelConfig) -> List[Stack]:
    """The reference's block stacks of ``cfg``'s family, in order."""
    if cfg.family == "hybrid":
        return [Stack("blocks", "blocks", 0,
                      (cfg.n_layers // cfg.attn_every, cfg.attn_every))]
    if cfg.family == "ssm":
        return [Stack("blocks", "blocks", 0, (cfg.n_layers,))]
    n_dense = cfg.first_dense if cfg.family == "moe" else cfg.n_layers
    out = [Stack("blocks_dense", "blocks", 0, (n_dense,)),
           Stack("blocks_moe", "blocks", n_dense, (cfg.n_layers - n_dense,)),
           Stack("mtp_block", "mtp_block", 0, (cfg.mtp,))]
    return [st for st in out if st.n]


def port_state(flat: Mapping[str, np.ndarray], cfg: ModelConfig
               ) -> Dict[str, np.ndarray]:
    """The reference's flat parameters renamed to the port's state-dict
    keys, stacked block leaves split per layer."""
    by_key = {st.key: st for st in stacks(cfg)}
    out: Dict[str, np.ndarray] = {}
    for key, arr in flat.items():
        arr = np.asarray(arr)
        head, _, rest = key.partition("/")
        path = rest.replace("/", ".")
        st = by_key.get(head)
        if st is not None and rest:
            if arr.shape[:len(st.lead)] != st.lead:
                raise ValueError(f"{key}: leading axis "
                                 f"{arr.shape[:len(st.lead)]} is not the "
                                 f"{st.lead} layers")
            layers = arr.reshape(st.n, *arr.shape[len(st.lead):])
            for i in range(st.n):
                out[f"{st.port}.{st.start + i}.{path}"] = layers[i]
        elif head == "shared" and rest and cfg.family == "hybrid":
            out[f"shared.{path}"] = arr
        elif key in _TOP:
            out[key] = arr
        else:
            raise NotImplementedError(
                f"{key}: not a parameter of a {cfg.family} model (its "
                f"stacks: {sorted(by_key)})")
    return out


@torch.no_grad()
def load_reference_params(model: TokenLM,
                          flat: Mapping[str, np.ndarray]) -> TokenLM:
    """Copy the reference's parameters (flat, ``/``-joined keys) into
    ``model`` in place; every port parameter must be given exactly once and
    with its shape (a tied model has no ``head``).  Returns ``model``."""
    state = port_state(flat, model.cfg)
    params = dict(model.named_parameters())
    if set(state) != set(params):
        raise KeyError(f"parameters differ: missing "
                       f"{sorted(set(params) - set(state))}, unexpected "
                       f"{sorted(set(state) - set(params))}")
    for name, p in params.items():
        src = torch.from_numpy(np.array(state[name]))
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} is not "
                             f"{tuple(p.shape)}")
        p.copy_(src.to(p.dtype))
    return model


def flatten_tree(tree: Mapping[str, Any], prefix: str = ""
                 ) -> Dict[str, np.ndarray]:
    """A nested dict of arrays as ``/``-joined keys to numpy arrays."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


@torch.no_grad()
def load_reference_cnn(model: torch.nn.Module, params: Mapping[str, Any],
                       state: Mapping[str, Any]) -> torch.nn.Module:
    """Copy the reference's CNN parameters and BatchNorm state (nested
    dicts of arrays, or flat ``/``-joined keys) into ``model`` in place:
    every parameter and buffer must be given exactly once, with its shape.
    ``model`` must have storage (``init_weights`` first: a model on the
    ``meta`` device has none).  Returns ``model``."""
    src = {**flatten_tree(params), **flatten_tree(state)}
    dense_w = {f"{n}.w" if n else "w" for n, m in model.named_modules()
               if isinstance(m, Dense)}
    dst = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    got = {k.replace("/", "."): v for k, v in src.items()}
    if set(got) != set(dst):
        raise KeyError(f"parameters differ: missing "
                       f"{sorted(set(dst) - set(got))}, unexpected "
                       f"{sorted(set(got) - set(dst))}")
    for name, t in dst.items():
        if t.is_meta:
            raise ValueError(f"{name} is on the meta device: call "
                             f"init_weights(device=...) first")
        arr = got[name].T if name in dense_w else got[name]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {tuple(got[name].shape)} does "
                             f"not fit {tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.array(arr, order="C")).to(t.dtype))
    return model


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One leaf of the reference's parameter pytree: the port parameters
    that make it up (one per stacked layer, in order, or a single one) and
    its shape.  A CNN's Dense weight keeps the port's (out, in) shape here,
    ``transposed`` marking that the reference's leaf is its transpose."""
    params: Tuple[nn.Parameter, ...]
    shape: Tuple[int, ...]
    transposed: bool = False

    def stack(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """``tensors`` (one per parameter, of its shape) as one tensor of
        the leaf's shape: a view for a leaf of one parameter."""
        if len(tensors) == 1:
            return tensors[0].reshape(self.shape)
        return torch.stack(list(tensors)).reshape(self.shape)

    def unstack(self, t: torch.Tensor) -> List[torch.Tensor]:
        """A tensor of the leaf's shape split into one view per parameter."""
        return list(t.reshape(len(self.params),
                              *self.params[0].shape).unbind(0))


def reference_leaves(model: nn.Module) -> Dict[str, Leaf]:
    """``model``'s parameters grouped as the reference's leaves, by the
    reference's ``/``-joined key.  An LM's block parameters
    ``blocks.<i>.<path>`` make one stacked leaf a stack
    (``blocks_dense/<path>`` of shape (L, ...), a moe model's
    ``blocks_dense`` and ``blocks_moe``, ``mtp_block``, or the hybrid's
    ``blocks/<path>`` of shape (groups, attn_every, ...)); any other
    module's parameters (a CNN's) are one leaf each, keyed by their path."""
    if not isinstance(model, TokenLM):
        dense_w = {f"{n}.w" if n else "w" for n, m in model.named_modules()
                   if isinstance(m, Dense)}
        return {name.replace(".", "/"): Leaf((p,), tuple(p.shape),
                                             name in dense_w)
                for name, p in model.named_parameters()}
    by_port: Dict[Tuple[str, int], Stack] = {}
    for st in stacks(model.cfg):
        for i in range(st.n):
            by_port[st.port, st.start + i] = st
    groups: Dict[str, List[nn.Parameter]] = {}
    lead: Dict[str, Tuple[int, ...]] = {}
    for name, p in model.named_parameters():
        head, _, rest = name.partition(".")
        idx, _, path = rest.partition(".")
        st = by_port.get((head, int(idx))) if idx.isdigit() else None
        if st is not None:
            key = f"{st.key}/{path.replace('.', '/')}"
            lead[key] = st.lead
        else:
            key = name.replace(".", "/")
        groups.setdefault(key, []).append(p)
    out = {}
    for key, ps in groups.items():
        shape = tuple(ps[0].shape)
        if key in lead:
            if len(ps) != int(np.prod(lead[key])):
                raise ValueError(f"{key}: {len(ps)} layers, not {lead[key]}")
            shape = lead[key] + shape
        out[key] = Leaf(tuple(ps), shape)
    return out


@torch.no_grad()
def reference_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s parameters as the reference's flat parameters (the
    inverse of :func:`port_state`): ``/``-joined keys, block leaves
    stacked, Dense weights transposed to (in, out); new tensors on the
    model's device."""
    out = {}
    for key, leaf in reference_leaves(model).items():
        t = leaf.stack([p.detach() for p in leaf.params]).clone()
        out[key] = t.T.contiguous() if leaf.transposed else t
    return out
