"""Carry the JAX package's LM weights into the port's ``DecoderLM`` and
``SSMLM``.

The reference keeps an LM's parameters as a pytree whose block leaves are
stacked over layers: ``embed`` (vocab, D), ``final_norm`` (D), ``head``
(D, vocab) unless the embeddings are tied, and

* dense decoder: ``blocks_dense/<path>`` of shape (L, ...);
* ssm (Mamba2): ``blocks/<path>`` of shape (L, ...);
* hybrid (Zamba2): ``blocks/<path>`` of shape (groups, attn_every, ...) and
  the shared block's ``shared/<path>``, given once.

Given that pytree flattened to numpy arrays under ``/``-joined keys,
:func:`load_reference_params` splits each stacked leaf per layer and copies
it into the port's parameter of the same path (``blocks.<i>.<path>``, the
hybrid's group g, block j at ``i = g * attn_every + j``; ``shared.<path>``).
Both packages keep (in, out) layouts, so every copy is one to one.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.decoder import TokenLM

_TOP = ("embed", "final_norm", "head")
_STACKED = {"dense": "blocks_dense", "ssm": "blocks", "hybrid": "blocks"}


def _leading(cfg: ModelConfig) -> Tuple[int, ...]:
    """The stacked leaves' leading axes."""
    if cfg.family == "hybrid":
        return (cfg.n_layers // cfg.attn_every, cfg.attn_every)
    return (cfg.n_layers,)


def port_state(flat: Mapping[str, np.ndarray], cfg: ModelConfig
               ) -> Dict[str, np.ndarray]:
    """The reference's flat parameters renamed to the port's state-dict
    keys, stacked block leaves split per layer."""
    stacked = _STACKED.get(cfg.family)
    lead = _leading(cfg)
    out: Dict[str, np.ndarray] = {}
    for key, arr in flat.items():
        arr = np.asarray(arr)
        head, _, rest = key.partition("/")
        path = rest.replace("/", ".")
        if head == stacked and rest:
            if arr.shape[:len(lead)] != lead:
                raise ValueError(f"{key}: leading axis "
                                 f"{arr.shape[:len(lead)]} is not the "
                                 f"{lead} layers")
            layers = arr.reshape(cfg.n_layers, *arr.shape[len(lead):])
            for i in range(cfg.n_layers):
                out[f"blocks.{i}.{path}"] = layers[i]
        elif head == "shared" and rest and cfg.family == "hybrid":
            out[f"shared.{path}"] = arr
        elif key in _TOP:
            out[key] = arr
        else:
            raise NotImplementedError(
                f"{key}: not a {cfg.family} parameter; the dense decoder's, "
                f"the ssm and the hybrid models' parameters are carried")
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
