"""Carry the JAX package's decoder weights into the port's ``DecoderLM``.

The reference keeps a dense decoder's parameters as a pytree whose block
leaves are stacked over layers: ``embed`` (vocab, D), ``final_norm`` (D),
``head`` (D, vocab) unless the embeddings are tied, and
``blocks_dense/<path>`` of shape (L, ...).  Given that pytree flattened to
numpy arrays under ``/``-joined keys, :func:`load_reference_params` splits
each stacked leaf per layer and copies it into the port's parameter of the
same path (``blocks.<i>.<path>``).  Both packages keep (in, out) layouts,
so every copy is one to one.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.models.decoder import DecoderLM

_TOP = ("embed", "final_norm", "head")


def port_state(flat: Mapping[str, np.ndarray], n_layers: int
               ) -> Dict[str, np.ndarray]:
    """The reference's flat parameters renamed to the port's state-dict
    keys, stacked block leaves split per layer."""
    out: Dict[str, np.ndarray] = {}
    for key, arr in flat.items():
        arr = np.asarray(arr)
        head, _, rest = key.partition("/")
        if head == "blocks_dense" and rest:
            if arr.shape[:1] != (n_layers,):
                raise ValueError(f"{key}: leading axis {arr.shape[:1]} is not "
                                 f"the {n_layers} layers")
            for i in range(n_layers):
                out[f"blocks.{i}.{rest.replace('/', '.')}"] = arr[i]
        elif key in _TOP:
            out[key] = arr
        else:
            raise NotImplementedError(
                f"{key}: only the dense decoder's parameters are carried")
    return out


@torch.no_grad()
def load_reference_params(model: DecoderLM,
                          flat: Mapping[str, np.ndarray]) -> DecoderLM:
    """Copy the reference's parameters (flat, ``/``-joined keys) into
    ``model`` in place; every port parameter must be given exactly once and
    with its shape (a tied model has no ``head``).  Returns ``model``."""
    state = port_state(flat, model.cfg.n_layers)
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
