"""Model-level quantization: measured accuracy + QAT (§IV-C).

``cnn_measured_accuracy`` builds the explorer's ``accuracy_fn``: for a cut
vector it executes the *partitioned, fake-quantized* CNN on a validation set
(weights at each platform's bit width, link activations quantized to the
producer's width) and returns top-1 accuracy.

``qat_finetune`` runs quantization-aware training: every forward quantizes
the parameters with straight-through gradients, so the float master weights
adapt to the quantization grid — the paper's accuracy-restoration step.

The JAX package's functions take the parameters and state explicitly; the
port's models hold their weights, so ``model`` stands for all three.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from repro_torch.core.quant import QuantSpec, quantize_pytree
from repro_torch.models.convert import reference_leaves
from repro_torch.nn.module import trainable
from repro_torch.optim.optimizers import (Optimizer, apply_updates,
                                          clip_by_global_norm, stacked_grads,
                                          stacked_params)
from repro_torch.serving.pipeline import PartitionedCNNRunner
from repro_torch.training.train_lib import cross_entropy


def _top1(logits: torch.Tensor, y: torch.Tensor) -> float:
    return float((logits.argmax(-1) == y).to(torch.float32).mean())


@torch.no_grad()
def quantized_eval(model, x, y, spec: QuantSpec) -> float:
    """Monolithic fake-quant eval (whole model at one bit width): top-1
    accuracy of ``model`` on (x, y) with every weight fake-quantized."""
    dev = model.device
    logits = functional_call(model, quantize_pytree(model, spec),
                             (torch.as_tensor(x, device=dev),))
    return _top1(logits, torch.as_tensor(y, device=dev))


def partition_plan(model, schedule, cuts: Sequence[int],
                   quant_specs: Sequence[QuantSpec]
                   ) -> Tuple[List[int], List[QuantSpec]]:
    """The block cuts and stage specs that execute the cut vector ``cuts``
    (positions in ``schedule``, ``-1`` the sentinel: no cut) with
    :class:`PartitionedCNNRunner`: each position maps to the last block its
    prefix holds whole, and platforms whose segment holds no block drop
    out, their spec with them."""
    block_cuts = [model.cut_to_block(schedule, c) if c >= 0 else -1
                  for c in cuts]
    # drop sentinel/duplicate cuts for the runner, remember platforms
    bounds = [-1] + block_cuts + [len(model.blocks) - 1]
    seg_specs = []
    for k in range(len(quant_specs)):
        a, b = bounds[k] + 1, bounds[k + 1]
        if b >= a:
            seg_specs.append((a, b, quant_specs[k]))
    return ([b for (_, b, _) in seg_specs[:-1]],
            [s for (_, _, s) in seg_specs])


def cnn_measured_accuracy(model, schedule, val_x: np.ndarray,
                          val_y: np.ndarray,
                          quant_specs: Sequence[QuantSpec],
                          ) -> Callable[[Sequence[int]], float]:
    """accuracy_fn(cuts) for the explorer (2+-platform CNN systems).

    Each cut vector runs as :func:`partition_plan` lays it out; results
    are cached per cut vector."""
    model.to_graph()   # populate graph_boundaries
    cache: Dict[Tuple[int, ...], float] = {}
    dev = model.device
    xd = torch.as_tensor(val_x, device=dev)
    yd = torch.as_tensor(val_y, device=dev)

    def measure(cuts) -> float:
        key = tuple(int(c) for c in cuts)
        if key in cache:
            return cache[key]
        runner_cuts, specs = partition_plan(model, schedule, key, quant_specs)
        logits, _ = PartitionedCNNRunner(model, runner_cuts, specs).run(xd)
        acc = _top1(logits, yd)
        cache[key] = acc
        return acc

    return measure


def qat_finetune(model, spec: QuantSpec, optimizer: Optimizer, data_iter,
                 steps: int = 50):
    """QAT loop: fake-quant in the forward, STE gradients to float masters.

    Each step runs ``model`` in training mode on its parameters
    fake-quantized (``quantize_pytree`` through ``functional_call``; the
    BatchNorm running statistics update in place, as in training), then
    cross-entropy, a clip of the global norm to 1.0 and the optimizer step
    on the float parameters.  ``model`` is updated in place, left in eval
    mode, and returned.  The reference's ``classifier`` argument, which
    changes nothing there (the loss is cross-entropy either way), has no
    twin here."""
    trainable(model)
    leaves = reference_leaves(model)
    dev = model.device
    opt_state = optimizer.init(stacked_params(leaves))
    for _ in range(steps):
        x, y = next(data_iter)
        x, y = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
        model.train()
        try:
            logits = functional_call(model, quantize_pytree(model, spec),
                                     (x,))
        finally:
            model.eval()
        cross_entropy(logits, y).backward()
        grads, _ = clip_by_global_norm(stacked_grads(leaves), 1.0)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state,
                                                  stacked_params(leaves))
            apply_updates(leaves, updates)
    return model
