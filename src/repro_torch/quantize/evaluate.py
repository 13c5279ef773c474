"""Model-level quantization: measured accuracy (§IV-C).

``cnn_measured_accuracy`` builds the explorer's ``accuracy_fn``: for a cut
vector it executes the *partitioned, fake-quantized* CNN on a validation set
(weights at each platform's bit width, link activations quantized to the
producer's width) and returns top-1 accuracy.

The JAX package's functions take the parameters and state explicitly; the
port's models hold their weights, so ``model`` stands for all three.
Quantization-aware training (``qat_finetune``) waits for the port of the
reference's optimizers and train step (``ROADMAP.md`` B4).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from repro_torch.core.quant import QuantSpec, quantize_pytree
from repro_torch.serving.pipeline import PartitionedCNNRunner


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
