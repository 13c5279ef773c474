"""Model-level quantization: measured accuracy + QAT (§IV-C).

``cnn_measured_accuracy`` builds the explorer's ``accuracy_fn``: for a cut
vector it executes the *partitioned, fake-quantized* CNN on a validation set
(weights at each platform's bit width, link activations quantized to the
producer's width) and returns top-1 accuracy.  ``lm_measured_accuracy`` is
its twin for an LM of the mixed or moe family: the share of next-token
positions at which the partitioned, fake-quantized model's top-1 is the
label.

``qat_finetune`` runs quantization-aware training: every forward quantizes
the parameters with straight-through gradients, so the float master weights
adapt to the quantization grid — the paper's accuracy-restoration step.

The JAX package's functions take the parameters and state explicitly; the
port's models hold their weights, so ``model`` stands for all three.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from repro_torch.core.quant import QuantSpec, quantize_pytree
from repro_torch.models.convert import reference_leaves
from repro_torch.nn.module import trainable
from repro_torch.obs.handle import NOOP_OBS, Obs
from repro_torch.optim.optimizers import (Optimizer, apply_updates,
                                          clip_by_global_norm, stacked_grads,
                                          stacked_params)
from repro_torch.serving.pipeline import (CHAIN_FAMILIES, TRACK,
                                          PartitionedCNNRunner,
                                          PartitionedLMRunner)
from repro_torch.training.train_lib import cross_entropy


def _top1(logits: torch.Tensor, y: torch.Tensor) -> float:
    return _top1_of(logits.argmax(-1), y)


def _top1_of(pred: torch.Tensor, y: torch.Tensor) -> float:
    return float((pred == y).to(torch.float32).mean())


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
                          obs: Optional[Obs] = None,
                          ) -> Callable[[Sequence[int]], float]:
    """accuracy_fn(cuts) for the explorer (2+-platform CNN systems).

    Each cut vector runs as :func:`partition_plan` lays it out; results
    are cached per cut vector.  ``obs`` (default off,
    :data:`~repro_torch.obs.NOOP_OBS`): switched on, each call records an
    ``oracle.measure`` span (``cuts``, ``cached``) on the ``oracle`` track
    around the runner's spans (:class:`PartitionedCNNRunner`) and an
    ``oracle.read``, the top-1's read back to the host."""
    obs = NOOP_OBS if obs is None else obs
    model.to_graph()   # populate graph_boundaries
    cache: Dict[Tuple[int, ...], float] = {}
    dev = model.device
    xd = torch.as_tensor(val_x, device=dev)
    yd = torch.as_tensor(val_y, device=dev)

    def measure(cuts) -> float:
        on = obs.enabled
        if on:
            t0 = time.perf_counter()
        key = tuple(int(c) for c in cuts)
        if key in cache:
            if on:
                obs.tracer.complete("oracle.measure", track=TRACK, start=t0,
                                    args={"cuts": key, "cached": True})
            return cache[key]
        runner_cuts, specs = partition_plan(model, schedule, key, quant_specs)
        logits, _ = PartitionedCNNRunner(model, runner_cuts, specs,
                                         obs=obs).run(xd)
        if on:
            t1 = time.perf_counter()
        acc = _top1(logits, yd)
        if on:
            t2 = time.perf_counter()
            obs.tracer.complete("oracle.read", track=TRACK, start=t1, end=t2)
            obs.tracer.complete("oracle.measure", track=TRACK, start=t0,
                                end=t2, args={"cuts": key, "cached": False})
        cache[key] = acc
        return acc

    return measure


ORACLE_POSITIONS = "oracle_positions"   # counter: positions scored


def lm_measured_accuracy(model, schedule, tokens, labels,
                         quant_specs: Sequence[QuantSpec],
                         link_quant: bool = True,
                         obs: Optional[Obs] = None):
    """accuracy_fn(cuts) for the explorer on a ``MixedLM`` or a moe-family
    ``DecoderLM`` (the chains of ``PartitionedLMRunner``): the twin of
    :func:`cnn_measured_accuracy`.

    Each cut vector (positions of ``schedule``, the model's chain) runs
    through one :class:`PartitionedLMRunner` on ``tokens`` (B, T), its
    stages' weights at their platforms' widths and, with ``link_quant``,
    the activations crossing the links at the producer's; the result is
    the share of the B x (T - 1) next-token positions at which the top-1
    equals ``labels`` (B, T - 1), e.g. the float model's top-1.  Results
    are cached per cut vector.  ``measure(cuts, keep=idx)`` also keeps, in
    ``measure.kept[cuts]``, the logits at the flat positions ``idx`` (of
    the B x T) and the top-1 at every position, and is never answered by
    the cache.  The runner takes the kernels on a CUDA tensor (``impl``
    ``"auto"``).  ``obs`` (default off, :data:`~repro_torch.obs.NOOP_OBS`):
    switched on, each call records an ``oracle.measure`` span (``cuts``,
    ``cached``) around the runner's spans and an ``oracle.read``, the
    accuracy's read back to the host, and counts the positions scored in
    ``oracle_positions``.  ``repro_torch.core.accuracy`` registers it as
    the measured oracle ``lm_fakequant`` (an ``AccuracySpec`` of kind
    ``measured``: the registry model, reduced or not, at ``seq`` tokens)."""
    if model.cfg.family not in CHAIN_FAMILIES:
        raise ValueError(f"{model.cfg.arch_id}: lm_measured_accuracy scores "
                         f"the mixed family and the moe family, not "
                         f"{model.cfg.family!r}")
    obs = NOOP_OBS if obs is None else obs
    names = [layer.name for layer in schedule]
    if names != list(model.to_graph(1).nodes):
        raise ValueError("the schedule is not the model's chain")
    cache: Dict[Tuple[int, ...], float] = {}
    dev = model.device
    td = torch.as_tensor(tokens, device=dev)
    yd = torch.as_tensor(labels, device=dev)
    if yd.shape != (td.shape[0], td.shape[1] - 1):
        raise ValueError(f"labels {tuple(yd.shape)} are not the "
                         f"{tuple(td.shape)} tokens' next-token positions")

    @torch.no_grad()
    def measure(cuts, keep: Optional[torch.Tensor] = None) -> float:
        on = obs.enabled
        if on:
            t0 = time.perf_counter()
        key = tuple(int(c) for c in cuts)
        if key in cache and keep is None:
            if on:
                obs.tracer.complete("oracle.measure", track=TRACK, start=t0,
                                    args={"cuts": key, "cached": True})
            return cache[key]
        logits, _ = PartitionedLMRunner(model, key, quant_specs, link_quant,
                                        impl="auto", obs=obs).forward(
                                            {"tokens": td})
        top1 = logits.argmax(-1)
        if keep is not None:
            measure.kept[key] = {
                "logits": logits.reshape(-1, logits.shape[-1])[keep],
                "top1": top1}
        del logits
        if on:
            t1 = time.perf_counter()
        acc = _top1_of(top1[:, :-1], yd)
        if on:
            t2 = time.perf_counter()
            obs.tracer.complete("oracle.read", track=TRACK, start=t1, end=t2)
            obs.tracer.complete("oracle.measure", track=TRACK, start=t0,
                                end=t2, args={"cuts": key, "cached": False})
            obs.metrics.counter(ORACLE_POSITIONS).inc(yd.numel())
        cache[key] = acc
        return acc

    measure.kept = {}
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
