"""Training loop machinery: losses, train step factories, state container
(the JAX package's ``repro.training.train_lib``).

The port's models hold their parameters, so a train step updates the
model in place and carries only the optimizer state:
``step(opt_state, batch) -> (opt_state, metrics)``.  Gradients come from
autograd; the optimizer sees them grouped as the reference's leaves
(``models.convert.reference_leaves``), so its per-leaf rules are the
reference's.  Metrics stay tensors on the model's device: the step reads
nothing back to the host, and a caller that prints them synchronizes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.convert import reference_leaves
from repro_torch.nn.module import trainable
from repro_torch.optim.optimizers import (Optimizer, apply_updates,
                                          clip_by_global_norm, stacked_grads,
                                          stacked_params)

IGNORE = -100


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore: int = IGNORE) -> torch.Tensor:
    """Mean token CE; labels == ignore are masked out."""
    mask = labels != ignore
    safe = torch.where(mask, labels, 0).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)


def lm_loss(cfg: ModelConfig, logits: torch.Tensor, batch: Dict,
            aux: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss + aux terms (MoE balance, z-loss, MTP)."""
    labels = batch["labels"]
    if cfg.family == "audio":
        # logits (B,T,K,V), labels (B,K,T)
        loss = cross_entropy(logits, labels.transpose(1, 2))
    else:
        loss = cross_entropy(logits, labels)
    metrics = {"ce": loss}
    total = loss
    if "lb_loss" in aux:
        total = total + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
        metrics["lb_loss"] = aux["lb_loss"]
        metrics["dropped"] = aux["dropped"]
    if "mtp_logits" in aux:
        mtp_labels = torch.roll(labels, -1, dims=-1)
        mtp_labels[..., -1] = IGNORE
        mtp = cross_entropy(aux["mtp_logits"], mtp_labels)
        total = total + 0.3 * mtp
        metrics["mtp"] = mtp
    metrics["loss"] = total
    return total, metrics


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    model_state: Any
    step: int = 0


def _on_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _microbatches(batch: Dict[str, torch.Tensor], n: int):
    """``batch`` split into ``n`` microbatches along its batch axis (axis 1
    of ``positions3`` (3, B, T), axis 0 of every other entry)."""
    parts = {}
    for k, v in batch.items():
        axis = 1 if k == "positions3" else 0
        b = v.shape[axis]
        if b % n:
            raise ValueError(f"batch {b} of {k!r} is not {n} microbatches")
        parts[k] = v.split(b // n, dim=axis)
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


def make_train_step(model, cfg: ModelConfig, optimizer: Optimizer,
                    clip_norm: Optional[float] = 1.0,
                    impl: str = "ref", grad_accum: int = 1) -> Callable:
    """Returns ``train_step(opt_state, batch) -> (opt_state, metrics)``,
    which updates ``model`` (made trainable here) in place; the first
    ``opt_state`` is ``optimizer.init(init_params(model))``.

    ``grad_accum > 1`` splits the batch into that many microbatches and
    sums their float32 gradients before dividing, as the reference's
    ``lax.scan`` does: live activation memory scales with the microbatch.
    The loss metrics are then the microbatches' means."""
    trainable(model)
    leaves = reference_leaves(model)
    dev = model.device

    def loss_fn(batch):
        logits, aux = model.forward_aux(batch, impl=impl, train=True)
        return lm_loss(cfg, logits, batch, aux)

    def compute_grads(batch):
        if grad_accum <= 1:
            total, metrics = loss_fn(batch)
            total.backward()
            return stacked_grads(leaves), metrics
        ms = []
        for mb in _microbatches(batch, grad_accum):
            total, m = loss_fn(mb)
            total.backward()      # .grad sums the microbatches' gradients
            ms.append({k: v.detach() for k, v in m.items()})
        grads = {k: g / grad_accum for k, g in stacked_grads(leaves).items()}
        metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        return grads, metrics

    def train_step(opt_state, batch):
        grads, metrics = compute_grads(_on_device(batch, dev))
        metrics = {k: v.detach() for k, v in metrics.items()}
        if clip_norm is not None:
            grads, gn = clip_by_global_norm(grads, clip_norm)
            metrics["grad_norm"] = gn
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state,
                                                  stacked_params(leaves))
            apply_updates(leaves, updates)
        return opt_state, metrics

    return train_step


def init_params(model) -> Dict[str, torch.Tensor]:
    """``model``'s parameters as the optimizer's ``params``: one tensor of
    each reference leaf's shape (``optimizer.init(init_params(model))``)."""
    return stacked_params(reference_leaves(model))


def make_classifier_train_step(model, optimizer: Optimizer,
                               clip_norm: Optional[float] = 1.0) -> Callable:
    """Train step for the CNN zoo: ``step(opt_state, x, y) -> (opt_state,
    metrics)``.  The forward runs in training mode (BatchNorm on the
    batch's statistics, its running statistics updated in place); the
    model is left in eval mode."""
    trainable(model)
    leaves = reference_leaves(model)
    dev = model.device

    def step(opt_state, x, y):
        x, y = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
        model.train()
        try:
            logits = model(x)
        finally:
            model.eval()
        loss = cross_entropy(logits, y)
        acc = (logits.argmax(-1) == y).float().mean()
        loss.backward()
        grads = stacked_grads(leaves)
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state,
                                                  stacked_params(leaves))
            apply_updates(leaves, updates)
        return opt_state, {"loss": loss.detach(), "acc": acc}

    return step


@torch.no_grad()
def evaluate_classifier(model, x, y) -> float:
    """Top-1 accuracy of ``model`` (its running statistics) on (x, y)."""
    dev = model.device
    was = model.training
    model.eval()
    logits = model(torch.as_tensor(x, device=dev))
    model.train(was)
    return float((logits.argmax(-1) == torch.as_tensor(y, device=dev))
                 .float().mean())
