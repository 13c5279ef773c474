"""Optimizers: AdamW, Adafactor, SGD — the JAX package's
``repro.optim.optimizers``, rule for rule, so that the port's losses can
be held against the reference's.

The API keeps the reference's shape: ``opt.init(params) -> opt_state``;
``opt.update(grads, opt_state, params) -> (updates, opt_state)``;
``apply_updates(leaves, updates)`` then adds the updates to the model's
parameters in place.

``params``, ``grads`` and ``updates`` are dicts from the reference's leaf
keys to tensors of the reference's leaf shapes
(``models.convert.reference_leaves``): a dense or SSM LM's block
parameters, separate modules in the port, are one leaf of shape (L, ...)
there.  Three rules are decided per leaf, so they are decided here per
*reference* leaf: AdamW's and Adafactor's weight decay apply to leaves of
two or more dimensions (a stacked RMSNorm scale, ``A_log``, ``D`` and
``dt_bias`` are (L, ...) and decayed), Adafactor factors a leaf whose two
trailing dimensions are both >= ``min_dim_size_to_factor``, and its
update clip takes the RMS over the whole leaf.  :func:`stacked_params`
and :func:`stacked_grads` build these dicts from the model.

A CNN's leaves are not stacked, and its Dense weights are (out, in) here
and (in, out) in the reference.  Both are two-dimensional, and
Adafactor's factored second moment is symmetric under the transpose: the
row and column means swap roles, and its normaliser, the mean of the row
means, equals the mean of the column means; so the port's orientation is
kept.  Optimizer state is float32, a dict keyed as ``params``.

SGD, AdamW and the global-norm clip take every leaf in each of their
elementwise operations at once (``torch._foreach_*``: a few launches a
step, where one operation a leaf costs thousands for a CNN's ~200
leaves); each element sees the reference's operations in its order.
Adafactor's per-leaf reductions keep it a loop over leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Tuple

import torch

from repro_torch.models.convert import Leaf

Schedule = Callable[[torch.Tensor], torch.Tensor]
Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


def _to_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def _device(tree: Mapping[str, torch.Tensor]) -> torch.device:
    return next(iter(tree.values())).device


def _step0(tree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(tree))


def stacked_params(leaves: Mapping[str, Leaf]) -> Tree:
    """Each reference leaf's value: its port parameters stacked to the
    leaf's shape (a copy for a stacked leaf; the parameter itself, or a
    view of it, for a leaf of one parameter), detached."""
    return {k: leaf.stack([p.detach() for p in leaf.params])
            for k, leaf in leaves.items()}


def stacked_grads(leaves: Mapping[str, Leaf]) -> Tree:
    """Each reference leaf's gradient, stacked as :func:`stacked_params`
    (zeros for a parameter without one); the parameters' own ``.grad`` are
    dropped, so the next backward starts from none."""
    out = {}
    for k, leaf in leaves.items():
        out[k] = leaf.stack([torch.zeros_like(p) if p.grad is None else p.grad
                             for p in leaf.params])
        for p in leaf.params:
            p.grad = None
    return out


@torch.no_grad()
def apply_updates(leaves: Mapping[str, Leaf], updates: Tree) -> None:
    """Add each leaf's update to its port parameters, in place (the
    reference's ``(p + u).astype(p.dtype)`` for the float32 parameters
    every config has)."""
    params, parts = [], []
    for k, leaf in leaves.items():
        params.extend(leaf.params)
        parts.extend(leaf.unstack(updates[k]))
    torch._foreach_add_(params, parts)


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    """``grads`` scaled so that their global L2 norm is at most
    ``max_norm``, and that norm before scaling (a device tensor)."""
    keys = list(grads)
    norms = torch._foreach_norm([grads[k].float() for k in keys])
    gn = torch.sqrt(torch.sum(torch.square(torch.stack(norms))))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return dict(zip(keys, torch._foreach_mul([grads[k] for k in keys],
                                             scale))), gn


def sgd(lr, momentum: float = 0.9, nesterov: bool = False) -> Optimizer:
    """SGD with (Nesterov) momentum; ``lr`` a number or a schedule."""
    sched = _to_schedule(lr)

    def init(params):
        return {"mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "step": _step0(params)}

    def update(grads, state, params=None):
        keys = list(grads)
        g = [grads[k] for k in keys]
        step = state["step"] + 1
        mu = torch._foreach_mul([state["mu"][k] for k in keys], momentum)
        torch._foreach_add_(mu, g)
        upd = mu
        if nesterov:
            upd = torch._foreach_mul(mu, momentum)
            torch._foreach_add_(upd, g)
        lr_t = sched(step)
        return (dict(zip(keys, torch._foreach_mul(upd, -lr_t))),
                {"mu": dict(zip(keys, mu)), "step": step})

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    """AdamW, decoupled weight decay on the leaves of two or more
    dimensions, as the reference decides; ``lr`` a number or a schedule."""
    sched = _to_schedule(lr)

    def init(params):
        def zeros():
            return {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in params.items()}
        return {"m": zeros(), "v": zeros(), "step": _step0(params)}

    def update(grads, state, params):
        keys = list(grads)
        g = [grads[k].float() for k in keys]
        step = state["step"] + 1
        m = torch._foreach_mul([state["m"][k] for k in keys], b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        v = torch._foreach_mul([state["v"][k] for k in keys], b2)
        torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g),
                                                  1 - b2))
        t = step.float()
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        lr_t = sched(step)
        den = torch._foreach_sqrt(torch._foreach_div(v, bc2))
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(torch._foreach_div(m, bc1), den)
        # no decay on norms/bias: leaves of one dimension
        decayed = [i for i, k in enumerate(keys)
                   if weight_decay and params[k].dim() >= 2]
        if decayed:
            torch._foreach_add_([upd[i] for i in decayed], torch._foreach_mul(
                [params[keys[i]].float() for i in decayed], weight_decay))
        return (dict(zip(keys, torch._foreach_mul(upd, -lr_t))),
                {"m": dict(zip(keys, m)), "v": dict(zip(keys, v)),
                 "step": step})

    return Optimizer(init, update)


def adafactor(lr, min_dim_size_to_factor: int = 128,
              decay_rate: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern, 2018)."""
    sched = _to_schedule(lr)

    def _factored(p) -> bool:
        return (p.dim() >= 2 and p.shape[-1] >= min_dim_size_to_factor
                and p.shape[-2] >= min_dim_size_to_factor)

    def init(params):
        def one(p):
            z = dict(dtype=torch.float32, device=p.device)
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}
        return {"slots": {k: one(p) for k, p in params.items()},
                "step": _step0(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        t = step.float()
        beta = 1.0 - t ** (-decay_rate)
        lr_t = sched(step)

        def one(g, slot, p):
            g32 = g.float()
            g2 = torch.square(g32) + eps
            if "vr" in slot:
                vr = beta * slot["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * slot["vc"] + (1 - beta) * g2.mean(-2)
                denom = torch.clamp(vr.mean(-1, keepdim=True), min=eps)
                pre = (vr[..., None] / denom[..., None]) * vc[..., None, :]
                upd = g32 * torch.rsqrt(pre + eps)
                new_slot = {"vr": vr, "vc": vc}
            else:
                v = beta * slot["v"] + (1 - beta) * g2
                upd = g32 * torch.rsqrt(v + eps)
                new_slot = {"v": v}
            # update clipping (RMS <= clip_threshold) over the whole leaf
            rms = torch.sqrt(torch.mean(torch.square(upd)) + eps)
            upd = upd / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay and p.dim() >= 2:
                upd = upd + weight_decay * p.float()
            return -lr_t * upd, new_slot

        outs = {k: one(g, state["slots"][k], params[k])
                for k, g in grads.items()}
        return ({k: o[0] for k, o in outs.items()},
                {"slots": {k: o[1] for k, o in outs.items()}, "step": step})

    return Optimizer(init, update)


def get_optimizer(name: str, lr, **kw) -> Optimizer:
    """The optimizer a config names (``adamw``, ``adafactor`` or ``sgd``)."""
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    if name == "sgd":
        return sgd(lr, **kw)
    raise KeyError(f"unknown optimizer {name!r}")
