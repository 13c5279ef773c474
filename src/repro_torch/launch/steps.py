"""The steps shared by the dry-run and a real run (the JAX package's
``repro.launch.steps``).

``build_train_setup`` / ``build_prefill_setup`` / ``build_serve_setup``
return a :class:`Setup`: the step, its argument stand-ins in the
reference's layout, and their shardings on a mesh.  Built on ``meta``
(the default) nothing is allocated and the step runs on the stand-ins,
computing shapes only: that is the dry-run.  Built on a device, the model
holds seeded weights there and ``Setup.args`` holds the step's state
there (the optimizer state, or the caches); the batch stays a stand-in
for the caller to replace.

The port's models hold their parameters, so a step's ``params`` (and the
train step's model ``state``, always ``{}``) are stand-ins that the step
passes through: ``step_fn(*arg_shapes)`` runs the reference's signature,
and a train step updates the model in place.  The steps take the models'
plain attention (``impl="ref"``), as the reference's setups do, so that
every step runs on ``meta``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import rules as R
from repro_torch.launch import specs as S
from repro_torch.models.convert import reference_leaves
from repro_torch.models.registry import build_model
from repro_torch.nn.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.training.train_lib import init_params, make_train_step


@dataclasses.dataclass
class Setup:
    cfg: ModelConfig
    model: Any
    step_fn: Any                    # callable(*args)
    arg_shapes: Tuple               # meta stand-ins
    in_shardings: Tuple
    out_shardings: Any
    out_shapes: Any = None          # meta stand-ins of the step's outputs
    args: Tuple = ()                # the arguments on the build device


def _model(cfg: ModelConfig, device, seed: int):
    device = torch.device(device)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    return build_model(cfg, device=device, generator=gen)


def _stand_ins(tree):
    """Meta stand-ins of every tensor of ``tree``."""
    return R.tree_map_with_path(
        lambda _, t: S.stand_in(t.shape, t.dtype), tree)


def param_shapes(model) -> dict:
    """Stand-ins of the model's parameters as the reference's leaves."""
    return {k: S.stand_in(leaf.shape, leaf.params[0].dtype)
            for k, leaf in reference_leaves(model).items()}


def _out_shapes(cfg, model, build_step, args, counter=None):
    """The step's outputs on ``meta``: ``build_step`` of the model, or of a
    meta twin of it (no weights) when it is on a device, run on the
    stand-ins ``args``, under ``counter`` (a dispatch mode) when given."""
    if model.device.type != "meta":
        model = build_model(cfg, device="meta")
    with counter or contextlib.nullcontext():
        return S.eval_shapes(build_step(model), *args)


def build_train_setup(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                      multi_pod: bool = False, seed: int = 0,
                      grad_accum: int = 1, device="meta",
                      counter=None) -> Setup:
    """One optimizer step of ``cfg.optimizer`` (lr 1e-4) over a
    ``shape`` batch; ``args`` (params, opt_state, {}, batch).  The step's
    one run on ``meta`` (for its output shapes) runs under ``counter``
    when given: the dry-run counts that run."""
    cfg = S.run_config(cfg, shape)
    model = _model(cfg, device, seed)

    def build_step(m):
        opt = get_optimizer(cfg.optimizer, 1e-4)
        step = make_train_step(m, cfg, opt, grad_accum=grad_accum)

        def train_step(params, opt_state, state, batch):
            opt_state, metrics = step(opt_state, batch)
            return params, opt_state, state, metrics
        return train_step

    params_shapes = param_shapes(model)
    opt = get_optimizer(cfg.optimizer, 1e-4)
    opt_state = opt.init(params_shapes if model.device.type == "meta"
                         else init_params(model))
    opt_shapes = _stand_ins(opt_state)
    batch_shapes = S.input_specs(cfg, shape)
    arg_shapes = (params_shapes, opt_shapes, {}, batch_shapes)

    hybrid = cfg.family == "hybrid"
    p_shard = R.params_shardings(params_shapes, mesh, hybrid)
    o_shard = R.params_shardings(opt_shapes, mesh, hybrid)
    b_shard = R.batch_shardings(batch_shapes, mesh, multi_pod,
                                shape.global_batch)
    outs = _out_shapes(cfg, model, build_step, arg_shapes, counter)
    out_shardings = (p_shard, o_shard, {}, R.replicated(outs[3], mesh))
    return Setup(cfg, model, build_step(model), arg_shapes,
                 (p_shard, o_shard, {}, b_shard), out_shardings, outs,
                 (params_shapes, opt_state, {}, batch_shapes))


def build_prefill_setup(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                        multi_pod: bool = False, seed: int = 0,
                        device="meta", counter=None) -> Setup:
    """The forward over a ``shape`` batch, returning the last position's
    logits (what serving needs); ``args`` (params, batch)."""
    cfg = S.run_config(cfg, shape)
    model = _model(cfg, device, seed)

    def build_step(m):
        @torch.no_grad()
        def prefill_step(params, batch):
            return m(batch, train=False)[:, -1]
        return prefill_step

    params_shapes = param_shapes(model)
    batch_shapes = S.input_specs(cfg, shape)
    batch_shapes.pop("labels", None)
    hybrid = cfg.family == "hybrid"
    p_shard = R.params_shardings(params_shapes, mesh, hybrid)
    b_shard = R.batch_shardings(batch_shapes, mesh, multi_pod,
                                shape.global_batch)
    arg_shapes = (params_shapes, batch_shapes)
    out_shapes = _out_shapes(cfg, model, build_step, arg_shapes, counter)
    nb = mesh.shape.get("pod", 1) * mesh.shape["data"]
    out_shard = NamedSharding(
        mesh, P(("pod", "data") if multi_pod else "data",
                *([None] * (len(out_shapes.shape) - 1)))
        if shape.global_batch % nb == 0
        else P(*([None] * len(out_shapes.shape))))
    return Setup(cfg, model, build_step(model), arg_shapes,
                 (p_shard, b_shard), out_shard, out_shapes, arg_shapes)


def build_serve_setup(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                      multi_pod: bool = False, seed: int = 0,
                      device="meta", counter=None) -> Setup:
    """One-token decode step against a seq_len-deep cache; ``args``
    (params, caches, batch)."""
    cfg = S.run_config(cfg, shape)
    model = _model(cfg, device, seed)

    def build_step(m):
        @torch.no_grad()
        def serve_step(params, caches, batch):
            return m.decode_step(caches, batch)
        return serve_step

    params_shapes = param_shapes(model)
    cap = S.cache_capacity(cfg, shape)
    caches = model.init_caches(shape.global_batch, cap, torch.bfloat16)
    cache_shapes = _stand_ins(caches)
    batch_shapes = S.decode_specs(cfg, shape)

    hybrid = cfg.family == "hybrid"
    p_shard = R.params_shardings(params_shapes, mesh, hybrid)
    c_shard = R.cache_shardings(cache_shapes, mesh, multi_pod,
                                shape.global_batch)
    b_shard = R.batch_shardings(batch_shapes, mesh, multi_pod,
                                shape.global_batch)
    arg_shapes = (params_shapes, cache_shapes, batch_shapes)
    outs = _out_shapes(cfg, model, build_step, arg_shapes, counter)
    out_shardings = (R.replicated(outs[0], mesh), c_shard)
    return Setup(cfg, model, build_step(model), arg_shapes,
                 (p_shard, c_shard, b_shard), out_shardings, outs,
                 (params_shapes, caches, batch_shapes))


def build_setup(kind: str, cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                multi_pod: bool = False, grad_accum: int = 1,
                device="meta", counter=None) -> Setup:
    kw = dict(device=device, counter=counter)
    if kind == "train":
        return build_train_setup(cfg, shape, mesh, multi_pod,
                                 grad_accum=grad_accum, **kw)
    if kind == "prefill":
        return build_prefill_setup(cfg, shape, mesh, multi_pod, **kw)
    if kind == "decode":
        return build_serve_setup(cfg, shape, mesh, multi_pod, **kw)
    raise KeyError(kind)
