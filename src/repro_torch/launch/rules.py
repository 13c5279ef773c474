"""Sharding rules (the JAX package's ``repro.launch.rules``): logical-axis
tables per run kind, and the specs of parameters, batches and caches.

Training uses FSDP x TP: weights 2-D sharded over (data, model),
activations batch-over-data with *sequence parallelism* (residual stream
seq over model).  Decode shards the KV cache over batch (data) and
sequence (model): GQA kv heads are often < 16, so head-sharding the cache
is not generally possible.

A parameter's path is the reference's leaf path (``blocks_dense/attn/wq``,
``models.convert.reference_leaves``), so every spec here can be compared
with the reference's string for string.  Trees are nested dicts, lists
and tuples of tensors (on ``meta`` or a device: only shapes are read);
a leaf's path is its keys joined by ``/``.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict

from repro_torch.nn import sharding as shd
from repro_torch.nn.sharding import Mesh, NamedSharding, PartitionSpec as P


def activation_rules(kind: str, multi_pod: bool, batch_divisible: bool,
                     opts: tuple = ()) -> Dict[str, object]:
    """Logical-axis table of a run.

    opts — §Perf optimizations:
      "attn_heads": attention-local kv-head sharding (+ kv duplication);
      "mla_latent": shard the MLA compressed latent over the model axis;
      "fsdp": batch over every mesh axis, no tensor/sequence parallelism;
      "remat_dots": remat keeps matmul outputs (``remat_policy``);
      "expert_ep": experts over (data, model);
      "softmax_low": the softmax in the compute dtype (``softmax_dtype``).
    """
    batch_ax = ("pod", "data") if multi_pod else "data"
    rules = dict(shd.DEFAULT_RULES)
    rules["batch"] = batch_ax if batch_divisible else None
    if kind in ("train", "prefill"):
        rules["seq"] = "model"            # sequence parallelism
        rules["expert_cap"] = None
    else:                                  # decode: T == 1
        rules["seq"] = None
    rules["kv_seq"] = "model"
    # kv heads are small (often 4-8): never shard them as activations
    rules["kv_heads"] = None
    if "attn_heads" in opts:
        rules["attn_kv"] = "model"
    if "mla_latent" in opts:
        rules["mla_latent"] = "model"
    if "fsdp" in opts:
        # pure FSDP: batch over EVERY mesh axis, no tensor/sequence
        # parallelism — weights stay 2-D sharded (ZeRO-3 gathers at use)
        all_axes = (("pod", "data", "model") if multi_pod
                    else ("data", "model"))
        rules["batch"] = all_axes if batch_divisible else None
        rules["seq"] = None
        rules["heads"] = None
        rules["kv_heads"] = None
        rules["mlp"] = None
        rules["vocab"] = None
        rules["experts"] = "model"     # expert weights stay expert-sharded
    if "remat_dots" in opts:
        rules["remat_policy"] = "dots"
    if "expert_ep" in opts:
        rules["experts"] = ("data", "model")
    if "softmax_low" in opts:
        rules["softmax_dtype"] = "compute"
    return rules


# -- parameter partition specs ------------------------------------------------

_PARAM_RULES = [
    # (path regex, the spec as a function of the UNSTACKED leaf ndim)
    (r"embed$", lambda nd: ["model", "data"]),                # (vocab, d)
    (r"head$", lambda nd: ["data", "model"]),                 # (d, vocab)
    (r"vis_proj$", lambda nd: ["data", "model"]),
    (r"mtp_proj$", lambda nd: ["data", "model"]),
    (r"(wq|wk|wv)$", lambda nd: ["data", "model"]),           # (d, h*hd)
    (r"wo$", lambda nd: ["model", "data"]),
    (r"(w_gate|w_up)$", lambda nd: (["model", "data", None]   # (E, d, ff)
                                    if nd == 3 else ["data", "model"])),
    (r"w_down$", lambda nd: (["model", None, "data"]
                             if nd == 3 else ["model", "data"])),
    (r"(sh_gate|sh_up)$", lambda nd: ["data", "model"]),
    (r"sh_down$", lambda nd: ["model", "data"]),
    (r"router$", lambda nd: ["data", None]),
    (r"w_dq$", lambda nd: ["data", None]),                    # MLA
    (r"w_uq$", lambda nd: [None, "model"]),
    (r"w_dkv$", lambda nd: ["data", None]),
    (r"w_kr$", lambda nd: ["data", None]),
    (r"(w_uk|w_uv)$", lambda nd: [None, "model"]),
    (r"w_in$", lambda nd: ["data", "model"]),                 # mamba in-proj
    (r"w_out$", lambda nd: ["model", "data"]),
    (r"conv_w$", lambda nd: [None, "model"]),
    (r"(bq|bk|bv)$", lambda nd: ["model"]),
]


def param_spec(path: str, ndim: int, hybrid: bool = False) -> P:
    """PartitionSpec of a parameter leaf given its '/'-joined path.

    Stacked params ("blocks*" / "mtp_block") get a leading replicated
    layer axis; hybrid (Zamba2) stacks get TWO (group, layer-in-group);
    shared-block params get none.
    """
    stacked = ("blocks" in path or "mtp_block" in path)
    n_stack = (2 if (hybrid and "blocks" in path and "mtp" not in path)
               else 1) if stacked else 0
    nd_eff = ndim - n_stack
    parts = None
    for pat, fn in _PARAM_RULES:
        if re.search(pat, path):
            parts = list(fn(nd_eff))
            break
    if parts is None:
        parts = []                          # norms, scalars: replicated
    parts = [None] * n_stack + parts
    while len(parts) < ndim:
        parts.append(None)
    return P(*parts[:ndim])


def _divides(shape, spec: P, mesh: Mesh) -> P:
    """Clear spec entries whose mesh axes don't divide the dim."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            out.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        out.append(ax if dim % size == 0 else None)
    return P(*out)


def tree_map_with_path(fn: Callable[[str, Any], Any], tree, path: str = ""):
    """``fn(path, leaf)`` over a nested dict / list / tuple, the structure
    kept; a leaf's path is its keys (and list indices) joined by ``/``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{path}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{path}{i}/")
                          for i, v in enumerate(tree))
    return fn(path[:-1], tree)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict / list / tuple, in order."""
    out = []
    tree_map_with_path(lambda _, leaf: out.append(leaf), tree)
    return out


def replicated(tree, mesh: Mesh):
    """A replicated sharding for every leaf of ``tree``."""
    return tree_map_with_path(
        lambda _, l: NamedSharding(mesh, P(*([None] * len(l.shape)))), tree)


def params_shardings(params_shapes, mesh: Mesh, hybrid: bool = False):
    """Tree of NamedShardings matching a parameter (or optimizer-state)
    tree keyed by the reference's leaf paths."""
    ep_both = shd.current_rules().get("experts") in (("data", "model"),
                                                     ["data", "model"])

    def one(key, leaf):
        nd = len(leaf.shape)
        if ep_both and nd == 4 and re.search(r"(w_gate|w_up|w_down)$", key):
            # §Perf "expert_ep": one expert per chip — weights resident,
            # tokens all-to-all (stacked (L, E, d, ff))
            spec = P(None, ("data", "model"), None, None)
        else:
            spec = param_spec(key, nd, hybrid)
        return NamedSharding(mesh, _divides(leaf.shape, spec, mesh))
    return tree_map_with_path(one, params_shapes)


def batch_shardings(batch_shapes, mesh: Mesh, multi_pod: bool,
                    global_batch: int):
    """Shard every batch leaf on axis 0 over the rules' batch axes (axis 1
    of the (3, B, T) positions)."""
    rules_batch = shd.current_rules().get("batch")
    if rules_batch is None:
        batch_axes = ("pod", "data") if multi_pod else ("data",)
    else:
        batch_axes = ((rules_batch,) if isinstance(rules_batch, str)
                      else tuple(rules_batch))
    nb = 1
    for a in batch_axes:
        nb *= mesh.shape[a]
    ax0 = batch_axes if global_batch % nb == 0 else None
    if ax0 is not None and len(ax0) == 1:
        ax0 = ax0[0]

    def one(_, leaf):
        if leaf.shape and leaf.shape[0] == global_batch and ax0 is not None:
            return NamedSharding(mesh, P(ax0, *([None] * (len(leaf.shape) - 1))))
        if len(leaf.shape) >= 2 and leaf.shape[1] == global_batch:
            # (3, B, T) positions
            spec = [None, ax0] + [None] * (len(leaf.shape) - 2)
            return NamedSharding(mesh, P(*spec))
        return NamedSharding(mesh, P(*([None] * len(leaf.shape))))
    return tree_map_with_path(one, batch_shapes)


def cache_shardings(cache_shapes, mesh: Mesh, multi_pod: bool,
                    batch_size: int):
    """KV/SSM caches: batch over data, cache sequence over model.

    Cache leaves are stacked (L, B, S, ...) or (L, B, ...) — axis 1 is
    batch; the sequence axis (if any) is axis 2.

    §Perf "mla_latent": MLA latent caches (ckv/kr) are sharded over the
    LATENT dim instead of the sequence.
    """
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    nb = 1
    for a in batch_axes:
        nb *= mesh.shape[a]
    bax = (batch_axes if len(batch_axes) > 1 else batch_axes[0]) \
        if batch_size % nb == 0 else None
    mla_latent = shd.current_rules().get("mla_latent") is not None

    def one(key, leaf):
        shp = leaf.shape
        spec = [None] * len(shp)
        is_mla = key.endswith("ckv") or key.endswith("kr")
        for i, d in enumerate(shp):
            if d == batch_size and i <= 2:
                if bax is not None:
                    spec[i] = bax
                if is_mla and mla_latent:
                    if shp[-1] % mesh.shape["model"] == 0:
                        spec[-1] = "model"
                elif i + 1 < len(shp) \
                        and shp[i + 1] % mesh.shape["model"] == 0 \
                        and shp[i + 1] >= mesh.shape["model"] * 8:
                    spec[i + 1] = "model"
                break
        return NamedSharding(mesh, P(*spec))
    return tree_map_with_path(one, cache_shapes)


def per_device_bytes(shapes, shardings) -> int:
    """Bytes one device holds of ``shapes`` under ``shardings`` (two trees
    of one structure): each leaf's bytes over the pieces its spec cuts it
    into.  ``_divides`` left only axes that divide, so this is exact."""
    total = 0
    for leaf, sh in zip(tree_leaves(shapes), tree_leaves(shardings)):
        n = leaf.numel() * leaf.element_size()
        total += n // sh.shard_count()
    return total
