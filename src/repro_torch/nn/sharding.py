"""Logical-axis sharding hints (the JAX package's ``repro.nn.sharding``).

Models name a tensor's axes with *logical* names; a launcher installs a
mesh and rules that map logical names to mesh axes.  The port runs each
model on one device, so the hints change no tensor: :func:`shard` is the
identity.  What the rules still decide is the accounting of the pod
tooling (``launch/rules.py``: which parameter, batch and cache axes a
mesh would split, and so the bytes each device would hold) and two
numerical options that the models read through :func:`current_rules`:
``remat_policy == "dots"`` (``models.decoder.run_blocks`` saves matmul
outputs under remat) and ``softmax_dtype == "compute"``
(``nn.attention.chunked_sdpa`` keeps the softmax in the compute dtype).

:class:`Mesh` and :class:`PartitionSpec` are plain Python: axis names and
sizes, and optionally the torch devices in row-major order (a mesh
without devices is *logical*, as the production pod meshes of
``launch/mesh.py`` are).  A :class:`PartitionSpec` prints as JAX's does,
so the port's specs can be compared with the reference's as strings.

Canonical logical axes:
  batch        — global batch            -> ('pod', 'data') / 'data'
  seq          — sequence                -> None (or 'model' under
                                            sequence parallelism)
  act_embed    — activation d_model      -> None
  heads        — attention heads         -> 'model'
  kv_heads     — kv heads                -> 'model'
  embed        — weight d_model (FSDP)   -> 'data'
  mlp          — FFN width               -> 'model'
  experts      — MoE experts             -> 'model'
  expert_cap   — dispatch slots          -> None
  vocab        — vocabulary              -> 'model'
  layers       — stacked layers          -> None
  kv_seq       — KV-cache sequence       -> None
  state        — SSM state dim           -> None
  ssm_heads    — SSM heads               -> 'model'
"""

from __future__ import annotations

import dataclasses
import math
import threading
from contextlib import contextmanager
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

Axis = Union[str, Tuple[str, ...], None]

_ctx = threading.local()


class PartitionSpec(tuple):
    """One mesh axis (a name, a tuple of names, or None) per tensor axis;
    equal to the tuple of its entries and printed as JAX's."""

    def __new__(cls, *parts: Axis):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        parts = ", ".join(map(repr, self))
        return f"PartitionSpec({parts}{',' if len(self) == 1 else ''})"

    __str__ = __repr__


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes of the given sizes over ``devices`` (row-major, one
    per mesh position), or logical (``devices`` None): the axes' sizes
    decide the accounting, and no tensor is placed."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Optional[Tuple[torch.device, ...]] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size} positions")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (JAX's ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The device of each index along ``axis``, every other axis at 0;
        raises on a logical mesh."""
        if self.devices is None:
            raise ValueError(f"mesh {self.shape} is logical: it has no "
                             f"devices")
        i = self.axis_names.index(axis)
        stride = math.prod(self.axis_sizes[i + 1:])
        return tuple(self.devices[j * stride]
                     for j in range(self.axis_sizes[i]))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``)."""
    mesh: Mesh
    spec: PartitionSpec

    def shard_count(self) -> int:
        """Pieces the spec cuts a tensor into: the product of the sizes of
        the mesh axes it names."""
        n = 1
        for ax in self.spec:
            for a in ((ax,) if isinstance(ax, str) else tuple(ax or ())):
                n *= self.mesh.shape[a]
        return n


def shard_map(f, *, mesh: Mesh, in_specs, out_specs, check_vma=None,
              check_rep=None, **kwargs):
    """``f`` itself on a mesh whose every axis has size 1 (each device
    then holds every tensor whole); raises ``ValueError`` on any other
    mesh, which only an SPMD partitioner could run."""
    if mesh.size != 1:
        raise ValueError(f"shard_map over mesh {mesh.shape}: the port runs "
                         f"a program on one device only")
    return f


DEFAULT_RULES: Dict[str, Axis] = {
    "batch": "data",
    "seq": None,
    "act_embed": None,
    "heads": "model",
    "kv_heads": "model",
    "embed": "data",
    "mlp": "model",
    "experts": "model",
    "expert_cap": None,
    "vocab": "model",
    "layers": None,
    "kv_seq": None,
    "state": None,
    "ssm_heads": "model",
    "codebooks": None,
    # §Perf optimizations (None = baseline behaviour)
    "attn_kv": None,        # attention-local kv-head sharding (+ kv dup)
    "mla_latent": None,     # MLA: shard the compressed latent dim
}

MULTIPOD_RULES = dict(DEFAULT_RULES, batch=("pod", "data"))


def axis_size(logical_name: str) -> int:
    """Mesh size of the axis a logical name maps to (1 when unmapped or
    with no mesh)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    ax = current_rules().get(logical_name)
    if ax is None:
        return 1
    axes = (ax,) if isinstance(ax, str) else tuple(ax)
    return math.prod(mesh.shape[a] for a in axes)


def set_mesh(mesh: Optional[Mesh], rules: Optional[Dict[str, Axis]] = None):
    _ctx.mesh = mesh
    _ctx.rules = dict(rules) if rules is not None else dict(DEFAULT_RULES)


def current_mesh() -> Optional[Mesh]:
    return getattr(_ctx, "mesh", None)


def current_rules() -> Dict[str, Axis]:
    return getattr(_ctx, "rules", dict(DEFAULT_RULES))


@contextmanager
def mesh_context(mesh: Mesh, rules: Optional[Dict[str, Axis]] = None):
    """Install ``mesh`` and ``rules`` for the block; the previous ones
    after it."""
    prev_mesh, prev_rules = current_mesh(), current_rules()
    set_mesh(mesh, rules)
    try:
        yield mesh
    finally:
        set_mesh(prev_mesh, prev_rules)


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    rules: Optional[Dict[str, Axis]] = None) -> PartitionSpec:
    rules = rules if rules is not None else current_rules()
    used = set()
    out = []
    for name in logical_axes:
        ax = rules.get(name) if name else None
        # an axis may appear only once in a spec
        if ax is None:
            out.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        axes = tuple(a for a in axes if a not in used)
        used.update(axes)
        out.append(axes if len(axes) > 1 else (axes[0] if axes else None))
    return PartitionSpec(*out)


def shard(x: torch.Tensor, logical_axes: Sequence[Optional[str]]
          ) -> torch.Tensor:
    """``x`` itself: a hint names one logical axis per tensor axis (checked
    while a mesh is installed) and moves nothing on one device."""
    if current_mesh() is not None and len(logical_axes) != x.dim():
        raise ValueError(f"{len(logical_axes)} logical axes "
                         f"{tuple(logical_axes)} for a tensor of shape "
                         f"{tuple(x.shape)}")
    return x


def named_sharding(logical_axes: Sequence[Optional[str]]
                   ) -> Optional[NamedSharding]:
    mesh = current_mesh()
    if mesh is None:
        return None
    return NamedSharding(mesh, logical_to_spec(logical_axes))
