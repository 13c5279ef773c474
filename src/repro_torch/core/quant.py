"""Quantization machinery — §IV-C accuracy exploration.

Calibration (range estimation over feature maps and weights), fake
quantization (quantize→dequantize in float, so accuracy can be measured
quickly, as the paper does) and the straight-through estimator of
quantization-aware training: the JAX package's ``repro.core.quant`` in
PyTorch, with the same arithmetic in the same order, so that fake-quant on
identical inputs gives identical values.

The partitioner reads only :class:`QuantSpec`'s bit width (bytes per
parameter, bytes per link element, proxy-accuracy noise); the functions
below run the partitioned, fake-quantized model (``serving.pipeline``,
``quantize.evaluate``).

The route of a fake quantization depends on the spec alone
(:func:`quantize_tensors`): per tensor by min/max, a whole list of
tensors goes to ``kernels.ops.fake_quant_tensors``, on the card one
hand-written kernel pair (K7, float32 tensors) bit for bit the chain
below, on the CPU the chain itself; per channel or by percentile, the
chain on every device.  The chain's ops are ``kernels.ref``'s
(:func:`compute_scale_zp`, :func:`fake_quant`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops as _kops
from repro_torch.kernels import ref as _kref
from repro_torch.obs import NOOP_OBS, Obs

# counters .cuda / .ref: tensors fake-quantized, by route (K7, the chain)
FAKE_QUANT_TENSORS = "fake_quant_tensors"


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Uniform symmetric/affine quantizer description for one platform."""

    bits: int = 8
    symmetric: bool = True
    per_channel: bool = False     # weights: quantize per output channel
    channel_axis: int = 0

    @property
    def qmin(self) -> int:
        """Smallest representable integer code."""
        return -(2 ** (self.bits - 1)) if self.symmetric else 0

    @property
    def qmax(self) -> int:
        """Largest representable integer code."""
        return 2 ** (self.bits - 1) - 1 if self.symmetric else 2 ** self.bits - 1


def compute_scale_zp(lo: torch.Tensor, hi: torch.Tensor,
                     spec: QuantSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale and zero-point from calibrated ranges
    (``kernels.ref.scale_zp``)."""
    return _kref.scale_zp(lo, hi, spec)


def fake_quant(x: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor,
               spec: QuantSpec) -> torch.Tensor:
    """Quantize→dequantize with straight-through gradients (QAT-ready):
    the value is the dequantized one, the gradient the identity
    (``kernels.ref.fake_quant``)."""
    return _kref.fake_quant(x, scale, zp, spec)


def _percentile(x: torch.Tensor, q: float, dim: Optional[int] = None
               ) -> torch.Tensor:
    """``jnp.percentile(x, q, axis=dim)`` with its default linear
    interpolation (``q`` in 0-100, as there), computed the way JAX computes
    it: sort, position ``q/100 * (n - 1)`` in float32, then ``low * (1 - w)
    + high * w``.  Sort-based, so it takes tensors of any size
    (``torch.quantile`` refuses more than 2^24 elements)."""
    if dim is None:
        x, dim = x.reshape(-1), 0
    s = torch.sort(x, dim=dim).values
    n = s.shape[dim]
    qt = torch.tensor(q, dtype=torch.float32) / 100.0
    pos = qt * torch.tensor(n - 1, dtype=torch.float32)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    lo_i = int(low.clamp(0, n - 1))
    hi_i = int(high.clamp(0, n - 1))
    lo_v = s.select(dim, lo_i)
    hi_v = s.select(dim, hi_i)
    return lo_v * lw.to(s.device) + hi_v * hw.to(s.device)


def calibrate(x: torch.Tensor, spec: QuantSpec,
              percentile: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Range estimation.  ``percentile`` (e.g. 99.9) clips outliers —
    min/max when None (the paper's parameter calibration step).  Per
    channel, the ranges keep ``x``'s rank with size 1 on every axis but
    ``spec.channel_axis``."""
    if spec.per_channel:
        ax = spec.channel_axis
        axes = tuple(i for i in range(x.dim()) if i != ax)
        if percentile is None:
            lo, hi = ((x.amin(dim=axes), x.amax(dim=axes)) if axes
                      else (x, x))
        else:
            flat = torch.movedim(x, ax, 0).reshape(x.shape[ax], -1)
            lo = _percentile(flat, 100 - percentile, dim=1)
            hi = _percentile(flat, percentile, dim=1)
        shape = [1] * x.dim()
        shape[ax] = -1
        return lo.reshape(shape), hi.reshape(shape)
    if percentile is None:
        return x.min(), x.max()
    return _percentile(x, 100 - percentile), _percentile(x, percentile)


def quantize_tensors(xs: Sequence[torch.Tensor], spec: QuantSpec,
                     percentile: Optional[float] = None,
                     channel_axes: Optional[Sequence[int]] = None,
                     obs: Obs = NOOP_OBS) -> List[torch.Tensor]:
    """Calibrate + fake-quant each of ``xs`` on its own range: the one
    place that picks the route, by ``spec`` and ``percentile`` alone.  Per
    tensor by min/max, all of ``xs`` in one ``kernels.ops.fake_quant_tensors``
    call (on the card the kernel pair K7, which takes float32 tensors or
    raises; on the CPU the chain); per channel (along ``channel_axes[i]``,
    ``spec.channel_axis`` when None) or by percentile, the chain on each,
    on every device.  With ``obs`` on, the tensors are counted by the route
    they took, ``fake_quant_tensors.cuda`` (K7) or ``.ref`` (the chain)."""
    if not xs:
        return []
    if spec.per_channel or percentile is not None:
        route, out = "ref", []
        for i, x in enumerate(xs):
            s = (spec if channel_axes is None or not spec.per_channel else
                 dataclasses.replace(spec, channel_axis=channel_axes[i]))
            scale, zp = compute_scale_zp(*calibrate(x, s, percentile), s)
            out.append(fake_quant(x, scale, zp, s))
    else:
        route = _kops.resolve_impl("auto", xs[0])
        out = _kops.fake_quant_tensors(xs, spec, impl=route)
    if obs.enabled:
        obs.metrics.counter(f"{FAKE_QUANT_TENSORS}.{route}").inc(len(xs))
    return out


def quantize_tensor(x: torch.Tensor, spec: QuantSpec,
                    percentile: Optional[float] = None,
                    obs: Obs = NOOP_OBS) -> torch.Tensor:
    """One-shot calibrate + fake-quant (weights, and link activations):
    :func:`quantize_tensors` of ``x`` alone."""
    return quantize_tensors([x], spec, percentile, obs=obs)[0]


class ActObserver:
    """Running min/max observer for activation calibration passes."""

    def __init__(self, spec: QuantSpec):
        self.spec = spec
        self.lo: Optional[torch.Tensor] = None
        self.hi: Optional[torch.Tensor] = None

    def update(self, x: torch.Tensor) -> None:
        lo, hi = calibrate(x, self.spec)
        self.lo = lo if self.lo is None else torch.minimum(self.lo, lo)
        self.hi = hi if self.hi is None else torch.maximum(self.hi, hi)

    def quantizer(self) -> Callable[[torch.Tensor], torch.Tensor]:
        if self.lo is None:
            raise RuntimeError("observer never saw data")
        scale, zp = compute_scale_zp(self.lo, self.hi, self.spec)
        spec = self.spec
        return lambda x: fake_quant(x, scale, zp, spec)


def reference_channel_axis(module: nn.Module, p: torch.Tensor) -> int:
    """The axis the JAX package quantizes per channel: the last axis of the
    parameter *in its layout*.  A module that stores a parameter in another
    layout names the axis in ``REFERENCE_LAST_AXIS`` (the port's ``Dense``
    keeps ``nn.Linear``'s (out, in) where the reference keeps (in, out),
    so its axis is 0, the output).  Conv weights are OIHW in both, so their
    axis is kw — a quirk of the reference that the port keeps."""
    return getattr(module, "REFERENCE_LAST_AXIS", p.dim() - 1)


def quantize_leaf(t: torch.Tensor, spec: QuantSpec,
                  percentile: Optional[float] = None,
                  channel_axis: Optional[int] = None) -> torch.Tensor:
    """The reference's ``quantize_pytree`` rule on one leaf: a float leaf
    of two or more dimensions is fake-quantized (per channel along
    ``channel_axis``, its last axis when None), any other is kept."""
    return quantize_leaves([t], spec, percentile, [channel_axis])[0]


def quantize_leaves(ts: Sequence[torch.Tensor], spec: QuantSpec,
                    percentile: Optional[float] = None,
                    channel_axes: Optional[Sequence[Optional[int]]] = None,
                    obs: Obs = NOOP_OBS) -> List[torch.Tensor]:
    """:func:`quantize_leaf` of each of ``ts`` (``channel_axes[i]`` the
    channel axis of ``ts[i]``), the leaves it quantizes in one
    :func:`quantize_tensors` call: per tensor by min/max on the card, one
    launch pair of K7 for all of them."""
    axes = channel_axes or [None] * len(ts)
    idx = [i for i, t in enumerate(ts)
           if t.dim() > 1 and t.is_floating_point()]
    out = list(ts)
    for i, q in zip(idx, quantize_tensors(
            [ts[i] for i in idx], spec, percentile,
            [ts[i].dim() - 1 if axes[i] is None else axes[i] for i in idx],
            obs)):
        out[i] = q
    return out


def quantize_modules(modules: Sequence[nn.Module], spec: QuantSpec,
                     percentile: Optional[float] = None, obs: Obs = NOOP_OBS
                     ) -> List[Dict[str, torch.Tensor]]:
    """:func:`quantize_pytree` of each of ``modules`` (a stage's blocks),
    their leaves in one :func:`quantize_leaves` call (``obs`` counts them,
    :func:`quantize_tensors`)."""
    owners, names, leaves, axes = [], [], [], []
    for k, module in enumerate(modules):
        for mname, mod in module.named_modules():
            for pname, p in mod.named_parameters(recurse=False):
                owners.append(k)
                names.append(f"{mname}.{pname}" if mname else pname)
                leaves.append(p)
                axes.append(reference_channel_axis(mod, p))
    out: List[Dict[str, torch.Tensor]] = [{} for _ in modules]
    for k, name, q in zip(owners, names,
                          quantize_leaves(leaves, spec, percentile, axes,
                                          obs)):
        out[k][name] = q
    return out


def quantize_pytree(module: nn.Module, spec: QuantSpec,
                    percentile: Optional[float] = None
                    ) -> Dict[str, torch.Tensor]:
    """Fake-quantized copies of ``module``'s parameters, by name (the
    ``named_parameters`` keys), for ``torch.func.functional_call``.

    Parameters of one dimension (biases, norm scales) are left in float —
    standard practice and what integer accelerators do (bias is accumulated
    at full precision); buffers (BatchNorm running statistics) are state,
    not parameters, and are not returned.  Per channel, each parameter is
    quantized along :func:`reference_channel_axis`.  Per tensor by
    min/max, all of them in one :func:`quantize_tensors` call.
    """
    return quantize_modules([module], spec, percentile)[0]


def quantization_error(x: torch.Tensor, spec: QuantSpec) -> float:
    """RMS fake-quant error, used by tests and the accuracy proxy."""
    return float(torch.sqrt(torch.mean((quantize_tensor(x, spec) - x) ** 2)))
