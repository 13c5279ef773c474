"""Wrapper of the hand-written CUDA per-tensor fake-quantization kernel
pair (K7).

The kernel (``csrc/fake_quant.cu``) replaces no TPU kernel: the JAX
package's ``repro/core/quant.py`` chain (min/max calibration, scale and
zero-point, quantize→dequantize), which XLA fuses, ran in the port as ~16
eager ATen launches a tensor.  One call here takes a list of float32
tensors and one per-tensor spec, gives each tensor its own range, and
writes every result into one flat buffer, each tensor's a view of it:
two launches (ranges, then quantize) for up to ``MAX_TENSORS`` tensors,
their pointers and sizes passed by value in the kernel's parameters.  The
result equals the ATen chain on the card bit for bit.

On CPU tensors :func:`fake_quant_tensors` runs the kernel's plain version
(``kernels.ref.fake_quant_tensors``); on CUDA tensors it launches the
kernels or raises.  It counts its launches (two a batch of up to
``MAX_TENSORS``) in its ``launches`` attribute.  :class:`StraightThrough`
puts the kernel under autograd with the straight-through gradient (the
identity), as ``x + (dq - x).detach()`` has it.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import List, Sequence

import torch

from repro_torch.kernels import ref as _ref

_SOURCE = "fake_quant.cu"
MAX_TENSORS = 96           # the kernel's kMaxTensors: tensors a launch pair
_ALIGN = 4                 # floats: each output starts on 16 bytes

_p = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signatures."""
    from repro_torch.kernels import _build
    lib = _build.load(_SOURCE)
    lib.fake_quant_launch.argtypes = ([_i] + [_p] * 3 + [_i] + [_p] * 2
                                      + [_i] * 4 + [_p])
    lib.fake_quant_launch.restype = _i
    lib.fake_quant_scratch_floats.argtypes = [_p, _i]
    lib.fake_quant_scratch_floats.restype = _ll
    lib.fake_quant_error_string.argtypes = [_i]
    lib.fake_quant_error_string.restype = ctypes.c_char_p
    return lib


def _validate(xs: Sequence[torch.Tensor], spec) -> None:
    if spec.per_channel:
        raise ValueError("fake_quant_tensors: the kernel quantizes per "
                         "tensor, not per channel")
    dev = xs[0].device
    for i, x in enumerate(xs):
        if x.device != dev:
            raise ValueError(f"fake_quant_tensors: tensor {i} is on "
                             f"{x.device}, tensor 0 on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"fake_quant_tensors: tensor {i} must be "
                            f"float32, got {x.dtype}")
        if x.numel() == 0:
            raise ValueError(f"fake_quant_tensors: tensor {i} is empty")


def fake_quant_tensors(xs: Sequence[torch.Tensor], spec
                       ) -> List[torch.Tensor]:
    """Each of ``xs`` (float32, one device) fake-quantized per tensor by
    its own min/max range under ``spec`` (a ``QuantSpec``, not per
    channel): ``core.quant``'s chain, value for value.  On CUDA tensors
    the results are views of one buffer, contiguous, in ``xs``' shapes."""
    if not xs:
        return []
    if xs[0].device.type == "cpu":
        return _ref.fake_quant_tensors(xs, spec)
    if xs[0].device.type != "cuda":
        raise ValueError(f"fake_quant_tensors: no kernel for device "
                         f"{xs[0].device}")
    _validate(xs, spec)
    xs = [x.contiguous() for x in xs]
    sizes = [x.numel() for x in xs]
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += -(-n // _ALIGN) * _ALIGN
    flat = xs[0].new_empty(total)
    lib = _lib()
    symmetric = int(spec.symmetric)
    rng = spec.qmax if symmetric else spec.qmax - spec.qmin
    index = xs[0].device.index
    # the raw stream, and no device switch on the current device: a link's
    # call is one small tensor, so the host's share is most of its time
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        stream = torch._C._cuda_getCurrentRawStream(index)
        for a in range(0, len(xs), MAX_TENSORS):
            part = range(a, min(a + MAX_TENSORS, len(xs)))
            k = len(part)
            ins = (_p * k)(*(xs[i].data_ptr() for i in part))
            ns = (_ll * k)(*(sizes[i] for i in part))
            os_ = (_ll * k)(*(offs[i] for i in part))
            scratch = flat.new_empty(lib.fake_quant_scratch_floats(ns, k))
            for phase in (0, 1):
                code = lib.fake_quant_launch(
                    phase, ins, ns, os_, k, flat.data_ptr(),
                    scratch.data_ptr(), rng, spec.qmin, spec.qmax, symmetric,
                    stream)
                if code != 0:
                    raise RuntimeError(
                        f"fake_quant launch failed: "
                        f"{lib.fake_quant_error_string(code).decode()}")
                fake_quant_tensors.launches += 1
    # as_strided: one view op a tensor (slicing and viewing take two)
    return [flat.as_strided(x.shape, x.stride(), o) for x, o in zip(xs, offs)]


fake_quant_tensors.launches = 0


class StraightThrough(torch.autograd.Function):
    """:func:`fake_quant_tensors` under autograd: the gradient of each
    output passes to its input unchanged (the straight-through estimator
    of quantization-aware training)."""

    @staticmethod
    def forward(ctx, spec, *xs):
        out = tuple(fake_quant_tensors(xs, spec))
        ctx.mark_non_differentiable(*(o for o, x in zip(out, xs)
                                      if not x.requires_grad))
        return out

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads)
