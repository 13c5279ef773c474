"""Wrapper of the hand-written CUDA kernel of the MBConv depthwise unit
(K8).

The kernel (``csrc/mbconv_dw.cu``) replaces no TPU kernel: the JAX
package's EfficientNet block (``repro/models/cnn/blocks.py::MBConv``)
leaves the unit to XLA, which fuses it, and the port ran it as five eager
passes over the block's widest tensors.  One launch here takes the
expansion's raw output E, applies its BatchNorm and SiLU as it loads,
convolves depthwise, applies the unit's BatchNorm and SiLU, writes D and
each plane's mean for the squeeze-excite, all bit for bit what the chain
gives on the card: ATen's depthwise sum, SiLU and mean order, cuDNN's
BatchNorm arithmetic.

On CPU tensors :func:`mbconv_dw` runs the kernel's plain version
(``kernels.ref.mbconv_dw``, the block's chain of ops); on CUDA tensors it
launches the kernel or raises.  It counts its launches in its
``launches`` attribute.  There is no backward: the block takes the chain
wherever a gradient or batch statistics are wanted.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ref as _ref

_SOURCE = "mbconv_dw.cu"
KERNELS = (3, 5)           # the kernel's k
STRIDES = (1, 2)

_p = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signatures."""
    from repro_torch.kernels import _build
    lib = _build.load(_SOURCE)
    lib.mbconv_dw_launch.argtypes = ([_p] * 8 + [_f] + [_p] * 4 + [_f]
                                     + [_i] * 7 + [_p])
    lib.mbconv_dw_launch.restype = _i
    lib.mbconv_dw_error_string.argtypes = [_i]
    lib.mbconv_dw_error_string.restype = ctypes.c_char_p
    return lib


def _validate(e, w, stride, bns) -> None:
    if e.dim() != 4:
        raise ValueError(f"mbconv_dw: e must be (N, C, H, W), got "
                         f"{tuple(e.shape)}")
    c, k = e.shape[1], w.shape[-1]
    if tuple(w.shape) != (c, 1, k, k) or k not in KERNELS:
        raise ValueError(f"mbconv_dw: w must be (C, 1, k, k) with C "
                         f"{c} and k in {KERNELS}, got {tuple(w.shape)}")
    if stride not in STRIDES:
        raise ValueError(f"mbconv_dw: stride must be in {STRIDES}, got "
                         f"{stride}")
    named = [("e", e), ("w", w)] + [
        (f"{which}[{j}]", t) for which, bn in bns for j, t in enumerate(bn[:4])]
    for name, t in named:
        if t.device != e.device:
            raise ValueError(f"mbconv_dw: {name} is on {t.device}, e on "
                             f"{e.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"mbconv_dw: {name} must be float32, got "
                            f"{t.dtype}")
        if name not in ("e", "w") and tuple(t.shape) != (c,):
            raise ValueError(f"mbconv_dw: {name} must be ({c},), got "
                             f"{tuple(t.shape)}")


def mbconv_dw(e: torch.Tensor, w: torch.Tensor, stride: int,
              bn: Sequence, pre: Optional[Sequence] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """D = SiLU(BN(depthwise(SiLU(BN_pre(e))))) and D's mean over each
    plane, as :func:`kernels.ref.mbconv_dw`: ``e`` (N, C, H, W) float32,
    ``w`` (C, 1, k, k) with k 3 or 5, ``stride`` 1 or 2, ``bn`` and
    ``pre`` (``pre`` optional) each (running mean, running variance,
    scale, bias, eps) of C floats.  One launch on a CUDA tensor."""
    if e.device.type == "cpu":
        return _ref.mbconv_dw(e, w, stride, bn, pre)
    if e.device.type != "cuda":
        raise ValueError(f"mbconv_dw: no kernel for device {e.device}")
    bns = [("bn", bn)] + ([("pre", pre)] if pre is not None else [])
    _validate(e, w, stride, bns)
    e, w = e.contiguous(), w.contiguous()
    n, c, h, wd = e.shape
    k = w.shape[-1]
    ho = (h + 2 * (k // 2) - k) // stride + 1
    wo = (wd + 2 * (k // 2) - k) // stride + 1
    d = e.new_empty((n, c, ho, wo))
    pooled = e.new_empty((n, c))
    ptrs = [t.contiguous() for _, b in bns for t in b[:4]]
    post = [t.data_ptr() for t in ptrs[:4]]
    pro = [t.data_ptr() for t in ptrs[4:]] if pre is not None else [None] * 4
    index = e.device.index
    # the raw stream, and no device switch on the current device, as K7's
    # wrapper launches
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        code = _lib().mbconv_dw_launch(
            e.data_ptr(), w.data_ptr(), d.data_ptr(), pooled.data_ptr(),
            *pro, float(pre[4]) if pre is not None else 0.0, *post,
            float(bn[4]), n, c, h, wd, k, stride, int(pre is not None),
            torch._C._cuda_getCurrentRawStream(index))
    if code != 0:
        raise RuntimeError(f"mbconv_dw launch failed: "
                           f"{_lib().mbconv_dw_error_string(code).decode()}")
    mbconv_dw.launches += 1
    return d, pooled


mbconv_dw.launches = 0
