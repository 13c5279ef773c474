"""Wrapper of the hand-written CUDA fake-quant int8 product kernel.

The kernel (``csrc/quant_matmul.cu``) replaces the JAX package's Pallas TPU
kernel ``repro/kernels/quant_matmul.py::quant_matmul``: x (M, K) float32 is
quantized symmetric 8-bit with the scale ``x_scale``, multiplied by the
int8 weights w_q (K, N) with int32 accumulation, and scaled back by
``x_scale`` and the per-column ``w_scale``.  Where the TPU kernel quantizes
x inside every (bm, bk) tile, the CUDA version quantizes it once into an
int8 scratch and then runs a tiled ``__dp4a`` product with the dequant
epilogue fused: two launches on the current stream.  ``x_scale`` stays on
the device (no host sync).

On a CPU tensor :func:`quant_matmul` runs the kernel's plain version
(``kernels.ref.quant_matmul``); on a CUDA tensor it launches the kernel,
whatever the shape, or raises.  It counts its launches in its
``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref as _ref

_SOURCE = "quant_matmul.cu"

_p = ctypes.c_void_p
_i = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signatures."""
    from repro_torch.kernels import _build
    lib = _build.load(_SOURCE)
    lib.quant_matmul_launch.argtypes = [_p] * 6 + [_i] * 3 + [_p]
    lib.quant_matmul_launch.restype = _i
    lib.quant_matmul_error_string.argtypes = [_i]
    lib.quant_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _validate(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
              x_scale: torch.Tensor) -> None:
    if w_q.dtype != torch.int8:
        raise TypeError(f"quant_matmul: w_q must be int8, got {w_q.dtype}")
    for name, a, dtype in (("x", x, torch.float32),
                           ("w_scale", w_scale, torch.float32),
                           ("x_scale", x_scale, torch.float32)):
        if a.dtype != dtype:
            raise TypeError(f"quant_matmul: {name} must be float32, got "
                            f"{a.dtype}")
    for name, a in (("w_q", w_q), ("w_scale", w_scale),
                    ("x_scale", x_scale)):
        if a.device != x.device:
            raise ValueError(f"quant_matmul: {name} is on {a.device}, x on "
                             f"{x.device}")
    for name, a in (("x", x), ("w_q", w_q), ("w_scale", w_scale)):
        if not a.is_contiguous():
            raise ValueError(f"quant_matmul: {name} must be contiguous")
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"quant_matmul: x {tuple(x.shape)} and w_q "
                         f"{tuple(w_q.shape)} are not (M, K) and (K, N)")
    if w_scale.shape != (w_q.shape[1],):
        raise ValueError(f"quant_matmul: w_scale {tuple(w_scale.shape)} is "
                         f"not ({w_q.shape[1]},)")
    if x_scale.numel() != 1:
        raise ValueError(f"quant_matmul: x_scale of shape "
                         f"{tuple(x_scale.shape)} is not a scalar")


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                 x_scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / x_scale), -128, 127) @ w_q``, then ``* x_scale *
    w_scale[None, :]``: x (M, K) float32, w_q (K, N) int8, w_scale (N,)
    float32, x_scale a float32 scalar tensor; returns (M, N) float32."""
    if x.device.type == "cpu":
        return _ref.quant_matmul(x, w_q, w_scale, x_scale)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: no kernel for device {x.device}")
    _validate(x, w_q, w_scale, x_scale)
    m, k = x.shape
    n = w_q.shape[1]
    lib = _lib()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    xq = torch.empty((m, (k + 3) // 4), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.quant_matmul_launch(
            x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
            x_scale.data_ptr(), out.data_ptr(), xq.data_ptr(), m, k, n,
            stream)
    if code != 0:
        raise RuntimeError(f"quant_matmul launch failed: "
                           f"{lib.quant_matmul_error_string(code).decode()}")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
