"""Wrapper of the hand-written CUDA fake-quant int8 product kernel.

The kernel (``csrc/quant_matmul.cu``) replaces the JAX package's Pallas TPU
kernel ``repro/kernels/quant_matmul.py::quant_matmul``: x (M, K) float32 is
quantized symmetric 8-bit with the scale ``x_scale``, multiplied by the
int8 weights w_q (K, N) with int32 accumulation, and scaled back by
``x_scale`` and the per-column ``w_scale``.  Where the TPU kernel quantizes
x inside every (bm, bk) tile, the CUDA version quantizes it once into an
int8 scratch and then runs the product on the int8 tensor cores
(``mma.sync`` m16n8k32) with the dequant epilogue fused, on the current
stream.  Where the output has too few tiles to fill the card, the product
splits K over :func:`split_count` ranges that run in parallel, adds them
in int32 and scales the sums in a third launch, so the result does not
depend on the split.  ``x_scale`` stays on the device (no host sync); the
scratch is allocated per call on the current stream.

On a CPU tensor :func:`quant_matmul` runs the kernel's plain version
(``kernels.ref.quant_matmul``); on a CUDA tensor it launches the kernel,
whatever the shape, or raises.  It counts its launches in its
``launches`` attribute.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref as _ref

_SOURCE = "quant_matmul.cu"

_p = ctypes.c_void_p
_i = ctypes.c_int

# the product kernel's output tile (rows and columns) and k-step
TILE, STEP = 128, 64
# product blocks an SM holds at once: 80 KB of shared memory and at most
# 128 registers a thread each
BLOCKS_PER_SM = 2
# the fewest k-steps a split walks
MIN_STEPS = 2
# the most splits: each split adds its whole tile to the sums and fills and
# drains its own pipeline; past 8 that costs more than the extra blocks
# gain (chip_variants.py --qmm on an H100: the head 0.019 ms of device time
# at 8 splits, 0.027 at 16)
MAX_SPLITS = 8


def split_count(m: int, k: int, n: int, sms: int) -> int:
    """How many ranges of k-steps the product walks in parallel: enough
    blocks to fill ``sms`` SMs once (``BLOCKS_PER_SM`` each), each range at
    least ``MIN_STEPS`` k-steps long, at most ``MAX_SPLITS``, at least 1."""
    tiles = -(-m // TILE) * -(-n // TILE)
    if tiles == 0:
        return 1
    steps = -(-k // STEP)
    return max(1, min(BLOCKS_PER_SM * sms // tiles, steps // MIN_STEPS,
                      MAX_SPLITS))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _plan(m: int, k: int, n: int, index: int,
          splits: Optional[int]) -> Tuple[int, int]:
    """(splits, scratch bytes) of a launch on device ``index``."""
    if splits is None:
        splits = split_count(m, k, n, _sms(index))
    return splits, _lib().quant_matmul_scratch_bytes(m, k, n, splits)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signatures."""
    from repro_torch.kernels import _build
    lib = _build.load(_SOURCE)
    lib.quant_matmul_launch.argtypes = [_p] * 6 + [_i] * 4 + [_p]
    lib.quant_matmul_launch.restype = _i
    lib.quant_matmul_scratch_bytes.argtypes = [_i] * 4
    lib.quant_matmul_scratch_bytes.restype = ctypes.c_size_t
    lib.quant_matmul_copy_width.argtypes = [_p, _i]
    lib.quant_matmul_copy_width.restype = _i
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
        if a.get_device() != x.get_device():   # an int: cheaper than .device
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
                 x_scale: torch.Tensor, *,
                 splits: Optional[int] = None) -> torch.Tensor:
    """``clip(round(x / x_scale), -128, 127) @ w_q``, then ``* x_scale *
    w_scale[None, :]``: x (M, K) float32, w_q (K, N) int8, w_scale (N,)
    float32, x_scale a float32 scalar tensor; returns (M, N) float32.
    ``splits`` overrides :func:`split_count` for the tests and the
    measurements of the split (the result is the same)."""
    if x.device.type == "cpu":
        return _ref.quant_matmul(x, w_q, w_scale, x_scale)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: no kernel for device {x.device}")
    _validate(x, w_q, w_scale, x_scale)
    m, k = x.shape
    n = w_q.shape[1]
    index = x.device.index
    splits, n_bytes = _plan(m, k, n, index, splits)
    lib = _lib()
    out = x.new_empty((m, n))        # float32, as x
    scratch = w_q.new_empty(n_bytes)   # bytes
    # the head's whole launch takes ~20 us of the device: the raw stream,
    # no device switch on the current device and the allocations without
    # a device argument keep the host's share near it
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        code = lib.quant_matmul_launch(
            x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
            x_scale.data_ptr(), out.data_ptr(), scratch.data_ptr(), m, k, n,
            splits, torch._C._cuda_getCurrentRawStream(index))
    if code != 0:
        raise RuntimeError(f"quant_matmul launch failed: "
                           f"{lib.quant_matmul_error_string(code).decode()}")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
