"""Wrapper of the hand-written CUDA sliding-window attention kernel.

The kernel (``csrc/window_attn.cu``) replaces the JAX package's Pallas TPU
kernel ``repro/kernels/window_attn.py::window_attn``: causal attention in
which query i sees the keys (i - window, i], computed tile by tile with an
online softmax so that no (T, T) score matrix exists.  It is flash
attention on Hopper's tensor cores at float32 accuracy: both products,
Q·Kᵀ and P·V, are 3xTF32 ``mma.sync`` (each float32 operand split into
two TF32 values, three TF32 products summed in float32,
``csrc/mma_tf32x3.cuh``).  One block of 8 warps per (query tile, head,
batch row) walks the key tiles its window touches, K and V double-buffered
in shared memory by ``cp.async``; each warp keeps its scores and output
rows in registers (two 16-row slices for head dims up to 64, one above).
GQA reads KV head ``h // (H // Kv)`` by index.

On a CPU tensor :func:`window_attn` runs the kernel's plain version
(``kernels.ref.window_attn_gqa``); on a CUDA tensor it launches the kernel
or raises.  It counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref as _ref

_SOURCE = "window_attn.cu"

_p = ctypes.c_void_p
_i = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signatures."""
    from repro_torch.kernels import _build
    lib = _build.load(_SOURCE)
    lib.window_attn_launch.argtypes = [_p, _p, _p, _p, _i, _i, _i, _i, _i,
                                       _i, _p]
    lib.window_attn_launch.restype = _i
    lib.window_attn_supports_head_dim.argtypes = [_i]
    lib.window_attn_supports_head_dim.restype = _i
    lib.window_attn_error_string.argtypes = [_i]
    lib.window_attn_error_string.restype = ctypes.c_char_p
    return lib


def _validate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"window_attn: {name} is on {x.device}, q on "
                             f"{q.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"window_attn: {name} must be float32, got "
                            f"{x.dtype}")
        if x.dim() != 4:
            raise ValueError(f"window_attn: {name} of shape "
                             f"{tuple(x.shape)} is not (B, T, heads, hd)")
        if not x.is_contiguous():
            raise ValueError(f"window_attn: {name} must be contiguous")
    b, t, h, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, t) or k.shape[3] != hd:
        raise ValueError(f"window_attn: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"window_attn: {h} query heads are not a multiple "
                         f"of {k.shape[2]} KV heads")
    if window < 1:
        raise ValueError(f"window_attn: window {window} must be >= 1")


def window_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                window: int) -> torch.Tensor:
    """Causal sliding-window attention: q (B, T, H, hd), k/v (B, T, Kv, hd)
    float32 with H a multiple of Kv; returns (B, T, H, hd)."""
    if q.device.type == "cpu":
        return _ref.window_attn_gqa(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"window_attn: no kernel for device {q.device}")
    _validate(q, k, v, window)
    b, t, h, hd = q.shape
    lib = _lib()
    if not lib.window_attn_supports_head_dim(hd):
        raise ValueError(f"window_attn: head dim {hd} is not one the kernel "
                         f"is built for (32, 64, 128, 160)")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.window_attn_launch(q.data_ptr(), k.data_ptr(),
                                      v.data_ptr(), out.data_ptr(), b, t, h,
                                      k.shape[2], hd, min(window, t + 1),
                                      stream)
    if code != 0:
        raise RuntimeError(f"window_attn launch failed: "
                           f"{lib.window_attn_error_string(code).decode()}")
    window_attn.launches += 1
    return out


window_attn.launches = 0
