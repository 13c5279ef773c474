"""Wrapper of the hand-written CUDA Mamba2 SSD chunked-scan kernel.

The kernel (``csrc/ssd_scan.cu``) replaces the JAX package's Pallas TPU
kernel ``repro/kernels/ssd_scan.py::ssd_scan``: the chunked SSD forward
without the D skip, returning y and the final (P, N) state of every
(batch row, head).  Where the TPU kernel walks the chunks of one (b, h) in
order with the state in scratch memory, the CUDA version runs the chunks in
parallel (cumulative decays, C·Bᵀ per chunk, per-chunk states, one pass
over the chunks for the carried states, the output) in five launches on
the current stream.  Its three products run on Hopper's tensor cores at
float32 accuracy (3xTF32 ``mma.sync``, ``csrc/mma_tf32x3.cuh``) from
operand tiles that ``cp.async`` double-buffers in shared memory, with the
decay, ``dt`` and ``exp(cs)`` factors applied to the fragments in
registers; the pass over chunks is bound by the bytes of the chunk states.

On a CPU tensor :func:`ssd_scan` runs the kernel's plain version
(``kernels.ref.ssd_scan``); on a CUDA tensor it launches the kernel or
raises.  It counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import ref as _ref

_SOURCE = "ssd_scan.cu"
_MAX_CHUNK = 1024          # the kernel's kMaxChunk

_p = ctypes.c_void_p
_i = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signatures."""
    from repro_torch.kernels import _build
    lib = _build.load(_SOURCE)
    lib.ssd_scan_launch.argtypes = [_p] * 10 + [_i] * 6 + [_p]
    lib.ssd_scan_launch.restype = _i
    lib.ssd_scan_error_string.argtypes = [_i]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _validate(x, dt, A, B, C, chunk: int) -> None:
    args = (("x", x, 4), ("dt", dt, 3), ("A", A, 1), ("B", B, 3),
            ("C", C, 3))
    for name, a, dim in args:
        if a.device != x.device:
            raise ValueError(f"ssd_scan: {name} is on {a.device}, x on "
                             f"{x.device}")
        if a.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} must be float32, got "
                            f"{a.dtype}")
        if a.dim() != dim:
            raise ValueError(f"ssd_scan: {name} of shape {tuple(a.shape)} "
                             f"is not {dim}-D")
        if not a.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    b, t, h, _ = x.shape
    if dt.shape != (b, t, h) or A.shape != (h,):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)} and A "
                         f"{tuple(A.shape)} do not match x {tuple(x.shape)}")
    if B.shape != C.shape or B.shape[:2] != (b, t):
        raise ValueError(f"ssd_scan: B {tuple(B.shape)} and C "
                         f"{tuple(C.shape)} do not match x {tuple(x.shape)}")
    if not 1 <= chunk <= _MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} is not in [1, "
                         f"{_MAX_CHUNK}]")
    if t % chunk:
        raise ValueError(f"ssd_scan: T={t} is not a multiple of the chunk "
                         f"{chunk}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD without the D skip: x (b, T, h, p), dt (b, T, h), A
    (h,), B/C (b, T, n) float32, T a multiple of ``chunk``; returns
    (y (b, T, h, p), final_state (b, h, p, n))."""
    if x.device.type == "cpu":
        return _ref.ssd_scan(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    _validate(x, dt, A, B, C, chunk)
    b, t, h, p = x.shape
    n = B.shape[-1]
    nc = t // chunk
    lib = _lib()
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    final = torch.empty((b, h, p, n), **f32)
    cs = torch.empty((b, nc, h, chunk), **f32)
    cb = torch.empty((b, nc, chunk, chunk), **f32)
    states = torch.empty((b, nc, h, p, n), **f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), final.data_ptr(), cs.data_ptr(),
            cb.data_ptr(), states.data_ptr(), b, t, h, p, n, chunk, stream)
    if code != 0:
        raise RuntimeError(f"ssd_scan launch failed: "
                           f"{lib.ssd_scan_error_string(code).decode()}")
    ssd_scan.launches += 1
    return y, final


ssd_scan.launches = 0
