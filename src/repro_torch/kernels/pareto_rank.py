"""Wrappers of the hand-written CUDA Pareto-domination kernels.

Two kernels (``csrc/pareto_rank.cu``) replace the JAX package's Pallas
TPU kernels ``repro/kernels/pareto_rank.py::packed_domination`` and
``::domination_counts``.  Both put 32 dominator rows on the 32 lanes of a
warp and test them against one column at a time with the branch-free Deb
test:

* :func:`packed_domination` — the warp's vote (``__ballot_sync``) is the
  packed word (32 dominators per 32-bit word, ``kernels.ref.pack_bits``
  layout);
* :func:`domination_counts` — the vote's popcount, summed over row splits
  of the grid by integer ``atomicAdd`` (exact, independent of order).

The third, :func:`peel_fronts`, replaces no Pallas kernel: it peels the
fronts off the packed words, the whole front loop of one ranking in one
cooperative launch, where the JAX package runs a compiled ``while_loop``.

On a CPU tensor each wrapper runs the kernel's plain version
(``kernels.ref``); on a CUDA tensor it launches the kernel or raises.
Each wrapper counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import ref as _ref

_SOURCE = "pareto_rank.cu"

_p = ctypes.c_void_p
_i = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernels' library, built on first use, with its C signatures."""
    from repro_torch.kernels import _build
    lib = _build.load(_SOURCE)
    lib.packed_domination_launch.argtypes = [
        _p, _p, _i, _p, _p, _i, _i, _p, _p]
    lib.packed_domination_launch.restype = _i
    lib.domination_counts_launch.argtypes = [
        _p, _p, _p, _i, _p, _p, _i, _i, _p, _p]
    lib.domination_counts_launch.restype = _i
    lib.peel_fronts_launch.argtypes = [_p, _p, _i, _i, _p, _p, _p, _p]
    lib.peel_fronts_launch.restype = _i
    for name in ("pareto_max_objectives", "pareto_rows_per_lane",
                 "peel_fronts_max_n"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = _i
    lib.pareto_error_string.argtypes = [_i]
    lib.pareto_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.pareto_error_string(code).decode()}")


def _validate(name: str, F: torch.Tensor, cv: torch.Tensor,
              device: torch.device) -> None:
    if F.device != device or cv.device != device:
        raise ValueError(f"{name}: every input must be on {device}")
    if F.dtype != torch.float32 or cv.dtype != torch.float32:
        raise TypeError(f"{name}: objectives and violations must be "
                        f"float32, got {F.dtype} and {cv.dtype}")
    if F.dim() != 2 or cv.shape != (F.shape[0],):
        raise ValueError(f"{name}: shapes {tuple(F.shape)} and "
                         f"{tuple(cv.shape)} are not (n, m) and (n,)")
    if not (F.is_contiguous() and cv.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")


def packed_domination(f_rows: torch.Tensor, cv_rows: torch.Tensor,
                      f_cols: torch.Tensor, cv_cols: torch.Tensor
                      ) -> torch.Tensor:
    """Bit-packed domination rows: word (w, q) bit j = row 32w+j of
    (f_rows, cv_rows) Deb-dominates column q of (f_cols, cv_cols).

    f_rows (r, m), f_cols (n, m) float32; a thread block covers 2048
    dominator rows (its 8 warps walk them 4 words at a time) by 256
    columns (staged in shared memory).  Returns (ceil(r/32), n) int32
    words carrying the uint32 bit pattern.
    """
    if f_rows.device.type == "cpu":
        return _ref.packed_domination(f_rows, cv_rows, f_cols, cv_cols)
    if f_rows.device.type != "cuda":
        raise ValueError(f"packed_domination: no kernel for device "
                         f"{f_rows.device}")
    dev = f_rows.device
    _validate("packed_domination", f_rows, cv_rows, dev)
    _validate("packed_domination", f_cols, cv_cols, dev)
    r, m = f_rows.shape
    n = f_cols.shape[0]
    if f_cols.shape[1] != m:
        raise ValueError("packed_domination: rows and columns differ in "
                         "objective count")
    lib = _lib()
    if m > lib.pareto_max_objectives():
        raise ValueError(f"packed_domination: {m} objectives exceed the "
                         f"kernel's {lib.pareto_max_objectives()}")
    out = torch.empty(((r + 31) // 32, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.packed_domination_launch(
            f_rows.data_ptr(), cv_rows.data_ptr(), r, f_cols.data_ptr(),
            cv_cols.data_ptr(), n, m, out.data_ptr(), stream)
    _check(lib, code, "packed_domination")
    packed_domination.launches += 1
    return out


packed_domination.launches = 0


def domination_counts(F: torch.Tensor, CV: torch.Tensor,
                      alive: torch.Tensor) -> torch.Tensor:
    """Per-individual count of alive constrained dominators; (n,) int32.

    F (n, m), CV (n,) float32; ``alive`` (n,) bool or integer mask on the
    dominator side (non-zero = alive).
    """
    if F.device.type == "cpu":
        return _ref.domination_counts(F, CV, alive != 0)
    if F.device.type != "cuda":
        raise ValueError(f"domination_counts: no kernel for device "
                         f"{F.device}")
    dev = F.device
    _validate("domination_counts", F, CV, dev)
    n, m = F.shape
    if alive.device != dev or alive.shape != (n,):
        raise ValueError("domination_counts: alive must be an (n,) mask on "
                         "the same device")
    alive = alive.to(torch.int32).contiguous()
    lib = _lib()
    if m > lib.pareto_max_objectives():
        raise ValueError(f"domination_counts: {m} objectives exceed the "
                         f"kernel's {lib.pareto_max_objectives()}")
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.domination_counts_launch(
            F.data_ptr(), CV.data_ptr(), alive.data_ptr(), n, F.data_ptr(),
            CV.data_ptr(), n, m, out.data_ptr(), stream)
    _check(lib, code, "domination_counts")
    domination_counts.launches += 1
    return out


domination_counts.launches = 0


def peel_fronts(words: torch.Tensor, alive: torch.Tensor,
                cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Front index per individual, peeled off the packed domination words
    among the ``alive`` individuals until at least ``cap`` are ranked or
    none are left, the plain loop's rules bit for bit
    (``kernels.ref.peel_fronts``).

    ``words`` (ceil(n/32), n) int32 in the ``kernels.ref.pack_bits``
    layout (K1's output), ``alive`` (n,) bool.  Returns (rank (n,) int64,
    unranked ones n; info (3,) int64: fronts peeled, individuals ranked,
    alive count at entry), both on the device, with nothing read back: one
    launch runs every front, its stop test on the device.
    """
    if words.device.type == "cpu":
        rank, fronts, done, n_alive = _ref.peel_fronts(words, alive, cap)
        return rank, torch.tensor([fronts, done, n_alive],
                                  dtype=torch.int64)
    if words.device.type != "cuda":
        raise ValueError(f"peel_fronts: no kernel for device {words.device}")
    dev = words.device
    n = alive.shape[0] if alive.dim() == 1 else -1
    if alive.device != dev:
        raise ValueError(f"peel_fronts: every input must be on {dev}")
    if words.dtype != torch.int32 or alive.dtype != torch.bool:
        raise TypeError(f"peel_fronts: words must be int32 and alive bool, "
                        f"got {words.dtype} and {alive.dtype}")
    if n < 0 or words.shape != ((n + 31) // 32, n):
        raise ValueError(f"peel_fronts: shapes {tuple(words.shape)} and "
                         f"{tuple(alive.shape)} are not (ceil(n/32), n) "
                         f"and (n,)")
    if not (words.is_contiguous() and alive.is_contiguous()):
        raise ValueError("peel_fronts: inputs must be contiguous")
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return rank, torch.zeros(3, dtype=torch.int64, device=dev)
    lib = _lib()
    if n > lib.peel_fronts_max_n():
        raise ValueError(f"peel_fronts: {n} individuals exceed the "
                         f"kernel's {lib.peel_fronts_max_n()}")
    # the kernel writes every element of these before it reads one
    info = torch.empty(3, dtype=torch.int64, device=dev)
    scratch = torch.empty(2 * ((n + 31) // 32) + 3, dtype=torch.int32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.peel_fronts_launch(
            words.data_ptr(), alive.data_ptr(), n, max(0, min(cap, n)),
            scratch.data_ptr(), rank.data_ptr(), info.data_ptr(), stream)
    _check(lib, code, "peel_fronts")
    peel_fronts.launches += 1
    return rank, info


peel_fronts.launches = 0
