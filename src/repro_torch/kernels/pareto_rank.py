"""Wrappers of the hand-written CUDA Pareto-domination kernels.

The kernels (``csrc/pareto_rank.cu``) replace the JAX package's Pallas
TPU kernels ``repro/kernels/pareto_rank.py::packed_domination`` and
``::domination_counts``.  Both put 32 dominator rows on the 32 lanes of a
warp and test them against one column at a time with the branch-free Deb
test:

* :func:`packed_domination` — the warp's vote (``__ballot_sync``) is the
  packed word (32 dominators per 32-bit word, ``nsga2_torch._pack_bits``
  layout);
* :func:`domination_counts` — the vote's popcount, summed over row splits
  of the grid by integer ``atomicAdd`` (exact, independent of order).

On a CPU tensor each wrapper runs the kernel's plain version
(``kernels.ref``); on a CUDA tensor it launches the kernel or raises.
Each wrapper counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools

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
        _p, _p, _i, _p, _p, _i, _i, _i, _i, _p, _p]
    lib.packed_domination_launch.restype = _i
    lib.domination_counts_launch.argtypes = [
        _p, _p, _p, _i, _p, _p, _i, _i, _p, _p]
    lib.domination_counts_launch.restype = _i
    for name in ("pareto_max_objectives", "pareto_rows_per_lane"):
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
                      f_cols: torch.Tensor, cv_cols: torch.Tensor, *,
                      bp: int = 1024, bq: int = 256) -> torch.Tensor:
    """Bit-packed domination rows: word (w, q) bit j = row 32w+j of
    (f_rows, cv_rows) Deb-dominates column q of (f_cols, cv_cols).

    f_rows (r, m), f_cols (n, m) float32; a thread block covers ``bp``
    dominator rows (a multiple of 32; its 8 warps walk them 4 words at a
    time) by ``bq`` columns (staged in shared memory, a multiple of 32 up
    to 1024).  Returns (ceil(r/32), n) int32 words carrying the uint32 bit
    pattern.
    """
    if f_rows.device.type == "cpu":
        return _ref.packed_domination(f_rows, cv_rows, f_cols, cv_cols, bp)
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
    if bp <= 0 or bp % 32 or bq <= 0 or bq % 32 or bq > 1024:
        raise ValueError(f"packed_domination: tile bp={bp}, bq={bq} is not "
                         f"a multiple of 32 (bq at most 1024)")
    lib = _lib()
    if m > lib.pareto_max_objectives():
        raise ValueError(f"packed_domination: {m} objectives exceed the "
                         f"kernel's {lib.pareto_max_objectives()}")
    out = torch.empty(((r + 31) // 32, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.packed_domination_launch(
            f_rows.data_ptr(), cv_rows.data_ptr(), r, f_cols.data_ptr(),
            cv_cols.data_ptr(), n, m, bp, bq, out.data_ptr(),
            stream)
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
