"""Run the port's CUDA kernels on the CPU through a host shim.

A CUDA source with a plain C interface is rewritten for ``g++`` (each
``kernel<<<grid, block, smem, stream>>>(args)`` becomes a call of
``shim_launch``, the dynamic shared array a pointer into a buffer of the
launch's bytes) and built against ``cuda_runtime.h`` here, which runs one
``std::thread`` per CUDA thread, the blocks one at a time, and supplies what
``mma_tf32x3.cuh`` and ``mma_s8.cuh`` keep under ``__CUDACC__`` (the
rounding, each ``mma`` as a warp collective over its fragment layout,
``cp.async`` as a copy), what ``pareto_rank.cu`` uses (the warp vote
``__ballot_sync``, ``__popc``, ``atomicAdd``) and what ``quant_matmul.cu``
uses (``__byte_perm``, ``__ldg``, ``cudaGetDevice``).  The library is
built with AddressSanitizer, so a read past a buffer stops the run.  The
kernels are then held against their plain PyTorch versions at small
shapes, the int8 product bit for bit against
``repro_torch.testing.quant_matmul_exact``: a rehearsal before a first chip
call, not a measurement (the shim sums each TF32 ``mma`` in double and
rounds to nearest; the card does not; its int8 ``mma`` is exact, as the
card's).

    LD_PRELOAD=$(g++ -print-file-name=libasan.so) ASAN_OPTIONS=detect_leaks=0 \\
        PYTHONPATH=src python3 tools/cuda_host_shim/rehearse.py [out_dir]
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.testing import (edge_population,  # noqa: E402
                                 quant_matmul_exact)

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)\s*<<<(.*?),\s*([^,]*?),\s*([^,]*?),"
                    r"\s*(\w+)>>>\s*\((.*?)\);", re.S)


def build(source: Path, out: Path) -> ctypes.CDLL:
    """``source`` rewritten for the shim and built into ``out``."""
    text = re.sub(r"extern __shared__ __align__\(16\) ([\w ]+?) (\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(g_block->dyn.data());",
                  source.read_text())
    text = LAUNCH.sub(lambda m: (
        f"shim_launch(dim3({m.group(2)}), dim3({m.group(3)}), {m.group(4)}, "
        f"[&]{{ {m.group(1)}({m.group(6)}); }});"), text)
    cpp = out.with_suffix(".cpp")
    cpp.write_text(text)
    subprocess.run(["g++", "-std=c++20", "-O1", "-g", "-fsanitize=address",
                    "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
                    f"-I{HERE}", f"-I{source.parent}", "-o", str(out),
                    str(cpp)], check=True)
    return ctypes.CDLL(str(out))


def window_attn(lib, b, t, h, kv, hd, window, seed, nan_word=None):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((b, t, h, hd), (b, t, kv, hd), (b, t, kv, hd)))
    if nan_word is not None:   # a NaN of these bits in q
        q.view(torch.int32)[0, t // 2, 0, 1] = nan_word
    out = torch.full_like(q, float("nan"))
    code = lib.window_attn_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  out.data_ptr(), b, t, h, kv, hd,
                                  min(window, t + 1), None)
    want = ref.window_attn_gqa(q, k, v, window)
    nan = torch.isnan(want)
    err = float((out[~nan] - want[~nan]).abs().max())
    ok = code == 0 and err < 2e-5 and torch.equal(torch.isnan(out), nan)
    print(f"window_attn b {b} t {t} h {h}/{kv} hd {hd} window {window}"
          f"{'' if nan_word is None else f' NaN {nan_word & 0xffffffff:#x}'}:"
          f" max_abs_err {err:.3e}{'' if ok else '  FAILED'}", flush=True)
    return ok


def ssd_scan(lib, b, t, h, p, n, chunk, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)) - 1))
    A = -np.exp(rng.standard_normal(h) * 0.3)
    B = rng.standard_normal((b, t, n)) * 0.5
    C = rng.standard_normal((b, t, n)) * 0.5
    args = [torch.from_numpy(a.astype(np.float32)) for a in (x, dt, A, B, C)]
    nc = t // chunk
    nan = float("nan")
    y = torch.full_like(args[0], nan)
    final = torch.full((b, h, p, n), nan)
    scratch = (torch.full((b, nc, h, chunk), nan),
               torch.full((b, nc, chunk, chunk), nan),
               torch.full((b, nc, h, p, n), nan))
    code = lib.ssd_scan_launch(*(a.data_ptr() for a in (*args, y, final,
                                                        *scratch)),
                               b, t, h, p, n, chunk, None)
    y_ref, final_ref = ref.ssd_scan(*args, chunk)
    err = max(float((y - y_ref).abs().max()),
              float((final - final_ref).abs().max()))
    ok = code == 0 and err < 2e-4
    print(f"ssd_scan b {b} t {t} h {h} p {p} n {n} chunk {chunk}: "
          f"max_abs_err {err:.3e}{'' if ok else '  FAILED'}", flush=True)
    return ok


def pareto_rank(lib, n, m, infeas, seed, bp=2048, bq=256, alive=True):
    """Both Pareto kernels against their plain versions, bit for bit."""
    F, CV = edge_population(n, m, infeas, seed)
    mask = torch.from_numpy(np.random.default_rng(seed).random(n) < 0.5)
    words = torch.full(((n + 31) // 32, n), -1, dtype=torch.int32)
    code = lib.packed_domination_launch(
        F.data_ptr(), CV.data_ptr(), n, F.data_ptr(), CV.data_ptr(), n, m,
        bp, bq, words.data_ptr(), None)
    ok = code == 0 and torch.equal(words, ref.packed_domination(F, CV, F, CV))
    for rows in ((torch.ones(n, dtype=torch.bool), mask) if alive
                 else (torch.ones(n, dtype=torch.bool),)):
        counts = torch.zeros(n, dtype=torch.int32)
        alive_i = rows.to(torch.int32)
        code = lib.domination_counts_launch(
            F.data_ptr(), CV.data_ptr(), alive_i.data_ptr(), n, F.data_ptr(),
            CV.data_ptr(), n, m, counts.data_ptr(), None)
        ok &= code == 0 and torch.equal(
            counts, ref.domination_counts(F, CV, rows))
    print(f"pareto_rank n {n} m {m} infeasible {infeas} bp {bp} bq {bq}: "
          f"{'bit-exact' if ok else 'FAILED'}", flush=True)
    return ok


def quant_matmul(lib, m, k, n, splits, seed, w_offset=0, x_offset=0):
    """The int8 product twice in a row on one scratch (filled with 0xab
    first: each call zeroes the split sums it adds to), bit for bit against
    the exact reference.  ``w_offset`` / ``x_offset`` start w_q / x that
    many elements into their buffers (a narrower copy of w_q, the
    quantize's scalar loads)."""
    rng = np.random.default_rng(seed)
    x_buf = torch.from_numpy(rng.standard_normal(m * k + x_offset).astype(
        np.float32))
    x = x_buf[x_offset:].view(m, k)
    w_buf = torch.from_numpy(rng.integers(-128, 128, k * n + w_offset).astype(
        np.int8))
    w_q = w_buf[w_offset:].view(k, n)
    w_scale = torch.from_numpy((rng.random(n) * 1e-2 + 1e-3).astype(
        np.float32))
    x_scale = x.abs().max() / 127.0 if x.numel() else torch.tensor(1.0)
    scratch = torch.full((lib.quant_matmul_scratch_bytes(m, k, n, splits),),
                         0xab, dtype=torch.uint8)
    want = quant_matmul_exact(x, w_q, w_scale, x_scale)
    ok = True
    for _ in range(2):
        out = torch.full((m, n), float("nan"))
        code = lib.quant_matmul_launch(
            x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
            x_scale.data_ptr(), out.data_ptr(), scratch.data_ptr(), m, k, n,
            splits, None)
        ok &= code == 0 and torch.equal(out, want)
    width = lib.quant_matmul_copy_width(w_q.data_ptr(), n)
    print(f"quant_matmul m {m} k {k} n {n} splits {splits} copy width "
          f"{width}: {'bit-exact twice' if ok else 'FAILED'}", flush=True)
    return ok


def main() -> int:
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else Path(tempfile.mkdtemp())
    out.mkdir(parents=True, exist_ok=True)
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    wa = build(CSRC / "window_attn.cu", out / "window_attn.so")
    wa.window_attn_launch.argtypes = [p_, p_, p_, p_] + [i_] * 6 + [p_]
    ssd = build(CSRC / "ssd_scan.cu", out / "ssd_scan.so")
    ssd.ssd_scan_launch.argtypes = [p_] * 10 + [i_] * 6 + [p_]
    pr = build(CSRC / "pareto_rank.cu", out / "pareto_rank.so")
    pr.packed_domination_launch.argtypes = [p_, p_, i_, p_, p_] + [i_] * 4 + [
        p_, p_]
    pr.domination_counts_launch.argtypes = [p_, p_, p_, i_, p_, p_, i_, i_,
                                            p_, p_]
    qm = build(CSRC / "quant_matmul.cu", out / "quant_matmul.so")
    qm.quant_matmul_launch.argtypes = [p_] * 6 + [i_] * 4 + [p_]
    qm.quant_matmul_scratch_bytes.argtypes = [i_] * 4
    qm.quant_matmul_scratch_bytes.restype = ctypes.c_size_t
    qm.quant_matmul_copy_width.argtypes = [p_, i_]
    ok = [quant_matmul(qm, *case, seed=i) for i, case in enumerate((
        (1, 1, 1, 1), (3, 5, 7, 1), (65, 130, 67, 2), (100, 96, 50, 1),
        (3, 150, 1000, 2), (20, 443, 40, 3), (4, 64, 16, 3),
        (130, 256, 256, 2)))]
    ok += [quant_matmul(qm, 3, 70, 100, 1, seed=9, w_offset=4),
           quant_matmul(qm, 5, 96, 64, 2, seed=10, w_offset=8, x_offset=1)]
    ok += [pareto_rank(pr, n, 3, infeas, seed=n)
          for n in (33, 97, 130) for infeas in (0.0, 0.3, 1.0)]
    ok += [pareto_rank(pr, n, m, 0.3, seed=m, bp=bp, bq=bq)
           for n, m, bp, bq in ((100, 1, 32, 32), (130, 2, 64, 96),
                                (70, 5, 96, 1024), (97, 8, 128, 64),
                                (1100, 3, 1024, 256))]
    ok += [pareto_rank(pr, 4099, 3, 0.3, seed=1, alive=False)]
    ok += [window_attn(wa, *case, seed=i) for i, case in enumerate((
        (1, 1, 1, 1, 32, 1), (1, 100, 2, 2, 32, 64), (1, 130, 3, 1, 64, 100),
        (2, 129, 2, 2, 64, 129), (1, 300, 3, 3, 64, 37),
        (1, 80, 1, 1, 128, 50), (1, 70, 3, 1, 160, 20)))]
    ok += [window_attn(wa, 1, 200, 2, 2, 64, 50, 5, nan_word=w)
           for w in (0x7FFFFFFF, -1, 0x7FC00000)]
    ok += [ssd_scan(ssd, *case, seed=i) for i, case in enumerate((
        (2, 128, 2, 16, 8, 32), (2, 256, 3, 32, 16, 64),
        (1, 256, 2, 20, 12, 256), (1, 64, 2, 7, 5, 16),
        (1, 200, 1, 64, 128, 100), (1, 96, 1, 70, 66, 32)))]
    print(f"{sum(ok)} of {len(ok)} cases within their tolerance")
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
