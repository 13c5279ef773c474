"""Run the port's CUDA kernels on the CPU through a host shim.

A CUDA source with a plain C interface is rewritten for ``g++`` (each
``kernel<<<grid, block, smem, stream>>>(args)`` becomes a call of
``shim_launch``, the dynamic shared array a pointer into a buffer of the
launch's bytes) and built against ``cuda_runtime.h`` here, which runs one
``std::thread`` per CUDA thread, the blocks one at a time, and supplies what
``mma_tf32x3.cuh`` and ``mma_s8.cuh`` keep under ``__CUDACC__`` (the
rounding, each ``mma`` as a warp collective over its fragment layout,
``cp.async`` as a copy), what ``pareto_rank.cu`` uses (the warp vote
``__ballot_sync``, ``__popc``, ``atomicAdd``; for the peel kernel a cooperative launch of
all its blocks at once, ``cooperative_groups::this_grid().sync()`` as a
barrier of all their threads, ``__shfl_sync``, ``__all_sync``,
``atomicOr``, ``__ldcg`` and the occupancy queries of a card of three
multiprocessors) and what ``quant_matmul.cu`` uses (``__byte_perm``,
``__ldg``, ``cudaGetDevice``); ``fake_quant.cu`` (K7) needs only
``__grid_constant__`` besides, ``mbconv_dw.cu`` (K8) ``__umulhi``,
``__shfl_down_sync`` and ``rsqrtf`` (the host's 1 / sqrt).  The library is
built with AddressSanitizer, so a read past a buffer stops the run.  The
kernels are then held against their plain PyTorch versions at small
shapes, the int8 product bit for bit against
``repro_torch.testing.quant_matmul_exact``: a rehearsal before a first chip
call, not a measurement (the shim sums each TF32 ``mma`` in double and
rounds to nearest; the card does not; its int8 ``mma`` is exact, as the
card's).  K7 is held bit for bit against the ATen chain as the card runs
it (:func:`card_chain`), K8 against the block's chain of ops within 1e-5
of the largest output (the host's expf, the CPU's BatchNorm and mean) and
its plane means bit for bit against ATen's CUDA mean order on its own D
(:func:`card_mean`).

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

from repro_torch.core import quant  # noqa: E402
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


def pareto_rank(lib, n, m, infeas, seed, alive=True):
    """Both Pareto kernels against their plain versions, bit for bit, at
    the kernels' fixed tiles."""
    F, CV = edge_population(n, m, infeas, seed)
    mask = torch.from_numpy(np.random.default_rng(seed).random(n) < 0.5)
    words = torch.full(((n + 31) // 32, n), -1, dtype=torch.int32)
    code = lib.packed_domination_launch(
        F.data_ptr(), CV.data_ptr(), n, F.data_ptr(), CV.data_ptr(), n, m,
        words.data_ptr(), None)
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
    print(f"pareto_rank n {n} m {m} infeasible {infeas}: "
          f"{'bit-exact' if ok else 'FAILED'}", flush=True)
    return ok


def cycle_words(n):
    """Packed words in which rows 0 and 1 dominate each other and every
    other row: no individual is free of an alive dominator, so the peel's
    first front is empty and takes everyone (the numerical-safety rule)."""
    B = torch.zeros((n, n), dtype=torch.bool)
    B[0, 1:] = True
    B[1, 0] = B[1, 2:] = True
    return ref.pack_bits(B)


def peel_fronts(lib, n, m, infeas, seed, mask="all", cap=None):
    """The peel kernel against the plain loop, ranks and counts bit for
    bit, on K1's words of an edge population (or a domination cycle),
    under an alive mask: all, random, or random with whole dead words."""
    if m == 0:
        words = cycle_words(n)
    else:
        F, CV = edge_population(n, m, infeas, seed)
        words = ref.packed_domination(F, CV, F, CV)
    rng = np.random.default_rng(seed)
    alive = torch.ones(n, dtype=torch.bool)
    if mask != "all":
        alive = torch.from_numpy(rng.random(n) < 0.7)
    if mask == "dead_words":
        for w in range(0, (n + 31) // 32, 2):
            alive[32 * w:32 * w + 32] = False
    cap = n if cap is None else cap
    rank = torch.full((n,), -7, dtype=torch.int64)
    info = torch.full((3,), -7, dtype=torch.int64)
    scratch = torch.full((2 * ((n + 31) // 32) + 3,), -1, dtype=torch.int32)
    code = lib.peel_fronts_launch(words.data_ptr(), alive.data_ptr(), n, cap,
                                  scratch.data_ptr(), rank.data_ptr(),
                                  info.data_ptr(), None)
    want, fronts, done, entry = ref.peel_fronts(words, alive, cap)
    ok = code == 0 and torch.equal(rank, want) and info.tolist() == [
        fronts, done, entry]
    grid = ctypes.c_uint.in_dll(lib, "shim_cooperative_grid").value
    print(f"peel_fronts n {n} m {m} infeasible {infeas} alive {mask} cap "
          f"{cap} grid {grid}: {fronts} fronts, {done} ranked "
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


def card_chain(x, spec):
    """``core.quant``'s per-tensor chain as ATen runs it on a CUDA tensor:
    the ops on the CPU, but the division by a Python number taken as a
    multiply by its float reciprocal, as ATen's CUDA division by a CPU
    scalar takes it."""
    f32 = dict(dtype=torch.float32)
    one = torch.tensor(1.0, **f32)
    lo, hi = x.min(), x.max()
    if spec.symmetric:
        amax = torch.maximum(lo.abs(), hi.abs())
        scale = torch.clamp_min(amax * (one / torch.tensor(
            float(spec.qmax), **f32)), 1e-12)
        zp = torch.zeros_like(scale)
    else:
        lo, hi = torch.clamp_max(lo, 0.0), torch.clamp_min(hi, 0.0)
        scale = torch.clamp_min((hi - lo) * (one / torch.tensor(
            float(spec.qmax - spec.qmin), **f32)), 1e-12)
        zp = torch.round(spec.qmin - lo / scale)
    return quant.fake_quant(x, scale, zp, spec)


def same_bits(a, b):
    """Equal bit for bit, NaN where NaN (whatever its payload)."""
    nan = torch.isnan(b)
    return torch.equal(torch.isnan(a), nan) and torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def fake_quant(lib, sizes, spec, seed, skew=0, special=None):
    """K7 over tensors of ``sizes`` (each ``skew`` floats into its buffer,
    so its start is off 16 bytes when skew % 4), both launches on one
    scratch, each output against :func:`card_chain` bit for bit.
    ``special``: tensor 0 all zeros, all -0.0, or holding a NaN."""
    rng = np.random.default_rng(seed)
    xs = []
    for i, n in enumerate(sizes):
        buf = rng.standard_normal(n + skew).astype(np.float32)
        buf *= float(rng.choice([1e-3, 1.0, 50.0]))
        if i == 0 and special == "zero":
            buf[:] = 0.0
        elif i == 0 and special == "negzero":
            buf[:] = -0.0
        elif i == 0 and special == "nan":
            buf[skew + n // 2] = np.nan
        xs.append(torch.from_numpy(buf)[skew:])
    k = len(xs)
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += -(-n // 4) * 4
    out = torch.full((total,), float("nan"))
    ll = ctypes.c_longlong
    ins = (ctypes.c_void_p * k)(*(x.data_ptr() for x in xs))
    ns = (ll * k)(*sizes)
    os_ = (ll * k)(*offs)
    scratch = torch.full((lib.fake_quant_scratch_floats(ns, k),), 7.0)
    rng_ = spec.qmax if spec.symmetric else spec.qmax - spec.qmin
    codes = [lib.fake_quant_launch(phase, ins, ns, os_, k, out.data_ptr(),
                                   scratch.data_ptr(), rng_, spec.qmin,
                                   spec.qmax, int(spec.symmetric), None)
             for phase in (0, 1)]
    ok = codes == [0, 0] and all(
        same_bits(out[o:o + x.numel()], card_chain(x, spec))
        for x, o in zip(xs, offs))
    print(f"fake_quant {k} tensors of {min(sizes)}-{max(sizes)} skew {skew} "
          f"bits {spec.bits} {'symmetric' if spec.symmetric else 'affine'}"
          f"{'' if special is None else f' {special}'}: "
          f"{'bit-exact' if ok else 'FAILED'}", flush=True)
    return ok


def mean_plan(nc, hw):
    """ATen's reduction config of a float mean over nc planes of hw values
    (``Reduce.cuh``'s ``setReduceConfig``), as K8's ``mean_plan``: (loads
    of 4, lanes a row, rows, a row's first load, the step between a lane's
    loads)."""
    def last_pow2(n):
        return 1 << (n.bit_length() - 1)
    dim0 = hw // 4 if hw >= 128 else hw
    dim0_pow2 = last_pow2(dim0) if dim0 < 512 else 512
    dim1_pow2 = last_pow2(nc) if nc < 512 else 512
    bw = min(dim0_pow2, 32)
    bh = min(dim1_pow2, 512 // bw)
    bw = min(dim0_pow2, 512 // bh)
    step = bw
    if -(-hw // step) >= min(bh * 16, 256):
        return hw >= 128, bw, bh, step, step * bh
    return hw >= 128, bw, 1, 0, step


def card_mean(d):
    """Each (n, c) plane's mean of d as ATen's CUDA mean kernel sums it:
    each lane's four accumulators over its loads, combined, a halving tree
    over each row's lanes and one over the rows, times the float factor
    num_outputs / numel (every step a float32 add, so the host gives the
    card's bits).  Planes that start on 16 bytes only."""
    n, c, h, w = d.shape
    hw = h * w
    assert hw % 4 == 0 or hw < 128
    vec, bw, ny, im1, step = mean_plan(n * c, hw)
    flat = d.reshape(n * c, hw)
    zero = torch.zeros(n * c)
    lanes = torch.zeros((n * c, ny, bw))
    for y in range(ny):
        for x in range(bw):
            acc = [zero.clone() for _ in range(4)]
            idx = x + y * im1
            if vec:
                while idx * 4 + 3 < hw:
                    for i in range(4):
                        acc[i] = acc[i] + flat[:, idx * 4 + i]
                    idx += step
                tail = hw - hw % 4 + x
                if (ny == 1 or y == 0) and tail < hw:
                    acc[0] = acc[0] + flat[:, tail]
            else:
                while idx + 3 * step < hw:
                    for i in range(4):
                        acc[i] = acc[i] + flat[:, idx + i * step]
                    idx += 4 * step
                for i in range(4):
                    if idx >= hw:
                        break
                    acc[i] = acc[i] + flat[:, idx]
                    idx += step
            lanes[:, y, x] = ((acc[0] + acc[1]) + acc[2]) + acc[3]
    off = bw // 2
    while off:
        lanes[:, :, :off] = lanes[:, :, :off] + lanes[:, :, off:2 * off]
        off //= 2
    off = ny // 2
    while off:
        lanes[:, :off, 0] = lanes[:, :off, 0] + lanes[:, off:2 * off, 0]
        off //= 2
    factor = torch.tensor(n * c, dtype=torch.float32) / torch.tensor(
        n * c * hw, dtype=torch.float32)
    return (lanes[:, 0, 0] * factor).view(n, c)


def mbconv_dw(lib, n, c, h, w, k, stride, pro, seed, skew=0):
    """K8 on e (n, c, h, w) starting ``skew`` floats into its buffer (off
    16 bytes when skew % 4: the scalar loads), D and the plane means
    against ``ref.mbconv_dw`` relative to their largest magnitude."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale
                                 + shift).astype(np.float32))

    def bn():
        var = torch.from_numpy(rng.uniform(0.1, 3.0, c).astype(np.float32))
        return (t(c), var, t(c, scale=0.3, shift=1.0), t(c, scale=0.5), 1e-5)

    e = t(n * c * h * w + skew, scale=2.0, shift=0.3)[skew:].view(n, c, h, w)
    wt = t(c, 1, k, k, scale=0.4)
    post, pre = bn(), bn() if pro else None
    want_d, want_m = ref.mbconv_dw(e, wt, stride, post, pre)
    d = torch.full_like(want_d, float("nan"))
    pooled = torch.full_like(want_m, float("nan"))
    pre_args = ([x.data_ptr() for x in pre[:4]] + [pre[4]] if pro
                else [None] * 4 + [0.0])
    code = lib.mbconv_dw_launch(
        e.data_ptr(), wt.data_ptr(), d.data_ptr(), pooled.data_ptr(),
        *pre_args, *(x.data_ptr() for x in post[:4]), post[4], n, c, h, w,
        k, stride, int(pro), None)
    err_d = float((d - want_d).abs().max() / want_d.abs().max())
    err_m = float((pooled - want_m).abs().max() / want_m.abs().max())
    # the means of the kernel's own D in ATen's CUDA order: bit for bit
    exact = same_bits(pooled, card_mean(d))
    ok = code == 0 and err_d <= 1e-5 and err_m <= 1e-5 and exact
    print(f"mbconv_dw n {n} c {c} {h}x{w} k {k} stride {stride} prologue "
          f"{int(pro)} skew {skew}: D {err_d:.2e}, means {err_m:.2e} of "
          f"their largest, means {'bit for bit' if exact else 'NOT'} "
          f"ATen's order{'' if ok else '  FAILED'}", flush=True)
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
    pr.packed_domination_launch.argtypes = [p_, p_, i_, p_, p_, i_, i_, p_,
                                            p_]
    pr.domination_counts_launch.argtypes = [p_, p_, p_, i_, p_, p_, i_, i_,
                                            p_, p_]
    pr.peel_fronts_launch.argtypes = [p_, p_, i_, i_, p_, p_, p_, p_]
    qm = build(CSRC / "quant_matmul.cu", out / "quant_matmul.so")
    qm.quant_matmul_launch.argtypes = [p_] * 6 + [i_] * 4 + [p_]
    qm.quant_matmul_scratch_bytes.argtypes = [i_] * 4
    qm.quant_matmul_scratch_bytes.restype = ctypes.c_size_t
    qm.quant_matmul_copy_width.argtypes = [p_, i_]
    fq = build(CSRC / "fake_quant.cu", out / "fake_quant.so")
    fq.fake_quant_launch.argtypes = ([i_] + [p_] * 3 + [i_] + [p_] * 2
                                     + [i_] * 4 + [p_])
    fq.fake_quant_scratch_floats.argtypes = [p_, i_]
    fq.fake_quant_scratch_floats.restype = ctypes.c_longlong
    mb = build(CSRC / "mbconv_dw.cu", out / "mbconv_dw.so")
    f_ = ctypes.c_float
    mb.mbconv_dw_launch.argtypes = ([p_] * 8 + [f_] + [p_] * 4 + [f_]
                                    + [i_] * 7 + [p_])
    # EfficientNet-B0's 16 depthwise shapes (its planes, k, stride,
    # prologue) at few channels, then odd planes, ragged runs, stride 2 on
    # odd sizes, rectangles and unaligned starts
    ok = [mbconv_dw(mb, n, c, h, h, k, s, pro, seed=i)
          for i, (n, c, h, k, s, pro) in enumerate((
              (1, 2, 112, 3, 1, False), (1, 2, 112, 3, 2, True),
              (1, 3, 56, 3, 1, True), (1, 3, 56, 5, 2, True),
              (1, 4, 28, 5, 1, True), (1, 4, 28, 3, 2, True),
              (2, 9, 14, 3, 1, True), (2, 9, 14, 5, 1, True),
              (2, 9, 14, 5, 2, True), (2, 33, 7, 5, 1, True),
              (2, 33, 7, 3, 1, True), (1, 5, 7, 3, 2, True),
              (1, 5, 7, 5, 2, False), (1, 3, 13, 5, 2, True),
              (3, 7, 9, 3, 1, True), (1, 40, 1, 3, 1, True),
              (1, 3, 2, 5, 2, True)))]
    ok += [mbconv_dw(mb, 2, 3, 9, 11, 3, 1, True, seed=20),
           mbconv_dw(mb, 1, 5, 15, 6, 5, 2, True, seed=21),
           mbconv_dw(mb, 2, 9, 14, 14, 5, 1, True, seed=22, skew=1),
           mbconv_dw(mb, 3, 5, 7, 7, 3, 2, True, seed=23, skew=3),
           mbconv_dw(mb, 3, 7, 12, 12, 3, 1, True, seed=24),
           mbconv_dw(mb, 2, 6, 8, 4, 5, 2, False, seed=25)]
    Q = quant.QuantSpec
    ok += [fake_quant(fq, sizes, spec, seed=i, skew=skew, special=special)
          for i, (sizes, spec, skew, special) in enumerate((
              ((1, 3, 4, 5, 100, 1000, 8193, 20000), Q(8), 0, None),
              ((7, 64, 8192, 16385), Q(16), 1, None),
              ((33, 4096, 999), Q(8, symmetric=False), 0, None),
              ((33, 4096, 999), Q(4, symmetric=False), 3, None),
              ((1000, 50), Q(8), 0, "zero"),
              ((1000, 50), Q(8), 2, "negzero"),
              ((1000, 50), Q(8, symmetric=False), 0, "negzero"),
              ((1000, 50), Q(8, symmetric=False), 0, "zero"),
              ((1000, 50), Q(16), 0, "nan"),
              ((5,) * 96, Q(8), 0, None)))]
    ok += [quant_matmul(qm, *case, seed=i) for i, case in enumerate((
        (1, 1, 1, 1), (3, 5, 7, 1), (65, 130, 67, 2), (100, 96, 50, 1),
        (3, 150, 1000, 2), (20, 443, 40, 3), (4, 64, 16, 3),
        (130, 256, 256, 2)))]
    ok += [quant_matmul(qm, 3, 70, 100, 1, seed=9, w_offset=4),
           quant_matmul(qm, 5, 96, 64, 2, seed=10, w_offset=8, x_offset=1)]
    ok += [pareto_rank(pr, n, 3, infeas, seed=n)
          for n in (33, 97, 130) for infeas in (0.0, 0.3, 1.0)]
    ok += [pareto_rank(pr, n, m, 0.3, seed=m)
           for n, m in ((100, 1), (130, 2), (70, 5), (97, 8), (1100, 3))]
    ok += [pareto_rank(pr, 4099, 3, 0.3, seed=1, alive=False)]
    ok += [peel_fronts(pr, n, m, 0.3, seed=n + m, mask=mask, cap=cap)
           for n, m in ((33, 3), (97, 1), (130, 8), (300, 3))
           for mask in ("all", "random", "dead_words")
           for cap in (None, 1, n // 2)]
    ok += [peel_fronts(pr, n, 3, infeas, seed=n, cap=cap)
           for n in (1, 32, 64) for infeas in (0.0, 1.0) for cap in (0, n)]
    ok += [peel_fronts(pr, n, 0, 0.0, seed=n, mask=mask)
           for n in (5, 40) for mask in ("all", "random")]
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
