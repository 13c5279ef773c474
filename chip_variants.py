"""The design measurements behind the tensor-core kernels, on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_variants.py

The sliding-window attention kernel (K5, ``window_attn.cu``) and the SSD
scan kernel (K4, ``ssd_scan.cu``) take their products as 3xTF32
``mma.sync`` (``mma_tf32x3.cuh``).  This script builds, beside the shipped
sources, copies in which one design choice is changed by a text
substitution (each variant below names the lines it replaces and what
takes their place), all with ``nvcc`` in parallel into
``build/variants/``, and prints:

1. the card's ``mma.sync`` m16n8k8 TF32 rate: independent products in a
   loop on every SM, the most the 3xTF32 kernels can reach (the data
   sheet's 495 TFLOP/s is ``wgmma``'s), and the SASS of the two roundings
   of the split (``cvt.rna.tf32.f32`` and its integer form) in a kernel
   that only loads, rounds and stores;
2. for K5 at the LM path's shape (smollm-360m, 2 x 8192 tokens, window
   4096) and K4 at mamba2-370m's and zamba2-2.7b's (2 x 8192 tokens), each
   build's time, its largest error against float64 and its signed relative
   bias, sum((got - exact) sign(exact)) / sum|exact| (negative: a drift
   toward zero);
3. the smollm-360m and mamba2-370m forwards at full width and depth over
   2 x 8192 tokens through each build of their kernel, against the plain
   forward: the logits' largest error (``chip_smoke.py`` gates 2e-4).

The Pareto kernels (K1 ``packed_domination``, K2 ``domination_counts``,
``pareto_rank.cu``) come first: each build's K1 time at the search's shape
(n 32768) and K2's at the final front's (n 16384), both held bit-exact to
the plain versions, for the word rows a warp holds (R), K2's row splits
and columns a block, and K2's splits summed by a second launch instead of
``atomicAdd``; then the shipped K1 at other row and column tiles.
``python3 chip_variants.py --pareto`` stops there.  ``--k5`` instead
prints ``ptxas -v``'s registers and spills of the shipped K5 and then, in
two rounds, each K5 build's time and error at the LM path's shape and at
qwen2-vl-7b's (2 x 8192 positions, 28 heads over 4 of dim 128, window
4096), and stops.

``python3 chip_variants.py --qmm`` measures the int8 product kernel (K3,
``quant_matmul.cu``) instead, and stops: the card's ``mma.sync`` m16n8k32
int8 rate (the data sheet's 1979 TOP/s is ``wgmma``'s) and the
instructions of the product's k-step loop in its SASS; then at
EfficientNet-B0's classifier (256 x 1280 x 1000) and VGG-16's three
(256 x 25088 x 4096, 256 x 4096 x 4096, 256 x 4096 x 1000) each build's
time with the shipped split, through the wrapper and in a CUDA graph
(the device's time alone), bit for bit against the exact reference: a
ring of 3 or 5 staged k-steps, warps as 4 x 2 (32 x 64 each), one block
an SM, the splits combined as int32 tiles by the last block of a tile to
arrive at its counter (the shipped kernel adds them to the zeroed (M, N)
sums by ``atomicAdd``, then an epilogue launch scales them), the
quantize fused into the product's staging (the shipped one is a launch
of its own); at fc0 builds without the transpose, the copies, both, or
the products (results wrong, only timed: what holds the k-step); then the
shipped build at 1 to 32 splits in a CUDA graph, and the wrapper's own
floor at 1 x 1 x 1.

It prints the card's name and power limit first.  It imports nothing of
JAX.  A machine without a CUDA device exits non-zero.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

OUT = ROOT / "build" / "variants"

SPLIT = ("  hi = to_tf32_non_nan(x);\n"
         "  lo = to_tf32(x - __uint_as_float(hi));")
ROWS_PER_LANE = "constexpr int kRowsPerLane = 4;"
COUNT_ROWS = "constexpr int kCountRows = 1024;"
COUNT_COLS = "constexpr int kCountCols = 256;"
# K2's second-launch combine: each split's sums go to a (splits, n) device
# array, and a second kernel adds them up per column.
COUNT_SCRATCH = "constexpr unsigned kAll = 0xffffffffu;"
COUNT_ADD = "      atomicAdd(&counts[q0 + c], s_count[c]);"
COUNT_LAUNCHER = "template <int M>\nint launch_counts("
COUNT_LAUNCH = """  domination_counts_kernel<M><<<grid, kWarps * 32, bytes, s>>>(
      f_rows, cv_rows, alive_rows, r, f_cols, cv_cols, n, m, out);
  return static_cast<int>(cudaGetLastError());"""
SECOND_LAUNCH = [
    (COUNT_SCRATCH, COUNT_SCRATCH + "\n__device__ int32_t g_partial[1 << 20];"),
    (COUNT_ADD, "      g_partial[(size_t)blockIdx.y * n + q0 + c] = s_count[c];"),
    (COUNT_LAUNCHER, """__global__ void count_splits_kernel(int splits, int n, int32_t* counts) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  int32_t s = 0;
  for (int i = 0; i < splits; ++i) s += g_partial[(size_t)i * n + q];
  counts[q] = s;
}

""" + COUNT_LAUNCHER),
    (COUNT_LAUNCH, """  if ((size_t)grid.y * n > (1u << 20)) return cudaErrorInvalidValue;
""" + COUNT_LAUNCH.replace("  return static_cast<int>(cudaGetLastError());", """\
  const int err = static_cast<int>(cudaGetLastError());
  if (err != cudaSuccess) return err;
  count_splits_kernel<<<(n + 255) / 256, 256, 0, s>>>(grid.y, n, out);
  return static_cast<int>(cudaGetLastError());"""))]
# K3's splits combined as int32 tiles in scratch and a per-tile arrival
# counter (zeroed by the quantize launch): the last block of a tile to
# arrive adds the other splits' tiles and applies the epilogue (the shipped
# kernel adds them to the (M, N) sums by atomicAdd, then an epilogue launch)
QMM_ATOMICS = """  if (splits > 1) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + r0 + 16 * mt + g + 8 * (e >> 1);
          const int n = n0 + c0 + 8 * nt + 2 * t + (e & 1);
          if (m < M && n < N)
            atomicAdd(sums + (size_t)m * N + n, acc[mt][nt][e]);
        }
    return;
  }
"""
QMM_LAST_ARRIVAL = [
    (QMM_ATOMICS, """  if (splits > 1) {
    __shared__ int last;
    const int tiles = gridDim.x * gridDim.y;
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    int* counters = sums;
    int* partial = sums + (tiles + 63) / 64 * 64;
    int* own = partial + ((size_t)tile * splits + z) * (kBM * kBN) + tid;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          own[((mt * kNT + nt) * 4 + e) * kThreads] = acc[mt][nt][e];
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(counters + tile, 1) == splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int o = 0; o < splits; ++o) {
      if (o == z) continue;
      const int* other = partial + ((size_t)tile * splits + o) * (kBM * kBN) +
                         tid;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mt][nt][e] += __ldcg(other + ((mt * kNT + nt) * 4 + e) *
                                                 kThreads);
    }
    if (tid == 0) counters[tile] = 0;
  }
"""),
    ("  return codes_bytes(M, K) + (splits > 1 ? (size_t)M * N * 4 : 0);",
     """  const size_t tiles = round_up(M, kBM) / kBM * (round_up(N, kBN) / kBN);
  return codes_bytes(M, K) +
         (splits > 1 ? (round_up(tiles, 64) + tiles * splits * kBM * kBN) * 4
                     : 0);"""),
    ("  const long long n_sums = splits > 1 ? (long long)M * N : 0;",
     "  const long long n_sums =\n"
     "      splits > 1 ? ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN) : 0;"),
    ("  if (splits == 1) return static_cast<int>(cudaGetLastError());",
     "  if (true) return static_cast<int>(cudaGetLastError());")]
# K3 with one part of its k-step taken out, to see what holds the product
# loop: the result is wrong and only timed
QMM_TRANSPOSE = [
    ("      transpose(bt + ((i + 1) & 1) * kBt, slot(i + 1) + kBM * kBK);",
     ";"),
    ("  if (count > 0) transpose(bt, slot(0) + kBM * kBK);", ";")]
QMM_COPIES = [("    if (i < count) {\n      unsigned char* as = slot(i);",
               "    if (false) {\n      unsigned char* as = slot(i);")]
QMM_PRODUCTS = [
    ("    product(acc, slot(i), bt + (i & 1) * kBt, r0, c0, g, t);", ";")]
# K3 with the quantize in the product's staging: each block quantizes its
# rows of x for each k-step (N / 128 times over), one launch (and a memset
# of the counters where the launch splits K)
QMM_STAGE = """        cp_async16(as + 16 * (tid + j * kThreads),
                   a_src + (size_t)i * (kBM * kBK) + 16 * j * kThreads, true);"""
QMM_FUSED = [
    (QMM_STAGE, """        *reinterpret_cast<uint4*>(as + 16 * (tid + j * kThreads)) =
            code_chunk(reinterpret_cast<const float*>(xq), __ldg(x_scale), M,
                       K, chunk_row(m0, tid + j * kThreads),
                       chunk_k((first + i) * kBK, tid + j * kThreads),
                       K % 4 == 0 &&
                           reinterpret_cast<uintptr_t>(xq) % 16 == 0);"""),
    ("""  if (threads > 0) {
    const bool vec4""", """  if (n_sums > 0) cudaMemsetAsync(sums, 0, 4 * (size_t)n_sums, s);
  xq = reinterpret_cast<signed char*>(const_cast<float*>(x));
  if (false) {
    const bool vec4""")]
# (name, source, {file: [(shipped text, variant text), ...]})
VARIANTS = (
    ("K5 split: cvt for hi and lo", "window_attn.cu", {
        "mma_tf32x3.cuh": [(SPLIT, SPLIT.replace("to_tf32_non_nan(x)",
                                                 "to_tf32(x)"))]}),
    ("K5 split: integer form for hi and lo (drops NaN)", "window_attn.cu", {
        "mma_tf32x3.cuh": [(SPLIT, SPLIT.replace("to_tf32(x -",
                                                 "to_tf32_non_nan(x -"))]}),
    ("K5 one accumulator for O over the whole walk", "window_attn.cu", {
        "window_attn.cu": [
            ("        for (int e = 0; e < 4; ++e) pv[mt][n][e] = 0.0f;",
             "        for (int e = 0; e < 4; ++e)\n"
             "          acc[mt][n][e] *= alpha[mt][e >> 1];"),
            ("        mma3(pv[mt], ph, pl, bh, bl);",
             "        mma3(acc[mt], ph, pl, bh, bl);"),
            ("          acc[mt][n][e] =\n"
             "              fmaf(acc[mt][n][e], alpha[mt][e >> 1], "
             "pv[mt][n][e]);",
             "          (void)pv;")]}),
    ("K5 one 16-row slice a warp at every head dim", "window_attn.cu", {
        "window_attn.cu": [("kMT = HD <= 64 ? 2 : 1;", "kMT = 1;")]}),
    ("K5 32-key tiles at head dim 128 (two blocks an SM)", "window_attn.cu", {
        "window_attn.cu": [("kBlockK = HD <= 128 ? 64 : 32;",
                            "kBlockK = HD <= 64 ? 64 : 32;")]}),
    ("K5 4 warps a block", "window_attn.cu", {
        "window_attn.cu": [("constexpr int kWarps = 8;",
                            "constexpr int kWarps = 4;")]}),
    ("K4 each 32-deep stage in a zeroed fragment", "ssd_scan.cu", {
        "ssd_scan.cu": [
            ("    const float* sb = sa + Tl::kA;\n",
             "    const float* sb = sa + Tl::kA;\n"
             "    float part[MT][NT][4] = {};\n"),
            ("        mma3(acc[mt], ah, al, bh, bl);",
             "        mma3(part[mt], ah, al, bh, bl);"),
            ("    __syncthreads();   // this stage is free for stage st + 2",
             "    for (int mt = 0; mt < MT; ++mt)\n"
             "      for (int nt = 0; nt < NT; ++nt)\n"
             "        for (int e = 0; e < 4; ++e)\n"
             "          acc[mt][nt][e] += part[mt][nt][e];\n"
             "    __syncthreads();")]}),
    ("K4 64 x 128 state tiles at every N", "ssd_scan.cu", {
        "ssd_scan.cu": [("  const bool wide = N > 64;",
                         "  const bool wide = true;")]}),
    ("K1/K2 R = 1 word row a warp", "pareto_rank.cu", {
        "pareto_rank.cu": [(ROWS_PER_LANE, ROWS_PER_LANE.replace("4", "1"))]}),
    ("K1/K2 R = 2 word rows a warp", "pareto_rank.cu", {
        "pareto_rank.cu": [(ROWS_PER_LANE, ROWS_PER_LANE.replace("4", "2"))]}),
    ("K1/K2 R = 8 word rows a warp", "pareto_rank.cu", {
        "pareto_rank.cu": [(ROWS_PER_LANE, ROWS_PER_LANE.replace("4", "8"))]}),
    ("K2 4 row splits (4096 rows each)", "pareto_rank.cu", {
        "pareto_rank.cu": [(COUNT_ROWS, COUNT_ROWS.replace("1024", "4096"))]}),
    ("K2 64 columns a block", "pareto_rank.cu", {
        "pareto_rank.cu": [(COUNT_COLS, COUNT_COLS.replace("256", "64"))]}),
    ("K2 splits summed by a second launch", "pareto_rank.cu", {
        "pareto_rank.cu": SECOND_LAUNCH}),
    ("K3 3-stage ring", "quant_matmul.cu", {"quant_matmul.cu": [
        ("constexpr int kStages = 4;", "constexpr int kStages = 3;")]}),
    ("K3 5-stage ring", "quant_matmul.cu", {"quant_matmul.cu": [
        ("constexpr int kStages = 4;", "constexpr int kStages = 5;")]}),
    ("K3 warps 4 x 2 (32 x 64 a warp)", "quant_matmul.cu", {
        "quant_matmul.cu": [("constexpr int kWarpsM = 2;",
                             "constexpr int kWarpsM = 4;")]}),
    ("K3 one block an SM", "quant_matmul.cu", {"quant_matmul.cu": [
        ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")]}),
    ("K3 splits combined by the last arrival at a tile's counter",
     "quant_matmul.cu", {"quant_matmul.cu": QMM_LAST_ARRIVAL}),
    ("K3 quantize fused into the product", "quant_matmul.cu", {
        "quant_matmul.cu": QMM_FUSED}),
    ("K3 without the transpose", "quant_matmul.cu", {
        "quant_matmul.cu": QMM_TRANSPOSE}),
    ("K3 without the copies", "quant_matmul.cu", {
        "quant_matmul.cu": QMM_COPIES}),
    ("K3 without the copies or the transpose", "quant_matmul.cu", {
        "quant_matmul.cu": QMM_COPIES + QMM_TRANSPOSE}),
    ("K3 without the products", "quant_matmul.cu", {
        "quant_matmul.cu": QMM_PRODUCTS}),
)

PEAK_SOURCE = r'''
#include <cuda_runtime.h>
#include "mma_s8.cuh"
#include "mma_tf32x3.cuh"
__global__ void mma_peak(float* out, int iters) {
  uint32_t a[4], b[8][2];
  for (int i = 0; i < 4; ++i)
    a[i] = tf32x3::to_tf32(threadIdx.x * 1e-3f + i);
  for (int n = 0; n < 8; ++n) {
    b[n][0] = tf32x3::to_tf32(n * 0.5f);
    b[n][1] = tf32x3::to_tf32(threadIdx.x * 1e-3f);
  }
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int n = 0; n < 8; ++n) tf32x3::mma_m16n8k8(d[n], a, b[n]);
  float s = 0.0f;
  for (int n = 0; n < 8; ++n)
    for (int e = 0; e < 4; ++e) s += d[n][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void round_cvt(const float* x, uint32_t* out) {
  out[threadIdx.x] = tf32x3::to_tf32(x[threadIdx.x]);
}
__global__ void round_integer(const float* x, uint32_t* out) {
  out[threadIdx.x] = tf32x3::to_tf32_non_nan(x[threadIdx.x]);
}
extern "C" int mma_peak_launch(float* out, int iters, int blocks,
                               void* stream) {
  mma_peak<<<blocks, 128, 0, (cudaStream_t)stream>>>(out, iters);
  return cudaGetLastError();
}
__global__ void imma_peak(int* out, int iters) {
  uint32_t a[4], b[8][2];
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 0x01010101u + i;
  for (int n = 0; n < 8; ++n) {
    b[n][0] = n * 0x01020304u;
    b[n][1] = threadIdx.x;
  }
  int d[8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int n = 0; n < 8; ++n) s8::mma_m16n8k32(d[n], a, b[n]);
  int s = 0;
  for (int n = 0; n < 8; ++n)
    for (int e = 0; e < 4; ++e) s += d[n][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int imma_peak_launch(int* out, int iters, int blocks,
                                void* stream) {
  imma_peak<<<blocks, 128, 0, (cudaStream_t)stream>>>(out, iters);
  return cudaGetLastError();
}
'''


def build():
    """Write the variants' sources and build them and the rate probe in
    parallel; returns ({name: library path}, probe library path)."""
    from repro_torch.kernels import _build
    if OUT.exists():
        shutil.rmtree(OUT)
    jobs = {}
    for i, (name, source, edits) in enumerate(VARIANTS):
        d = OUT / f"v{i}"
        d.mkdir(parents=True)
        for f in _build.CSRC.iterdir():
            text = f.read_text()
            for old, new in edits.get(f.name, ()):
                assert text.count(old) == 1, (name, f.name, old)
                text = text.replace(old, new)
            (d / f.name).write_text(text)
        jobs[name] = (d / source, d / f"{Path(source).stem}.so")
    probe = OUT / "mma_peak.cu"
    probe.write_text(PEAK_SOURCE)
    jobs["probe"] = (probe, OUT / "mma_peak.so")
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{src.parent}",
         f"-I{_build.CSRC}", "-o", str(so), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (src, so) in jobs.items()}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
    _build.build_all()
    return ({name: so for name, (_, so) in jobs.items() if name != "probe"},
            jobs["probe"][1])


@contextlib.contextmanager
def using(module, so):
    """``module``'s wrapper launches the library ``so`` inside the block
    (and plans its scratch with it, where the wrapper caches a plan)."""
    from repro_torch.kernels import _build
    load, lib = _build.load, module._lib
    _build.load = lambda source: ctypes.CDLL(str(so))
    try:
        variant = module._lib.__wrapped__()   # the wrapper's signatures
    finally:
        _build.load = load
    plan = getattr(module, "_plan", None)
    module._lib = lambda: variant
    try:
        if plan is not None:
            plan.cache_clear()
        yield
    finally:
        module._lib = lib
        if plan is not None:
            plan.cache_clear()


def mma_rate(so):
    lib = ctypes.CDLL(str(so))
    lib.mma_peak_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]
    blocks, iters = 132 * 16, 4096
    out = torch.empty(blocks * 128, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ms = chip_smoke.cuda_ms(
        lambda: lib.mma_peak_launch(out.data_ptr(), iters, blocks, stream), 3)
    flops = blocks * 4 * iters * 8 * 2 * 16 * 8 * 8
    print(f"mma.sync m16n8k8 TF32: {flops / ms / 1e9:.1f} TFLOP/s "
          f"({blocks} blocks of 4 warps, 8 independent accumulators)")


def imma_rate(so):
    lib = ctypes.CDLL(str(so))
    lib.imma_peak_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
    blocks, iters = 132 * 16, 4096
    out = torch.empty(blocks * 128, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ms = chip_smoke.cuda_ms(
        lambda: lib.imma_peak_launch(out.data_ptr(), iters, blocks, stream),
        3)
    ops = blocks * 4 * iters * 8 * 2 * 16 * 8 * 32
    print(f"mma.sync m16n8k32 int8: {ops / ms / 1e9:.1f} TOP/s "
          f"({blocks} blocks of 4 warps, 8 independent accumulators)")


def qmm_operands(dev, m, k, n, seed):
    """x relu(normal) (M, K) and per-channel int8 weights of a Kaiming
    (N, K) draw, as chip_smoke.py phase 8's VGG layers."""
    from repro_torch.nn.module import kaiming
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.relu(torch.randn((m, k), generator=g, device=dev))
    w = kaiming((n, k), fan_in=k, generator=g, device=dev)
    return (x, *chip_smoke.int8_columns(w), chip_smoke.act_scale(x))


def print_qmm_sass():
    """The product kernel's k-step loop in its SASS (16-byte copies of
    w_q): its instructions for its IMMA, the most common opcodes."""
    from repro_torch.kernels import _build
    listing = _build.sass("quant_matmul.cu")
    if listing is None:
        print("no cuobjdump in the toolkit: K3's SASS not read")
        return
    loop = chip_smoke.inner_loop(listing["qmm_product_kernel<16>"], "IMMA")
    ops = collections.Counter(op for _, op, _ in loop)
    print(f"K3's k-step loop (qmm_product_kernel<16>): {len(loop)} "
          f"instructions for {ops['IMMA']} IMMA; "
          + ", ".join(f"{op} {n}" for op, n in ops.most_common(12)))


def device_ms(fn, reps=20):
    """Milliseconds a call of ``fn`` holds the card: ``reps`` calls
    captured in a CUDA graph, the graph replayed and timed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return chip_smoke.cuda_ms(graph.replay, 5) / reps


def qmm_builds(dev, builds):
    """K3 through each build at the classifiers' shapes, bit for bit
    against the exact reference (a build "without" a part of the k-step is
    only timed, at fc0); then the shipped build's splits, and the wrapper's
    floor."""
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.testing import quant_matmul_exact
    shapes = (("efficientnet_b0 head", (chip_smoke.CNN_BATCH, 1280, 1000)),
              *((f"vgg16 fc{i}", (chip_smoke.CNN_BATCH, k, n))
                for i, (k, n) in enumerate(chip_smoke.VGG_FC)))
    sms = qm._sms(0)
    ablations = [b for b in builds if b[0].startswith("K3 without")]
    builds = [b for b in builds if b not in ablations]
    for label, shape in shapes:
        args = qmm_operands(dev, *shape, 1)
        exact = quant_matmul_exact(*args)
        xq = torch.clamp(torch.round(args[0] / args[3]), -128, 127).to(
            torch.int8)
        int_mm = chip_smoke.cuda_ms(lambda: torch._int_mm(xq, args[1]), 20)
        print(f"K3 at {label} {shape}, splits {qm.split_count(*shape, sms)}"
              f" (torch._int_mm, product only: {int_mm:.4f} ms):")
        for name, so in builds + builds[:1]:
            with using(qm, so) if so else contextlib.nullcontext():
                assert torch.equal(qm.quant_matmul(*args), exact), name
                ms = chip_smoke.cuda_ms(lambda: qm.quant_matmul(*args), 20)
                dev_ms = device_ms(lambda: qm.quant_matmul(*args))
            print(f"  {name}: {ms:.4f} ms, in a CUDA graph {dev_ms:.4f} ms, "
                  f"bit-exact")
        line = []
        for splits in (1, 2, 3, 4, 6, 8, 12, 16, 32):
            assert torch.equal(qm.quant_matmul(*args, splits=splits), exact)
            line.append(f"{splits}: " + format(device_ms(
                lambda: qm.quant_matmul(*args, splits=splits)), ".4f"))
        print(f"  shipped in a CUDA graph at splits {', '.join(line)} ms, "
              f"bit-exact")
        for name, so in ablations if label == "vgg16 fc0" else ():
            with using(qm, so):
                dev_ms = device_ms(lambda: qm.quant_matmul(*args))
            print(f"  {name}: in a CUDA graph {dev_ms:.4f} ms (result not "
                  f"compared)")
        del args, exact, xq
    tiny = qmm_operands(dev, 1, 1, 1, 2)
    print(f"K3's wrapper at 1 x 1 x 1: "
          f"{chip_smoke.cuda_ms(lambda: qm.quant_matmul(*tiny), 50):.4f} ms "
          f"a call, in a CUDA graph "
          f"{device_ms(lambda: qm.quant_matmul(*tiny)):.4f} ms")


def print_rounding_sass(so):
    """The opcodes of the two rounding probes, from ``cuobjdump -sass``."""
    from repro_torch.kernels import _build
    tool = _build._cuobjdump()
    if tool is None:
        print("no cuobjdump in the toolkit: the roundings' SASS not shown")
        return
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if name in ("_Z9round_cvtPKfPj", "_Z13round_integerPKfPj"):
            ops = []
            for line in part.splitlines():
                if "/*0" in line and ";" in line:
                    words = line.split(";")[0].split("*/")[-1].split()
                    ops += words[1:2] if words[:1] and words[0].startswith(
                        "@") else words[:1]   # the opcode after a predicate
            print(f"{name}: {' '.join(ops)}")


def report(label, got, exact, ms):
    """Largest error and signed relative bias against float64."""
    errs, num, den = [], 0.0, 0.0
    for g, e in zip(got, exact):
        d = g.double() - e
        errs.append(float(d.abs().max()))
        num += float((d * e.sign()).sum())
        den += float(e.abs().sum())
    print(f"  {label}: {ms:.4f} ms, max err vs float64 {max(errs):.3e}, "
          f"bias {num / den:+.3e}")


def print_ptxas(source):
    """``ptxas -v``'s registers, spills and shared memory for each kernel
    of the shipped ``source``."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    done = subprocess.run(
        [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-Xptxas", "-v", f"-I{_build.CSRC}", "-cubin",
         "-o", str(OUT / "ptxas.cubin"), str(_build.CSRC / source)],
        capture_output=True, text=True, timeout=600)
    for line in (done.stdout + done.stderr).splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill")):
            print(f"  {line.strip()}")


def window_attn_builds(dev, builds, arch=chip_smoke.LM_ARCH):
    from repro_torch.kernels import ref, window_attn
    from repro_torch.models.registry import get_config
    cfg = get_config(arch)
    b, t, h, kv, hd, w = (chip_smoke.LM_B, chip_smoke.LM_T, cfg.n_heads,
                          cfg.n_kv, cfg.resolved_head_dim, cfg.window)
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(s, generator=g, device=dev)
               for s in ((b, t, h, hd), (b, t, kv, hd), (b, t, kv, hd)))
    heads = (0, h // 2, h - 1)          # of batch row 0, exact in float64
    exact = [ref.window_attn_gqa(q[:1, :, i:i + 1].double(),
                                 k[:1, :, i // (h // kv)][:, :, None].double(),
                                 v[:1, :, i // (h // kv)][:, :, None].double(),
                                 w)[0, :, 0] for i in heads]
    print(f"K5 window_attn at q ({b}, {t}, {h}, {hd}), window {w} "
          f"(float64 for heads {heads} of row 0):")
    for name, so in builds:
        with using(window_attn, so) if so else contextlib.nullcontext():
            out = window_attn.window_attn(q, k, v, w)
            ms = chip_smoke.cuda_ms(lambda: window_attn.window_attn(q, k, v, w),
                                    10)
        report(name, [out[0, :, i] for i in heads], exact, ms)


def ssd_scan_builds(dev, builds):
    from repro_torch.kernels import ref, ssd_scan
    from repro_torch.models.registry import get_config
    for arch in chip_smoke.SSD_MODELS:
        cfg = get_config(arch)
        b, t, chunk = chip_smoke.LM_B, chip_smoke.LM_T, cfg.ssm_chunk
        h = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
        p, n = cfg.ssm_headdim, cfg.ssm_state
        g = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn((b, t, h, p), generator=g, device=dev)
        dt = torch.nn.functional.softplus(
            torch.randn((b, t, h), generator=g, device=dev) - 1)
        A = -torch.exp(torch.randn((h,), generator=g, device=dev) * 0.3)
        B = torch.randn((b, t, n), generator=g, device=dev) * 0.5
        C = torch.randn((b, t, n), generator=g, device=dev) * 0.5
        args = (x, dt, A, B, C)
        exact = ref.ssd_scan(*(a.double() for a in args), chunk)
        print(f"K4 ssd_scan at {arch}'s shape x ({b}, {t}, {h}, {p}), "
              f"N {n}, chunk {chunk} (y and the final state):")
        for name, so in builds:
            with using(ssd_scan, so) if so else contextlib.nullcontext():
                out = ssd_scan.ssd_scan(*args, chunk)
                ms = chip_smoke.cuda_ms(lambda: ssd_scan.ssd_scan(*args, chunk),
                                        10)
            report(name, out, exact, ms)
        del exact, args


def pareto_builds(dev, builds):
    """K1 at the search's shape (n 32768) and K2 at the final front's (n
    16384) through each build, bit-exact against the plain versions; then
    the shipped K1 at other row and column tiles."""
    from repro_torch.kernels import ops, pareto_rank, ref
    pop = chip_smoke.POP
    F, CV = (torch.from_numpy(a).to(dev)
             for a in chip_smoke.population(2 * pop, seed=1))
    F2, CV2 = (torch.from_numpy(a).to(dev)
               for a in chip_smoke.population(pop, seed=2))
    ones = torch.ones(pop, dtype=torch.bool, device=dev)
    words = ref.packed_domination(F, CV, F, CV, chip_smoke.RANK_BLOCK)
    counts = ref.domination_counts(F2, CV2, ones, chip_smoke.RANK_BLOCK)
    tile = dict(bp=ops._row_tile(chip_smoke.RANK_BLOCK), bq=ops._COL_TILE)
    print(f"K1 packed_domination at F ({2 * pop}, 3), tiles {tile}; "
          f"K2 domination_counts at F ({pop}, 3):")
    for name, so in builds:
        with using(pareto_rank, so) if so else contextlib.nullcontext():
            assert torch.equal(pareto_rank.packed_domination(
                F, CV, F, CV, **tile), words), name
            assert torch.equal(pareto_rank.domination_counts(F2, CV2, ones),
                               counts), name
            k1 = chip_smoke.cuda_ms(
                lambda: pareto_rank.packed_domination(F, CV, F, CV, **tile),
                20)
            k2 = chip_smoke.cuda_ms(
                lambda: pareto_rank.domination_counts(F2, CV2, ones), 20)
        print(f"  {name}: K1 {k1:.4f} ms, K2 {k2:.4f} ms, both bit-exact")
    for bp, bq in ((1024, 256), (4096, 256), (2048, 64), (2048, 128),
                   (2048, 512), (2048, 1024)):
        ms = chip_smoke.cuda_ms(lambda: pareto_rank.packed_domination(
            F, CV, F, CV, bp=bp, bq=bq), 20)
        print(f"  shipped K1 at bp {bp}, bq {bq}: {ms:.4f} ms")


def forwards(dev, arch, module, builds):
    from repro_torch.models.registry import build_model, get_config
    cfg = get_config(arch)
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(chip_smoke.SEED))
    rng = np.random.default_rng(chip_smoke.SEED)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (chip_smoke.LM_B, chip_smoke.LM_T))).to(dev)}
    with torch.no_grad():
        want = model(batch, impl="ref")
        print(f"{arch} forward, {chip_smoke.LM_B} x {chip_smoke.LM_T} "
              f"tokens, logits against the plain forward:")
        for name, so in builds:
            with using(module, so) if so else contextlib.nullcontext():
                err = float((model(batch, impl="cuda") - want).abs().max())
            print(f"  {name}: max_abs_err {err:.3e}")
    del model, want


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import ssd_scan, window_attn
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line())
    libs, probe = build()
    shipped = ("shipped", None)
    if "--qmm" in argv:
        imma_rate(probe)
        print_qmm_sass()
        qmm_builds(dev, [shipped] + [(n, s) for n, s in libs.items()
                                     if n.startswith("K3")])
        return 0
    pareto_builds(dev, [shipped] + [(n, s) for n, s in libs.items()
                                    if n.startswith(("K1", "K2"))])
    if "--pareto" in argv:
        return 0
    k5 = [shipped] + [(n, s) for n, s in libs.items() if n.startswith("K5")]
    if "--k5" in argv:
        print("window_attn.cu, ptxas:")
        print_ptxas("window_attn.cu")
        for rnd in range(2):
            for arch in (chip_smoke.LM_ARCH, chip_smoke.VLM_ARCH):
                window_attn_builds(dev, k5, arch)
        return 0
    mma_rate(probe)
    print_rounding_sass(probe)
    k4 = [shipped] + [(n, s) for n, s in libs.items() if n.startswith("K4")]
    window_attn_builds(dev, k5)
    ssd_scan_builds(dev, k4)
    forwards(dev, chip_smoke.LM_ARCH, window_attn, k5)
    forwards(dev, chip_smoke.SSM_ARCH, ssd_scan, k4)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
