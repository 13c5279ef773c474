// Fake-quant int8 matrix product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package,
// repro/kernels/quant_matmul.py::quant_matmul (body _kernel):
//
//   y[m, n] = (float)(sum_k q(x[m, k]) * w_q[k, n]) * x_scale * w_scale[n]
//   q(v)    = clip(round_half_even(v / x_scale), -128, 127)
//
// with x (M, K) float32, w_q (K, N) int8 row-major, w_scale (N,) float32 and
// x_scale a float32 scalar that stays on the device (read by pointer).
//
// What bounds it on an H100: at the shapes of the zoo's classifiers the
// bytes.  VGG-16's first classifier layer (M = 256, K = 25088, N = 4096)
// moves ~0.13 GB (x once, w_q once, y once: ~0.040 ms at 3.35 TB/s) for
// 5.3e10 int8 operations (~0.027 ms at the 1979 TOP/s dense int8 tensor-core
// rate); EfficientNet-B0's head (256 x 1280 x 1000) is ~1 microsecond of
// either, so launch latency dominates it.
//
// Design (a simple first version on the CUDA cores: no int8 tensor cores,
// no wgmma, no TMA).  The TPU kernel quantizes x inside every (bm, bk) tile,
// N / bn times over, to keep its working set in VMEM.  Here, in two launches
// on the caller's stream:
//   1. quantize: one thread per group of 4 consecutive k of one row writes
//      the 4 codes of x as one packed int32 word, once, into an (M, Kw)
//      int8x4 scratch (Kw = ceil(K / 4), the tail zero-padded);
//   2. product: 64 x 64 output tiles, 256 threads with 4 x 4 outputs each,
//      accumulate in int32 with __dp4a over 32-deep K steps staged in
//      shared memory: x's words as they are, w_q's 4 consecutive rows of one
//      column packed into one word while staging (w_q is (K, N) row-major,
//      dp4a wants 4 consecutive k of one n); the next step's operands are
//      loaded into registers while the current step is multiplied.  The
//      epilogue scales in the reference's order.
// Rounding: v / x_scale is divided correctly rounded (__fdiv_rn, never
// v * (1 / x_scale): one ulp moves a tie to another code) and rounded half
// to even by rintf, as jnp.round and torch.round do.  The int32 sums are
// exact for K up to 131072 (|sum| <= K * 128 * 128 < 2^31), so the kernel
// equals the float32 plain version wherever that version's partial sums
// stay below 2^24.  Ragged M, N and K are masked in the kernel: every shape
// launches.
//
// Plain C interface, loaded with ctypes; the caller allocates the output and
// the scratch, and the launch returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;        // output tile rows and columns
constexpr int kDepthW = 8;       // staged depth in int8x4 words (32 k)
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLds = kTile + 4;  // padded row of a staged tile (16 B aligned)
constexpr int kLoads = kTile * kDepthW / kThreads;   // words per thread: 2

__device__ __forceinline__ unsigned quantize_code(float v, float s) {
  float r = rintf(__fdiv_rn(v, s));
  r = fminf(fmaxf(r, -128.0f), 127.0f);
  return static_cast<unsigned>(static_cast<int>(r)) & 0xffu;
}

// x (M, K) float32 -> xq (M, Kw) int8x4 words; byte j of word w of row m is
// the code of x[m, 4w + j] (0 beyond K)
__global__ void qmm_quantize_kernel(const float* __restrict__ x,
                                    const float* __restrict__ x_scale,
                                    unsigned* __restrict__ xq, int M, int K,
                                    int Kw) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)M * Kw) return;
  const long long m = idx / Kw;
  const int k0 = 4 * (int)(idx % Kw);
  const float s = __ldg(x_scale);
  unsigned word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (k0 + j < K) word |= quantize_code(x[m * K + k0 + j], s) << (8 * j);
  xq[idx] = word;
}

__global__ void __launch_bounds__(kThreads)
qmm_product_kernel(const int* __restrict__ xq, const signed char* __restrict__ w,
                   const float* __restrict__ w_scale,
                   const float* __restrict__ x_scale, float* __restrict__ out,
                   int M, int K, int N, int Kw) {
  __shared__ __align__(16) int as[kDepthW][kLds];   // as[kw][m]
  __shared__ __align__(16) int bs[kDepthW][kLds];   // bs[kw][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;

  // staging coordinates: x's words row-major (8 words of a row side by
  // side), w_q's packed words column-major (64 columns side by side)
  int a_row[kLoads], a_kw[kLoads], b_kw[kLoads], b_col[kLoads];
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    const int idx = tid + r * kThreads;
    a_row[r] = idx / kDepthW;
    a_kw[r] = idx % kDepthW;
    b_kw[r] = idx / kTile;
    b_col[r] = idx % kTile;
  }

  int a_next[kLoads], b_next[kLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int m = m0 + a_row[r], kw = k0 + a_kw[r];
      a_next[r] = (m < M && kw < Kw) ? __ldg(xq + (long long)m * Kw + kw) : 0;
      const int n = n0 + b_col[r], kb = 4 * (k0 + b_kw[r]);
      unsigned word = 0;
      if (n < N) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (kb + j < K)
            word |= (unsigned)(unsigned char)__ldg(w + (long long)(kb + j) * N + n)
                    << (8 * j);
      }
      b_next[r] = (int)word;
    }
  };

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  load(0);
  for (int k0 = 0; k0 < Kw; k0 += kDepthW) {
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      as[a_kw[r]][a_row[r]] = a_next[r];
      bs[b_kw[r]][b_col[r]] = b_next[r];
    }
    __syncthreads();
    if (k0 + kDepthW < Kw) load(k0 + kDepthW);
#pragma unroll
    for (int kw = 0; kw < kDepthW; ++kw) {
      const int4 a = *reinterpret_cast<const int4*>(&as[kw][4 * ty]);
      const int4 b = *reinterpret_cast<const int4*>(&bs[kw][4 * tx]);
      const int av[4] = {a.x, a.y, a.z, a.w};
      const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float xs = __ldg(x_scale);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n < N)
        out[(long long)m * N + n] =
            __fmul_rn(__fmul_rn((float)acc[i][j], xs), __ldg(w_scale + n));
    }
  }
}

}  // namespace

extern "C" {

// x (M, K) float32, w_q (K, N) int8, w_scale (N,) float32, x_scale one
// float32, out (M, N) float32, xq scratch (M, ceil(K / 4)) int32; all
// contiguous on the device.
int quant_matmul_launch(const float* x, const signed char* w_q,
                        const float* w_scale, const float* x_scale, float* out,
                        int* xq, int M, int K, int N, void* stream) {
  if (M < 0 || K < 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Kw = (K + 3) / 4;
  cudaError_t err;
  const long long words = (long long)M * Kw;
  if (words > 0) {
    qmm_quantize_kernel<<<(unsigned)((words + kThreads - 1) / kThreads),
                          kThreads, 0, s>>>(
        x, x_scale, reinterpret_cast<unsigned*>(xq), M, K, Kw);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  qmm_product_kernel<<<grid, kThreads, 0, s>>>(xq, w_q, w_scale, x_scale, out,
                                               M, K, N, Kw);
  return cudaGetLastError();
}

const char* quant_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
