// Fake-quant int8 matrix product for Hopper (sm_90a), on the int8 tensor
// cores.
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
// 5.3e10 int8 operations (~0.027 ms at the 1979 TOP/s dense int8 rate of
// wgmma; ~0.048 ms at the 1103-1127 TOP/s that mma.sync reaches, measured
// by chip_variants.py --qmm);
// EfficientNet-B0's head (256 x 1280 x 1000) is ~1 microsecond of either,
// so launch latency dominates it.
//
// Design, on the caller's stream:
//   1. quantize: one thread per 16-byte chunk of codes reads 8 consecutive
//      x of two rows (as float4 where x and K allow) and writes their codes
//      in the order the product's fragments read them (below), K rounded up
//      to the 64-deep k-step and M to the 128-row tile, the padding zero;
//      where the product splits K, it also zeroes the (M, N) int32 sums.
//   2. product: 128 x 128 output tiles, 8 warps as 2 (m) x 4 (n), each warp
//      64 x 32 as 4 x 4 mma.sync m16n8k32 int8 products (mma_s8.cuh)
//      accumulating in int32.  64-deep k-steps are staged with cp.async in
//      a ring of kStages: the codes' 8 KB block as it lies, and w_q's (64,
//      128) tile as it lies in memory (N-contiguous), copied as wide as its
//      row stride and address allow (16, 8 or 4 bytes, else byte by byte),
//      zero-filled past K and N.  One step ahead of the products, that tile
//      is transposed in shared memory, 4 x 4 bytes at a time with
//      __byte_perm, into a (128, 64) K-contiguous tile for the B operand.
//      One 16-byte shared load gives a lane a whole A fragment (a0..a3 of
//      one k32 product), another its B fragments of both k32 products
//      (k 16t..16t+3 for b0, the next 4 for b1, the last 8 for the second
//      product; the codes' order pairs the same k).  The shared layouts are
//      free of bank conflicts (tests/test_torch_qmm_design.py counts them):
//      w_q's staged rows with their 16-byte chunks swizzled by k / 8, the
//      transposed rows n and n ^ 1 swapped where bit 2 of n is set.
//   3. Split K, where the product's grid is too small for the card: its z
//      walks `splits` ranges of k-steps, each block adds its int32 tile to
//      the (M, N) int32 sums with atomicAdd, and an epilogue launch scales
//      the sums.  int32 sums are exact in any order, so every split gives
//      the same bits.  Unsplit, the product block applies the epilogue.
// Rounding: v / x_scale is divided correctly rounded (__fdiv_rn, never
// v * (1 / x_scale): one ulp moves a tie to another code) and rounded half
// to even by rintf, as jnp.round and torch.round do; the epilogue is two
// correctly rounded products in the reference's order.  The int32 sums are
// exact for K up to 131072 (|sum| <= K * 128 * 128 < 2^31), so the result
// is bit for bit the exact sum rounded once to float32, then scaled.
// Ragged M, N and K are masked in the kernel: every shape launches.
//
// Plain C interface, loaded with ctypes; the caller allocates the output
// and the scratch (quant_matmul_scratch_bytes), and the launch returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

#include "mma_s8.cuh"
#include "mma_tf32x3.cuh"

namespace {

using tf32x3::cp_async16;
using tf32x3::cp_async4;
using tf32x3::cp_async8;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;

constexpr int kBM = 128, kBN = 128;   // output tile
constexpr int kBK = 64;               // k-step, bytes of a fragment row
constexpr int kThreads = 256;         // 8 warps
constexpr int kWarpsM = 2;            // ... as kWarpsM (m) x 8 / kWarpsM (n)
constexpr int kMT = kBM / kWarpsM / 16;          // a warp's 16-row tiles
constexpr int kNT = kBN / (8 / kWarpsM) / 8;     // ... and 8-column tiles
constexpr int kStages = 4;            // ring of staged k-steps
constexpr int kSlot = kBM * kBK + kBK * kBN;   // codes, then w_q as it lies
constexpr int kBt = kBN * kBK;                 // one transposed w_q tile
constexpr int kSmem = kStages * kSlot + 2 * kBt;
constexpr int kQuantThreads = 256;

__device__ __forceinline__ unsigned quantize_code(float v, float s) {
  float r = rintf(__fdiv_rn(v, s));
  r = fminf(fmaxf(r, -128.0f), 127.0f);
  return static_cast<unsigned>(static_cast<int>(r)) & 0xffu;
}

// The codes' layout, in the order the product's fragments read them: for
// each 128-row tile of x and each 64-deep k-step an 8 KB block, made of
// eight 1 KB blocks of 16 rows; in one of those, lane (g, t)'s 16 bytes of
// k32 product s (at ((s * 8 + g) * 4 + t) * 16) are its a0..a3: rows g and
// g + 8 (interleaved word by word) at k 16t + 8s .. 16t + 8s + 7, the first
// four k in a0 / a1, the next four in a2 / a3.  Rows past M and k past K
// hold 0.  One 16-byte shared load then gives a lane a whole A fragment.
//
// One 16-byte chunk of the codes: rows m and m + 8 of x at k..k+7 (x as
// float4 where vec4: x 16-byte aligned, K a multiple of 4).
__device__ __forceinline__ uint4 code_chunk(const float* x, float s, int M,
                                            int K, int m, int k, bool vec4) {
  uint32_t word[4] = {0, 0, 0, 0};   // rows m, m + 8 at k..k+3, k+4..k+7
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m + 8 * h;
    if (row >= M) continue;
    const float* p = x + (size_t)row * K + k;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      uint32_t& w = word[2 * q + h];
      if (vec4 && k + 8 <= K) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p) + q);
        w = quantize_code(v.x, s) | quantize_code(v.y, s) << 8 |
            quantize_code(v.z, s) << 16 | quantize_code(v.w, s) << 24;
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (k + 4 * q + b < K)
            w |= quantize_code(p[4 * q + b], s) << (8 * b);
      }
    }
  }
  return make_uint4(word[0], word[1], word[2], word[3]);
}

// Chunk c (0..511) of the codes' 8 KB block at (m0, k0): its first row and k.
__device__ __forceinline__ int chunk_row(int m0, int c) {
  return m0 + 16 * (c / 64) + (c / 4) % 8;
}
__device__ __forceinline__ int chunk_k(int k0, int c) {
  return k0 + 16 * (c % 4) + 8 * (c % 64 / 32);
}

// x (M, K) float32 -> xq, one thread per 16-byte chunk; sums[0, n_sums) =
// 0.
__global__ void __launch_bounds__(kQuantThreads)
qmm_quantize_kernel(const float* __restrict__ x,
                    const float* __restrict__ x_scale,
                    signed char* __restrict__ xq, int* __restrict__ sums,
                    int M, int K, int Mp, int Kp, long long n_sums,
                    bool vec4) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n_sums) sums[idx] = 0;
  if (idx >= (long long)Mp * Kp / 16) return;
  const long long block = idx / 512;   // (128-row tile, k-step)
  const int steps = Kp / kBK, c = (int)(idx % 512);
  *reinterpret_cast<uint4*>(xq + 16 * idx) = code_chunk(
      x, __ldg(x_scale), M, K, chunk_row((int)(block / steps) * kBM, c),
      chunk_k((int)(block % steps) * kBK, c), vec4);
}

// Byte offset of (k row r, byte b) in a staged (64, 128) w_q tile: each
// row's 16-byte chunks swizzled by r / 8, so that the transpose's reads of
// one column group from 8 rows apart meet distinct banks.
__device__ __forceinline__ int raw_offset(int r, int b) {
  return r * kBN + ((((b >> 4) ^ (r >> 3)) & 7) << 4) + (b & 15);
}

// Row of the transposed tile that holds column n: n and n ^ 1 swapped where
// bit 2 of n is set, so that the transpose's 8-byte stores to columns 4c + j
// and 4c + 4 + j fall in different halves of the banks.
__device__ __forceinline__ int bt_row(int n) { return n ^ ((n >> 2) & 1); }

// One piece of w_q's tile: kVec bytes by cp.async (kVec divides N and w_q's
// address), or one byte through registers; zeros when !in.
template <int kVec>
__device__ __forceinline__ void copy_w(unsigned char* dst,
                                       const signed char* src, bool in) {
  if constexpr (kVec == 16) {
    cp_async16(dst, src, in);
  } else if constexpr (kVec == 8) {
    cp_async8(dst, src, in);
  } else if constexpr (kVec == 4) {
    cp_async4(dst, src, in);
  } else {
    *dst = in ? static_cast<unsigned char>(*src) : 0;
  }
}

// The staged (64 k, 128 n) tile -> bt (128 n, 64 k): each thread takes 8 k
// rows of a 4-column group, two 4 x 4 byte blocks, and stores each column's
// 8 consecutive k as one 8-byte word.
__device__ __forceinline__ void transpose(unsigned char* bt,
                                          const unsigned char* raw) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int kq = lane % 8, c = 4 * warp + lane / 8;
  uint32_t r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    r[i] = *reinterpret_cast<const uint32_t*>(raw +
                                              raw_offset(8 * kq + i, 4 * c));
  uint32_t col[4][2];   // column 4c + j: k 8kq..8kq+3, then 8kq+4..8kq+7
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t* q = r + 4 * h;
    const uint32_t lo01 = __byte_perm(q[0], q[1], 0x5140);   // bytes 0, 1
    const uint32_t lo23 = __byte_perm(q[2], q[3], 0x5140);
    const uint32_t hi01 = __byte_perm(q[0], q[1], 0x7362);   // bytes 2, 3
    const uint32_t hi23 = __byte_perm(q[2], q[3], 0x7362);
    col[0][h] = __byte_perm(lo01, lo23, 0x5410);
    col[1][h] = __byte_perm(lo01, lo23, 0x7632);
    col[2][h] = __byte_perm(hi01, hi23, 0x5410);
    col[3][h] = __byte_perm(hi01, hi23, 0x7632);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<uint2*>(bt + bt_row(4 * c + j) * kBK + 8 * kq) =
        make_uint2(col[j][0], col[j][1]);
}

// acc += one k-step's products: 2 k32 products for each of the warp's
// kMT x kNT fragment tiles, its first row r0 and column c0.
__device__ __forceinline__ void product(int (&acc)[kMT][kNT][4],
                                        const unsigned char* as,
                                        const unsigned char* bt, int r0,
                                        int c0, int g, int t) {
  uint4 b[kNT];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
    b[nt] = *reinterpret_cast<const uint4*>(
        bt + bt_row(c0 + 8 * nt + g) * kBK + 16 * t);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const unsigned char* blk = as + (r0 / 16 + mt) * 1024 + (g * 4 + t) * 16;
    const uint4 lo = *reinterpret_cast<const uint4*>(blk);
    const uint4 hi = *reinterpret_cast<const uint4*>(blk + 512);
    const uint32_t a0[4] = {lo.x, lo.y, lo.z, lo.w};
    const uint32_t a1[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const uint32_t b0[2] = {b[nt].x, b[nt].y};
      s8::mma_m16n8k32(acc[mt][nt], a0, b0);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const uint32_t b1[2] = {b[nt].z, b[nt].w};
      s8::mma_m16n8k32(acc[mt][nt], a1, b1);
    }
  }
}

template <int kVec>
__global__ void __launch_bounds__(kThreads, 2)
qmm_product_kernel(const signed char* __restrict__ xq,
                   const signed char* __restrict__ w,
                   const float* __restrict__ w_scale,
                   const float* __restrict__ x_scale, float* __restrict__ out,
                   int* __restrict__ sums, int M, int K, int N, int Kp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = (warp % kWarpsM) * kMT * 16;   // the warp's first row
  const int c0 = (warp / kWarpsM) * kNT * 8;    // ... and column
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int splits = gridDim.z, z = blockIdx.z;
  const int steps = Kp / kBK;
  const int first = (int)((long long)steps * z / splits);
  const int count = (int)((long long)steps * (z + 1) / splits) - first;
  unsigned char* bt = smem + kStages * kSlot;
  auto slot = [&](int i) { return smem + (i % kStages) * kSlot; };

  // This thread's share of each k-step's copies, fixed for the block: kA
  // 16-byte chunks of the codes' 8 KB block (in xq's order), and kW pieces
  // of w_q's (64, 128) tile, kRows rows apart (past K and N zero-filled).
  constexpr int kA = kBM * kBK / 16 / kThreads;
  constexpr int kPieces = kBN / kVec, kRows = kThreads / kPieces;
  constexpr int kW = kBK / kRows;
  const int w_row = tid / kPieces, w_col = kVec * (tid % kPieces);
  const bool w_in = n0 + w_col < N;
  const signed char* a_src =
      xq + ((size_t)blockIdx.x * steps + first) * (kBM * kBK) + 16 * tid;
  const signed char* w_src =
      w + ((size_t)first * kBK + w_row) * N + n0 + w_col;
  auto load = [&](int i) {
    if (i < count) {
      unsigned char* as = slot(i);
      unsigned char* raw = as + kBM * kBK;
#pragma unroll
      for (int j = 0; j < kA; ++j)
        cp_async16(as + 16 * (tid + j * kThreads),
                   a_src + (size_t)i * (kBM * kBK) + 16 * j * kThreads, true);
      const int k0 = (first + i) * kBK;
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        const int r = w_row + j * kRows;
        const bool in = w_in && k0 + r < K;
        copy_w<kVec>(raw + raw_offset(r, w_col),
                     in ? w_src + ((size_t)i * kBK + j * kRows) * N : w, in);
      }
    }
    cp_async_commit();
  };

  int acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  for (int i = 0; i < kStages - 1; ++i) load(i);
  cp_async_wait<kStages - 2>();   // step 0 landed
  __syncthreads();
  if (count > 0) transpose(bt, slot(0) + kBM * kBK);
  for (int i = 0; i < count; ++i) {
    cp_async_wait<kStages - 3>();   // step i + 1 landed
    __syncthreads();   // ... for every thread; step i - 1 is done with
    load(i + kStages - 1);   // into step i - 1's slot
    if (i + 1 < count)
      transpose(bt + ((i + 1) & 1) * kBt, slot(i + 1) + kBM * kBK);
    product(acc, slot(i), bt + (i & 1) * kBt, r0, c0, g, t);
  }

  if (splits > 1) {
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

  const float xs = __ldg(x_scale);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + r0 + 16 * mt + g + 8 * (e >> 1);
        const int n = n0 + c0 + 8 * nt + 2 * t + (e & 1);
        if (m < M && n < N)
          out[(size_t)m * N + n] = __fmul_rn(
              __fmul_rn((float)acc[mt][nt][e], xs), __ldg(w_scale + n));
      }
}

size_t round_up(size_t v, size_t to) { return (v + to - 1) / to * to; }

// The split launch's sums, scaled: y = (float)sum * x_scale * w_scale[n].
__global__ void __launch_bounds__(kQuantThreads)
qmm_epilogue_kernel(const int* __restrict__ sums,
                    const float* __restrict__ w_scale,
                    const float* __restrict__ x_scale, float* __restrict__ out,
                    int M, int N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < (long long)M * N)
    out[i] = __fmul_rn(__fmul_rn((float)sums[i], __ldg(x_scale)),
                       __ldg(w_scale + i % N));
}

// The scratch: the codes (M and K rounded up to the tile and the k-step)
// at 0, then, for a split launch, the (M, N) int32 sums.
size_t codes_bytes(int M, int K) { return round_up(M, kBM) * round_up(K, kBK); }
size_t scratch_bytes(int M, int K, int N, int splits) {
  return codes_bytes(M, K) + (splits > 1 ? (size_t)M * N * 4 : 0);
}

template <int kVec>
int launch_product(const signed char* xq, const signed char* w_q,
                   const float* w_scale, const float* x_scale, float* out,
                   int* sums, int M, int K, int N, int Kp, int splits,
                   cudaStream_t s) {
  // The product's shared memory is above the 48 KB default: allowed once
  // a device (the attribute belongs to the device's copy of the kernel),
  // not at every launch (~1-4 us of host time a call on an H100 machine,
  // where the head's whole call is ~20 us of device time).
  static std::atomic<unsigned long long> allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(allowed.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(qmm_product_kernel<kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed.fetch_or(bit, std::memory_order_relaxed);
  }
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, splits);
  qmm_product_kernel<kVec><<<grid, kThreads, kSmem, s>>>(
      xq, w_q, w_scale, x_scale, out, sums, M, K, N, Kp);
  if (splits == 1) return static_cast<int>(cudaGetLastError());
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = (long long)M * N;
  qmm_epilogue_kernel<<<(unsigned)((n + kQuantThreads - 1) / kQuantThreads),
                        kQuantThreads, 0, s>>>(sums, w_scale, x_scale, out, M,
                                               N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The widest copy of w_q's rows, in bytes, that its address and row
// stride N allow: 16, 8, 4 or 1.
int quant_matmul_copy_width(const void* w_q, int N) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(w_q) | (uintptr_t)N;
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 1;
}

// Bytes of device scratch one launch needs: the codes (M and K rounded up
// to the tile and the k-step) and, for splits > 1, the (M, N) int32 sums.
size_t quant_matmul_scratch_bytes(int M, int K, int N, int splits) {
  return scratch_bytes(M, K, N, splits);
}

// x (M, K) float32, w_q (K, N) int8, w_scale (N,) float32, x_scale one
// float32, out (M, N) float32, scratch of quant_matmul_scratch_bytes
// (256-byte aligned); all contiguous on the device.  `splits` (1 to 65535)
// ranges of k-steps run in parallel.
int quant_matmul_launch(const float* x, const signed char* w_q,
                        const float* w_scale, const float* x_scale, float* out,
                        void* scratch, int M, int K, int N, int splits,
                        void* stream) {
  if (M < 0 || K < 0 || N < 0 || splits < 1 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  signed char* xq = static_cast<signed char*>(scratch);
  int* sums = reinterpret_cast<int*>(xq + codes_bytes(M, K));
  const int Mp = (int)round_up(M, kBM), Kp = (int)round_up(K, kBK);
  const long long n_sums = splits > 1 ? (long long)M * N : 0;
  const long long chunks = (long long)Mp * Kp / 16;
  const long long threads = chunks > n_sums ? chunks : n_sums;
  if (threads > 0) {
    const bool vec4 = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    qmm_quantize_kernel<<<(unsigned)((threads + kQuantThreads - 1) /
                                     kQuantThreads),
                          kQuantThreads, 0, s>>>(x, x_scale, xq, sums, M, K,
                                                 Mp, Kp, n_sums, vec4);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  switch (quant_matmul_copy_width(w_q, N)) {
    case 16:
      return launch_product<16>(xq, w_q, w_scale, x_scale, out, sums, M, K, N,
                                Kp, splits, s);
    case 8:
      return launch_product<8>(xq, w_q, w_scale, x_scale, out, sums, M, K, N,
                               Kp, splits, s);
    case 4:
      return launch_product<4>(xq, w_q, w_scale, x_scale, out, sums, M, K, N,
                               Kp, splits, s);
    default:
      return launch_product<1>(xq, w_q, w_scale, x_scale, out, sums, M, K, N,
                               Kp, splits, s);
  }
}

const char* quant_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
