// Mamba2 SSD chunked scan (prefill) for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel of the JAX package,
// repro/kernels/ssd_scan.py::ssd_scan (body _kernel).  For each batch row b
// and head h, over chunks z of `chunk` tokens, with cs the within-chunk
// cumulative sum of dA = dt * A:
//
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j     (intra)
//         + exp(cs_i) C_i . H_{z-1}                                (inter)
//   H_z   = exp(cs_end) H_{z-1} + sum_i exp(cs_end - cs_i) dt_i x_i B_i^T
//
// with the (P, N) state H carried across chunks from zero; y leaves out the
// D skip (the caller adds it) and the final state is returned.
//
// What bounds it on an H100: the operations.  At mamba2-370m's shape (B = 2,
// T = 8192, H = 32, P = 64, N = 128, chunk 128) a call needs about 2.2e10
// operations (C.B^T once per (b, chunk), its lower triangle against dt x,
// C.H^T and the state update per (b, h, chunk)): ~0.13 ms as 3xTF32 on the
// tensor cores (three TF32 products at 495 TFLOP/s each), ~0.33 ms as
// float32 FMAs on the CUDA cores (67 TFLOP/s), against ~0.29 GB of inputs
// and outputs (~0.09 ms at 3.35 TB/s).
//
// Design.  The TPU kernel walks the chunks of one (b, h) in order with the
// state in VMEM scratch.  Here the chunks run in parallel, in five launches
// on the caller's stream:
//   0. cumsum: one thread per (b, chunk, h) sums dA in order (as the plain
//      version's cumsum does) into a (B, NC, H, chunk) scratch;
//   1. cb:     C.B^T per (b, chunk), shared by every head, lower tiles only;
//   2. state:  per (b, chunk, h) the chunk's own state contribution S_z;
//   3. scan:   per (b, h), walks the chunks, H_z = exp(cs_end) H_{z-1} +
//              S_z, overwriting S_z with the state before chunk z and
//              writing the final state;
//   4. out:    per (b, chunk, h) the intra and inter terms as one product
//              [L o CB | exp(cs) C] . [dt x ; H^T] of depth chunk + N.
// Launches 1, 2 and 4 are 64 x 64 output tiles (64 x 128 for the chunk
// states where N > 64) on the tensor cores at float32 accuracy (3xTF32
// mma.sync, mma_tf32x3.cuh): 4 warps in a 2 x 2 grid, operands in
// 32-deep tiles that cp.async double-buffers in shared memory
// as they lie in device memory (B, C, x, cb and state rows, 16 bytes a
// copy, or 4 where P, N or chunk is not a multiple of 4).  The factors
// (dt, the decays, exp(cs)) are applied to each fragment in registers
// before it is split.  Above the diagonal the decay is selected to 0,
// never multiplied by a mask: exp(cs_i - cs_j) there can be inf.  Tiles
// above the diagonal are skipped, in C.B^T and in the intra product.
// Launch 3 is bound by bytes (each chunk state read and written once):
// the gates exp(cs_end) of a (b, h) are computed once into shared memory,
// each thread carries 4 consecutive state elements as a float4, and the
// loads of 8 chunks are issued ahead of the carry chain.
//
// Plain C interface, loaded with ctypes; the caller allocates the outputs
// and the scratch, and the launch returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma_tf32x3.cuh"

namespace {

using tf32x3::mma3;
using tf32x3::split;

constexpr int kTile = 64;        // output tile rows (and C.B^T's columns)
constexpr int kDepth = 32;       // reduction depth of one staged tile
constexpr int kThreads = 128;    // 4 warps in a 2 x 2 grid
constexpr int kLdK = kDepth + 8; // row of a tile stored k-contiguous

// Floats of one staged operand of `rows` rows (m or n), stored s[r][k]
// (row kLdK) when KFast, else s[k][r] (row rows + 4).
template <int Rows>
constexpr int operand_floats() {
  return Rows * kLdK > kDepth * (Rows + 4) ? Rows * kLdK
                                           : kDepth * (Rows + 4);
}
constexpr int kMaxChunk = 1024;
constexpr int kScanThreads = 256;
constexpr int kScanAhead = 8;    // chunk states loaded ahead of the chain
constexpr int kGateSegment = 2048;

// Where an operand of the tile lies in device memory: element (r, k) (r its
// tile row m or n, k the reduction index) is at base[r * ld + k] when
// KFast, else at base[k * ld + r]; rows at or past r_end are 0.
struct Operand {
  const float* base;
  size_t ld;
  int r_end;
};

// Copy reduction indices [k0, k0 + kDepth) of the Rows rows of `op` into
// s (s[r][k] with row kLdK when KFast, else s[k][r] with row Rows + 4);
// zeros past k_end.
template <int Rows, bool KFast, bool Vec>
__device__ __forceinline__ void load_stage(float* s, const Operand& op,
                                           int k0, int k_end) {
  constexpr int kW = Vec ? 4 : 1;   // floats a copy
  constexpr int kPieces = Rows * kDepth / kW;
#pragma unroll
  for (int c = threadIdx.x; c < kPieces; c += kThreads) {
    int r, k;
    if (KFast) {
      r = c / (kDepth / kW);
      k = c % (kDepth / kW) * kW;
    } else {
      k = c / (Rows / kW);
      r = c % (Rows / kW) * kW;
    }
    const bool in = r < op.r_end && k0 + k < k_end;
    const float* src = in ? op.base + (KFast ? r * op.ld + k0 + k
                                             : (k0 + k) * op.ld + r)
                          : op.base;
    float* dst = s + (KFast ? r * kLdK + k : k * (Rows + 4) + r);
    if (Vec)
      tf32x3::cp_async16(dst, src, in);
    else
      tf32x3::cp_async4(dst, src, in);
  }
}

// Elements (r, k) and (r, k + 1) of a staged tile of Rows rows, k (even)
// relative to the stage: one float2 when k is contiguous (a half warp's
// reads then hit 32 banks), else two rows apart (Rows + 4 = 4 mod 32: a
// warp's reads hit 32 banks).
template <int Rows, bool KFast>
__device__ __forceinline__ float2 pair(const float* s, int r, int k) {
  if (KFast) return *reinterpret_cast<const float2*>(s + r * kLdK + k);
  return make_float2(s[k * (Rows + 4) + r], s[(k + 1) * (Rows + 4) + r]);
}

// The products' tiling: 4 warps in a 2 x 2 grid, each MT x NT fragments of
// m16n8, so a block computes a (32 MT) x (16 NT) tile.
template <int MT, int NT>
struct Tiling {
  static constexpr int kM = 32 * MT, kN = 16 * NT;
  static constexpr int kA = operand_floats<kM>();
  static constexpr int kB = operand_floats<kN>();
  static constexpr size_t kSmem = sizeof(float) * 2 * (kA + kB);
};

// acc += A B^T over k in [0, k_end), A(m, k) = fa(m, k, a) and B(n, k) =
// fb(n, k, b) for the staged values a and b (m, n tile-local, k absolute).
// Warp w owns rows (w / 2) 16 MT.. and columns (w % 2) 8 NT..: acc[mt][nt]
// is the m16n8 fragment at rows + 16 mt, columns + 8 nt.  smem holds two
// stages of the two operands.
template <int MT, int NT, bool AKFast, bool BKFast, bool Vec, class FA,
          class FB>
__device__ __forceinline__ void gemm(float* smem, float (&acc)[MT][NT][4],
                                     const Operand& a, const Operand& b,
                                     int k_end, FA fa, FB fb) {
  using Tl = Tiling<MT, NT>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 2 * 16 * MT, wn = warp % 2 * 8 * NT;
  const int n_stages = (k_end + kDepth - 1) / kDepth;
  auto load = [&](int st) {
    float* s = smem + (st & 1) * (Tl::kA + Tl::kB);
    load_stage<Tl::kM, AKFast, Vec>(s, a, st * kDepth, k_end);
    load_stage<Tl::kN, BKFast, Vec>(s + Tl::kA, b, st * kDepth, k_end);
  };
  load(0);
  tf32x3::cp_async_commit();
  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages) load(st + 1);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<1>();
    __syncthreads();
    const float* sa = smem + (st & 1) * (Tl::kA + Tl::kB);
    const float* sb = sa + Tl::kA;
#pragma unroll
    for (int ks = 0; ks < kDepth / 8; ++ks) {
      // the fragment's k = t, t + 4 are the stage's 8 ks + 2t, 8 ks + 2t + 1
      const int kl = 8 * ks + 2 * t;
      const int k = st * kDepth + kl;
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = wn + 8 * nt + g;
        const float2 r = pair<Tl::kN, BKFast>(sb, n, kl);
        // b0 (k, g), b1 (k + 1, g)
        const float v[2] = {k < k_end ? fb(n, k, r.x) : 0.0f,
                            k + 1 < k_end ? fb(n, k + 1, r.y) : 0.0f};
        split(v, bh[nt], bl[nt]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = wm + 16 * mt + g;
        const float2 r0 = pair<Tl::kM, AKFast>(sa, m, kl);
        const float2 r1 = pair<Tl::kM, AKFast>(sa, m + 8, kl);
        // a0 (g, k), a1 (g + 8, k), a2 (g, k + 1), a3 (g + 8, k + 1)
        const float v[4] = {
            k < k_end ? fa(m, k, r0.x) : 0.0f,
            k < k_end ? fa(m + 8, k, r1.x) : 0.0f,
            k + 1 < k_end ? fa(m, k + 1, r0.y) : 0.0f,
            k + 1 < k_end ? fa(m + 8, k + 1, r1.y) : 0.0f};
        uint32_t ah[4], al[4];
        split(v, ah, al);
        mma3(acc[mt], ah, al, bh, bl);
      }
    }
    __syncthreads();   // this stage is free for stage st + 2
  }
}

// out(m0 + m, n0 + n) = acc for the fragments' (m, n) inside (rows, cols).
template <int MT, int NT, class F>
__device__ __forceinline__ void store(const float (&acc)[MT][NT][4], int m0,
                                      int n0, int rows, int cols, F out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + warp / 2 * 16 * MT + 16 * mt + g + (e >> 1) * 8;
        const int n = n0 + warp % 2 * 8 * NT + 8 * nt + 2 * t + (e & 1);
        if (m < rows && n < cols) out(m, n) = acc[mt][nt][e];
      }
}

// 64 x 64 tiles for C.B^T and the output; the chunk states take 64 x 128
// tiles where N > 64 (each split B fragment then feeds twice the products:
// 0.257 -> 0.221 ms at mamba2-370m's N 128, but 0.32 -> 0.46 ms at
// zamba2-2.7b's N 64, half of whose tile would be empty).
using CbTiling = Tiling<2, 4>;
using OutTiling = Tiling<2, 4>;

// The factor arrays' length: whole 64-row tiles, so that no row of a tile
// reads past them.
__host__ __device__ __forceinline__ int padded_chunk(int chunk) {
  return (chunk + kTile - 1) / kTile * kTile;
}

// 0. cs[b, z, h, i] = sum_{k <= i} dt[b, z chunk + k, h] * A[h], in order.
__global__ void ssd_cumsum_kernel(const float* __restrict__ dt,
                                  const float* __restrict__ A,
                                  float* __restrict__ cs, long long rows,
                                  int H, int chunk) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows) return;                  // idx = (b nc + z) H + h
  const int h = idx % H;
  const long long bz = idx / H;
  const float a = A[h];
  const float* d = dt + bz * chunk * H + h;
  float* out = cs + idx * chunk;
  float s = 0.0f;
  for (int i = 0; i < chunk; ++i) {
    s = __fadd_rn(s, __fmul_rn(d[(size_t)i * H], a));
    out[i] = s;
  }
}

// 1. cb[b, z, i, j] = C_i . B_j over one chunk, for the tiles with j-tile
//    <= i-tile (the rest is never read).
template <bool Vec>
__global__ void __launch_bounds__(kThreads)
ssd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
              float* __restrict__ cb, int N, int chunk) {
  const int tiles = (chunk + kTile - 1) / kTile;
  const int ti = blockIdx.y / tiles, tj = blockIdx.y % tiles;
  if (tj > ti) return;
  extern __shared__ __align__(16) float smem[];
  const long long bz = blockIdx.x;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const Operand c_op{Cm + (bz * chunk + i0) * N, (size_t)N, chunk - i0};
  const Operand b_op{Bm + (bz * chunk + j0) * N, (size_t)N, chunk - j0};
  float acc[2][4][4] = {};
  auto plain = [](int, int, float v) { return v; };
  gemm<2, 4, true, true, Vec>(smem, acc, c_op, b_op, N, plain, plain);
  float* out = cb + bz * chunk * chunk;
  store(acc, i0, j0, chunk, chunk,
        [=](int i, int j) -> float& { return out[(size_t)i * chunk + j]; });
}

// dt_j of one (b, chunk, h) into s_dt[0, chunk).
__device__ __forceinline__ void stage_dt(float* s_dt, const float* dt_rows,
                                         int H, int chunk) {
  for (int i = threadIdx.x; i < chunk; i += kThreads)
    s_dt[i] = dt_rows[(size_t)i * H];
}

// 2. states[b, z, h, p, n] = sum_i exp(cs_end - cs_i) (x_i[p] dt_i) B_i[n].
template <bool Vec, int NT>
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ Bm, const float* __restrict__ cs,
                 float* __restrict__ states, int H, int P, int N, int chunk) {
  using StateTiling = Tiling<2, NT>;
  constexpr int TM = StateTiling::kM, TN = StateTiling::kN;
  const int tiles_n = (N + TN - 1) / TN;
  const int p0 = blockIdx.y / tiles_n * TM;
  const int n0 = blockIdx.y % tiles_n * TN;
  const long long bzh = blockIdx.x;        // (b nc + z) H + h
  const int h = bzh % H;
  const long long bz = bzh / H;
  extern __shared__ __align__(16) float smem[];
  float* s_dt = smem + StateTiling::kSmem / sizeof(float);
  float* s_dec = s_dt + padded_chunk(chunk);
  const float* cs_row = cs + bzh * chunk;
  const float cs_end = cs_row[chunk - 1];
  stage_dt(s_dt, dt + bz * chunk * H + h, H, chunk);
  for (int i = threadIdx.x; i < chunk; i += kThreads)
    s_dec[i] = expf(__fsub_rn(cs_end, cs_row[i]));
  __syncthreads();
  const Operand x_op{x + bz * chunk * H * P + (size_t)h * P + p0,
                     (size_t)H * P, P - p0};
  const Operand b_op{Bm + bz * chunk * N + n0, (size_t)N, N - n0};
  float acc[2][NT][4] = {};
  gemm<2, NT, false, false, Vec>(
      smem, acc, x_op, b_op, chunk,
      [=](int, int i, float v) {
        return __fmul_rn(__fmul_rn(v, s_dt[i]), s_dec[i]);
      },
      [](int, int, float v) { return v; });
  float* out = states + bzh * P * N;
  store(acc, p0, n0, P, N,
        [=](int p, int n) -> float& { return out[(size_t)p * N + n]; });
}

// 3. Per (b, h): walk the chunks in order, replacing S_z by the state
//    before chunk z; write the final state.  Thread e of the (b, h) carries
//    elements [W e, W e + W) of the P N state.
template <int W>
__global__ void __launch_bounds__(kScanThreads)
ssd_scan_states_kernel(const float* __restrict__ cs,
                       float* __restrict__ states,
                       float* __restrict__ final_state, int H, int PN,
                       int nc, int chunk) {
  using Vec = typename std::conditional<W == 4, float4, float>::type;
  __shared__ float s_gate[kGateSegment];
  const int e = blockIdx.y * kScanThreads + threadIdx.x;
  const bool active = e * W < PN;
  const long long bh = blockIdx.x;         // b H + h
  const int h = bh % H;
  const long long b = bh / H;
  const size_t z_stride = (size_t)H * PN;
  float* s = states + (b * nc * H + h) * (size_t)PN + (size_t)e * W;
  float carry[W] = {};
  for (int seg = 0; seg < nc; seg += kGateSegment) {
    const int seg_end = min(nc, seg + kGateSegment);
    __syncthreads();   // the previous segment's gates are read
    for (int z = seg + threadIdx.x; z < seg_end; z += kScanThreads)
      s_gate[z - seg] = expf(cs[((b * nc + z) * H + h) * chunk + chunk - 1]);
    __syncthreads();
    if (!active) continue;
    for (int z0 = seg; z0 < seg_end; z0 += kScanAhead) {
      Vec buf[kScanAhead];
#pragma unroll
      for (int u = 0; u < kScanAhead; ++u)
        if (z0 + u < seg_end)
          buf[u] = *reinterpret_cast<const Vec*>(s + (z0 + u) * z_stride);
#pragma unroll
      for (int u = 0; u < kScanAhead; ++u) {
        if (z0 + u >= seg_end) break;
        const float gate = s_gate[z0 + u - seg];
        const float* in = reinterpret_cast<const float*>(&buf[u]);
        Vec before;
        float* out = reinterpret_cast<float*>(&before);
#pragma unroll
        for (int w = 0; w < W; ++w) {
          out[w] = carry[w];
          carry[w] = __fadd_rn(__fmul_rn(carry[w], gate), in[w]);
        }
        *reinterpret_cast<Vec*>(s + (z0 + u) * z_stride) = before;
      }
    }
  }
  if (active)
#pragma unroll
    for (int w = 0; w < W; ++w)
      final_state[bh * PN + (size_t)e * W + w] = carry[w];
}

// 4. y[b, z chunk + i, h, p] = sum_{j <= i} cb[i, j] exp(cs_i - cs_j)
//    (x_j[p] dt_j) + sum_n exp(cs_i) C_i[n] H_{z-1}[p, n].
template <bool Vec>
__global__ void __launch_bounds__(kThreads)
ssd_out_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ Cm, const float* __restrict__ cb,
               const float* __restrict__ cs,
               const float* __restrict__ states, float* __restrict__ y,
               int H, int P, int N, int chunk) {
  const int tiles_p = (P + kTile - 1) / kTile;
  const int i0 = blockIdx.y / tiles_p * kTile;
  const int p0 = blockIdx.y % tiles_p * kTile;
  const long long bzh = blockIdx.x;        // (b nc + z) H + h
  const int h = bzh % H;
  const long long bz = bzh / H;
  extern __shared__ __align__(16) float smem[];
  const int padded = padded_chunk(chunk);
  float* s_dt = smem + OutTiling::kSmem / sizeof(float);
  float* s_cs = s_dt + padded;
  float* s_exp = s_cs + padded;
  const float* cs_row = cs + bzh * chunk;
  stage_dt(s_dt, dt + bz * chunk * H + h, H, chunk);
  for (int i = threadIdx.x; i < padded; i += kThreads) {
    s_cs[i] = i < chunk ? cs_row[i] : 0.0f;
    s_exp[i] = i < chunk ? expf(cs_row[i]) : 0.0f;
  }
  __syncthreads();
  float acc[2][4][4] = {};
  // intra: keys j up to this tile's last row; above the diagonal select 0
  // (the tile's rows past the chunk read the factors' zero padding; they
  // are not stored)
  const Operand cb_op{cb + (bz * chunk + i0) * chunk, (size_t)chunk,
                      chunk - i0};
  const Operand x_op{x + bz * chunk * H * P + (size_t)h * P + p0,
                     (size_t)H * P, P - p0};
  gemm<2, 4, true, false, Vec>(
      smem, acc, cb_op, x_op, min(chunk, i0 + kTile),
      [=](int m, int j, float v) {
        const int i = i0 + m;
        return j <= i ? __fmul_rn(v, expf(__fsub_rn(s_cs[i], s_cs[j])))
                      : 0.0f;
      },
      [=](int, int j, float v) { return __fmul_rn(v, s_dt[j]); });
  // inter: the state carried into this chunk
  const Operand c_op{Cm + (bz * chunk + i0) * N, (size_t)N, chunk - i0};
  const Operand h_op{states + bzh * P * N + (size_t)p0 * N, (size_t)N,
                     P - p0};
  gemm<2, 4, true, true, Vec>(
      smem, acc, c_op, h_op, N,
      [=](int m, int, float v) { return __fmul_rn(v, s_exp[i0 + m]); },
      [](int, int, float v) { return v; });
  float* out = y + bz * chunk * H * P + (size_t)h * P;
  store(acc, i0, p0, chunk, P, [=](int i, int p) -> float& {
    return out[(size_t)i * H * P + p];
  });
}

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool Vec>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, float* y, float* final_state, float* cs,
           float* cb, float* states, int B, int T, int H, int P, int N,
           int chunk, cudaStream_t s) {
  const int nc = T / chunk;
  const long long bzh = (long long)B * nc * H;
  const int tiles_c = (chunk + kTile - 1) / kTile;
  const int tiles_p = (P + kTile - 1) / kTile;
  const bool wide = N > 64;   // 64 x 128 state tiles
  auto state_kernel =
      wide ? ssd_state_kernel<Vec, 8> : ssd_state_kernel<Vec, 4>;
  const int state_n = wide ? 128 : 64;
  const int tiles_s = tiles_p * ((N + state_n - 1) / state_n);
  const size_t factors = sizeof(float) * padded_chunk(chunk);
  const size_t smem_state =
      (wide ? Tiling<2, 8>::kSmem : Tiling<2, 4>::kSmem) + 2 * factors;
  const size_t smem_out = OutTiling::kSmem + 3 * factors;
  cudaError_t err;
  if ((err = allow_smem(ssd_cb_kernel<Vec>, CbTiling::kSmem)) !=
          cudaSuccess ||
      (err = allow_smem(state_kernel, smem_state)) != cudaSuccess ||
      (err = allow_smem(ssd_out_kernel<Vec>, smem_out)) != cudaSuccess)
    return err;
  if (nc > 0) {
    ssd_cumsum_kernel<<<(unsigned)((bzh + 127) / 128), 128, 0, s>>>(
        dt, A, cs, bzh, H, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ssd_cb_kernel<Vec><<<dim3((unsigned)((long long)B * nc),
                              tiles_c * tiles_c),
                         kThreads, CbTiling::kSmem, s>>>(Bm, Cm, cb, N,
                                                         chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    state_kernel<<<dim3((unsigned)bzh, tiles_s), kThreads, smem_state, s>>>(
        x, dt, Bm, cs, states, H, P, N, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int pn = P * N;
  if (pn % 4 == 0 && aligned16(states))
    ssd_scan_states_kernel<4><<<dim3((unsigned)(B * H),
                                     (pn / 4 + kScanThreads - 1) /
                                         kScanThreads),
                                kScanThreads, 0, s>>>(cs, states, final_state,
                                                      H, pn, nc, chunk);
  else
    ssd_scan_states_kernel<1><<<dim3((unsigned)(B * H),
                                     (pn + kScanThreads - 1) / kScanThreads),
                                kScanThreads, 0, s>>>(cs, states, final_state,
                                                      H, pn, nc, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (nc > 0) {
    ssd_out_kernel<Vec><<<dim3((unsigned)bzh, tiles_c * tiles_p), kThreads,
                          smem_out, s>>>(x, dt, Cm, cb, cs, states, y, H, P,
                                         N, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// x, y (B, T, H, P); dt (B, T, H); A (H,); Bm, Cm (B, T, N); final_state
// (B, H, P, N); scratch cs (B, T/chunk, H, chunk), cb (B, T/chunk, chunk,
// chunk), states (B, T/chunk, H, P, N).  All contiguous float32 on the
// device; T a multiple of chunk, 1 <= chunk <= kMaxChunk.
int ssd_scan_launch(const float* x, const float* dt, const float* A,
                    const float* Bm, const float* Cm, float* y,
                    float* final_state, float* cs, float* cb, float* states,
                    int B, int T, int H, int P, int N, int chunk,
                    void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || T % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || P <= 0 || N <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies need every operand row to start on 16 bytes
  const bool vec = P % 4 == 0 && N % 4 == 0 && chunk % 4 == 0 &&
                   aligned16(x) && aligned16(Bm) && aligned16(Cm) &&
                   aligned16(cb) && aligned16(states);
  return vec ? launch<true>(x, dt, A, Bm, Cm, y, final_state, cs, cb, states,
                            B, T, H, P, N, chunk, s)
             : launch<false>(x, dt, A, Bm, Cm, y, final_state, cs, cb,
                             states, B, T, H, P, N, chunk, s);
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
