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
// float32 operations (C.B^T once per (b, chunk), its lower triangle against
// dt x, C.H^T and the state update per (b, h, chunk)), ~0.33 ms at the 67
// TFLOP/s float32 rate outside the tensor cores, against ~0.29 GB of inputs
// and outputs (~0.09 ms at 3.35 TB/s).
//
// Design (a plain CUDA-core first version; no TF32, no wgmma).  The TPU
// kernel walks the chunks of one (b, h) in order with the state in VMEM
// scratch.  Here the chunks run in parallel, in five launches on the
// caller's stream:
//   0. cumsum: one thread per (b, chunk, h) sums dA in order (as the plain
//      version's cumsum does) into a (B, NC, H, chunk) scratch;
//   1. cb:     C.B^T per (b, chunk), shared by every head, lower tiles only;
//   2. state:  per (b, chunk, h) the chunk's own state contribution S_z;
//   3. scan:   per (b, h), one thread per state element walks the chunks,
//              H_z = exp(cs_end) H_{z-1} + S_z, overwriting S_z with the
//              state before chunk z and writing the final state;
//   4. out:    per (b, chunk, h) the intra and inter terms as one product
//              [L o CB | exp(cs) C] . [dt x ; H^T] of depth chunk + N.
// Launches 1, 2 and 4 are 64 x 64 output tiles computed by 256 threads (4 x
// 4 outputs each) from 16-deep operand tiles staged in shared memory, so
// shared memory stays at ~17 KB a block whatever P, N and chunk are (no
// whole-chunk B, C and score tiles, which would not fit beside the state).
// Above the diagonal the decay is selected to 0, never multiplied by a
// mask: exp(cs_i - cs_j) there can be inf.  Tiles above the diagonal are
// skipped, in C.B^T and in the intra product.
//
// Plain C interface, loaded with ctypes; the caller allocates the outputs
// and the scratch, and the launch returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;       // output tile rows and columns
constexpr int kDepth = 16;      // reduction depth of one staged tile
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLds = kTile + 4; // padded row of a staged tile
constexpr int kMaxChunk = 1024;

struct Tiles {
  float a[kDepth][kLds];   // a[k][m]: the left operand, transposed
  float b[kDepth][kLds];   // b[k][n]: the right operand
};

// Stage one kDepth x kTile operand tile: s[k][m] = f(k0 + k, m), zero past
// k_end.  KFast: consecutive threads take consecutive k (the source is
// contiguous along k), else consecutive m.
template <bool KFast, class F>
__device__ __forceinline__ void stage(float (*s)[kLds], int k0, int k_end,
                                      F f) {
#pragma unroll
  for (int r = 0; r < kDepth * kTile / kThreads; ++r) {
    const int e = threadIdx.x + r * kThreads;
    const int k = KFast ? e % kDepth : e / kTile;
    const int m = KFast ? e / kDepth : e % kTile;
    s[k][m] = k0 + k < k_end ? f(k0 + k, m) : 0.0f;
  }
}

// acc[r][q] += sum_k A(k, 4 ty + r) B(k, 4 tx + q) over k in [0, k_end),
// A(k, m) = fa(k, m) and B(k, n) = fb(k, n) with tile-local m and n.
template <bool AKFast, bool BKFast, class FA, class FB>
__device__ __forceinline__ void gemm(Tiles& t, float (&acc)[4][4], int k_end,
                                     FA fa, FB fb) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int k0 = 0; k0 < k_end; k0 += kDepth) {
    stage<AKFast>(t.a, k0, k_end, fa);
    stage<BKFast>(t.b, k0, k_end, fb);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&t.a[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&t.b[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
    __syncthreads();
  }
}

// out(m0 + 4 ty + r, n0 + 4 tx + q) = acc[r][q] inside (rows, cols).
template <class F>
__device__ __forceinline__ void store(const float (&acc)[4][4], int m0,
                                      int n0, int rows, int cols, F out) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + ty * 4 + r;
    if (m >= rows) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx * 4 + q;
      if (n < cols) out(m, n) = acc[r][q];
    }
  }
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
__global__ void __launch_bounds__(kThreads)
ssd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
              float* __restrict__ cb, int N, int chunk) {
  const int tiles = (chunk + kTile - 1) / kTile;
  const int ti = blockIdx.y / tiles, tj = blockIdx.y % tiles;
  if (tj > ti) return;
  const long long bz = blockIdx.x;
  const float* c_rows = Cm + bz * chunk * N;
  const float* b_rows = Bm + bz * chunk * N;
  const int i0 = ti * kTile, j0 = tj * kTile;
  __shared__ __align__(16) Tiles t;
  float acc[4][4] = {};
  gemm<true, true>(
      t, acc, N,
      [=](int k, int m) {
        const int i = i0 + m;
        return i < chunk ? c_rows[(size_t)i * N + k] : 0.0f;
      },
      [=](int k, int m) {
        const int j = j0 + m;
        return j < chunk ? b_rows[(size_t)j * N + k] : 0.0f;
      });
  float* out = cb + bz * chunk * chunk;
  store(acc, i0, j0, chunk, chunk,
        [=](int i, int j) -> float& { return out[(size_t)i * chunk + j]; });
}

// 2. states[b, z, h, p, n] = sum_i exp(cs_end - cs_i) (x_i[p] dt_i) B_i[n].
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ Bm, const float* __restrict__ cs,
                 float* __restrict__ states, int H, int P, int N, int chunk) {
  const int tiles_n = (N + kTile - 1) / kTile;
  const int p0 = blockIdx.y / tiles_n * kTile;
  const int n0 = blockIdx.y % tiles_n * kTile;
  const long long bzh = blockIdx.x;        // (b nc + z) H + h
  const int h = bzh % H;
  const long long bz = bzh / H;
  __shared__ float s_dec[kMaxChunk];
  __shared__ __align__(16) Tiles t;
  const float* cs_row = cs + bzh * chunk;
  const float cs_end = cs_row[chunk - 1];
  for (int i = threadIdx.x; i < chunk; i += kThreads)
    s_dec[i] = expf(__fsub_rn(cs_end, cs_row[i]));
  __syncthreads();
  const float* dec = s_dec;
  const float* x_rows = x + bz * chunk * H * P + (size_t)h * P;
  const float* dt_rows = dt + bz * chunk * H + h;
  const float* b_rows = Bm + bz * chunk * N;
  float acc[4][4] = {};
  gemm<false, false>(
      t, acc, chunk,
      [=](int i, int m) {
        const int p = p0 + m;
        if (p >= P) return 0.0f;
        const float xdt = __fmul_rn(x_rows[(size_t)i * H * P + p],
                                    dt_rows[(size_t)i * H]);
        return __fmul_rn(xdt, dec[i]);
      },
      [=](int i, int m) {
        const int n = n0 + m;
        return n < N ? b_rows[(size_t)i * N + n] : 0.0f;
      });
  float* out = states + bzh * P * N;
  store(acc, p0, n0, P, N,
        [=](int p, int n) -> float& { return out[(size_t)p * N + n]; });
}

// 3. Per (b, h) and state element: walk the chunks in order, replacing
//    S_z by the state before chunk z; write the final state.
__global__ void ssd_scan_states_kernel(const float* __restrict__ cs,
                                       float* __restrict__ states,
                                       float* __restrict__ final_state,
                                       int H, int PN, int nc, int chunk) {
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= PN) return;
  const long long bh = blockIdx.x;         // b H + h
  const int h = bh % H;
  const long long b = bh / H;
  float carry = 0.0f;
  for (int z = 0; z < nc; ++z) {
    const long long bzh = (b * nc + z) * H + h;
    const float g = expf(cs[bzh * chunk + chunk - 1]);
    float* s = states + bzh * PN + e;
    const float s_z = *s;
    *s = carry;
    carry = __fadd_rn(__fmul_rn(carry, g), s_z);
  }
  final_state[bh * PN + e] = carry;
}

// 4. y[b, z chunk + i, h, p] = sum_{j <= i} cb[i, j] exp(cs_i - cs_j)
//    (x_j[p] dt_j) + sum_n exp(cs_i) C_i[n] H_{z-1}[p, n].
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
  __shared__ float s_cs[kMaxChunk];
  __shared__ float s_exp[kMaxChunk];
  __shared__ __align__(16) Tiles t;
  const float* cs_row = cs + bzh * chunk;
  for (int i = threadIdx.x; i < chunk; i += kThreads) {
    s_cs[i] = cs_row[i];
    s_exp[i] = expf(cs_row[i]);
  }
  __syncthreads();
  const float* scs = s_cs;
  const float* sexp = s_exp;
  const float* cb_rows = cb + bz * chunk * chunk;
  const float* x_rows = x + bz * chunk * H * P + (size_t)h * P;
  const float* dt_rows = dt + bz * chunk * H + h;
  const float* c_rows = Cm + bz * chunk * N;
  const float* h_prev = states + bzh * P * N;
  float acc[4][4] = {};
  // intra: keys j up to this tile's last row; above the diagonal select 0
  gemm<true, false>(
      t, acc, min(chunk, i0 + kTile),
      [=](int j, int m) {
        const int i = i0 + m;
        if (i >= chunk || j > i) return 0.0f;
        return __fmul_rn(cb_rows[(size_t)i * chunk + j],
                         expf(__fsub_rn(scs[i], scs[j])));
      },
      [=](int j, int m) {
        const int p = p0 + m;
        if (p >= P) return 0.0f;
        return __fmul_rn(x_rows[(size_t)j * H * P + p],
                         dt_rows[(size_t)j * H]);
      });
  // inter: the state carried into this chunk
  gemm<true, true>(
      t, acc, N,
      [=](int n, int m) {
        const int i = i0 + m;
        return i < chunk ? __fmul_rn(c_rows[(size_t)i * N + n], sexp[i])
                         : 0.0f;
      },
      [=](int n, int m) {
        const int p = p0 + m;
        return p < P ? h_prev[(size_t)p * N + n] : 0.0f;
      });
  float* out = y + bz * chunk * H * P + (size_t)h * P;
  store(acc, i0, p0, chunk, P, [=](int i, int p) -> float& {
    return out[(size_t)i * H * P + p];
  });
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
  const int nc = T / chunk;
  const long long bzh = (long long)B * nc * H;
  const int tiles_c = (chunk + kTile - 1) / kTile;
  const int tiles_p = (P + kTile - 1) / kTile;
  const int tiles_n = (N + kTile - 1) / kTile;
  cudaError_t err;
  if (nc > 0) {
    ssd_cumsum_kernel<<<(unsigned)((bzh + 127) / 128), 128, 0, s>>>(
        dt, A, cs, bzh, H, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ssd_cb_kernel<<<dim3((unsigned)((long long)B * nc), tiles_c * tiles_c),
                    kThreads, 0, s>>>(Bm, Cm, cb, N, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ssd_state_kernel<<<dim3((unsigned)bzh, tiles_p * tiles_n), kThreads, 0,
                       s>>>(x, dt, Bm, cs, states, H, P, N, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int pn = P * N;
  ssd_scan_states_kernel<<<dim3((unsigned)(B * H), (pn + 255) / 256), 256, 0,
                           s>>>(cs, states, final_state, H, pn, nc, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (nc > 0) {
    ssd_out_kernel<<<dim3((unsigned)bzh, tiles_c * tiles_p), kThreads, 0,
                     s>>>(x, dt, Cm, cb, cs, states, y, H, P, N, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
