// Constrained Pareto-domination kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package,
// repro/kernels/pareto_rank.py:
//   * packed_domination_kernel  <- packed_domination / _packed_kernel
//   * domination_counts_kernel  <- domination_counts / _counts_kernel
//
// Both evaluate Deb constrained domination of a dominator row p over a
// column q, with exactly the tie rules of the plain version
// (repro_torch/kernels/ref.py::dominates_tile):
//   dom = (fp & !fq) | (!fp & !fq & cv_p < cv_q) | (fp & fq & all_le & any_lt)
// with fp = cv_p <= 0 and fq = cv_q <= 0.  A NaN compares false everywhere,
// and a +inf violation (row padding) dominates nothing.
//
// The test is branch-free.  The feasibility bits are folded into each point
// once, where it is loaded (load_point), not once per pair:
//   * an infeasible point's first objective becomes NaN, so all_le is false
//     for every pair with an infeasible side;
//   * its key is -inf when it is feasible, else its violation; a column whose
//     violation is NaN (infeasible, dominated by the feasible rows alone)
//     takes -FLT_MAX.
// Then dom = (all_le & any_lt) | (key_p < key_q): 2m + 1 float compares that
// chain into one predicate, which feeds the warp vote.  Objectives are padded
// with zeros to M (3, the search's latency / energy / throughput, or 8),
// which changes neither all_le nor any_lt.
//
// What bounds them on an H100: the instructions each pair costs.  At the
// search's shapes packed_domination does 1.07e9 pair tests (n = 32768, m = 3)
// against 128 MiB of packed output, domination_counts 2.7e8 (n = 16384)
// against 64 KiB.  The design, one warp per 32 dominator rows:
//   * lane j holds dominator row 32w + j of each of its kRowsPerLane word
//     rows in registers, so each column it reads serves kRowsPerLane pairs;
//   * the block's columns are staged once in shared memory as 16-byte
//     records (f0, f1, f2, key) for m <= 3, three records up to m = 8, read
//     by all lanes at once (a broadcast LDS.128 per column per word row set);
//   * __ballot_sync of the 32 lanes' tests *is* word (w, q): bit j is lane j,
//     the nsga2_torch._pack_bits layout with no shift-or per pair.  Lane
//     q mod 32 keeps it, and after 32 columns each word row goes out as one
//     coalesced 128-byte store;
//   * domination_counts takes __popc of the same vote, a dead row folded in
//     as padding.  Its grid splits the row axis too, so that n = 16384 fills
//     the card; the splits' partial counts are summed by integer atomicAdd
//     into a zeroed output (exact and independent of order; the shared
//     memory holds the block's per-column sum first, so a column takes one
//     global add per split).
//
// Plain C interface, loaded with ctypes; every launch goes on the caller's
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxObjectives = 8;
constexpr int kWarps = 8;              // warps per block
constexpr int kRowsPerLane = 4;        // word rows each warp holds at once
constexpr int kMaxCols = 1024;         // columns a block stages
constexpr int kCountRows = 1024;       // domination_counts: rows per split
constexpr int kCountCols = 256;        // domination_counts: columns per block
constexpr unsigned kAll = 0xffffffffu;

// A point: M objectives (zero padded) and the key, in whole float4 records.
template <int M>
struct Point {
  static constexpr int kVec = (M + 1 + 3) / 4;
  static constexpr int kLen = 4 * kVec;
};

// Point i of (f, cv) with its feasibility folded in, or padding where i < 0
// or the point is dead: a padding row dominates nothing (key +inf), a
// padding column is dominated by nothing (key -inf).
template <int M, bool kColumn>
__device__ __forceinline__ void load_point(const float* __restrict__ f,
                                           const float* __restrict__ cv,
                                           const int32_t* __restrict__ alive,
                                           int i, int m,
                                           float (&x)[Point<M>::kLen]) {
  const float nan = __int_as_float(0x7fc00000);
  const float pinf = __int_as_float(0x7f800000);
  const float ninf = __int_as_float(0xff800000);
  const float nmax = __int_as_float(0xff7fffff);   // -FLT_MAX
#pragma unroll
  for (int j = 0; j < Point<M>::kLen; ++j) x[j] = 0.0f;
  if (i < 0 || (alive != nullptr && alive[i] == 0)) {
    x[0] = nan;
    x[M] = kColumn ? ninf : pinf;
    return;
  }
#pragma unroll
  for (int j = 0; j < M; ++j)
    if (j < m) x[j] = f[(size_t)i * m + j];
  const float c = cv[i];
  const bool feas = c <= 0.0f;
  x[0] = feas ? x[0] : nan;
  x[M] = feas ? ninf : ((kColumn && c != c) ? nmax : c);
}

template <int M>
__device__ __forceinline__ bool dominates(const float (&p)[Point<M>::kLen],
                                          const float (&q)[Point<M>::kLen]) {
  bool any_lt = false;
#pragma unroll
  for (int j = 0; j < M; ++j) any_lt |= p[j] < q[j];
  bool dom = any_lt;
#pragma unroll
  for (int j = 0; j < M; ++j) dom &= p[j] <= q[j];
  return dom | (p[M] < q[M]);
}

// One block: rows [row0, row_end) of the dominators against the columns
// [q0, q0 + cols) staged in shared memory.  Each warp walks groups of
// kRowsPerLane word rows.  kCount selects the epilogue: packed words to
// ``words``; or each column's dominators summed in shared memory, then
// added to ``counts``.
template <int M, bool kCount>
__device__ __forceinline__ void domination_tile(
    const float* __restrict__ f_rows, const float* __restrict__ cv_rows,
    const int32_t* __restrict__ alive_rows, int r, int rows_per_block,
    const float* __restrict__ f_cols, const float* __restrict__ cv_cols,
    int n, int m, int cols, uint32_t* __restrict__ words,
    int32_t* __restrict__ counts) {
  constexpr int kVec = Point<M>::kVec, kLen = Point<M>::kLen;
  extern __shared__ __align__(16) float smem[];
  float4* s_cols = reinterpret_cast<float4*>(smem);
  int32_t* s_count = reinterpret_cast<int32_t*>(s_cols + cols * kVec);

  const int q0 = blockIdx.x * cols;
  const int n_cols = min(cols, n - q0);
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    float x[kLen];
    load_point<M, true>(f_cols, cv_cols, nullptr, c < n_cols ? q0 + c : -1,
                        m, x);
#pragma unroll
    for (int v = 0; v < kVec; ++v)
      s_cols[c * kVec + v] =
          make_float4(x[4 * v], x[4 * v + 1], x[4 * v + 2], x[4 * v + 3]);
    if constexpr (kCount) s_count[c] = 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * rows_per_block;
  const int row_end = min(row0 + rows_per_block, r);
  for (int base = row0 + (threadIdx.x >> 5) * kRowsPerLane * 32;
       base < row_end; base += kWarps * kRowsPerLane * 32) {
    float p[kRowsPerLane][kLen];
#pragma unroll
    for (int k = 0; k < kRowsPerLane; ++k) {
      const int i = base + 32 * k + lane;
      load_point<M, false>(f_rows, cv_rows, alive_rows,
                           i < row_end ? i : -1, m, p[k]);
    }
    for (int c0 = 0; c0 < n_cols; c0 += 32) {
      uint32_t word[kRowsPerLane] = {};
      int32_t count = 0;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        float q[kLen];
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          const float4 t = s_cols[(c0 + c) * kVec + v];
          q[4 * v] = t.x;
          q[4 * v + 1] = t.y;
          q[4 * v + 2] = t.z;
          q[4 * v + 3] = t.w;
        }
        if constexpr (kCount) {
          int32_t s = 0;
#pragma unroll
          for (int k = 0; k < kRowsPerLane; ++k)
            s += __popc(__ballot_sync(kAll, dominates<M>(p[k], q)));
          count = lane == c ? s : count;
        } else {
#pragma unroll
          for (int k = 0; k < kRowsPerLane; ++k) {
            const uint32_t b = __ballot_sync(kAll, dominates<M>(p[k], q));
            word[k] = lane == c ? b : word[k];
          }
        }
      }
      const int q = q0 + c0 + lane;
      if constexpr (kCount) {
        if (q < n) atomicAdd(&s_count[c0 + lane], count);
      } else {
#pragma unroll
        for (int k = 0; k < kRowsPerLane; ++k) {
          const int w = base / 32 + k;
          if (q < n && w * 32 < row_end) words[(size_t)w * n + q] = word[k];
        }
      }
    }
  }
  if constexpr (kCount) {
    __syncthreads();
    for (int c = threadIdx.x; c < n_cols; c += blockDim.x)
      atomicAdd(&counts[q0 + c], s_count[c]);
  }
}

// Grid (ceil(n / cols), ceil(r / rows_per_block)), kWarps warps a block;
// at most 64 registers a thread, so that 4 blocks (8 warps a scheduler)
// stay resident.
template <int M>
__global__ void __launch_bounds__(kWarps * 32, 4) packed_domination_kernel(
    const float* __restrict__ f_rows, const float* __restrict__ cv_rows,
    int r, const float* __restrict__ f_cols,
    const float* __restrict__ cv_cols, int n, int m, int rows_per_block,
    int cols, uint32_t* __restrict__ out) {
  domination_tile<M, false>(f_rows, cv_rows, nullptr, r, rows_per_block,
                            f_cols, cv_cols, n, m, cols, out, nullptr);
}

// Grid (ceil(n / kCountCols), ceil(r / kCountRows)): the row splits' sums
// go to ``counts`` by atomicAdd.
template <int M>
__global__ void __launch_bounds__(kWarps * 32, 4) domination_counts_kernel(
    const float* __restrict__ f_rows, const float* __restrict__ cv_rows,
    const int32_t* __restrict__ alive_rows, int r,
    const float* __restrict__ f_cols, const float* __restrict__ cv_cols,
    int n, int m, int32_t* __restrict__ counts) {
  domination_tile<M, true>(f_rows, cv_rows, alive_rows, r, kCountRows,
                           f_cols, cv_cols, n, m, kCountCols, nullptr,
                           counts);
}

template <int M>
int launch_packed(const float* f_rows, const float* cv_rows, int r,
                  const float* f_cols, const float* cv_cols, int n, int m,
                  int rows_per_block, int cols, uint32_t* out,
                  cudaStream_t s) {
  const dim3 grid((n + cols - 1) / cols,
                  (r + rows_per_block - 1) / rows_per_block);
  const size_t bytes = (size_t)cols * Point<M>::kVec * 16;
  packed_domination_kernel<M><<<grid, kWarps * 32, bytes, s>>>(
      f_rows, cv_rows, r, f_cols, cv_cols, n, m, rows_per_block, cols, out);
  return static_cast<int>(cudaGetLastError());
}

template <int M>
int launch_counts(const float* f_rows, const float* cv_rows,
                  const int32_t* alive_rows, int r, const float* f_cols,
                  const float* cv_cols, int n, int m, int32_t* out,
                  cudaStream_t s) {
  const dim3 grid((n + kCountCols - 1) / kCountCols,
                  (r + kCountRows - 1) / kCountRows);
  const size_t bytes = (size_t)kCountCols * (Point<M>::kVec * 16 + 4);
  domination_counts_kernel<M><<<grid, kWarps * 32, bytes, s>>>(
      f_rows, cv_rows, alive_rows, r, f_cols, cv_cols, n, m, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pareto_max_objectives() { return kMaxObjectives; }

int pareto_rows_per_lane() { return kRowsPerLane; }

int packed_domination_launch(const float* f_rows, const float* cv_rows,
                             int r, const float* f_cols,
                             const float* cv_cols, int n, int m,
                             int rows_per_block, int cols_per_block,
                             int32_t* out, void* stream) {
  if (r <= 0 || n <= 0) return cudaSuccess;
  if (m < 0 || m > kMaxObjectives || rows_per_block <= 0 ||
      rows_per_block % 32 || cols_per_block <= 0 || cols_per_block % 32 ||
      cols_per_block > kMaxCols)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* words = reinterpret_cast<uint32_t*>(out);
  return m <= 3 ? launch_packed<3>(f_rows, cv_rows, r, f_cols, cv_cols, n, m,
                                   rows_per_block, cols_per_block, words, s)
                : launch_packed<8>(f_rows, cv_rows, r, f_cols, cv_cols, n, m,
                                   rows_per_block, cols_per_block, words, s);
}

// ``out`` must hold zeros.
int domination_counts_launch(const float* f_rows, const float* cv_rows,
                             const int32_t* alive_rows, int r,
                             const float* f_cols, const float* cv_cols,
                             int n, int m, int32_t* out, void* stream) {
  if (r <= 0 || n <= 0) return cudaSuccess;
  if (m < 0 || m > kMaxObjectives) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return m <= 3 ? launch_counts<3>(f_rows, cv_rows, alive_rows, r, f_cols,
                                   cv_cols, n, m, out, s)
                : launch_counts<8>(f_rows, cv_rows, alive_rows, r, f_cols,
                                   cv_cols, n, m, out, s);
}

const char* pareto_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
