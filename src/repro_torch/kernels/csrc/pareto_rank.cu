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
//   feasible (cv <= 0) beats infeasible; among infeasible the lower cv
//   wins; among feasible all(f_p <= f_q) & any(f_p < f_q).
// A NaN compares false everywhere, and a +inf violation (row padding)
// dominates nothing.
//
// What bounds them on an H100: the pair tests.  At the search's shapes
// (n = 32768 rows and columns, m = 3 objectives) packed_domination does
// about 1.1e9 pair tests of 2m+1 float compares each, against 128 MiB of
// packed output; domination_counts at n = 16384 does 2.7e8 pair tests and
// writes 64 KiB.  The design keeps each column's objectives in registers,
// stages dominator rows through shared memory (every thread of a warp reads
// the same row, a broadcast), and writes each output word once, coalesced
// along the column axis.  No atomics: every output has one writer, so both
// results are exact and deterministic.
//
// Plain C interface, loaded with ctypes; every launch goes on the caller's
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxObjectives = 8;
constexpr int kStageRows = 256;   // dominator rows staged per shared tile

__device__ __forceinline__ bool dominates(const float* fp, float cvp,
                                          const float* fq, float cvq,
                                          int m) {
  const bool feas_p = cvp <= 0.0f;
  const bool feas_q = cvq <= 0.0f;
  if (feas_p && !feas_q) return true;
  if (feas_q && !feas_p) return false;
  if (!feas_p && !feas_q) return cvp < cvq;
  bool all_le = true, any_lt = false;
#pragma unroll
  for (int j = 0; j < kMaxObjectives; ++j) {
    if (j < m) {
      all_le &= fp[j] <= fq[j];
      any_lt |= fp[j] < fq[j];
    }
  }
  return all_le && any_lt;
}

// Grid (ceil(n / blockDim.x), ceil(r / rows_per_block)); one thread per
// column q of the block's column tile, looping over the rows_per_block / 32
// output words of its row tile.  Shared: kStageRows rows of (m objectives +
// cv), refilled as the loop walks the row tile.
__global__ void packed_domination_kernel(
    const float* __restrict__ f_rows, const float* __restrict__ cv_rows,
    int r, const float* __restrict__ f_cols,
    const float* __restrict__ cv_cols, int n, int m, int rows_per_block,
    uint32_t* __restrict__ out) {
  __shared__ float s_f[kStageRows * kMaxObjectives];
  __shared__ float s_cv[kStageRows];

  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const bool col_ok = q < n;
  float fq[kMaxObjectives];
  float cvq = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxObjectives; ++j)
    fq[j] = (col_ok && j < m) ? f_cols[(size_t)q * m + j] : 0.0f;
  if (col_ok) cvq = cv_cols[q];

  const int words_out = (r + 31) / 32;
  const int row0 = blockIdx.y * rows_per_block;
  const int row_end = min(row0 + rows_per_block, r);

  for (int stage0 = row0; stage0 < row_end; stage0 += kStageRows) {
    const int n_stage = min(kStageRows, row_end - stage0);
    __syncthreads();
    for (int i = threadIdx.x; i < kStageRows; i += blockDim.x) {
      if (i < n_stage) {
        s_cv[i] = cv_rows[stage0 + i];
        for (int j = 0; j < m; ++j)
          s_f[i * kMaxObjectives + j] = f_rows[(size_t)(stage0 + i) * m + j];
      } else {
        s_cv[i] = __int_as_float(0x7f800000);   // +inf: dominates nothing
      }
    }
    __syncthreads();
    if (!col_ok) continue;
    for (int w = 0; w < kStageRows / 32; ++w) {
      const int word = stage0 / 32 + w;   // stage0 is a multiple of 32
      if (word * 32 >= row_end) break;
      uint32_t bits = 0;
#pragma unroll 4
      for (int b = 0; b < 32; ++b) {
        const int i = w * 32 + b;
        if (dominates(&s_f[i * kMaxObjectives], s_cv[i], fq, cvq, m))
          bits |= 1u << b;
      }
      if (word < words_out) out[(size_t)word * n + q] = bits;
    }
  }
}

// Grid ceil(n / blockDim.x); one thread per column, streaming every
// dominator row through shared memory and counting the alive ones that
// dominate it in a register.
__global__ void domination_counts_kernel(
    const float* __restrict__ f_rows, const float* __restrict__ cv_rows,
    const int32_t* __restrict__ alive_rows, int r,
    const float* __restrict__ f_cols, const float* __restrict__ cv_cols,
    int n, int m, int32_t* __restrict__ out) {
  __shared__ float s_f[kStageRows * kMaxObjectives];
  __shared__ float s_cv[kStageRows];

  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const bool col_ok = q < n;
  float fq[kMaxObjectives];
  float cvq = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxObjectives; ++j)
    fq[j] = (col_ok && j < m) ? f_cols[(size_t)q * m + j] : 0.0f;
  if (col_ok) cvq = cv_cols[q];

  int32_t count = 0;
  for (int stage0 = 0; stage0 < r; stage0 += kStageRows) {
    const int n_stage = min(kStageRows, r - stage0);
    __syncthreads();
    for (int i = threadIdx.x; i < kStageRows; i += blockDim.x) {
      // a dead row is staged as padding: it dominates nothing
      if (i < n_stage && alive_rows[stage0 + i] != 0) {
        s_cv[i] = cv_rows[stage0 + i];
        for (int j = 0; j < m; ++j)
          s_f[i * kMaxObjectives + j] = f_rows[(size_t)(stage0 + i) * m + j];
      } else {
        s_cv[i] = __int_as_float(0x7f800000);
      }
    }
    __syncthreads();
    if (!col_ok) continue;
    for (int i = 0; i < n_stage; ++i)
      count += dominates(&s_f[i * kMaxObjectives], s_cv[i], fq, cvq, m);
  }
  if (col_ok) out[q] = count;
}

}  // namespace

extern "C" {

int pareto_max_objectives() { return kMaxObjectives; }

int packed_domination_launch(const float* f_rows, const float* cv_rows,
                             int r, const float* f_cols,
                             const float* cv_cols, int n, int m,
                             int rows_per_block, int cols_per_block,
                             int32_t* out, void* stream) {
  if (r <= 0 || n <= 0) return cudaSuccess;
  dim3 grid((n + cols_per_block - 1) / cols_per_block,
            (r + rows_per_block - 1) / rows_per_block);
  packed_domination_kernel<<<grid, cols_per_block, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      f_rows, cv_rows, r, f_cols, cv_cols, n, m, rows_per_block,
      reinterpret_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

int domination_counts_launch(const float* f_rows, const float* cv_rows,
                             const int32_t* alive_rows, int r,
                             const float* f_cols, const float* cv_cols,
                             int n, int m, int cols_per_block, int32_t* out,
                             void* stream) {
  if (n <= 0) return cudaSuccess;
  dim3 grid((n + cols_per_block - 1) / cols_per_block);
  domination_counts_kernel<<<grid, cols_per_block, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      f_rows, cv_rows, alive_rows, r, f_cols, cv_cols, n, m, out);
  return static_cast<int>(cudaGetLastError());
}

const char* pareto_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
