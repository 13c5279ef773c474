// Constrained Pareto-domination kernels for Hopper (sm_90a).
//
// Two replace the Pallas TPU kernels of the JAX package,
// repro/kernels/pareto_rank.py:
//   * packed_domination_kernel  <- packed_domination / _packed_kernel
//   * domination_counts_kernel  <- domination_counts / _counts_kernel
// The third, peel_fronts_kernel, replaces none (its note is at the kernel).
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
//     the kernels/ref.py::pack_bits layout with no shift-or per pair.  Lane
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxObjectives = 8;
constexpr int kWarps = 8;              // warps per block
constexpr int kRowsPerLane = 4;        // word rows each warp holds at once
constexpr int kPackedRows = 2048;      // packed_domination: rows a block
constexpr int kPackedCols = 256;       // packed_domination: columns a block
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

// Grid (ceil(n / kPackedCols), ceil(r / kPackedRows)), kWarps warps a
// block; at most 64 registers a thread, so that 4 blocks (8 warps a
// scheduler) stay resident.  The time is flat over 1024-4096 rows and
// 64-1024 columns a block at the search's shape (chip_variants.py).
template <int M>
__global__ void __launch_bounds__(kWarps * 32, 4) packed_domination_kernel(
    const float* __restrict__ f_rows, const float* __restrict__ cv_rows,
    int r, const float* __restrict__ f_cols,
    const float* __restrict__ cv_cols, int n, int m,
    uint32_t* __restrict__ out) {
  domination_tile<M, false>(f_rows, cv_rows, nullptr, r, kPackedRows,
                            f_cols, cv_cols, n, m, kPackedCols, out, nullptr);
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
                  uint32_t* out, cudaStream_t s) {
  const dim3 grid((n + kPackedCols - 1) / kPackedCols,
                  (r + kPackedRows - 1) / kPackedRows);
  const size_t bytes = (size_t)kPackedCols * Point<M>::kVec * 16;
  packed_domination_kernel<M><<<grid, kWarps * 32, bytes, s>>>(
      f_rows, cv_rows, r, f_cols, cv_cols, n, m, out);
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


// ---------------------------------------------------------------------------
// peel_fronts_kernel: the whole front loop of one ranking in one launch.
//
// It replaces no Pallas kernel.  The JAX package peels its fronts inside a
// compiled lax.while_loop (repro/core/nsga2_jax.py, nondominated_rank and
// its tiled twin), one XLA program with no host decision in it.  The port's
// loop was plain PyTorch (kernels/ref.py::peel_fronts): about ten
// elementwise passes over the (W, n) words and one host read a front.  This
// kernel runs that loop on the device, with the plain loop's ranks, stop
// rules and "numerical safety" branch bit for bit, and the host reads one
// small result a ranking.
//
// It reads K1's words as they are: bit j of word (w, q) is set when row
// 32w + j dominates column q.  Column q joins front r when no alive row
// dominates it: words[w, q] & alive[w] == 0 for every word row w.
//
// What bounds it on an H100.  A front reads at most the alive columns of
// the alive word rows, W x n x 4 bytes, 128 MiB at n = 32768 (40 us at
// 3.35 TB/s); a column stops at its first alive dominator and a dead word
// row is never read, so most fronts read far less (chip_smoke.py counts
// the bytes a ranking's fronts need).  The fronts depend on each other, so
// each also pays a grid barrier and the staging of the alive words: about
// 4 us a front.  Neither is the limit: a front takes about 65 us at
// n = 32768, against 1 us of bytes.  A front member's column reads every
// live word row, 64 rows in flight a block, so the walk's chain of
// dependent loads is the likely limit.  The design:
//   * one cooperative launch, as many blocks as the card holds at once and
//     at most one a column slice (32 columns, one alive word), so that the
//     blocks can wait for each other at a grid barrier between fronts;
//   * the alive mask packed in device memory and double-buffered: front r
//     reads `cur` and writes `next`, so no block waits inside a front;
//   * each front, every block stages the W alive words in shared memory with
//     the list of the non-zero ones and their population count, the alive
//     count, the same in every block;
//   * the block's 8 warps walk that list for its slice, kPeelUnroll word rows
//     a lane in flight, the lanes on neighbouring columns (coalesced).  A lane
//     stops loading once its column is dominated, a warp once every column
//     of the slice is settled; the warps share the dominated columns through
//     a word in shared memory;
//   * front members take rank r, and the block adds its front count to one
//     of three counters in turn (one is zeroed while another is read).  After
//     the barrier every block reads it and applies the plain loop's stop
//     rules, so that all blocks leave the loop at the same front.
constexpr int kPeelWarps = 8;          // warps per block
constexpr int kPeelUnroll = 8;         // word rows a lane loads at once
constexpr int kPeelHeader = 4;         // shared words before the alive words

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

inline size_t peel_smem_bytes(int n) {
  return (size_t)(kPeelHeader + 2 * ((n + 31) / 32)) * 4;
}

// words (W, n) and alive (n,) as given; alive_a, alive_b (W,) and counts
// (3,) scratch; rank (n,) and result (3,: fronts, ranked, alive at entry)
// written.
__global__ void __launch_bounds__(kPeelWarps * 32) peel_fronts_kernel(
    const uint32_t* __restrict__ words, const uint8_t* __restrict__ alive,
    int n, int cap, uint32_t* alive_a, uint32_t* alive_b, int* counts,
    int64_t* __restrict__ rank, int64_t* __restrict__ result) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  extern __shared__ __align__(16) uint32_t peel_smem[];
  const int W = (n + 31) / 32;
  int* s_len = reinterpret_cast<int*>(peel_smem);      // live word rows
  int* s_alive_n = s_len + 1;                          // alive individuals
  uint32_t* s_dom = peel_smem + 2;                     // slice's dominated
  uint32_t* s_alive = peel_smem + kPeelHeader;         // (W,) alive words
  int* s_list = reinterpret_cast<int*>(s_alive + W);   // live word rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // entry: the alive mask packed, every rank n, the counters zeroed
  for (int s = blockIdx.x * kPeelWarps + warp; s < W;
       s += gridDim.x * kPeelWarps) {
    const int q = 32 * s + lane;
    const uint32_t word = __ballot_sync(kAll, q < n && alive[q] != 0);
    if (q < n) rank[q] = n;
    if (lane == 0) alive_a[s] = word;
  }
  if (blockIdx.x == 0 && threadIdx.x < 3) counts[threadIdx.x] = 0;
  grid.sync();

  uint32_t* cur = alive_a;
  uint32_t* next = alive_b;
  int r = 0, done = 0, entry = 0;
  for (;;) {
    // stage the alive words, the list of live word rows, the alive count
    // (read past L1: other blocks wrote them before the barrier)
    if (threadIdx.x == 0) *s_len = *s_alive_n = 0;
    __syncthreads();
    int pop = 0;
    for (int base = warp * 32; base < W; base += kPeelWarps * 32) {
      const int w = base + lane;
      const uint32_t a = w < W ? __ldcg(cur + w) : 0u;
      if (w < W) s_alive[w] = a;
      pop += __popc(a);
      const uint32_t live = __ballot_sync(kAll, a != 0u);
      int at = 0;
      if (lane == 0 && live) at = atomicAdd(s_len, __popc(live));
      at = __shfl_sync(kAll, at, 0);
      if (a) s_list[at + __popc(live & ((1u << lane) - 1u))] = w;
    }
    pop = warp_sum(pop);
    if (lane == 0 && pop) atomicAdd(s_alive_n, pop);
    __syncthreads();
    const int n_alive = *s_alive_n, len = *s_len;
    if (r == 0) entry = n_alive;
    if (n_alive == 0 || done >= cap) break;      // the same in every block

    // the front test of the block's slices
    int k_block = 0;
    for (int s = blockIdx.x; s < W; s += gridDim.x) {
      const uint32_t cols = s_alive[s];
      if (cols == 0u) {
        if (threadIdx.x == 0) next[s] = 0u;
        continue;
      }
      if (threadIdx.x == 0) *s_dom = 0u;
      __syncthreads();
      const uint32_t* col = words + 32 * s + lane;
      bool settled = !((cols >> lane) & 1u);     // dead (or past n): no load
      for (int i0 = warp * kPeelUnroll; i0 < len;
           i0 += kPeelWarps * kPeelUnroll) {
        uint32_t hit = 0u;
        if (!settled) {
#pragma unroll
          for (int u = 0; u < kPeelUnroll; ++u) {
            if (i0 + u < len) {
              const int w = s_list[i0 + u];
              hit |= __ldg(col + (size_t)w * n) & s_alive[w];
            }
          }
        }
        const uint32_t dom = __ballot_sync(kAll, hit != 0u);
        if (lane == 0 && dom) atomicOr(s_dom, dom);
        settled = settled || hit != 0u ||
                  ((*reinterpret_cast<volatile uint32_t*>(s_dom) >> lane) &
                   1u);
        if (__all_sync(kAll, settled)) break;
      }
      __syncthreads();
      const uint32_t front = cols & ~*s_dom;
      if (warp == 0 && ((front >> lane) & 1u)) rank[32 * s + lane] = r;
      if (threadIdx.x == 0) {
        next[s] = cols & ~front;
        k_block += __popc(front);
      }
      __syncthreads();                           // *s_dom is reused
    }
    if (threadIdx.x == 0) {
      if (k_block) atomicAdd(&counts[r % 3], k_block);
      if (blockIdx.x == 0) counts[(r + 1) % 3] = 0;
    }
    grid.sync();

    const int k = __ldcg(&counts[r % 3]);
    if (k == 0) {                                // numerical safety
      for (int s = blockIdx.x; s < W; s += gridDim.x)
        if (warp == 0 && ((s_alive[s] >> lane) & 1u))
          rank[32 * s + lane] = r;
      done += n_alive;
      ++r;
      break;
    }
    done += k;
    ++r;
    uint32_t* t = cur;
    cur = next;
    next = t;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    result[0] = r;
    result[1] = done;
    result[2] = entry;
  }
}

// The cooperative grid for n individuals: the blocks the card holds at
// once, at most one a 32-column slice; or a negative CUDA error code.
int peel_grid(int n, size_t smem) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(peel_fronts_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, peel_fronts_kernel, kPeelWarps * 32, smem);
  if (err == cudaSuccess && per_sm < 1)
    err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int slices = (n + 31) / 32;
  return per_sm * sms < slices ? per_sm * sms : slices;
}

}  // namespace

extern "C" {

int pareto_max_objectives() { return kMaxObjectives; }

int pareto_rows_per_lane() { return kRowsPerLane; }

int packed_domination_launch(const float* f_rows, const float* cv_rows,
                             int r, const float* f_cols,
                             const float* cv_cols, int n, int m,
                             int32_t* out, void* stream) {
  if (r <= 0 || n <= 0) return cudaSuccess;
  if (m < 0 || m > kMaxObjectives) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* words = reinterpret_cast<uint32_t*>(out);
  return m <= 3 ? launch_packed<3>(f_rows, cv_rows, r, f_cols, cv_cols, n, m,
                                   words, s)
                : launch_packed<8>(f_rows, cv_rows, r, f_cols, cv_cols, n, m,
                                   words, s);
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

// The largest n whose alive words and list fit in a block's shared memory.
int peel_fronts_max_n() { return ((232448 / 4 - kPeelHeader) / 2) * 32; }

// ``scratch`` holds 2 * ceil(n / 32) + 3 int32; nothing need be zeroed.
int peel_fronts_launch(const int32_t* words, const uint8_t* alive, int n,
                       int cap, int32_t* scratch, int64_t* rank,
                       int64_t* result, void* stream) {
  if (n <= 0 || n > peel_fronts_max_n() || cap < 0)
    return cudaErrorInvalidValue;
  const size_t smem = peel_smem_bytes(n);
  const int grid = peel_grid(n, smem);
  if (grid < 0) return -grid;
  const int W = (n + 31) / 32;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(words);
  uint32_t* alive_a = reinterpret_cast<uint32_t*>(scratch);
  uint32_t* alive_b = alive_a + W;
  int* counts = reinterpret_cast<int*>(scratch + 2 * W);
  void* args[] = {&w, &alive, &n, &cap, &alive_a, &alive_b, &counts, &rank,
                  &result};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      peel_fronts_kernel, dim3(grid), dim3(kPeelWarps * 32), args, smem,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* pareto_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
