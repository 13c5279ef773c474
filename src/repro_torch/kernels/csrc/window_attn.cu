// Causal sliding-window attention (prefill) for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel of the JAX package,
// repro/kernels/window_attn.py::window_attn (body _kernel): query i of a
// (batch, head) attends to the keys j with i - W < j <= i, softmax(q k^T /
// sqrt(hd)) v, with an online softmax (running max, running sum and
// accumulator in float32) and the denominator clamped at 1e-20.  GQA maps
// query head h to KV head h / (H / Kv) by index; K and V are never
// repeated.
//
// What bounds it on an H100: the operations.  At the LM path's shape
// (B = 2, T = 8192, H = 15, Kv = 5, hd = 64, W = 4096) a call has 755M
// valid (query, key) pairs of 4 hd = 256 operations each (q.k and p.v),
// about 193 GFLOP: ~1.17 ms as 3xTF32 on the tensor cores (three TF32
// products at 495 TFLOP/s each), ~2.9 ms as float32 FMAs on the CUDA cores
// (67 TFLOP/s), against 168 MB of q, k, v and o (~0.05 ms at 3.35 TB/s).
//
// Design: flash attention on the tensor cores at float32 accuracy, both
// products by the 3xTF32 mma.sync of mma_tf32x3.cuh.  One block of 8 warps
// per (query tile, head, batch row); each warp owns MT 16-row slices of
// the tile (MT = 2 for hd <= 64, 1 above, where the accumulators of two
// would not fit in registers).  A thread holds ~255 registers, so an SM
// runs at most 8 warps.  At hd 128 a block of 4 warps (64 query rows and
// two key stages, 168 KiB of shared memory) sat alone on its SM; a block
// of 8 (128 rows, 202 KiB) is alone too, with twice the warps: 14.1
// against 22.6 ms at qwen2-vl-7b's shape.  At hd 64 a block walks each
// key tile for 256 query rows, not 128: 3.66 against 3.95 ms
// (chip_variants.py --k5, PERF.md).
// - Splitting a float32 into two TF32 values costs seven instructions,
//   and each warp splits every K and V fragment it reads: with two slices
//   a warp, each split fragment feeds two products.
// - Q: the tile waits in shared memory and each fragment is scaled by
//   log2(e)/sqrt(hd) and split as it is read.
// - K and V: the key tiles of the window go through a two-stage ring in
//   shared memory, filled by cp.async (16 bytes a thread, zeros past T):
//   the next tile is in flight while the current one is computed.
// - S = Q K^T goes into registers, in base 2: log2(e) is folded into Q's
//   scale, so each exponential of the softmax is one exp2f (2^(x log2 e) =
//   e^x).  A score row lives in the 4 lanes of a quad, so the online
//   softmax's row max is two __shfl_xor; the row sum is kept as each
//   lane's share and summed at the end.  Only tiles that touch the
//   diagonal or the window's lower edge test positions (a second copy of
//   the softmax): there an invalid score is selected to -1e30 and its p to
//   0 (never multiplied by a mask).
// - O = alpha O + P V: the fragment's k = t and t + 4 stand for the tile's
//   keys 2t and 2t + 1 (mma_tf32x3.cuh), so the score accumulator is
//   already P's A fragment; no shuffle or scratch re-lays it.  V's
//   fragment reads the same two keys.  P takes the all-integer split: a
//   NaN p (from a NaN in q or k) is also in the row sum, and the clamp
//   keeps it.  Each tile's P V goes into a zeroed fragment, merged into O
//   by one float32 fma: the tensor cores' float32 accumulation is not
//   rounded to nearest, and an O that took every tile's products in place
//   drifted toward zero by 1.5e-5 of its size over a 4096-key window,
//   3e-4 in smollm-360m's logits (PERF.md).
// Row strides: K and Q rows hd + 8 floats (the float2 reads of a half warp
// hit 32 banks), V rows hd + 4 (the 32 lanes' two-key reads hit 32 banks).
// hd 160 takes 32-key tiles, so that Q and two stages fit in 227 KB.
//
// Plain C interface, loaded with ctypes; every launch goes on the caller's
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <type_traits>

#include "mma_tf32x3.cuh"

namespace {

using tf32x3::mma3;
using tf32x3::split;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

template <int HD>
struct Layout {
  static constexpr int kMT = HD <= 64 ? 2 : 1;       // 16-row slices a warp
  static constexpr int kBlockQ = 16 * kMT * kWarps;  // query rows a block
  static constexpr int kBlockK = HD <= 128 ? 64 : 32;
  static constexpr int kKs = HD + 8;   // K and Q row stride, floats
  static constexpr int kVs = HD + 4;   // V row stride
  static constexpr int kStage = kBlockK * (kKs + kVs);
  static constexpr size_t kBytes =
      sizeof(float) * (2 * kStage + kBlockQ * kKs);
};

// Issue the copies of `rows` rows of hd floats (row r at src + r * stride)
// into dst rows of `ld` floats; rows at or past `valid` are zero-filled.
template <int HD>
__device__ __forceinline__ void copy_rows(float* dst, int ld,
                                          const float* src, size_t stride,
                                          int rows, int valid) {
  constexpr int kPieces = HD / 4;
  for (int c = threadIdx.x; c < rows * kPieces; c += kThreads) {
    const int r = c / kPieces, d = (c % kPieces) * 4;
    const bool in = r < valid;
    tf32x3::cp_async16(dst + r * ld + d, in ? src + r * stride + d : src,
                       in);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
window_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   int T, int H, int KV, int window) {
  using L = Layout<HD>;
  constexpr int MT = L::kMT, BQ = L::kBlockQ, BK = L::kBlockK;
  constexpr int KS = HD / 8;   // k-steps of S = Q K^T
  constexpr int NT = HD / 8;   // 8-wide column tiles of O
  constexpr int JT = BK / 8;   // 8-key column tiles of S
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem + 2 * L::kStage;   // [BQ][kKs]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  // base-2 scores: log2(e) / sqrt(hd)
  const float scale = 1.4426950408889634f / sqrtf(static_cast<float>(HD));
  const int slice0 = warp * 16 * MT;   // first tile row of this warp
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const float* k_bh = k + static_cast<size_t>(b) * T * kv_stride +
                      static_cast<size_t>(kvh) * HD;
  const float* v_bh = v + (k_bh - k);
  const size_t q_stride = static_cast<size_t>(H) * HD;

  const int k_first = max(0, q0 - window + 1) / BK * BK;
  const int k_last = min(T - 1, q0 + BQ - 1);
  const int n_tiles = (k_last - k_first) / BK + 1;

  auto load_tile = [&](int it) {
    const int k0 = k_first + it * BK;
    float* sK = smem + (it & 1) * L::kStage;
    float* sV = sK + BK * L::kKs;
    copy_rows<HD>(sK, L::kKs, k_bh + k0 * kv_stride, kv_stride, BK, T - k0);
    copy_rows<HD>(sV, L::kVs, v_bh + k0 * kv_stride, kv_stride, BK, T - k0);
  };
  copy_rows<HD>(sQ, L::kKs,
                q + (static_cast<size_t>(b) * T + q0) * q_stride +
                    static_cast<size_t>(h) * HD,
                q_stride, BQ, T - q0);
  load_tile(0);
  tf32x3::cp_async_commit();

  float m_i[MT][2], l_i[MT][2];   // l_i: this lane's share of the row sums
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_i[mt][r] = kNegInf;
      l_i[mt][r] = 0.0f;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.0f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_tile(it + 1);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<1>();   // tile `it` (and Q) landed
    __syncthreads();
    const int k0 = k_first + it * BK;
    const float* sK = smem + (it & 1) * L::kStage;
    const float* sV = sK + BK * L::kKs;

    // S = (Q log2(e) / sqrt(hd)) K^T: s[mt][j] holds keys 8j + 2t and
    // 8j + 2t + 1 of slice mt's row g (e 0, 1) and row g + 8 (e 2, 3)
    float s[MT][JT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < JT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t bh[JT][2], bl[JT][2];
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        const float2 kv = *reinterpret_cast<const float2*>(
            sK + (8 * j + g) * L::kKs + 8 * ks + 2 * t);
        split(kv.x, bh[j][0], bl[j][0]);
        split(kv.y, bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // a0/a2: dims 8ks + 2t, + 1 of row g; a1/a3 the same of row g + 8
        const float* r0 = sQ + (slice0 + 16 * mt + g) * L::kKs + 8 * ks +
                          2 * t;
        const float2 x0 = *reinterpret_cast<const float2*>(r0);
        const float2 x1 = *reinterpret_cast<const float2*>(r0 + 8 * L::kKs);
        const float a[4] = {x0.x * scale, x1.x * scale, x0.y * scale,
                            x1.y * scale};
        uint32_t ah[4], al[4];
        split(a, ah, al);
        mma3(s[mt], ah, al, bh, bl);
      }
    }

    // the online softmax; `masked` for the tiles on the diagonal or the
    // window's lower edge, the only ones that test positions
    float alpha[MT][2];
    auto softmax = [&](auto masked) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row0 = q0 + slice0 + 16 * mt + g;
        uint32_t valid = 0xffffffffu;   // bit 4j + e
        if constexpr (decltype(masked)::value) {
#pragma unroll
          for (int j = 0; j < JT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qp = row0 + (e >> 1) * 8;
              const int kp = k0 + 8 * j + 2 * t + (e & 1);
              if (!(kp <= qp && kp > qp - window)) {
                valid &= ~(1u << (4 * j + e));
                s[mt][j][e] = kNegInf;
              }
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float m_t = kNegInf;
#pragma unroll
          for (int j = 0; j < JT; ++j)
            m_t = fmaxf(m_t, fmaxf(s[mt][j][2 * r], s[mt][j][2 * r + 1]));
          m_t = fmaxf(m_t, __shfl_xor_sync(0xffffffffu, m_t, 1));
          m_t = fmaxf(m_t, __shfl_xor_sync(0xffffffffu, m_t, 2));
          const float m_new = fmaxf(m_i[mt][r], m_t);
          alpha[mt][r] = exp2f(m_i[mt][r] - m_new);
          float row = 0.0f;
#pragma unroll
          for (int j = 0; j < JT; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 2 * r + c;
              float p = exp2f(s[mt][j][e] - m_new);
              if constexpr (decltype(masked)::value)
                p = (valid >> (4 * j + e)) & 1u ? p : 0.0f;
              s[mt][j][e] = p;
              row += p;
            }
          l_i[mt][r] = l_i[mt][r] * alpha[mt][r] + row;
          m_i[mt][r] = m_new;
        }
      }
    };
    if (!(k0 + BK - 1 <= q0 && k0 > q0 + BQ - 1 - window))
      softmax(std::true_type{});
    else
      softmax(std::false_type{});

    // O = alpha O + P V, P V into a zeroed fragment of its own (see the
    // head of the file).  Key step j's A fragment is s[mt][j] itself (a0 =
    // key 8j + 2t of row g, a1 of row g + 8, a2/a3 key 8j + 2t + 1).
    float pv[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[mt][n][e] = 0.0f;
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      const float* v0 = sV + (8 * j + 2 * t) * L::kVs + g;
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        split(v0[8 * n], bh[n][0], bl[n][0]);
        split(v0[L::kVs + 8 * n], bh[n][1], bl[n][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float a[4] = {s[mt][j][0], s[mt][j][2], s[mt][j][1],
                            s[mt][j][3]};
        uint32_t ph[4], pl[4];
        split</*NonNan=*/true>(a, ph, pl);   // a NaN p is in l too
        mma3(pv[mt], ph, pl, bh, bl);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][n][e] =
              fmaf(acc[mt][n][e], alpha[mt][e >> 1], pv[mt][n][e]);
    __syncthreads();   // this stage is free for tile it + 2
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_i[mt][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      // max(l, 1e-20) that keeps a NaN l, as the reference's maximum
      const float denom = l < 1e-20f ? 1e-20f : l;
      const int row = q0 + slice0 + 16 * mt + g + 8 * r;
      if (row < T) {
        float* out = o + (static_cast<size_t>(b) * T + row) * q_stride +
                     static_cast<size_t>(h) * HD + 2 * t;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<float2*>(out + 8 * n) = make_float2(
              acc[mt][n][2 * r] / denom, acc[mt][n][2 * r + 1] / denom);
      }
    }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int T, int H, int KV, int window, cudaStream_t stream) {
  const size_t smem = Layout<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int BQ = Layout<HD>::kBlockQ;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  window_attn_kernel<HD><<<grid, kThreads, smem, stream>>>(q, k, v, o, T, H,
                                                           KV, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int window_attn_supports_head_dim(int hd) {
  return hd == 32 || hd == 64 || hd == 128 || hd == 160;
}

// q, o (B, T, H, hd); k, v (B, T, KV, hd); all contiguous float32 on the
// device, H a multiple of KV, window >= 1.
int window_attn_launch(const float* q, const float* k, const float* v,
                       float* o, int B, int T, int H, int KV, int hd,
                       int window, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32>(q, k, v, o, B, T, H, KV, window, s);
    case 64: return launch<64>(q, k, v, o, B, T, H, KV, window, s);
    case 128: return launch<128>(q, k, v, o, B, T, H, KV, window, s);
    case 160: return launch<160>(q, k, v, o, B, T, H, KV, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* window_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
