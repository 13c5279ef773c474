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
// valid (query, key) pairs of 4 hd = 256 float32 operations each (q.k and
// p.v), about 193 GFLOP, ~2.9 ms at the 67 TFLOP/s float32 rate outside the
// tensor cores, against 168 MB of q, k, v and o (~0.05 ms at 3.35 TB/s).
//
// Design (a plain CUDA-core first version; no TF32, no wgmma): one thread
// block per (64-query tile, head, batch row), 256 threads.  The block walks
// the 64-key tiles its window touches (at most W / 64 + 1 of them), staging
// K and V in shared memory, so no (T, T) score matrix exists anywhere.
// Thread (g, c) of the block (g = tid / 16, c = tid % 16) owns query rows
// 4g..4g+3 and, per tile, keys c + 16 j (j < 4) of the score tile and
// output dims c + 16 j (j < hd / 16) of the accumulator; the 16 threads of
// a row group reduce the row max with shuffles.  Rows of Q and K in shared
// memory are padded by one float so the 16 lanes reading 16 different keys
// at one dim hit 16 banks; P rows are padded by four so the two row groups
// of a warp land 16 banks apart.  The ragged edge (t not a multiple of 64,
// any window) is masked in the kernel: rows past t are staged as zeros and
// never written.
//
// Plain C interface, loaded with ctypes; every launch goes on the caller's
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kPStride = kBlockK + 4;
constexpr float kNegInf = -1e30f;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockQ * (HD + 1) + kBlockK * (HD + 1) +
                          kBlockK * HD + kBlockQ * kPStride);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
window_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   int T, int H, int KV, int window) {
  constexpr int NJ = HD / 16;   // output dims per thread
  extern __shared__ float smem[];
  float* sQ = smem;                              // [kBlockQ][HD + 1]
  float* sK = sQ + kBlockQ * (HD + 1);           // [kBlockK][HD + 1]
  float* sV = sK + kBlockK * (HD + 1);           // [kBlockK][HD]
  float* sP = sV + kBlockK * HD;                 // [kBlockQ][kPStride]

  const int tid = threadIdx.x;
  const int g = tid >> 4;
  const int c = tid & 15;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const float sqrt_hd = sqrtf(static_cast<float>(HD));

  for (int idx = tid; idx < kBlockQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int t = q0 + r;
    sQ[r * (HD + 1) + d] =
        t < T ? q[(((size_t)b * T + t) * H + h) * HD + d] : 0.0f;
  }

  float m_i[4], l_i[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.0f;   // this lane's share of the row sum
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  const int k_first = max(0, q0 - window + 1) / kBlockK * kBlockK;
  const int k_last = min(T - 1, q0 + kBlockQ - 1);
  for (int k0 = k_first; k0 <= k_last; k0 += kBlockK) {
    __syncthreads();   // the previous tile's P @ V is done with sK/sV/sP
    for (int idx = tid; idx < kBlockK * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD;
      const int t = k0 + r;
      const size_t at = (((size_t)b * T + t) * KV + kvh) * HD + d;
      sK[r * (HD + 1) + d] = t < T ? k[at] : 0.0f;
      sV[r * HD + d] = t < T ? v[at] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(g * 4 + i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(c + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + g * 4 + i;
      bool valid[4];
      float m_t = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + c + 16 * j;
        valid[j] = kp <= qp && kp > qp - window;
        s[i][j] = valid[j] ? s[i][j] / sqrt_hd : kNegInf;
        m_t = fmaxf(m_t, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        m_t = fmaxf(m_t, __shfl_xor_sync(0xffffffffu, m_t, off, 16));
      const float m_new = fmaxf(m_i[i], m_t);
      const float alpha = expf(m_i[i] - m_new);
      float row = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.0f;
        sP[(g * 4 + i) * kPStride + c + 16 * j] = p;
        row += p;
      }
      l_i[i] = l_i[i] * alpha + row;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < kBlockK; ++key) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(g * 4 + i) * kPStride + key];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = sV[key * HD + c + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_i[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off, 16);
    const float denom = fmaxf(l, 1e-20f);
    const int t = q0 + g * 4 + i;
    if (t < T) {
      float* out = o + (((size_t)b * T + t) * H + h) * HD;
#pragma unroll
      for (int j = 0; j < NJ; ++j) out[c + 16 * j] = acc[i][j] / denom;
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int T, int H, int KV, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((T + kBlockQ - 1) / kBlockQ, H, B);
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
