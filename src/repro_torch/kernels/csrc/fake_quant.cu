// Per-tensor fake quantization of many float32 tensors for Hopper (sm_90a):
// min/max calibration, scale and zero-point, quantize -> dequantize.
//
// Replaces no TPU kernel.  The JAX package fake-quantizes with jnp ops that
// XLA fuses (repro/core/quant.py: calibrate, compute_scale_zp, fake_quant);
// the port ran the same chain as eager ATen ops, about 16 launches a tensor
// (min, max, abs, abs, maximum, div, clamp_min, zeros_like; div, add, round,
// clamp, sub, mul, sub, add), so a stage of EfficientNet-B0 cost hundreds of
// tiny launches and the host, not the device, set its time.
//
// What bounds it on an H100: bytes.  Each tensor is read twice (its range,
// then its values) and written once: EfficientNet-B0's 82 weight tensors
// (21 MB) take ~19 us at 3.35 TB/s, granite-4.0-h-micro's stacked leaves
// of one stage up to a few GB take milliseconds.
//
// Design.  One call takes up to kMaxTensors tensors, described by value in
// the kernel's parameters (input pointer, size, offset in the flat output;
// ~2.7 KB, under the 4 KB of classic kernel parameters), and runs in two
// launches on the caller's stream:
//   0. range:    each block reduces a slice of one tensor to a (min, max)
//                partial in scratch.  Min and max are exact in any order,
//                so no atomics and no memset are needed;
//   1. quantize: each block folds its tensor's partials, forms scale and
//                zero-point, and writes x + (dq - x) into its slice of the
//                flat output.
// A tensor gets ceil(n / kElemsPerBlock) blocks, at most
// kMaxBlocksPerTensor, which walk it grid-stride with float4 loads (scalar
// where its start is not on 16 bytes), so a tensor of several GB runs at
// bandwidth and a small one costs one block.
//
// Bits.  The result equals the ATen chain on a CUDA tensor bit for bit:
// each operation rounded on its own in the chain's order (the intrinsics
// keep nvcc from contracting a * b - c into an FMA), a Python-number
// divisor as ATen's CUDA division by a CPU scalar takes it (a multiply by
// the float reciprocal, formed on the host), a divisor that is a tensor
// (x / scale) as a true division, rintf for torch.round, NaN kept as ATen's
// min, max, maximum and clamp keep it, zp added and subtracted (so -0.0
// comes out +0.0).
//
// Plain C interface, loaded with ctypes; the caller allocates the output
// and the scratch, and each launch returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxTensors = 96;
constexpr int kThreads = 256;
constexpr int kElemsPerBlock = kThreads * 4 * 8;   // 8 float4 a thread
constexpr int kMaxBlocksPerTensor = 1024;

struct Batch {
  const float* in[kMaxTensors];
  long long n[kMaxTensors];
  long long out_off[kMaxTensors];     // floats, a multiple of 4
  int block0[kMaxTensors + 1];        // first block of each tensor
  int count;
};

int blocks_of(long long n) {
  long long b = (n + kElemsPerBlock - 1) / kElemsPerBlock;
  return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocksPerTensor
                                           ? kMaxBlocksPerTensor : b));
}

// NaN-propagating min and max, as ATen's min/max reductions combine.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The tensor that block `block` works on: the last t with block0[t] <= it.
__device__ __forceinline__ int tensor_of(const Batch& b, int block) {
  int lo = 0, hi = b.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (b.block0[mid] <= block) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// (min, max) over the block's threads; every thread gets the result.
__device__ __forceinline__ void block_range(float& lo, float& hi) {
  __shared__ float s_lo[kThreads / 32], s_hi[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min_nan(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max_nan(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  lo = s_lo[0];
  hi = s_hi[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) {
    lo = min_nan(lo, s_lo[w]);
    hi = max_nan(hi, s_hi[w]);
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

__global__ void __launch_bounds__(kThreads)
fake_quant_range_kernel(const __grid_constant__ Batch b, float* lo_out,
                        float* hi_out) {
  const int t = tensor_of(b, blockIdx.x);
  const float* x = b.in[t];
  const long long n = b.n[t];
  const int j = blockIdx.x - b.block0[t];
  const long long stride = (long long)(b.block0[t + 1] - b.block0[t]) *
                           kThreads;
  const long long first = (long long)j * kThreads + threadIdx.x;
  float lo = __int_as_float(0x7f800000), hi = -lo;   // +inf, -inf
  long long done = 0;
  if (aligned16(x)) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const long long n4 = n / 4;
#pragma unroll 4
    for (long long i = first; i < n4; i += stride) {
      const float4 v = __ldg(x4 + i);
      lo = min_nan(min_nan(lo, v.x), min_nan(v.y, min_nan(v.z, v.w)));
      hi = max_nan(max_nan(hi, v.x), max_nan(v.y, max_nan(v.z, v.w)));
    }
    done = n4 * 4;
  }
  for (long long i = done + first; i < n; i += stride) {
    const float v = __ldg(x + i);
    lo = min_nan(lo, v);
    hi = max_nan(hi, v);
  }
  block_range(lo, hi);
  if (threadIdx.x == 0) {
    lo_out[blockIdx.x] = lo;
    hi_out[blockIdx.x] = hi;
  }
}

// torch.clamp(v, qmin, qmax), clamp_min and clamp_max on CUDA: NaN stays.
__device__ __forceinline__ float clamp_min_aten(float v, float m) {
  return v != v ? v : fmaxf(v, m);
}
__device__ __forceinline__ float clamp_max_aten(float v, float m) {
  return v != v ? v : fminf(v, m);
}
// torch.maximum on CUDA: the first NaN, else the larger.
__device__ __forceinline__ float maximum_aten(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// round(x / scale + zp) clamped, (q - zp) * scale, then x + (dq - x).
__device__ __forceinline__ float fake_quant(float x, float scale, float zp,
                                           float qmin, float qmax) {
  float q = rintf(__fadd_rn(__fdiv_rn(x, scale), zp));
  q = q != q ? q : fminf(fmaxf(q, qmin), qmax);
  const float dq = __fmul_rn(__fsub_rn(q, zp), scale);
  return __fadd_rn(x, __fsub_rn(dq, x));
}

__global__ void __launch_bounds__(kThreads)
fake_quant_apply_kernel(const __grid_constant__ Batch b, const float* lo_in,
                        const float* hi_in, float* out, float inv_range,
                        float qmin, float qmax, int symmetric) {
  const int t = tensor_of(b, blockIdx.x);
  const int p0 = b.block0[t];
  const int parts = b.block0[t + 1] - p0;
  float lo = __int_as_float(0x7f800000), hi = -lo;
  for (int i = threadIdx.x; i < parts; i += kThreads) {
    lo = min_nan(lo, lo_in[p0 + i]);
    hi = max_nan(hi, hi_in[p0 + i]);
  }
  block_range(lo, hi);
  // compute_scale_zp: amax / qmax (or (hi - lo) / (qmax - qmin)) by the
  // reciprocal, clamped to 1e-12; zp = round(qmin - lo / scale)
  float scale, zp;
  if (symmetric) {
    const float amax = maximum_aten(fabsf(lo), fabsf(hi));
    scale = clamp_min_aten(__fmul_rn(amax, inv_range), 1e-12f);
    zp = 0.0f;
  } else {
    lo = clamp_max_aten(lo, 0.0f);
    hi = clamp_min_aten(hi, 0.0f);
    scale = clamp_min_aten(__fmul_rn(__fsub_rn(hi, lo), inv_range), 1e-12f);
    zp = rintf(__fsub_rn(qmin, __fdiv_rn(lo, scale)));
  }

  const float* x = b.in[t];
  float* y = out + b.out_off[t];
  const long long n = b.n[t];
  const long long stride = (long long)parts * kThreads;
  const long long first = (long long)(blockIdx.x - p0) * kThreads +
                          threadIdx.x;
  long long done = 0;
  if (aligned16(x) && aligned16(y)) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* y4 = reinterpret_cast<float4*>(y);
    const long long n4 = n / 4;
#pragma unroll 4
    for (long long i = first; i < n4; i += stride) {
      float4 v = __ldg(x4 + i);
      v.x = fake_quant(v.x, scale, zp, qmin, qmax);
      v.y = fake_quant(v.y, scale, zp, qmin, qmax);
      v.z = fake_quant(v.z, scale, zp, qmin, qmax);
      v.w = fake_quant(v.w, scale, zp, qmin, qmax);
      y4[i] = v;
    }
    done = n4 * 4;
  }
  for (long long i = done + first; i < n; i += stride)
    y[i] = fake_quant(__ldg(x + i), scale, zp, qmin, qmax);
}

// The batch of `count` tensors; false when it does not fit a launch.
bool make_batch(Batch& b, const void* const* ins, const long long* ns,
                const long long* offs, int count) {
  if (count < 1 || count > kMaxTensors) return false;
  b.count = count;
  long long blocks = 0;
  for (int t = 0; t < count; ++t) {
    if (ns[t] < 1 || offs[t] % 4) return false;
    b.in[t] = static_cast<const float*>(ins[t]);
    b.n[t] = ns[t];
    b.out_off[t] = offs[t];
    b.block0[t] = static_cast<int>(blocks);
    blocks += blocks_of(ns[t]);
  }
  b.block0[count] = static_cast<int>(blocks);
  return true;
}

}  // namespace

extern "C" {

// Floats of scratch a call over tensors of sizes ns[0 .. count) needs (a
// min and a max for each block); 0 when the batch does not fit a launch.
long long fake_quant_scratch_floats(const long long* ns, int count) {
  if (count < 1 || count > kMaxTensors) return 0;
  long long blocks = 0;
  for (int t = 0; t < count; ++t) blocks += blocks_of(ns[t]);
  return 2 * blocks;
}

// Launch `phase` (0: ranges, 1: quantize) over `count` contiguous float32
// tensors ins[t] of ns[t] elements, tensor t written at out + offs[t]
// (offs a multiple of 4).  scratch holds fake_quant_scratch_floats(ns,
// count) floats; phase 1 reads what phase 0 wrote there.  `range` is qmax
// (symmetric) or qmax - qmin (affine), the integer ATen divides by.
int fake_quant_launch(int phase, const void* const* ins, const long long* ns,
                      const long long* offs, int count, float* out,
                      float* scratch, int range, int qmin, int qmax,
                      int symmetric, void* stream) {
  Batch b;
  if (!make_batch(b, ins, ns, offs, count) || range < 1 ||
      (phase != 0 && phase != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = b.block0[count];
  float* lo = scratch;
  float* hi = scratch + blocks;
  if (phase == 0) {
    fake_quant_range_kernel<<<blocks, kThreads, 0, s>>>(b, lo, hi);
  } else {
    // ATen divides a CUDA tensor by a Python number as a multiply by
    // the reciprocal, formed in float on the host
    const float inv_range = 1.0f / static_cast<float>(range);
    fake_quant_apply_kernel<<<blocks, kThreads, 0, s>>>(
        b, lo, hi, out, inv_range, static_cast<float>(qmin),
        static_cast<float>(qmax), symmetric);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fake_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
