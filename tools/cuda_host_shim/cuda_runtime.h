// Host shim: runs a CUDA source's kernels on the CPU, one std::thread per
// CUDA thread, blocks one at a time (a cooperative launch: all its blocks
// at once, with a grid barrier); warp collectives through per-warp buffers
// and 32-thread barriers.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <memory>
#include <thread>
#include <type_traits>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__ static
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3s { unsigned x, y, z; };
inline thread_local uint3s threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) uint2 { uint32_t x, y; };
struct alignas(16) uint4 { uint32_t x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaErrorNotSupported = 801;
constexpr int cudaErrorCooperativeLaunchTooLarge = 720;
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
// a small card: SHIM_SMS multiprocessors, one block each, so that a
// cooperative grid is a few blocks and a block takes several slices
constexpr int SHIM_SMS = 3;
enum cudaDeviceAttr { cudaDevAttrCooperativeLaunch, cudaDevAttrMultiProcessorCount };
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMultiProcessorCount ? SHIM_SMS : 1;
  return 0;
}
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return 0;
}
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* device) { *device = 0; return 0; }
inline const char* cudaGetErrorString(int) { return "shim error"; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline long long min(long long a, long long b) { return a < b ? a : b; }
inline long long max(long long a, long long b) { return a > b ? a : b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
inline float __int_as_float(int32_t i) { float f; std::memcpy(&f, &i, 4); return f; }
inline int __popc(uint32_t x) { return __builtin_popcount(x); }
inline unsigned __umulhi(unsigned a, unsigned b) { return (unsigned)(((uint64_t)a * b) >> 32); }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline int atomicAdd(int32_t* a, int32_t v) { return __atomic_fetch_add(a, v, __ATOMIC_RELAXED); }
inline uint32_t atomicOr(uint32_t* a, uint32_t v) { return __atomic_fetch_or(a, v, __ATOMIC_RELAXED); }
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcg(const T* p) { return __atomic_load_n(p, __ATOMIC_RELAXED); }
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {   // prmt
  const uint64_t v = (uint64_t)y << 32 | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}

struct ShimBlock {
  std::unique_ptr<std::barrier<>> block_bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
  std::vector<float> shfl;            // [warp][32]
  std::vector<uint32_t> vote;         // [warp][32]
  std::vector<uint32_t> fa, fb;       // [warp][32][4], [warp][32][2]
  std::vector<char> dyn;
};
inline thread_local ShimBlock* g_block = nullptr;   // the thread's block
inline void __syncthreads() { g_block->block_bar->arrive_and_wait(); }
inline void warp_sync() { g_block->warp_bars[threadIdx.x / 32]->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { warp_sync(); }
inline uint32_t __ballot_sync(unsigned, int pred) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint32_t* buf = &g_block->vote[warp * 32];
  buf[lane] = pred ? 1u << lane : 0u;
  warp_sync();
  uint32_t r = 0;
  for (int i = 0; i < 32; ++i) r |= buf[i];
  warp_sync();
  return r;
}
inline int __all_sync(unsigned m, int pred) { return __ballot_sync(m, pred) == 0xffffffffu; }
// a 4-byte value through the warp's vote buffer
template <class T> inline T shim_shfl(T v, int src) {
  static_assert(sizeof(T) == 4, "4-byte shuffles only");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint32_t* buf = &g_block->vote[warp * 32];
  std::memcpy(&buf[lane], &v, 4);
  warp_sync();
  T r;
  std::memcpy(&r, &buf[src], 4);
  warp_sync();
  return r;
}
inline int __shfl_sync(unsigned, int v, int src) { return shim_shfl(v, src % 32); }
inline int __shfl_xor_sync(unsigned, int v, int m) { return shim_shfl(v, (threadIdx.x % 32) ^ m); }
inline float __shfl_down_sync(unsigned, float v, int d, int w = 32) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* buf = &g_block->shfl[warp * 32];
  buf[lane] = v;
  warp_sync();
  const float r = lane % w + d < w ? buf[lane + d] : v;
  warp_sync();
  return r;
}
inline float __shfl_xor_sync(unsigned, float v, int m, int w = 32) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* buf = &g_block->shfl[warp * 32];
  buf[lane] = v;
  warp_sync();
  const int src = (lane & ~(w - 1)) | ((lane ^ m) & (w - 1));
  const float r = buf[src];
  warp_sync();
  return r;
}

namespace tf32x3 {
inline uint32_t to_tf32(float x) {   // cvt.rna.tf32.f32
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7f800000u) == 0x7f800000u) return u;   // inf, NaN
  return (u + 0x1000u) & 0xffffe000u;
}
inline void mma_m16n8k8(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint32_t* A = &g_block->fa[warp * 128];
  uint32_t* B = &g_block->fb[warp * 64];
  for (int i = 0; i < 4; ++i) A[lane * 4 + i] = a[i];
  for (int i = 0; i < 2; ++i) B[lane * 2 + i] = b[i];
  warp_sync();
  auto Aat = [&](int m, int k) {   // a0 (g,t) a1 (g+8,t) a2 (g,t+4) a3 (g+8,t+4)
    const int g = m % 8, t = k % 4;
    const int idx = (m >= 8 ? 1 : 0) + (k >= 4 ? 2 : 0);
    return __uint_as_float(A[(g * 4 + t) * 4 + idx]);
  };
  auto Bat = [&](int k, int n) {   // b0 (t, g) b1 (t+4, g)
    return __uint_as_float(B[(n * 4 + k % 4) * 2 + (k >= 4 ? 1 : 0)]);
  };
  const int g = lane / 4, t = lane % 4;
  float out[4];
  for (int e = 0; e < 4; ++e) {
    const int m = g + (e >= 2 ? 8 : 0), n = 2 * t + (e & 1);
    double s = d[e];
    for (int k = 0; k < 8; ++k) s += (double)Aat(m, k) * (double)Bat(k, n);
    out[e] = (float)s;
  }
  warp_sync();
  for (int e = 0; e < 4; ++e) d[e] = out[e];
}
inline void cp_async16(void* s, const void* g, bool in) {
  if (in) std::memcpy(s, g, 16); else std::memset(s, 0, 16);
}
inline void cp_async8(void* s, const void* g, bool in) {
  if (in) std::memcpy(s, g, 8); else std::memset(s, 0, 8);
}
inline void cp_async4(void* s, const void* g, bool in) {
  if (in) std::memcpy(s, g, 4); else std::memset(s, 0, 4);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
}  // namespace tf32x3

namespace s8 {
// mma.sync m16n8k32 s32.s8.s8.s32 as a warp collective over the layout of
// mma_s8.cuh, summed exactly in 64 bits (the card's int32 sum is exact
// while it stays below 2^31)
inline void mma_m16n8k32(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint32_t* A = &g_block->fa[warp * 128];
  uint32_t* B = &g_block->fb[warp * 64];
  for (int i = 0; i < 4; ++i) A[lane * 4 + i] = a[i];
  for (int i = 0; i < 2; ++i) B[lane * 2 + i] = b[i];
  warp_sync();
  auto byte = [](uint32_t w, int k) { return (int)(int8_t)(w >> (8 * (k % 4))); };
  auto Aat = [&](int m, int k) {   // a0 (g, 4t..) a1 (g+8, 4t..) a2 (g, 4t+16..) a3 (g+8, 4t+16..)
    const int lane_of = (m % 8) * 4 + (k % 16) / 4;
    return byte(A[lane_of * 4 + (m >= 8 ? 1 : 0) + (k >= 16 ? 2 : 0)], k);
  };
  auto Bat = [&](int k, int n) {   // b0 (4t.., g) b1 (4t+16.., g)
    return byte(B[(n * 4 + (k % 16) / 4) * 2 + (k >= 16 ? 1 : 0)], k);
  };
  const int g = lane / 4, t = lane % 4;
  int out[4];
  for (int e = 0; e < 4; ++e) {
    const int m = g + (e >= 2 ? 8 : 0), n = 2 * t + (e & 1);
    int64_t s = d[e];
    for (int k = 0; k < 32; ++k) s += (int64_t)Aat(m, k) * Bat(k, n);
    out[e] = (int)s;
  }
  warp_sync();
  for (int e = 0; e < 4; ++e) d[e] = out[e];
}
}  // namespace s8

inline void shim_block_init(ShimBlock& sb, int n, size_t smem) {
  sb.block_bar = std::make_unique<std::barrier<>>(n);
  for (int w = 0; w < (n + 31) / 32; ++w)
    sb.warp_bars.push_back(std::make_unique<std::barrier<>>(std::min(32, n - 32 * w)));
  sb.shfl.resize(n + 32);
  sb.vote.resize(n + 32);
  sb.fa.resize((n / 32 + 1) * 128);
  sb.fb.resize((n / 32 + 1) * 64);
  sb.dyn.resize(smem);
  {  // unwritten shared memory reads as NaN
    float nan = std::numeric_limits<float>::quiet_NaN();
    for (size_t i = 0; i + 4 <= sb.dyn.size(); i += 4) std::memcpy(&sb.dyn[i], &nan, 4);
  }
}

template <class F>
void shim_launch(dim3 grid, dim3 block, size_t smem, F fn) {
  const int n = block.x * block.y * block.z;
  ShimBlock sb;
  shim_block_init(sb, n, smem);
  std::vector<std::thread> ths;
  for (int i = 0; i < n; ++i)
    ths.emplace_back([&, i] {
      g_block = &sb;
      threadIdx = {(unsigned)i, 0, 0};
      blockDim = block;
      gridDim = grid;
      for (unsigned z = 0; z < grid.z; ++z)
        for (unsigned y = 0; y < grid.y; ++y)
          for (unsigned x = 0; x < grid.x; ++x) {
            blockIdx = {x, y, z};
            fn();
            sb.block_bar->arrive_and_wait();
          }
    });
  for (auto& t : ths) t.join();
}

// A cooperative launch: every block of the (1-D) grid at once, each thread
// of each block a std::thread, cooperative_groups::this_grid().sync() a
// barrier of them all.  The last such launch's block count is read by name
// (rehearse.py prints it).
inline std::barrier<>* g_grid_bar = nullptr;
extern "C" {
inline unsigned shim_cooperative_grid = 0;
}

template <class... A, size_t... I>
void shim_call(void (*f)(A...), void** args, std::index_sequence<I...>) {
  f(*static_cast<std::remove_reference_t<A>*>(args[I])...);
}

template <class... A>
int cudaLaunchCooperativeKernel(void (*f)(A...), dim3 grid, dim3 block, void** args,
                                size_t smem, cudaStream_t) {
  const int n = block.x * block.y * block.z;
  std::vector<ShimBlock> blocks(grid.x);
  for (auto& sb : blocks) shim_block_init(sb, n, smem);
  std::barrier<> grid_bar(n * grid.x);
  g_grid_bar = &grid_bar;
  shim_cooperative_grid = grid.x;
  std::vector<std::thread> ths;
  for (unsigned b = 0; b < grid.x; ++b)
    for (int i = 0; i < n; ++i)
      ths.emplace_back([&, b, i] {
        g_block = &blocks[b];
        threadIdx = {(unsigned)i, 0, 0};
        blockIdx = {b, 0, 0};
        blockDim = block;
        gridDim = grid;
        shim_call(f, args, std::index_sequence_for<A...>{});
      });
  for (auto& t : ths) t.join();
  g_grid_bar = nullptr;
  return 0;
}
