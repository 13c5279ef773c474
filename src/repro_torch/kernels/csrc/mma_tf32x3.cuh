// Float32-accurate matrix products on Hopper's tensor cores (sm_90a): the
// 3xTF32 split, shared by window_attn.cu and ssd_scan.cu, and the cp.async
// helpers those two and quant_matmul.cu stage their tiles with.
//
// A float32 x is split into two TF32 values, hi = rna(x) and lo = rna(x -
// hi) (x - hi is exact in float32; rna rounds to 10 mantissa bits, ties
// away from zero).  A product a.b is then taken as three
// TF32 products on the tensor cores, lo.hi, hi.lo and hi.hi, accumulated in
// float32 with the small terms first; lo.lo (below 2^-22 of |a||b|) is
// dropped.  Each TF32 product of two 11-bit mantissas is exact, so what is
// left is the float32 rounding of the sums: the result agrees with a
// float32 product to ~1e-7 relative, where one TF32 product alone is off
// by ~1e-3 (tests/test_torch_tf32x3.py emulates both).  It costs three
// tensor-core products (3 x 1/495e12 s per operation on an H100) against
// the CUDA cores' one float32 FMA (1/67e12).
//
// The tensor cores add each step's products to the float32 accumulator
// without rounding to nearest (the sum drifts toward zero by up to an ulp
// a step), so a sum over many steps is taken in parts: each part in a
// zeroed fragment, the parts added in float32 (PERF.md has the drift).
//
// Fragments are those of mma.sync m16n8k8 .row.col f32.tf32.tf32.f32, with
// g = lane / 4 and t = lane % 4:
//   A (16 x 8, row m, column k): a0 (g, t), a1 (g+8, t), a2 (g, t+4),
//                                a3 (g+8, t+4);
//   B (8 x 8, row k, column n):  b0 (t, g), b1 (t+4, g);
//   C (16 x 8):                  c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
//                                c3 (g+8, 2t+1).
// A reduction does not care in which order its k are visited as long as A
// and B agree, so the kernels map the fragment's k = t to the tile's k =
// 2t and k = t+4 to 2t+1: a0/a2 and b0/b1 are then two
// neighbours of one row, read as one float2, and the accumulator's c0/c1
// are already a0/a2 of the next product (P.V in window_attn.cu).
//
// The inline PTX is confined to the functions under __CUDACC__ (one
// instruction each); a host compiler, as in the CPU rehearsal that runs a
// kernel with one std::thread per CUDA thread, supplies its own: the mma
// as a warp-collective product over the fragment layout above.

#pragma once

#include <cstdint>

namespace tf32x3 {

#ifdef __CUDACC__

// cvt.rna.tf32.f32: round to the nearest TF32 value (ties away from zero);
// the 13 low mantissa bits of the result are 0.  NaN stays NaN.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a b on one warp's m16n8k8 fragments.
__device__ __forceinline__ void mma_m16n8k8(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global to shared memory without passing through registers;
// zeros when !in (no byte is read then).  Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(gmem), "r"(in ? 16 : 0)
               : "memory");
}

// The same for 8 bytes, both addresses 8-byte aligned.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(s),
               "l"(gmem), "r"(in ? 8 : 0)
               : "memory");
}

// The same for one float, for rows that are not 16-byte aligned.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(gmem), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

#endif  // __CUDACC__

// The rounding of to_tf32 as an integer add and a mask: the same result
// for every input but a NaN (one whose payload carries into the sign bit,
// as the card's canonical 0x7fffffff does, becomes -0).  On sm_90 the cvt
// compiles to a NaN test beside this add and this mask, with a constant
// or a select (chip_variants.py prints both), this to the two alone.
__device__ __forceinline__ uint32_t to_tf32_non_nan(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32: hi = rna(x), lo = rna(x - hi).  hi takes the
// integer form (inf stays inf); a NaN x makes x - hi NaN whatever hi is,
// and the cvt keeps it in lo, so the products carry it on.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32_non_nan(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// The same split with the integer form for both halves, for an operand
// whose NaN reaches the result another way (window_attn's P: its NaN is
// in the row sum that divides the output).
__device__ __forceinline__ void split_non_nan(float x, uint32_t& hi,
                                              uint32_t& lo) {
  hi = to_tf32_non_nan(x);
  lo = to_tf32_non_nan(x - __uint_as_float(hi));
}

template <bool NonNan = false, int R>
__device__ __forceinline__ void split(const float (&x)[R], uint32_t (&hi)[R],
                                      uint32_t (&lo)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (NonNan)
      split_non_nan(x[r], hi[r], lo[r]);
    else
      split(x[r], hi[r], lo[r]);
  }
}

// d[n] += a b[n] for n < N at float32 accuracy: the small terms first,
// lo.lo dropped.  Three passes over the N independent accumulators, so
// that consecutive mma.sync do not wait on each other's result.
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N][4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[N][2],
                                     const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_m16n8k8(d[n], al, bh[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_m16n8k8(d[n], ah, bl[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_m16n8k8(d[n], ah, bh[n]);
}

}  // namespace tf32x3
