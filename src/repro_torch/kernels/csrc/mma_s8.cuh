// Exact int8 matrix products on Hopper's tensor cores (sm_90a): the
// mma.sync m16n8k32 .row.col s32.s8.s8.s32 product of quant_matmul.cu.
//
// Each product of two int8 values is exact in int32 and so is their sum
// while |sum| < 2^31 (K * 128 * 128 < 2^31 for K up to 131072), whatever
// the order: unlike the TF32 products of mma_tf32x3.cuh, nothing rounds.
//
// Fragments, with g = lane / 4 and t = lane % 4, each register four int8
// values of consecutive k (the lowest k in the lowest byte):
//   A (16 x 32, row m, column k): a0 row g, k 4t..4t+3; a1 row g+8, the
//                                 same k; a2 row g, k 4t+16..4t+19;
//                                 a3 row g+8, k 4t+16..4t+19;
//   B (32 x 8, row k, column n):  b0 k 4t..4t+3 of column g;
//                                 b1 k 4t+16..4t+19 of column g;
//   C (16 x 8, int32):            c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
//                                 c3 (g+8, 2t+1)
// (CUTLASS's SM80_16x8x32_S32S8S8S32_TN traits: A (T32, V16) -> (m, k)
// with strides ((64, 1), (16, 8, 256)) over m + 16 k, B ((32, 1), (8,
// 128)) over n + 8 k, C SM80_16x8_Row).  A reduction does not care in
// which order its k are visited as long as A and B agree, so
// quant_matmul.cu maps fragment k 4t..4t+3 to the tile's k 16t..16t+3
// and 4t+16..4t+19 to 16t+4..16t+7 (the second k32 product: 16t+8 on): one
// 16-byte shared load of a K-contiguous B row feeds b0/b1 of both
// products, and the codes are stored so that one 16-byte load is a whole
// A fragment (tests/test_torch_qmm_design.py emulates the layout and that
// permutation).
//
// The inline PTX is confined to the function under __CUDACC__; a host
// compiler, as in the CPU rehearsal that runs a kernel with one
// std::thread per CUDA thread, supplies its own: the mma as a
// warp-collective product over the layout above, summed in int32.

#pragma once

#include <cstdint>

namespace s8 {

#ifdef __CUDACC__

// d += a b on one warp's m16n8k32 fragments.
__device__ __forceinline__ void mma_m16n8k32(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

#endif  // __CUDACC__

}  // namespace s8
