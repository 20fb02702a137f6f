// bf16 products on Hopper's tensor cores (--bf16-updates): one warp-level
// mma.sync.m16n8k16 with bf16 operands and float32 accumulators a product,
// in place of the three m16n8k8 TF32 passes of mma_tf32.cuh.  The operands
// stay float32 in shared memory and are rounded to bf16 (to nearest, ties
// to even: cvt.rn, as JAX's astype(bfloat16)) as each fragment is loaded,
// so neither storage order of an operand needs a transposed copy.  A
// product of two bf16 values is exact in float32, so what the tensor core
// adds to the float32 plain version of the same rounded operands is its
// own accumulation.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16), with g = lane / 4 and
// t = lane % 4; each register holds two bf16 values, the lower-indexed one
// in its low half:
//   A (16 x 16, row): a0 (g, 2t..2t+1), a1 (g + 8, 2t..2t+1),
//                     a2 (g, 2t+8..2t+9), a3 (g + 8, 2t+8..2t+9);
//   B (16 x 8, col):  b0 (2t..2t+1, g), b1 (2t+8..2t+9, g);
//   C (16 x 8):       as m16n8k8: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8,
//                     2t), c3 (g + 8, 2t + 1).
#pragma once

#include <cstdint>

namespace marlnav {
namespace mma {

// {lo, hi} rounded to bf16 and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// c += a b, one m16n8k16 bf16 product with float32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t b0,
                                         const uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of a 16 x 16 tile whose element (m, k) is s[m * ld + k].
__device__ __forceinline__ void load_a_rows_bf16(const float* s, int ld,
                                                 int lane, uint32_t (&a)[4]) {
  const int g = lane >> 2, t = lane & 3;
  const float* r0 = s + g * ld + 2 * t;
  const float* r1 = r0 + 8 * ld;
  a[0] = pack_bf16(r0[0], r0[1]);
  a[1] = pack_bf16(r1[0], r1[1]);
  a[2] = pack_bf16(r0[8], r0[9]);
  a[3] = pack_bf16(r1[8], r1[9]);
}

// A fragment of a 16 x 16 tile whose element (m, k) is s[k * ld + m].
__device__ __forceinline__ void load_a_cols_bf16(const float* s, int ld,
                                                 int lane, uint32_t (&a)[4]) {
  const int g = lane >> 2, t = lane & 3;
  const float* k0 = s + 2 * t * ld + g;
  const float* k8 = k0 + 8 * ld;
  a[0] = pack_bf16(k0[0], k0[ld]);
  a[1] = pack_bf16(k0[8], k0[ld + 8]);
  a[2] = pack_bf16(k8[0], k8[ld]);
  a[3] = pack_bf16(k8[8], k8[ld + 8]);
}

// B fragment of a 16 x 8 tile whose element (k, n) is s[k * ld + n].
__device__ __forceinline__ void load_b_rows_bf16(const float* s, int ld,
                                                 int lane, uint32_t (&b)[2]) {
  const int g = lane >> 2, t = lane & 3;
  const float* k0 = s + 2 * t * ld + g;
  const float* k8 = k0 + 8 * ld;
  b[0] = pack_bf16(k0[0], k0[ld]);
  b[1] = pack_bf16(k8[0], k8[ld]);
}

}  // namespace mma
}  // namespace marlnav
