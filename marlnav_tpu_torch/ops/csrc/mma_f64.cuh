// Float64 products on Hopper's tensor cores (DMMA): the gradient kernels'
// forward where its instance's registers allow (TcShape::kFloat64).  A
// product of two float32 values is exact in float64, and the sums run in
// float64, so a pre-activation comes out as float64 would compute it and is
// rounded to float32 once: no row takes the other side of the ReLU's kink
// than the float64 plain version does, and the heads' sums start from
// values as exact as float32 holds.  (The 3xTF32 split keeps each operand to
// 2^-22 of itself, not float32's 2^-24, and the tensor core's float32 sums
// are not rounded to nearest: a row near a kink or a clip edge took the
// other side often enough that its whole gradient showed in the sums.)
//
// mma.sync.m16n8k8 .f64 (sm_90; twice the rate of m8n8k4 on an H100),
// one float64 a register, in the element layout of mma_tf32.cuh's m16n8k8
// TF32 fragments: with g = lane / 4 and t = lane % 4,
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                    a3 (g + 8, t + 4);
//   B (8 x 8, col):  b0 (t, g), b1 (t + 4, g);
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                    c3 (g + 8, 2t + 1).
#pragma once

namespace marlnav {
namespace mma {

// c += a b, one m16n8k8 float64 product.
__device__ __forceinline__ void mma_f64(double (&c)[4], const double (&a)[4],
                                        double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

}  // namespace mma
}  // namespace marlnav
