// Float32 products on Hopper's tensor cores in 3xTF32, and the
// asynchronous copies that feed the port's hand-written kernels (cp.async,
// and bulk copies on mbarriers), at the end.  The products: warp-level
// mma.sync.m16n8k8 with TF32 operands and
// float32 accumulators, each float32 operand x split into two TF32 halves
//   big = cvt.rna.tf32(x),  small = cvt.rna.tf32(x - big),
// and each product taken as small*big + big*small + big*big.  The one
// dropped term, small*small, is below float32's last bit, so the three
// passes keep float32's accuracy where one TF32 pass keeps about three
// decimal digits.  The tensor core ignores -fmad=false: these products
// round as the tensor core does, every other operation as written.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32), with g = lane / 4 (the
// group) and t = lane % 4 (the thread in the group):
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                    a3 (g + 8, t + 4);
//   B (8 x 8, col):  b0 (t, g), b1 (t + 4, g);
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                    c3 (g + 8, 2t + 1).
// The loaders below read a fragment from shared memory in either storage
// order of its matrix, so a product and its transpose need no copy.
//
// mma.sync rather than wgmma: wgmma takes TF32 operands only K-major from
// shared memory, so a backward product (a sum over rows) would need
// transposed copies of its operands; mma.sync fragments load from any
// layout.  Warp specialisation (forward and backward warps on a ring of
// chunks that the backward warps refill) runs the float32 critic's narrow
// float64 instances (fused_update.cu tc_pipelined); wgmma is later work.
#pragma once

#include <cstdint>

namespace marlnav {
namespace mma {

__device__ __forceinline__ uint32_t tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, each a TF32 value.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_round(x);
  small = tf32_round(x - __uint_as_float(big));
}

template <int K>
__device__ __forceinline__ void split(const float (&x)[K], uint32_t (&big)[K],
                                      uint32_t (&small)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) split(x[i], big[i], small[i]);
}

// c += a b, one m16n8k8 TF32 product.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t b0,
                                         const uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: the two cross terms first, then big * big.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(c, a_small, b_big[0], b_big[1]);
  mma_tf32(c, a_big, b_small[0], b_small[1]);
  mma_tf32(c, a_big, b_big[0], b_big[1]);
}

// A fragment of a 16 x 8 tile whose element (m, k) is s[m * ld + k].
__device__ __forceinline__ void load_a_rows(const float* s, int ld, int lane,
                                            float (&a)[4]) {
  const int g = lane >> 2, t = lane & 3;
  a[0] = s[g * ld + t];
  a[1] = s[(g + 8) * ld + t];
  a[2] = s[g * ld + t + 4];
  a[3] = s[(g + 8) * ld + t + 4];
}

// A fragment of a 16 x 8 tile whose element (m, k) is s[k * ld + m].
__device__ __forceinline__ void load_a_cols(const float* s, int ld, int lane,
                                            float (&a)[4]) {
  const int g = lane >> 2, t = lane & 3;
  a[0] = s[t * ld + g];
  a[1] = s[t * ld + g + 8];
  a[2] = s[(t + 4) * ld + g];
  a[3] = s[(t + 4) * ld + g + 8];
}

// B fragment of an 8 x 8 tile whose element (k, n) is s[k * ld + n].
__device__ __forceinline__ void load_b_rows(const float* s, int ld, int lane,
                                            float (&b)[2]) {
  const int g = lane >> 2, t = lane & 3;
  b[0] = s[t * ld + g];
  b[1] = s[(t + 4) * ld + g];
}

// Asynchronous copies from device to shared memory (cp.async): 4 or 16
// bytes a thread, completed in groups.  After wait_group, a __syncwarp or
// __syncthreads makes one thread's copies visible to the others.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

// As cp_async4 / cp_async16, and 8 bytes, but zeros land in place of the
// source where !valid (no source byte is read then; src need only be
// mapped).
__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src,
                                                bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8_zfill(float* dst, const float* src,
                                                bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src,
                                                 bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
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

// Bulk copies from device to shared memory by the tensor memory
// accelerator (cp.async.bulk): one thread starts a copy of a multiple of
// 16 bytes between 16-byte aligned addresses, which completes on an
// mbarrier in shared memory that expects its bytes.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive on bar, whose phase then also waits for `bytes` of bulk copies.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Arrive on bar (its count includes this thread).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrive on bar once this thread's earlier cp.async copies have landed (its
// count includes this thread).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the phase of bar with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// As mbar_wait, but a waiting thread is suspended until the phase completes
// (or a time limit, the hint of 10 ms, passes) rather than spinning, so
// that waiting warps leave the issue slots to the warps at work.
__device__ __forceinline__ void mbar_wait_suspended(uint64_t* bar,
                                                    unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity), "r"(10000000u)
        : "memory");
  } while (!done);
}

// A barrier of the block's first N threads (named barrier 1), where warps
// of different roles meet at different points of the code.
template <int N>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(N) : "memory");
}

// Order the block's earlier shared-memory reads (after a barrier) before
// this thread's next bulk copies into the same memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace mma
}  // namespace marlnav
