// The reverse recursions of the returns for Hopper: zero-at-done discounted
// returns and bootstrapped GAE(lambda) advantages, one thread an env column.
//
// Replaces marlnav_tpu/algo/mappo.py:96 discounted_returns and :134
// gae_advantages (XLA lax.scans, no Pallas kernel), which the JAX package's
// fused path runs in their associative forms (:184, :204).  Here the
// sequential order is kept on every path: it is the JAX package's reference
// order, and its associative forms differ from it by reassociation only.
// The plain PyTorch versions are ops/returns.py discounted_returns_reference
// and gae_advantages_reference; both perform the same operations in the same
// order (the library is built with -fmad=false), so they agree bit for bit:
//   discounted: c = done ? 0 : r + (gamma c)
//   GAE:        nd = 1 - done
//               delta = (r + (gamma next_value) nd) - v
//               gae = delta + (gamma_lam nd) gae,  next_value = v
// where gamma is rounded once to the accumulation type and gamma_lam is the
// double product gamma * lam rounded once (the plain loop's Python scalar
// arithmetic).  Two instances of each: float32, and float64 for
// --returns-f64, which reads the float32 rewards and values and accumulates
// and writes in double.
//
// Bound on an H100 SXM at (P, T) = (1024, 1000), discounted float32: bytes
// (4 + 1 + 4) T P = 9.2 MB -> 2.8 us at 3.35 TB/s; the carry's dependent
// chain, 3 operations a step (multiply, add, select) at ~4 cycles each,
// ~6 us at 1.98 GHz.  The chain bounds it: a column's steps are serial.
// Design: each thread walks its column from t = T - 1 down to 0, so a warp's
// loads at each t are one coalesced row segment.  The loads do not depend on
// the carry, so each thread keeps kStages - 1 chunks of kChunk steps in
// flight as 4-byte cp.async copies into its own slots of a ring in shared
// memory (no barrier: a thread reads only what it copied), and runs the
// chain on a chunk once it has landed, from registers.  A done flag is one
// byte: the thread copies the aligned 4-byte word that holds it (a word
// that holds a byte of a device allocation lies inside it) and picks the
// byte.
// Measured (chip_smoke.py phase 11, H100 80GB HBM3 at 700 W; PERF.md):
// 0.057 ms at (1024, 1000), 10% of the bound, and the same at P = 7, one
// warp: a step takes ~57 ns whatever P is, a latency of one warp's step
// rather than of the memory; which of its instructions is not profiled.
#include <cuda_runtime.h>

#include <cstdint>

namespace marlnav {
namespace returns {

constexpr int kThreads = 32;  // one warp a block: the columns are independent
constexpr int kChunk = 16;    // steps a chunk (one cp.async group)
constexpr int kStages = 6;    // chunks in a thread's ring

__device__ __forceinline__ void copy4(uint32_t* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most kStages - 1 of this thread's groups are in flight:
// with k + kStages groups committed, chunk k's has landed.
__device__ __forceinline__ void wait_oldest() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
}

// Arrays staged a step: rewards, the done word and, for GAE, values.
template <bool kGae>
struct Ring {
  static constexpr int kArrays = kGae ? 3 : 2;
  uint32_t w[kStages][kArrays][kChunk][kThreads];
};

template <typename Acc, bool kGae>
__global__ void __launch_bounds__(kThreads)
returns_kernel(const float* __restrict__ rewards,
               const uint8_t* __restrict__ done,
               const float* __restrict__ values,
               const float* __restrict__ last_value, int num_steps,
               int num_envs, double gamma, double gamma_lam,
               Acc* __restrict__ out) {
  __shared__ Ring<kGae> ring;
  const int lane = threadIdx.x;
  const int p = blockIdx.x * kThreads + lane;
  if (p >= num_envs) return;
  const int chunks = (num_steps + kChunk - 1) / kChunk;

  // Chunk k holds steps t = T - 1 - (k kChunk + j), j = 0 .. kChunk - 1.
  auto prefetch = [&](int k) {
    if (k < chunks) {
      const int slot = k % kStages;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int t = num_steps - 1 - (k * kChunk + j);
        if (t >= 0) {
          const size_t i = static_cast<size_t>(t) * num_envs + p;
          copy4(&ring.w[slot][0][j][lane], rewards + i);
          copy4(&ring.w[slot][1][j][lane],
                reinterpret_cast<const void*>(
                    reinterpret_cast<uintptr_t>(done + i) & ~uintptr_t{3}));
          if constexpr (kGae) copy4(&ring.w[slot][2][j][lane], values + i);
        }
      }
    }
    commit();  // an empty group past the last chunk keeps the count
  };

  const Acc g = static_cast<Acc>(gamma);
  const Acc gl = static_cast<Acc>(gamma_lam);
  Acc carry = Acc(0);  // the return, or the GAE advantage
  Acc next_value = kGae ? static_cast<Acc>(last_value[p]) : Acc(0);

  for (int k = 0; k < kStages - 1; ++k) prefetch(k);
  for (int k = 0; k < chunks; ++k) {
    prefetch(k + kStages - 1);  // into the slot chunk k - 1 left
    wait_oldest();           // chunk k has landed
    // The chunk's words into registers, then the chain.
    const int slot = k % kStages;
    uint32_t w[Ring<kGae>::kArrays][kChunk];
#pragma unroll
    for (int a = 0; a < Ring<kGae>::kArrays; ++a)
#pragma unroll
      for (int j = 0; j < kChunk; ++j) w[a][j] = ring.w[slot][a][j][lane];
    const int t0 = num_steps - 1 - k * kChunk;
    size_t i = static_cast<size_t>(t0) * num_envs + p;
#pragma unroll
    for (int j = 0; j < kChunk; ++j, i -= num_envs) {
      if (t0 - j < 0) continue;  // past step 0 in the last chunk
      const Acc r = static_cast<Acc>(__uint_as_float(w[0][j]));
      const uintptr_t byte = reinterpret_cast<uintptr_t>(done + i) & 3;
      const bool d = ((w[1][j] >> (8u * static_cast<unsigned>(byte))) &
                      0xffu) != 0;
      if constexpr (kGae) {
        const Acc v = static_cast<Acc>(__uint_as_float(w[2][j]));
        const Acc nd = Acc(1) - (d ? Acc(1) : Acc(0));
        const Acc delta = (r + (g * next_value) * nd) - v;
        carry = delta + (gl * nd) * carry;
        next_value = v;
      } else {
        carry = d ? Acc(0) : r + g * carry;
      }
      out[i] = carry;
    }
  }
}

template <typename Acc, bool kGae>
cudaError_t launch(const float* rewards, const uint8_t* done,
                   const float* values, const float* last_value, int num_steps,
                   int num_envs, double gamma, double gamma_lam, void* out,
                   cudaStream_t s) {
  const int blocks = (num_envs + kThreads - 1) / kThreads;
  returns_kernel<Acc, kGae><<<blocks, kThreads, 0, s>>>(
      rewards, done, values, last_value, num_steps, num_envs, gamma, gamma_lam,
      static_cast<Acc*>(out));
  return cudaGetLastError();
}

}  // namespace returns
}  // namespace marlnav

extern "C" {

// out (T, P), float32 (f64 = 0) or float64 (f64 = 1): the discounted
// returns (gae = 0; values and last_value unused) or the GAE advantages
// (gae = 1) of rewards (T, P) float32, done (T, P) bool, values (T, P) and
// last_value (P,) float32, on `stream` (a cudaStream_t from
// torch.cuda.current_stream()).  Returns cudaGetLastError() after the
// launch: 0 when it was accepted.
int marlnav_returns(const float* rewards, const uint8_t* done,
                    const float* values, const float* last_value,
                    int num_steps, int num_envs, double gamma,
                    double gamma_lam, int gae, int f64, void* out, int device,
                    void* stream) {
  using namespace marlnav::returns;
  if (num_steps < 1 || num_envs < 1 || (gae && (!values || !last_value)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    err = gae ? launch<double, true>(rewards, done, values, last_value,
                                     num_steps, num_envs, gamma, gamma_lam,
                                     out, s)
              : launch<double, false>(rewards, done, values, last_value,
                                      num_steps, num_envs, gamma, gamma_lam,
                                      out, s);
  else
    err = gae ? launch<float, true>(rewards, done, values, last_value,
                                    num_steps, num_envs, gamma, gamma_lam, out,
                                    s)
              : launch<float, false>(rewards, done, values, last_value,
                                     num_steps, num_envs, gamma, gamma_lam,
                                     out, s);
  return static_cast<int>(err);
}

}  // extern "C"
