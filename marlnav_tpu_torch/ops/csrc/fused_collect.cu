// Fused MAPPO training rollout (collect) for Hopper: one thread per env.
//
// Replaces marlnav_tpu/ops/fused_collect.py:make_fused_collect (the Pallas
// TPU kernel at fused_collect.py:167, pallas_call at :327).  For every env
// and each of T steps it computes, in registers:
//   obs features -> affine actor (tanh / softplus heads) -> Box-Muller
//   sample -> actions and log-probs -> dynamics -> rewards and done ->
//   episode counters -> triangle reset draw and mask blend,
// and writes the training buffer in the canonical layout:
//   obs (T, P, A, F), actions (T, P, A, 2), log_probs (T, P*A),
//   rewards (T, P), done (T, P) uint8, the final row state, and the three
//   episode counters as int32 (3,) (one block reduction + atomicAdd).
// The plain PyTorch version is ops/fused_collect.py collect_rows_reference;
// both perform the same float32 operations in the same order (the library
// is built with -fmad=false).  The step after the actions (dynamics,
// rewards, reset) is env_step.cuh's, shared with fused_rollout.cu.
//
// Random numbers: Philox4x32-10 keyed on (seed, env index) with counter
// (step, draw group, 0, 0); each draw group gives 4 uniforms.  Per step
// there are 2A + 2O (+ 3A with noisy_ags) draws: [0, 2A) actions, then
// obstacle x, obstacle y, then 3 per agent for the noisy reset.  With a
// `noise` tensor (T, n_draws, P) the kernel reads those uniforms instead.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32 without tensor
// cores), default config (A=3, O=3, F=12), per env-step:
//   bytes:  (36 + 6 + 3 + 1) float32 + 1 byte of output = 185 B;
//           P=1024, T=1000: 189 MB -> 57 us.
//   operations: ~1,830 float operations (chip_smoke.py OPS_PER_ENV_STEP
//           gives the count by part): 18 geom calls (sqrt, divide, the
//           8-term acos polynomial); 3 x (48 FMA of the actor operator +
//           tanh x2, softplus x2, log x2, sqrt x2); 3 Box-Muller pairs;
//           9 + 9 pair distances in the rewards; the reset blend.  Philox's
//           integer rounds are not counted.
//           1,024,000 env-steps -> ~1.87 GFLOP -> 28 us.
//   The larger, the bytes, bounds it: ~57 us at (1024, 1000).
// Design: simple and right first.  Known weaknesses, measured in PERF.md
// and left to a later redesign: at P=1024 one thread per env fills only 8
// blocks of 128 threads on a 132-SM card, so the 1000-step sequential loop
// is latency-bound; each thread stores its 36 obs floats contiguously, so
// a warp's stores are strided, not coalesced.
#include <cuda_runtime.h>

#include <cstdint>

#include "env_step.cuh"

namespace marlnav {

constexpr int kThreads = 128;

template <int O>
__global__ void __launch_bounds__(kThreads)
fused_collect_kernel(Rows in, Rows out, const float* __restrict__ w,
                     const float* __restrict__ noise, uint32_t seed,
                     StepParams c, float* __restrict__ obs_out,
                     float* __restrict__ act_out, float* __restrict__ lp_out,
                     float* __restrict__ rew_out, uint8_t* __restrict__ done_out,
                     int32_t* __restrict__ stats_out) {
  constexpr int F = Dims<O>::F;
  const int P = c.num_envs;
  const int n_draws = step_draws(O, c.noisy);

  // The actor operator: wa (4, F) row-major, then ca (4,).
  __shared__ float s_w[4 * F + 4];
  for (int i = threadIdx.x; i < 4 * F + 4; i += blockDim.x) s_w[i] = w[i];
  __syncthreads();
  const float* wa = s_w;
  const float* ca = s_w + 4 * F;

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int n_trunc = 0, n_col = 0, n_tar = 0;

  if (p < P) {
    EnvRegs<O> e;
    e.load(in, P, p);
    const uint2 key = make_uint2(seed, static_cast<uint32_t>(p));

    for (int t = 0; t < c.num_steps; ++t) {
      float u[Dims<O>::kDraws];
      step_uniforms<O>(noise, n_draws, P, p, t, key, u);

      // ---- observations (pre-step) and actions, one agent at a time ----
      const size_t tp = static_cast<size_t>(t) * P + p;
      float ang_raw[kAgents], acc_raw[kAgents];
#pragma unroll
      for (int i = 0; i < kAgents; ++i) {
        float x[F];
        agent_obs(e, i, c, x);
        // obs row (t, p, i, :) in the Observations concat order.
        float* o_row = obs_out + (tp * kAgents + i) * F;
#pragma unroll
        for (int f = 0; f < F; ++f) o_row[f] = x[f];

        float z[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) z[k] = affine_row(wa + k * F, ca[k], x);
        const float mu0 = tanhf(z[0]), mu1 = tanhf(z[1]);
        const float v0 = softplus(z[2]), v1 = softplus(z[3]);
        float z0, z1;
        box_muller(u[2 * i], u[2 * i + 1], z0, z1);
        ang_raw[i] = mu0 + sqrtf(v0) * z0;
        acc_raw[i] = mu1 + sqrtf(v1) * z1;
        // log p(a) with (a - mu)^2 / var == z^2 (DiagGaussian.log_prob).
        const float lp =
            -0.5f * ((((c.log2pi2 + logf(v0)) + logf(v1)) + z0 * z0) + z1 * z1);
        act_out[(tp * kAgents + i) * 2] = ang_raw[i];
        act_out[(tp * kAgents + i) * 2 + 1] = acc_raw[i];
        lp_out[tp * kAgents + i] = lp;
      }

      // ---- dynamics, rewards, done and the auto-reset (env_step.cuh) ----
      const StepOutcome s = advance(e, ang_raw, acc_raw, u + 2 * kAgents, c);
      rew_out[tp] = s.reward;
      done_out[tp] = s.finished > 0.5f ? 1 : 0;
      n_trunc += s.trunc > 0.5f;
      n_col += s.any_coll > 0.5f;
      n_tar += s.all_in_target > 0.5f;
    }
    e.store(out, P, p);
  }

  // ---- episode counters: one block reduction, then one atomicAdd each ----
  __shared__ int s_cnt[3][kThreads / 32];
  const unsigned full = 0xffffffffu;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    n_trunc += __shfl_down_sync(full, n_trunc, off);
    n_col += __shfl_down_sync(full, n_col, off);
    n_tar += __shfl_down_sync(full, n_tar, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_cnt[0][warp] = n_trunc;
    s_cnt[1][warp] = n_col;
    s_cnt[2][warp] = n_tar;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    int sum = 0;
    for (int k = 0; k < kThreads / 32; ++k) sum += s_cnt[threadIdx.x][k];
    if (sum) atomicAdd(stats_out + threadIdx.x, sum);
  }
}

}  // namespace marlnav

extern "C" {

// Sizes of the structs the Python side mirrors with ctypes; the wrapper
// checks them before the first launch.
int marlnav_collect_params_size() {
  return static_cast<int>(sizeof(marlnav::StepParams));
}
int marlnav_collect_max_obstacles() { return marlnav::kMaxObs; }

// Launch on `stream` (a cudaStream_t from torch.cuda.current_stream()).
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
int marlnav_fused_collect(const marlnav::Rows* in, const marlnav::Rows* out,
                          const float* w, const float* noise, uint32_t seed,
                          const marlnav::StepParams* params, float* obs,
                          float* act, float* lp, float* rew, uint8_t* done,
                          int32_t* stats, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks =
      (params->num_envs + marlnav::kThreads - 1) / marlnav::kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MARLNAV_LAUNCH(O)                                               \
  case O:                                                              \
    marlnav::fused_collect_kernel<O><<<blocks, marlnav::kThreads, 0, s>>>( \
        *in, *out, w, noise, seed, *params, obs, act, lp, rew, done, stats); \
    break;
  switch (params->num_obstacles) {
    MARLNAV_LAUNCH(1)
    MARLNAV_LAUNCH(2)
    MARLNAV_LAUNCH(3)
    MARLNAV_LAUNCH(4)
    MARLNAV_LAUNCH(5)
    MARLNAV_LAUNCH(6)
    MARLNAV_LAUNCH(7)
    MARLNAV_LAUNCH(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MARLNAV_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
