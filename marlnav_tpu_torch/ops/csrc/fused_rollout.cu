// The whole random- or policy-mean rollout for Hopper: one thread per env.
//
// Replaces marlnav_tpu/ops/fused_rollout.py:make_fused_rollout (the Pallas
// TPU kernel at fused_rollout.py:178, pallas_call at :312), the bench
// kernel.  For every env and each of T steps it computes, in registers:
//   obs features -> affine actor -> the action (Box-Muller sample, or the
//   policy mean with kDeterministic) -> dynamics -> rewards and done ->
//   triangle reset draw and mask blend,
// and writes only the rewards (T, P), one coalesced row a step, and the
// final row state.  No episode counters (fused_rollout.py:39-40).  The
// plain PyTorch version is ops/fused_rollout.py rollout_rows_reference;
// both perform the same float32 operations in the same order (-fmad=false).
//
// Random numbers: the collect kernel's Philox slots (env_step.cuh
// step_uniforms): key (seed, env), counter (step, draw group).  A
// stochastic rollout and a collect from the same seed, state and actor
// therefore give the same rewards and final state bit for bit.  The reset
// draws stay at slot 2A in the policy-mean mode too (fused_rollout.py:257).
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32 without tensor
// cores), default config (A=3, O=3, F=12), at the bench's headline
// (P, T) = (16384, 500):
//   bytes:  4 B of rewards an env-step = 32.8 MB, plus the row state in and
//           out (2 x 23 floats an env, 3 MB) -> 10.7 us.
//   operations: the collect kernel's ~1,830 float operations an env-step
//           less the log-probs and the done flag and counters: ~1,799
//           sampled, ~1,493 with the policy mean (chip_smoke.py
//           ROLLOUT_OPS_PER_ENV_STEP) -> 14.7 GFLOP -> 0.22 ms sampled.
//   Operations bound it.
// Design: simple and right first, as the collect kernel: one thread per env
// keeps the whole trajectory in registers, so the loop is latency-bound
// where P is small (P=1024 fills 8 blocks on 132 SMs).
#include <cuda_runtime.h>

#include <cstdint>

#include "env_step.cuh"

namespace marlnav {

constexpr int kThreads = 128;

template <int O, bool kDeterministic>
__global__ void __launch_bounds__(kThreads)
fused_rollout_kernel(Rows in, Rows out, const float* __restrict__ w,
                     const float* __restrict__ noise, uint32_t seed,
                     StepParams c, float* __restrict__ rew_out) {
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
  if (p >= P) return;
  EnvRegs<O> e;
  e.load(in, P, p);
  const uint2 key = make_uint2(seed, static_cast<uint32_t>(p));

  for (int t = 0; t < c.num_steps; ++t) {
    float u[Dims<O>::kDraws];
    step_uniforms<O>(noise, n_draws, P, p, t, key, u);

    float ang_raw[kAgents], acc_raw[kAgents];
#pragma unroll
    for (int i = 0; i < kAgents; ++i) {
      float x[F];
      agent_obs(e, i, c, x);
      if (kDeterministic) {
        ang_raw[i] = tanhf(affine_row(wa, ca[0], x));
        acc_raw[i] = tanhf(affine_row(wa + F, ca[1], x));
      } else {
        float z[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) z[k] = affine_row(wa + k * F, ca[k], x);
        const float mu0 = tanhf(z[0]), mu1 = tanhf(z[1]);
        const float v0 = softplus(z[2]), v1 = softplus(z[3]);
        float z0, z1;
        box_muller(u[2 * i], u[2 * i + 1], z0, z1);
        ang_raw[i] = mu0 + sqrtf(v0) * z0;
        acc_raw[i] = mu1 + sqrtf(v1) * z1;
      }
    }
    const StepOutcome s = advance(e, ang_raw, acc_raw, u + 2 * kAgents, c);
    rew_out[static_cast<size_t>(t) * P + p] = s.reward;
  }
  e.store(out, P, p);
}

}  // namespace marlnav

extern "C" {

// Sizes the Python side checks before the first launch.
int marlnav_rollout_params_size() {
  return static_cast<int>(sizeof(marlnav::StepParams));
}
int marlnav_rollout_max_obstacles() { return marlnav::kMaxObs; }

// Launch on `stream` (a cudaStream_t from torch.cuda.current_stream()).
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
int marlnav_fused_rollout(const marlnav::Rows* in, const marlnav::Rows* out,
                          const float* w, const float* noise, uint32_t seed,
                          const marlnav::StepParams* params, int deterministic,
                          float* rew, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks =
      (params->num_envs + marlnav::kThreads - 1) / marlnav::kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MARLNAV_LAUNCH(O)                                                    \
  case O:                                                                   \
    if (deterministic)                                                      \
      marlnav::fused_rollout_kernel<O, true>                                \
          <<<blocks, marlnav::kThreads, 0, s>>>(*in, *out, w, noise, seed,  \
                                                *params, rew);              \
    else                                                                    \
      marlnav::fused_rollout_kernel<O, false>                               \
          <<<blocks, marlnav::kThreads, 0, s>>>(*in, *out, w, noise, seed,  \
                                                *params, rew);              \
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
