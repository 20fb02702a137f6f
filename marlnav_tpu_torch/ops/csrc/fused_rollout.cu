// The whole random- or policy-mean rollout for Hopper: a group of lanes per
// env.
//
// Replaces marlnav_tpu/ops/fused_rollout.py:make_fused_rollout (the Pallas
// TPU kernel at fused_rollout.py:178, pallas_call at :312), the bench
// kernel.  For every env and each of T steps it computes, in registers:
//   obs features -> affine actor -> the action (Box-Muller sample, or the
//   policy mean with kMean) -> dynamics -> rewards and done ->
//   triangle reset draw and mask blend,
// and writes only the rewards (T, P) and the final row state.  No episode
// counters (fused_rollout.py:39-40).  The plain PyTorch version is
// ops/fused_rollout.py rollout_rows_reference; both perform the same
// float32 operations in the same order (-fmad=false), so they agree bit
// for bit.
//
// Random numbers: the collect kernel's Philox slots (env_step.cuh
// group_uniforms): key (seed, env), counter (step, draw group).  A
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
// Design: the collect kernel's lane groups (env_step.cuh) with kLanes = 4
// lanes an env: lane i steps agent i (its 6 geom calls, 4 actor rows,
// Box-Muller, dynamics, reward term and reset) and the fourth lane draws
// Philox groups with the others and repeats agent 2's step otherwise; the
// group's first lane writes the reward.  One thread per env (the first
// design) took 5.8 us a step at the bench's (16384, 500), latency-bound
// on one warp a scheduler.
// G kept: 4 (chip_smoke.py on an H100 80GB HBM3 at 700 W; PERF.md):
// 1.757 ms at (16384, 500), its path, against 2.547 ms with G = 8, which
// doubles the warps and has both lanes of an agent repeat the work they
// share.  G = 8 is faster at P = 1024 (1.56 against 2.11 ms at T = 1000),
// where latency rules.  Blocks of 128 threads (32 gave the same time).
// Past kMaxObs = 8 obstacles fused_rollout_rt_kernel<G, kMean> takes the
// step with O at run time and G = 4, 8, 16 or 32 lanes an env chosen at
// launch, as fused_collect.cu's run-time instance does.
// What the card showed (chip_smoke.py phase 7 and its sweep; H100 80GB
// HBM3 at 700 W; PERF.md §6 row 8): at the bench's P = 16384 the step
// behaves as issue-bound (2,048 warps at G = 4): each width from 4 to 32
// costs more,
// 3.50 against 5.14, 7.22 and 13.62 ms at O 9 sampled, because a wider
// group repeats its per-agent work on more lanes.  Spreading the
// O-dependent work over all 4 lanes (the spare fourth lane had repeated
// agent 2's) took the run-time instance from about 3.97, 5.85, 9.43 ms
// to 3.50, 4.77, 7.20 at O 9, 17, 32 sampled, 11-14% of its operations
// bound; the templated instances keep the spare lane.
#include <cuda_runtime.h>

#include <cstdint>

#include "env_step.cuh"

namespace marlnav {

constexpr int kLanes = 4;  // lanes an env

template <int O, bool kMean>
__global__ void __launch_bounds__(kMaxBlockThreads)
fused_rollout_kernel(Rows in, Rows out, const float* __restrict__ w,
                     const float* __restrict__ noise, uint32_t seed,
                     StepParams c, float* __restrict__ rew_out) {
  constexpr int F = Dims<O>::F;
  constexpr int G = kLanes;
  const int P = c.num_envs;
  const int n_draws = step_draws(O, c.noisy);

  // The actor operator: wa (4, F) row-major, then ca (4,).
  __shared__ float s_w[4 * F + 4];
  // Each group's uniforms for the current step.
  __shared__ float s_u[kMaxBlockThreads / G][Dims<O>::kDraws];
  for (int i = threadIdx.x; i < 4 * F + 4; i += blockDim.x) s_w[i] = w[i];
  __syncthreads();
  const float* wa = s_w;
  const float* ca = s_w + 4 * F;

  const Group<G> g(threadIdx.x);
  // A group past P steps env P - 1 again, so that it takes part in every
  // shuffle of its warp, and stores nothing.
  const int env = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) / G);
  const bool valid = env < P;
  const int p = valid ? env : P - 1;
  float* u = s_u[threadIdx.x / G];

  LaneState<O> e;
  e.load(in, P, p, g.agent, c);
  const uint2 key = make_uint2(seed, static_cast<uint32_t>(p));

  for (int t = 0; t < c.num_steps; ++t) {
    group_uniforms<G>(noise, n_draws, Dims<O>::kDraws, P, p, t, key,
                      g, u);
    float apx[kAgents], apy[kAgents];
#pragma unroll
    for (int j = 0; j < kAgents; ++j) {
      apx[j] = Group<G>::from_agent(e.px, j);
      apy[j] = Group<G>::from_agent(e.py, j);
    }
    float x[F];
    group_obs(e, g, apx, apy, c, x);
    const Action a =
        group_action<G, kMean, false>(g, wa, ca, x, u + 2 * g.agent, c);
    const StepOutcome s =
        group_advance(e, g, a.ang_raw, a.acc_raw, u + 2 * kAgents, c);
    if (valid && g.leader()) rew_out[static_cast<size_t>(t) * P + p] = s.reward;
  }
  if (valid) e.store(out, P, p, g);
}

// The run-time instance: c.num_obstacles > kMaxObs (env_step.cuh), G
// lanes an env (G = 4, 8, 16 or 32, chosen at launch: ops/fused_collect.py
// rt_lanes), as fused_collect_rt_kernel: the operator and each group's
// rows, obstacles, uniforms and heads in dynamic shared memory of
// rt_smem_floats, the work that grows with O spread over the G lanes.
template <int G, bool kMean>
__global__ void __launch_bounds__(kMaxBlockThreads, kRtMinBlocks)
fused_rollout_rt_kernel(Rows in, Rows out, const float* __restrict__ w,
                        const float* __restrict__ noise, uint32_t seed,
                        StepParams c, float* __restrict__ rew_out) {
  const int P = c.num_envs, o = c.num_obstacles, F = obs_width(o);
  const int n_draws = step_draws(o, c.noisy);

  extern __shared__ float s_dyn[];
  float* s_w = s_dyn;
  for (int i = threadIdx.x; i < 4 * F + 4; i += blockDim.x) s_w[i] = w[i];
  __syncthreads();
  const float* wa = s_w;
  const float* ca = s_w + 4 * F;

  const Group<G> g(threadIdx.x);
  const int env = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) / G);
  const bool valid = env < P;
  const int p = valid ? env : P - 1;

  float* xs = s_dyn + 4 * F + 4 +
              static_cast<int>(threadIdx.x / G) * rt_group_floats(o, c.noisy);
  float* u = xs + kAgents * F + 2 * o;
  float* heads = u + n_draws;
  RtLaneState<G> e;
  e.load(in, P, p, c, g, xs + kAgents * F, o);
  const uint2 key = make_uint2(seed, static_cast<uint32_t>(p));

  for (int t = 0; t < c.num_steps; ++t) {
    group_uniforms<G>(noise, n_draws, n_draws, P, p, t, key, g, u);
    group_obs_rt(e, c, xs);
    __syncwarp();
    const Action a =
        group_action_rt<G, kMean, false>(g, wa, ca, xs, F, u, heads, c);
    const StepOutcome s =
        group_advance(e, g, a.ang_raw, a.acc_raw, u + 2 * kAgents, c);
    if (valid && g.leader()) rew_out[static_cast<size_t>(t) * P + p] = s.reward;
  }
  if (valid) e.store(out, P, p, g);
}

// The run-time instance for `lanes` lanes an env and the mode, or null
// where it has none.
using RolloutRtKernel = void (*)(Rows, Rows, const float*, const float*,
                                 uint32_t, StepParams, float*);
template <bool kMean>
RolloutRtKernel rollout_rt_kernel(int lanes) {
  switch (lanes) {
    case 4: return fused_rollout_rt_kernel<4, kMean>;
    case 8: return fused_rollout_rt_kernel<8, kMean>;
    case 16: return fused_rollout_rt_kernel<16, kMean>;
    case 32: return fused_rollout_rt_kernel<32, kMean>;
    default: return nullptr;
  }
}
inline RolloutRtKernel rollout_rt_kernel(int lanes, bool mean) {
  return mean ? rollout_rt_kernel<true>(lanes) : rollout_rt_kernel<false>(lanes);
}

}  // namespace marlnav

extern "C" {

// Sizes the Python side checks before the first launch.
int marlnav_rollout_params_size() {
  return static_cast<int>(sizeof(marlnav::StepParams));
}
int marlnav_rollout_max_obstacles() { return marlnav::kMaxObs; }
int marlnav_rollout_lanes() { return marlnav::kLanes; }
// Bytes of dynamic shared memory of the run-time instance (num_obstacles
// > kMaxObs) at `lanes` lanes an env, for blocks of `threads`; -1 past
// what a block may take, or where no instance has `lanes`.
int marlnav_rollout_rt_smem(int num_obstacles, int noisy, int threads,
                            int lanes) {
  if (marlnav::rollout_rt_kernel(lanes, false) == nullptr) return -1;
  const long long bytes =
      4ll * marlnav::rt_smem_floats(num_obstacles, noisy, threads / lanes);
  return bytes > marlnav::kMaxBlockSmem ? -1 : static_cast<int>(bytes);
}

// Launch `blocks` blocks of `threads` threads (a multiple of 32, at most
// kMaxBlockThreads, blocks x threads >= lanes x num_envs; see
// ops/fused_collect.py launch_geometry), `lanes` an env (kLanes for the
// templated instances; 4, 8, 16 or 32 for the run-time one), on `stream`
// (a cudaStream_t from torch.cuda.current_stream()).  Returns
// cudaGetLastError() after the launch: 0 when it was accepted.
int marlnav_fused_rollout(const marlnav::Rows* in, const marlnav::Rows* out,
                          const float* w, const float* noise, uint32_t seed,
                          const marlnav::StepParams* params, int deterministic,
                          float* rew, int blocks, int threads, int lanes,
                          int device, void* stream) {
  const bool rt = params->num_obstacles > marlnav::kMaxObs;
  if (threads % 32 != 0 || threads < 32 ||
      threads > marlnav::kMaxBlockThreads || blocks < 1 ||
      (rt ? marlnav::rollout_rt_kernel(lanes, false) == nullptr
          : lanes != marlnav::kLanes) ||
      static_cast<long long>(blocks) * threads <
          static_cast<long long>(lanes) * params->num_envs)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MARLNAV_LAUNCH(O)                                                    \
  case O:                                                                   \
    if (deterministic)                                                      \
      marlnav::fused_rollout_kernel<O, true><<<blocks, threads, 0, s>>>(    \
          *in, *out, w, noise, seed, *params, rew);                         \
    else                                                                    \
      marlnav::fused_rollout_kernel<O, false><<<blocks, threads, 0, s>>>(   \
          *in, *out, w, noise, seed, *params, rew);                         \
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
    default: {
      const int smem = marlnav_rollout_rt_smem(params->num_obstacles,
                                               params->noisy, threads, lanes);
      if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
      auto* kernel = marlnav::rollout_rt_kernel(lanes, deterministic != 0);
      if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(cudaGetLastError());
      }
      kernel<<<blocks, threads, smem, s>>>(*in, *out, w, noise, seed, *params,
                                           rew);
    }
  }
#undef MARLNAV_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
