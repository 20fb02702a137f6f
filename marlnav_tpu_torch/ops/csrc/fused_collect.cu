// Fused MAPPO training rollout (collect) for Hopper: a group of lanes per
// env.
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
// is built with -fmad=false), so they agree bit for bit.  The step is
// env_step.cuh's, shared with fused_rollout.cu.
//
// Random numbers: Philox4x32-10 keyed on (seed, env index) with counter
// (step, draw group, 0, 0); each draw group gives 4 uniforms.  The seed is
// read from device memory (one int32, taken as its 32 bits), so a CUDA
// graph that holds a launch draws a new stream when the seed is rewritten
// between replays.  Per step
// there are 2A + 2O (+ 3A with noisy_ags) draws: [0, 2A) actions, then
// obstacle x, obstacle y, then 3 per agent for the noisy reset.  With a
// `noise` tensor (T, n_draws, P) the kernel reads those uniforms instead.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32 without tensor
// cores), default config (A=3, O=3, F=12), per env-step:
//   bytes:  (36 + 6 + 3 + 1) float32 + 1 byte of output = 185 B;
//           P=1024, T=1000: 189 MB -> 57 us.
//   operations: ~1,830 float operations (chip_smoke.py OPS_PER_ENV_STEP
//           gives the count by part); Philox's integer rounds are not
//           counted.  1,024,000 env-steps -> ~1.87 GFLOP -> 28 us.
//   The larger, the bytes, bounds it: ~57 us at (1024, 1000).
// Design: lane groups (env_step.cuh).  The T steps of one env are a
// dependent chain of ~3,000 instructions a step, so one thread per env (the
// first design) left 4 warps an SM at any P and took 6.55 us a step at
// (1024, 1000): latency-bound.  Here each env takes kLanes = 8 lanes of
// one warp.  Agent i's two lanes split its 6 geom calls and its 4 actor
// rows (one action component each) and share the rest of its step; the
// Philox groups spread over the group; shuffles carry positions, the two
// lanes' halves and the reward terms.  Agent i's obs row goes out as three
// float4 stores (float2 where F % 4 != 0) taken in turn by its two lanes,
// so a warp's store covers whole rows; its first lane writes the action
// pair and log-prob, the group's first lane the reward, done and counters.
// G kept: 8 (chip_smoke.py on an H100 80GB HBM3 at 700 W; PERF.md):
// 1.70 ms at (1024, 1000), its path, against 2.35 ms with G = 4, one lane
// an agent.  G = 4 is faster at P = 16384 (0.79 against 1.12 ms at T =
// 200), where its fewer warp-instructions count more than latency.
// Blocks of 128 threads (32 gave the same time at P = 1024).
// Past kMaxObs = 8 obstacles (the templated instances' limit) the wrapper
// launches fused_collect_rt_kernel: the same step with the obstacles, the
// agents' observation rows and the uniforms in dynamic shared memory, O at
// run time (env_step.cuh), in blocks of 128, 64 or 32 threads, the most
// whose groups fit (ops/fused_collect.py block_threads).  It equals its
// plain version bit for bit as the templated instances do.
// What limits it now, not profiled per instruction: at P = 1024 the grid
// is 256 warps, about 2 an SM, so the step's chain (~1.7 us) is most
// likely still latency-bound, at 3% of the bytes bound; more envs a
// launch or fewer instructions on the chain would move it.
#include <cuda_runtime.h>

#include <cstdint>

#include "env_step.cuh"

namespace marlnav {

constexpr int kLanes = 8;  // lanes an env

// The episode counters of a block: one block reduction, then one atomicAdd
// each.  Only each group's first lane counts, once per env.
__device__ __forceinline__ void add_episode_counts(int n_trunc, int n_col,
                                                   int n_tar,
                                                   int32_t* stats_out) {
  __shared__ int s_cnt[3][kMaxBlockThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    n_trunc += __shfl_down_sync(kFullMask, n_trunc, off);
    n_col += __shfl_down_sync(kFullMask, n_col, off);
    n_tar += __shfl_down_sync(kFullMask, n_tar, off);
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
    for (int k = 0; k < static_cast<int>(blockDim.x / 32); ++k)
      sum += s_cnt[threadIdx.x][k];
    if (sum) atomicAdd(stats_out + threadIdx.x, sum);
  }
}

template <int O>
__global__ void __launch_bounds__(kMaxBlockThreads)
fused_collect_kernel(Rows in, Rows out, const float* __restrict__ w,
                     const float* __restrict__ noise,
                     const int32_t* __restrict__ seed, StepParams c, float* __restrict__ obs_out,
                     float* __restrict__ act_out, float* __restrict__ lp_out,
                     float* __restrict__ rew_out, uint8_t* __restrict__ done_out,
                     int32_t* __restrict__ stats_out) {
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
  int n_trunc = 0, n_col = 0, n_tar = 0;

  LaneState<O> e;
  e.load(in, P, p, g.agent, c);
  const uint2 key =
      make_uint2(static_cast<uint32_t>(*seed), static_cast<uint32_t>(p));

  for (int t = 0; t < c.num_steps; ++t) {
    group_uniforms<G>(noise, n_draws, Dims<O>::kDraws, P, p, t, key,
                      g, u);

    // ---- observations (pre-step) and the action of the lane's agent ----
    float apx[kAgents], apy[kAgents];
#pragma unroll
    for (int j = 0; j < kAgents; ++j) {
      apx[j] = Group<G>::from_agent(e.px, j);
      apy[j] = Group<G>::from_agent(e.py, j);
    }
    float x[F];
    group_obs(e, g, apx, apy, c, x);
    const size_t tp = static_cast<size_t>(t) * P + p;
    const size_t row = tp * kAgents + g.agent;  // (t, p, agent)
    if (valid && g.agent_lane()) store_obs_row(g, obs_out + row * F, x);
    const Action a =
        group_action<G, false, true>(g, wa, ca, x, u + 2 * g.agent, c);
    if (valid && g.owner()) {
      reinterpret_cast<float2*>(act_out)[row] =
          make_float2(a.ang_raw, a.acc_raw);
      lp_out[row] = a.log_prob;
    }

    // ---- dynamics, rewards, done and the auto-reset (env_step.cuh) ----
    const StepOutcome s =
        group_advance(e, g, a.ang_raw, a.acc_raw, u + 2 * kAgents, c);
    if (valid && g.leader()) {
      rew_out[tp] = s.reward;
      done_out[tp] = s.finished > 0.5f ? 1 : 0;
      n_trunc += s.trunc > 0.5f;
      n_col += s.any_coll > 0.5f;
      n_tar += s.all_in_target > 0.5f;
    }
  }
  if (valid) e.store(out, P, p, g);

  add_episode_counts(n_trunc, n_col, n_tar, stats_out);
}

// The run-time instance: c.num_obstacles > kMaxObs (env_step.cuh).  The
// actor operator and each group's observation rows, obstacles and
// uniforms are dynamic shared memory of rt_smem_floats; the step is the
// templated kernel's, with RtLaneState, group_obs_rt and RtRow in place of
// the register arrays.
__global__ void __launch_bounds__(kMaxBlockThreads)
fused_collect_rt_kernel(Rows in, Rows out, const float* __restrict__ w,
                        const float* __restrict__ noise,
                        const int32_t* __restrict__ seed, StepParams c,
                        float* __restrict__ obs_out,
                        float* __restrict__ act_out,
                        float* __restrict__ lp_out,
                        float* __restrict__ rew_out,
                        uint8_t* __restrict__ done_out,
                        int32_t* __restrict__ stats_out) {
  constexpr int G = kLanes;
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
  int n_trunc = 0, n_col = 0, n_tar = 0;

  // The group's region: its agents' rows (A, F), obstacles, uniforms.
  float* xs = s_dyn + 4 * F + 4 +
              static_cast<int>(threadIdx.x / G) * rt_group_floats(o, c.noisy);
  RtLaneState e;
  e.obx = xs + kAgents * F;
  e.oby = e.obx + o;
  e.o = o;
  float* u = e.oby + o;
  e.load(in, P, p, g.agent, c, g);
  const uint2 key =
      make_uint2(static_cast<uint32_t>(*seed), static_cast<uint32_t>(p));
  float* x = xs + g.agent * F;

  for (int t = 0; t < c.num_steps; ++t) {
    group_uniforms<G>(noise, n_draws, n_draws, P, p, t, key, g, u);
    float apx[kAgents], apy[kAgents];
#pragma unroll
    for (int j = 0; j < kAgents; ++j) {
      apx[j] = Group<G>::from_agent(e.px, j);
      apy[j] = Group<G>::from_agent(e.py, j);
    }
    group_obs_rt(e, g, apx, apy, c, x);
    __syncwarp();
    const size_t tp = static_cast<size_t>(t) * P + p;
    const size_t row = tp * kAgents + g.agent;
    if (valid && g.agent_lane()) store_obs_row_rt(g, obs_out + row * F, x, F);
    const Action a = group_action<G, false, true>(g, wa, ca, RtRow{x, F},
                                                  u + 2 * g.agent, c);
    if (valid && g.owner()) {
      reinterpret_cast<float2*>(act_out)[row] =
          make_float2(a.ang_raw, a.acc_raw);
      lp_out[row] = a.log_prob;
    }
    const StepOutcome s =
        group_advance(e, g, a.ang_raw, a.acc_raw, u + 2 * kAgents, c);
    if (valid && g.leader()) {
      rew_out[tp] = s.reward;
      done_out[tp] = s.finished > 0.5f ? 1 : 0;
      n_trunc += s.trunc > 0.5f;
      n_col += s.any_coll > 0.5f;
      n_tar += s.all_in_target > 0.5f;
    }
  }
  if (valid) e.store(out, P, p, g);

  add_episode_counts(n_trunc, n_col, n_tar, stats_out);
}

}  // namespace marlnav

extern "C" {

// Sizes of the structs the Python side mirrors with ctypes; the wrapper
// checks them before the first launch.
int marlnav_collect_params_size() {
  return static_cast<int>(sizeof(marlnav::StepParams));
}
int marlnav_collect_max_obstacles() { return marlnav::kMaxObs; }
int marlnav_collect_lanes() { return marlnav::kLanes; }
// Bytes of dynamic shared memory of the run-time instance (num_obstacles
// > kMaxObs) for blocks of `threads`; -1 past what a block may take.
int marlnav_collect_rt_smem(int num_obstacles, int noisy, int threads) {
  const long long bytes =
      4ll * marlnav::rt_smem_floats(num_obstacles, noisy,
                                    threads / marlnav::kLanes);
  return bytes > marlnav::kMaxBlockSmem ? -1 : static_cast<int>(bytes);
}

// Launch `blocks` blocks of `threads` threads (a multiple of 32, at most
// kMaxBlockThreads, blocks x threads >= kLanes x num_envs; see
// ops/fused_collect.py launch_geometry) on `stream` (a cudaStream_t from
// torch.cuda.current_stream()).  Returns cudaGetLastError() after the
// launch: 0 when it was accepted.
int marlnav_fused_collect(const marlnav::Rows* in, const marlnav::Rows* out,
                          const float* w, const float* noise,
                          const int32_t* seed,
                          const marlnav::StepParams* params, float* obs,
                          float* act, float* lp, float* rew, uint8_t* done,
                          int32_t* stats, int blocks, int threads, int device,
                          void* stream) {
  if (threads % 32 != 0 || threads < 32 ||
      threads > marlnav::kMaxBlockThreads || blocks < 1 ||
      static_cast<long long>(blocks) * threads <
          static_cast<long long>(marlnav::kLanes) * params->num_envs)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MARLNAV_LAUNCH(O)                                                  \
  case O:                                                                 \
    marlnav::fused_collect_kernel<O><<<blocks, threads, 0, s>>>(           \
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
    default: {
      const int smem = marlnav_collect_rt_smem(params->num_obstacles,
                                               params->noisy, threads);
      if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
      auto* kernel = marlnav::fused_collect_rt_kernel;
      if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      kernel<<<blocks, threads, smem, s>>>(*in, *out, w, noise, seed, *params,
                                           obs, act, lp, rew, done, stats);
    }
  }
#undef MARLNAV_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
