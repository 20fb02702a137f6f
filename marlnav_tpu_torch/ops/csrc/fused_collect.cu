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
// is built with -fmad=false).
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

#include "step_math.cuh"

namespace marlnav {

constexpr int kAgents = 3;  // StepMath raises for A != 3
constexpr int kMaxObs = 8;  // obstacle counts instantiated: 1 .. kMaxObs
constexpr int kThreads = 128;

// Row state: px, py, dx, dy, sp (A, P); obx, oby (O, P); tg, misc (2, P).
// misc = [step_num; target-reach latch], both float32.
struct Rows {
  float* px;
  float* py;
  float* dx;
  float* dy;
  float* sp;
  float* obx;
  float* oby;
  float* tg;
  float* misc;
};

// Every scalar the step reads; built by ops/fused_collect.py
// (_KernelParams), field for field.
struct CollectParams {
  int32_t num_envs;
  int32_t num_steps;
  int32_t num_obstacles;  // selects the template instance
  int32_t noisy;
  int32_t group_soft;
  int32_t wide_angle;  // angle_range > 2*pi: generic cos/sin on reset
  float trunc_after;   // float(episode_len - 1)
  float min_speed, max_speed, min_accel, max_accel;
  float risk_factor, distance_factor, heading_factor, target_factor;
  float soft_factor, bond_factor, group_soft_scale;
  float ob_risk_dist, ag_risk_dist, ob_coll_dist, ag_coll_dist;
  float agents_min_d, agents_max_d, max_at_prop_d, target_radius;
  float cap_distance, ideal_dist, cos_head;
  float inv_init_dist, inv_max_at_prop_d, inv_bond_sharpness;
  float inv_others, inv_agents;
  float inv_pi, d_scale, ang_mean, ang_scale, acc_mean, acc_scale;
  float base_x[kAgents], base_y[kAgents];
  float pos_std, angle_range, init_speed;
  float ox_range, oy_range, ox_mean, oy_mean;
  float neg_pi, pi, log2pi2;  // -pi, pi, 2*log(2*pi)
};

// The obstacle count O is a template parameter so every per-obstacle array
// and draw index is known at compile time and stays in registers.
template <int O>
__global__ void __launch_bounds__(kThreads)
fused_collect_kernel(Rows in, Rows out, const float* __restrict__ w,
                     const float* __restrict__ noise, uint32_t seed,
                     CollectParams c, float* __restrict__ obs_out,
                     float* __restrict__ act_out, float* __restrict__ lp_out,
                     float* __restrict__ rew_out, uint8_t* __restrict__ done_out,
                     int32_t* __restrict__ stats_out) {
  constexpr int F = 2 + 2 * O + 2 * (kAgents - 1);
  constexpr int kDraws = 2 * kAgents + 2 * O + 3 * kAgents;
  const int P = c.num_envs;
  const int n_draws = 2 * kAgents + 2 * O + (c.noisy ? 3 * kAgents : 0);

  // The actor operator: wa (4, F) row-major, then ca (4,).
  __shared__ float s_w[4 * F + 4];
  for (int i = threadIdx.x; i < 4 * F + 4; i += blockDim.x) s_w[i] = w[i];
  __syncthreads();
  const float* wa = s_w;
  const float* ca = s_w + 4 * F;

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int n_trunc = 0, n_col = 0, n_tar = 0;

  if (p < P) {
    float px[kAgents], py[kAgents], hx[kAgents], hy[kAgents], sp[kAgents];
    float obx[O], oby[O];
#pragma unroll
    for (int i = 0; i < kAgents; ++i) {
      px[i] = in.px[i * P + p];
      py[i] = in.py[i * P + p];
      hx[i] = in.dx[i * P + p];
      hy[i] = in.dy[i * P + p];
      sp[i] = in.sp[i * P + p];
    }
#pragma unroll
    for (int j = 0; j < O; ++j) {
      obx[j] = in.obx[j * P + p];
      oby[j] = in.oby[j * P + p];
    }
    const float tx = in.tg[p], ty = in.tg[P + p];
    float step_num = in.misc[p], latch = in.misc[P + p];
    const uint2 key = make_uint2(seed, static_cast<uint32_t>(p));

    for (int t = 0; t < c.num_steps; ++t) {
      // ---- this step's uniforms ----
      float u[kDraws];
      if (noise != nullptr) {
        const float* nt = noise + static_cast<size_t>(t) * n_draws * P + p;
#pragma unroll
        for (int k = 0; k < kDraws; ++k)
          u[k] = k < n_draws ? nt[static_cast<size_t>(k) * P] : 0.0f;
      } else {
#pragma unroll
        for (int g = 0; g < (kDraws + 3) / 4; ++g) {
          if (4 * g < n_draws) {
            const uint4 r = philox4x32_10(
                make_uint4(static_cast<uint32_t>(t), g, 0u, 0u), key);
            const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (4 * g + q < kDraws) u[4 * g + q] = bits_to_uniform(words[q]);
          }
        }
      }

      // ---- observations (pre-step) and actions, one agent at a time ----
      const size_t tp = static_cast<size_t>(t) * P + p;
      float ang_raw[kAgents], acc_raw[kAgents];
#pragma unroll
      for (int i = 0; i < kAgents; ++i) {
        float f_ta, f_td, f_oa[O], f_od[O], f_na[2], f_nd[2];
        float a_, d_;
        geom(px[i], py[i], hx[i], hy[i], tx, ty, c.cap_distance, a_, d_);
        f_ta = a_ * c.inv_pi;
        f_td = d_ * c.d_scale - 1.0f;
#pragma unroll
        for (int j = 0; j < O; ++j) {
          geom(px[i], py[i], hx[i], hy[i], obx[j], oby[j], c.cap_distance,
               a_, d_);
          f_oa[j] = a_ * c.inv_pi;
          f_od[j] = d_ * c.d_scale - 1.0f;
        }
        int m = 0;
#pragma unroll
        for (int j = 0; j < kAgents; ++j) {
          if (j == i) continue;
          geom(px[i], py[i], hx[i], hy[i], px[j], py[j], c.cap_distance, a_,
               d_);
          f_na[m] = a_ * c.inv_pi;
          f_nd[m] = d_ * c.d_scale - 1.0f;
          ++m;
        }

        // obs row (t, p, i, :) in the Observations concat order.
        float* o_row = obs_out + (tp * kAgents + i) * F;
        o_row[0] = f_ta;
        o_row[1] = f_td;
#pragma unroll
        for (int j = 0; j < O; ++j) {
          o_row[2 + j] = f_oa[j];
          o_row[2 + O + j] = f_od[j];
        }
        o_row[2 + 2 * O] = f_na[0];
        o_row[3 + 2 * O] = f_na[1];
        o_row[4 + 2 * O] = f_nd[0];
        o_row[5 + 2 * O] = f_nd[1];

        // z = wa x + ca, summed in feature order (step_math.actor_affine).
        float z[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float* wk = wa + k * F;
          float acc = wk[0] * f_ta;
          acc = acc + wk[1] * f_td;
#pragma unroll
          for (int j = 0; j < O; ++j) acc = acc + wk[2 + j] * f_oa[j];
#pragma unroll
          for (int j = 0; j < O; ++j) acc = acc + wk[2 + O + j] * f_od[j];
          acc = acc + wk[2 + 2 * O] * f_na[0];
          acc = acc + wk[3 + 2 * O] * f_na[1];
          acc = acc + wk[4 + 2 * O] * f_nd[0];
          acc = acc + wk[5 + 2 * O] * f_nd[1];
          z[k] = acc + ca[k];
        }
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

      // ---- dynamics (step_math.dynamics) ----
      float npx[kAgents], npy[kAgents], nhx[kAgents], nhy[kAgents],
          nsp[kAgents];
#pragma unroll
      for (int i = 0; i < kAgents; ++i) {
        const float ang = fminf(
            fmaxf(c.ang_mean + c.ang_scale * ang_raw[i], c.neg_pi), c.pi);
        const float acc = fminf(
            fmaxf(c.acc_mean + c.acc_scale * acc_raw[i], c.min_accel),
            c.max_accel);
        const float co = cos_pi(ang), si = sin_pi(ang);
        nhx[i] = co * hx[i] - si * hy[i];
        nhy[i] = si * hx[i] + co * hy[i];
        nsp[i] = fminf(fmaxf(sp[i] + acc, c.min_speed), c.max_speed);
        npx[i] = px[i] + nhx[i] * nsp[i];
        npy[i] = py[i] + nhy[i] * nsp[i];
      }
      step_num = step_num + 1.0f;
      const float trunc = step_num > c.trunc_after ? 1.0f : 0.0f;

      // ---- rewards from the moved, pre-reinit state (step_math.rewards) ----
      float reward_sum = 0.0f, all_in_target = 1.0f, any_coll = 0.0f;
      float max_t_dist = 0.0f, prev_max_t_dist = 0.0f;
#pragma unroll
      for (int i = 0; i < kAgents; ++i) {
        const float ddx = tx - npx[i], ddy = ty - npy[i];
        const float t_dist = sqrtf(ddx * ddx + ddy * ddy);
        max_t_dist = fmaxf(max_t_dist, t_dist);
        if (c.group_soft) {
          const float pdx = tx - px[i], pdy = ty - py[i];
          prev_max_t_dist = fmaxf(prev_max_t_dist, sqrtf(pdx * pdx + pdy * pdy));
        }
        const float inv = 1.0f / fmaxf(t_dist, F32(1e-12));
        const float t_dot = fminf(
            fmaxf((nhx[i] * ddx + nhy[i] * ddy) * inv, F32(-1.0 + 1e-8)),
            F32(1.0 - 1e-8));

        float o_risk = 0.0f, o_coll = 0.0f;
#pragma unroll
        for (int j = 0; j < O; ++j) {
          const float odx = obx[j] - npx[i], ody = oby[j] - npy[i];
          const float o_dist = sqrtf(odx * odx + ody * ody);
          o_risk = fmaxf(o_risk, o_dist < c.ob_risk_dist ? 1.0f : 0.0f);
          o_coll = fmaxf(o_coll, o_dist < c.ob_coll_dist ? 1.0f : 0.0f);
        }
        float n_risk = 0.0f, n_coll = 0.0f, band_sum = 0.0f, bond_sum = 0.0f;
#pragma unroll
        for (int j = 0; j < kAgents; ++j) {
          if (j == i) continue;
          const float ndx = npx[j] - npx[i], ndy = npy[j] - npy[i];
          const float n_dist = sqrtf(ndx * ndx + ndy * ndy);
          n_risk = fmaxf(n_risk, n_dist < c.ag_risk_dist ? 1.0f : 0.0f);
          n_coll = fmaxf(n_coll, n_dist < c.ag_coll_dist ? 1.0f : 0.0f);
          band_sum = band_sum + ((c.agents_min_d < n_dist &&
                                  n_dist < c.agents_max_d) ? 1.0f : 0.0f);
          const float scaled = (n_dist - c.ideal_dist) * c.inv_bond_sharpness;
          bond_sum = bond_sum + 1.0f / (1.0f + scaled * scaled);
        }
        const float in_target = t_dist < c.target_radius ? 1.0f : 0.0f;
        const float heading = t_dist < c.cap_distance
                                  ? 1.0f
                                  : (t_dot > c.cos_head ? 1.0f : 0.0f);
        const float soft = -t_dist * c.inv_init_dist;
        const float dist_sc =
            fminf(band_sum, c.max_at_prop_d) * c.inv_max_at_prop_d;
        const float bond = bond_sum * c.inv_others;
        const float risk = fminf(o_risk + n_risk, 1.0f);
        const float coll = fminf(o_coll + n_coll, 1.0f);
        all_in_target = fminf(all_in_target, in_target);
        any_coll = fmaxf(any_coll, coll);
        reward_sum = reward_sum +
                     ((((c.heading_factor * heading +
                         c.distance_factor * dist_sc) +
                        c.soft_factor * soft) +
                       c.bond_factor * bond) -
                      c.risk_factor * risk);
      }
      float reward = reward_sum * c.inv_agents + c.target_factor * all_in_target;
      if (c.group_soft)
        reward = reward + c.group_soft_scale * (prev_max_t_dist - max_t_dist);

      const float terminated = fmaxf(any_coll, latch);
      const float finished = fmaxf(terminated, trunc);
      const float new_latch = latch > 0.5f ? 0.0f : all_in_target;
      rew_out[tp] = reward;
      done_out[tp] = finished > 0.5f ? 1 : 0;
      n_trunc += trunc > 0.5f;
      n_col += any_coll > 0.5f;
      n_tar += all_in_target > 0.5f;

      // ---- auto-reset: fresh triangle draw, mask-blended (reset_blend) ----
      const float m = finished, km = 1.0f - finished;
      const float* ur = u + 2 * kAgents;
#pragma unroll
      for (int j = 0; j < O; ++j) {
        obx[j] = m * ((ur[j] - 0.5f) * c.ox_range + c.ox_mean) + km * obx[j];
        oby[j] = m * ((ur[O + j] - 0.5f) * c.oy_range + c.oy_mean) +
                 km * oby[j];
      }
#pragma unroll
      for (int i = 0; i < kAgents; ++i) {
        float bx = c.base_x[i], by = c.base_y[i], hx0 = 1.0f;
        if (c.noisy) {
          const float* un = ur + 2 * O + 3 * i;
          float z0, z1;
          box_muller(un[0], un[1], z0, z1);
          const float ang = c.angle_range * (un[2] - 0.5f);
          bx = c.base_x[i] + c.pos_std * z0;
          by = c.base_y[i] + c.pos_std * z1;
          float hy0;
          if (c.wide_angle) {
            hx0 = cosf(ang);
            hy0 = sinf(ang);
          } else {
            hx0 = cos_pi(ang);
            hy0 = sin_pi(ang);
          }
          hy[i] = m * hy0 + km * nhy[i];
        } else {
          hy[i] = km * nhy[i];
        }
        px[i] = m * bx + km * npx[i];
        py[i] = m * by + km * npy[i];
        hx[i] = m * hx0 + km * nhx[i];
        sp[i] = m * c.init_speed + km * nsp[i];
      }
      step_num = km * step_num;
      latch = new_latch;
    }

    // ---- final state ----
#pragma unroll
    for (int i = 0; i < kAgents; ++i) {
      out.px[i * P + p] = px[i];
      out.py[i * P + p] = py[i];
      out.dx[i * P + p] = hx[i];
      out.dy[i * P + p] = hy[i];
      out.sp[i * P + p] = sp[i];
    }
#pragma unroll
    for (int j = 0; j < O; ++j) {
      out.obx[j * P + p] = obx[j];
      out.oby[j * P + p] = oby[j];
    }
    out.tg[p] = tx;
    out.tg[P + p] = ty;
    out.misc[p] = step_num;
    out.misc[P + p] = latch;
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
  return static_cast<int>(sizeof(marlnav::CollectParams));
}
int marlnav_collect_max_obstacles() { return marlnav::kMaxObs; }

// Launch on `stream` (a cudaStream_t from torch.cuda.current_stream()).
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
int marlnav_fused_collect(const marlnav::Rows* in, const marlnav::Rows* out,
                          const float* w, const float* noise, uint32_t seed,
                          const marlnav::CollectParams* params, float* obs,
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
