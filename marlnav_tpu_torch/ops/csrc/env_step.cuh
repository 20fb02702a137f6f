// One env-step of the port's fused rollout kernels, in registers: shared by
// fused_collect.cu (the training rollout) and fused_rollout.cu (the bench
// rollout), so both take the same float32 operations in the same order.
//
// Device counterpart of ops/fused_collect.py roll_rows, the step loop both
// kernels' plain versions share.  Built with -fmad=false like every source
// here: see step_math.cuh.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "step_math.cuh"

namespace marlnav {

constexpr int kAgents = 3;  // StepMath raises for A != 3
constexpr int kMaxObs = 8;  // obstacle counts instantiated: 1 .. kMaxObs

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
struct StepParams {
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

// The observation width and the most uniforms a step draws, for O
// obstacles.  O is a template parameter of every kernel so each
// per-obstacle array and draw index is known at compile time and stays in
// registers.
template <int O>
struct Dims {
  static constexpr int F = 2 + 2 * O + 2 * (kAgents - 1);
  static constexpr int kDraws = 2 * kAgents + 2 * O + 3 * kAgents;
};

// Draws of a step: [0, 2A) actions, then obstacle x, obstacle y, then 3
// per agent for the noisy reset.
__host__ __device__ inline int step_draws(int num_obstacles, int noisy) {
  return 2 * kAgents + 2 * num_obstacles + (noisy ? 3 * kAgents : 0);
}

// One env's state.
template <int O>
struct EnvRegs {
  float px[kAgents], py[kAgents], hx[kAgents], hy[kAgents], sp[kAgents];
  float obx[O], oby[O];
  float tx, ty, step_num, latch;

  __device__ __forceinline__ void load(const Rows& r, int P, int p) {
#pragma unroll
    for (int i = 0; i < kAgents; ++i) {
      px[i] = r.px[i * P + p];
      py[i] = r.py[i * P + p];
      hx[i] = r.dx[i * P + p];
      hy[i] = r.dy[i * P + p];
      sp[i] = r.sp[i * P + p];
    }
#pragma unroll
    for (int j = 0; j < O; ++j) {
      obx[j] = r.obx[j * P + p];
      oby[j] = r.oby[j * P + p];
    }
    tx = r.tg[p];
    ty = r.tg[P + p];
    step_num = r.misc[p];
    latch = r.misc[P + p];
  }

  __device__ __forceinline__ void store(const Rows& r, int P, int p) const {
#pragma unroll
    for (int i = 0; i < kAgents; ++i) {
      r.px[i * P + p] = px[i];
      r.py[i * P + p] = py[i];
      r.dx[i * P + p] = hx[i];
      r.dy[i * P + p] = hy[i];
      r.sp[i * P + p] = sp[i];
    }
#pragma unroll
    for (int j = 0; j < O; ++j) {
      r.obx[j * P + p] = obx[j];
      r.oby[j * P + p] = oby[j];
    }
    r.tg[p] = tx;
    r.tg[P + p] = ty;
    r.misc[p] = step_num;
    r.misc[P + p] = latch;
  }
};

// Step t's uniforms for env p: Philox4x32-10 keyed on (seed, p) with
// counter (t, draw group, 0, 0), 4 uniforms a group; or, with `noise`
// (T, n_draws, P), the given ones.  Slots at and above n_draws are not set.
template <int O>
__device__ __forceinline__ void step_uniforms(const float* __restrict__ noise,
                                              int n_draws, int P, int p,
                                              int t, uint2 key,
                                              float (&u)[Dims<O>::kDraws]) {
  constexpr int kDraws = Dims<O>::kDraws;
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
}

// Agent i's normalized observation (step_math.obs_feats), in the
// Observations concat order: target angle and distance, the obstacles'
// angles then distances, the other agents' angles then distances.
template <int O>
__device__ __forceinline__ void agent_obs(const EnvRegs<O>& e, int i,
                                          const StepParams& c,
                                          float (&x)[Dims<O>::F]) {
  float a_, d_;
  geom(e.px[i], e.py[i], e.hx[i], e.hy[i], e.tx, e.ty, c.cap_distance, a_,
       d_);
  x[0] = a_ * c.inv_pi;
  x[1] = d_ * c.d_scale - 1.0f;
#pragma unroll
  for (int j = 0; j < O; ++j) {
    geom(e.px[i], e.py[i], e.hx[i], e.hy[i], e.obx[j], e.oby[j],
         c.cap_distance, a_, d_);
    x[2 + j] = a_ * c.inv_pi;
    x[2 + O + j] = d_ * c.d_scale - 1.0f;
  }
  int m = 0;
#pragma unroll
  for (int j = 0; j < kAgents; ++j) {
    if (j == i) continue;
    geom(e.px[i], e.py[i], e.hx[i], e.hy[i], e.px[j], e.py[j],
         c.cap_distance, a_, d_);
    x[2 + 2 * O + m] = a_ * c.inv_pi;
    x[2 + 2 * O + (kAgents - 1) + m] = d_ * c.d_scale - 1.0f;
    ++m;
  }
}

// One row of the actor operator, w . x + c, summed in feature order
// (step_math.actor_affine).
template <int F>
__device__ __forceinline__ float affine_row(const float* w, float c,
                                            const float (&x)[F]) {
  float acc = w[0] * x[0];
#pragma unroll
  for (int f = 1; f < F; ++f) acc = acc + w[f] * x[f];
  return acc + c;
}

struct StepOutcome {
  float reward;
  float trunc;
  float any_coll;
  float all_in_target;
  float finished;  // terminated or truncated: the env was reset
};

// Everything after the actions: the dynamics, the step counter, the
// rewards from the moved, pre-reinit state, done, and the fresh triangle
// draw mask-blended in where the env finished (step_math.dynamics,
// rewards, reset_blend).  `e` becomes the next step's state; `ur` holds
// the reset uniforms (slots 2A and up).
template <int O>
__device__ __forceinline__ StepOutcome advance(EnvRegs<O>& e,
                                               const float (&ang_raw)[kAgents],
                                               const float (&acc_raw)[kAgents],
                                               const float* ur,
                                               const StepParams& c) {
  // ---- dynamics ----
  float npx[kAgents], npy[kAgents], nhx[kAgents], nhy[kAgents], nsp[kAgents];
#pragma unroll
  for (int i = 0; i < kAgents; ++i) {
    const float ang =
        fminf(fmaxf(c.ang_mean + c.ang_scale * ang_raw[i], c.neg_pi), c.pi);
    const float acc = fminf(
        fmaxf(c.acc_mean + c.acc_scale * acc_raw[i], c.min_accel),
        c.max_accel);
    const float co = cos_pi(ang), si = sin_pi(ang);
    nhx[i] = co * e.hx[i] - si * e.hy[i];
    nhy[i] = si * e.hx[i] + co * e.hy[i];
    nsp[i] = fminf(fmaxf(e.sp[i] + acc, c.min_speed), c.max_speed);
    npx[i] = e.px[i] + nhx[i] * nsp[i];
    npy[i] = e.py[i] + nhy[i] * nsp[i];
  }
  e.step_num = e.step_num + 1.0f;
  const float trunc = e.step_num > c.trunc_after ? 1.0f : 0.0f;

  // ---- rewards from the moved, pre-reinit state ----
  float reward_sum = 0.0f, all_in_target = 1.0f, any_coll = 0.0f;
  float max_t_dist = 0.0f, prev_max_t_dist = 0.0f;
#pragma unroll
  for (int i = 0; i < kAgents; ++i) {
    const float ddx = e.tx - npx[i], ddy = e.ty - npy[i];
    const float t_dist = sqrtf(ddx * ddx + ddy * ddy);
    max_t_dist = fmaxf(max_t_dist, t_dist);
    if (c.group_soft) {
      const float pdx = e.tx - e.px[i], pdy = e.ty - e.py[i];
      prev_max_t_dist = fmaxf(prev_max_t_dist, sqrtf(pdx * pdx + pdy * pdy));
    }
    const float inv = 1.0f / fmaxf(t_dist, F32(1e-12));
    const float t_dot =
        fminf(fmaxf((nhx[i] * ddx + nhy[i] * ddy) * inv, F32(-1.0 + 1e-8)),
              F32(1.0 - 1e-8));

    float o_risk = 0.0f, o_coll = 0.0f;
#pragma unroll
    for (int j = 0; j < O; ++j) {
      const float odx = e.obx[j] - npx[i], ody = e.oby[j] - npy[i];
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

  const float terminated = fmaxf(any_coll, e.latch);
  const float finished = fmaxf(terminated, trunc);
  const float new_latch = e.latch > 0.5f ? 0.0f : all_in_target;

  // ---- auto-reset: fresh triangle draw, mask-blended ----
  const float m = finished, km = 1.0f - finished;
#pragma unroll
  for (int j = 0; j < O; ++j) {
    e.obx[j] = m * ((ur[j] - 0.5f) * c.ox_range + c.ox_mean) + km * e.obx[j];
    e.oby[j] =
        m * ((ur[O + j] - 0.5f) * c.oy_range + c.oy_mean) + km * e.oby[j];
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
      e.hy[i] = m * hy0 + km * nhy[i];
    } else {
      e.hy[i] = km * nhy[i];
    }
    e.px[i] = m * bx + km * npx[i];
    e.py[i] = m * by + km * npy[i];
    e.hx[i] = m * hx0 + km * nhx[i];
    e.sp[i] = m * c.init_speed + km * nsp[i];
  }
  e.step_num = km * e.step_num;
  e.latch = new_latch;
  return {reward, trunc, any_coll, all_in_target, finished};
}

}  // namespace marlnav
