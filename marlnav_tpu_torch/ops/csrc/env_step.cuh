// One env-step of the port's rollout kernels on a group of lanes: shared by
// fused_collect.cu (the training rollout, TPU kernel
// marlnav_tpu/ops/fused_collect.py:make_fused_collect) and fused_rollout.cu
// (the bench rollout, marlnav_tpu/ops/fused_rollout.py:make_fused_rollout),
// so both take the same float32 operations in the same order.  Device
// counterpart of ops/fused_collect.py roll_rows, the step loop both
// kernels' plain versions share.  Built with -fmad=false like every source
// here: see step_math.cuh.
//
// Lane groups.  Each env is stepped by G consecutive lanes of one warp, so
// a group never crosses a warp.  The templated instances (O <= kMaxObs)
// fix G = 4 or 8 (kLanes: 8 for the collect, 4 for the rollout; PERF.md
// has both timed on both).  With A = 3 agents, agent i takes S = G / 4
// lanes: its geom calls (alternating between its lanes when S = 2), its
// actor rows (action component k on its lane k when S = 2), Box-Muller,
// action and log-prob, its dynamics, its reward term and its reset.  The
// spare lanes (lane >= A S) repeat the last agent's work and store
// nothing.  The run-time instances (O past kMaxObs) take G = 4 .. 32,
// chosen at launch, and spread the work that grows with O over every lane
// of the group instead (see RtLaneState below).  The group's Philox
// groups (or injected uniforms) are spread over all G lanes and staged in
// shared memory, where each lane reads the slots it uses.  Values cross
// lanes by __shfl_sync, which moves bits exactly: every agent's position
// before the observations and after the dynamics, the geom results and
// action halves of an agent's two lanes, and the per-agent reward terms
// and flags, which every lane of the group then reduces in agent order
// from the plain version's start values (the ordered sum reward_sum =
// ((0 + r0) + r1) + r2 included), so each lane holds the same reward, done
// flag and counters.  Each lane also holds the obstacles and blends them on
// reset from the same draws.  Every value is thus computed as the plain
// version computes it, by one lane or bit for bit alike on several.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "step_math.cuh"

namespace marlnav {

constexpr int kAgents = 3;  // StepMath raises for A != 3
constexpr int kMaxObs = 8;  // obstacle counts instantiated: 1 .. kMaxObs
constexpr int kMaxBlockThreads = 256;
// Blocks of kMaxBlockThreads an SM the run-time instances keep room for:
// at most 128 registers a thread, so that 16 warps an SM stay resident.
constexpr int kRtMinBlocks = 2;
constexpr int kMaxBlockSmem = 232448;  // bytes a block may take on an H100
constexpr unsigned kFullMask = 0xffffffffu;

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

// Draws of a step: [0, 2A) actions, then obstacle x, obstacle y, then 3
// per agent for the noisy reset.
__host__ __device__ constexpr int step_draws(int num_obstacles, int noisy) {
  return 2 * kAgents + 2 * num_obstacles + (noisy ? 3 * kAgents : 0);
}

// The observation width for O obstacles.
__host__ __device__ constexpr int obs_width(int num_obstacles) {
  return 2 + 2 * num_obstacles + 2 * (kAgents - 1);
}

// The observation width and the most uniforms a step draws, for O
// obstacles.  O is a template parameter of the templated kernels so each
// per-obstacle array and draw index is known at compile time and stays in
// registers.
template <int O>
struct Dims {
  static constexpr int F = obs_width(O);
  static constexpr int kDraws = step_draws(O, 1);
  static constexpr int kGeoms = 1 + O + (kAgents - 1);  // geom calls an agent
};

// The run-time instance's dynamic shared memory in floats: the actor
// operator (4 F + 4), then for each of `groups` groups its agents'
// observation rows (A, F), its obstacles x then y (O each), its step's
// uniforms (step_draws) and its agents' actor heads (kHeads each), each
// group's region an even count of floats so that the rows stay on 8 bytes.
constexpr int kHeads = 4;  // an agent's operator rows: means, variances
__host__ __device__ inline int rt_group_floats(int num_obstacles, int noisy) {
  const int n = kAgents * obs_width(num_obstacles) + 2 * num_obstacles +
                step_draws(num_obstacles, noisy) + kAgents * kHeads;
  return (n + 1) & ~1;
}
__host__ __device__ inline int rt_smem_floats(int num_obstacles, int noisy,
                                              int groups) {
  return 4 * obs_width(num_obstacles) + 4 +
         groups * rt_group_floats(num_obstacles, noisy);
}

// A lane's place in its env's group of G lanes.
template <int G>
struct Group {
  static_assert(G == 4 || G == 8 || G == 16 || G == 32,
                "a group is 4, 8, 16 or 32 lanes");
  static constexpr int S = G / 4;  // lanes an agent

  int lane;   // 0 .. G-1
  int agent;  // the agent this lane steps; spare lanes repeat the last
  int sub;    // 0 .. S-1: which of the agent's lanes

  __device__ explicit Group(int thread)
      : lane(thread % G), agent(min(thread % G / S, kAgents - 1)),
        sub(thread % S) {}
  // Writes the env's reward, done flag, counters, obstacles and misc rows.
  __device__ bool leader() const { return lane == 0; }
  // Any of the agents' lanes (not a spare one).
  __device__ bool agent_lane() const { return lane < kAgents * S; }
  // Writes its agent's action, log-prob and final rows.
  __device__ bool owner() const { return agent_lane() && sub == 0; }
  // `v` as agent j's first lane holds it.
  __device__ static float from_agent(float v, int j) {
    return __shfl_sync(kFullMask, v, j * S, G);
  }
  // A value computed in halves on an agent's two lanes (S = 2): out[k] is
  // its lane k's.
  __device__ void pair(float mine, float (&out)[2]) const {
    const float other = __shfl_xor_sync(kFullMask, mine, 1, G);
    out[0] = sub ? other : mine;
    out[1] = sub ? mine : other;
  }
};

// One lane's part of one env's state: its agent's rows, and a copy of the
// obstacles, target and counters that every lane of the group holds.
template <int O>
struct LaneState {
  float px, py, hx, hy, sp;  // the lane's agent
  float bx, by;              // its triangle base position
  float obx[O], oby[O];
  float tx, ty, step_num, latch;

  __device__ static constexpr int num_obs() { return O; }

  __device__ __forceinline__ void load(const Rows& r, int P, int p, int i,
                                       const StepParams& c) {
    px = r.px[i * P + p];
    py = r.py[i * P + p];
    hx = r.dx[i * P + p];
    hy = r.dy[i * P + p];
    sp = r.sp[i * P + p];
#pragma unroll
    for (int j = 0; j < kAgents; ++j)  // a constant index keeps c in place
      if (j == i) {
        bx = c.base_x[j];
        by = c.base_y[j];
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

  template <int G>
  __device__ __forceinline__ void store(const Rows& r, int P, int p,
                                        const Group<G>& g) const {
    if (g.owner()) {
      const int i = g.agent;
      r.px[i * P + p] = px;
      r.py[i * P + p] = py;
      r.dx[i * P + p] = hx;
      r.dy[i * P + p] = hy;
      r.sp[i * P + p] = sp;
    }
    if (g.leader()) {
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
  }

  // The lane's agent's obstacle risk and collision flags at (npx, npy).
  __device__ __forceinline__ void obstacle_flags(float npx, float npy,
                                                 const StepParams& c,
                                                 float& o_risk,
                                                 float& o_coll) const {
#pragma unroll
    for (int j = 0; j < O; ++j) {
      const float odx = obx[j] - npx, ody = oby[j] - npy;
      const float o_dist = sqrtf(odx * odx + ody * ody);
      o_risk = fmaxf(o_risk, o_dist < c.ob_risk_dist ? 1.0f : 0.0f);
      o_coll = fmaxf(o_coll, o_dist < c.ob_coll_dist ? 1.0f : 0.0f);
    }
  }

  // The obstacles' fresh draw from the reset uniforms ur, blended in by m
  // (km = 1 - m); every lane blends its own copy.
  template <int G>
  __device__ __forceinline__ void reset_obstacles(float m, float km,
                                                  const float* ur,
                                                  const StepParams& c,
                                                  const Group<G>&) {
#pragma unroll
    for (int j = 0; j < O; ++j) {
      obx[j] = m * ((ur[j] - 0.5f) * c.ox_range + c.ox_mean) + km * obx[j];
      oby[j] = m * ((ur[O + j] - 0.5f) * c.oy_range + c.oy_mean) + km * oby[j];
    }
  }
};

// The run-time instance's LaneState: the same rows, but the obstacles (o of
// them) are the group's one copy in shared memory, obx then oby, loaded,
// stored and blended on reset with each obstacle on one lane, a __syncwarp
// after, and read by every lane of the group.  The obstacle flags spread
// the obstacles over the group's G lanes, each lane taking its obstacles'
// distances to all A agents.
template <int G>
struct RtLaneState {
  float px, py, hx, hy, sp;
  float bx, by;
  float* obx;
  float* oby;
  int o;
  int lane, agent;
  float tx, ty, step_num, latch;

  __device__ int num_obs() const { return o; }

  // The obstacles at obx[0 .. o), oby[0 .. o); the lane's agent's rows and
  // the group's obstacles, target and counters from r.
  __device__ __forceinline__ void load(const Rows& r, int P, int p,
                                       const StepParams& c,
                                       const Group<G>& g, float* obstacles,
                                       int num_obstacles) {
    o = num_obstacles;
    obx = obstacles;
    oby = obstacles + o;
    lane = g.lane;
    agent = g.agent;
    const int i = agent;
    px = r.px[i * P + p];
    py = r.py[i * P + p];
    hx = r.dx[i * P + p];
    hy = r.dy[i * P + p];
    sp = r.sp[i * P + p];
#pragma unroll
    for (int j = 0; j < kAgents; ++j)
      if (j == i) {
        bx = c.base_x[j];
        by = c.base_y[j];
      }
    for (int j = lane; j < o; j += G) {
      obx[j] = r.obx[j * P + p];
      oby[j] = r.oby[j * P + p];
    }
    tx = r.tg[p];
    ty = r.tg[P + p];
    step_num = r.misc[p];
    latch = r.misc[P + p];
    __syncwarp();
  }

  __device__ __forceinline__ void store(const Rows& r, int P, int p,
                                        const Group<G>& g) const {
    if (g.owner()) {
      const int i = g.agent;
      r.px[i * P + p] = px;
      r.py[i * P + p] = py;
      r.dx[i * P + p] = hx;
      r.dy[i * P + p] = hy;
      r.sp[i * P + p] = sp;
    }
    for (int j = lane; j < o; j += G) {
      r.obx[j * P + p] = obx[j];
      r.oby[j * P + p] = oby[j];
    }
    if (g.leader()) {
      r.tg[p] = tx;
      r.tg[P + p] = ty;
      r.misc[p] = step_num;
      r.misc[P + p] = latch;
    }
  }

  // The lane's agent's flags at its new position (npx, npy).  Lane l takes
  // obstacles l, l + G, ..., each against all agents' new positions; a
  // flag is the maximum of 0/1 terms, an OR, so the bits of the group are
  // OR-reduced by shuffles in any order and the result is the plain
  // version's.
  __device__ __forceinline__ void obstacle_flags(float npx, float npy,
                                                 const StepParams& c,
                                                 float& o_risk,
                                                 float& o_coll) const {
    float anpx[kAgents], anpy[kAgents];
#pragma unroll
    for (int i = 0; i < kAgents; ++i) {
      anpx[i] = Group<G>::from_agent(npx, i);
      anpy[i] = Group<G>::from_agent(npy, i);
    }
    unsigned bits = 0;  // bit 2 i: agent i's risk, 2 i + 1: its collision
    for (int j = lane; j < o; j += G) {
      const float ox = obx[j], oy = oby[j];
#pragma unroll
      for (int i = 0; i < kAgents; ++i) {
        const float odx = ox - anpx[i], ody = oy - anpy[i];
        const float o_dist = sqrtf(odx * odx + ody * ody);
        bits |= ((o_dist < c.ob_risk_dist ? 1u : 0u) |
                 (o_dist < c.ob_coll_dist ? 2u : 0u))
                << (2 * i);
      }
    }
#pragma unroll
    for (int m = 1; m < G; m <<= 1)
      bits |= __shfl_xor_sync(kFullMask, bits, m, G);
    o_risk = (bits >> (2 * agent)) & 1u ? 1.0f : 0.0f;
    o_coll = (bits >> (2 * agent)) & 2u ? 1.0f : 0.0f;
  }

  // Every lane has read the obstacles of this step (the first __syncwarp)
  // before obstacle j is blended on lane j % G; the second publishes them.
  __device__ __forceinline__ void reset_obstacles(float m, float km,
                                                  const float* ur,
                                                  const StepParams& c,
                                                  const Group<G>&) {
    __syncwarp();
    for (int j = lane; j < o; j += G) {
      obx[j] = m * ((ur[j] - 0.5f) * c.ox_range + c.ox_mean) + km * obx[j];
      oby[j] = m * ((ur[o + j] - 0.5f) * c.oy_range + c.oy_mean) + km * oby[j];
    }
    __syncwarp();
  }
};

// Step t's uniforms for env p into the group's slots u[0 .. slots), slots
// >= n_draws (Dims<O>::kDraws in the templated instances, n_draws in the
// run-time one): Philox4x32-10 keyed on (seed, p) with counter (t, draw
// group, 0, 0), 4 uniforms a group, lane l drawing groups l, l + G, ...;
// or, with `noise` (T, n_draws, P), lane l loading draws l, l + G, ...
// Slots at and above n_draws may be left unset.  The slots do not depend on
// G.  Every lane of the warp calls it: the __syncwarp before lets the last
// step's reads finish, the one after publishes the slots.
template <int G>
__device__ __forceinline__ void group_uniforms(const float* __restrict__ noise,
                                               int n_draws, int slots, int P,
                                               int p, int t, uint2 key,
                                               const Group<G>& g, float* u) {
  const int kDraws = slots;
  __syncwarp();
  if (noise != nullptr) {
    const float* nt = noise + static_cast<size_t>(t) * n_draws * P + p;
    for (int k = g.lane; k < n_draws; k += G)
      u[k] = nt[static_cast<size_t>(k) * P];
  } else {
    for (int d = g.lane; 4 * d < n_draws; d += G) {
      const uint4 r = philox4x32_10(
          make_uint4(static_cast<uint32_t>(t), static_cast<uint32_t>(d), 0u,
                     0u),
          key);
      const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (4 * d + q < kDraws) u[4 * d + q] = bits_to_uniform(words[q]);
    }
  }
  __syncwarp();
}

// The point of an agent's geom call k (k known at compile time after
// unrolling): the target, obstacle k - 1, or its (k - 1 - O)-th other
// agent in index order, whose position is in apx, apy.
template <int O>
__device__ __forceinline__ void geom_point(const LaneState<O>& e, int agent,
                                           const float (&apx)[kAgents],
                                           const float (&apy)[kAgents], int k,
                                           float& qx, float& qy) {
  if (k == 0) {
    qx = e.tx;
    qy = e.ty;
  } else if (k <= O) {
    qx = e.obx[k - 1];
    qy = e.oby[k - 1];
  } else {
    const int m = k - 1 - O;
    const bool before = m < agent;
    qx = before ? apx[m] : apx[m + 1];
    qy = before ? apy[m] : apy[m + 1];
  }
}

// The lane's agent's normalized observation (step_math.obs_feats), in the
// Observations concat order: target angle and distance, the obstacles'
// angles then distances, the other agents' angles then distances.  apx,
// apy hold every agent's position.  With S = 2 the agent's lanes take
// alternate geom calls and exchange the results, so both hold all of x.
template <int O, int G>
__device__ __forceinline__ void group_obs(const LaneState<O>& e,
                                          const Group<G>& g,
                                          const float (&apx)[kAgents],
                                          const float (&apy)[kAgents],
                                          const StepParams& c,
                                          float (&x)[Dims<O>::F]) {
  constexpr int kGeoms = Dims<O>::kGeoms;
  constexpr int S = Group<G>::S;
  float ang[kGeoms], dist[kGeoms];
#pragma unroll
  for (int k0 = 0; k0 < kGeoms; k0 += S) {
    float qx, qy, a_, d_;
    geom_point(e, g.agent, apx, apy, k0, qx, qy);
    if constexpr (S == 2) {
      // lane 1 takes call k0 + 1 (or repeats k0 where kGeoms is odd)
      float q1x, q1y;
      geom_point(e, g.agent, apx, apy, k0 + 1 < kGeoms ? k0 + 1 : k0, q1x,
                 q1y);
      qx = g.sub ? q1x : qx;
      qy = g.sub ? q1y : qy;
    }
    geom(e.px, e.py, e.hx, e.hy, qx, qy, c.cap_distance, a_, d_);
    if constexpr (S == 1) {
      ang[k0] = a_;
      dist[k0] = d_;
    } else {
      float pa[2], pd[2];
      g.pair(a_, pa);
      g.pair(d_, pd);
      ang[k0] = pa[0];
      dist[k0] = pd[0];
      if (k0 + 1 < kGeoms) {
        ang[k0 + 1] = pa[1];
        dist[k0 + 1] = pd[1];
      }
    }
  }
  x[0] = ang[0] * c.inv_pi;
  x[1] = dist[0] * c.d_scale - 1.0f;
#pragma unroll
  for (int j = 0; j < O; ++j) {
    x[2 + j] = ang[1 + j] * c.inv_pi;
    x[2 + O + j] = dist[1 + j] * c.d_scale - 1.0f;
  }
#pragma unroll
  for (int m = 0; m < kAgents - 1; ++m) {
    x[2 + 2 * O + m] = ang[1 + O + m] * c.inv_pi;
    x[2 + 2 * O + (kAgents - 1) + m] = dist[1 + O + m] * c.d_scale - 1.0f;
  }
}

// Agent i's value of a per-agent array: i at run time, so two selects
// keep the array in registers.
__device__ __forceinline__ float pick(const float (&a)[kAgents], int i) {
  return i == 0 ? a[0] : (i == 1 ? a[1] : a[2]);
}

// group_obs for the run-time instance: lane l takes the geom calls k = l,
// l + G, ... of the 1 + O + A - 1 an agent makes, each for all A agents
// (three independent chains), on their positions and headings, which every
// lane gathers by shuffles; the target and obstacles are points all agents
// share, loaded once.  Each call writes its two features straight into its
// agent's row of xs ((A, F) floats in shared memory), in the Observations
// order.  The caller's __syncwarp publishes the rows.
template <int G>
__device__ __forceinline__ void group_obs_rt(const RtLaneState<G>& e,
                                             const StepParams& c, float* xs) {
  float apx[kAgents], apy[kAgents], ahx[kAgents], ahy[kAgents];
#pragma unroll
  for (int i = 0; i < kAgents; ++i) {
    apx[i] = Group<G>::from_agent(e.px, i);
    apy[i] = Group<G>::from_agent(e.py, i);
    ahx[i] = Group<G>::from_agent(e.hx, i);
    ahy[i] = Group<G>::from_agent(e.hy, i);
  }
  const int o = e.o, F = obs_width(o);
  for (int k = e.lane; k < 1 + o + (kAgents - 1); k += G) {
    float qx = 0.0f, qy = 0.0f;
    int ia, id;  // the features' indices in a row
    if (k == 0) {
      qx = e.tx;
      qy = e.ty;
      ia = 0;
      id = 1;
    } else if (k <= o) {
      qx = e.obx[k - 1];
      qy = e.oby[k - 1];
      ia = 2 + (k - 1);
      id = 2 + o + (k - 1);
    } else {
      ia = 2 + 2 * o + (k - 1 - o);
      id = ia + (kAgents - 1);
    }
#pragma unroll
    for (int i = 0; i < kAgents; ++i) {
      float px_ = qx, py_ = qy;
      if (k > o) {  // agent i's m-th other agent
        const int m = k - 1 - o;
        const int j = m < i ? m : m + 1;
        px_ = pick(apx, j);
        py_ = pick(apy, j);
      }
      float a_, d_;
      geom(apx[i], apy[i], ahx[i], ahy[i], px_, py_, c.cap_distance, a_, d_);
      xs[i * F + ia] = a_ * c.inv_pi;
      xs[i * F + id] = d_ * c.d_scale - 1.0f;
    }
  }
}

// Agent i's observation row, 4 B a feature from `row` on: float4 stores
// where F % 4 == 0 (the row then starts on a 16-byte boundary), else
// float2 (F is even).  With S = 2 the agent's lanes take alternate chunks.
template <int F, int G>
__device__ __forceinline__ void store_obs_row(const Group<G>& g, float* row,
                                              const float (&x)[F]) {
  constexpr int S = Group<G>::S;
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int q = 0; q < F / 4; ++q)
      if (q % S == g.sub)
        reinterpret_cast<float4*>(row)[q] =
            make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < F / 2; ++q)
      if (q % S == g.sub)
        reinterpret_cast<float2*>(row)[q] = make_float2(x[2 * q], x[2 * q + 1]);
  }
}

// The env's A observation rows of the run-time instance, (A, F) floats
// from xs in shared memory (on 8 bytes) to `rows`, which the buffer lays
// out just so: float2 stores spread over the group's lanes.
template <int G>
__device__ __forceinline__ void store_obs_rows_rt(const Group<G>& g,
                                                  float* rows, const float* xs,
                                                  int n) {
  for (int q = g.lane; q < n / 2; q += G)
    reinterpret_cast<float2*>(rows)[q] =
        reinterpret_cast<const float2*>(xs)[q];
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

// affine_row for the run-time instance: f (even) features of w and x in
// shared memory, both on 8 bytes.  The adds stay one chain in feature
// order; the loads run a block of kAhead float2 pairs ahead of it, so the
// chain waits on its adds and not on shared memory.  A block read ahead
// may pass the row's end by up to 2 kAhead floats, never added: an
// operator row is followed by the next, or by ca and the groups' regions,
// an observation row by the next, or by the group's obstacles (2 O > 16
// floats), all in the block's shared memory.
__device__ __forceinline__ float affine_row_rt(const float* w, float c,
                                               const float* x, int f) {
  constexpr int kAhead = 4;
  const float2* w2 = reinterpret_cast<const float2*>(w);
  const float2* x2 = reinterpret_cast<const float2*>(x);
  const int n = f / 2;
  float2 bw[kAhead], bx[kAhead];
#pragma unroll
  for (int q = 0; q < kAhead; ++q) {
    bw[q] = w2[1 + q];
    bx[q] = x2[1 + q];
  }
  const float2 w0 = w2[0], x0 = x2[0];
  float acc = w0.x * x0.x;
  acc = acc + w0.y * x0.y;
  int q0 = 1;
  for (; q0 + kAhead <= n; q0 += kAhead) {
    float pr[2 * kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      pr[2 * q] = bw[q].x * bx[q].x;
      pr[2 * q + 1] = bw[q].y * bx[q].y;
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      bw[q] = w2[q0 + kAhead + q];
      bx[q] = x2[q0 + kAhead + q];
    }
#pragma unroll
    for (int q = 0; q < 2 * kAhead; ++q) acc = acc + pr[q];
  }
#pragma unroll
  for (int q = 0; q < kAhead; ++q)  // the last n - q0 < kAhead pairs
    if (q0 + q < n) {
      acc = acc + bw[q].x * bx[q].x;
      acc = acc + bw[q].y * bx[q].y;
    }
  return acc + c;
}

struct Action {
  float ang_raw, acc_raw, log_prob;
};

// The lane's agent's action from its features: the policy mean (kMean),
// or mu + sqrt(var) * z with z the Box-Muller pair of the draws u[0], u[1]
// and, with kLogProb, its log-prob (DiagGaussian.log_prob, with (a - mu)^2
// / var == z^2).  Rows k and k + 2 of the operator (wa (4, F) row-major,
// then ca (4,)) give component k's mean and variance; with S = 2
// component k is computed on the agent's lane k.  x: the features in
// registers.
template <int G, bool kMean, bool kLogProb, int F>
__device__ __forceinline__ Action group_action(const Group<G>& g,
                                               const float* wa,
                                               const float* ca,
                                               const float (&x)[F],
                                               const float* u,
                                               const StepParams& c) {
  constexpr int S = Group<G>::S;
  float mu[2], v[2], lv[2];
#pragma unroll
  for (int k0 = 0; k0 < 2; k0 += S) {
    const int k = S == 1 ? k0 : g.sub;
    const float m = tanhf(affine_row(wa + k * F, ca[k], x));
    float var = 0.0f, log_var = 0.0f;
    if (!kMean) {
      var = softplus(affine_row(wa + (k + 2) * F, ca[k + 2], x));
      if (kLogProb) log_var = logf(var);
    }
    if constexpr (S == 1) {
      mu[k0] = m;
      v[k0] = var;
      lv[k0] = log_var;
    } else {
      g.pair(m, mu);
      if (!kMean) {
        g.pair(var, v);
        if (kLogProb) g.pair(log_var, lv);
      }
    }
  }
  if (kMean) return {mu[0], mu[1], 0.0f};
  float z0, z1;
  box_muller(u[0], u[1], z0, z1);
  Action a;
  a.ang_raw = mu[0] + sqrtf(v[0]) * z0;
  a.acc_raw = mu[1] + sqrtf(v[1]) * z1;
  a.log_prob = kLogProb ? -0.5f * ((((c.log2pi2 + lv[0]) + lv[1]) + z0 * z0) +
                                   z1 * z1)
                        : 0.0f;
  return a;
}

// group_action for the run-time instance.  The A agents' operator rows
// (both means and, unless kMean, both variances: A x 4 rows of F features
// from xs) spread over the group's lanes, row r = 4 i + k (kMean: 2 i + k)
// on lane r % G; their pre-activations go through the group's `heads` (A x
// kHeads floats in shared memory) to every lane of their agent, which then
// takes tanh, softplus, log and the action as group_action does, on the
// same values (the same functions on every lane: no divergence).
template <int G, bool kMean, bool kLogProb>
__device__ __forceinline__ Action group_action_rt(const Group<G>& g,
                                                  const float* wa,
                                                  const float* ca,
                                                  const float* xs, int F,
                                                  const float* u,
                                                  float* heads,
                                                  const StepParams& c) {
  constexpr int kRows = kMean ? 2 : 4;  // an agent's
  for (int r = g.lane; r < kAgents * kRows; r += G) {
    const int i = r / kRows, k = r % kRows;
    heads[kHeads * i + k] = affine_row_rt(wa + k * F, ca[k], xs + i * F, F);
  }
  __syncwarp();
  const float* z = heads + kHeads * g.agent;
  const float mu0 = tanhf(z[0]), mu1 = tanhf(z[1]);
  if (kMean) return {mu0, mu1, 0.0f};
  const float v0 = softplus(z[2]), v1 = softplus(z[3]);
  float z0, z1;
  box_muller(u[2 * g.agent], u[2 * g.agent + 1], z0, z1);
  Action a;
  a.ang_raw = mu0 + sqrtf(v0) * z0;
  a.acc_raw = mu1 + sqrtf(v1) * z1;
  a.log_prob = kLogProb ? -0.5f * ((((c.log2pi2 + logf(v0)) + logf(v1)) +
                                    z0 * z0) +
                                   z1 * z1)
                        : 0.0f;
  return a;
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
// the reset uniforms (slots 2A and up).  Every lane of the group returns
// the same outcome.
template <class E, int G>
__device__ __forceinline__ StepOutcome group_advance(E& e,
                                                     const Group<G>& g,
                                                     float ang_raw,
                                                     float acc_raw,
                                                     const float* ur,
                                                     const StepParams& c) {
  // ---- dynamics of the lane's agent ----
  const float ang =
      fminf(fmaxf(c.ang_mean + c.ang_scale * ang_raw, c.neg_pi), c.pi);
  const float acc = fminf(
      fmaxf(c.acc_mean + c.acc_scale * acc_raw, c.min_accel), c.max_accel);
  const float co = cos_pi(ang), si = sin_pi(ang);
  const float nhx = co * e.hx - si * e.hy;
  const float nhy = si * e.hx + co * e.hy;
  const float nsp = fminf(fmaxf(e.sp + acc, c.min_speed), c.max_speed);
  const float npx = e.px + nhx * nsp;
  const float npy = e.py + nhy * nsp;
  e.step_num = e.step_num + 1.0f;
  const float trunc = e.step_num > c.trunc_after ? 1.0f : 0.0f;
  float anpx[kAgents], anpy[kAgents];
#pragma unroll
  for (int j = 0; j < kAgents; ++j) {
    anpx[j] = Group<G>::from_agent(npx, j);
    anpy[j] = Group<G>::from_agent(npy, j);
  }

  // ---- the agent's reward term, from the moved, pre-reinit state ----
  const float ddx = e.tx - npx, ddy = e.ty - npy;
  const float t_dist = sqrtf(ddx * ddx + ddy * ddy);
  float prev_t_dist = 0.0f;
  if (c.group_soft) {
    const float pdx = e.tx - e.px, pdy = e.ty - e.py;
    prev_t_dist = sqrtf(pdx * pdx + pdy * pdy);
  }
  const float inv = 1.0f / fmaxf(t_dist, F32(1e-12));
  const float t_dot =
      fminf(fmaxf((nhx * ddx + nhy * ddy) * inv, F32(-1.0 + 1e-8)),
            F32(1.0 - 1e-8));
  float o_risk = 0.0f, o_coll = 0.0f;
  e.obstacle_flags(npx, npy, c, o_risk, o_coll);
  // the other agents in index order
  float n_risk = 0.0f, n_coll = 0.0f, band_sum = 0.0f, bond_sum = 0.0f;
#pragma unroll
  for (int m = 0; m < kAgents - 1; ++m) {
    const bool before = m < g.agent;
    const float ndx = (before ? anpx[m] : anpx[m + 1]) - npx;
    const float ndy = (before ? anpy[m] : anpy[m + 1]) - npy;
    const float n_dist = sqrtf(ndx * ndx + ndy * ndy);
    n_risk = fmaxf(n_risk, n_dist < c.ag_risk_dist ? 1.0f : 0.0f);
    n_coll = fmaxf(n_coll, n_dist < c.ag_coll_dist ? 1.0f : 0.0f);
    band_sum = band_sum + ((c.agents_min_d < n_dist &&
                            n_dist < c.agents_max_d) ? 1.0f : 0.0f);
    const float scaled = (n_dist - c.ideal_dist) * c.inv_bond_sharpness;
    bond_sum = bond_sum + 1.0f / (1.0f + scaled * scaled);
  }
  const float in_target = t_dist < c.target_radius ? 1.0f : 0.0f;
  const float heading =
      t_dist < c.cap_distance ? 1.0f : (t_dot > c.cos_head ? 1.0f : 0.0f);
  const float soft = -t_dist * c.inv_init_dist;
  const float dist_sc = fminf(band_sum, c.max_at_prop_d) * c.inv_max_at_prop_d;
  const float bond = bond_sum * c.inv_others;
  const float risk = fminf(o_risk + n_risk, 1.0f);
  const float coll = fminf(o_coll + n_coll, 1.0f);
  const float term = (((c.heading_factor * heading +
                        c.distance_factor * dist_sc) +
                       c.soft_factor * soft) +
                      c.bond_factor * bond) -
                     c.risk_factor * risk;

  // ---- across agents, in agent order, on every lane ----
  float reward_sum = 0.0f, all_in_target = 1.0f, any_coll = 0.0f;
  float max_t_dist = 0.0f, prev_max_t_dist = 0.0f;
#pragma unroll
  for (int j = 0; j < kAgents; ++j) {
    max_t_dist = fmaxf(max_t_dist, Group<G>::from_agent(t_dist, j));
    if (c.group_soft)
      prev_max_t_dist =
          fmaxf(prev_max_t_dist, Group<G>::from_agent(prev_t_dist, j));
    all_in_target = fminf(all_in_target, Group<G>::from_agent(in_target, j));
    any_coll = fmaxf(any_coll, Group<G>::from_agent(coll, j));
    reward_sum = reward_sum + Group<G>::from_agent(term, j);
  }
  float reward = reward_sum * c.inv_agents + c.target_factor * all_in_target;
  if (c.group_soft)
    reward = reward + c.group_soft_scale * (prev_max_t_dist - max_t_dist);

  const float terminated = fmaxf(any_coll, e.latch);
  const float finished = fmaxf(terminated, trunc);
  const float new_latch = e.latch > 0.5f ? 0.0f : all_in_target;

  // ---- auto-reset: fresh triangle draw, mask-blended ----
  const float m = finished, km = 1.0f - finished;
  e.reset_obstacles(m, km, ur, c, g);
  float bx = e.bx, by = e.by, hx0 = 1.0f;
  if (c.noisy) {
    const float* un = ur + 2 * e.num_obs() + 3 * g.agent;
    float z0, z1;
    box_muller(un[0], un[1], z0, z1);
    const float ang0 = c.angle_range * (un[2] - 0.5f);
    bx = e.bx + c.pos_std * z0;
    by = e.by + c.pos_std * z1;
    float hy0;
    if (c.wide_angle) {
      hx0 = cosf(ang0);
      hy0 = sinf(ang0);
    } else {
      hx0 = cos_pi(ang0);
      hy0 = sin_pi(ang0);
    }
    e.hy = m * hy0 + km * nhy;
  } else {
    e.hy = km * nhy;
  }
  e.px = m * bx + km * npx;
  e.py = m * by + km * npy;
  e.hx = m * hx0 + km * nhx;
  e.sp = m * c.init_speed + km * nsp;
  e.step_num = km * e.step_num;
  e.latch = new_latch;
  return {reward, trunc, any_coll, all_in_target, finished};
}

}  // namespace marlnav
