// PPO update gradients for Hopper: the actor's and the critic's loss and
// parameter-gradient sums over a set of rows, in one streaming pass each.
//
// Replaces six Pallas TPU kernels of marlnav_tpu/ops/, which compute three
// functions in two VMEM layouts each:
//   actor_grad_kernel   <- fused_update_tiled.py:157 make_tiled_actor_grad
//                          (pallas_call :226, the full-batch route) and
//                          fused_update.py:706 _make_actor_grad_affine
//                          (pallas_call :758, staged, sliced minibatches);
//   critic_grad_kernel  <- fused_update_tiled.py:265 make_tiled_critic_grad
//                          (pallas_call :347) and fused_update.py:787
//                          make_fused_critic_grad (pallas_call :844);
//   actor_grad_uncollapsed_kernel
//                       <- fused_update.py:436 make_fused_actor_grad, the
//                          "packed" layout (pallas_call :509), and :553
//                          _make_actor_grad_undilated (pallas_call :618):
//                          the actor through the 12 -> 50 -> 2+2 network
//                          itself (MARLNAV_ACTOR_LAYOUT=packed|undilated).
// The layouts were the TPU's concern; the kernels read a time slice of the
// canonical Buffer as flat rows (actor (t, p, a) rows of obs (N, F); critic
// (t, p) rows of obs (N, A*F)), so one kernel serves the full batch and any
// minibatch slice.  The plain PyTorch versions are ops/update_math.py
// actor_grad_sums_reference, actor_grad_sums_uncollapsed_reference and
// critic_grad_sums_reference; the per-row arithmetic here follows
// ops/update_math.py ppo_chain / critic_chain op for op (JAX's balanced
// min/max ties, the half-weight clip edges, relu'(0) = 0).
//
// No sequential grid: a TPU kernel carries its sums across grid steps in
// VMEM.  Here each block writes one partial per output into `partials`
// (gridDim.x, n_out), and reduce_partials_kernel, launched next on the same
// stream, sums the blocks' partials in a fixed order (in double).  There is
// no float atomicAdd, and the grid depends only on the row count and the
// card's SM count, so two launches on the same input agree bit for bit.
//
// Bounds on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32 without tensor
// cores), default configuration (F = 12, A*F = 36, H = 50), faithful full
// batch: 999 x 1024 x 3 = 3,068,928 actor rows, 1,022,976 critic rows.
//   actor:  64 B a row (obs 48, action 8, log-prob 4, advantage 4)
//           = 196 MB -> 58.6 us; ~292 float operations a row (0.9 GFLOP,
//           13 us).  Bytes bound it.  Design: one thread per row in a
//           grid-stride loop over 4 blocks an SM, the 4 x F + 4 operator in
//           shared memory, the 4F + 5 sums in registers, coalesced float2
//           loads; one warp-shuffle + shared-memory reduction a block.
//   critic: 152 B a row (obs 144, old value, return) = 155.5 MB -> 46.4 us;
//           4*In*H + 10*H + 30 operations a row (7,730: two 36 x 50
//           products, W1 x forward and g_pre x^T backward, and the chain)
//           = 7.9 GFLOP: 16.0 us on the tensor cores in TF32 (495 TFLOP/s
//           dense), 118 us on the CUDA cores (67 TFLOP/s).  With the
//           products on the tensor cores the bytes bound it.  The three
//           TF32 passes and the padding (In + 1 = 37 -> 40 and 48, H = 50
//           -> 56) make 30 GFLOP of tensor-core work, 61 us at that peak,
//           and the per-row chain stays on the CUDA cores: what the design
//           keeps busy is the tensor cores, not the memory.
//           Design (critic_grad_kernel): each warp takes 16 rows at a time,
//           on its own, with no block barrier in its loop.
//           - Loads: the rows' obs (contiguous, 16-byte cp.async a thread),
//             old values and returns go into the warp's double buffer in
//             shared memory while the rows before them are computed.
//           - Forward: pre = [x | 1] [W1^T ; b1] (the bias as a ones
//             column, K padded to 8 KS) by mma.sync m16n8k8 in 3xTF32
//             (mma_tf32.cuh), with W1 and b1 split into their TF32 halves
//             once a block, in fragment order in shared memory.
//           - Per row, in the accumulator fragments (a row's columns sit on
//             one quad of 4 lanes): ReLU, v = w2 . h + b2 by fixed-order
//             partial sums and two shuffles, critic_row, then g_pre =
//             (w2 g_v) (h > 0) and the dW2 sums; padding rows get g_v = 0.
//           - Backward: [x | 1]^T g_pre gives dW1^T and db1 in one product
//             (M = In + 1 padded to 16 MT, N = H padded to 8 NT, K = the
//             rows), its accumulators in registers across every row the
//             warp visits; g_pre reaches the B layout through a 16-row
//             tile in shared memory, x^T is read from the row buffer.
//           - A persistent grid of one block an SM; the block's warps sum
//             their accumulators in a fixed order into one partial.
//           Widths are template instances on the padded sizes (In <= 63,
//           H <= 64; critic_instance).  mma.sync, not wgmma: see
//           mma_tf32.cuh.
//   un-collapsed actor: 64 B a row, as the actor = 196 MB -> 58.6 us;
//           4*F*H + 25*H + 100 float operations a row (3,750: W1 x, the two
//           heads, the PPO chain, g_h, the four sums) = 11.5 GFLOP: 23 us
//           in TF32 on the tensor cores, 172 us on the CUDA cores.  Design:
//           the shared-memory tiles of the critic kernel before it moved to
//           the tensor cores, with the actor's chain; the H*F + 5H + 5 sums
//           split over the block (H*F entries over all threads, 5 a hidden
//           unit, 5 a tile row).  Its products run on the CUDA cores; the
//           helpers of mma_tf32.cuh serve its redesign.
// Built with -fmad=false like the collect kernel (one flag set for the
// port's libraries): every multiply and add rounds separately, as PyTorch's
// elementwise operations do, at the price of the fused multiply-adds the
// CUDA-core products would otherwise use.  The flag does not touch the
// tensor cores' mma instructions.
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tf32.cuh"

namespace marlnav {
namespace update {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;  // the wrapper sizes the grid with it
constexpr int kMaxObs = 24;      // actor widths instantiated: even 2 .. 24
constexpr int kTileRows = 64;    // rows staged a tile (un-collapsed actor)
constexpr int kMaxHidden = 64;   // un-collapsed actor
constexpr int kCriticMaxIn = 63;
constexpr int kCriticMaxHidden = 64;
// dW1 entries a thread of the un-collapsed actor kernel (H <= kMaxHidden,
// F <= kMaxObs).
constexpr int kMaxUncollapsedEntries =
    (kMaxHidden * kMaxObs + kThreads - 1) / kThreads;
constexpr float kLog2Pi2 = static_cast<float>(2.0 * 1.8378770664093453);
constexpr float kEnt0 = static_cast<float>(1.0 + 1.8378770664093453);

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float flag(bool b) { return b ? 1.f : 0.f; }

// d clip(x, lo, hi) / dx: 1 inside, 0 outside, 1/2 exactly on a bound.
__device__ __forceinline__ float clip_grad(float x, float lo, float hi) {
  const float inside = flag(x > lo) * flag(x < hi);
  const float on_edge = flag(x == lo) + flag(x == hi);
  return inside + 0.5f * on_edge;
}

// The PPO constants of the actor objective.
struct PpoConsts {
  float lo, hi;           // 1 - eps, 1 + eps
  float ent_c, ent_half;  // ent_const, ent_const * 0.5
};

struct ActorArgs {
  const float* obs;  // (N, F)
  const float* act;  // (N, 2)
  const float* lp;   // (N,) behaviour log-probs
  const float* adv;  // (N,)
  const float* op;   // (4F + 4): a_comp row-major, then c_comp
  long long n_rows;
  PpoConsts k;
  float* partials;   // (gridDim.x, 1 + 4F + 4)
};

// One row of update_math.ppo_chain: the row's loss term, and g_z =
// [g_u0, g_u1, g_s0, g_s1] from z = [u0, u1, s0, s1].
__device__ __forceinline__ float ppo_row(const float z[4], float2 a,
                                         float lp_b, float adv,
                                         const PpoConsts& k, float g_z[4]) {
  const float act[2] = {a.x, a.y};
  float mu[2], e_s[2], var[2], diff[2], inv_var[2], log_var[2], zz[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float s = z[2 + c];
    mu[c] = tanhf(z[c]);
    e_s[c] = expf(-fabsf(s));
    var[c] = fmaxf(s, 0.f) + log1pf(e_s[c]);
    diff[c] = act[c] - mu[c];
    inv_var[c] = 1.f / var[c];
    log_var[c] = logf(var[c]);
    zz[c] = diff[c] * diff[c] * inv_var[c];
  }
  const float lv_sum = log_var[0] + log_var[1];
  const float lp_new = -0.5f * (kLog2Pi2 + lv_sum + zz[0] + zz[1]);
  const float ent = kEnt0 + 0.5f * lv_sum;

  const float ratio = expf(lp_new - lp_b);
  const float clipped = fminf(fmaxf(ratio, k.lo), k.hi);
  const float o1 = ratio * adv;
  const float o2 = clipped * adv;
  const float obj = fminf(o1, o2);
  const float loss = -(obj + k.ent_c * ent);

  const float w_o1 = flag(o1 < o2) + 0.5f * flag(o1 == o2);
  const float w_o2 = 1.f - w_o1;
  const float dclip = clip_grad(ratio, k.lo, k.hi);
  const float g_ratio = -adv * (w_o1 + w_o2 * dclip);
  const float g_lp = g_ratio * ratio;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float s = z[2 + c];
    const float g_mu = g_lp * diff[c] * inv_var[c];
    const float g_var =
        g_lp * 0.5f * (zz[c] - 1.f) * inv_var[c] - k.ent_half * inv_var[c];
    g_z[c] = g_mu * (1.f - mu[c] * mu[c]);
    const float r_e = 1.f / (1.f + e_s[c]);
    g_z[2 + c] = g_var * (s >= 0.f ? r_e : e_s[c] * r_e);
  }
  return loss;
}

template <int F>
__global__ void __launch_bounds__(kThreads)
    actor_grad_kernel(const ActorArgs args) {
  constexpr int kOut = 1 + 4 * F + 4;  // loss, dz (4, F), dzs (4)
  __shared__ float s_op[4 * F + 4];
  __shared__ float s_red[kWarps][kOut];
  for (int i = threadIdx.x; i < 4 * F + 4; i += kThreads) s_op[i] = args.op[i];
  __syncthreads();

  float loss = 0.f, dz[4][F], dzs[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    dzs[c] = 0.f;
#pragma unroll
    for (int f = 0; f < F; ++f) dz[c][f] = 0.f;
  }

  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long row = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
       row < args.n_rows; row += stride) {
    float x[F];
    const float2* xr = reinterpret_cast<const float2*>(args.obs + row * F);
#pragma unroll
    for (int f = 0; f < F / 2; ++f) {
      const float2 v = xr[f];
      x[2 * f] = v.x;
      x[2 * f + 1] = v.y;
    }
    float z[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int f = 0; f < F; ++f) acc = acc + s_op[c * F + f] * x[f];
      z[c] = acc + s_op[4 * F + c];
    }
    float g_z[4];
    loss += ppo_row(z, reinterpret_cast<const float2*>(args.act)[row],
                    args.lp[row], args.adv[row], args.k, g_z);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dzs[c] += g_z[c];
#pragma unroll
      for (int f = 0; f < F; ++f) dz[c][f] += g_z[c] * x[f];
    }
  }

  // Block reduction: warp shuffles, then the warps in order.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v = warp_sum(loss);
  if (lane == 0) s_red[warp][0] = v;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      v = warp_sum(dz[c][f]);
      if (lane == 0) s_red[warp][1 + c * F + f] = v;
    }
    v = warp_sum(dzs[c]);
    if (lane == 0) s_red[warp][1 + 4 * F + c] = v;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kOut; k += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += s_red[w][k];
    args.partials[static_cast<long long>(blockIdx.x) * kOut + k] = s;
  }
}

struct CriticArgs {
  const float* obs;   // (N, In)
  const float* vold;  // (N,) behaviour values
  const float* ret;   // (N,)
  const float* w1;    // (H, In)
  const float* b1;    // (H,)
  const float* w2;    // (1, H)
  const float* b2;    // (1,)
  long long n_rows;
  int in_size, hidden;
  float eps;
  bool vec4;        // obs rows load in 16-byte copies (In % 4 == 0, aligned)
  float* partials;  // (gridDim.x, 1 + H*In + 2H + 1)
};

// The instances of critic_grad_kernel: KS k-steps of 8 over [x | 1] (In + 1
// <= 8 KS), NT n-tiles of 8 over the hidden units (H <= 8 NT).  False
// outside the range the instances cover.
inline bool critic_instance(int in, int hid, int* ks, int* nt) {
  if (in < 1 || in > kCriticMaxIn || hid < 1 || hid > kCriticMaxHidden)
    return false;
  const int k = (in + 8) / 8, n = (hid + 7) / 8;
  *ks = k <= 3 ? 3 : k <= 5 ? 5 : k <= 6 ? 6 : 8;
  *nt = n <= 4 ? 4 : n <= 7 ? 7 : 8;
  return true;
}

// Warps a block, one block an SM.  With 8 a thread may hold 255 registers:
// the default instance takes 211 without spilling.  12 warps cap it at 168,
// where it spilled and ran 9% slower on an H100 (0.239 against 0.218 ms at
// 1,022,976 rows).
constexpr int kCriticWarps = 8;

// Shared memory of one instance, in floats.  The row buffer's stride LDX
// (= 4 mod 8) keeps the forward A loads free of bank conflicts (the
// transposed backward loads have 2-way ones); g_pre's LDG (= 8 or 24 mod
// 32) keeps the backward B loads free of them.
template <int KS, int NT>
struct CriticShape {
  static constexpr int kMt = (KS + 1) / 2;  // backward m-tiles over [x | 1]
  static constexpr int kLdx = kMt * 16 + 4;
  static constexpr int kLdg = NT * 8 % 16 == 0 ? NT * 8 + 8 : NT * 8;
  // a warp: rows (2, 16, LDX), g_pre (16, LDG), old values and returns (2,
  // 32)
  static constexpr int kWarpFloats = 2 * 16 * kLdx + 16 * kLdg + 2 * 32;
  static constexpr int kFragFloats = KS * NT * 32 * 4;  // W1 | b1, split
  static constexpr int kMainFloats =
      kFragFloats + NT * 8 + kCriticWarps * kWarpFloats;
};

// Start the copies of rows 16 chunk .. 16 chunk + 15 (those below n_rows)
// into one buffer of a warp: obs into sx (16, LDX), old values and returns
// into svr (32,).
template <int LDX>
__device__ __forceinline__ void critic_prefetch(const CriticArgs& a,
                                                long long chunk, float* sx,
                                                float* svr, int lane) {
  const long long r0 = chunk * 16;
  const int rows = static_cast<int>(a.n_rows - r0 < 16 ? a.n_rows - r0 : 16);
  const int in = a.in_size;
  const float* src = a.obs + r0 * in;
  if (a.vec4) {
    const int per_row = in / 4, units = rows * per_row;
    for (int u = lane; u < units; u += 32) {
      const int r = u / per_row;
      mma::cp_async16(sx + r * LDX + 4 * (u - r * per_row), src + 4 * u);
    }
  } else {
    const int units = rows * in;
    for (int u = lane; u < units; u += 32) {
      const int r = u / in;
      mma::cp_async4(sx + r * LDX + (u - r * in), src + u);
    }
  }
  if (lane < rows)
    mma::cp_async4(svr + lane, a.vold + r0 + lane);
  else if (lane >= 16 && lane - 16 < rows)
    mma::cp_async4(svr + lane, a.ret + r0 + lane - 16);
}

// One row of update_math.critic_chain; returns g_v, the loss term in *loss.
__device__ __forceinline__ float critic_row(float v, float vold, float ret,
                                           float eps, float* loss) {
  const float lo = vold - eps, hi = vold + eps;
  const float clamped = fminf(fmaxf(v, lo), hi);
  const float e1 = v - ret;
  const float e2 = clamped - ret;
  const float d1 = e1 * e1;
  const float d2 = e2 * e2;
  *loss = fmaxf(d1, d2);
  const float w_d2 = flag(d1 < d2) + 0.5f * flag(d1 == d2);
  const float w_d1 = 1.f - w_d2;
  return 2.f * (w_d1 * e1 + w_d2 * e2 * clip_grad(v, lo, hi));
}

template <int KS, int NT>
__global__ void __launch_bounds__(kCriticWarps * 32, 1)
    critic_grad_kernel(const CriticArgs args) {
  constexpr int W = kCriticWarps;
  using Shape = CriticShape<KS, NT>;
  constexpr int MT = Shape::kMt, LDX = Shape::kLdx, LDG = Shape::kLdg;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int in = args.in_size, hid = args.hidden;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // (KS, NT, 32) B fragments of [W1^T ; b1]: big b0, big b1, small b0,
  // small b1 a lane.
  const float4* s_wf = smem4;
  float* s_w2 = smem + Shape::kFragFloats;  // (8 NT,), zero-padded
  float* s_x = s_w2 + NT * 8 + warp * Shape::kWarpFloats;  // (2, 16, LDX)
  float* s_g = s_x + 2 * 16 * LDX;                         // (16, LDG)
  float* s_vr = s_g + 16 * LDG;  // (2, 32): 16 old values, 16 returns

  for (int i = tid; i < KS * NT * 32; i += W * 32) {
    const int l = i & 31, nt = (i >> 5) % NT, ks = (i >> 5) / NT;
    const int n = nt * 8 + (l >> 2), k = ks * 8 + (l & 3);
    float b[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = k + 4 * h;
      b[h] = n >= hid ? 0.f
             : kk < in ? args.w1[n * in + kk]
             : kk == in ? args.b1[n]
                        : 0.f;
    }
    uint32_t big[2], small[2];
    mma::split(b, big, small);
    smem4[i] = make_float4(__uint_as_float(big[0]), __uint_as_float(big[1]),
                           __uint_as_float(small[0]),
                           __uint_as_float(small[1]));
  }
  for (int j = tid; j < NT * 8; j += W * 32)
    s_w2[j] = j < hid ? args.w2[j] : 0.f;
  // Zero the warp's buffers (rows past n_rows stay finite), then the ones
  // column of [x | 1] in both row buffers.
  for (int i = lane; i < Shape::kWarpFloats; i += 32) s_x[i] = 0.f;
  __syncwarp();
  s_x[lane * LDX + in] = 1.f;
  const float b2 = args.b2[0];
  __syncthreads();

  float bacc[MT][NT][4];  // [x | 1]^T g_pre: dW1^T, then db1 in row In
  float acc_w2[NT][2];    // dW2, columns 8 nt + 2t, + 1, over this lane's rows
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    acc_w2[nt][0] = acc_w2[nt][1] = 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) bacc[mt][nt][i] = 0.f;
  }
  float acc_loss = 0.f, acc_b2 = 0.f;  // lanes t == 0: rows g and g + 8

  const long long n = args.n_rows, n_chunks = (n + 15) / 16;
  const long long stride = static_cast<long long>(gridDim.x) * W;
  long long chunk = static_cast<long long>(blockIdx.x) * W + warp;
  if (chunk < n_chunks) critic_prefetch<LDX>(args, chunk, s_x, s_vr, lane);
  mma::cp_async_commit();
  for (int buf = 0; chunk < n_chunks; chunk += stride, buf ^= 1) {
    const long long next = chunk + stride;
    if (next < n_chunks)
      critic_prefetch<LDX>(args, next, s_x + (buf ^ 1) * 16 * LDX,
                           s_vr + (buf ^ 1) * 32, lane);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncwarp();
    const float* x = s_x + buf * 16 * LDX;
    const float* vr = s_vr + buf * 32;

    // Forward: pre = [x | 1] [W1^T ; b1] over the 16 rows.
    float c[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      float a[4];
      uint32_t a_big[4], a_small[4];
      mma::load_a_rows(x + ks * 8, LDX, lane, a);
      mma::split(a, a_big, a_small);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float4 w = s_wf[(ks * NT + nt) * 32 + lane];
        const uint32_t b_big[2] = {__float_as_uint(w.x), __float_as_uint(w.y)};
        const uint32_t b_small[2] = {__float_as_uint(w.z),
                                     __float_as_uint(w.w)};
        mma::mma_3xtf32(c[nt], a_big, a_small, b_big, b_small);
      }
    }

    // h = relu(pre) in place; v of rows g and g + 8 from the quad's
    // fixed-order partial sums.
    float p[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 w = *reinterpret_cast<const float2*>(s_w2 + nt * 8 + 2 * t);
#pragma unroll
      for (int i = 0; i < 4; ++i) c[nt][i] = fmaxf(c[nt][i], 0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        p[h] = p[h] + w.x * c[nt][2 * h];
        p[h] = p[h] + w.y * c[nt][2 * h + 1];
      }
    }
    float gv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      p[h] = p[h] + __shfl_xor_sync(0xffffffffu, p[h], 1);
      p[h] = p[h] + __shfl_xor_sync(0xffffffffu, p[h], 2);
      const int row = g + 8 * h;
      float loss;
      const float gvr = critic_row(p[h] + b2, vr[row], vr[16 + row],
                                   args.eps, &loss);
      const bool valid = chunk * 16 + row < n;
      gv[h] = valid ? gvr : 0.f;
      if (valid && t == 0) {
        acc_loss += loss;
        acc_b2 += gvr;
      }
    }

    // g_pre = (w2 g_v) (h > 0) into the warp's tile; dW2 += g_v h.
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 w = *reinterpret_cast<const float2*>(s_w2 + nt * 8 + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float h0 = c[nt][2 * h], h1 = c[nt][2 * h + 1];
        *reinterpret_cast<float2*>(s_g + (g + 8 * h) * LDG + nt * 8 + 2 * t) =
            make_float2((w.x * gv[h]) * flag(h0 > 0.f),
                        (w.y * gv[h]) * flag(h1 > 0.f));
        acc_w2[nt][0] += gv[h] * h0;
        acc_w2[nt][1] += gv[h] * h1;
      }
    }
    __syncwarp();

    // Backward: [x | 1]^T g_pre, K = the 16 rows in two steps of 8.
#pragma unroll
    for (int kr = 0; kr < 2; ++kr) {
      uint32_t a_big[MT][4], a_small[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float a[4];
        mma::load_a_cols(x + kr * 8 * LDX + mt * 16, LDX, lane, a);
        mma::split(a, a_big[mt], a_small[mt]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float b[2];
        uint32_t b_big[2], b_small[2];
        mma::load_b_rows(s_g + kr * 8 * LDG + nt * 8, LDG, lane, b);
        mma::split(b, b_big, b_small);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma::mma_3xtf32(bacc[mt][nt], a_big[mt], a_small[mt], b_big,
                          b_small);
      }
    }
    __syncwarp();  // the buffers are refilled next
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  // The block's partial: each warp's sums into its row of red (W, n_out),
  // then the warps summed in order.  red reuses all of shared memory.
  const int n_w1 = hid * in, n_out = 1 + n_w1 + 2 * hid + 1;
  float* red = smem;
  float* mine = red + warp * n_out;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = mt * 16 + g + 8 * (i >> 1);
        const int j = nt * 8 + 2 * t + (i & 1);
        if (j < hid && m <= in)
          mine[m < in ? 1 + j * in + m : 1 + n_w1 + j] = bacc[mt][nt][i];
      }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = acc_w2[nt][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      const int j = nt * 8 + 2 * t + e;
      if (g == 0 && j < hid) mine[1 + n_w1 + hid + j] = s;
    }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    acc_loss += __shfl_xor_sync(0xffffffffu, acc_loss, off);
    acc_b2 += __shfl_xor_sync(0xffffffffu, acc_b2, off);
  }
  if (lane == 0) {
    mine[0] = acc_loss;
    mine[n_out - 1] = acc_b2;
  }
  __syncthreads();
  for (int k = tid; k < n_out; k += W * 32) {
    float s = 0.f;
    for (int w = 0; w < W; ++w) s += red[w * n_out + k];
    args.partials[static_cast<long long>(blockIdx.x) * n_out + k] = s;
  }
}

struct UncollapsedArgs {
  const float* obs;   // (N, F)
  const float* act;   // (N, 2)
  const float* lp;    // (N,) behaviour log-probs
  const float* adv;   // (N,)
  const float* w1;    // (H, F)
  const float* b1;    // (H,)
  const float* wmu;   // (2, H)
  const float* bmu;   // (2,)
  const float* wvar;  // (2, H)
  const float* bvar;  // (2,)
  long long n_rows;
  int obs_size, hidden;
  PpoConsts k;
  float* partials;  // (gridDim.x, 1 + H*F + H + 2*(2H + 2))
};

// Dynamic shared memory of actor_grad_uncollapsed_kernel, in floats.  Odd
// row strides for W1 and the activations keep the column-wise reads free
// of bank conflicts.
constexpr int uncollapsed_smem_floats(int obs_size, int hidden) {
  return hidden * (obs_size | 1) + hidden + 4 * hidden + 4 +
         kTileRows * obs_size + kTileRows * (hidden | 1) + 4 * kTileRows +
         5 * kTileRows;
}
static_assert(sizeof(float) * uncollapsed_smem_floats(kMaxObs, kMaxHidden) <=
                  48 * 1024,
              "the widest instance fits the default 48 KiB of dynamic "
              "shared memory");

// The actor's loss and its five gradient sums through the network itself
// (update_math.actor_grad_sums_uncollapsed_reference): the critic kernel's
// design with the actor's PPO chain.  A block stages a 64-row tile of obs
// and of h = W1 x + b1 (then g_h) in shared memory; the H*F entries of
// dW1 are split over the block's threads, the 4H of dWmu and dWvar and
// the H of db1 go to one thread a unit, the loss and the head biases' 4
// sums to one thread a tile row.
__global__ void __launch_bounds__(kThreads)
    actor_grad_uncollapsed_kernel(const UncollapsedArgs args) {
  extern __shared__ float smem[];
  const int in = args.obs_size, hid = args.hidden;
  const int ldw = in | 1, ldh = hid | 1, tid = threadIdx.x;
  float* s_w1 = smem;                  // (H, ldw)
  float* s_b1 = s_w1 + hid * ldw;      // (H,)
  float* s_wh = s_b1 + hid;            // (4, H): Wmu rows, then Wvar rows
  float* s_bh = s_wh + 4 * hid;        // (4,): bmu, then bvar
  float* s_x = s_bh + 4;               // (kTileRows, F)
  float* s_h = s_x + kTileRows * in;   // (kTileRows, ldh): h, then g_h
  float* s_g = s_h + kTileRows * ldh;  // (kTileRows, 4): g_u, then g_s
  float* s_red = s_g + 4 * kTileRows;  // (5, kTileRows)
  for (int i = tid; i < hid * in; i += kThreads)
    s_w1[(i / in) * ldw + i % in] = args.w1[i];
  for (int j = tid; j < hid; j += kThreads) s_b1[j] = args.b1[j];
  for (int i = tid; i < 2 * hid; i += kThreads) {
    s_wh[i] = args.wmu[i];
    s_wh[2 * hid + i] = args.wvar[i];
  }
  if (tid < 2) {
    s_bh[tid] = args.bmu[tid];
    s_bh[2 + tid] = args.bvar[tid];
  }
  __syncthreads();

  const int n_w1 = hid * in;
  float acc[kMaxUncollapsedEntries];  // dW1 entries tid + m * kThreads
#pragma unroll
  for (int m = 0; m < kMaxUncollapsedEntries; ++m) acc[m] = 0.f;
  float acc_b1 = 0.f, acc_wh[4] = {0.f, 0.f, 0.f, 0.f};  // unit tid < H
  float acc_loss = 0.f, acc_bh[4] = {0.f, 0.f, 0.f, 0.f};  // row tid < 64

  const long long n_tiles = (args.n_rows + kTileRows - 1) / kTileRows;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = tile * kTileRows;
    const int rows = static_cast<int>(
        args.n_rows - r0 < kTileRows ? args.n_rows - r0 : kTileRows);
    const float* src = args.obs + r0 * in;
    for (int i = tid; i < kTileRows * in; i += kThreads)
      s_x[i] = i < rows * in ? src[i] : 0.f;
    __syncthreads();

    // Forward: h = W1 x + b1 (no activation), one (row, unit) pair a thread.
    for (int p = tid; p < kTileRows * hid; p += kThreads) {
      const int r = p / hid, j = p - r * hid;
      const float* w = s_w1 + j * ldw;
      const float* x = s_x + r * in;
      float a = 0.f;
      for (int k = 0; k < in; ++k) a = a + w[k] * x[k];
      s_h[r * ldh + j] = a + s_b1[j];
    }
    __syncthreads();

    // The heads z = [Wmu; Wvar] h + [bmu; bvar] and the PPO chain, one row
    // a thread; padding rows get g = 0.
    if (tid < kTileRows) {
      float g[4] = {0.f, 0.f, 0.f, 0.f};
      if (tid < rows) {
        const float* h = s_h + tid * ldh;
        float z[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float* w = s_wh + c * hid;
          float a = 0.f;
          for (int j = 0; j < hid; ++j) a = a + w[j] * h[j];
          z[c] = a + s_bh[c];
        }
        const long long row = r0 + tid;
        acc_loss += ppo_row(z, reinterpret_cast<const float2*>(args.act)[row],
                            args.lp[row], args.adv[row], args.k, g);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc_bh[c] += g[c];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) s_g[tid * 4 + c] = g[c];
    }
    __syncthreads();

    // dWmu, dWvar = sum g h^T; then g_h = Wmu^T g_u + Wvar^T g_s in place
    // of h, and db1 = sum g_h: one hidden unit a thread.
    if (tid < hid) {
      float w[4], sw[4] = {0.f, 0.f, 0.f, 0.f}, sb = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) w[c] = s_wh[c * hid + tid];
      for (int r = 0; r < kTileRows; ++r) {
        const float h = s_h[r * ldh + tid];
        const float* g = s_g + 4 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) sw[c] = sw[c] + g[c] * h;
        const float gh =
            ((w[0] * g[0] + w[1] * g[1]) + w[2] * g[2]) + w[3] * g[3];
        s_h[r * ldh + tid] = gh;
        sb = sb + gh;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) acc_wh[c] += sw[c];
      acc_b1 += sb;
    }
    __syncthreads();

    // dW1 = sum g_h x^T over the tile, each thread its own entries.
#pragma unroll
    for (int m = 0; m < kMaxUncollapsedEntries; ++m) {
      const int e = tid + m * kThreads;
      if (e < n_w1) {
        const int j = e / in, k = e - j * in;
        float s = 0.f;
        for (int r = 0; r < kTileRows; ++r)
          s = s + s_h[r * ldh + j] * s_x[r * in + k];
        acc[m] += s;
      }
    }
    __syncthreads();
  }

  // This block's partials: loss, dW1 (H, F), db1 (H), dWmu (2, H), dbmu
  // (2), dWvar (2, H), dbvar (2).
  const int o_b1 = 1 + n_w1, o_wmu = o_b1 + hid, o_bmu = o_wmu + 2 * hid;
  const int o_wvar = o_bmu + 2, o_bvar = o_wvar + 2 * hid, n_out = o_bvar + 2;
  float* out = args.partials + static_cast<long long>(blockIdx.x) * n_out;
#pragma unroll
  for (int m = 0; m < kMaxUncollapsedEntries; ++m) {
    const int e = tid + m * kThreads;
    if (e < n_w1) out[1 + e] = acc[m];
  }
  if (tid < hid) {
    out[o_b1 + tid] = acc_b1;
    out[o_wmu + tid] = acc_wh[0];
    out[o_wmu + hid + tid] = acc_wh[1];
    out[o_wvar + tid] = acc_wh[2];
    out[o_wvar + hid + tid] = acc_wh[3];
  }
  if (tid < kTileRows) {
    s_red[tid] = acc_loss;
#pragma unroll
    for (int c = 0; c < 4; ++c) s_red[(1 + c) * kTileRows + tid] = acc_bh[c];
  }
  __syncthreads();
  if (tid < 5) {
    float v = 0.f;
    for (int r = 0; r < kTileRows; ++r) v += s_red[tid * kTileRows + r];
    // tid 0: the loss; 1, 2: dbmu; 3, 4: dbvar.
    out[tid == 0 ? 0 : (tid < 3 ? o_bmu + tid - 1 : o_bvar + tid - 3)] = v;
  }
}

// out[c] = sum over blocks b, in order, of partials[b, c] (in double).
__global__ void reduce_partials_kernel(const float* partials, int blocks,
                                       int n_out, float* out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_out) return;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b)
    s += static_cast<double>(partials[static_cast<long long>(b) * n_out + c]);
  out[c] = static_cast<float>(s);
}

inline cudaError_t reduce(const float* partials, int blocks, int n_out,
                          float* out, cudaStream_t s) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials_kernel<<<(n_out + kThreads - 1) / kThreads, kThreads, 0,
                           s>>>(partials, blocks, n_out, out);
  return cudaGetLastError();
}

template <int KS, int NT>
cudaError_t launch_critic(const CriticArgs& args, int blocks,
                          cudaStream_t s) {
  constexpr int W = kCriticWarps, kMain = CriticShape<KS, NT>::kMainFloats;
  const int n_out = 1 + args.hidden * args.in_size + 2 * args.hidden + 1;
  const int floats = kMain > W * n_out ? kMain : W * n_out;
  const int smem = static_cast<int>(sizeof(float)) * floats;
  cudaError_t err = cudaFuncSetAttribute(
      critic_grad_kernel<KS, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  critic_grad_kernel<KS, NT><<<blocks, W * 32, smem, s>>>(args);
  return cudaGetLastError();
}

}  // namespace update
}  // namespace marlnav

extern "C" {

int marlnav_update_blocks_per_sm() { return marlnav::update::kBlocksPerSm; }
int marlnav_actor_max_obs() { return marlnav::update::kMaxObs; }
int marlnav_critic_max_hidden() { return marlnav::update::kCriticMaxHidden; }
int marlnav_critic_max_in() { return marlnav::update::kCriticMaxIn; }
int marlnav_uncollapsed_max_hidden() { return marlnav::update::kMaxHidden; }
int marlnav_uncollapsed_tile_rows() { return marlnav::update::kTileRows; }

// Warps a block of the critic kernel's instance for (In, H), 16 rows a warp
// at a time; 0 outside the widths it takes.
int marlnav_critic_warps(int in_size, int hidden) {
  int ks, nt;
  return marlnav::update::critic_instance(in_size, hidden, &ks, &nt)
             ? marlnav::update::kCriticWarps
             : 0;
}

// Both launch on `stream` (a cudaStream_t from torch.cuda.current_stream()):
// the grad kernel on `blocks` blocks, then the fixed-order reduction of its
// partials into `out`.  They return cudaGetLastError(): 0 when both
// launches were accepted.

// out: loss_sum, dz (4, F), dzs (4).
int marlnav_actor_grad_sums(const float* obs, const float* act,
                            const float* lp, const float* adv,
                            const float* op, long long n_rows, int obs_size,
                            float lo, float hi, float ent_c, float ent_half,
                            int blocks, float* partials, float* out,
                            int device, void* stream) {
  using namespace marlnav::update;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ActorArgs args{obs, act, lp, adv, op, n_rows,
                       {lo, hi, ent_c, ent_half}, partials};
#define MARLNAV_LAUNCH(F)                                         \
  case F:                                                        \
    actor_grad_kernel<F><<<blocks, kThreads, 0, s>>>(args);       \
    break;
  switch (obs_size) {
    MARLNAV_LAUNCH(2)
    MARLNAV_LAUNCH(4)
    MARLNAV_LAUNCH(6)
    MARLNAV_LAUNCH(8)
    MARLNAV_LAUNCH(10)
    MARLNAV_LAUNCH(12)
    MARLNAV_LAUNCH(14)
    MARLNAV_LAUNCH(16)
    MARLNAV_LAUNCH(18)
    MARLNAV_LAUNCH(20)
    MARLNAV_LAUNCH(22)
    MARLNAV_LAUNCH(24)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MARLNAV_LAUNCH
  return static_cast<int>(reduce(partials, blocks, 1 + 4 * obs_size + 4,
                                 out, s));
}

// out: loss_sum, dW1 (H, In), db1 (H), dW2 (H), db2.
int marlnav_critic_grad_sums(const float* obs, const float* vold,
                             const float* ret, const float* w1,
                             const float* b1, const float* w2,
                             const float* b2, long long n_rows, int in_size,
                             int hidden, float eps, int blocks,
                             float* partials, float* out, int device,
                             void* stream) {
  using namespace marlnav::update;
  int ks, nt;
  if (!critic_instance(in_size, hidden, &ks, &nt))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 =
      in_size % 4 == 0 && reinterpret_cast<std::uintptr_t>(obs) % 16 == 0;
  const CriticArgs args{obs, vold, ret, w1, b1, w2, b2, n_rows,
                        in_size, hidden, eps, vec4, partials};
#define MARLNAV_CRITIC(KS, NT) \
  if (ks == KS && nt == NT) err = launch_critic<KS, NT>(args, blocks, s); else
  MARLNAV_CRITIC(3, 4) MARLNAV_CRITIC(3, 7) MARLNAV_CRITIC(3, 8)
  MARLNAV_CRITIC(5, 4) MARLNAV_CRITIC(5, 7) MARLNAV_CRITIC(5, 8)
  MARLNAV_CRITIC(6, 4) MARLNAV_CRITIC(6, 7) MARLNAV_CRITIC(6, 8)
  MARLNAV_CRITIC(8, 4) MARLNAV_CRITIC(8, 7) MARLNAV_CRITIC(8, 8)
  err = cudaErrorInvalidValue;
#undef MARLNAV_CRITIC
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce(partials, blocks,
                                 1 + hidden * in_size + 2 * hidden + 1, out,
                                 s));
}

// out: loss_sum, dW1 (H, F), db1 (H), dWmu (2, H), dbmu (2), dWvar (2, H),
// dbvar (2).
int marlnav_actor_grad_uncollapsed_sums(
    const float* obs, const float* act, const float* lp, const float* adv,
    const float* w1, const float* b1, const float* wmu, const float* bmu,
    const float* wvar, const float* bvar, long long n_rows, int obs_size,
    int hidden, float lo, float hi, float ent_c, float ent_half, int blocks,
    float* partials, float* out, int device, void* stream) {
  using namespace marlnav::update;
  if (obs_size < 1 || obs_size > kMaxObs || hidden < 1 ||
      hidden > kMaxHidden)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * uncollapsed_smem_floats(obs_size,
                                                              hidden);
  const UncollapsedArgs args{obs, act, lp, adv, w1, b1, wmu, bmu, wvar, bvar,
                             n_rows, obs_size, hidden,
                             {lo, hi, ent_c, ent_half}, partials};
  actor_grad_uncollapsed_kernel<<<blocks, kThreads, smem, s>>>(args);
  return static_cast<int>(reduce(partials, blocks,
                                 1 + hidden * obs_size + 5 * hidden + 4, out,
                                 s));
}

}  // extern "C"
