// PPO update gradients for Hopper: the actor's and the critic's loss and
// parameter-gradient sums over a set of rows, in one streaming pass each.
//
// Replaces six Pallas TPU kernels of marlnav_tpu/ops/, which compute three
// functions in two VMEM layouts each:
//   actor_grad_kernel   <- fused_update_tiled.py:157 make_tiled_actor_grad
//                          (pallas_call :226, the full-batch route) and
//                          fused_update.py:706 _make_actor_grad_affine
//                          (pallas_call :758, staged, sliced minibatches);
//   tc_grad_kernel<CriticHead>
//                       <- fused_update_tiled.py:265 make_tiled_critic_grad
//                          (pallas_call :347) and fused_update.py:787
//                          make_fused_critic_grad (pallas_call :844);
//   tc_grad_kernel<ActorHead>
//                       <- fused_update.py:436 make_fused_actor_grad, the
//                          "packed" layout (pallas_call :509), and :553
//                          _make_actor_grad_undilated (pallas_call :618):
//                          the actor through the F -> H -> 2+2 network
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
// cores, 495 TFLOP/s TF32 on them), default configuration (F = 12, A*F =
// 36, H = 50), faithful full batch: 999 x 1024 x 3 = 3,068,928 actor rows,
// 1,022,976 critic rows.
//   actor:  64 B a row (obs 48, action 8, log-prob 4, advantage 4)
//           = 196 MB -> 58.6 us; ~292 float operations a row (0.9 GFLOP,
//           13 us).  Bytes bound it.  Design: one thread per row in a
//           grid-stride loop over 4 blocks an SM, the 4 x F + 4 operator in
//           shared memory, the 4F + 5 sums in registers, coalesced float2
//           loads; one warp-shuffle + shared-memory reduction a block.
//           Instances: even F = 2 .. 32.
//   critic: 152 B a row (obs 144, old value, return) = 155.5 MB -> 46.4 us;
//           4*In*H + 10*H + 30 operations a row (7,730: two 36 x 50
//           products and the chain) = 7.9 GFLOP: 16.0 us in TF32, 118 us
//           on the CUDA cores.  The bytes bound it.
//   un-collapsed actor: 64 B a row, as the actor = 196 MB -> 58.6 us;
//           4*F*H + 25*H + 100 operations a row (3,750: W1 x, the heads,
//           the PPO chain, g_h and the sums) = 11.5 GFLOP: 23 us in TF32,
//           172 us on the CUDA cores.  The bytes bound it.
// Both run on one body, tc_grad_kernel<Head, KS>, whose two products run on
// the tensor cores by mma.sync m16n8k8 in 3xTF32 (mma_tf32.cuh); the three
// TF32 passes and the padding make the tensor cores, not the memory, what
// the design keeps busy.
//   - Rows: each warp takes 16 rows at a time (a chunk).  Their obs
//     (16-byte cp.async a thread where In % 4 == 0, else 4-byte copies) and
//     the head's per-row inputs go into the warp's double buffer in shared
//     memory while the rows before them are computed.
//   - Forward: pre = [x | 1] [W1^T ; b1] (the bias as a ones column, K
//     padded to 8 KS); W1 and b1 sit in shared memory once a block in
//     fragment order, split into their TF32 halves (or as floats, split at
//     each load, where the halves do not fit beside 8 warps' buffers).
//   - The head, per row in the accumulator fragments (a row's columns sit
//     on one quad of 4 lanes; fixed-order partial sums and two xor
//     shuffles give every lane of the quad the same sums):
//       critic: ReLU, v = w2 . h + b2, critic_row, g_pre = (w2 g_v)(h > 0),
//         and the dW2 and db2 sums in registers;
//       actor: no activation (the reference's quirk), z = [Wmu; Wvar] h +
//         [bmu; bvar] (4 outputs), ppo_row, g_h = [Wmu; Wvar]^T g_z; h and
//         g_z go to shared memory for a third product, dWh = g_z^T h, and
//         the head biases' sums stay in registers.
//     Padding rows (past n_rows) get zero gradients.
//   - Backward: [x | 1]^T g_pre (dW1^T, with db1 as its last row; M = In +
//     1 padded to 16 MT, N = H padded to 8 NT, K = the rows), and for the
//     actor g_z^T h as one more m-tile, accumulated across every chunk in
//     registers.  Where a warp's registers hold every output tile (MT NT <=
//     21: the default critic and actor), each warp runs on its own, with
//     no block barrier, over its own rows, and the block's warps are summed
//     in order at the end.  Past that the block's warps share their rows:
//     each round every warp writes its chunk's g_pre, a block barrier, then
//     each warp runs the backward of its own output tiles (a WM x WN grid
//     of m- and n-tiles) over all the block's chunks, a block barrier
//     before the buffers are refilled; at the end each warp writes its
//     tiles straight to the block's partial.
//   - A persistent grid of one block an SM (two for the actor's narrow
//     instances, whose registers allow it).
// Widths are template instances on padded sizes (critic In <= 103, H <=
// 128; un-collapsed actor F <= 39, H <= 128; critic_instance and
// actor_instance).  mma.sync, not wgmma: see mma_tf32.cuh.
// Built with -fmad=false like the collect kernel (one flag set for the
// port's libraries): every multiply and add rounds separately, as PyTorch's
// elementwise operations do.  The flag does not touch the tensor cores'
// mma instructions.
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tf32.cuh"

namespace marlnav {
namespace update {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;  // the wrapper sizes the grid with it
constexpr int kMaxObs = 32;      // actor widths instantiated: even 2 .. 32
constexpr int kCriticMaxIn = 103;
constexpr int kUncollapsedMaxObs = 39;
constexpr int kMaxHidden = 128;  // critic and un-collapsed actor
// Shared memory a block may take on an H100 (227 KB), in floats.
constexpr int kSmemFloats = 232448 / 4;
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

// ----------------------------------------------------------------------
// The tensor-core body and its two heads
// ----------------------------------------------------------------------

struct GradArgs {
  const float* obs;      // (N, In): rows of x
  const float* w1;       // (H, In)
  const float* b1;       // (H,)
  const float* row[3];   // the head's per-row inputs
  const float* head[4];  // the head's weights
  long long n_rows;
  int in_size, hidden;
  bool vec4;       // obs rows load in 16-byte copies (In % 4 == 0, aligned)
  float eps;       // critic: the value clip
  PpoConsts k;     // actor: the PPO constants
  float* partials;  // (gridDim.x, n_out)
};

// Copy 16 floats of a per-row input (rows r0 .. r0 + rows - 1) from the
// lanes lo .. lo + 15.
__device__ __forceinline__ void prefetch_column(const float* src, long long r0,
                                                int rows, float* dst, int lane,
                                                int lo) {
  const int r = lane - lo;
  if (r >= 0 && r < 16 && r < rows) mma::cp_async4(dst + r, src + r0 + r);
}

// The critic's head: In -> H ReLU -> 1, the clipped-value loss.
//   row:  old values (N,), returns (N,);
//   head: w2 (1, H), b2 (1,);
//   out:  loss_sum, dW1 (H, In), db1 (H), dW2 (H), db2.
template <int NT>
struct CriticHead {
  static constexpr int kNt = NT;
  static constexpr int kAux = 2;    // floats a row: old value, return
  static constexpr int kThird = 0;  // dW2 stays in registers
  static constexpr int kParamFloats = NT * 8;  // w2, zero-padded
  static __host__ __device__ int n_out(int in, int hid) {
    return 1 + hid * in + 2 * hid + 1;
  }
  // Per-warp sums besides the tiles: loss, dW2 (H), db2.
  static __host__ __device__ int n_small(int hid) { return hid + 2; }
  static __device__ int small_index(int k, int in, int hid) {
    return k == 0 ? 0 : 1 + hid * in + hid + (k - 1);
  }
  // Output of element (m, j) of the backward product: dW1 (j, m), db1 (j)
  // in row In; -1 in the padding.
  static __device__ int tile_index(int m, int j, int in, int hid, int) {
    if (j >= hid || m > in) return -1;
    return m < in ? 1 + j * in + m : 1 + hid * in + j;
  }

  float acc_w2[NT][2];  // dW2, columns 8 nt + 2t, + 1, over this lane's rows
  float acc_loss, acc_b2;  // lanes t == 0: rows g and g + 8
  float b2, eps;

  __device__ void init(const GradArgs& a, float* s_par, int tid,
                       int threads) {
    for (int j = tid; j < NT * 8; j += threads)
      s_par[j] = j < a.hidden ? a.head[0][j] : 0.f;
    b2 = a.head[1][0];
    eps = a.eps;
    acc_loss = acc_b2 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc_w2[nt][0] = acc_w2[nt][1] = 0.f;
  }

  // Old values into aux[0 .. 15], returns into aux[16 .. 31].
  static __device__ void prefetch(const GradArgs& a, long long r0, int rows,
                                  float* aux, int lane) {
    prefetch_column(a.row[0], r0, rows, aux, lane, 0);
    prefetch_column(a.row[1], r0, rows, aux + 16, lane, 16);
  }

  // The 16 rows of a chunk from their pre-activations c (the fragments of
  // rows g and g + 8): h = relu(pre) in place, the loss chain, g_pre into
  // s_g (16, LDG); rows from row0 on are valid below n.
  template <int LDG>
  __device__ void rows(float (&c)[NT][4], const float* s_par, const float* aux,
                       long long row0, long long n, int g, int t, float* s_g,
                       float*, float*) {
    float p[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 w =
          *reinterpret_cast<const float2*>(s_par + nt * 8 + 2 * t);
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
      const float gvr = critic_row(p[h] + b2, aux[row], aux[16 + row], &loss);
      const bool valid = row0 + row < n;
      gv[h] = valid ? gvr : 0.f;
      if (valid && t == 0) {
        acc_loss += loss;
        acc_b2 += gvr;
      }
    }
    // g_pre = (w2 g_v) (h > 0) into the warp's tile; dW2 += g_v h.
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 w =
          *reinterpret_cast<const float2*>(s_par + nt * 8 + 2 * t);
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
  }

  // One row of update_math.critic_chain; returns g_v, the loss term in
  // *loss.
  __device__ float critic_row(float v, float vold, float ret,
                              float* loss) const {
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

  // This warp's loss, dW2 and db2 sums into dst, at small index k, or at
  // its output index where `full`.
  __device__ void store_small(float* dst, bool full, int in, int hid, int g,
                              int t, int lane) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = acc_w2[nt][e];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        const int j = nt * 8 + 2 * t + e;
        if (g == 0 && j < hid)
          dst[full ? small_index(1 + j, in, hid) : 1 + j] = s;
      }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      acc_loss += __shfl_xor_sync(0xffffffffu, acc_loss, off);
      acc_b2 += __shfl_xor_sync(0xffffffffu, acc_b2, off);
    }
    if (lane == 0) {
      dst[0] = acc_loss;
      dst[full ? small_index(hid + 1, in, hid) : hid + 1] = acc_b2;
    }
  }
};

// The un-collapsed actor's head: F -> H (no activation) -> 2 + 2, the PPO
// objective (update_math.actor_grad_sums_uncollapsed_reference).
//   row:  actions (N, 2), behaviour log-probs (N,), advantages (N,);
//   head: wmu (2, H), bmu (2,), wvar (2, H), bvar (2,);
//   out:  loss_sum, dW1 (H, F), db1 (H), dWmu (2, H), dbmu (2), dWvar
//         (2, H), dbvar (2).
template <int NT>
struct ActorHead {
  static constexpr int kNt = NT;
  static constexpr int kAux = 4;    // floats a row: action (2), lp, adv
  static constexpr int kThird = 1;  // dWmu, dWvar = g_z^T h, one m-tile
  // [Wmu; Wvar] (4, 8 NT), zero-padded, then [bmu; bvar].
  static constexpr int kParamFloats = 4 * NT * 8 + 4;
  static __host__ __device__ int n_out(int in, int hid) {
    return 1 + hid * in + 5 * hid + 4;
  }
  // Per-warp sums besides the tiles: loss, dbmu (2), dbvar (2).
  static __host__ __device__ int n_small(int) { return 5; }
  static __device__ int small_index(int k, int in, int hid) {
    const int o_bmu = 1 + hid * in + 3 * hid;
    return k == 0 ? 0 : k < 3 ? o_bmu + k - 1 : o_bmu + 2 * hid + k - 1;
  }
  // Output of element (m, j) of the backward products: rows m < extra0 are
  // [x | 1]^T g_h (dW1 (j, m), db1 (j) in row In), rows extra0 + c (c < 4)
  // are g_z^T h (dWmu, then dWvar); -1 in the padding.
  static __device__ int tile_index(int m, int j, int in, int hid,
                                   int extra0) {
    if (j >= hid) return -1;
    if (m < extra0) {
      if (m > in) return -1;
      return m < in ? 1 + j * in + m : 1 + hid * in + j;
    }
    const int c = m - extra0, o_wmu = 1 + hid * in + hid;
    if (c >= 4) return -1;
    return c < 2 ? o_wmu + c * hid + j
                 : o_wmu + 2 * hid + 2 + (c - 2) * hid + j;
  }

  float acc_loss, acc_bh[4];  // lanes t == 0: rows g and g + 8
  PpoConsts k;

  __device__ void init(const GradArgs& a, float* s_par, int tid,
                       int threads) {
    const int hid = a.hidden;
    for (int i = tid; i < 4 * NT * 8; i += threads) {
      const int c = i / (NT * 8), j = i - c * NT * 8;
      s_par[i] = j >= hid ? 0.f
                 : c < 2  ? a.head[0][c * hid + j]
                          : a.head[2][(c - 2) * hid + j];
    }
    if (tid < 4)
      s_par[4 * NT * 8 + tid] = tid < 2 ? a.head[1][tid] : a.head[3][tid - 2];
    k = a.k;
    acc_loss = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_bh[c] = 0.f;
  }

  // Actions into aux[0 .. 31] (row r at 2r, 2r + 1), log-probs into
  // aux[32 .. 47], advantages into aux[48 .. 63].
  static __device__ void prefetch(const GradArgs& a, long long r0, int rows,
                                  float* aux, int lane) {
    if (lane < 2 * rows) mma::cp_async4(aux + lane, a.row[0] + 2 * r0 + lane);
    prefetch_column(a.row[1], r0, rows, aux + 32, lane, 0);
    prefetch_column(a.row[2], r0, rows, aux + 48, lane, 16);
  }

  // The 16 rows of a chunk from h = [x | 1][W1^T ; b1] in c (the fragments
  // of rows g and g + 8): the heads, the PPO chain, then h into s_h (16,
  // LDG), g_z into s_z (16, 4) and g_h into s_g (16, LDG).
  template <int LDG>
  __device__ void rows(float (&c)[NT][4], const float* s_par, const float* aux,
                       long long row0, long long n, int g, int t, float* s_g,
                       float* s_h, float* s_z) {
    float p[4][2];
#pragma unroll
    for (int o = 0; o < 4; ++o) p[o][0] = p[o][1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const float2 w = *reinterpret_cast<const float2*>(
            s_par + o * NT * 8 + nt * 8 + 2 * t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          p[o][h] = p[o][h] + w.x * c[nt][2 * h];
          p[o][h] = p[o][h] + w.y * c[nt][2 * h + 1];
        }
      }
    // The PPO chain once a lane: lanes t = 0, 1 of the quad take row g,
    // lanes 2, 3 row g + 8; the quad's other row comes by one shuffle.
    const int mh = t >> 1, row = g + 8 * mh;
    float z[4];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        p[o][h] = p[o][h] + __shfl_xor_sync(0xffffffffu, p[o][h], 1);
        p[o][h] = p[o][h] + __shfl_xor_sync(0xffffffffu, p[o][h], 2);
      }
      z[o] = (mh ? p[o][1] : p[o][0]) + s_par[4 * NT * 8 + o];
    }
    float g_row[4], gz[2][4];  // gz: rows g and g + 8
    const float loss = ppo_row(z, make_float2(aux[2 * row], aux[2 * row + 1]),
                               aux[32 + row], aux[48 + row], k, g_row);
    const bool valid = row0 + row < n;
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      g_row[o] = valid ? g_row[o] : 0.f;
      const float other = __shfl_xor_sync(0xffffffffu, g_row[o], 2);
      gz[0][o] = mh ? other : g_row[o];
      gz[1][o] = mh ? g_row[o] : other;
    }
    if (valid && (t & 1) == 0) {
      acc_loss += loss;
#pragma unroll
      for (int o = 0; o < 4; ++o) acc_bh[o] += g_row[o];
    }
    if ((t & 1) == 0)
      *reinterpret_cast<float4*>(s_z + row * 4) =
          make_float4(g_row[0], g_row[1], g_row[2], g_row[3]);
    // h and g_h = Wmu^T g_u + Wvar^T g_s into the warp's tiles.
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float w[4][2];
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const float2 v = *reinterpret_cast<const float2*>(
            s_par + o * NT * 8 + nt * 8 + 2 * t);
        w[o][0] = v.x;
        w[o][1] = v.y;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at = (g + 8 * h) * LDG + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(s_h + at) =
            make_float2(c[nt][2 * h], c[nt][2 * h + 1]);
        float gh[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          gh[e] = ((w[0][e] * gz[h][0] + w[1][e] * gz[h][1]) +
                   w[2][e] * gz[h][2]) +
                  w[3][e] * gz[h][3];
        *reinterpret_cast<float2*>(s_g + at) = make_float2(gh[0], gh[1]);
      }
    }
  }

  // This warp's loss, dbmu and dbvar sums into dst (see CriticHead).
  __device__ void store_small(float* dst, bool full, int in, int hid, int,
                              int, int lane) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      acc_loss += __shfl_xor_sync(0xffffffffu, acc_loss, off);
#pragma unroll
      for (int o = 0; o < 4; ++o)
        acc_bh[o] += __shfl_xor_sync(0xffffffffu, acc_bh[o], off);
    }
    if (lane == 0) {
      dst[0] = acc_loss;
#pragma unroll
      for (int o = 0; o < 4; ++o)
        dst[full ? small_index(1 + o, in, hid) : 1 + o] = acc_bh[o];
    }
  }
};

// The backward's cost to a warp, a k-step of 8 rows, where a grid of
// (warps / wn) x wn warps shares (mt, nt) output tiles: 3 mma a tile
// (weighed as 2 instructions each), 16 instructions to load and split an
// A fragment, 8 a B fragment.
constexpr int tc_cost(int mt, int nt, int warps, int wn) {
  const int mtw = (mt + warps / wn - 1) / (warps / wn);
  const int ntw = (nt + wn - 1) / wn;
  return 6 * mtw * ntw + 16 * mtw + 8 * ntw;
}

// The wn (a divisor of warps) of the least cost, the largest on a tie.
constexpr int tc_best_wn(int mt, int nt, int warps) {
  int best = 1;
  for (int wn = 2; wn <= warps; ++wn)
    if (warps % wn == 0 &&
        tc_cost(mt, nt, warps, wn) <= tc_cost(mt, nt, warps, best))
      best = wn;
  return best;
}

// The shape of tc_grad_kernel<Head, KS>: KS k-steps of 8 over [x | 1] (In +
// 1 <= 8 KS), NT = Head::kNt n-tiles of 8 over the hidden units (H <= 8 NT).
template <class Head, int KS>
struct TcShape {
  static constexpr int kNt = Head::kNt;
  static constexpr int kMt = (KS + 1) / 2;  // backward m-tiles over [x | 1]
  static constexpr int kMtAll = kMt + Head::kThird;
  // The row buffer's stride LDX (= 4 mod 8) keeps the forward A loads free
  // of bank conflicts (the transposed backward loads have 2-way ones);
  // g_pre's LDG (= 8 or 24 mod 32) keeps the backward B loads free of them.
  static constexpr int kLdx = kMt * 16 + 4;
  static constexpr int kLdg = kNt * 8 % 16 == 0 ? kNt * 8 + 8 : kNt * 8;
  // Warps share their rows where one warp's registers would not hold
  // every output tile: the default critic (3 x 7 tiles, 211 registers)
  // is the largest that does not.
  static constexpr bool kShared = kMtAll * kNt > 21;
  // A warp's region: rows (2, 16, LDX) | g_pre (16, LDG) | h (16, LDG) and
  // g_z (16, 4) for a third product | per-row inputs (2, 16 kAux).
  static constexpr int kOffG = 2 * 16 * kLdx;
  static constexpr int kOffH = kOffG + 16 * kLdg;
  static constexpr int kOffZ = kOffH + Head::kThird * 16 * kLdg;
  static constexpr int kOffAux = kOffZ + Head::kThird * 16 * 4;
  static constexpr int kWarpFloats = kOffAux + 2 * 16 * Head::kAux;
  // W1's fragments split into TF32 halves once a block where that fits
  // beside 8 warps, else as floats split at each load.
  static constexpr bool kPreSplit =
      KS * kNt * 32 * 4 + Head::kParamFloats + 8 * kWarpFloats <=
      kSmemFloats;
  static constexpr int kFragFloats = KS * kNt * 32 * (kPreSplit ? 4 : 2);
  static constexpr int kFit =
      (kSmemFloats - kFragFloats - Head::kParamFloats) / kWarpFloats;
  static constexpr int kWarps = kFit < 8 ? kFit : 8;
  static constexpr int kMainFloats =
      kFragFloats + Head::kParamFloats + kWarps * kWarpFloats;
  // Output tiles of a warp: a WM x WN grid of warps over (kMtAll, NT)
  // tiles where the rows are shared, else all of them.
  static constexpr int kWn = kShared ? tc_best_wn(kMtAll, kNt, kWarps) : 1;
  static constexpr int kWm = kShared ? kWarps / kWn : 1;
  static constexpr int kMtw = (kMtAll + kWm - 1) / kWm;
  // Blocks an SM: two of the actor's per-warp instances of up to 14 tiles,
  // which fit 128 registers a thread without spilling and whose chain
  // leaves the tensor cores idle between chunks; one of every other (the
  // critic's default keeps 211 registers).
  static constexpr int kBlocks = Head::kThird && kMtAll * kNt <= 14 ? 2 : 1;
  static constexpr int kNtw = (kNt + kWn - 1) / kWn;
  static_assert(kWarps >= 1 && kMainFloats <= kSmemFloats,
                "an instance fits the block's shared memory");
  static_assert(kShared || kWarps == 8, "per-warp instances take 8 warps");
};

template <int S>
__device__ __forceinline__ void group_sync() {
  if (S == 1)
    __syncwarp();
  else
    __syncthreads();
}

// Start the copies of rows 16 chunk .. 16 chunk + 15 (those below n_rows)
// into one buffer of a warp: obs into sx (16, LDX), the head's per-row
// inputs into aux (16 kAux).
template <class Head, int LDX>
__device__ __forceinline__ void tc_prefetch(const GradArgs& a, long long chunk,
                                            float* sx, float* aux, int lane) {
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
  Head::prefetch(a, r0, rows, aux, lane);
}

template <class Head, int KS>
__global__ void __launch_bounds__(TcShape<Head, KS>::kWarps * 32,
                                  TcShape<Head, KS>::kBlocks)
    tc_grad_kernel(const GradArgs args) {
  using Sh = TcShape<Head, KS>;
  constexpr int NT = Sh::kNt, W = Sh::kWarps, S = Sh::kShared ? W : 1;
  constexpr int MT = Sh::kMt, LDX = Sh::kLdx, LDG = Sh::kLdg;
  constexpr int WM = Sh::kWm, WN = Sh::kWn, MTW = Sh::kMtw, NTW = Sh::kNtw;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int in = args.in_size, hid = args.hidden;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // (KS, NT, 32) B fragments of [W1^T ; b1]: big b0, big b1, small b0,
  // small b1 a lane (or b0, b1 as floats), then the head's weights, then
  // the warps' regions.
  float* s_par = smem + Sh::kFragFloats;
  float* s_warps = s_par + Head::kParamFloats;
  float* mine = s_warps + warp * Sh::kWarpFloats;

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
    if (Sh::kPreSplit) {
      uint32_t big[2], small[2];
      mma::split(b, big, small);
      smem4[i] = make_float4(__uint_as_float(big[0]), __uint_as_float(big[1]),
                             __uint_as_float(small[0]),
                             __uint_as_float(small[1]));
    } else {
      reinterpret_cast<float2*>(smem)[i] = make_float2(b[0], b[1]);
    }
  }
  Head head;
  head.init(args, s_par, tid, W * 32);
  // Zero the warp's region (rows past n_rows stay finite), then the ones
  // column of [x | 1] in both row buffers.
  for (int i = lane; i < Sh::kWarpFloats; i += 32) mine[i] = 0.f;
  __syncwarp();
  mine[lane * LDX + in] = 1.f;
  __syncthreads();

  // Backward accumulators of this warp's output tiles (m-tile wm + WM i,
  // n-tile wn + WN j).
  float bacc[MTW][NTW][4];
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) bacc[i][j][e] = 0.f;
  const int own = warp % S, wq0 = warp - own;  // the group's first warp
  const int wm = own / WN, wn = own % WN;

  // Each round the group of S warps takes S chunks, one a warp.
  const long long n = args.n_rows, n_chunks = (n + 15) / 16;
  const long long stride = static_cast<long long>(gridDim.x) * W;
  long long base = static_cast<long long>(blockIdx.x) * W + wq0;
  float* aux_own = mine + Sh::kOffAux;
  if (base + own < n_chunks)
    tc_prefetch<Head, LDX>(args, base + own, mine, aux_own, lane);
  mma::cp_async_commit();
  for (int buf = 0; base < n_chunks; base += stride, buf ^= 1) {
    const long long chunk = base + own, next = chunk + stride;
    if (next < n_chunks)
      tc_prefetch<Head, LDX>(args, next, mine + (buf ^ 1) * 16 * LDX,
                             aux_own + (buf ^ 1) * 16 * Head::kAux, lane);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncwarp();
    const float* x = mine + buf * 16 * LDX;

    // Forward: pre = [x | 1] [W1^T ; b1] over the warp's 16 rows.
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
        uint32_t b_big[2], b_small[2];
        if (Sh::kPreSplit) {
          const float4 w = smem4[(ks * NT + nt) * 32 + lane];
          b_big[0] = __float_as_uint(w.x);
          b_big[1] = __float_as_uint(w.y);
          b_small[0] = __float_as_uint(w.z);
          b_small[1] = __float_as_uint(w.w);
        } else {
          const float2 w = reinterpret_cast<const float2*>(
              smem)[(ks * NT + nt) * 32 + lane];
          const float b[2] = {w.x, w.y};
          mma::split(b, b_big, b_small);
        }
        mma::mma_3xtf32(c[nt], a_big, a_small, b_big, b_small);
      }
    }
    head.template rows<LDG>(c, s_par, aux_own + buf * 16 * Head::kAux,
                            chunk * 16, n, g, t, mine + Sh::kOffG,
                            mine + Sh::kOffH, mine + Sh::kOffZ);
    group_sync<S>();

    // Backward over the group's S chunks, K = 16 rows each in two steps of
    // 8: [x | 1]^T g_pre, and g_z^T h for the actor.
#pragma unroll 1
    for (int q = 0; q < S; ++q) {
      const float* rq = s_warps + (wq0 + q) * Sh::kWarpFloats;
      const float* xq = rq + buf * 16 * LDX;
#pragma unroll
      for (int kr = 0; kr < 2; ++kr) {
        uint32_t a_big[MTW][4], a_small[MTW][4];
#pragma unroll
        for (int i = 0; i < MTW; ++i) {
          const int mt = wm + WM * i;
          float a[4] = {0.f, 0.f, 0.f, 0.f};
          if (mt < MT) {
            mma::load_a_cols(xq + kr * 8 * LDX + mt * 16, LDX, lane, a);
          } else if (Head::kThird && mt == MT && g < 4) {
            // g_z^T: row c < 4 of the m-tile, column a row of the chunk.
            const float* z = rq + Sh::kOffZ + kr * 8 * 4;
            a[0] = z[t * 4 + g];
            a[2] = z[(t + 4) * 4 + g];
          }
          mma::split(a, a_big[i], a_small[i]);
        }
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const int nt = wn + WN * j;
          if (nt >= NT) continue;
          float b[2];
          uint32_t b_big[2], b_small[2];
          mma::load_b_rows(rq + Sh::kOffG + kr * 8 * LDG + nt * 8, LDG, lane,
                           b);
          mma::split(b, b_big, b_small);
#pragma unroll
          for (int i = 0; i < MTW; ++i) {
            const int mt = wm + WM * i;
            if (mt < MT) {
              mma::mma_3xtf32(bacc[i][j], a_big[i], a_small[i], b_big,
                              b_small);
            } else if (Head::kThird && mt == MT) {
              float hb[2];
              uint32_t h_big[2], h_small[2];
              mma::load_b_rows(rq + Sh::kOffH + kr * 8 * LDG + nt * 8, LDG,
                               lane, hb);
              mma::split(hb, h_big, h_small);
              mma::mma_3xtf32(bacc[i][j], a_big[i], a_small[i], h_big,
                              h_small);
            }
          }
        }
      }
    }
    group_sync<S>();  // the buffers are refilled next
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  // The block's partial.  Per-warp instances: each warp's sums into its row
  // of red (W, n_out), then the warps summed in order.  Shared rows: each
  // tile has one owner, which writes it straight to the partial; the small
  // sums go through red (W, n_small).  red reuses all of shared memory.
  const int n_out = Head::n_out(in, hid);
  const int n_red = S == 1 ? n_out : Head::n_small(hid);
  float* out = args.partials + static_cast<long long>(blockIdx.x) * n_out;
  float* red = smem;
  float* my_red = red + warp * n_red;
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int mt = wm + WM * i, nt = wn + WN * j;
        if (mt >= Sh::kMtAll || nt >= NT) continue;
        const int o = Head::tile_index(mt * 16 + g + 8 * (e >> 1),
                                       nt * 8 + 2 * t + (e & 1), in, hid,
                                       16 * MT);
        if (o < 0) continue;
        if (S == 1)
          my_red[o] = bacc[i][j][e];
        else
          out[o] = bacc[i][j][e];
      }
  head.store_small(my_red, S == 1, in, hid, g, t, lane);
  __syncthreads();
  for (int k = tid; k < n_red; k += W * 32) {
    float s = 0.f;
    for (int w = 0; w < W; ++w) s += red[w * n_red + k];
    out[S == 1 ? k : Head::small_index(k, in, hid)] = s;
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

template <class Head, int KS>
cudaError_t launch_tc(const GradArgs& args, int blocks, cudaStream_t s) {
  using Sh = TcShape<Head, KS>;
  constexpr int W = Sh::kWarps;
  const int n_red = Sh::kShared ? Head::n_small(args.hidden)
                                : Head::n_out(args.in_size, args.hidden);
  const int floats =
      Sh::kMainFloats > W * n_red ? Sh::kMainFloats : W * n_red;
  if (floats > kSmemFloats) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(float)) * floats;
  cudaError_t err = cudaFuncSetAttribute(
      tc_grad_kernel<Head, KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  tc_grad_kernel<Head, KS><<<blocks, W * 32, smem, s>>>(args);
  return cudaGetLastError();
}

// k-steps of 8 over [x | 1] and n-tiles of 8 over the hidden units, each
// rounded up to an instance; 0 outside the widths built.
inline int critic_ks(int in) {
  const int k = (in + 8) / 8;
  return in < 1 || in > kCriticMaxIn ? 0
         : k <= 3                    ? 3
         : k <= 5                    ? 5
         : k <= 9                    ? 9
                                     : 13;
}
inline int actor_ks(int f) {
  const int k = (f + 8) / 8;
  return f < 1 || f > kUncollapsedMaxObs ? 0 : k <= 2 ? 2 : k <= 3 ? 3 : 5;
}
inline int hidden_nt(int hid) {
  const int n = (hid + 7) / 8;
  return hid < 1 || hid > kMaxHidden ? 0
         : n <= 4                    ? 4
         : n <= 7                    ? 7
         : n <= 8                    ? 8
                                     : 16;
}

// The instance of Head for (KS, NT): its warps a block (0 where none is
// built) and its blocks an SM in *per_sm; with args, it is also launched,
// its error in *err.
#define MARLNAV_TC(HEAD, KS_, NT_)                                   \
  if (ks == KS_ && nt == NT_) {                                      \
    if (args) *err = launch_tc<HEAD<NT_>, KS_>(*args, blocks, s);    \
    if (per_sm) *per_sm = TcShape<HEAD<NT_>, KS_>::kBlocks;          \
    return TcShape<HEAD<NT_>, KS_>::kWarps;                          \
  }
#define MARLNAV_TC_NT(HEAD, KS_)                                       \
  MARLNAV_TC(HEAD, KS_, 4) MARLNAV_TC(HEAD, KS_, 7)                    \
  MARLNAV_TC(HEAD, KS_, 8) MARLNAV_TC(HEAD, KS_, 16)

inline int critic_instance(int in, int hid, int* per_sm = nullptr,
                           const GradArgs* args = nullptr, int blocks = 0,
                           cudaStream_t s = nullptr,
                           cudaError_t* err = nullptr) {
  const int ks = critic_ks(in), nt = hidden_nt(hid);
  MARLNAV_TC_NT(CriticHead, 3)
  MARLNAV_TC_NT(CriticHead, 5)
  MARLNAV_TC_NT(CriticHead, 9)
  MARLNAV_TC_NT(CriticHead, 13)
  return 0;
}

inline int actor_instance(int f, int hid, int* per_sm = nullptr,
                          const GradArgs* args = nullptr, int blocks = 0,
                          cudaStream_t s = nullptr,
                          cudaError_t* err = nullptr) {
  const int ks = actor_ks(f), nt = hidden_nt(hid);
  MARLNAV_TC_NT(ActorHead, 2)
  MARLNAV_TC_NT(ActorHead, 3)
  MARLNAV_TC_NT(ActorHead, 5)
  return 0;
}
#undef MARLNAV_TC_NT
#undef MARLNAV_TC

inline bool aligned16(const float* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace update
}  // namespace marlnav

extern "C" {

int marlnav_update_blocks_per_sm() { return marlnav::update::kBlocksPerSm; }
int marlnav_actor_max_obs() { return marlnav::update::kMaxObs; }
int marlnav_critic_max_in() { return marlnav::update::kCriticMaxIn; }
int marlnav_uncollapsed_max_obs() {
  return marlnav::update::kUncollapsedMaxObs;
}
int marlnav_max_hidden() { return marlnav::update::kMaxHidden; }

// Warps a block of the tensor-core kernel's instance for these widths, 16
// rows a warp at a time (0 outside the widths built), and, for the actor,
// its blocks an SM, which size the persistent grid (the critic's: 1).
int marlnav_critic_warps(int in_size, int hidden) {
  return marlnav::update::critic_instance(in_size, hidden);
}
int marlnav_uncollapsed_warps(int obs_size, int hidden) {
  return marlnav::update::actor_instance(obs_size, hidden);
}
int marlnav_uncollapsed_blocks_per_sm(int obs_size, int hidden) {
  int per_sm = 0;
  marlnav::update::actor_instance(obs_size, hidden, &per_sm);
  return per_sm;
}

// Each launches on `stream` (a cudaStream_t from
// torch.cuda.current_stream()): the grad kernel on `blocks` blocks, then the
// fixed-order reduction of its partials into `out`.  They return
// cudaGetLastError(): 0 when both launches were accepted.

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
    MARLNAV_LAUNCH(26)
    MARLNAV_LAUNCH(28)
    MARLNAV_LAUNCH(30)
    MARLNAV_LAUNCH(32)
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
  if (!critic_instance(in_size, hidden))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GradArgs args{obs,    w1,      b1,
                      {vold, ret, nullptr}, {w2, b2, nullptr, nullptr},
                      n_rows, in_size, hidden,
                      in_size % 4 == 0 && aligned16(obs),
                      eps,    {},      partials};
  critic_instance(in_size, hidden, nullptr, &args, blocks, s, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce(
      partials, blocks, CriticHead<4>::n_out(in_size, hidden), out, s));
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
  if (!actor_instance(obs_size, hidden))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GradArgs args{obs,    w1,       b1,
                      {act, lp, adv},   {wmu, bmu, wvar, bvar},
                      n_rows, obs_size, hidden,
                      obs_size % 4 == 0 && aligned16(obs),
                      0.f,    {lo, hi, ent_c, ent_half},
                      partials};
  actor_instance(obs_size, hidden, nullptr, &args, blocks, s, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce(
      partials, blocks, ActorHead<4>::n_out(obs_size, hidden), out, s));
}

}  // extern "C"
