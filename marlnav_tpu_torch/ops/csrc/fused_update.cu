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
// (gridDim.x, n_out), which are then summed in a fixed block order (in
// double): by the affine actor's last block to finish, and for the
// tensor-core kernels by reduce_partials_kernel, launched next on the same
// stream.  There is no float atomicAdd, and the grid depends only on the
// row count, the widths and the card, so two launches on the same input
// agree bit for bit.
//
// Bounds on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32 without tensor
// cores, 495 TFLOP/s TF32 on them), default configuration (F = 12, A*F =
// 36, H = 50), faithful full batch: 999 x 1024 x 3 = 3,068,928 actor rows,
// 1,022,976 critic rows.
//   actor:  (4F + 16) B a row (obs 48, action 8, log-prob 4, advantage 4)
//           = 196 MB -> 58.6 us; 16F + 100 float operations a row (0.9
//           GFLOP, 13 us).  Bytes bound it.  Design (actor_grad_kernel, F
//           at run time, 1 .. 1023): a persistent grid of the blocks that fit
//           the card at once streams row tiles through a ring of 4 stages
//           in shared memory, each tile's four spans started by one thread
//           as bulk copies (the tensor memory accelerator) on the stage's
//           mbarrier three tiles ahead; a row's chain on 256 / R threads,
//           the sums by threads that each own four columns of [x | 1] over
//           a fixed subset of the rows (16 sums in registers at any F); the
//           last block to finish sums the partials.
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
//     fragment order.  Where a pass holds at most 8 n-tiles (64 hidden
//     units) the forward runs on the float64 tensor cores (mma_f64.cuh,
//     tc_forward_f64): exact products, float64 sums, one rounding, and
//     the head's sums in float64; past that in 3xTF32, W1 split into its
//     TF32 halves (or as floats, split at each load, where the halves do
//     not fit beside 8 warps' buffers).
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
//     registers.  In both products each k-step's mma starts from zero and
//     its result is added to the running sums by the CUDA cores (add_to):
//     no tensor-core accumulation chains more than one k-step, and the
//     lanes' CUDA-core sums add their chunk's rows first (a chunk partial).
//     Where a warp's registers hold every output tile (MT NT <=
//     21: the default critic and actor), each warp runs on its own, with
//     no block barrier, over its own rows, and the block's warps are summed
//     in order at the end.  Past that the block's warps share their rows:
//     each round every warp writes its chunk's g_pre, a block barrier, then
//     each warp runs the backward of its own output tiles (a WM x WN grid
//     of m- and n-tiles) over all the block's chunks, a block barrier
//     before the buffers are refilled; at the end each warp writes its
//     tiles straight to the block's partial.
//   - A persistent grid of one block an SM.
//   - Past 128 hidden units (NT 32) the kernel runs a pass over its rows
//     for each 16 n-tiles: each pass takes the whole forward, group by
//     group (the head needs every unit), its own group last, and the
//     backward of its own group's tiles.
// The float32 critic's per-warp float64 instances whose backward holds at
// most 3 m-tiles (TcShape::kPipelined: KS 3 with NT 4, 7 or 8, KS 5 with
// NT 4 or 7, i.e. In <= 23 with H <= 64 and In <= 39 with H <= 56; the
// default and curriculum critic, In 36 / H 50, among them) run a
// warp-specialised body instead (tc_pipelined), with the same arithmetic a
// row; only the float32 sums over rows are added in another order.
//   - Why: in the per-warp body each warp takes its chunk's copies, float64
//     forward, head and backward in turn, two warps a scheduler (255
//     registers).  On the H100 a warp spent ~48% of a chunk's time in the
//     forward's chain of dependent float64 mma (clock stamps), while the
//     tensor pipe was ~40% busy.
//   - Roles: 6 forward warps, each taking every 6th chunk of its block:
//     the float64 forward of all n-tiles at once (7 independent
//     accumulations at NT 7), the head, g_pre into the chunk's stage.  Then
//     6 backward warps, each holding every output tile in registers over
//     its chunks (every 6th), refilling each stage it frees.  12 warps a
//     block at 168 registers a thread, none spilled.  A producer warp of
//     its own could not keep the forward warps fed; 16 warps (128 registers
//     a thread, with setmaxnreg budgets or without) spilled and ran slower.
//   - Ring: kRing (24) stages of a chunk (x | g_pre | old values and
//     returns) in shared memory, two mbarriers each (full_x: the chunk has
//     landed; full_g: its g_pre is written).  A refill goes by bulk copies
//     (the tensor memory accelerator: a row a lane, the per-row inputs two
//     lanes), by cp.async for a ragged last chunk or rows off 16 bytes.
//   - Bound: the tensor pipe, which the float64 and TF32 products share
//     (measured on the H100: an m16n8k8 .f64 ~33 cycles of a sub-partition,
//     a TF32 one ~7).  A chunk's 35 float64 and 126 TF32 products take
//     ~2,040 cycles: 124 us at 1,022,976 rows, against 46 us of bytes.
// Widths are template instances on padded sizes (critic In <= 103, H <=
// 256; un-collapsed actor F <= 39, H <= 256; critic_instance and
// actor_instance); every other width takes the run-time-width route (its
// own section below), the same products on the tensor cores with In and H
// at run time.  mma.sync, not wgmma: see mma_tf32.cuh.
// --bf16-updates (bf16 variants, rounding where the JAX route rounds; the
// plain versions in ops/update_math.py round at the same points):
//   - actor_grad_kernel<kTiled | kStaged>: the operands of the products
//     rounded by __float2bfloat16_rn (round to nearest even, as JAX's astype)
//     on the CUDA cores; a product of two bf16 values is exact in float32,
//     so the __fmaf_rn chains stay.  kTiled rounds g_z and x in the sums and
//     feeds the ones column the rounded g_z; kStaged also rounds a_comp and x
//     in the forward and feeds the ones column the float32 g_z.
//   - tc_grad_kernel<CriticHeadBf16 | ActorHeadBf16>: each product one
//     mma.sync.m16n8k16 bf16 pass (mma_bf16.cuh) in place of three m16n8k8
//     TF32 ones, the operands rounded at fragment load from the float32
//     staging.  The bias leaves the product: the forward's accumulators start
//     from the float32 b1 (K = In, padded to 16), and db1 sums the float32
//     g_pre / g_h in the warp's tile by columns (the ones row of [x | 1]^T
//     would sum them rounded).  The heads round their CUDA-core products'
//     operands too.  Instances only for the widths training reaches.
// Built with -fmad=false like the collect kernel (one flag set for the
// port's libraries): every multiply and add rounds separately, as PyTorch's
// elementwise operations do, in the per-row chains.  The flag does not
// touch the tensor cores' mma instructions, nor the affine actor's explicit
// fused multiply-adds (__fmaf_rn) in z = a_comp x + c_comp and its sums,
// which its plain version takes by matrix products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma_bf16.cuh"
#include "mma_f64.cuh"
#include "mma_tf32.cuh"

namespace marlnav {
namespace update {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// The affine actor: a ring of kStages row tiles a block; obs widths up to
// kActorMaxObs, where the column groups of [x | 1] (4 columns each, F / 4
// + 1 of them) still have a thread each.
constexpr int kStages = 4;
constexpr int kActorMaxObs = 4 * kThreads - 1;
// Up to kActorNarrowObs its tile takes the most rows (256, 128, 64, 32)
// whose block needs at most kActorSmemTarget bytes of shared memory, so
// that two blocks or more share an SM (F 255: 32 rows, 137 KB); past it the
// most rows (32, 16, 8) that fit a block's shared memory.
constexpr int kActorNarrowObs = kThreads - 1;
constexpr int kActorSmemTarget = 96 * 1024;
constexpr int kCriticMaxIn = 103;
constexpr int kUncollapsedMaxObs = 39;
constexpr int kMaxHidden = 256;  // critic and un-collapsed actor
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

// One row of update_math.critic_chain: the clipped-value loss term of the
// new value v in *loss, and its gradient g_v.
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

// The PPO constants of the actor objective.
struct PpoConsts {
  float lo, hi;           // 1 - eps, 1 + eps
  float ent_c, ent_half;  // ent_const, ent_const * 0.5
};

// The affine actor's roundings (--bf16-updates), by the JAX route each
// stands for (ops/update_math.py actor_grad_sums_reference): kF32 none;
// kTiled (fused_update_tiled.py:199-204) g_z and x in the sums g_z x^T,
// the ones column fed the rounded g_z (so dzs sums it), the forward
// unrounded; kStaged (fused_update.py:734-741) a_comp and x in the forward
// too, the ones column fed the float32 g_z.
enum ActorMode { kF32 = 0, kTiled = 1, kStaged = 2 };

// x rounded to the nearest bf16 (ties to even), as a float.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct ActorArgs {
  const float* obs;     // (N, F)
  const float* act;     // (N, 2)
  const float* lp;      // (N,) behaviour log-probs
  const float* adv;     // (N,)
  const float* a_comp;  // (4, F)
  const float* c_comp;  // (4,)
  long long n_rows;
  int obs_size, tile_rows;
  PpoConsts k;
  float* partials;      // (gridDim.x, 4F + 5)
  float* out;           // (4F + 5): loss_sum, dz (4, F), dzs (4)
  unsigned int* done;   // this launch's finished blocks, 0 at its start
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

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Floats a span of n floats takes in shared memory: up to 3 more, where its
// source does not start on 16 bytes (span_of).
__host__ __device__ constexpr int span_floats(int n) { return round4(n + 3); }

// One row tile of the affine actor in shared memory, R rows as four spans:
// obs (R, F) at 0, actions (R, 2) at act, log-probs and advantages (R) at
// lp and adv; `floats` in all, each span starting on 16 bytes.
struct ActorTile {
  int act, lp, adv, floats;
  __host__ __device__ ActorTile(int f, int r)
      : act(span_floats(r * f)),
        lp(act + span_floats(2 * r)),
        adv(lp + span_floats(r)),
        floats(adv + span_floats(r)) {}
};

// A block's shared memory in floats: [a_comp^T | c_comp] (F + 1, 4), g_z
// (R, 4) and the ring of tiles; after the rows, the threads' sums (at most
// kThreads x 16) and then the last block's doubles reuse it.
__host__ __device__ inline int actor_smem_floats(int f, int r) {
  const int main =
      4 * (f + 1) + 4 * r + kStages * ActorTile(f, r).floats;
  return main > 16 * kThreads ? main : 16 * kThreads;
}

// Rows a tile (0 outside the widths taken).  F 12: 256 rows, 70 KB, three
// blocks an SM; F 255: 32 rows, 137 KB, one; F 300: 32 rows, 161 KB; F
// 1023: 8 rows, 148 KB.
inline int actor_tile_rows(int f) {
  if (f < 1 || f > kActorMaxObs) return 0;
  if (f <= kActorNarrowObs) {
    for (int r = 256; r > 32; r /= 2)
      if (4 * actor_smem_floats(f, r) <= kActorSmemTarget) return r;
    return 32;
  }
  for (int r = 32; r > 8; r /= 2)
    if (actor_smem_floats(f, r) <= kSmemFloats) return r;
  return 8;
}

// The source's offset within 16 bytes, in floats.
__device__ __forceinline__ int span_lead(const float* src) {
  return static_cast<int>((reinterpret_cast<std::uintptr_t>(src) >> 2) & 3);
}

// A span of n floats from src placed in shared memory at dst + lead (lead
// = span_lead(src)), so that source and destination agree modulo 16 bytes:
// its body, `units` of 16 bytes from float `head` on, goes by one bulk
// copy, the up to 3 floats before and after it by 4-byte cp.async.
struct Span {
  float* d;
  const float* src;
  int n, head, units;
};

__device__ __forceinline__ Span span_of(float* dst, const float* src, int n) {
  const int lead = span_lead(src);
  const int head = min((4 - lead) & 3, n);
  return {dst + lead, src, n, head, (n - head) >> 2};
}

// The span's 4-byte copies, on threads t = 0 .. 7.
__device__ __forceinline__ void copy_edges(const Span& s, int t) {
  if (t < s.head) mma::cp_async4(s.d + t, s.src + t);
  const int e = s.head + 4 * s.units + t - 4;  // threads 4 .. 6: the tail
  if (t >= 4 && e < s.n) mma::cp_async4(s.d + e, s.src + e);
}

// The affine actor's loss and sums over all rows.  A persistent grid (the
// blocks resident at once, each on tiles blockIdx.x + k gridDim.x) streams
// row tiles through a ring of kStages in shared memory: each tile's obs,
// actions, log-probs and advantages are four contiguous spans, which one
// thread starts as bulk copies on the stage's mbarrier while the tiles
// before them are computed (kStages - 1 in flight).  A tile of R rows: kThreads / R threads a row take z = a_comp x
// + c_comp (each a strided share of the columns, then an xor tree), and
// ppo_row; one of them writes g_z to shared memory.  Then each thread sums
// g_z [x | 1]^T of a group of four columns of [x | 1] (16 outputs, one
// g_z load for 16 fused multiply-adds) over a fixed subset of the rows, so
// its registers do not grow with F.  Each block writes one
// partial (its row subsets summed in order), and the last block to finish
// sums the partials in block order, in double.  kMode (ActorMode): with
// bf16 rounding each product's operands are bf16, so its product is exact
// in float32 and the __fmaf_rn chains stay as they are.
template <int kMode>
__global__ void __launch_bounds__(kThreads, 2)
    actor_grad_kernel(const ActorArgs a) {
  constexpr bool kRound = kMode != kF32;
  auto rx = [](float v) { return kRound ? round_bf16(v) : v; };
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float s_loss[kWarps];
  __shared__ bool s_last;
  __shared__ uint64_t s_full[kStages];  // a stage's copies have landed
  const int f = a.obs_size, rt = a.tile_rows, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const ActorTile tile(f, rt);
  // s_op[j] = a_comp[:, j] (one 16-byte load a column of x), s_op[F] =
  // c_comp.
  const float4* s_op = smem4;
  float4* s_gz = smem4 + f + 1;  // (R) g_z
  float* s_ring = smem + 4 * (f + 1 + rt);
  for (int i = tid; i < 4 * f; i += kThreads)
    smem[4 * (i % f) + i / f] =
        kMode == kStaged ? round_bf16(a.a_comp[i]) : a.a_comp[i];
  if (tid < 4) smem[4 * f + tid] = a.c_comp[tid];
  if (tid == 0)
    for (int i = 0; i < kStages; ++i) mma::mbar_init(&s_full[i], 1);
  __syncthreads();

  const long long n = a.n_rows, n_tiles = (n + rt - 1) / rt;
  const long long tiles = (n_tiles - 1 - blockIdx.x) / gridDim.x + 1;
  auto first_row = [&](long long k) {
    return (blockIdx.x + k * gridDim.x) * static_cast<long long>(rt);
  };
  // Warp 0 starts tile k's copies: thread 0 the four bodies (after a
  // proxy fence: the stage was last read by the block's threads), threads
  // 8 i .. 8 i + 7 span i's edges.
  auto fetch = [&](long long k) {
    if (warp != 0) return;
    const long long r0 = first_row(k);
    const int rows = static_cast<int>(n - r0 < rt ? n - r0 : rt);
    const int stage = static_cast<int>(k % kStages);
    float* st = s_ring + stage * tile.floats;
    auto span = [&](int i) {
      return i == 0   ? span_of(st, a.obs + r0 * f, rows * f)
             : i == 1 ? span_of(st + tile.act, a.act + 2 * r0, 2 * rows)
             : i == 2 ? span_of(st + tile.lp, a.lp + r0, rows)
                      : span_of(st + tile.adv, a.adv + r0, rows);
    };
    if (tid == 0) {
      mma::fence_proxy_async();
      const Span sp[4] = {span(0), span(1), span(2), span(3)};
      unsigned bytes = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) bytes += 16u * sp[i].units;
      mma::mbar_arrive_expect(&s_full[stage], bytes);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (sp[i].units)
          mma::bulk_copy(sp[i].d + sp[i].head, sp[i].src + sp[i].head,
                         16u * sp[i].units, &s_full[stage]);
    }
    copy_edges(span(lane >> 3), lane & 7);
  };
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < tiles) fetch(k);
    mma::cp_async_commit();
  }

  // The chain: row `row` of a tile on threads k = 0 .. tpr - 1 (adjacent
  // lanes), which sum columns k, k + tpr, ... of z.
  const int tpr = kThreads / rt, row = tid / tpr, kr = tid % tpr;
  const unsigned row_mask = (0xffffffffu >> (32 - tpr)) << (lane & ~(tpr - 1));
  // The sums: columns c0 .. c0 + 3 of [x | 1] (column F is the ones
  // column, dzs; columns past it are none) over rows sub, sub + q, ... of
  // each tile; a group's q threads are consecutive.
  const int ng = (f + 4) / 4, q = kThreads / ng;
  const int cg = tid / q, sub = tid % q, c0 = 4 * cg;
  const bool summing = cg < ng, full4 = c0 + 4 <= f;
  float acc[4][4] = {}, loss = 0.f;  // acc[column][output]
  for (long long k = 0; k < tiles; ++k) {
    mma::cp_async_wait<kStages - 2>();
    mma::mbar_wait(&s_full[k % kStages],
                   static_cast<unsigned>(k / kStages) & 1u);
    __syncthreads();  // tile k is in; every thread is done with tile k - 1
    if (k + kStages - 1 < tiles) fetch(k + kStages - 1);  // into k - 1's
    mma::cp_async_commit();
    const long long r0 = first_row(k);
    const int rows = static_cast<int>(n - r0 < rt ? n - r0 : rt);
    const float* st = s_ring + static_cast<int>(k % kStages) * tile.floats;
    const int x0 = static_cast<int>(st - smem) + span_lead(a.obs + r0 * f);
    // Rows on 16 bytes (F % 4 == 0 and obs on 16 bytes): a row's x by
    // float4, which at a stride of F floats hits no bank twice in a
    // quarter warp (4-byte loads of F 12 rows hit each bank 4 times).
    const bool vec = (f & 3) == 0 && (x0 & 3) == 0;
    if (row < rows) {
      const float* xr = smem + x0 + row * f;
      float z[4] = {0.f, 0.f, 0.f, 0.f};
      auto column = [&](float xv, float4 w) {
        if (kMode == kStaged) xv = round_bf16(xv);
        z[0] = __fmaf_rn(w.x, xv, z[0]);
        z[1] = __fmaf_rn(w.y, xv, z[1]);
        z[2] = __fmaf_rn(w.z, xv, z[2]);
        z[3] = __fmaf_rn(w.w, xv, z[3]);
      };
      if (vec) {  // 16-byte loads of x, free of bank conflicts
        for (int j = 4 * kr; j < f; j += 4 * tpr) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + j);
          column(xv.x, s_op[j]);
          column(xv.y, s_op[j + 1]);
          column(xv.z, s_op[j + 2]);
          column(xv.w, s_op[j + 3]);
        }
      } else {
        for (int j = kr; j < f; j += tpr) column(xr[j], s_op[j]);
      }
      for (int off = 1; off < tpr; off <<= 1)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          z[c] += __shfl_xor_sync(row_mask, z[c], off);
      const float4 cc = s_op[f];
      z[0] = z[0] + cc.x;
      z[1] = z[1] + cc.y;
      z[2] = z[2] + cc.z;
      z[3] = z[3] + cc.w;
      const float* act = st + tile.act + span_lead(a.act + 2 * r0) + 2 * row;
      float g[4];
      const float l = ppo_row(z, make_float2(act[0], act[1]),
                              st[tile.lp + span_lead(a.lp + r0) + row],
                              st[tile.adv + span_lead(a.adv + r0) + row],
                              a.k, g);
      if (kr == 0) {
        loss += l;
        s_gz[row] = make_float4(g[0], g[1], g[2], g[3]);
      }
    }
    __syncthreads();  // the tile's g_z
    if (summing) {
      // Column i of the group takes g_z rounded where kRound, but the
      // ones column (c0 + i == F) the float32 g_z in kStaged.
      auto add = [&](const float4 g32, const float (&xv)[4]) {
        const float4 g = make_float4(rx(g32.x), rx(g32.y), rx(g32.z),
                                     rx(g32.w));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 gi = kMode == kStaged && c0 + i == f ? g32 : g;
          const float xi = rx(xv[i]);
          acc[i][0] = __fmaf_rn(gi.x, xi, acc[i][0]);
          acc[i][1] = __fmaf_rn(gi.y, xi, acc[i][1]);
          acc[i][2] = __fmaf_rn(gi.z, xi, acc[i][2]);
          acc[i][3] = __fmaf_rn(gi.w, xi, acc[i][3]);
        }
      };
      const float* xc = smem + x0 + c0;
      if (full4 && vec) {
        for (int r = sub; r < rows; r += q) {
          const float4 v = *reinterpret_cast<const float4*>(xc + r * f);
          const float xv[4] = {v.x, v.y, v.z, v.w};
          add(s_gz[r], xv);
        }
      } else if (full4) {
        for (int r = sub; r < rows; r += q) {
          const float* xr = xc + r * f;
          const float xv[4] = {xr[0], xr[1], xr[2], xr[3]};
          add(s_gz[r], xv);
        }
      } else {  // the last group: x columns c0 .. F - 1, the ones, none
        for (int r = sub; r < rows; r += q) {
          const float* xr = xc + r * f;
          float xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            xv[i] = c0 + i < f ? xr[i] : c0 + i == f ? 1.f : 0.f;
          add(s_gz[r], xv);
        }
      }
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  // The block's partial: each output's row subsets in order, the loss by
  // warp shuffles and then the warps in order.
  float4* red = smem4;  // (q, ng, 4 columns) of the 4 outputs
  if (summing)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      red[(sub * ng + cg) * 4 + i] =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  const float v = warp_sum(loss);
  if (lane == 0) s_loss[warp] = v;
  __syncthreads();
  const int n_out = 4 * f + 5;
  float* part = a.partials + static_cast<long long>(blockIdx.x) * n_out;
  const float* red_f = smem;
  for (int o = tid; o < 4 * (f + 1); o += kThreads) {  // column o / 4
    float s = 0.f;
    for (int j = 0; j < q; ++j) s += red_f[16 * j * ng + o];
    const int c = o & 3, cl = o >> 2;
    part[cl < f ? 1 + c * f + cl : 1 + 4 * f + c] = s;
  }
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += s_loss[w];
    part[0] = s;
  }

  // The last block to finish sums the partials, in double: consecutive
  // threads on consecutive outputs (coalesced), `parts` groups of threads
  // on blocks part, part + parts, ..., eight loads in flight a thread
  // (into eight sums, added in a fixed tree), then the groups in order.
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int span = n_out < kThreads ? (n_out + 31) & ~31 : kThreads;
  const int parts = kThreads / span, part_i = tid / span, oi = tid % span;
  const int grid = static_cast<int>(gridDim.x);
  double* s_sum = reinterpret_cast<double*>(smem);  // (parts, span)
  for (int o0 = 0; o0 < n_out; o0 += span) {
    const int o = o0 + oi;
    double s[8] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    if (o < n_out) {
      const float* p = a.partials + o;
      int b = part_i;
      for (; b + 7 * parts < grid; b += 8 * parts)
#pragma unroll
        for (int u = 0; u < 8; ++u)
          s[u] += static_cast<double>(
              __ldcg(p + static_cast<long long>(b + u * parts) * n_out));
      for (; b < grid; b += parts)
        s[0] += static_cast<double>(
            __ldcg(p + static_cast<long long>(b) * n_out));
    }
    s_sum[part_i * span + oi] =
        ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
    __syncthreads();
    if (part_i == 0 && o < n_out) {
      double t = s_sum[oi];
      for (int j = 1; j < parts; ++j) t += s_sum[j * span + oi];
      a.out[o] = static_cast<float>(t);
    }
    __syncthreads();
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
// The hidden units (8 NT) run in passes of kNtg n-tiles (at most 16: 128
// units) over the rows; see tc_grad_kernel.
template <int NT>
struct PassTiles {
  static constexpr int kNt = NT;
  static constexpr int kNtg = NT > 16 ? 16 : NT;
  static constexpr int kGroups = NT / kNtg;
  static_assert(NT % kNtg == 0, "whole passes");
};

//
// BF (--bf16-updates): the products' operands are bf16 (rounded at the
// points of ops/update_math.py critic_grad_sums_reference): the tensor-core
// products on bf16 fragments (mma_bf16.cuh), and here w2 (in shared
// memory) and h for v, w2 and g_v for g_h, g_v and h for dW2.  The ReLU's
// mask reads the float32 h.  db1 sums the float32 g_pre (tc_grad_kernel's
// column sums), not as the ones row of [x | 1]^T g_pre, which would sum
// the rounded g_pre.
template <int NT, bool BF>
struct CriticHeadT : PassTiles<NT> {
  static constexpr int kNtg = PassTiles<NT>::kNtg;
  static constexpr bool kBf16 = BF;
  static constexpr int kAux = 2;    // floats a row: old value, return
  static constexpr int kThird = 0;  // dW2 stays in registers
  // With the float64 forward, v's sums in float64 too: a row whose v lies
  // near a clip edge takes the side float64 takes.
  static constexpr bool kF64Sums = !BF;
  static constexpr int kParamFloats = NT * 8;  // w2, zero-padded
  static constexpr int kSums = 2;   // a lane's share of v, rows g and g + 8
  static constexpr int kSmallMax = NT * 8 + 2 + (BF ? NT * 8 : 0);
  static __host__ __device__ int n_out(int in, int hid) {
    return 1 + hid * in + 2 * hid + 1;
  }
  // Per-warp sums besides the tiles: loss, dW2 (H), db2, and with BF db1
  // (H).
  static __host__ __device__ int n_small(int hid) {
    return hid + 2 + (BF ? hid : 0);
  }
  static __device__ int small_index(int k, int in, int hid) {
    return k == 0         ? 0
           : k <= hid + 1 ? 1 + hid * in + hid + (k - 1)
                          : 1 + hid * in + (k - hid - 2);
  }
  // The small index of db1 (j = 0) with BF.
  static __device__ int db1_small(int hid) { return hid + 2; }
  // Output of element (m, j) of the backward product: dW1 (j, m), db1 (j)
  // in row In (not with BF); -1 in the padding.
  static __device__ int tile_index(int m, int j, int in, int hid, int) {
    if (j >= hid || m > in || (BF && m == in)) return -1;
    return m < in ? 1 + j * in + m : 1 + hid * in + j;
  }

  float acc_w2[kNtg][2];  // dW2 of the pass's columns, over this lane's rows
  float acc_loss, acc_b2;  // lanes t == 0: rows g and g + 8
  float b2, eps;

  static __device__ float r(float x) { return BF ? round_bf16(x) : x; }

  __device__ void init(const GradArgs& a, float* s_par, int tid,
                       int threads) {
    for (int j = tid; j < NT * 8; j += threads)
      s_par[j] = j < a.hidden ? r(a.head[0][j]) : 0.f;
    b2 = a.head[1][0];
    eps = a.eps;
    acc_loss = acc_b2 = 0.f;
    clear();
  }

  // Zero the sums of a pass's columns.
  __device__ void clear() {
#pragma unroll
    for (int nt = 0; nt < kNtg; ++nt) acc_w2[nt][0] = acc_w2[nt][1] = 0.f;
  }

  // Old values into aux[0 .. 15], returns into aux[16 .. 31].
  static __device__ void prefetch(const GradArgs& a, long long r0, int rows,
                                  float* aux, int lane) {
    prefetch_column(a.row[0], r0, rows, aux, lane, 0);
    prefetch_column(a.row[1], r0, rows, aux + 16, lane, 16);
  }

  // From the pre-activations c of hidden units col0 + 8 nt + 2t, + 1 (the
  // fragments of rows g and g + 8): h = relu(pre) in place, and this lane's
  // share of w2 . h added to p.
  template <int NTG>
  static __device__ void sums(float (&c)[NTG][4], const float* s_par,
                              int col0, int t, float (&p)[kSums]) {
#pragma unroll
    for (int nt = 0; nt < NTG; ++nt) {
      const float2 w =
          *reinterpret_cast<const float2*>(s_par + col0 + nt * 8 + 2 * t);
#pragma unroll
      for (int i = 0; i < 4; ++i) c[nt][i] = fmaxf(c[nt][i], 0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        p[h] = p[h] + w.x * r(c[nt][2 * h]);
        p[h] = p[h] + w.y * r(c[nt][2 * h + 1]);
      }
    }
  }

  // As sums, in float64, for the n-tiles n0 .. n0 + NG - 1 (below ntg) of
  // the float64 pre-activations cd (tc_forward_f64; one pass, float32
  // operands): the ReLU in place, then this lane's share of w2 . h.
  template <int NG>
  static __device__ void sums_f64(double (&cd)[NG][4], int n0, int ntg,
                                  const float* s_par, int t,
                                  double (&p)[kSums]) {
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      if (n0 + j >= ntg) break;
      const float2 w =
          *reinterpret_cast<const float2*>(s_par + (n0 + j) * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) cd[j][e] = cd[j][e] > 0.0 ? cd[j][e] : 0.0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        p[h] = p[h] + static_cast<double>(w.x) * cd[j][2 * h];
        p[h] = p[h] + static_cast<double>(w.y) * cd[j][2 * h + 1];
      }
    }
  }

  // The 16 rows of a chunk from the lane's shares p of w2 . h (all hidden
  // units; float32, or float64 after tc_forward_f64) and the pass's h in c
  // (units col0 ..): the loss chain, g_pre into s_g (16, LDG); rows from
  // row0 on are valid below n.  The loss and db2 count where `first` (the
  // first pass).
  template <int NTG, int LDG, typename PT>
  __device__ void rows(float (&c)[NTG][4], PT (&p)[kSums],
                       const float* s_par, const float* aux, long long row0,
                       long long n, int g, int t, int col0, bool first,
                       float* s_g, float*, float*) {
    // The chunk's sums of this lane's two rows (its partials), added to the
    // lane's running sums once a chunk.
    float gv[2], loss_c = 0.f, b2_c = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      p[h] = p[h] + __shfl_xor_sync(0xffffffffu, p[h], 1);
      p[h] = p[h] + __shfl_xor_sync(0xffffffffu, p[h], 2);
      const int row = g + 8 * h;
      float loss;
      const float gvr = update::critic_row(static_cast<float>(p[h] + b2),
                                           aux[row], aux[16 + row], eps,
                                           &loss);
      const bool valid = row0 + row < n;
      gv[h] = valid ? gvr : 0.f;
      if (valid) {
        loss_c += loss;
        b2_c += gvr;
      }
    }
    if (t == 0 && first) {
      acc_loss += loss_c;
      acc_b2 += b2_c;
    }
    // g_pre = (w2 g_v) (h > 0) into the warp's tile; dW2 += g_v h.
#pragma unroll
    for (int nt = 0; nt < NTG; ++nt) {
      const float2 w =
          *reinterpret_cast<const float2*>(s_par + col0 + nt * 8 + 2 * t);
      float w2_c[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float h0 = c[nt][2 * h], h1 = c[nt][2 * h + 1];
        const float gvh = r(gv[h]);
        const float2 gp = make_float2((w.x * gvh) * flag(h0 > 0.f),
                                      (w.y * gvh) * flag(h1 > 0.f));
        *reinterpret_cast<float2*>(s_g + (g + 8 * h) * LDG + nt * 8 + 2 * t) =
            gp;
        w2_c[0] += gvh * r(h0);
        w2_c[1] += gvh * r(h1);
      }
      acc_w2[nt][0] += w2_c[0];
      acc_w2[nt][1] += w2_c[1];
    }
  }

  // This warp's dW2 sums of the pass's columns (col0 ..) and, with
  // `scalars`, its loss and db2 sums into dst, at small index k, or at
  // their output index where `full`.
  __device__ void store_small(float* dst, bool full, int in, int hid, int g,
                              int t, int lane, int col0 = 0,
                              bool scalars = true) {
#pragma unroll
    for (int nt = 0; nt < kNtg; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = acc_w2[nt][e];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        const int j = col0 + nt * 8 + 2 * t + e;
        if (g == 0 && j < hid)
          dst[full ? small_index(1 + j, in, hid) : 1 + j] = s;
      }
    if (!scalars) return;
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
//
// BF (--bf16-updates): the products' operands are bf16 (ops/update_math.py
// actor_grad_sums_uncollapsed_reference): the tensor-core products on bf16
// fragments, and here [Wmu; Wvar] (in shared memory) and h for z, [Wmu;
// Wvar] and g_z for g_h; db1 sums the float32 g_h (tc_grad_kernel's column
// sums).
template <int NT, bool BF>
struct ActorHeadT : PassTiles<NT> {
  static constexpr int kNtg = PassTiles<NT>::kNtg;
  static constexpr bool kBf16 = BF;
  static constexpr int kAux = 4;    // floats a row: action (2), lp, adv
  static constexpr int kThird = 1;  // dWmu, dWvar = g_z^T h, one m-tile
  static constexpr bool kF64Sums = false;  // z's sums in float32
  // [Wmu; Wvar] (4, 8 NT), zero-padded, then [bmu; bvar].
  static constexpr int kParamFloats = 4 * NT * 8 + 4;
  // A lane's share of z = [Wmu; Wvar] h: p[2 o + h], output o, rows g and
  // g + 8.
  static constexpr int kSums = 8;
  static constexpr int kSmallMax = 5 + (BF ? NT * 8 : 0);
  static __host__ __device__ int n_out(int in, int hid) {
    return 1 + hid * in + 5 * hid + 4;
  }
  // Per-warp sums besides the tiles: loss, dbmu (2), dbvar (2), and with BF
  // db1 (H).
  static __host__ __device__ int n_small(int hid) {
    return 5 + (BF ? hid : 0);
  }
  static __device__ int small_index(int k, int in, int hid) {
    const int o_bmu = 1 + hid * in + 3 * hid;
    return k == 0  ? 0
           : k < 3 ? o_bmu + k - 1
           : k < 5 ? o_bmu + 2 * hid + k - 1
                   : 1 + hid * in + (k - 5);
  }
  // The small index of db1 (j = 0) with BF.
  static __device__ int db1_small(int) { return 5; }
  // Output of element (m, j) of the backward products: rows m < extra0 are
  // [x | 1]^T g_h (dW1 (j, m), db1 (j) in row In, not with BF), rows
  // extra0 + c (c < 4) are g_z^T h (dWmu, then dWvar); -1 in the padding.
  static __device__ int tile_index(int m, int j, int in, int hid,
                                   int extra0) {
    if (j >= hid) return -1;
    if (m < extra0) {
      if (m > in || (BF && m == in)) return -1;
      return m < in ? 1 + j * in + m : 1 + hid * in + j;
    }
    const int c = m - extra0, o_wmu = 1 + hid * in + hid;
    if (c >= 4) return -1;
    return c < 2 ? o_wmu + c * hid + j
                 : o_wmu + 2 * hid + 2 + (c - 2) * hid + j;
  }

  // Lanes t == 0, 2: row g, or g + 8, of each chunk, one term a chunk (the
  // lane's whole share of it).
  float acc_loss, acc_bh[4];
  PpoConsts k;

  static __device__ float r(float x) { return BF ? round_bf16(x) : x; }

  __device__ void init(const GradArgs& a, float* s_par, int tid,
                       int threads) {
    const int hid = a.hidden;
    for (int i = tid; i < 4 * NT * 8; i += threads) {
      const int c = i / (NT * 8), j = i - c * NT * 8;
      s_par[i] = j >= hid ? 0.f
                 : c < 2  ? r(a.head[0][c * hid + j])
                          : r(a.head[2][(c - 2) * hid + j]);
    }
    if (tid < 4)
      s_par[4 * NT * 8 + tid] = tid < 2 ? a.head[1][tid] : a.head[3][tid - 2];
    k = a.k;
    acc_loss = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_bh[c] = 0.f;
  }

  // The pass's sums are all tiles of the backward.
  __device__ void clear() {}

  // Actions into aux[0 .. 31] (row r at 2r, 2r + 1), log-probs into
  // aux[32 .. 47], advantages into aux[48 .. 63].
  static __device__ void prefetch(const GradArgs& a, long long r0, int rows,
                                  float* aux, int lane) {
    if (lane < 2 * rows) mma::cp_async4(aux + lane, a.row[0] + 2 * r0 + lane);
    prefetch_column(a.row[1], r0, rows, aux + 32, lane, 0);
    prefetch_column(a.row[2], r0, rows, aux + 48, lane, 16);
  }

  // This lane's share of z = [Wmu; Wvar] h over hidden units col0 + 8 nt +
  // 2t, + 1, whose h = [x | 1][W1^T ; b1] is in c (the fragments of rows g
  // and g + 8), added to p.
  template <int NTG>
  static __device__ void sums(float (&c)[NTG][4], const float* s_par,
                              int col0, int t, float (&p)[kSums]) {
#pragma unroll
    for (int nt = 0; nt < NTG; ++nt)
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const float2 w = *reinterpret_cast<const float2*>(
            s_par + o * NT * 8 + col0 + nt * 8 + 2 * t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          p[2 * o + h] = p[2 * o + h] + w.x * r(c[nt][2 * h]);
          p[2 * o + h] = p[2 * o + h] + w.y * r(c[nt][2 * h + 1]);
        }
      }
  }

  // The 16 rows of a chunk from the lane's shares p of z (all hidden units)
  // and the pass's h in c (units col0 ..): the PPO chain, then h into s_h
  // (16, LDG), g_z into s_z (16, 4) and g_h into s_g (16, LDG).  The loss
  // and the head biases' sums count where `first` (the first pass).
  template <int NTG, int LDG, typename PT>
  __device__ void rows(float (&c)[NTG][4], PT (&p)[kSums],
                       const float* s_par, const float* aux, long long row0,
                       long long n, int g, int t, int col0, bool first,
                       float* s_g, float* s_h, float* s_z) {
    // The PPO chain once a lane: lanes t = 0, 1 of the quad take row g,
    // lanes 2, 3 row g + 8; the quad's other row comes by one shuffle.
    const int mh = t >> 1, row = g + 8 * mh;
    float z[4];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        PT& q = p[2 * o + h];
        q = q + __shfl_xor_sync(0xffffffffu, q, 1);
        q = q + __shfl_xor_sync(0xffffffffu, q, 2);
      }
      z[o] = static_cast<float>((mh ? p[2 * o + 1] : p[2 * o]) +
                                s_par[4 * NT * 8 + o]);
    }
    float g_row[4], gz[2][4];  // gz: rows g and g + 8
    const float loss = ppo_row(z, make_float2(aux[2 * row], aux[2 * row + 1]),
                               aux[32 + row], aux[48 + row], k, g_row);
    const bool valid = row0 + row < n;
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      g_row[o] = valid ? g_row[o] : 0.f;
      const float other = __shfl_xor_sync(0xffffffffu, g_row[o], 2);
      gz[0][o] = r(mh ? other : g_row[o]);  // g_z as g_h's operand
      gz[1][o] = r(mh ? g_row[o] : other);
    }
    if (valid && (t & 1) == 0 && first) {
      acc_loss += loss;
#pragma unroll
      for (int o = 0; o < 4; ++o) acc_bh[o] += g_row[o];
    }
    if ((t & 1) == 0)
      *reinterpret_cast<float4*>(s_z + row * 4) =
          make_float4(g_row[0], g_row[1], g_row[2], g_row[3]);
    // h and g_h = Wmu^T g_u + Wvar^T g_s into the warp's tiles.
#pragma unroll
    for (int nt = 0; nt < NTG; ++nt) {
      float w[4][2];
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const float2 v = *reinterpret_cast<const float2*>(
            s_par + o * NT * 8 + col0 + nt * 8 + 2 * t);
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

  // This warp's loss, dbmu and dbvar sums into dst where `scalars` (see
  // CriticHeadT).
  __device__ void store_small(float* dst, bool full, int in, int hid, int,
                              int, int lane, int = 0, bool scalars = true) {
    if (!scalars) return;
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

// The heads' float32 instances (3xTF32) and bf16 ones (--bf16-updates),
// each its own type, so that a kernel instance's name says which it is.
template <int NT>
struct CriticHead : CriticHeadT<NT, false> {};
template <int NT>
struct CriticHeadBf16 : CriticHeadT<NT, true> {};
template <int NT>
struct ActorHead : ActorHeadT<NT, false> {};
template <int NT>
struct ActorHeadBf16 : ActorHeadT<NT, true> {};

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

constexpr int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// The shape of tc_grad_kernel<Head, KS>: KS k-steps of 8 over [x | 1] (In +
// 1 <= 8 KS), NT = Head::kNt n-tiles of 8 over the hidden units (H <= 8 NT),
// in kGroups passes of kNtg n-tiles each.
template <class Head, int KS>
struct TcShape {
  static constexpr int kNt = Head::kNt;
  static constexpr int kNtg = Head::kNtg;
  static constexpr int kGroups = Head::kGroups;
  static constexpr int kMt = (KS + 1) / 2;  // backward m-tiles over [x | 1]
  static constexpr int kMtAll = kMt + Head::kThird;
  // The row buffer's stride LDX (= 4 mod 8) keeps the forward A loads free
  // of bank conflicts (the transposed backward loads have 2-way ones);
  // g_pre's LDG (= 8 or 24 mod 32) keeps the backward B loads free of them.
  static constexpr int kLdx = kMt * 16 + 4;
  static constexpr int kLdg = kNtg * 8 % 16 == 0 ? kNtg * 8 + 8 : kNtg * 8;
  // Warps share their rows where one warp's registers would not hold
  // every output tile of a pass: the default critic (3 x 7 tiles, 211
  // registers) is the largest that does not.
  static constexpr bool kShared = kGroups > 1 || kMtAll * kNtg > 21;
  // A warp's region: rows (2, 16, LDX) | g_pre (16, LDG) | h (16, LDG) and
  // g_z (16, 4) for a third product | per-row inputs (2, 16 kAux).
  static constexpr int kOffG = 2 * 16 * kLdx;
  static constexpr int kOffH = kOffG + 16 * kLdg;
  static constexpr int kOffZ = kOffH + Head::kThird * 16 * kLdg;
  static constexpr int kOffAux = kOffZ + Head::kThird * 16 * 4;
  static constexpr int kWarpFloats = kOffAux + 2 * 16 * Head::kAux;
  // With several passes, each warp keeps its small sums (loss, the head's
  // bias sums, the critic's dW2) in a row of its own across them.
  static constexpr int kSmall = kGroups > 1 ? Head::kSmallMax : 0;
  // W1's fragments split into TF32 halves once a block where that fits
  // beside 8 warps, else as floats split at each load.  bf16 (Head::kBf16):
  // W1's m16n8k16 B fragments over kMt k-steps of 16 (K = In, the bias not
  // in the product), two packed registers a lane, then b1 (8 NT floats),
  // from which the forward's accumulators start.
  static constexpr bool kBf16 = Head::kBf16;
  // The forward on the float64 tensor cores (tc_forward_f64) where a pass
  // is one of at most 8 n-tiles: its float64 sums, two n-tiles at a time,
  // fit beside the backward's accumulators.  W1's fragments are held as
  // float64 pairs (the size of the TF32 halves).
  static constexpr bool kFloat64 = !kBf16 && kGroups == 1 && kNtg <= 8;
  static constexpr bool kPreSplit =
      !kFloat64 && KS * kNt * 32 * 4 + Head::kParamFloats +
                           8 * (kWarpFloats + kSmall) <=
                       kSmemFloats;
  static constexpr int kB1Off = kMt * kNt * 32 * 2;
  static constexpr int kFragFloats =
      kBf16 ? kB1Off + kNt * 8
            : KS * kNt * 32 * (kPreSplit || kFloat64 ? 4 : 2);
  static constexpr int kFit = (kSmemFloats - kFragFloats -
                               Head::kParamFloats) / (kWarpFloats + kSmall);
  // The warp-specialised body (tc_pipelined): the float32 critic's
  // per-warp float64 instances whose backward holds at most 3 m-tiles.
  // kFwdWarps forward and head warps, then kBwdWarps backward warps (12
  // warps: 168 registers a thread, the most that holds a backward warp's
  // output tiles beside its fragments without a spill), on a ring of kRing
  // chunk stages (x (16, LDX) | g_pre (16, LDG) | per-row inputs (16 kAux))
  // after W1's fragments and the head's weights; then the warps' sums
  // (kRedFloats: the backward warps' tiles, the forward warps' small sums,
  // at the widest In and H of the instance), then two mbarriers a stage (2
  // floats each).  kRing is a multiple of both warp counts.
  static constexpr bool kPipelined =
      kFloat64 && !kShared && Head::kF64Sums && kMt <= 3;
  static constexpr int kFwdWarps = 6;
  static constexpr int kBwdWarps = 6;
  static constexpr int kStageFloats = 16 * (kLdx + kLdg + Head::kAux);
  static constexpr int kRedFloats =
      (kBwdWarps * (64 * KS * kNt + 8 * kNt + 2) +
       kFwdWarps * (8 * kNt + 2) + 1) / 2 * 2;
  static constexpr int kRingFit =
      (kSmemFloats - kFragFloats - Head::kParamFloats - kRedFloats) /
      (kStageFloats + 4);
  static constexpr int kRingUnit = kFwdWarps * kBwdWarps /
                                   gcd(kFwdWarps, kBwdWarps);
  static constexpr int kRing =
      (kRingFit < 32 ? kRingFit : 32) / kRingUnit * kRingUnit;
  static constexpr int kRedOff =
      kFragFloats + Head::kParamFloats + kRing * kStageFloats;
  static constexpr int kBarOff = kRedOff + kRedFloats;
  static constexpr int kWarps = kPipelined ? kFwdWarps + kBwdWarps
                                : kFit < 8  ? kFit
                                            : 8;
  // Chunks of 16 rows a block takes a round: its warps, or the pipelined
  // body's forward warps (the persistent grid's rows a block round).
  static constexpr int kRoundChunks = kPipelined ? kFwdWarps : kWarps;
  static constexpr int kMainFloats =
      kPipelined ? kBarOff + 4 * kRing
                 : kFragFloats + Head::kParamFloats +
                       kWarps * (kWarpFloats + kSmall);
  // Output tiles of a warp: a WM x WN grid of warps over a pass's (kMtAll,
  // kNtg) tiles where the rows are shared, else all of them.
  static constexpr int kWn = kShared ? tc_best_wn(kMtAll, kNtg, kWarps) : 1;
  static constexpr int kWm = kShared ? kWarps / kWn : 1;
  static constexpr int kMtw = (kMtAll + kWm - 1) / kWm;
  static constexpr int kNtw = (kNtg + kWn - 1) / kWn;
  static_assert(kWarps >= 1 && kMainFloats <= kSmemFloats,
                "an instance fits the block's shared memory");
  static_assert(kShared || kPipelined || kWarps == 8,
                "per-warp instances take 8 warps");
  static_assert(!kPipelined || (kRing > 0 && Head::kAux == 2),
                "a ring whose length both warp counts divide");
};

template <int S>
__device__ __forceinline__ void group_sync() {
  if (S == 1)
    __syncwarp();
  else
    __syncthreads();
}

// c += d, where d is one k-step's product, accumulated by the tensor core
// from zero: the running sums are float32 adds on the CUDA cores, so no
// tensor-core accumulation runs longer than a k-step.  The tensor core's
// own float32 accumulation is not rounded to nearest: chained over hundreds
// of k-steps, its sums drifted from float64 far past the plain version's
// error (5x on dW1 at In 1040, 10-80x on the templated instances' db1).
__device__ __forceinline__ void add_to(float (&c)[4], const float (&d)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = c[e] + d[e];
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

// pre = [x | 1] [W1^T ; b1] over a warp's 16 rows x (16, LDX) for the
// n-tiles nt0 .. nt0 + NTG - 1, into c (the fragments of rows g and g + 8),
// in 3xTF32: the instances past 8 n-tiles a pass, whose registers hold no
// float64 sums (tc_forward_f64).
template <class Sh, int KS, int NTG, int LDX>
__device__ __forceinline__ void tc_forward(float (&c)[NTG][4], const float* x,
                                           const float4* smem4, int nt0,
                                           int lane) {
  constexpr int NT = Sh::kNt;
#pragma unroll
  for (int nt = 0; nt < NTG; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[nt][i] = 0.f;
  auto kstep = [&](int ks) {
    float a[4];
    uint32_t a_big[4], a_small[4];
    mma::load_a_rows(x + ks * 8, LDX, lane, a);
    mma::split(a, a_big, a_small);
#pragma unroll
    for (int nt = 0; nt < NTG; ++nt) {
      uint32_t b_big[2], b_small[2];
      const int at = (ks * NT + nt0 + nt) * 32 + lane;
      if (Sh::kPreSplit) {
        const float4 w = smem4[at];
        b_big[0] = __float_as_uint(w.x);
        b_big[1] = __float_as_uint(w.y);
        b_small[0] = __float_as_uint(w.z);
        b_small[1] = __float_as_uint(w.w);
      } else {
        const float2 w = reinterpret_cast<const float2*>(smem4)[at];
        const float b[2] = {w.x, w.y};
        mma::split(b, b_big, b_small);
      }
      mma::mma_3xtf32(c[nt], a_big, a_small, b_big, b_small);
    }
  };
  // The one-pass instances take the k-steps as a loop, the two-pass ones
  // unrolled: each way the other spilled past 64 hidden units.
  if constexpr (Sh::kGroups == 1) {
#pragma unroll 1
    for (int ks = 0; ks < KS; ++ks) kstep(ks);
  } else {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) kstep(ks);
  }
}

// The same on the float64 tensor cores (TcShape::kFloat64): pre of each
// row and n-tile summed in float64 over the k-steps from W1's fragments (w:
// b0, b1 a lane, as float64), then rounded to float32 once, into c.  Where
// the head takes float64 sums (Head::kF64Sums), its sums from the float64
// pre into p.  NG n-tiles at a time (the same sums in the same order at any
// NG), the k-steps as a loop: unrolled, their loads were all hoisted and
// spilled.  tc_grad_kernel's own body takes two; the pipelined forward
// warps (tc_pipelined), whose registers hold nothing else, take more.
template <class Sh, class Head, int KS, int NTG, int LDX, typename PT,
          int NG = 2>
__device__ __forceinline__ void tc_forward_f64(float (&c)[NTG][4],
                                               PT (&p)[Head::kSums],
                                               const float* x,
                                               const double2* w,
                                               const float* s_par, int lane) {
  constexpr int NT = Sh::kNt;
  const int g = lane >> 2, t = lane & 3;
  const float* xl = x + g * LDX + t;  // rows g, g + 8; columns t, t + 4
#pragma unroll
  for (int n0 = 0; n0 < NTG; n0 += NG) {
    double cd[NG][4];
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cd[j][e] = 0.0;
#pragma unroll 1
    for (int ks = 0; ks < KS; ++ks) {
      const float* xk = xl + ks * 8;
      const double a[4] = {xk[0], xk[8 * LDX], xk[4], xk[8 * LDX + 4]};
      const double2* wk = w + (ks * NT + n0) * 32 + lane;
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        if (n0 + j >= NTG) break;
        const double2 b = wk[j * 32];
        mma::mma_f64(cd[j], a, b.x, b.y);
      }
    }
    if constexpr (Head::kF64Sums) Head::sums_f64(cd, n0, NTG, s_par, t, p);
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      if (n0 + j >= NTG) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) c[n0 + j][e] = static_cast<float>(cd[j][e]);
    }
  }
}

// The same in bf16: pre = b1 + x W1^T, the sums started from b1 (float32,
// unrounded), one m16n8k16 product a k-step of 16 on x rounded at its
// fragment load and W1's pre-rounded fragments, from zero and added by
// add_to; the ones column of [x | 1] meets zeros there.
template <class Sh, int NTG, int LDX>
__device__ __forceinline__ void tc_forward_bf16(float (&c)[NTG][4],
                                                const float* x,
                                                const float4* smem4, int nt0,
                                                int lane) {
  constexpr int NT = Sh::kNt;
  const uint2* frag = reinterpret_cast<const uint2*>(smem4);
  const float* b1 = reinterpret_cast<const float*>(smem4) + Sh::kB1Off;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NTG; ++nt) {
    const float2 b = *reinterpret_cast<const float2*>(
        b1 + (nt0 + nt) * 8 + 2 * t);
    c[nt][0] = c[nt][2] = b.x;
    c[nt][1] = c[nt][3] = b.y;
  }
#pragma unroll
  for (int k16 = 0; k16 < Sh::kMt; ++k16) {
    uint32_t a[4];
    mma::load_a_rows_bf16(x + k16 * 16, LDX, lane, a);
#pragma unroll
    for (int nt = 0; nt < NTG; ++nt) {
      const uint2 w = frag[(k16 * NT + nt0 + nt) * 32 + lane];
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma::mma_bf16(d, a, w.x, w.y);
      add_to(c[nt], d);
    }
  }
}

// The warp-specialised body's pieces (tc_pipelined).
//
// Fill a stage with chunk `chunk` (rows 16 chunk .. 16 chunk + 15): obs into
// sx (16, LDX), old values and returns into aux (16 each), completing on
// the stage's mbarrier `bar` (32 arrivals, one a lane).  A whole chunk
// whose rows and per-row inputs start on 16 bytes (bulk) goes by bulk
// copies (a row a lane, a column each for lanes 16 and 17; the tensor
// memory accelerator counts their bytes on bar); else by cp.async, rows
// past n_rows landing as zeros.  The columns past In keep what the block
// put there at its start (the ones column, zeros).  The stage's earlier
// reads must be ordered before the call (a barrier's wait, __syncwarp).
template <int LDX>
__device__ __forceinline__ void tc_fill_stage(const GradArgs& a,
                                              long long chunk, bool bulk,
                                              float* sx, float* aux,
                                              uint64_t* bar, int lane) {
  const long long r0 = chunk * 16;
  const int in = a.in_size;
  const float* src = a.obs + r0 * in;
  if (bulk && r0 + 16 <= a.n_rows) {
    mma::fence_proxy_async();
    if (lane == 0)
      mma::mbar_arrive_expect(bar, 64 * in + 128);
    else
      mma::mbar_arrive(bar);
    if (lane < 16)
      mma::bulk_copy(sx + lane * LDX, src + lane * in, 4 * in, bar);
    else if (lane < 18)
      mma::bulk_copy(aux + 16 * (lane - 16),
                     (lane == 16 ? a.row[0] : a.row[1]) + r0, 64, bar);
    return;
  }
  const int rows = static_cast<int>(a.n_rows - r0 < 16 ? a.n_rows - r0 : 16);
  if (a.vec4) {
    const int per_row = in / 4;
    for (int u = lane; u < 16 * per_row; u += 32) {
      const int r = u / per_row;
      mma::cp_async16_zfill(sx + r * LDX + 4 * (u - r * per_row),
                            r < rows ? src + 4 * u : a.obs, r < rows);
    }
  } else {
    for (int u = lane; u < 16 * in; u += 32) {
      const int r = u / in;
      mma::cp_async4_zfill(sx + r * LDX + (u - r * in),
                           r < rows ? src + u : a.obs, r < rows);
    }
  }
  const int r = lane & 15;
  const float* col = lane < 16 ? a.row[0] : a.row[1];
  mma::cp_async4_zfill(aux + lane, r < rows ? col + r0 + r : col, r < rows);
  mma::cp_async_mbar_arrive(bar);
}

// bacc += [x | 1]^T g_pre over a chunk's 16 rows (two k-steps of 8), every
// (MT, NT) output tile, in 3xTF32: each k-step's product from zero, added
// by add_to, as tc_grad_kernel's per-warp body does.
template <class Sh>
__device__ __forceinline__ void tc_backward_chunk(
    float (&bacc)[Sh::kMt][Sh::kNt][4], const float* x, const float* gp,
    int lane) {
  constexpr int MT = Sh::kMt, NT = Sh::kNt, LDX = Sh::kLdx, LDG = Sh::kLdg;
#pragma unroll
  for (int kr = 0; kr < 2; ++kr) {
    uint32_t a_big[MT][4], a_small[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float v[4];
      mma::load_a_cols(x + kr * 8 * LDX + i * 16, LDX, lane, v);
      mma::split(v, a_big[i], a_small[i]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float v[2];
      uint32_t b_big[2], b_small[2];
      mma::load_b_rows(gp + kr * 8 * LDG + j * 8, LDG, lane, v);
      mma::split(v, b_big, b_small);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma::mma_3xtf32(d, a_big[i], a_small[i], b_big, b_small);
        add_to(bacc[i][j], d);
      }
    }
  }
}

// The warp-specialised body of the float32 critic's per-warp float64
// instances (TcShape::kPipelined; the head note says why).  Block b takes
// chunks b, b + grid, ... (its i-th is local chunk i) through a ring of
// kRing stages, chunk i in stage i % kRing, each stage with two mbarriers
// of 32 arrivals:
//   - forward warp f (0 .. kFwdWarps - 1) takes local chunks f, f +
//     kFwdWarps, ...: waits on full_x, runs the float64 forward and the
//     head on the stage's x, as tc_grad_kernel's body does, writes g_pre
//     into the stage and arrives on full_g; it keeps the loss, db2 and dW2
//     sums in its registers;
//   - backward warp k (kFwdWarps + k) takes local chunks k, k + kBwdWarps,
//     ...: waits on full_g, adds the chunk's [x | 1]^T g_pre to its output
//     tiles (all of them, in registers), then refills the stage with chunk
//     i + kRing (tc_fill_stage).  The backward warps also start the ring's
//     first chunks, each its own.
// So a stage's chunks land in order, and since kRing is a multiple of both
// warp counts, a warp's own chunk kRing before the one it waits for has
// passed the same barrier: a wait on phase p never meets phase p - 1
// unfinished, nor p + 1 finished (that needs this chunk's backward).  A
// chunk's g_pre on full_g also orders its x, which the forward warp read
// after full_x.  At the end each warp writes its sums to its own row (the
// forward warps' small sums into red_f (kFwdWarps, n_small) at their small
// index, the backward warps' tiles into red_b (kBwdWarps, n_out) at their
// output index); after a block barrier (a named one: the roles never
// reconverge) the backward warps sum each over its warps in order into the
// block's partial.  Every sum's order depends only on the rows and the
// grid.
template <class Head, int KS>
__device__ __forceinline__ void tc_pipelined(const GradArgs& a,
                                             float4* smem4) {
  using Sh = TcShape<Head, KS>;
  constexpr int NT = Sh::kNt, MT = Sh::kMt, LDX = Sh::kLdx, LDG = Sh::kLdg;
  constexpr int NF = Sh::kFwdWarps, NB = Sh::kBwdWarps, R = Sh::kRing;
  constexpr int W = Sh::kWarps, ST = Sh::kStageFloats;
  constexpr int kOffG = 16 * LDX, kOffAux = kOffG + 16 * LDG;
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_par = smem + Sh::kFragFloats;
  float* stages = s_par + Head::kParamFloats;
  uint64_t* full_x = reinterpret_cast<uint64_t*>(smem + Sh::kBarOff);
  uint64_t* full_g = full_x + R;
  const int in = a.in_size, hid = a.hidden;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // W1's fragments as float64 pairs (tc_grad_kernel's kFloat64 layout).
  for (int i = tid; i < KS * NT * 32; i += W * 32) {
    const int l = i & 31, nt = (i >> 5) % NT, ks = (i >> 5) / NT;
    const int n = nt * 8 + (l >> 2), k = ks * 8 + (l & 3);
    float b[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = k + 4 * h;
      b[h] = n >= hid ? 0.f
             : kk < in ? a.w1[n * in + kk]
             : kk == in ? a.b1[n]
                        : 0.f;
    }
    reinterpret_cast<double2*>(smem4)[i] = make_double2(b[0], b[1]);
  }
  Head head;
  head.init(a, s_par, tid, W * 32);
  // Every stage's x: the ones column of [x | 1], zeros elsewhere.
  for (int i = tid; i < R * ST; i += W * 32) {
    const int o = i % ST;
    stages[i] = o < 16 * LDX && o % LDX == in ? 1.f : 0.f;
  }
  if (tid < R) {
    mma::mbar_init(&full_x[tid], 32);
    mma::mbar_init(&full_g[tid], 32);
  }
  __syncthreads();

  const long long n = a.n_rows, n_chunks = (n + 15) / 16;
  const long long grid = gridDim.x, b0 = blockIdx.x;
  const long long n_local = b0 < n_chunks ? (n_chunks - b0 + grid - 1) / grid
                                          : 0;
  const int n_out = Head::n_out(in, hid), n_small = Head::n_small(hid);
  float* red_b = smem + Sh::kRedOff;
  float* red_f = red_b + NB * n_out;
  // Bulk copies where obs rows and the per-row inputs start on 16 bytes.
  const bool bulk =
      a.vec4 && (reinterpret_cast<std::uintptr_t>(a.row[0]) |
                 reinterpret_cast<std::uintptr_t>(a.row[1])) % 16 == 0;
  // Local chunk i into its stage, completing on the stage's full_x.
  auto load = [&](long long i) {
    const int s = static_cast<int>(i % R);
    float* st = stages + s * ST;
    tc_fill_stage<LDX>(a, b0 + i * grid, bulk, st, st + kOffAux, &full_x[s],
                       lane);
  };

  if (warp < NF) {
    const double2* w = reinterpret_cast<const double2*>(smem4);
    for (long long i = warp; i < n_local; i += NF) {
      const int s = static_cast<int>(i % R);
      mma::mbar_wait_suspended(&full_x[s],
                               static_cast<unsigned>((i / R) & 1));
      float* st = stages + s * ST;
      float c[NT][4];
      double p[Head::kSums];
#pragma unroll
      for (int q = 0; q < Head::kSums; ++q) p[q] = 0.0;
      tc_forward_f64<Sh, Head, KS, NT, LDX, double, NT>(c, p, st, w, s_par,
                                                         lane);
      head.template rows<NT, LDG>(c, p, s_par, st + kOffAux,
                                  (b0 + i * grid) * 16, n, g, t, 0, true,
                                  st + kOffG, nullptr, nullptr);
      mma::mbar_arrive(&full_g[s]);
    }
    head.store_small(red_f + warp * n_small, false, in, hid, g, t, lane);
    mma::named_sync<W * 32>();
  } else {
    const int k = warp - NF;
    for (long long i = k; i < R && i < n_local; i += NB) load(i);
    float bacc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) bacc[i][j][e] = 0.f;
    for (long long i = k; i < n_local; i += NB) {
      const int s = static_cast<int>(i % R);
      mma::mbar_wait_suspended(&full_g[s],
                               static_cast<unsigned>((i / R) & 1));
      const float* st = stages + s * ST;
      tc_backward_chunk<Sh>(bacc, st, st + kOffG, lane);
      if (i + R < n_local) {
        __syncwarp();  // every lane's reads of the stage before its refill
        load(i + R);
      }
    }
    float* my = red_b + k * n_out;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = Head::tile_index(i * 16 + g + 8 * (e >> 1),
                                         j * 8 + 2 * t + (e & 1), in, hid,
                                         16 * MT);
          if (o >= 0) my[o] = bacc[i][j][e];
        }
    mma::named_sync<W * 32>();
    float* out = a.partials + static_cast<long long>(blockIdx.x) * n_out;
    const int bt = tid - NF * 32;
    for (int o = 1 + bt; o < 1 + hid * (in + 1); o += NB * 32) {
      float s = 0.f;
      for (int q = 0; q < NB; ++q) s += red_b[q * n_out + o];
      out[o] = s;
    }
    for (int q = bt; q < n_small; q += NB * 32) {
      float s = 0.f;
      for (int f = 0; f < NF; ++f) s += red_f[f * n_small + q];
      out[Head::small_index(q, in, hid)] = s;
    }
  }
}

// Past 16 n-tiles (128 hidden units) the kernel runs kGroups passes over
// its rows, pass q for the hidden units of n-tiles 16 q .. 16 q + 15: the
// head needs every unit before a row's chain, so each pass takes the whole
// forward, group by group (each group's share of the head summed on its
// own, the shares added in group order, so every pass sees the same v or
// z), its own group last, whose pre stays in registers for g_pre and the
// backward of its tiles.  Registers stay those of a 16-tile pass; the
// forward's products and the row reads are paid once a pass.
template <class Head, int KS>
__global__ void __launch_bounds__(TcShape<Head, KS>::kWarps * 32, 1)
    tc_grad_kernel(const GradArgs args) {
  using Sh = TcShape<Head, KS>;
  constexpr int NT = Sh::kNt, NTG = Sh::kNtg, G = Sh::kGroups;
  constexpr int W = Sh::kWarps, S = Sh::kShared ? W : 1;
  constexpr int MT = Sh::kMt, LDX = Sh::kLdx, LDG = Sh::kLdg;
  constexpr int WM = Sh::kWm, WN = Sh::kWn, MTW = Sh::kMtw, NTW = Sh::kNtw;
  constexpr int P = Head::kSums;
  extern __shared__ float4 smem4[];
  if constexpr (Sh::kPipelined) {
    tc_pipelined<Head, KS>(args, smem4);
    return;
  }
  float* smem = reinterpret_cast<float*>(smem4);
  const int in = args.in_size, hid = args.hidden;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // (KS, NT, 32) B fragments of [W1^T ; b1]: big b0, big b1, small b0,
  // small b1 a lane (or b0, b1 as floats, or as float64 with kFloat64),
  // then the head's weights, then the warps' regions, then (several passes)
  // the warps' small sums.
  float* s_par = smem + Sh::kFragFloats;
  float* s_warps = s_par + Head::kParamFloats;
  float* s_small = s_warps + W * Sh::kWarpFloats;
  float* mine = s_warps + warp * Sh::kWarpFloats;

  if constexpr (Sh::kBf16) {
    // B fragment (k16, nt) of W1^T for lane l: W1 (n, k), (n, k + 1) and
    // (n, k + 8), (n, k + 9), n = 8 nt + l / 4, k = 16 k16 + 2 (l % 4).
    for (int i = tid; i < MT * NT * 32; i += W * 32) {
      const int l = i & 31, nt = (i >> 5) % NT, k16 = (i >> 5) / NT;
      const int n = nt * 8 + (l >> 2), k = k16 * 16 + 2 * (l & 3);
      auto w = [&](int kk) {
        return n < hid && kk < in ? args.w1[n * in + kk] : 0.f;
      };
      reinterpret_cast<uint2*>(smem)[i] =
          make_uint2(mma::pack_bf16(w(k), w(k + 1)),
                     mma::pack_bf16(w(k + 8), w(k + 9)));
    }
    for (int j = tid; j < NT * 8; j += W * 32)
      smem[Sh::kB1Off + j] = j < hid ? args.b1[j] : 0.f;
  } else {
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
    if (Sh::kFloat64) {
      reinterpret_cast<double2*>(smem4)[i] = make_double2(b[0], b[1]);
    } else if (Sh::kPreSplit) {
      uint32_t big[2], small[2];
      mma::split(b, big, small);
      smem4[i] = make_float4(__uint_as_float(big[0]), __uint_as_float(big[1]),
                             __uint_as_float(small[0]),
                             __uint_as_float(small[1]));
    } else {
      reinterpret_cast<float2*>(smem)[i] = make_float2(b[0], b[1]);
    }
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

  // Backward accumulators of this warp's output tiles of a pass (m-tile
  // wm + WM i, n-tile wn + WN j of the pass's kNtg).
  float bacc[MTW][NTW][4];
  // bf16: this lane's db1 sums of the pass's columns lane, lane + 32, ...
  // (float32, unrounded; the ones row of the backward would sum the
  // rounded operand).
  constexpr int kDb1 = Sh::kBf16 ? (NTG * 8 + 31) / 32 : 1;
  float db1[kDb1];
  // db1's sums of the pass's columns into dst: at small index k, or at
  // their output index where `full`.
  auto store_db1 = [&](float* dst, bool full, int col0) {
#pragma unroll
    for (int i = 0; i < kDb1; ++i) {
      const int j = col0 + lane + 32 * i, k = Head::db1_small(hid) + j;
      if (lane + 32 * i < NTG * 8 && j < hid)
        dst[full ? Head::small_index(k, in, hid) : k] = db1[i];
    }
  };
  const int own = warp % S, wq0 = warp - own;  // the group's first warp
  const int wm = own / WN, wn = own % WN;
  const long long n = args.n_rows, n_chunks = (n + 15) / 16;
  const long long stride = static_cast<long long>(gridDim.x) * W;
  float* aux_own = mine + Sh::kOffAux;
  const int n_out = Head::n_out(in, hid);
  float* out = args.partials + static_cast<long long>(blockIdx.x) * n_out;

#pragma unroll 1
  for (int grp = 0; grp < G; ++grp) {
    const int col0 = G == 1 ? 0 : grp * 8 * NTG;  // its first hidden unit
    const bool first = G == 1 || grp == 0;
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) bacc[i][j][e] = 0.f;
    head.clear();
#pragma unroll
    for (int i = 0; i < kDb1; ++i) db1[i] = 0.f;

    // Each round the group of S warps takes S chunks, one a warp.
    long long base = static_cast<long long>(blockIdx.x) * W + wq0;
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

      // Forward: pre = [x | 1] [W1^T ; b1] over the warp's 16 rows, and
      // the lane's share p of the head's sums (the critic's in float64 with
      // kFloat64).
      auto forward = [&](float (&o)[NTG][4], const float* xr, const float4* s4,
                         int nt0, int ln) {
        if constexpr (Sh::kBf16)
          tc_forward_bf16<Sh, NTG, LDX>(o, xr, s4, nt0, ln);
        else
          tc_forward<Sh, KS, NTG, LDX>(o, xr, s4, nt0, ln);
      };
      using PT = typename std::conditional<Sh::kFloat64 && Head::kF64Sums,
                                           double, float>::type;
      float c[NTG][4];
      PT p[P];
#pragma unroll
      for (int i = 0; i < P; ++i) p[i] = 0.f;
      if constexpr (Sh::kFloat64) {
        tc_forward_f64<Sh, Head, KS, NTG, LDX>(
            c, p, x, reinterpret_cast<const double2*>(smem4), s_par, lane);
        if constexpr (!Head::kF64Sums) Head::sums(c, s_par, 0, t, p);
      } else if constexpr (G == 1) {
        forward(c, x, smem4, 0, lane);
        Head::sums(c, s_par, 0, t, p);
      } else {
        float pg[G][P];
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
#pragma unroll
          for (int i = 0; i < P; ++i) pg[gi][i] = 0.f;
          if (gi == grp) continue;
          float o[NTG][4];
          forward(o, x, smem4, gi * NTG, lane);
          Head::sums(o, s_par, gi * 8 * NTG, t, pg[gi]);
        }
        float po[P];
#pragma unroll
        for (int i = 0; i < P; ++i) po[i] = 0.f;
        forward(c, x, smem4, grp * NTG, lane);
        Head::sums(c, s_par, col0, t, po);
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
#pragma unroll
          for (int i = 0; i < P; ++i) p[i] = p[i] + (gi == grp ? po[i] : pg[gi][i]);
      }
      head.template rows<NTG, LDG>(c, p, s_par,
                                   aux_own + buf * 16 * Head::kAux,
                                   chunk * 16, n, g, t, col0, first,
                                   mine + Sh::kOffG, mine + Sh::kOffH,
                                   mine + Sh::kOffZ);
      group_sync<S>();
      if constexpr (Sh::kBf16) {
        // db1 += the chunk's float32 g_pre (critic) or g_h (actor): lane l
        // sums columns l, l + 32, ... of the warp's tile over its 16 rows.
        const float* sg = mine + Sh::kOffG;
#pragma unroll
        for (int i = 0; i < kDb1; ++i) {
          const int col = lane + 32 * i;
          if (col < NTG * 8) {
            float sum = 0.f;
#pragma unroll
            for (int r = 0; r < 16; ++r) sum += sg[r * LDG + col];
            db1[i] += sum;
          }
        }
      }

      // Backward over the group's S chunks, K = 16 rows each in two steps
      // of 8: [x | 1]^T g_pre, and g_z^T h for the actor.  bf16: one step
      // of 16, each operand rounded at its fragment load.  Each k-step's
      // product from zero, added to bacc by add_to.
#pragma unroll 1
      for (int q = 0; q < S; ++q) {
        const float* rq = s_warps + (wq0 + q) * Sh::kWarpFloats;
        const float* xq = rq + buf * 16 * LDX;
        if constexpr (Sh::kBf16) {
          uint32_t a[MTW][4];
#pragma unroll
          for (int i = 0; i < MTW; ++i) {
            const int mt = wm + WM * i;
            a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0u;
            if (mt < MT) {
              mma::load_a_cols_bf16(xq + mt * 16, LDX, lane, a[i]);
            } else if (Head::kThird && mt == MT && g < 4) {
              // g_z^T: row c < 4 of the m-tile, column a row of the chunk.
              const float* z = rq + Sh::kOffZ;
              a[i][0] = mma::pack_bf16(z[2 * t * 4 + g],
                                       z[(2 * t + 1) * 4 + g]);
              a[i][2] = mma::pack_bf16(z[(2 * t + 8) * 4 + g],
                                       z[(2 * t + 9) * 4 + g]);
            }
          }
#pragma unroll
          for (int j = 0; j < NTW; ++j) {
            const int nt = wn + WN * j;
            if (nt >= NTG) continue;
            uint32_t b[2];
            mma::load_b_rows_bf16(rq + Sh::kOffG + nt * 8, LDG, lane, b);
#pragma unroll
            for (int i = 0; i < MTW; ++i) {
              const int mt = wm + WM * i;
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              if (mt < MT) {
                mma::mma_bf16(d, a[i], b[0], b[1]);
              } else if (Head::kThird && mt == MT) {
                uint32_t hb[2];
                mma::load_b_rows_bf16(rq + Sh::kOffH + nt * 8, LDG, lane, hb);
                mma::mma_bf16(d, a[i], hb[0], hb[1]);
              } else {
                continue;
              }
              add_to(bacc[i][j], d);
            }
          }
        } else {
          // The A fragment of m-tile mt and k-step kr, split in TF32 halves.
          auto load_a = [&](int mt, int kr, uint32_t (&big)[4],
                            uint32_t (&small)[4]) {
            float a[4] = {0.f, 0.f, 0.f, 0.f};
            if (mt < MT) {
              mma::load_a_cols(xq + kr * 8 * LDX + mt * 16, LDX, lane, a);
            } else if (Head::kThird && mt == MT && g < 4) {
              // g_z^T: row c < 4 of the m-tile, column a row of the chunk.
              const float* z = rq + Sh::kOffZ + kr * 8 * 4;
              a[0] = z[t * 4 + g];
              a[2] = z[(t + 4) * 4 + g];
            }
            mma::split(a, big, small);
          };
          // The B fragment of n-tile nt and k-step kr: g_pre, or h for the
          // actor's m-tile MT (g_z^T h).
          auto load_b = [&](bool h, int nt, int kr, uint32_t (&big)[2],
                            uint32_t (&small)[2]) {
            float b[2];
            mma::load_b_rows(rq + (h ? Sh::kOffH : Sh::kOffG) + kr * 8 * LDG +
                                 nt * 8, LDG, lane, b);
            mma::split(b, big, small);
          };
          // bacc[i][j] += the k-step's product from zero; where the warps
          // share their rows, after the tile's previous add (0 times its
          // sum), so that a tile's k-steps stay in turn and their products
          // are not all in flight at once, 4 registers each.
          auto step = [&](int i, int j, const uint32_t (&ab)[4],
                          const uint32_t (&as)[4], const uint32_t (&bb)[2],
                          const uint32_t (&bs)[2]) {
            const float z = Sh::kShared ? bacc[i][j][0] * 0.f : 0.f;
            float d[4] = {z, z, z, z};
            mma::mma_3xtf32(d, ab, as, bb, bs);
            add_to(bacc[i][j], d);
          };
          // A k-step of 8 rows; where the warps share their rows, the two
          // as a loop, so that the second's loads wait for the first's
          // products (registers: unrolled, the widest instances spilled).
          auto kstep = [&](int kr) {
            uint32_t a_big[MTW][4], a_small[MTW][4];
#pragma unroll
            for (int i = 0; i < MTW; ++i)
              load_a(wm + WM * i, kr, a_big[i], a_small[i]);
#pragma unroll
            for (int j = 0; j < NTW; ++j) {
              const int nt = wn + WN * j;
              if (nt >= NTG) continue;
              uint32_t b_big[2], b_small[2];
              load_b(false, nt, kr, b_big, b_small);
#pragma unroll
              for (int i = 0; i < MTW; ++i) {
                const int mt = wm + WM * i;
                if (mt < MT) {
                  step(i, j, a_big[i], a_small[i], b_big, b_small);
                } else if (Head::kThird && mt == MT) {
                  uint32_t h_big[2], h_small[2];
                  load_b(true, nt, kr, h_big, h_small);
                  step(i, j, a_big[i], a_small[i], h_big, h_small);
                }
              }
            }
          };
          if constexpr (Sh::kShared) {
#pragma unroll 1
            for (int kr = 0; kr < 2; ++kr) kstep(kr);
          } else {
#pragma unroll
            for (int kr = 0; kr < 2; ++kr) kstep(kr);
          }
        }
      }
      group_sync<S>();  // the buffers are refilled next
    }
    mma::cp_async_wait<0>();
    __syncthreads();

    if constexpr (G > 1) {
      // The pass's tiles straight to the partial (each has one owner), its
      // small sums into the warp's row (the loss and the head's biases at
      // the last pass).
#pragma unroll
      for (int i = 0; i < MTW; ++i)
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int mt = wm + WM * i, nt = wn + WN * j;
            if (mt >= Sh::kMtAll || nt >= NTG) continue;
            const int o = Head::tile_index(
                mt * 16 + g + 8 * (e >> 1), col0 + nt * 8 + 2 * t + (e & 1),
                in, hid, 16 * MT);
            if (o >= 0) out[o] = bacc[i][j][e];
          }
      if constexpr (Sh::kBf16) store_db1(s_small + warp * Sh::kSmall, false,
                                         col0);
      head.store_small(s_small + warp * Sh::kSmall, false, in, hid, g, t,
                       lane, col0, grp == G - 1);
    }
  }

  if constexpr (G > 1) {
    __syncthreads();
    const int n_red = Head::n_small(hid);
    for (int k = tid; k < n_red; k += W * 32) {
      float s = 0.f;
      for (int w = 0; w < W; ++w) s += s_small[w * Sh::kSmall + k];
      out[Head::small_index(k, in, hid)] = s;
    }
  } else {
    // The block's partial.  Per-warp instances: each warp's sums into its
    // row of red (W, n_out), then the warps summed in order.  Shared rows:
    // each tile has one owner, which writes it straight to the partial; the
    // small sums go through red (W, n_small).  red reuses all of shared
    // memory.
    const int n_red = S == 1 ? n_out : Head::n_small(hid);
    float* red = smem;
    float* my_red = red + warp * n_red;
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int mt = wm + WM * i, nt = wn + WN * j;
          if (mt >= Sh::kMtAll || nt >= NTG) continue;
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
    if constexpr (Sh::kBf16) store_db1(my_red, S == 1, 0);
    __syncthreads();
    for (int k = tid; k < n_red; k += W * 32) {
      float s = 0.f;
      for (int w = 0; w < W; ++w) s += red[w * n_red + k];
      out[S == 1 ? k : Head::small_index(k, in, hid)] = s;
    }
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

// ----------------------------------------------------------------------
// The run-time-width route: every width past the tensor-core instances
// ----------------------------------------------------------------------
//
// Critic In > 103 or H > 256, un-collapsed actor F > 39 or H > 256, and in
// bf16 every width but the ten instances (critic_instance, actor_instance)
// take this route, which the wrappers pick by width before the launch.  Its
// widths are run-time values and its products run on the tensor cores as
// tc_grad_kernel's do (3xTF32 m16n8k8; bf16: one m16n8k16 on operands
// rounded where the plain versions round them, ops/update_math.py), but no
// width lives whole in shared memory: W1 streams through it a (hidden chunk
// x k-chunk) tile at a time.  Each k-step's products start from zero on the
// tensor core and are added to the running sums by the CUDA cores
// (add_to): the tensor core's own float32 accumulation, run over hundreds
// of k-steps, drifted from float64 past the plain version's error (5x on
// dW1 at In 1040); a k-step at a time it stays at or below it.  Three
// launches on the caller's stream:
//   rt_forward_kernel: a persistent grid over row tiles of kRtRows (128)
//     rows, 16 a warp.  For each hidden chunk of kRtHc (64) units in turn,
//     pre = x W1^T over the chunk with K at run time: stages of kRtKc (32)
//     columns of x and W1 on a ring of three, two in flight by cp.async
//     (zeros past the rows, the units and In), W1 split into its TF32
//     halves (or rounded to bf16) once a stage, in fragment order; then +
//     b1.  The chunk's share of the head input (v, or z's four values) is
//     summed by each lane over its units, reduced over the quad by shuffles
//     and added to the row's sum in chunk order.  Then each row's chain
//     (critic_row or ppo_row): its loss term and g (g_v, or g_z) into
//     rowbuf (N, 1 + kOut).
//   rt_backward_kernel: a grid of (row blocks B, hidden chunks, In chunks
//     of kRtIc (128) columns).  Block (b, c, i) takes the row tiles b, b + B,
//     ... and for each recomputes chunk c's pre-activations by the forward's
//     own stages (the same k order: the same bits, so the ReLU mask and h
//     are the forward's), applies the row chain from rowbuf (g_pre = (w2
//     g_v)(h > 0), or g_h = [Wmu; Wvar]^T g_z; split into its TF32 halves
//     once) and adds dW1^T of its In chunk += x^T g_pre on the tensor cores,
//     into accumulators that stay in registers across its rows; the In
//     chunk's columns of x are kept from the stages that pass them.  Blocks
//     of In chunk 0 also sum db1 (the float32 g_pre) and the head's products
//     (dW2 = g_v . h, or g_z^T h: one or four rows, a sixteenth or a quarter
//     of an m-tile, so on the CUDA cores), each lane over its own rows, in
//     registers; blocks (b, 0, 0) the loss and the head biases from rowbuf.
//     Each writes its part of row block b's partial (B, n_out).
//   reduce_partials_kernel: the row blocks' partials in order, in double.
// Where one block of the backward's grid holds all of H and In (H <= kRtHc
// and In <= kRtIc), its grid is (B, 1, 1) and a block holds a tile's whole
// pre at the tile's end, so for the critic two launches do, in one pass
// over x (marlnav_rt_one_pass): rt_forward_kernel<false, BF, true> is the
// backward with the forward's tile end (the head input, the row chain) run
// on that pre, each row's loss term and g kept in shared memory in place of
// rowbuf; then the reduction.  Every sum keeps the three launches' order:
// the same bits.
// The grids depend only on the row count, the widths and the card, and no
// sum takes an atomic, so two launches on the same inputs agree bit for bit.
// Shared memory is the same at every width; the widths end where the
// backward grid's y or z (65,535 chunks) or 32-bit output indices do.
// Work: 3 products of In x H a row (the forward, its recompute, dW1; in
// one pass 2, x read once), each three TF32 passes; past 128 columns each
// In chunk recomputes the forward once more.  On the H100 the route runs at
// 13-22% of the float32 CUDA-core bound and far below the tensor cores'
// (PERF.md row 3); timed variants point at the stage copies and the dW1
// product, not the tensor cores.
constexpr int kRtRows = 128;         // rows a tile: 16 a warp
constexpr int kRtHc = 64;            // hidden units a chunk
constexpr int kRtNt = kRtHc / 8;     // n-tiles a chunk
constexpr int kRtKc = 32;            // columns of x and W1 a stage
constexpr int kRtIc = 128;           // columns of dW1 a backward block
constexpr int kRtLdx = kRtKc + 4;    // = 4 mod 8: A loads free of conflicts
constexpr int kRtLdi = kRtIc + 4;    // the same for the In chunk's x
constexpr int kRtLdg = kRtHc + 8;    // = 8 mod 32: B loads free of conflicts
constexpr int kRtLdg2 = kRtHc + 4;   // float2s: 2 kRtLdg2 = 8 mod 32, the
                                     // same for the 64-bit loads
constexpr int kRtMaxChunks = 65535;  // a grid's y or z

// GradArgs (vec4 unused) and the route's own.
struct RtArgs : GradArgs {
  int copy;       // floats a stage copy: 4, 2 or 1 (rows of x and W1 on
                  // 16 or 8 bytes, else 4)
  float* rowbuf;  // (N, 1 + kOut): loss term, g (unused in one pass)
};

// A block's shared memory, in floats: kRing stages (x (kRtRows, kRtLdx),
// W1 (kRtHc, kRtLdx), and where the stage starts a chunk its b1 and head
// weights ((1 + kOut), kRtHc)), W1's fragments of a stage, the chunk's b1
// and head weights; the backward's also the In chunk's x (kRtRows,
// kRtLdi), g_pre (float32: its TF32 halves, (kRtRows, kRtLdg2) float2s;
// bf16: (kRtRows, kRtLdg) floats) and two tiles' rowbuf rows (kRtRows,
// kRow; in one pass the rows' own inputs, then their chains), the next
// one's copied while a tile runs.  The forward keeps two stages in flight
// (kRing 3); the backward and the one pass, whose tiles fill the rest, one
// (kRing 2).
template <bool kActor, int kRing>
struct RtShape {
  static constexpr int kOut = kActor ? 4 : 1;  // g_v, or g_z
  static constexpr int kRow = 1 + kOut;        // rowbuf floats a row
  static constexpr int kIn = kActor ? 4 : 2;   // a row's own inputs
  static constexpr int kParams = (kRtRows + kRtHc) * kRtLdx;  // in a stage
  static constexpr int kStage = kParams + (1 + kOut) * kRtHc;
  static constexpr int kFrag = kRing * kStage;  // (k-steps, n-tiles, 32)
  static constexpr int kB1 = kFrag + kRtKc / 8 * kRtNt * 32 * 4;
  static constexpr int kHead = kB1 + kRtHc;
  static constexpr int kForward = kHead + kOut * kRtHc;
  static constexpr int kXi = kForward;
  static constexpr int kG = kXi + kRtRows * kRtLdi;
  static constexpr int kRg = kG + kRtRows * kRtLdg2 * 2;
  static constexpr int kBackward = kRg + 2 * kRtRows * kRow;
  static_assert(kForward <= kSmemFloats / 2, "two forward blocks an SM");
  static_assert(kRing == 3 || kBackward <= kSmemFloats, "a backward fits");
  static_assert(kWarps * (1 + kOut) * kRtHc <= kRtRows * kRtLdi,
                "the column sums' reduction fits the In chunk's x");
};

// x rounded to bf16 where BF.
template <bool BF>
__device__ __forceinline__ float rt_r(float v) {
  return BF ? round_bf16(v) : v;
}

// Start the copies of a stage into xs, (kRtRows + kRtHc, kRtLdx): rows r0
// .. r0 + kRtRows - 1 of x, then units j0 .. j0 + kRtHc - 1 of W1, over
// columns k0 .. k0 + kRtKc - 1, E floats a copy; zeros past the rows, the
// units and In.  A thread keeps one column group and steps over the rows.
template <int E>
__device__ __forceinline__ void rt_fetch(const RtArgs& a, long long r0,
                                         int j0, int k0, float* xs,
                                         int tid) {
  constexpr int kPer = kRtKc / E;         // copies a row
  constexpr int kStep = kThreads / kPer;  // rows between a thread's copies
  const long long in = a.in_size;
  const int c = k0 + E * (tid % kPer), r = tid / kPer;
  const bool col = c < in;
  auto copy = [&](float* dst, const float* src, bool ok) {
    if (E == 4) mma::cp_async16_zfill(dst, ok ? src : a.obs, ok);
    else if (E == 2) mma::cp_async8_zfill(dst, ok ? src : a.obs, ok);
    else mma::cp_async4_zfill(dst, ok ? src : a.obs, ok);
  };
  float* dst = xs + r * kRtLdx + (c - k0);
  const float* x = a.obs + (r0 + r) * in + c;
#pragma unroll
  for (int i = 0; i < kRtRows / kStep; ++i)
    copy(dst + i * kStep * kRtLdx, x + i * kStep * in,
         col && r0 + r + i * kStep < a.n_rows);
  dst += kRtRows * kRtLdx;
  const float* w = a.w1 + (j0 + r) * in + c;
#pragma unroll
  for (int i = 0; i < kRtHc / kStep; ++i)
    copy(dst + i * kStep * kRtLdx, w + i * kStep * in,
         col && j0 + r + i * kStep < a.hidden);
}

__device__ __forceinline__ void rt_fetch(const RtArgs& a, long long r0,
                                         int j0, int k0, float* xs,
                                         int tid) {
  if (a.copy == 4)
    rt_fetch<4>(a, r0, j0, k0, xs, tid);
  else if (a.copy == 2)
    rt_fetch<2>(a, r0, j0, k0, xs, tid);
  else
    rt_fetch<1>(a, r0, j0, k0, xs, tid);
}

// Start the copies of hidden units j0 .. j0 + kRtHc - 1 of b1 and of the
// head's weights (w2, or Wmu's two rows and Wvar's) into dst ((1 + kOut),
// kRtHc); zeros past H.
template <int kOut>
__device__ __forceinline__ void rt_fetch_params(const RtArgs& a, int j0,
                                                float* dst, int tid) {
  const int hid = a.hidden;
  for (int i = tid; i < (1 + kOut) * kRtHc; i += kThreads) {
    const int o = i / kRtHc - 1, j = j0 + i % kRtHc;
    const float* src = o < 0    ? a.b1 + j
                       : o < 2 ? a.head[0] + o * hid + j
                               : a.head[2] + (o - 2) * hid + j;
    mma::cp_async4_zfill(dst + i, j < hid ? src : a.b1, j < hid);
  }
}

// Start the copies of rowbuf's rows r0 .. r0 + kRtRows - 1 into dst
// (kRtRows, kRow); zeros past n (their g is 0).
template <int kRow>
__device__ __forceinline__ void rt_fetch_rows(const RtArgs& a, long long r0,
                                              float* dst, int tid) {
  const long long end = a.n_rows * kRow;
  for (int i = tid; i < kRtRows * kRow; i += kThreads) {
    const long long at = r0 * kRow + i;
    mma::cp_async4_zfill(dst + i, at < end ? a.rowbuf + at : a.rowbuf,
                         at < end);
  }
}

// W1's stage (kRtHc, kRtLdx) into B fragments: float32, (k-step of 8,
// n-tile, lane) -> float4 (big b0, big b1, small b0, small b1); bf16,
// (k-step of 16, n-tile, lane) -> uint2 of packed pairs (mma_bf16.cuh).
template <bool BF>
__device__ __forceinline__ void rt_split(const float* ws, float4* frag,
                                         int tid) {
  if constexpr (BF) {
    for (int i = tid; i < kRtKc / 16 * kRtNt * 32; i += kThreads) {
      const int l = i & 31, nt = (i >> 5) % kRtNt, k16 = (i >> 5) / kRtNt;
      const float* w =
          ws + (nt * 8 + (l >> 2)) * kRtLdx + k16 * 16 + 2 * (l & 3);
      reinterpret_cast<uint2*>(frag)[i] =
          make_uint2(mma::pack_bf16(w[0], w[1]), mma::pack_bf16(w[8], w[9]));
    }
  } else {
    for (int i = tid; i < kRtKc / 8 * kRtNt * 32; i += kThreads) {
      const int l = i & 31, nt = (i >> 5) % kRtNt, ks = (i >> 5) / kRtNt;
      const float* w = ws + (nt * 8 + (l >> 2)) * kRtLdx + ks * 8 + (l & 3);
      const float b[2] = {w[0], w[4]};
      uint32_t big[2], small[2];
      mma::split(b, big, small);
      frag[i] = make_float4(__uint_as_float(big[0]), __uint_as_float(big[1]),
                            __uint_as_float(small[0]),
                            __uint_as_float(small[1]));
    }
  }
}

// c += x W1^T over one stage for a warp's 16 rows xw (row stride kRtLdx):
// `steps` k-steps of 8 (float32) or 16 (bf16, x rounded at its load).
template <bool BF>
__device__ __forceinline__ void rt_stage_mma(float (&c)[kRtNt][4],
                                             const float* xw,
                                             const float4* frag, int steps,
                                             int lane) {
  if constexpr (BF) {
    const uint2* f = reinterpret_cast<const uint2*>(frag);
#pragma unroll
    for (int k16 = 0; k16 < kRtKc / 16; ++k16) {
      if (k16 >= steps) break;
      uint32_t a[4];
      mma::load_a_rows_bf16(xw + k16 * 16, kRtLdx, lane, a);
#pragma unroll
      for (int nt = 0; nt < kRtNt; ++nt) {
        const uint2 w = f[(k16 * kRtNt + nt) * 32 + lane];
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma::mma_bf16(d, a, w.x, w.y);
        add_to(c[nt], d);
      }
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < kRtKc / 8; ++ks) {
      if (ks >= steps) break;
      float a[4];
      uint32_t a_big[4], a_small[4];
      mma::load_a_rows(xw + ks * 8, kRtLdx, lane, a);
      mma::split(a, a_big, a_small);
#pragma unroll
      for (int nt = 0; nt < kRtNt; ++nt) {
        const float4 w = frag[(ks * kRtNt + nt) * 32 + lane];
        const uint32_t b_big[2] = {__float_as_uint(w.x), __float_as_uint(w.y)};
        const uint32_t b_small[2] = {__float_as_uint(w.z),
                                     __float_as_uint(w.w)};
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma::mma_3xtf32(d, a_big, a_small, b_big, b_small);
        add_to(c[nt], d);
      }
    }
  }
}

// The stages of one block: tile i of its own (rows (first + i step)
// kRtRows ..) takes stages i per_tile .. i per_tile + per_tile - 1, stage w
// of a tile being hidden chunk c0 + w / n_k over k-chunk w % n_k.  Every
// stage runs the same steps on all threads:
//   wait for its copies; barrier; start the next stage's copies into the
//   other buffer; `prepare` (W1's split, and what else the stage's shared
//   memory needs); barrier; its products; `after` (a chunk's or a tile's
//   end).
struct RtStages {
  long long first, step, n_tiles;  // this block's tiles of the grid's
  int per_tile, n_k, c0;
  __device__ long long count() const {
    return first < n_tiles ? ((n_tiles - 1 - first) / step + 1) * per_tile
                           : 0;
  }
  __device__ void at(long long s, long long& r0, int& chunk, int& kq) const {
    const long long i = s / per_tile;
    const int w = static_cast<int>(s - i * per_tile);
    r0 = (first + i * step) * kRtRows;
    chunk = c0 + w / n_k;
    kq = w % n_k;
  }
};

// k-steps of stage k-chunk kq: of 8 columns (float32) or 16 (bf16), up to
// In.
template <bool BF>
__device__ __forceinline__ int rt_steps(int in, int kq) {
  constexpr int kStep = BF ? 16 : 8;
  const int left = (in - kq * kRtKc + kStep - 1) / kStep;
  return left < kRtKc / kStep ? left : kRtKc / kStep;
}

// The address of a row's own input c (critic: old value, return; actor:
// the action's two values, log-prob, advantage).
template <bool kActor>
__device__ __forceinline__ const float* rt_input(const RtArgs& a,
                                                 long long row, int c) {
  return !kActor ? a.row[c] + row
         : c < 2 ? a.row[0] + 2 * row + c
                 : a.row[c - 1] + row;
}

// Start the copies of rows r0 .. r0 + kRtRows - 1's own inputs into dst
// (kRtRows, kRow), kIn of each row's kRow floats; zeros past n.
template <bool kActor>
__device__ __forceinline__ void rt_fetch_inputs(const RtArgs& a,
                                                long long r0, float* dst,
                                                int tid) {
  using Sh = RtShape<kActor, 2>;
  for (int i = tid; i < kRtRows * Sh::kIn; i += kThreads) {
    const int c = i / kRtRows, r = i % kRtRows;
    const bool ok = r0 + r < a.n_rows;
    mma::cp_async4_zfill(dst + r * Sh::kRow + c,
                         ok ? rt_input<kActor>(a, r0 + r, c) : a.obs, ok);
  }
}

// A chunk's end: this lane's share of the head input over its units
// (critic: w2 . relu(pre); actor: [Wmu; Wvar] pre, with pre = c + b1),
// summed over the quad: p[2 o + h], output o of row g + 8 h.
template <bool kActor, bool BF>
__device__ __forceinline__ void rt_head_sums(const float (&c)[kRtNt][4],
                                             const float* s_b1,
                                             const float* s_head, int t,
                                             float* p) {
  constexpr int kOut = RtShape<kActor, 2>::kOut;
#pragma unroll
  for (int i = 0; i < 2 * kOut; ++i) p[i] = 0.f;
#pragma unroll
  for (int nt = 0; nt < kRtNt; ++nt) {
    const int j = nt * 8 + 2 * t;
    const float2 b = *reinterpret_cast<const float2*>(s_b1 + j);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = c[nt][2 * h] + b.x, v1 = c[nt][2 * h + 1] + b.y;
      if (!kActor) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        const float2 w =
            *reinterpret_cast<const float2*>(s_head + o * kRtHc + j);
        p[2 * o + h] = p[2 * o + h] + w.x * rt_r<BF>(v0);
        p[2 * o + h] = p[2 * o + h] + w.y * rt_r<BF>(v1);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2 * kOut; ++i) {
    p[i] = p[i] + __shfl_xor_sync(0xffffffffu, p[i], 1);
    p[i] = p[i] + __shfl_xor_sync(0xffffffffu, p[i], 2);
  }
}

// The row chain (critic_row or ppo_row) of row g + 8 t (lanes t = 0, 1 of
// a quad) from the head input's row sums tot and the row's own inputs `in`:
// its loss term, then g (g_v, or g_z), into out (kRow floats; it may be
// `in`).
template <bool kActor>
__device__ __forceinline__ void rt_row(const RtArgs& a, const float* tot,
                                       int t, const float* in, float* out) {
  if constexpr (kActor) {
    float z[4], gz[4];
#pragma unroll
    for (int o = 0; o < 4; ++o)
      z[o] = (t ? tot[2 * o + 1] : tot[2 * o]) +
             (o < 2 ? a.head[1][o] : a.head[3][o - 2]);
    const float loss =
        ppo_row(z, make_float2(in[0], in[1]), in[2], in[3], a.k, gz);
    out[0] = loss;
#pragma unroll
    for (int o = 0; o < 4; ++o) out[1 + o] = gz[o];
  } else {
    float loss;
    const float gv = critic_row((t ? tot[1] : tot[0]) + a.head[1][0], in[0],
                                in[1], a.eps, &loss);
    out[0] = loss;
    out[1] = gv;
  }
}

// The forward of the three launches (see above): each row's loss term and
// g into rowbuf.
template <bool kActor, bool BF>
__device__ __forceinline__ void rt_forward_pass(const RtArgs& a) {
  using Sh = RtShape<kActor, 3>;
  constexpr int kOut = Sh::kOut, kRow = Sh::kRow;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float4* frag = reinterpret_cast<float4*>(smem + Sh::kFrag);
  float* s_b1 = smem + Sh::kB1;
  float* s_head = smem + Sh::kHead;  // (kOut, kRtHc), rounded where BF
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int in = a.in_size, hid = a.hidden;
  const int n_k = (in + kRtKc - 1) / kRtKc;
  const int n_chunks = (hid + kRtHc - 1) / kRtHc;
  const RtStages st{blockIdx.x, gridDim.x,
                    (a.n_rows + kRtRows - 1) / kRtRows, n_chunks * n_k, n_k,
                    0};
  const long long n_stages = st.count();
  auto fetch = [&](long long s) {
    long long r0;
    int chunk, kq;
    st.at(s, r0, chunk, kq);
    float* xs = smem + (s % 3) * Sh::kStage;
    rt_fetch(a, r0, chunk * kRtHc, kq * kRtKc, xs, tid);
    if (kq == 0) rt_fetch_params<kOut>(a, chunk * kRtHc, xs + Sh::kParams, tid);
  };
  for (int s = 0; s < 2; ++s) {
    if (s < n_stages) fetch(s);
    mma::cp_async_commit();
  }
  float c[kRtNt][4];
  float tot[2 * kOut];  // the row sums of the head input: rows g, g + 8
  for (long long s = 0; s < n_stages; ++s) {
    mma::cp_async_wait<1>();
    __syncthreads();
    if (s + 2 < n_stages) fetch(s + 2);
    mma::cp_async_commit();
    long long r0;
    int chunk, kq;
    st.at(s, r0, chunk, kq);
    const float* xs = smem + (s % 3) * Sh::kStage;
    rt_split<BF>(xs + kRtRows * kRtLdx, frag, tid);
    if (kq == 0)  // the chunk's b1 and head weights, the latter rounded
      for (int i = tid; i < (1 + kOut) * kRtHc; i += kThreads) {
        const float v = xs[Sh::kParams + i];
        s_b1[i] = i < kRtHc ? v : rt_r<BF>(v);  // s_head follows s_b1
      }
    __syncthreads();
    if (kq == 0) {
#pragma unroll
      for (int nt = 0; nt < kRtNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
      if (chunk == 0)
#pragma unroll
        for (int i = 0; i < 2 * kOut; ++i) tot[i] = 0.f;
    }
    rt_stage_mma<BF>(c, xs + warp * 16 * kRtLdx, frag, rt_steps<BF>(in, kq),
                     lane);
    if (kq != n_k - 1) continue;
    // The chunk's end: its share of the head input, added to the row sums
    // in chunk order.
    float p[2 * kOut];
    rt_head_sums<kActor, BF>(c, s_b1, s_head, t, p);
#pragma unroll
    for (int i = 0; i < 2 * kOut; ++i) tot[i] = tot[i] + p[i];
    if (chunk != n_chunks - 1) continue;
    // The tile's end: lanes t = 0, 1 of each quad take rows g and g + 8.
    const long long row = r0 + warp * 16 + g + 8 * t;
    if (t < 2 && row < a.n_rows) {
      float ins[Sh::kIn];
#pragma unroll
      for (int i = 0; i < Sh::kIn; ++i) ins[i] = *rt_input<kActor>(a, row, i);
      rt_row<kActor>(a, tot, t, ins, a.rowbuf + row * kRow);
    }
  }
  mma::cp_async_wait<0>();
}

// The backward of the three launches, or with kOnePass the whole gradient
// where one block holds all of H and In (grid (B, 1, 1)): the forward's
// tile end on the pre-activations the backward has recomputed, each row's
// chain in shared memory (in place of its inputs, fetched with the tile's
// first stage), then the backward's own tile end.  The same operations in
// the same order as the forward's and the backward's, so both modes give
// the same bits.
template <bool kActor, bool BF, bool kOnePass>
__device__ __forceinline__ void rt_grad_pass(const RtArgs& a) {
  using Sh = RtShape<kActor, 2>;
  constexpr int kOut = Sh::kOut, kRow = Sh::kRow;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float4* frag = reinterpret_cast<float4*>(smem + Sh::kFrag);
  const float* s_b1 = smem + Sh::kB1;
  const float* s_head = smem + Sh::kHead;
  float* xi = smem + Sh::kXi;  // (kRtRows, kRtLdi): the In chunk's x
  float* gs = smem + Sh::kG;   // g_pre, or g_h: float2 halves, or bf16's
  float* rg = smem + Sh::kRg;  // (2, kRtRows, kRow): tiles' rowbuf rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int in = a.in_size, hid = a.hidden;
  const int j0 = blockIdx.y * kRtHc, i0 = blockIdx.z * kRtIc;
  const int n_k = (in + kRtKc - 1) / kRtKc;
  const RtStages st{blockIdx.x, gridDim.x,
                    (a.n_rows + kRtRows - 1) / kRtRows, n_k, n_k,
                    static_cast<int>(blockIdx.y)};
  const long long n_stages = st.count();
  // dW1^T of the In chunk (its m-tiles, 16 columns each) by the chunk's 8
  // n-tiles: warps share an m-tile where there are fewer than 8 (wn warps
  // each, n-tiles wn0, wn0 + wn, ...), so that a narrow In keeps every
  // warp busy.
  const int span = in - i0 < kRtIc ? in - i0 : kRtIc;
  const int mts = (span + 15) / 16;
  const int wn = mts > 4 ? 1 : mts > 2 ? 2 : mts > 1 ? 4 : 8;
  const int mt = warp / wn, wn0 = warp % wn, nj = kRtNt / wn;
  const bool dw1 = mt < mts;
  float acc[kRtNt][4];
#pragma unroll
  for (int j = 0; j < kRtNt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // In chunk 0: this lane's sums of its units' columns (8 nt + 2t + e)
  // over its rows of each tile (g, then g + 8): db1, then the head's (dW2,
  // or dWmu and dWvar).  Blocks (b, 0, 0), warp 0: lane l's sums of
  // rowbuf's columns (loss, then g) over rows l, l + 32, ... of each tile.
  const bool sums = blockIdx.z == 0;
  const bool small = sums && blockIdx.y == 0 && warp == 0;
  float csum[1 + kOut][kRtNt][2], ssum[kRow];
#pragma unroll
  for (int o = 0; o <= kOut; ++o)
#pragma unroll
    for (int nt = 0; nt < kRtNt; ++nt) csum[o][nt][0] = csum[o][nt][1] = 0.f;
#pragma unroll
  for (int o = 0; o < kRow; ++o) ssum[o] = 0.f;
  // The chunk's b1 and head weights, once: the first barrier below shows
  // them.
  for (int i = tid; i < (1 + kOut) * kRtHc; i += kThreads) {
    const int o = i / kRtHc - 1, j = j0 + i % kRtHc;
    float v = 0.f;
    if (j < hid)
      v = o < 0 ? a.b1[j]
          : !kActor ? rt_r<BF>(a.head[0][j])
          : o < 2   ? rt_r<BF>(a.head[0][o * hid + j])
                    : rt_r<BF>(a.head[2][(o - 2) * hid + j]);
    smem[Sh::kB1 + i] = v;
  }
  auto fetch = [&](long long s) {
    long long r0;
    int chunk, kq;
    st.at(s, r0, chunk, kq);
    float* xs = smem + (s & 1) * Sh::kStage;
    rt_fetch(a, r0, j0, kq * kRtKc, xs, tid);
    if (kq == 0) {  // the tile's rowbuf rows, or inputs, into its half of rg
      float* rows = rg + (s / n_k & 1) * kRtRows * kRow;
      if constexpr (kOnePass)
        rt_fetch_inputs<kActor>(a, r0, rows, tid);
      else
        rt_fetch_rows<kRow>(a, r0, rows, tid);
    }
  };
  if (n_stages > 0) fetch(0);
  mma::cp_async_commit();
  float c[kRtNt][4];
  for (long long s = 0; s < n_stages; ++s) {
    mma::cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < n_stages) fetch(s + 1);
    mma::cp_async_commit();
    long long r0;
    int chunk, kq;
    st.at(s, r0, chunk, kq);
    const float* xs = smem + (s & 1) * Sh::kStage;
    rt_split<BF>(xs + kRtRows * kRtLdx, frag, tid);
    const int x0 = kq * kRtKc - i0;  // the stage's columns in the In chunk
    if (x0 >= 0 && x0 < kRtIc)
      for (int u = tid; u < kRtRows * kRtKc / 4; u += kThreads) {
        const int r = u / (kRtKc / 4), q = 4 * (u % (kRtKc / 4));
        *reinterpret_cast<float4*>(xi + r * kRtLdi + x0 + q) =
            *reinterpret_cast<const float4*>(xs + r * kRtLdx + q);
      }
    __syncthreads();
    if (kq == 0)
#pragma unroll
      for (int nt = 0; nt < kRtNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
    rt_stage_mma<BF>(c, xs + warp * 16 * kRtLdx, frag, rt_steps<BF>(in, kq),
                     lane);
    if (kq != n_k - 1) continue;
    float* rgt = rg + (s / n_k & 1) * kRtRows * kRow;
    if constexpr (kOnePass) {
      // The forward's tile end: the head input's row sums (its one chunk
      // added to zero, as the forward adds it), then lanes t = 0, 1 of each
      // quad take rows g and g + 8 through the row chain, over the rows'
      // inputs in rgt (zeros past n, as rowbuf's copies read there).  A
      // warp's rows are its own.
      float p[2 * kOut], tot[2 * kOut];
      rt_head_sums<kActor, BF>(c, s_b1, s_head, t, p);
#pragma unroll
      for (int i = 0; i < 2 * kOut; ++i) tot[i] = 0.f + p[i];
      if (t < 2) {
        const int r = warp * 16 + g + 8 * t;
        float* row = rgt + r * kRow;
        if (r0 + r < a.n_rows)
          rt_row<kActor>(a, tot, t, row, row);
        else
#pragma unroll
          for (int o = 0; o < kRow; ++o) row[o] = 0.f;
      }
      __syncwarp();
    }
    // The tile's end.  g_pre (critic: (w2 g_v)(h > 0), with h = relu(pre))
    // or g_h (actor: [Wmu; Wvar]^T g_z, with h = pre) into gs (float32:
    // split into its TF32 halves once, here), and the column sums.
#pragma unroll
    for (int nt = 0; nt < kRtNt; ++nt) {
      const int j = nt * 8 + 2 * t;
      const float2 b = *reinterpret_cast<const float2*>(s_b1 + j);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        const float* gr = rgt + r * kRow + 1;
        float hv[2] = {c[nt][2 * h] + b.x, c[nt][2 * h + 1] + b.y};
        float gp[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (kActor) {
            const float* w = s_head + j + e;
            gp[e] = ((w[0] * rt_r<BF>(gr[0]) + w[kRtHc] * rt_r<BF>(gr[1])) +
                     w[2 * kRtHc] * rt_r<BF>(gr[2])) +
                    w[3 * kRtHc] * rt_r<BF>(gr[3]);
          } else {
            hv[e] = fmaxf(hv[e], 0.f);
            gp[e] = (s_head[j + e] * rt_r<BF>(gr[0])) * flag(hv[e] > 0.f);
          }
          if (sums) {
            csum[0][nt][e] = csum[0][nt][e] + gp[e];
#pragma unroll
            for (int o = 0; o < kOut; ++o)
              csum[1 + o][nt][e] =
                  csum[1 + o][nt][e] + rt_r<BF>(gr[o]) * rt_r<BF>(hv[e]);
          }
        }
        if constexpr (BF) {
          *reinterpret_cast<float2*>(gs + r * kRtLdg + j) =
              make_float2(gp[0], gp[1]);
        } else {
          uint32_t big[2], small_[2];
          mma::split(gp, big, small_);
          *reinterpret_cast<float4*>(gs + 2 * (r * kRtLdg2 + j)) =
              make_float4(__uint_as_float(big[0]), __uint_as_float(small_[0]),
                          __uint_as_float(big[1]),
                          __uint_as_float(small_[1]));
        }
      }
    }
    __syncthreads();
    // dW1^T += x^T g_pre over the tile's rows (K = kRtRows).
    if (dw1) {
      const float* xa = xi + mt * 16;
      if constexpr (BF) {
#pragma unroll 2
        for (int k16 = 0; k16 < kRtRows / 16; ++k16) {
          uint32_t af[4];
          mma::load_a_cols_bf16(xa + k16 * 16 * kRtLdi, kRtLdi, lane, af);
#pragma unroll
          for (int jn = 0; jn < kRtNt; ++jn) {
            if (jn >= nj) break;
            uint32_t bf[2];
            mma::load_b_rows_bf16(gs + k16 * 16 * kRtLdg + (wn0 + wn * jn) * 8,
                                  kRtLdg, lane, bf);
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma::mma_bf16(d, af, bf[0], bf[1]);
            add_to(acc[jn], d);
          }
        }
      } else {
        const float2* g2 = reinterpret_cast<const float2*>(gs);
#pragma unroll 2
        for (int k8 = 0; k8 < kRtRows / 8; ++k8) {
          float af[4];
          uint32_t a_big[4], a_small[4];
          mma::load_a_cols(xa + k8 * 8 * kRtLdi, kRtLdi, lane, af);
          mma::split(af, a_big, a_small);
#pragma unroll
          for (int jn = 0; jn < kRtNt; ++jn) {
            if (jn >= nj) break;
            // B (row k8 8 + t (+ 4), unit n-tile 8 + g): its halves.
            const float2* b = g2 + (k8 * 8 + t) * kRtLdg2 +
                              (wn0 + wn * jn) * 8 + g;
            const float2 b0 = b[0], b1 = b[4 * kRtLdg2];
            const uint32_t b_big[2] = {__float_as_uint(b0.x),
                                       __float_as_uint(b1.x)};
            const uint32_t b_small[2] = {__float_as_uint(b0.y),
                                         __float_as_uint(b1.y)};
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma::mma_3xtf32(d, a_big, a_small, b_big, b_small);
            add_to(acc[jn], d);
          }
        }
      }
    }
    if (small)
#pragma unroll
      for (int i = 0; i < kRtRows / 32; ++i)
#pragma unroll
        for (int o = 0; o < kRow; ++o)
          ssum[o] = ssum[o] + rgt[(lane + 32 * i) * kRow + o];
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // every warp is done with xi, which red reuses

  // This block's part of row block b's partial, at the outputs' indices.
  const int n_out =
      kActor ? 1 + hid * in + 5 * hid + 4 : 1 + hid * in + 2 * hid + 1;
  float* out = a.partials + static_cast<long long>(blockIdx.x) * n_out;
  const int o_b1 = 1 + hid * in, o_head = o_b1 + hid;
  if (dw1)
#pragma unroll
    for (int jn = 0; jn < kRtNt; ++jn) {
      if (jn >= nj) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = i0 + mt * 16 + g + 8 * (e >> 1);
        const int j = j0 + (wn0 + wn * jn) * 8 + 2 * t + (e & 1);
        if (m < in && j < hid) out[1 + j * in + m] = acc[jn][e];
      }
    }
  if (sums) {  // the lanes' sums over g by shuffles, then warps in order
    float* red = xi;  // (kWarps, 1 + kOut, kRtHc)
#pragma unroll
    for (int o = 0; o <= kOut; ++o)
#pragma unroll
      for (int nt = 0; nt < kRtNt; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = csum[o][nt][e];
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            v = v + __shfl_xor_sync(0xffffffffu, v, off);
          if (g == 0)
            red[(warp * (1 + kOut) + o) * kRtHc + nt * 8 + 2 * t + e] = v;
        }
    __syncthreads();
    for (int i = tid; i < (1 + kOut) * kRtHc; i += kThreads) {
      const int o = i / kRtHc, j = j0 + i % kRtHc;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v = v + red[w * (1 + kOut) * kRtHc + i];
      if (j >= hid) continue;
      const int c = o - 1;
      out[o == 0      ? o_b1 + j
          : !kActor   ? o_head + j
          : c < 2     ? o_head + c * hid + j
                      : o_head + 2 * hid + 2 + (c - 2) * hid + j] = v;
    }
  }
  if (small) {  // column 0 the loss; then db2, or dbmu and dbvar
#pragma unroll
    for (int o = 0; o < kRow; ++o) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ssum[o] = ssum[o] + __shfl_xor_sync(0xffffffffu, ssum[o], off);
      const int c = o - 1;
      if (lane == 0)
        out[o == 0      ? 0
            : !kActor   ? o_head + hid
            : c < 2     ? o_head + 2 * hid + c
                        : o_head + 4 * hid + 2 + (c - 2)] = ssum[o];
    }
  }
}

// kOnePass: the whole gradient in one launch (rt_grad_pass), on the
// backward's grid and shared memory.  Either mode launches this kernel once
// a gradient (the benchmark's critic_rt_grad_roofline_pct counts by it).
template <bool kActor, bool BF, bool kOnePass>
__global__ void __launch_bounds__(kThreads, kOnePass ? 1 : 2)
    rt_forward_kernel(const RtArgs a) {
  if constexpr (kOnePass)
    rt_grad_pass<kActor, BF, true>(a);
  else
    rt_forward_pass<kActor, BF>(a);
}

template <bool kActor, bool BF>
__global__ void __launch_bounds__(kThreads, 1)
    rt_backward_kernel(const RtArgs a) {
  rt_grad_pass<kActor, BF, false>(a);
}

template <bool kActor, bool BF>
cudaError_t launch_rt(const RtArgs& args, bool one_pass, int sms,
                      int blocks, int n_out, float* out, cudaStream_t s) {
  const int fwd = 4 * RtShape<kActor, 3>::kForward;
  const int bwd = 4 * RtShape<kActor, 2>::kBackward;
  if constexpr (!kActor) {  // the critic's alone: marlnav_rt_one_pass
    if (one_pass) {
      cudaError_t err = cudaFuncSetAttribute(
          rt_forward_kernel<kActor, BF, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, bwd);
      if (err != cudaSuccess) return err;
      rt_forward_kernel<kActor, BF, true><<<blocks, kThreads, bwd, s>>>(args);
      return reduce(args.partials, blocks, n_out, out, s);
    }
  }
  cudaError_t err = cudaFuncSetAttribute(
      rt_forward_kernel<kActor, BF, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, fwd);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rt_backward_kernel<kActor, BF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bwd);
  if (err != cudaSuccess) return err;
  const long long tiles = (args.n_rows + kRtRows - 1) / kRtRows;
  const int forward_blocks =
      static_cast<int>(tiles < 2LL * sms ? tiles : 2LL * sms);
  rt_forward_kernel<kActor, BF, false>
      <<<forward_blocks, kThreads, fwd, s>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks, (args.hidden + kRtHc - 1) / kRtHc,
                  (args.in_size + kRtIc - 1) / kRtIc);
  rt_backward_kernel<kActor, BF><<<grid, kThreads, bwd, s>>>(args);
  return reduce(args.partials, blocks, n_out, out, s);
}

template <class Head, int KS>
cudaError_t launch_tc(const GradArgs& args, int blocks, cudaStream_t s) {
  using Sh = TcShape<Head, KS>;
  constexpr int W = Sh::kWarps;
  const int n_red = Sh::kShared ? Head::n_small(args.hidden)
                                : Head::n_out(args.in_size, args.hidden);
  const int floats = Sh::kPipelined || Sh::kMainFloats > W * n_red
                         ? Sh::kMainFloats
                         : W * n_red;
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
         : n <= 16                   ? 16
                                     : 32;
}

// The instance of Head for (KS, NT): the chunks of 16 rows a block takes a
// round (its warps, or the pipelined body's forward warps; 0 where none is
// built; one block an SM, every instance taking up to the full register
// file a thread); with args, it is also launched, its error in *err; with
// pipelined, whether it takes the warp-specialised body (tc_pipelined).
#define MARLNAV_TC(HEAD, KS_, NT_)                                   \
  if (ks == KS_ && nt == NT_) {                                      \
    if (args) *err = launch_tc<HEAD<NT_>, KS_>(*args, blocks, s);    \
    if (pipelined) *pipelined = TcShape<HEAD<NT_>, KS_>::kPipelined; \
    return TcShape<HEAD<NT_>, KS_>::kRoundChunks;                    \
  }
#define MARLNAV_TC_NT(HEAD, KS_)                                       \
  MARLNAV_TC(HEAD, KS_, 4) MARLNAV_TC(HEAD, KS_, 7)                    \
  MARLNAV_TC(HEAD, KS_, 8) MARLNAV_TC(HEAD, KS_, 16)                  \
  MARLNAV_TC(HEAD, KS_, 32)

// bf16 (--bf16-updates) instances: the widths training reaches, the
// default (critic In 36, actor F 12; hidden 50), -no 8 (In 66, F 22), -no
// 14 (In 102, F 34), -hs 128 and -hs 256; past them a bf16 launch raises
// (In 102 with hidden 256, whose bf16 instance spilled, among them).
inline int critic_instance(int in, int hid, bool bf16,
                           const GradArgs* args = nullptr, int blocks = 0,
                           cudaStream_t s = nullptr,
                           cudaError_t* err = nullptr,
                           bool* pipelined = nullptr) {
  const int ks = critic_ks(in), nt = hidden_nt(hid);
  if (bf16) {
    MARLNAV_TC(CriticHeadBf16, 5, 7) MARLNAV_TC(CriticHeadBf16, 9, 7)
    MARLNAV_TC(CriticHeadBf16, 13, 7) MARLNAV_TC(CriticHeadBf16, 5, 16)
    MARLNAV_TC(CriticHeadBf16, 5, 32)
    return 0;
  }
  MARLNAV_TC_NT(CriticHead, 3)
  MARLNAV_TC_NT(CriticHead, 5)
  MARLNAV_TC_NT(CriticHead, 9)
  MARLNAV_TC_NT(CriticHead, 13)
  return 0;
}

inline int actor_instance(int f, int hid, bool bf16,
                          const GradArgs* args = nullptr, int blocks = 0,
                          cudaStream_t s = nullptr,
                          cudaError_t* err = nullptr,
                          bool* pipelined = nullptr) {
  const int ks = actor_ks(f), nt = hidden_nt(hid);
  if (bf16) {
    MARLNAV_TC(ActorHeadBf16, 2, 7) MARLNAV_TC(ActorHeadBf16, 3, 7)
    MARLNAV_TC(ActorHeadBf16, 5, 7) MARLNAV_TC(ActorHeadBf16, 2, 16)
    MARLNAV_TC(ActorHeadBf16, 2, 32)
    return 0;
  }
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

// The affine actor kernel of a rounding mode (nullptr outside them).
inline const void* actor_kernel(int mode) {
  return mode == kF32      ? reinterpret_cast<const void*>(
                                 actor_grad_kernel<kF32>)
         : mode == kTiled  ? reinterpret_cast<const void*>(
                                 actor_grad_kernel<kTiled>)
         : mode == kStaged ? reinterpret_cast<const void*>(
                                 actor_grad_kernel<kStaged>)
                           : nullptr;
}

// Let the affine actor's blocks (each mode's) take the shared memory of a
// tile at obs width f on `device`, the current device: at least that of
// the widest narrow tile (F 255 at 32 rows), raised where a wider width
// needs more; once a device and size.
inline cudaError_t actor_allow_smem(int device, int f) {
  static int allowed[64] = {};
  const bool known = device >= 0 && device < 64;
  const int narrow = 4 * actor_smem_floats(kActorNarrowObs, 32);
  const int need = 4 * actor_smem_floats(f, actor_tile_rows(f));
  const int bytes = need > narrow ? need : narrow;
  if (known && allowed[device] >= bytes) return cudaSuccess;
  cudaError_t err = cudaSuccess;
  for (int mode = kF32; mode <= kStaged && err == cudaSuccess; ++mode)
    err = cudaFuncSetAttribute(actor_kernel(mode),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (known && err == cudaSuccess) allowed[device] = bytes;
  return err;
}

}  // namespace update
}  // namespace marlnav

extern "C" {

int marlnav_actor_max_obs() { return marlnav::update::kActorMaxObs; }
int marlnav_actor_tile_rows(int obs_size) {
  return marlnav::update::actor_tile_rows(obs_size);
}
// Blocks of the affine actor kernel of rounding `mode` (ActorMode)
// resident on the card at once (the most its grid takes) at this obs
// width: 0 outside the widths and modes it takes, -1 on a CUDA error.
int marlnav_actor_resident_blocks(int obs_size, int device, int mode) {
  using namespace marlnav::update;
  const int rows = actor_tile_rows(obs_size);
  if (!rows || !actor_kernel(mode)) return 0;
  int per_sm = 0, sms = 0;
  if (cudaSetDevice(device) != cudaSuccess ||
      actor_allow_smem(device, obs_size) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, actor_kernel(mode), kThreads,
          4 * actor_smem_floats(obs_size, rows)) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return -1;
  return per_sm * sms;
}
int marlnav_critic_max_in() { return marlnav::update::kCriticMaxIn; }
int marlnav_uncollapsed_max_obs() {
  return marlnav::update::kUncollapsedMaxObs;
}
int marlnav_max_hidden() { return marlnav::update::kMaxHidden; }

// Chunks of 16 rows a block of the tensor-core kernel's instance for these
// widths (its bf16 one where bf16 != 0) takes a round: its warps, each on
// a chunk at a time, or the pipelined body's forward warps (0 outside the
// instances built); one block an SM sizes the persistent grid.
int marlnav_critic_warps(int in_size, int hidden, int bf16) {
  return marlnav::update::critic_instance(in_size, hidden, bf16 != 0);
}
// 1 where that instance takes the warp-specialised body (tc_pipelined).
int marlnav_critic_pipelined(int in_size, int hidden, int bf16) {
  bool pipelined = false;
  marlnav::update::critic_instance(in_size, hidden, bf16 != 0, nullptr, 0,
                                   nullptr, nullptr, &pipelined);
  return pipelined ? 1 : 0;
}
int marlnav_uncollapsed_warps(int obs_size, int hidden, int bf16) {
  return marlnav::update::actor_instance(obs_size, hidden, bf16 != 0);
}

// The row blocks of the run-time route's backward grid (the rows of its
// partials) for n_rows rows at these widths on a card of `sms` SMs: one
// wave of blocks (one an SM) over the grid's hidden and In chunks, at least
// one, at most a tile of rows each; 0 where the widths pass the grid's
// 65,535 chunks or a 32-bit output index.
int marlnav_rt_row_blocks(long long n_rows, int in_size, int hidden,
                          int sms) {
  using namespace marlnav::update;
  const long long chunks = (hidden + kRtHc - 1) / kRtHc;
  const long long in_chunks = (in_size + kRtIc - 1) / kRtIc;
  if (n_rows < 1 || in_size < 1 || hidden < 1 || sms < 1 ||
      chunks > kRtMaxChunks || in_chunks > kRtMaxChunks ||
      static_cast<long long>(hidden) * (in_size + 5) + 4 > 0x7fffffffLL)
    return 0;
  const long long tiles = (n_rows + kRtRows - 1) / kRtRows;
  long long blocks = sms / (chunks * in_chunks);
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks < tiles ? blocks : tiles);
}

// 1 where the run-time route of the critic (actor == 0) or the
// un-collapsed actor takes one pass over x (two launches: one block of its
// backward's grid holds all of H and In), 0 where it takes three.  The
// actor always takes three: its float32 one-pass instance, whose chain
// (ppo_row) runs beside the five column sums' registers, took all 255
// registers and spilled.
int marlnav_rt_one_pass(int actor, int in_size, int hidden) {
  using namespace marlnav::update;
  return !actor && in_size >= 1 && hidden >= 1 && in_size <= kRtIc &&
         hidden <= kRtHc;
}

// Each launches on `stream` (a cudaStream_t from
// torch.cuda.current_stream()) and returns cudaGetLastError(): 0 when its
// launches were accepted.

// The affine actor of rounding `mode` (ActorMode) on at most `capacity`
// blocks (its resident blocks) and at most a block a tile; partials
// (capacity, 4F + 5).  out: loss_sum, dz
// (4, F), dzs (4), summed by the kernel's last block.  done: one word of
// the caller's, zeroed here on `stream` before the launch, where the
// blocks count themselves done: the launch owns it, so launches on other
// streams, or one cut short, cannot mix their counts.
int marlnav_actor_grad_sums(const float* obs, const float* act,
                            const float* lp, const float* adv,
                            const float* a_comp, const float* c_comp,
                            long long n_rows, int obs_size, float lo,
                            float hi, float ent_c, float ent_half,
                            int mode, int capacity, float* partials,
                            float* out, unsigned int* done, int device,
                            void* stream) {
  using namespace marlnav::update;
  const int rows = actor_tile_rows(obs_size);
  if (!rows || !actor_kernel(mode) || n_rows < 1 || capacity < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = actor_allow_smem(device, obs_size);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (n_rows + rows - 1) / rows;
  const int blocks = static_cast<int>(tiles < capacity ? tiles : capacity);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(done, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ActorArgs args{obs,      act,  lp,   adv,
                       a_comp,   c_comp, n_rows, obs_size,
                       rows,     {lo, hi, ent_c, ent_half},
                       partials, out,  done};
  const int smem = 4 * actor_smem_floats(obs_size, rows);
  if (mode == kTiled)
    actor_grad_kernel<kTiled><<<blocks, kThreads, smem, s>>>(args);
  else if (mode == kStaged)
    actor_grad_kernel<kStaged><<<blocks, kThreads, smem, s>>>(args);
  else
    actor_grad_kernel<kF32><<<blocks, kThreads, smem, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core kernels (their bf16 instances where bf16 != 0) on
// `blocks` blocks, then the fixed-order reduction of their partials into
// `out`.

// out: loss_sum, dW1 (H, In), db1 (H), dW2 (H), db2.
int marlnav_critic_grad_sums(const float* obs, const float* vold,
                             const float* ret, const float* w1,
                             const float* b1, const float* w2,
                             const float* b2, long long n_rows, int in_size,
                             int hidden, float eps, int bf16, int blocks,
                             float* partials, float* out, int device,
                             void* stream) {
  using namespace marlnav::update;
  if (!critic_instance(in_size, hidden, bf16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GradArgs args{obs,    w1,      b1,
                      {vold, ret, nullptr}, {w2, b2, nullptr, nullptr},
                      n_rows, in_size, hidden,
                      in_size % 4 == 0 && aligned16(obs),
                      eps,    {},      partials};
  critic_instance(in_size, hidden, bf16 != 0, &args, blocks, s, &err);
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
    int hidden, float lo, float hi, float ent_c, float ent_half, int bf16,
    int blocks, float* partials, float* out, int device, void* stream) {
  using namespace marlnav::update;
  if (!actor_instance(obs_size, hidden, bf16 != 0))
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
  actor_instance(obs_size, hidden, bf16 != 0, &args, blocks, s, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce(
      partials, blocks, ActorHead<4>::n_out(obs_size, hidden), out, s));
}

// The run-time-width route (see rt_forward_kernel) of the critic (actor ==
// 0: row0 old values, row1 returns; head0 w2, head1 b2) or the un-collapsed
// actor (row0 actions, row1 log-probs, row2 advantages; head0..3 wmu, bmu,
// wvar, bvar), its backward on `blocks` row blocks (marlnav_rt_row_blocks
// for `sms`): in one pass where one_pass != 0 (only where
// marlnav_rt_one_pass), else in three launches through rowbuf (N, 2) or (N,
// 5); partials (blocks, n_out); out as the tensor-core entry points'.
int marlnav_rt_grad_sums(int actor, const float* obs, const float* row0,
                         const float* row1, const float* row2,
                         const float* w1, const float* b1, const float* head0,
                         const float* head1, const float* head2,
                         const float* head3, long long n_rows, int in_size,
                         int hidden, float eps, float lo, float hi,
                         float ent_c, float ent_half, int bf16, int one_pass,
                         int sms, int blocks, float* rowbuf, float* partials,
                         float* out, int device, void* stream) {
  using namespace marlnav::update;
  const int most = marlnav_rt_row_blocks(n_rows, in_size, hidden, sms);
  if (!most || blocks < 1 || blocks > most ||
      (one_pass && !marlnav_rt_one_pass(actor, in_size, hidden)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The widest copies that every row of x and W1 starts on.
  const std::uintptr_t at = reinterpret_cast<std::uintptr_t>(obs) |
                            reinterpret_cast<std::uintptr_t>(w1) |
                            4u * static_cast<unsigned>(in_size);
  const int copy = at % 16 == 0 ? 4 : at % 8 == 0 ? 2 : 1;
  const RtArgs args{{obs, w1, b1, {row0, row1, row2},
                     {head0, head1, head2, head3}, n_rows, in_size, hidden,
                     false, eps, {lo, hi, ent_c, ent_half}, partials},
                    copy, rowbuf};
  const int n_out = actor ? ActorHead<4>::n_out(in_size, hidden)
                          : CriticHead<4>::n_out(in_size, hidden);
  const bool one = one_pass != 0;
  if (actor)
    err = bf16 ? launch_rt<true, true>(args, one, sms, blocks, n_out, out, s)
               : launch_rt<true, false>(args, one, sms, blocks, n_out, out,
                                        s);
  else
    err = bf16 ? launch_rt<false, true>(args, one, sms, blocks, n_out, out, s)
               : launch_rt<false, false>(args, one, sms, blocks, n_out, out,
                                         s);
  return static_cast<int>(err);
}

}  // extern "C"
