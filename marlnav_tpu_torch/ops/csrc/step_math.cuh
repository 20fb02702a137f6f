// Per-env step physics shared by the port's fused CUDA kernels.
//
// Device counterpart of marlnav_tpu_torch/ops/step_math.py (itself a port
// of marlnav_tpu/ops/step_math.py).  Every function performs the same
// float32 operations in the same order as its Python twin, and the
// library is built with -fmad=false so no multiply-add is contracted: a
// kernel built from these functions agrees with the plain PyTorch version
// on the same inputs (see ops/fused_collect.py for the tolerances).
//
// Constants are written as double literals and cast to float, which is
// how PyTorch rounds a Python float scalar against a float32 tensor.
#pragma once

#include <cstdint>

namespace marlnav {

#define F32(x) static_cast<float>(x)

constexpr double kPiD = 3.14159265358979323846;

// ---------------------------------------------------------------------------
// Polynomials (step_math.py acos / sin_pi / cos_pi)
// ---------------------------------------------------------------------------

// arccos on [-1, 1]: Hastings polynomial (Abramowitz & Stegun 4.4.45).
__device__ __forceinline__ float acos_h(float x) {
  const float ax = fabsf(x);
  float poly = F32(-0.0012624911) * ax + F32(0.0066700901);
  poly = poly * ax + F32(-0.0170881256);
  poly = poly * ax + F32(0.0308918810);
  poly = poly * ax + F32(-0.0501743046);
  poly = poly * ax + F32(0.0889789874);
  poly = poly * ax + F32(-0.2145988016);
  poly = poly * ax + F32(1.5707963050);
  const float r = sqrtf(fmaxf(1.0f - ax, 0.0f)) * poly;
  return x < 0.0f ? F32(kPiD) - r : r;
}

// sin(x) for |x| <= pi.
__device__ __forceinline__ float sin_pi(float x) {
  const float x2 = x * x;
  float acc = F32(1.3449973826791738e-10) * x2 + F32(-2.4676487851666484e-08);
  acc = acc * x2 + F32(2.752939488670167e-06);
  acc = acc * x2 + F32(-0.00019840151841299232);
  acc = acc * x2 + F32(0.0083333102899997395);
  acc = acc * x2 + F32(-0.16666664568359335);
  acc = acc * x2 + F32(0.99999999442030307);
  return acc * x;
}

// cos(x) for |x| <= pi.
__device__ __forceinline__ float cos_pi(float x) {
  const float x2 = x * x;
  float acc = F32(1.7245068538391953e-09) * x2 + F32(-2.7079024321864158e-07);
  acc = acc * x2 + F32(2.4769882914249208e-05);
  acc = acc * x2 + F32(-0.0013887803571303186);
  acc = acc * x2 + F32(0.041666489213904624);
  acc = acc * x2 + F32(-0.49999989101180597);
  acc = acc * x2 + F32(0.99999998904852216);
  return acc;
}

// jax.nn.softplus: max(x, 0) + log1p(exp(-|x|)).
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// ---------------------------------------------------------------------------
// Random numbers
// ---------------------------------------------------------------------------

// Philox4x32-10 (Salmon et al., SC'11): counter-based, so any (key,
// counter) pair is an independent draw with no state to carry.
__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t lo0 = 0xD2511F53u * ctr.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, ctr.x);
    const uint32_t lo1 = 0xCD9E8D57u * ctr.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, ctr.z);
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += 0x9E3779B9u;
    key.y += 0xBB67AE85u;
  }
  return ctr;
}

// Uniform [0, 1) from a raw word: the top 24 bits by ARITHMETIC shift of
// the word read as int32 (step_math.py bits_to_uniform), exact in float32
// and strictly below 1.
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return F32(static_cast<int32_t>(bits) >> 8) * F32(1.0 / 16777216.0) + 0.5f;
}

// (z0, z1) standard-normal pair.  theta = 2*pi*u2 is shifted to
// t = theta - pi in [-pi, pi) so the bounded polynomials apply.
__device__ __forceinline__ void box_muller(float u1, float u2, float& z0,
                                           float& z1) {
  const float r = sqrtf(-2.0f * logf(fmaxf(u1, F32(1e-12))));
  const float t = F32(2.0 * kPiD) * u2 - F32(kPiD);
  const float rn = -r;
  z0 = rn * cos_pi(t);
  z1 = rn * sin_pi(t);
}

// ---------------------------------------------------------------------------
// Geometry (step_math.py StepMath.geom)
// ---------------------------------------------------------------------------

// Signed view angle and distance from an agent (px, py, heading hx, hy)
// to the point (tx, ty); the angle is zeroed inside cap_distance.
__device__ __forceinline__ void geom(float px, float py, float hx, float hy,
                                     float tx, float ty, float cap_distance,
                                     float& ang, float& dist) {
  const float ddx = tx - px;
  const float ddy = ty - py;
  dist = sqrtf(ddx * ddx + ddy * ddy);
  const float inv = 1.0f / fmaxf(dist, F32(1e-12));
  const float ux = ddx * inv;
  const float uy = ddy * inv;
  const float dot = fminf(fmaxf(hx * ux + hy * uy, F32(-1.0 + 1e-8)),
                          F32(1.0 - 1e-8));
  const float orth_x = ux - dot * hx;
  const float sign = orth_x > 0.0f ? -1.0f : 1.0f;
  ang = sign * acos_h(dot);
  if (dist < cap_distance) ang = 0.0f;
}

}  // namespace marlnav
