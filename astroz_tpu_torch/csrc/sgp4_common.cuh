// Device functions shared by the SGP4 kernels (sgp4_shallow.cu, K1 and
// its merge variant K3; sgp4_deep.cu, K2).
//
// Each function is the twin of a plain torch function of
// astroz_tpu_torch/ops/fastmath.py or ops/fast.py and runs the same
// IEEE-rounded f32/f64 operations in the same order. The library is built
// with --fmad=false and without --use_fast_math (astroz_tpu_torch/
// _build.py), so the kernels give the plain versions' bits: divides and
// square roots are correctly rounded (1/sqrtf stands for the JAX rsqrt;
// CUDA's rsqrtf is an approximation), rintf rounds half to even like
// torch.round, and f64 remainders follow torch.remainder (the divisor's
// sign: fmod, then + 2pi below zero).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// f32 constants are the f32 rounding of the double the Python code
// writes, as torch and JAX round a python float against an f32 tensor
#define F32(x) ((float)(x))

constexpr double PI_D = 3.141592653589793;
constexpr double TWO_PI_D = 2.0 * 3.141592653589793;
constexpr float TWO_PI_F = F32(2.0 * 3.141592653589793);

constexpr float TWO_OVER_PI = F32(0.6366197723675814);
constexpr float PIO2_HI = F32(2.0 * 0.78515625);
constexpr float PIO2_MED = F32(2.0 * 2.4187564849853515625e-4);
constexpr float PIO2_LO = F32(2.0 * 3.77489497744594108e-8);
constexpr float S1 = F32(-1.6666654611e-1);
constexpr float S2 = F32(8.3321608736e-3);
constexpr float S3 = F32(-1.9515295891e-4);
constexpr float C1 = F32(4.166664568298827e-2);
constexpr float C2 = F32(-1.388731625493765e-3);
constexpr float C3 = F32(2.443315711809948e-5);

constexpr float SIXTH = F32(1.0 / 6.0);
constexpr float TWELFTH = F32(1.0 / 12.0);
constexpr float THIRD = F32(1.0 / 3.0);

// fastmath.sincos
__device__ __forceinline__ void sincos_poly(float x, float& s, float& c) {
  const float k = rintf(x * TWO_OVER_PI);
  const float y = ((x - k * PIO2_HI) - k * PIO2_MED) - k * PIO2_LO;
  const float y2 = y * y;
  const float sp = y + y * y2 * (S1 + y2 * (S2 + y2 * S3));
  const float cp = 1.0f - 0.5f * y2 + y2 * y2 * (C1 + y2 * (C2 + y2 * C3));
  const int q = (int)k & 3;
  const bool swap = (q & 1) == 1;
  s = swap ? cp : sp;
  c = swap ? sp : cp;
  if ((q & 2) == 2) s = -s;
  if (((q + 1) & 2) == 2) c = -c;
}

// fastmath.angle_add
__device__ __forceinline__ void angle_add(float sin_a, float cos_a,
                                          float delta, float& s, float& c) {
  const float d2 = delta * delta;
  const float sd = delta * (1.0f - d2 * SIXTH * (1.0f - F32(0.05) * d2));
  const float cd = 1.0f - 0.5f * d2 * (1.0f - d2 * TWELFTH);
  s = sin_a * cd + cos_a * sd;
  c = cos_a * cd - sin_a * sd;
}

// min(max(x, lo), hi); NaN stays NaN like torch.clamp
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  x = (x < lo) ? lo : x;
  return (x > hi) ? hi : x;
}

// torch.remainder(x, 2pi) in f64
__device__ __forceinline__ double rem_two_pi(double x) {
  double r = fmod(x, TWO_PI_D);
  if (r < 0.0) r += TWO_PI_D;
  return r;
}

// fast._wrap_two_pi_f32
__device__ __forceinline__ float wrap_two_pi(float x) {
  if (x >= TWO_PI_F) x = x - TWO_PI_F;
  if (x >= TWO_PI_F) x = x - TWO_PI_F;
  if (x < 0.0f) x = x + TWO_PI_F;
  return x;
}

// fast.solve_kepler_fast: returns sin and cos of the eccentric longitude
template <int ITERS>
__device__ __forceinline__ void solve_kepler(float u, float axnl, float aynl,
                                             float& sineo1, float& coseo1) {
  float eo1 = u;
  sincos_poly(eo1, sineo1, coseo1);
#pragma unroll
  for (int i = 0; i < ITERS - 1; ++i) {
    const float denom = 1.0f - coseo1 * axnl - sineo1 * aynl;
    const float tem5 = (u - aynl * coseo1 + axnl * sineo1 - eo1) / denom;
    eo1 = eo1 + clampf(tem5, F32(-0.95), F32(0.95));
    sincos_poly(eo1, sineo1, coseo1);
  }
  const float denom = 1.0f - coseo1 * axnl - sineo1 * aynl;
  const float tem5 = (u - aynl * coseo1 + axnl * sineo1 - eo1) / denom;
  const float d = clampf(tem5, F32(-0.95), F32(0.95));
  const float d2h = 0.5f * d * d;
  const float sind = d * (1.0f - THIRD * d2h);
  const float cosd = 1.0f - d2h;
  const float s = sineo1 * cosd + coseo1 * sind;
  const float c = coseo1 * cosd - sineo1 * sind;
  sineo1 = s;
  coseo1 = c;
}

// one grid point's TEME output
struct PosVel {
  float r[3];
  float v[3];
  int error;
};

// fast._kepler_posvel_f32: long-period terms -> Kepler -> short-period
// terms -> TEME r (and v); errors 4 and 6 over `error`; failed points
// zero-filled. rsq_am is 1/sqrt(am_safe).
template <bool WANT_VEL, int ITERS>
__device__ __forceinline__ PosVel kepler_posvel(
    float u, float am, float am_safe, float rsq_am, float ep, float argpp,
    float sin_node, float cos_node, float sinip, float cosip, float aycof,
    float xlcof, float con41, float x1mth2, float x7thm1, int error, float j2,
    float re, float vkmpersec) {
  float sin_argpp, cos_argpp;
  sincos_poly(argpp, sin_argpp, cos_argpp);
  const float axnl = ep * cos_argpp;
  const float temp_lp = 1.0f / (am_safe * (1.0f - ep * ep));
  const float aynl = ep * sin_argpp + temp_lp * aycof;
  const float u_kep = wrap_two_pi(u + temp_lp * xlcof * axnl);
  float sineo1, coseo1;
  solve_kepler<ITERS>(u_kep, axnl, aynl, sineo1, coseo1);

  const float ecose = axnl * coseo1 + aynl * sineo1;
  const float esine = axnl * sineo1 - aynl * coseo1;
  const float el2 = axnl * axnl + aynl * aynl;
  const float pl = am * (1.0f - el2);
  if (pl < 0.0f && error == 0) error = 4;
  const float pl_safe = pl > 0.0f ? pl : 1.0f;

  const float rl = am * (1.0f - ecose);
  const float rl_inv = 1.0f / rl;
  const float betal = sqrtf(fabsf(1.0f - el2));
  const float temp_b = esine / (1.0f + betal);
  const float am_rl = am * rl_inv;
  const float sinu = am_rl * (sineo1 - aynl - axnl * temp_b);
  const float cosu = am_rl * (coseo1 - axnl + aynl * temp_b);
  const float sin2u = (cosu + cosu) * sinu;
  const float cos2u = 1.0f - 2.0f * sinu * sinu;
  const float rsq_pl = 1.0f / sqrtf(pl_safe);
  const float temp_p = rsq_pl * rsq_pl;
  const float temp1 = 0.5f * j2 * temp_p;
  const float temp2 = temp1 * temp_p;

  const float mrt = rl * (1.0f - 1.5f * temp2 * betal * con41) +
                    0.5f * temp1 * x1mth2 * cos2u;
  float sinsu, cossu, snod, cnod, sini, cosi;
  angle_add(sinu, cosu, -0.25f * temp2 * x7thm1 * sin2u, sinsu, cossu);
  angle_add(sin_node, cos_node, 1.5f * temp2 * cosip * sin2u, snod, cnod);
  angle_add(sinip, cosip, 1.5f * temp2 * cosip * sinip * cos2u, sini, cosi);

  const float xmx = -snod * cosi;
  const float xmy = cnod * cosi;
  const float ux = xmx * sinsu + cnod * cossu;
  const float uy = xmy * sinsu + snod * cossu;
  const float uz = sini * sinsu;

  if (mrt < 1.0f && error == 0) error = 6;
  const bool ok = error == 0;
  const float mrt_re = ok ? mrt * re : 0.0f;
  PosVel o;
  o.error = error;
  o.r[0] = mrt_re * ux;
  o.r[1] = mrt_re * uy;
  o.r[2] = mrt_re * uz;
  if (WANT_VEL) {
    const float rdotl = am_safe * rsq_am * esine * rl_inv;
    const float rvdotl = pl_safe * rsq_pl * rl_inv;
    const float nm_oxke = rsq_am * rsq_am * rsq_am;
    const float mvt = rdotl - nm_oxke * temp1 * x1mth2 * sin2u;
    const float rvdot =
        rvdotl + nm_oxke * temp1 * (x1mth2 * cos2u + 1.5f * con41);
    const float vx_ = xmx * cossu - cnod * sinsu;
    const float vy_ = xmy * cossu - snod * sinsu;
    const float vz_ = sini * cossu;
    const float mvt_s = ok ? vkmpersec * mvt : 0.0f;
    const float rvdot_s = ok ? vkmpersec * rvdot : 0.0f;
    o.v[0] = mvt_s * ux + rvdot_s * vx_;
    o.v[1] = mvt_s * uy + rvdot_s * vy_;
    o.v[2] = mvt_s * uz + rvdot_s * vz_;
  }
  return o;
}

// writes one point of the (3, T, N) planes and the (T, N) error plane:
// idx = t * N + n, plane = T * N
template <bool WANT_VEL>
__device__ __forceinline__ void store_point(const PosVel& o, size_t idx,
                                            size_t plane, float* r, float* v,
                                            int* err) {
  r[idx] = o.r[0];
  r[plane + idx] = o.r[1];
  r[2 * plane + idx] = o.r[2];
  err[idx] = o.error;
  if (WANT_VEL) {
    v[idx] = o.v[0];
    v[plane + idx] = o.v[1];
    v[2 * plane + idx] = o.v[2];
  }
}

}  // namespace
