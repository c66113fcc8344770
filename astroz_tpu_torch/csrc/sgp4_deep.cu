// Deep-space (SDP4) fast propagation over a separable time grid, for
// Hopper: kernel K2.
//
// Replaces the TPU kernel astroz_tpu/ops/pallas_sgp4.py:_kernel_deep
// (wrapper propagate_deep_pallas). For every (time t, deep satellite d):
//   tsince = t_time[t] - t_sat[d]                                    (f64)
//   spine: secular and lunisolar-secular angles in f64; on resonant lanes
//          the 720-minute resonance integral read from the per-satellite
//          tables (row k = min(floor(|t| / 720), steps), + steps + 1 when
//          t < 0) and finished by the Euler-Maclaurin quadratic; reduced
//          mod 2pi (theta by fmod, the dividend's sign; the rest by
//          remainder, the divisor's) and cast to f32
//   tail:  simplified drag, am = (xke / nm)^(2/3) by a bit-trick cube
//          root, lunisolar periodics with the Lyddane branch below
//          0.2 rad, the inclination flip, per-point inclination
//          coefficients, Newton Kepler (6 or 8 trips), J2 short-period
//          terms, TEME r (and v), all f32
//   errors 2, 1, 3 (each only where none is set yet), then the Kepler
//   tail's 4 and 6, over the init error; failed points zero-filled.
// The plain torch version is astroz_tpu_torch/ops/fast.py (deep_spine_f64
// + deep_tail_f32); this file runs the same operations in the same order
// (sgp4_common.cuh says how the bits are kept). The TPU kernel streamed
// six (T, D) f32 grids that XLA's f64 spine and table gather wrote to
// device memory; here the spine is f64 inside the kernel, each point
// reads its five table values directly, and those grids never exist.
//
// Bound. Each point does ~450 f32 operations (eleven polynomial sincos,
// the atan2 polynomial, the cube root's three divides, Kepler), ~30 f64
// operations with five reductions mod 2pi (one FMA each with its quotient,
// sgp4_common.cuh:fmod_two_pi), and stores 28 bytes (16 without
// velocities); the deep subset is ~5% of a catalog (667 x 1,440 points
// at the headline grid, 27 MB of stores), so the kernel is small and
// issue-bound, with register pressure from the 26 lunisolar coefficients
// and 13 f64 spine fields a thread holds. The layout is K1's: one thread
// owns one deep satellite and ROWS time rows, loads its fields once, and
// neighbouring threads take neighbouring satellites, so field loads,
// table reads and plane stores are contiguous across a warp. Outputs are
// exact-shape; the ragged edges are masked.

#include "sgp4_common.cuh"

namespace {

constexpr int BLOCK = 128;  // deep satellites per block
constexpr int ROWS = 8;     // time rows per thread

constexpr int N_SPINE = 13;  // ops/fast.py DEEP_SPINE_FIELD_NAMES
constexpr int N_TAIL = 33;   // ops/fast.py DEEP_FIELD_NAMES

constexpr double STEPP = 720.0;
constexpr double RPTIM = 4.37526908801129966e-3;
constexpr float PI_F = F32(3.14159265358979323846);
constexpr float ZES = F32(0.01675);
constexpr float ZEL = F32(0.05490);
constexpr float ZNS = F32(1.19459e-5);
constexpr float ZNL = F32(1.5835218e-4);

// fastmath._AT: the atan polynomial, lowest order first
constexpr float AT0 = F32(0.9999994161665577);
constexpr float AT1 = F32(-0.33330223078054766);
constexpr float AT2 = F32(0.1995111999819918);
constexpr float AT3 = F32(-0.1393327926026066);
constexpr float AT4 = F32(0.09709489254190584);
constexpr float AT5 = F32(-0.05688293268565614);
constexpr float AT6 = F32(0.022568342982102904);
constexpr float AT7 = F32(-0.004257856903975933);
constexpr float HALF_PI_F = F32(1.5707963267948966);

// fastmath.fast_atan2
__device__ __forceinline__ float fast_atan2(float y, float x) {
  const float abs_y = fabsf(y);
  const float abs_x = fabsf(x);
  const bool swap = abs_y > abs_x;
  const float num = swap ? abs_x : abs_y;
  float den = swap ? abs_y : abs_x;
  den = den > 0.0f ? den : 1.0f;
  const float z = num / den;
  const float z2 = z * z;
  float a = AT6 + z2 * AT7;
  a = AT5 + z2 * a;
  a = AT4 + z2 * a;
  a = AT3 + z2 * a;
  a = AT2 + z2 * a;
  a = AT1 + z2 * a;
  a = AT0 + z2 * a;
  a = z * a;
  a = swap ? HALF_PI_F - a : a;
  a = x < 0.0f ? PI_F - a : a;
  return y < 0.0f ? -a : a;
}

// fastmath.pow23: fast_cbrt squared. The bits divided by 3 with floor
// division as torch.div(..., rounding_mode="floor")
__device__ __forceinline__ float pow23(float x) {
  const int i = __float_as_int(x);
  int q = i / 3;
  if (i % 3 != 0 && i < 0) q -= 1;
  float y = __int_as_float(q + 0x2A511CD0);
  y = (2.0f * y + x / (y * y)) * THIRD;
  y = (2.0f * y + x / (y * y)) * THIRD;
  y = (2.0f * y + x / (y * y)) * THIRD;
  return y * y;
}

template <bool WANT_VEL, int ITERS>
__global__ void __launch_bounds__(BLOCK)
sgp4_deep_kernel(const double* __restrict__ t_time,
                 const double* __restrict__ t_sat,
                 const double* __restrict__ spine,
                 const float* __restrict__ tail,
                 const int* __restrict__ flags,
                 const double* __restrict__ tables, int n_times, int n_deep,
                 int n_steps, float j2, float re, float vkmpersec, float xke,
                 float j3oj2, float* __restrict__ r, float* __restrict__ v,
                 int* __restrict__ err) {
  const int d = blockIdx.x * BLOCK + threadIdx.x;
  if (d >= n_deep) return;
  const int t_begin = blockIdx.y * ROWS;
  const int t_end = min(t_begin + ROWS, n_times);
  const size_t nd = (size_t)n_deep;
  const size_t plane = (size_t)n_times * nd;
  const size_t table = (size_t)(2 * (n_steps + 1)) * nd;

  double sp[N_SPINE];
#pragma unroll
  for (int k = 0; k < N_SPINE; ++k) sp[k] = spine[k * nd + d];
  const double mo = sp[0], mdot = sp[1], dmdt = sp[2], argpo = sp[3];
  const double argpdot = sp[4], domdt = sp[5], nodeo = sp[6];
  const double nodedot = sp[7], dnodt = sp[8], nodecf = sp[9];
  const double no_unkozai = sp[10], t2cof = sp[11], gsto = sp[12];
  float tf[N_TAIL];
#pragma unroll
  for (int k = 0; k < N_TAIL; ++k) tf[k] = tail[k * nd + d];
  const float cc1 = tf[0], bstar = tf[1], cc4 = tf[2], ecco = tf[3];
  const float inclo = tf[4], dedt = tf[5], didt = tf[6];
  // lunisolar coefficients: DPPER_FIELD_NAMES from row 7
  const float zmos = tf[7], se2 = tf[8], se3 = tf[9], si2 = tf[10];
  const float si3 = tf[11], sl2 = tf[12], sl3 = tf[13], sl4 = tf[14];
  const float sgh2 = tf[15], sgh3 = tf[16], sgh4 = tf[17], sh2 = tf[18];
  const float sh3 = tf[19], zmol = tf[20], ee2 = tf[21], e3 = tf[22];
  const float xi2 = tf[23], xi3 = tf[24], xl2 = tf[25], xl3 = tf[26];
  const float xl4 = tf[27], xgh2 = tf[28], xgh3 = tf[29], xgh4 = tf[30];
  const float xh2 = tf[31], xh3 = tf[32];
  const int irez = flags[d];
  const int error0 = flags[nd + d];
  const double epoch = t_sat[d];

  for (int ti = t_begin; ti < t_end; ++ti) {
    // ---- f64 deep spine (fast.deep_spine_f64) ----------------------------
    const double t = t_time[ti] - epoch;
    const double xmdf = mo + (mdot + dmdt) * t;
    const double argpdf = argpo + (argpdot + domdt) * t;
    const double t2 = t * t;
    const double nodem64 = nodeo + (nodedot + dnodt) * t + nodecf * t2;
    const double templ_big = no_unkozai * t2 * t2cof;
    double mm_spine = xmdf;
    double nm64 = no_unkozai;
    if (irez != 0) {
      // fast.resonance_from_tables: exact floor division, then the row
      const double a = fabs(t);
      double k = (a - fmod(a, STEPP)) / STEPP;
      k = (k > (double)n_steps) ? (double)n_steps : k;
      const int row = (int)k + (t < 0.0 ? n_steps + 1 : 0);
      // the five tables, ops/fast.py RESONANCE_TABLE_NAMES, `table` apart
      const double* tb = tables + (size_t)row * nd + d;
      const double xli = tb[0], xni = tb[table], xndt = tb[2 * table];
      const double xldot = tb[3 * table], xnddt = tb[4 * table];
      const double atime = k * (t > 0.0 ? STEPP : -STEPP);
      const double ft = t - atime;
      nm64 = xni + xndt * ft + xnddt * ft * ft * 0.5;
      const double xl = xli + xldot * ft + xndt * ft * ft * 0.5;
      const double theta = fmod_two_pi(gsto + t * RPTIM);
      mm_spine = irez == 1 ? xl - nodem64 - argpdf + theta
                           : xl - 2.0 * nodem64 + 2.0 * theta;
    }
    mm_spine = mm_spine + templ_big;
    const float t32 = __double2float_rn(t);
    float u = __double2float_rn(rem_two_pi(mm_spine + argpdf));
    const float mp = __double2float_rn(rem_two_pi(mm_spine));
    const float argp32 = __double2float_rn(rem_two_pi(argpdf));
    const float nodep = __double2float_rn(rem_two_pi(nodem64));
    const float nm_deep = __double2float_rn(nm64);

    // ---- simplified drag, am from the resonance nm (fast.deep_tail_f32)
    int error = error0;
    const float tempa = 1.0f - cc1 * t32;
    const float tempe = bstar * cc4 * t32;
    const bool bad_nm = nm_deep <= 0.0f;
    if (bad_nm && error == 0) error = 2;
    const float a_base = pow23(xke / (bad_nm ? F32(1e-8) : nm_deep));
    const float am = a_base * tempa * tempa;
    const float am_safe = am > 0.0f ? am : 1.0f;
    const float rsq_am = 1.0f / sqrtf(am_safe);

    float em = ecco - tempe + dedt * t32;
    const float inclm = inclo + didt * t32;
    if ((em >= 1.0f || em < F32(-0.001)) && error == 0) error = 1;
    em = clampf(em, F32(1.0e-6), F32(0.999999));

    // ---- lunisolar periodics (fast._dpper_core) ----------------------------
    float sin_node, cos_node;
    sincos_poly(nodep, sin_node, cos_node);
    float szm, unused, sinzf, coszf;
    float zm = zmos + ZNS * t32;
    sincos_poly(zm, szm, unused);
    float zf = zm + 2.0f * ZES * szm;
    sincos_poly(zf, sinzf, coszf);
    float f2 = 0.5f * sinzf * sinzf - 0.25f;
    float f3 = -0.5f * sinzf * coszf;
    const float ses = se2 * f2 + se3 * f3;
    const float sis = si2 * f2 + si3 * f3;
    const float sls = sl2 * f2 + sl3 * f3 + sl4 * sinzf;
    const float sghs = sgh2 * f2 + sgh3 * f3 + sgh4 * sinzf;
    const float shs = sh2 * f2 + sh3 * f3;

    zm = zmol + ZNL * t32;
    sincos_poly(zm, szm, unused);
    zf = zm + 2.0f * ZEL * szm;
    sincos_poly(zf, sinzf, coszf);
    f2 = 0.5f * sinzf * sinzf - 0.25f;
    f3 = -0.5f * sinzf * coszf;
    const float sel = ee2 * f2 + e3 * f3;
    const float sil = xi2 * f2 + xi3 * f3;
    const float sll = xl2 * f2 + xl3 * f3 + xl4 * sinzf;
    const float sghl = xgh2 * f2 + xgh3 * f3 + xgh4 * sinzf;
    const float shll = xh2 * f2 + xh3 * f3;

    const float pe = ses + sel;
    const float pinc = sis + sil;
    const float pl = sls + sll;
    const float pgh = sghs + sghl;
    const float ph = shs + shll;

    float xincp = inclm + pinc;
    float ep = em + pe;
    float sinip, cosip;
    sincos_poly(xincp, sinip, cosip);

    float argpp, du;
    if (xincp < F32(0.2)) {
      // Lyddane path
      const float alfdp =
          sinip * sin_node + ph * cos_node + pinc * cosip * sin_node;
      const float betdp =
          sinip * cos_node - ph * sin_node + pinc * cosip * cos_node;
      float nodep_l = fast_atan2(alfdp, betdp);
      const bool far = fabsf(nodep - nodep_l) > PI_F;
      if (far && nodep_l < nodep) {
        nodep_l = nodep_l + TWO_PI_F;
      } else if (far && nodep_l >= nodep) {
        nodep_l = nodep_l - TWO_PI_F;
      }
      const float xls =
          mp + argp32 + cosip * nodep + pl + pgh - pinc * nodep * sinip;
      const float mp_l = mp + pl;
      argpp = xls - mp_l - cosip * nodep_l;
      // mp_l + argpp_l - (mp + argpp), algebraically
      du = pl + pgh + cosip * (nodep - nodep_l) - pinc * nodep * sinip;
      sincos_poly(nodep_l, sin_node, cos_node);
    } else {
      const float sin_safe = fabsf(sinip) > F32(1e-12) ? sinip : F32(1e-12);
      const float ph_n = ph / sin_safe;
      const float pgh_n = pgh - cosip * ph_n;
      argpp = argp32 + pgh_n;
      du = pl + pgh_n;
      angle_add(sin_node, cos_node, ph_n, sin_node, cos_node);
    }
    u = u + du;

    // inclination flip: node += pi, argp -= pi, and u = mp + argp with it
    if (xincp < 0.0f) {
      sin_node = -sin_node;
      cos_node = -cos_node;
      argpp = argpp - PI_F;
      u = u - PI_F;
    }
    xincp = fabsf(xincp);
    if ((ep < 0.0f || ep > 1.0f) && error == 0) error = 3;
    ep = clampf(ep, F32(1e-12), F32(0.999999));

    // ---- per-point inclination-dependent coefficients ------------------
    sincos_poly(xincp, sinip, cosip);
    const float aycof = -0.5f * j3oj2 * sinip;
    const bool near180 = fabsf(cosip + 1.0f) > F32(1.5e-12);
    const float denom = near180 ? 1.0f + cosip : F32(1.5e-12);
    const float xlcof =
        -0.25f * j3oj2 * sinip * (3.0f + 5.0f * cosip) / denom;
    const float cosisq = cosip * cosip;
    const float con41 = 3.0f * cosisq - 1.0f;
    const float x1mth2 = 1.0f - cosisq;
    const float x7thm1 = 7.0f * cosisq - 1.0f;

    // ---- long-period terms -> Kepler -> TEME (fast._kepler_posvel_f32) -
    const PosVel o = kepler_posvel<WANT_VEL, ITERS>(
        u, am, am_safe, rsq_am, ep, argpp, sin_node, cos_node, sinip, cosip,
        aycof, xlcof, con41, x1mth2, x7thm1, error, j2, re, vkmpersec);
    store_point<WANT_VEL>(o, (size_t)ti * nd + d, plane, r, v, err);
  }
}

template <bool WANT_VEL>
cudaError_t launch(int kepler_iters, dim3 grid, cudaStream_t stream,
                   const double* t_time, const double* t_sat,
                   const double* spine, const float* tail, const int* flags,
                   const double* tables, int n_times, int n_deep,
                   int n_steps, float j2, float re, float vkmpersec,
                   float xke, float j3oj2, float* r, float* v, int* err) {
#define ASTROZ_LAUNCH(IT)                                                  \
  sgp4_deep_kernel<WANT_VEL, IT><<<grid, BLOCK, 0, stream>>>(              \
      t_time, t_sat, spine, tail, flags, tables, n_times, n_deep, n_steps, \
      j2, re, vkmpersec, xke, j3oj2, r, v, err)
  switch (kepler_iters) {
    case 6: ASTROZ_LAUNCH(6); break;
    case 8: ASTROZ_LAUNCH(8); break;
    default: return cudaErrorInvalidValue;
  }
#undef ASTROZ_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes by astroz_tpu_torch/_build.py).
// Shapes: t_time (T,) f64; t_sat (D,) f64 deep epochs; spine (13, D) f64;
// tail (33, D) f32; flags (2, D) i32 = [irez, init error]; tables
// (5, 2 * (n_steps + 1), D) f64; r (3, T, D) f32; v (3, T, D) f32 or null
// when want_vel == 0; err (T, D) i32. All contiguous on the current
// device. Launches on `stream` and returns the launch's cudaError_t.
extern "C" int astroz_sgp4_deep(const double* t_time, const double* t_sat,
                                const double* spine, const float* tail,
                                const int* flags, const double* tables,
                                int n_times, int n_deep, int n_steps,
                                int kepler_iters, int want_vel, float j2,
                                float re, float vkmpersec, float xke,
                                float j3oj2, float* r, float* v, int* err,
                                void* stream) {
  const dim3 grid((n_deep + BLOCK - 1) / BLOCK, (n_times + ROWS - 1) / ROWS);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      want_vel ? launch<true>(kepler_iters, grid, st, t_time, t_sat, spine,
                              tail, flags, tables, n_times, n_deep, n_steps,
                              j2, re, vkmpersec, xke, j3oj2, r, v, err)
               : launch<false>(kepler_iters, grid, st, t_time, t_sat, spine,
                               tail, flags, tables, n_times, n_deep, n_steps,
                               j2, re, vkmpersec, xke, j3oj2, r, v, err);
  return static_cast<int>(rc);
}
