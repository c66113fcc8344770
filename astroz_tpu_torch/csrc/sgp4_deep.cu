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
//          remainder, the divisor's) and cast to f32; every f64 fmod is
//          sgp4_common.cuh:fmod_exact
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
// issue-bound: the row loop's hot path is at most 1,541 SASS instructions
// a point (both sides of its branches counted, chip_smoke.kernel_report
// on the built library). What the design does about it (each choice
// timed in turns on an H100 by shallow_variants.py, the calls replayed
// from a CUDA graph):
// - a persistent grid (sgp4_common.cuh: warp_run): no more blocks than
//   fit at once, each warp a run of (warp column, time row) units that
//   differ by at most one, so the 27-lane last column holds one warp, not
//   a block, and no wave runs part full (the grid of 8-row blocks ran
//   2.05 waves, the third on 24 SMs): -23% at 667 x 1,440;
// - the 13 f64 spine fields and 33 f32 coefficients live in shared memory
//   (30 KB a block), read where they are used, not in ~59 registers
//   across the rows; __launch_bounds__(128, 6) then gives 79 registers
//   without a spill, 6 blocks an SM where 113 registers gave 4;
// - the catalog stages the deep slots grouped by regime
//   (propagation.deep_slots), so that a warp's lanes take one side of the
//   Lyddane branch and of the resonance branch: ~5% of K2.
// Together 0.096 -> 0.067 ms. The kernel is now shorter than the host
// time of its Python wrapper (55-77 us a call), so calls launched back to
// back take ~0.07-0.09 ms each: what is left is on the host.
// A thread owns one deep satellite of its warp's column, and neighbouring
// lanes take neighbouring slots, so field loads, table reads and plane
// stores are contiguous across a warp. Outputs are exact-shape; the ragged
// edges are masked.
//
// TABLES, the resonance tables K2 and the f64 kernel's ESCAPE mode read:
// not a TPU kernel. The JAX package builds them in one lax.scan
// (astroz_tpu/ops/fast.py:138 _resonance_tables); the plain version
// (ops/fast.py:resonance_tables_reference) steps n_steps + 1 times through
// ~60 small torch ops. One thread a (deep lane, direction) walks the
// dependent 720-minute steps with the f64 state in registers and writes
// its rows of the (5, 2 (n_steps + 1), D) table: the same operations in
// the same order, the f32 series on K2's polynomial sincos. Bound: the
// steps are a chain on one thread, ~150 f32 and ~20 f64 operations each,
// over ~1,300 threads at the headline catalog: microseconds of work, so a
// launch is latency and launch overhead, not bytes (267 KB out at depth 4).

#include "sgp4_common.cuh"

namespace {

constexpr int BLOCK = 128;  // deep satellites per block
// blocks an SM that __launch_bounds__ asks registers for (the fields
// live in shared memory, 30 KB a block, so at most 7 fit; 6 is faster)
constexpr int DEEP_MIN_BLOCKS = 6;

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

// K2's inputs and outputs
struct DeepArgs {
  const double* t_time;  // (T,) f64
  const double* t_sat;   // (D,) f64
  const double* spine;   // (13, D) f64
  const float* tail;     // (33, D) f32
  const int* flags;      // (2, D) i32
  const double* tables;  // (5, 2 * (n_steps + 1), D) f64
  int n_times, n_deep, n_steps;
  float j2, re, vkmpersec, xke, j3oj2;
  float* r;
  float* v;
  int* err;
};

// one point of fast.deep_spine_f64 + fast.deep_tail_f32 at t minutes from
// the epoch of deep satellite d; sp[k] is DEEP_SPINE_FIELD_NAMES[k], tf[k]
// DEEP_FIELD_NAMES[k] (SharedFields), each read where it is used
template <bool WANT_VEL, int ITERS, class SpineFields, class TailFields>
__device__ __forceinline__ PosVel deep_point(double t, const SpineFields& sp,
                                             const TailFields& tf, int irez,
                                             int error0, int d,
                                             const DeepArgs& a) {
  const size_t nd = (size_t)a.n_deep;
  const int n_steps = a.n_steps;
  // ---- f64 deep spine (fast.deep_spine_f64) --------------------------------
  const double mo = sp[0], mdot = sp[1], dmdt = sp[2], argpo = sp[3];
  const double argpdot = sp[4], domdt = sp[5], nodeo = sp[6];
  const double nodedot = sp[7], dnodt = sp[8], nodecf = sp[9];
  const double no_unkozai = sp[10], t2cof = sp[11];
  const double xmdf = mo + (mdot + dmdt) * t;
  const double argpdf = argpo + (argpdot + domdt) * t;
  const double t2 = t * t;
  const double nodem64 = nodeo + (nodedot + dnodt) * t + nodecf * t2;
  const double templ_big = no_unkozai * t2 * t2cof;
  double mm_spine = xmdf;
  double nm64 = no_unkozai;
  if (irez != 0) {
    // fast.resonance_from_tables: exact floor division, then the row
    const double at = fabs(t);
    double k = (at - fmod_exact(at, STEPP, 1.0 / STEPP)) / STEPP;
    k = (k > (double)n_steps) ? (double)n_steps : k;
    const int row = (int)k + (t < 0.0 ? n_steps + 1 : 0);
    // the five tables, ops/fast.py RESONANCE_TABLE_NAMES, `table` apart
    const size_t table = (size_t)(2 * (n_steps + 1)) * nd;
    const double* tb = a.tables + (size_t)row * nd + d;
    const double xli = tb[0], xni = tb[table], xndt = tb[2 * table];
    const double xldot = tb[3 * table], xnddt = tb[4 * table];
    const double atime = k * (t > 0.0 ? STEPP : -STEPP);
    const double ft = t - atime;
    nm64 = xni + xndt * ft + xnddt * ft * ft * 0.5;
    const double xl = xli + xldot * ft + xndt * ft * ft * 0.5;
    const double gsto = sp[12];
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

  // ---- simplified drag, am from the resonance nm (fast.deep_tail_f32) ----
  int error = error0;
  const float cc1 = tf[0], bstar = tf[1], cc4 = tf[2];
  const float tempa = 1.0f - cc1 * t32;
  const float tempe = bstar * cc4 * t32;
  const bool bad_nm = nm_deep <= 0.0f;
  if (bad_nm && error == 0) error = 2;
  const float a_base = pow23(a.xke / (bad_nm ? F32(1e-8) : nm_deep));
  const float am = a_base * tempa * tempa;
  const float am_safe = am > 0.0f ? am : 1.0f;
  const float rsq_am = 1.0f / sqrtf(am_safe);

  const float ecco = tf[3], inclo = tf[4], dedt = tf[5], didt = tf[6];
  float em = ecco - tempe + dedt * t32;
  const float inclm = inclo + didt * t32;
  if ((em >= 1.0f || em < F32(-0.001)) && error == 0) error = 1;
  em = clampf(em, F32(1.0e-6), F32(0.999999));

  // ---- lunisolar periodics (fast._dpper_core) ------------------------------
  // coefficients: DPPER_FIELD_NAMES from row 7
  float sin_node, cos_node;
  sincos_poly(nodep, sin_node, cos_node);
  float szm, unused, sinzf, coszf;
  float zm = tf[7] + ZNS * t32;  // zmos
  sincos_poly(zm, szm, unused);
  float zf = zm + 2.0f * ZES * szm;
  sincos_poly(zf, sinzf, coszf);
  float f2 = 0.5f * sinzf * sinzf - 0.25f;
  float f3 = -0.5f * sinzf * coszf;
  const float se2 = tf[8], se3 = tf[9], si2 = tf[10], si3 = tf[11];
  const float sl2 = tf[12], sl3 = tf[13], sl4 = tf[14];
  const float sgh2 = tf[15], sgh3 = tf[16], sgh4 = tf[17];
  const float sh2 = tf[18], sh3 = tf[19];
  const float ses = se2 * f2 + se3 * f3;
  const float sis = si2 * f2 + si3 * f3;
  const float sls = sl2 * f2 + sl3 * f3 + sl4 * sinzf;
  const float sghs = sgh2 * f2 + sgh3 * f3 + sgh4 * sinzf;
  const float shs = sh2 * f2 + sh3 * f3;

  zm = tf[20] + ZNL * t32;  // zmol
  sincos_poly(zm, szm, unused);
  zf = zm + 2.0f * ZEL * szm;
  sincos_poly(zf, sinzf, coszf);
  f2 = 0.5f * sinzf * sinzf - 0.25f;
  f3 = -0.5f * sinzf * coszf;
  const float ee2 = tf[21], e3 = tf[22], xi2 = tf[23], xi3 = tf[24];
  const float xl2 = tf[25], xl3 = tf[26], xl4 = tf[27];
  const float xgh2 = tf[28], xgh3 = tf[29], xgh4 = tf[30];
  const float xh2 = tf[31], xh3 = tf[32];
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

  // ---- per-point inclination-dependent coefficients --------------------
  sincos_poly(xincp, sinip, cosip);
  const float aycof = -0.5f * a.j3oj2 * sinip;
  const bool near180 = fabsf(cosip + 1.0f) > F32(1.5e-12);
  const float denom = near180 ? 1.0f + cosip : F32(1.5e-12);
  const float xlcof =
      -0.25f * a.j3oj2 * sinip * (3.0f + 5.0f * cosip) / denom;
  const float cosisq = cosip * cosip;
  const float con41 = 3.0f * cosisq - 1.0f;
  const float x1mth2 = 1.0f - cosisq;
  const float x7thm1 = 7.0f * cosisq - 1.0f;

  // ---- long-period terms -> Kepler -> TEME (fast._kepler_posvel_f32) ---
  return kepler_posvel<WANT_VEL, ITERS>(
      u, am, am_safe, rsq_am, ep, argpp, sin_node, cos_node, sinip, cosip,
      aycof, xlcof, con41, x1mth2, x7thm1, error, a.j2, a.re, a.vkmpersec);
}

// K2: each warp walks its run of (warp column, time row) units
// (sgp4_common.cuh: warp_run); a thread owns one deep satellite of the
// column and keeps its fields in shared memory.
template <bool WANT_VEL, int ITERS>
__global__ void __launch_bounds__(BLOCK, DEEP_MIN_BLOCKS)
sgp4_deep_kernel(const DeepArgs a) {
  __shared__ double spine_rows[N_SPINE][BLOCK];
  __shared__ float tail_rows[N_TAIL][BLOCK];
  SharedFields<double, N_SPINE, BLOCK> sp{spine_rows};
  SharedFields<float, N_TAIL, BLOCK> tf{tail_rows};
  const int n_times = a.n_times, n_deep = a.n_deep;
  const size_t nd = (size_t)n_deep;
  const size_t plane = (size_t)n_times * nd;
  const WarpRun run =
      warp_run((long long)((n_deep + WARP - 1) / WARP) * n_times);
  if (run.count == 0) return;
  int col = (int)(run.first / n_times);
  int ti = (int)(run.first % n_times);
  int d = col * WARP + (int)(threadIdx.x % WARP);
  int loaded = -1;
  int irez = 0, error0 = 0;
  double epoch = 0.0;
  for (long long k = run.count; k > 0; --k) {
    if (col != loaded) {
      if (d < n_deep) {
        sp.load(a.spine, nd, d);
        tf.load(a.tail, nd, d);
        irez = a.flags[d];
        error0 = a.flags[nd + d];
        epoch = a.t_sat[d];
      }
      loaded = col;
    }
    if (d < n_deep) {
      const PosVel o = deep_point<WANT_VEL, ITERS>(a.t_time[ti] - epoch, sp,
                                                   tf, irez, error0, d, a);
      store_point<WANT_VEL>(o, (size_t)ti * nd + d, plane, a.r, a.v, a.err);
    }
    if (++ti == n_times) {
      ti = 0;
      ++col;
      d += WARP;
    }
  }
}

// the persistent grid of one instantiation, then (with `launch`) the
// launch on it
template <bool WANT_VEL, int ITERS>
cudaError_t deep_run(const DeepArgs& a, cudaStream_t stream, bool launch,
                     Grid* g) {
  static int per_sm = 0;  // this instantiation's blocks an SM
  const long long units =
      (long long)((a.n_deep + WARP - 1) / WARP) * a.n_times;
  const cudaError_t rc = persistent_grid(sgp4_deep_kernel<WANT_VEL, ITERS>,
                                         BLOCK, per_sm, units, g);
  if (rc != cudaSuccess || !launch || g->blocks == 0) return rc;
  sgp4_deep_kernel<WANT_VEL, ITERS><<<g->blocks, BLOCK, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool WANT_VEL>
cudaError_t deep_iters(int kepler_iters, const DeepArgs& a,
                       cudaStream_t stream, bool launch, Grid* g) {
  switch (kepler_iters) {
    case 6: return deep_run<WANT_VEL, 6>(a, stream, launch, g);
    case 8: return deep_run<WANT_VEL, 8>(a, stream, launch, g);
    default: return cudaErrorInvalidValue;
  }
}

int deep(int want_vel, int kepler_iters, const DeepArgs& a, void* stream,
         bool launch, int* grid) {
  Grid g{0, 0, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      want_vel ? deep_iters<true>(kepler_iters, a, st, launch, &g)
               : deep_iters<false>(kepler_iters, a, st, launch, &g);
  if (grid != nullptr) {
    grid[0] = g.per_sm;
    grid[1] = g.sms;
    grid[2] = g.blocks;
  }
  return static_cast<int>(rc);
}


// ---- TABLES: the resonance tables ------------------------------------------

constexpr int TABLE_BLOCK = 128;  // (lane, direction) walkers per block
constexpr double STEP2 = 259200.0;

// rows of the fields matrix, ops/cuda_sgp4.py RESONANCE_FIELD_NAMES
enum ResonanceField {
  RF_XLAMO, RF_NO_UNKOZAI, RF_ARGPO, RF_ARGPDOT, RF_XFACT, RF_DEL1, RF_DEL2,
  RF_DEL3, RF_D2201, RF_D2211, RF_D3210, RF_D3222, RF_D4410, RF_D4422,
  RF_D5220, RF_D5232, RF_D5421, RF_D5433, RF_IREZ, N_RESONANCE_FIELDS
};

// the phase constants of fast._resonance_derivs_fast's sc_shift, in the
// order FASX2, 2 FASX4, 3 FASX6, G22, G32, G44, G52, G54: the f32 rounding
// of the host's sin and cos of each (ops/cuda_sgp4.py RESONANCE_SHIFTS)
enum Shift { SH_FASX2, SH_FASX4, SH_FASX6, SH_G22, SH_G32, SH_G44, SH_G52,
             SH_G54, N_SHIFTS };
struct Shifts {
  float s[N_SHIFTS];
  float c[N_SHIFTS];
};

// sin/cos of (a + b)
__device__ __forceinline__ void sc_sum(float sa, float ca, float sb, float cb,
                                       float& s, float& c) {
  s = sa * cb + ca * sb;
  c = ca * cb - sa * sb;
}

// sin/cos of (x - the shift's constant)
__device__ __forceinline__ void sc_shift(float s, float c, const Shifts& k,
                                         int i, float& so, float& co) {
  so = s * k.c[i] - c * k.s[i];
  co = c * k.c[i] + s * k.s[i];
}

// fast._resonance_derivs_fast at (xli, xni, atime): xndt, xldot and
// xnddt * xldot
__device__ __forceinline__ void resonance_derivs(
    const double* f, long long stride, const Shifts& k, double xli,
    double xni, double atime, double& xndt, double& xldot, double& xnddt) {
  const float xli32 = __double2float_rn(rem_two_pi(xli));
  const float xomi32 = __double2float_rn(
      rem_two_pi(f[RF_ARGPO * stride] + f[RF_ARGPDOT * stride] * atime));
  float s_li, c_li, s_omi, c_omi;
  sincos_poly(xli32, s_li, c_li);
  const float s_2li = 2.0f * s_li * c_li;
  const float c_2li = 1.0f - 2.0f * s_li * s_li;
  sincos_poly(xomi32, s_omi, c_omi);
  const float s_2omi = 2.0f * s_omi * c_omi;
  const float c_2omi = 1.0f - 2.0f * s_omi * s_omi;
  float xndt32, xnddt32;
  if (f[RF_IREZ * stride] != 2.0) {
    // geosynchronous 3-term series (irez 1; irez 0 takes it too, its
    // del terms zero)
    float s_3li, c_3li, s1, c1, s2, c2, s3, c3;
    sc_sum(s_2li, c_2li, s_li, c_li, s_3li, c_3li);
    sc_shift(s_li, c_li, k, SH_FASX2, s1, c1);
    sc_shift(s_2li, c_2li, k, SH_FASX4, s2, c2);
    sc_shift(s_3li, c_3li, k, SH_FASX6, s3, c3);
    const float del1 = __double2float_rn(f[RF_DEL1 * stride]);
    const float del2 = __double2float_rn(f[RF_DEL2 * stride]);
    const float del3 = __double2float_rn(f[RF_DEL3 * stride]);
    xndt32 = del1 * s1 + del2 * s2 + del3 * s3;
    xnddt32 = del1 * c1 + 2.0f * del2 * c2 + 3.0f * del3 * c3;
  } else {
    // half-day 10-term series (irez 2), summed from 0 as Python's sum
    float s_[10], c_[10], s_ol, c_ol, s_nol, c_nol, s_2ol, c_2ol, s_2o2l,
        c_2o2l, s_o2l, c_o2l, s_no2l, c_no2l;
    sc_sum(s_omi, c_omi, s_li, c_li, s_ol, c_ol);
    sc_sum(-s_omi, c_omi, s_li, c_li, s_nol, c_nol);
    sc_sum(s_2omi, c_2omi, s_li, c_li, s_2ol, c_2ol);
    sc_sum(s_2omi, c_2omi, s_2li, c_2li, s_2o2l, c_2o2l);
    sc_sum(s_omi, c_omi, s_2li, c_2li, s_o2l, c_o2l);
    sc_sum(-s_omi, c_omi, s_2li, c_2li, s_no2l, c_no2l);
    sc_shift(s_2ol, c_2ol, k, SH_G22, s_[0], c_[0]);
    sc_shift(s_li, c_li, k, SH_G22, s_[1], c_[1]);
    sc_shift(s_ol, c_ol, k, SH_G32, s_[2], c_[2]);
    sc_shift(s_nol, c_nol, k, SH_G32, s_[3], c_[3]);
    sc_shift(s_2o2l, c_2o2l, k, SH_G44, s_[4], c_[4]);
    sc_shift(s_2li, c_2li, k, SH_G44, s_[5], c_[5]);
    sc_shift(s_ol, c_ol, k, SH_G52, s_[6], c_[6]);
    sc_shift(s_nol, c_nol, k, SH_G52, s_[7], c_[7]);
    sc_shift(s_o2l, c_o2l, k, SH_G54, s_[8], c_[8]);
    sc_shift(s_no2l, c_no2l, k, SH_G54, s_[9], c_[9]);
    xndt32 = 0.0f;
    xnddt32 = 0.0f;
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      const float d = __double2float_rn(f[(RF_D2201 + i) * stride]);
      xndt32 = __fadd_rn(xndt32, d * s_[i]);
      // terms 4, 5, 8, 9 carry 2 li: their derivative takes 2.0
      const float dc = d * c_[i];
      xnddt32 = __fadd_rn(xnddt32, (i == 4 || i == 5 || i == 8 || i == 9)
                                       ? dc * 2.0f : dc);
    }
  }
  xndt = static_cast<double>(xndt32);
  xldot = xni + f[RF_XFACT * stride];
  xnddt = static_cast<double>(xnddt32) * xldot;
}

__global__ void __launch_bounds__(TABLE_BLOCK)
    resonance_tables_kernel(const double* fields, int n_deep, int n_steps,
                            const Shifts k, double* tables) {
  const int i = blockIdx.x * TABLE_BLOCK + threadIdx.x;
  if (i >= 2 * n_deep) return;
  const int lane = i % n_deep, dir = i / n_deep;
  const long long D = n_deep, rows = 2LL * (n_steps + 1);
  const double* f = fields + lane;
  const double delt = dir == 0 ? STEPP : -STEPP;
  double xli = __dadd_rn(f[RF_XLAMO * D], 0.0);
  double xni = __dadd_rn(f[RF_NO_UNKOZAI * D], 0.0);
  double atime = 0.0;
  double* out = tables + static_cast<long long>(dir) * (n_steps + 1) * D
                + lane;
  for (int s = 0; s <= n_steps; ++s) {
    double xndt, xldot, xnddt;
    resonance_derivs(f, D, k, xli, xni, atime, xndt, xldot, xnddt);
    double* o = out + s * D;
    o[0] = xli;
    o[rows * D] = xni;
    o[2 * rows * D] = xndt;
    o[3 * rows * D] = xldot;
    o[4 * rows * D] = xnddt;
    const double xli_next = xli + xldot * delt + xndt * STEP2;
    xni = xni + xndt * delt + xnddt * STEP2;
    xli = xli_next;
    atime = atime + delt;
  }
}

}  // namespace

// Plain C entry points (bound with ctypes by astroz_tpu_torch/_build.py).
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
  const DeepArgs a{t_time,  t_sat, spine, tail,      flags, tables,
                   n_times, n_deep, n_steps, j2,     re,    vkmpersec,
                   xke,     j3oj2, r,     v,         err};
  return deep(want_vel, kepler_iters, a, stream, true, nullptr);
}

// K2's grid at (n_times, n_deep) without a launch: grid[0] blocks an SM
// of the instantiation, grid[1] the card's SMs, grid[2] blocks launched
extern "C" int astroz_sgp4_deep_grid(int n_times, int n_deep,
                                     int kepler_iters, int want_vel,
                                     int* grid) {
  DeepArgs a{};
  a.n_times = n_times;
  a.n_deep = n_deep;
  return deep(want_vel, kepler_iters, a, nullptr, false, grid);
}

// TABLES. fields (19, D) f64, rows ops/cuda_sgp4.py RESONANCE_FIELD_NAMES
// (irez as f64); shifts: a host array of 16 f32, the sines of the 8 phase
// constants, then their cosines; tables (5, 2 * (n_steps + 1), D) f64,
// rows ops/fast.py RESONANCE_TABLE_NAMES, forward steps first. Launches on
// `stream` and returns the launch's cudaError_t.
extern "C" int astroz_resonance_tables(const double* fields, int n_deep,
                                       int n_steps, const float* shifts,
                                       double* tables, void* stream) {
  if (n_deep <= 0) return 0;
  if (n_steps < 0) return static_cast<int>(cudaErrorInvalidValue);
  Shifts k;
  for (int i = 0; i < N_SHIFTS; ++i) {
    k.s[i] = shifts[i];
    k.c[i] = shifts[N_SHIFTS + i];
  }
  const int blocks = (2 * n_deep + TABLE_BLOCK - 1) / TABLE_BLOCK;
  resonance_tables_kernel<<<blocks, TABLE_BLOCK, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      fields, n_deep, n_steps, k, tables);
  return static_cast<int>(cudaGetLastError());
}
