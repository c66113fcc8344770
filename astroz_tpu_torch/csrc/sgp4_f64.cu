// Full-f64 SGP4/SDP4 at independent points, for Hopper: the f64 kernel.
//
// Not a TPU kernel. The JAX package runs its f64 propagators as XLA
// programs that it jits around the Pallas kernels: the HEO escape inside
// _propagate_fast_fused (astroz_tpu/propagation.py:996, the escape at
// :918 and :1047, ops/fast.py:1052 sdp4_propagate_tables), and
// propagate(method="f64") (_propagate_shallow :814, _propagate_mixed
// :822, the scan at ops/sdp4.py:841). This file computes, per point, what
// the port's plain f64 functions compute, bit for bit on the card:
//   DENSE   ops/sgp4.py sgp4_propagate (a near-earth catalog, remainder
//           reductions) or ops/sdp4.py sdp4_propagate (a catalog with deep
//           lanes: SDP4 semantics on every lane, fmod reductions) at
//           tsince (T, C) minutes, C the catalog's S lanes or 1, or one
//           lane against a (T, C) grid; or, from a sweep's (T,) jd and fr
//           rows, at the tsince ((jd[t] - epoch_jd) + fr[t]) * 1440 of
//           each lane's epoch_jd, formed in the walk point by point (no
//           (T, S) grid is written or read); r, v (T, N, 3) f64, err
//           (T, N) i32
//   ESCAPE  ops/fast.py sdp4_propagate_tables over the HEO escape lanes,
//           tsince = t_time[t] - t_sat[x], the resonance read from the
//           deep subset's tables at column idx[x]; r, v cast to f32 and
//           written straight into kernel K2's (3, T, D) planes at
//           column idx[x], the codes into its (T, D) plane
// Codes 2, 1 and 3 (each only where no code is set yet), then 4 and 6, over
// the init error; failed points zero-filled. ops/sdp4.py
// sdp4_propagate_scan (propagate's scan_times=True) has no mode of its
// own: every row of the plain scan is sdp4_propagate at that row alone,
// and the row walk carries the resonance along each thread's run of rows
// (see below), so DENSE in SDP4 mode on the sweep's jd and fr rows gives
// the scan's bits in one launch (ops/cuda_sgp4.py sgp4_f64_scan).
//
// How the bits are kept. The plain versions are chains of torch ops, one
// rounding each, on CUDA:
// - this file is built with --fmad=true (astroz_tpu_torch/_build.py), as
//   torch's own kernels are: libdevice's f64 pow gives torch's bits only
//   when contraction is on. Its own arithmetic goes through the D type
//   below, whose operators are the rounded intrinsics __dadd_rn,
//   __dmul_rn, ..., which are never contracted, so every + - * / rounds
//   once as a torch op does; sin, cos, atan2 and pow are libdevice's, as
//   torch's are;
// - a python float divisor is a multiply by its reciprocal on CUDA
//   (torch's div with a CPU scalar): x / xke is x * (1 / xke); a python
//   float divided by a tensor is Tensor.__rtruediv__, reciprocal then
//   multiply: xke / x is (1 / x) * xke;
// - x ** 3 is (x * x) * x, x ** 1.5 and x ** (2/3) are pow;
// - DENSE's tsince from the jd and fr rows is torch's grid of
//   ops/cuda_sgp4.py epoch_tsince, ((jd - epoch_jd) + fr) * 1440: a
//   subtract, an add and a multiply by 1440, each rounded once, in that
//   order, so every point gets the bits of the grid torch would write;
// - torch.remainder is fmod, then + 2pi where the result is below zero
//   (sgp4_common.cuh rem_two_pi), torch.fmod is exact (fmod_exact);
// - torch's Newton loop runs 10 trips and freezes a lane once its step is
//   under 1e-12, recomputing sin and cos of the frozen value: leaving the
//   loop there gives the same bits.
//
// Bound. The plain versions count 262 f64 operations a point on the
// headline mixed catalog in SDP4 mode and 238 on the 1year_1s grid in
// SGP4 mode (chip_smoke.count_ops: a divide, square root, sin, cos or pow
// counted as one, the Newton trips each point takes; SGP4 on near-earth
// lanes, SDP4 on deep ones), and a point stores 52 bytes (r, v, err), so
// the bound of chip_smoke.bound is the bytes: 0.350 ms at 13,478 x
// 1,440. It is out of reach: libdevice's sin, cos, pow and atan2 and the
// correctly rounded divides take tens of f64 instructions each, and the
// f64 pipe (132 SMs x 64 lanes) is the real limit. chip_smoke.kernel_report
// counts the row loop's f64 instructions (SASS) a point over that pipe.
//
// Design: DENSE is one row walk (sgp4_f64_walk_kernel). Each
// choice was timed in turns on an H100 80GB HBM3 at 700 W by
// shallow_variants.py (kernels replayed from a CUDA graph, the mixed
// catalog x 1,440 unless said), against the one-thread-a-point kernel it
// replaces (9.45 ms):
// - Slots by regime: the staging's flag row SLOT_LANE lists the lanes
//   near-earth first, then the deep ones by Lyddane branch and irez, in
//   catalog order within a group (ops/cuda_sgp4.py f64_slot_lanes), and
//   thread slot s computes lane SLOT_LANE[s], so a warp's lanes take one
//   side of the deep branch, of dpper's Lyddane branch and of the
//   resonance series (in catalog order 81.5% of a row's warps held a
//   deep lane): 2.76 ms against 5.78 in catalog order. The order only
//   moves which thread computes a lane.
// - A thread walks rows of one lane: the persistent balanced grid of
//   sgp4_common.cuh (warp_run) gives each warp a run of (warp column of
//   32 slots, time row) points; where the run enters a column, a thread
//   stages its lane's flags and the 32 fields of the near-earth body that
//   every point reads (epoch_jd among them, for the tsince of the jd and
//   fr rows, and the per-lane products bstar * cc4 and bstar * cc5,
//   which the plain chain forms before it meets t) in shared memory, 34
//   KB a block, read where they are used; the deep rows, read on the deep
//   warps alone, come from the matrix through L1.
// - Deep columns weigh 4: a warp column that holds a deep slot runs ~3x
//   the hot SASS instructions of a near-earth one (6,373 in the row loop
//   against ~2,000), so with every row weighing one unit its warps ran
//   long after the others (5.70 ms); a row of such a column weighs
//   F64_DEEP_WEIGHT units in the split, and their runs are that much
//   shorter: 2.76 ms (weight 8: 3.23). The column where the deep slots
//   start is found on the card (first_deep_column).
// - The resonance is carried along the run: ops/sdp4.py
//   integrate_resonance's state after k steps does not depend on the
//   target time, and its restart rule resets the carry where t lies
//   behind it or across epoch, so a carry resumed from the row before
//   gives the bits of stepping from epoch (tests/test_torch_f64_kernel.py
//   holds the plain functions to this); a run starts with a fresh carry.
//   DENSE steps O(rows) a resonant lane, not O(rows x |t| / 720): with
//   the epochs spread over +-7 days, 2.77 ms against 25.7. The scan's
//   rows are DENSE's on the same tsince: 0.478 ms at x 240 against the
//   serial walkers' 3.99.
// - Registers: __launch_bounds__ asks for 5 blocks an SM in SDP4 mode
//   (96 registers, 2.76 ms; 4 blocks at 128 registers 2.77) and 6 in
//   SGP4 mode (80 registers). SGP4 mode has nothing to carry and runs
//   the 1year_1s grid in 3.49 ms against the one-point kernel's 3.04:
//   the walk's state costs registers (80 and 116 B of spills against
//   68), 6 blocks an SM against 7; 7 blocks (72 registers) spill more
//   and take 3.61. A compiler fence at each row keeps the compiler from
//   holding the staged fields in registers across the rows: SGP4 mode's
//   spills 116 -> 32 B and 3.48 -> 3.40 ms, SDP4 mode unchanged.
// - DENSE on a sweep's jd and fr rows (propagate(method="f64")): the
//   walk reads jd[t] and fr[t], one address across a warp, and the
//   lane's epoch_jd from the staged body, in place of a (T, S) grid that
//   torch wrote in three passes (155 MB at 13,478 x 1,440) and the walk
//   read back: 2.689 ms a day's sweep against 3.055 for torch's grid and
//   DENSE on it (2.774 DENSE alone). The row source is a runtime field,
//   not a template axis: SDP4 mode keeps 96 registers (spill stores 456
//   -> 412 B with velocities, 436 -> 424 without), SGP4 mode 80 (32 B
//   with velocities, 16 -> 32 without).

#include <climits>

#include "sgp4_common.cuh"

namespace {

constexpr int BLOCK = 128;
// blocks an SM that __launch_bounds__ asks registers for, in SDP4 and in
// SGP4 mode (the body takes 34 KB of shared memory a block, so at most 6
// fit)
constexpr int F64_MIN_BLOCKS = 5;
constexpr int F64_SGP4_MIN_BLOCKS = 6;
// units a row of a warp column that holds a deep slot weighs in the
// balanced split of the row walk (a row of near-earth slots weighs one)
constexpr int F64_DEEP_WEIGHT = 4;

// The rows of the staged field matrix: the f64 fields of Sgp4Elements,
// then those of DeepElements, in their order (ops/cuda_sgp4.py
// F64_FIELD_NAMES, which tests/test_torch_f64_kernel.py holds to this
// list).
enum Field {
  NO_KOZAI, NO_UNKOZAI, ECCO, INCLO, NODEO, ARGPO, MO, BSTAR, EPOCH_JD,
  GSTO, A, ALTA, ALTP, MDOT, ARGPDOT, NODEDOT, NODECF, CC1, CC4, CC5, D2,
  D3, D4, T2COF, T3COF, T4COF, T5COF, OMGCOF, XMCOF, ETA, DELMO, SINMAO,
  AYCOF, XLCOF, CON41, X1MTH2, X7THM1,
  ZMOL, ZMOS, SE2, SE3, SI2, SI3, SL2, SL3, SL4, SGH2, SGH3, SGH4, SH2,
  SH3, EE2, E3, XI2, XI3, XL2, XL3, XL4, XGH2, XGH3, XGH4, XH2, XH3, DEDT,
  DIDT, DMDT, DNODT, DOMDT, DEL1, DEL2, DEL3, D2201, D2211, D3210, D3222,
  D4410, D4422, D5220, D5232, D5421, D5433, XFACT, XLAMO,
  N_FIELDS
};
// the rows of the staged flags (ops/cuda_sgp4.py F64_FLAG_NAMES): row k
// < SLOT_LANE at the lane; row SLOT_LANE at the slot, the lane that slot
// computes (the slot order)
enum Flag { ISIMP, IS_DEEP, IREZ, ERROR, SLOT_LANE, N_FLAGS };

// the three semantics
enum Mode { SGP4, SDP4, TABLES };

// An f64 value whose arithmetic rounds once an operation and is never
// contracted into a fused multiply-add (see above). No conversion back
// to double, so no builtin f64 arithmetic slips in.
struct D {
  double v;
  D() = default;
  __device__ __forceinline__ D(double x) : v(x) {}
};
__device__ __forceinline__ D operator+(D a, D b) { return __dadd_rn(a.v, b.v); }
__device__ __forceinline__ D operator-(D a, D b) { return __dsub_rn(a.v, b.v); }
__device__ __forceinline__ D operator*(D a, D b) { return __dmul_rn(a.v, b.v); }
__device__ __forceinline__ D operator/(D a, D b) { return __ddiv_rn(a.v, b.v); }
__device__ __forceinline__ D operator-(D a) { return -a.v; }
__device__ __forceinline__ bool operator<(D a, D b) { return a.v < b.v; }
__device__ __forceinline__ bool operator<=(D a, D b) { return a.v <= b.v; }
__device__ __forceinline__ bool operator>(D a, D b) { return a.v > b.v; }
__device__ __forceinline__ bool operator>=(D a, D b) { return a.v >= b.v; }
__device__ __forceinline__ bool operator==(D a, D b) { return a.v == b.v; }
__device__ __forceinline__ D sin(D a) { return ::sin(a.v); }
__device__ __forceinline__ D cos(D a) { return ::cos(a.v); }
__device__ __forceinline__ D atan2(D y, D x) { return ::atan2(y.v, x.v); }
__device__ __forceinline__ D sqrt(D a) { return __dsqrt_rn(a.v); }
__device__ __forceinline__ D fabs(D a) { return ::fabs(a.v); }
__device__ __forceinline__ D pow(D a, double e) { return ::pow(a.v, e); }
// torch.reciprocal
__device__ __forceinline__ D recip(D a) { return D(1.0) / a; }
// torch.fmod / torch.remainder by 2pi
__device__ __forceinline__ D fmod2pi(D a) { return fmod_two_pi(a.v); }
__device__ __forceinline__ D rem2pi(D a) { return rem_two_pi(a.v); }
// torch.clamp: NaN stays NaN
__device__ __forceinline__ D clamp(D x, D lo, D hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

constexpr double X2O3 = 2.0 / 3.0;
constexpr double PI = 3.141592653589793;
constexpr double TWO_PI = 2.0 * 3.141592653589793;
constexpr double INV_TEMP4 = 1.0 / 1.5e-12;  // "/ _TEMP4" on CUDA
// ops/sdp4.py constants
constexpr double ZES = 0.01675, ZEL = 0.05490;
constexpr double ZNS = 1.19459e-5, ZNL = 1.5835218e-4;
constexpr double TWO_ZES = 2.0 * ZES, TWO_ZEL = 2.0 * ZEL;
constexpr double RPTIM = 4.37526908801129966e-3;
constexpr double FASX2 = 0.13130908, FASX4 = 2.8843198, FASX6 = 0.37448087;
constexpr double G22 = 5.7686396, G32 = 0.95240898, G44 = 1.8014998;
constexpr double G52 = 1.0508330, G54 = 4.4108898;
constexpr double STEPP = 720.0, STEP2 = 259200.0;
constexpr double INV_STEPP = 1.0 / 720.0;  // "/ STEPP" on CUDA
constexpr double MINUTES_PER_DAY = 1440.0;

// The gravity model's numbers as the plain code forms them in Python
// (ops/cuda_sgp4.py _f64_consts)
struct Consts {
  double xke;        // grav.xke
  double inv_xke;    // 1 / grav.xke: "/ grav.xke" on CUDA
  double half_j2;    // 0.5 * grav.j2
  double re;         // grav.radius_earth_km
  double vkmpersec;  // re * grav.xke / 60.0
  double aycof_c;    // -0.5 * grav.j3oj2
  double xlcof_c;    // -0.25 * grav.j3oj2
};

// the near-earth body's fields, which every point of the row walk reads:
// rows NO_UNKOZAI..EPOCH_JD and MDOT..X7THM1 of the field matrix at body
// slots 0..31, then the per-lane products bstar * cc4 and bstar * cc5
// (EPOCH_JD for the points whose tsince the walk forms from the sweep's
// epochs)
constexpr int BSTAR_CC4 = 32, BSTAR_CC5 = 33, N_BODY = 34;
__host__ __device__ constexpr int body_slot(int k) {
  return k >= NO_UNKOZAI && k <= EPOCH_JD
             ? k - NO_UNKOZAI
         : k >= MDOT && k <= X7THM1 ? k - MDOT + (EPOCH_JD - NO_UNKOZAI + 1)
                                    : -1;
}
static_assert(body_slot(X7THM1) == BSTAR_CC4 - 1, "body slots");

// one lane's fields read where they are used: row k of the (F, stride)
// matrix at the lane (ESCAPE)
struct GlobalLane {
  const double* f;
  size_t stride;
  __device__ __forceinline__ D operator[](int k) const {
    return __ldg(f + (size_t)k * stride);
  }
  __device__ __forceinline__ D bstar_cc4() const {
    return (*this)[BSTAR] * (*this)[CC4];
  }
  __device__ __forceinline__ D bstar_cc5() const {
    return (*this)[BSTAR] * (*this)[CC5];
  }
};

// one lane's fields in the row walk: the body from the thread's column of
// shared memory, staged once a run (only the thread that owns a column
// writes and reads it, so no barrier is needed); the other rows from the
// matrix at the lane
struct StagedLane {
  const double* f;
  size_t stride;
  double (*body)[BLOCK];
  __device__ __forceinline__ D operator[](int k) const {
    return body_slot(k) >= 0 ? D(body[body_slot(k)][threadIdx.x])
                             : D(__ldg(f + (size_t)k * stride));
  }
  __device__ __forceinline__ D bstar_cc4() const {
    return body[BSTAR_CC4][threadIdx.x];
  }
  __device__ __forceinline__ D bstar_cc5() const {
    return body[BSTAR_CC5][threadIdx.x];
  }
  // the body of the lane at `f`
  __device__ __forceinline__ void stage() {
#pragma unroll
    for (int k = NO_UNKOZAI; k <= EPOCH_JD; ++k)
      body[body_slot(k)][threadIdx.x] = __ldg(f + (size_t)k * stride);
#pragma unroll
    for (int k = MDOT; k <= X7THM1; ++k)
      body[body_slot(k)][threadIdx.x] = __ldg(f + (size_t)k * stride);
    body[BSTAR_CC4][threadIdx.x] = ((*this)[BSTAR] * (*this)[CC4]).v;
    body[BSTAR_CC5][threadIdx.x] = ((*this)[BSTAR] * (*this)[CC5]).v;
  }
};

struct Flags {
  bool isimp, is_deep;
  int irez, error;
};

__device__ __forceinline__ Flags read_flags(const int* flags, size_t stride,
                                            size_t lane) {
  return {flags[ISIMP * stride + lane] != 0,
          flags[IS_DEEP * stride + lane] != 0, flags[IREZ * stride + lane],
          flags[ERROR * stride + lane]};
}

// one point's outputs, TEME km and km/s
struct Out {
  D r[3], v[3];
  int error;
};

// ---- ops/sgp4.py update_secular -------------------------------------------
struct Secular {
  D mm, argpm, nodem, tempa, tempe, templ;
};

template <class F>
__device__ __forceinline__ Secular update_secular(const F& L, bool isimp,
                                                  D t) {
  const D xmdf = L[MO] + L[MDOT] * t;
  const D argpdf = L[ARGPO] + L[ARGPDOT] * t;
  const D nodedf = L[NODEO] + L[NODEDOT] * t;
  const D t2 = t * t;
  Secular s;
  s.nodem = nodedf + L[NODECF] * t2;
  D tempa = D(1.0) - L[CC1] * t;
  const D tempe = L.bstar_cc4() * t;
  const D templ = L[T2COF] * t2;
  // higher-order drag on the non-simplified lanes
  s.mm = xmdf;
  s.argpm = argpdf;
  if (!isimp) {
    const D delomg = L[OMGCOF] * t;
    const D delmtemp = D(1.0) + L[ETA] * cos(xmdf);
    const D delm = L[XMCOF] * (delmtemp * delmtemp * delmtemp - L[DELMO]);
    const D tempd = delomg + delm;
    s.mm = xmdf + tempd;
    s.argpm = argpdf - tempd;
  }
  const D t3 = t2 * t;
  const D t4 = t3 * t;
  s.tempa = tempa - L[D2] * t2 - L[D3] * t3 - L[D4] * t4;
  s.tempe = tempe + (isimp ? D(0.0)
                           : L.bstar_cc5() * (sin(s.mm) - L[SINMAO]));
  s.templ = templ + L[T3COF] * t3 + L[T4COF] * t4 + t4 * t * L[T5COF];
  return s;
}

// ---- ops/sdp4.py _resonance_derivs -----------------------------------------
struct Derivs {
  D xndt, xldot, xnddt;
};

template <class F>
__device__ __forceinline__ Derivs resonance_derivs(const F& L, int irez,
                                                   D xli, D xni, D atime) {
  D xndt, xnddt;
  if (irez == 2) {
    const D xomi = L[ARGPO] + L[ARGPDOT] * atime;
    const D x2omi = xomi + xomi;
    const D x2li = xli + xli;
    const D a22 = x2omi + xli - G22, b22 = xli - G22;
    const D a32 = xomi + xli - G32, b32 = -xomi + xli - G32;
    const D a44 = x2omi + x2li - G44, b44 = x2li - G44;
    const D a52 = xomi + xli - G52, b52 = -xomi + xli - G52;
    const D a54 = xomi + x2li - G54, b54 = -xomi + x2li - G54;
    xndt = L[D2201] * sin(a22) + L[D2211] * sin(b22) + L[D3210] * sin(a32) +
           L[D3222] * sin(b32) + L[D4410] * sin(a44) + L[D4422] * sin(b44) +
           L[D5220] * sin(a52) + L[D5232] * sin(b52) + L[D5421] * sin(a54) +
           L[D5433] * sin(b54);
    xnddt = L[D2201] * cos(a22) + L[D2211] * cos(b22) + L[D3210] * cos(a32) +
            L[D3222] * cos(b32) + L[D5220] * cos(a52) + L[D5232] * cos(b52) +
            D(2.0) * (L[D4410] * cos(a44) + L[D4422] * cos(b44) +
                      L[D5421] * cos(a54) + L[D5433] * cos(b54));
  } else {
    const D a1 = xli - FASX2;
    const D a2 = D(2.0) * (xli - FASX4);
    const D a3 = D(3.0) * (xli - FASX6);
    xndt = L[DEL1] * sin(a1) + L[DEL2] * sin(a2) + L[DEL3] * sin(a3);
    xnddt = L[DEL1] * cos(a1) + D(2.0) * L[DEL2] * cos(a2) +
            D(3.0) * L[DEL3] * cos(a3);
  }
  const D xldot = xni + L[XFACT];
  return {xndt, xldot, xnddt * xldot};
}

// ---- ops/sdp4.py integrate_resonance, resumed from (atime, xli, xni) -------
// Returns the resonance mean motion and longitude at t; the carry moves to
// the state after the last step.
template <class F>
__device__ __forceinline__ void integrate_resonance(const F& L, int irez,
                                                    D t, D& atime, D& xli,
                                                    D& xni, D& nm_res,
                                                    D& xl) {
  if (atime == 0.0 || t * atime <= 0.0 || fabs(t) < fabs(atime)) {
    atime = 0.0;
    xli = L[XLAMO];
    xni = L[NO_UNKOZAI];
  }
  const D delt = t > 0.0 ? D(STEPP) : D(-STEPP);
  while (fabs(t - atime) >= STEPP) {
    const Derivs d = resonance_derivs(L, irez, xli, xni, atime);
    atime = atime + delt;
    xli = xli + d.xldot * delt + d.xndt * STEP2;
    xni = xni + d.xndt * delt + d.xnddt * STEP2;
  }
  const Derivs d = resonance_derivs(L, irez, xli, xni, atime);
  const D ft = t - atime;
  nm_res = xni + d.xndt * ft + d.xnddt * ft * ft * 0.5;
  xl = xli + d.xldot * ft + d.xndt * ft * ft * 0.5;
}

// The resonance of the row walk: resumed from the lane's carry of the row
// before; atime 0 (a fresh carry, ops/sdp4.py fresh_carry) restarts from
// epoch
struct FromCarry {
  D atime, xli, xni;
  template <class F>
  __device__ __forceinline__ void operator()(const F& L, int irez, D t,
                                             D& nm_res, D& xl) {
    integrate_resonance(L, irez, t, atime, xli, xni, nm_res, xl);
  }
};

// The resonance of ESCAPE, ops/fast.py resonance_from_tables: row k =
// min(floor(|t| / 720), n_steps), + n_steps + 1 when t < 0, of the five
// (2 (n_steps + 1), n_deep) tables, then the Euler-Maclaurin quadratic
struct FromTables {
  const double* tables;  // (5, 2 (n_steps + 1), n_deep) f64
  size_t col, n_deep;
  int n_steps;
  template <class F>
  __device__ __forceinline__ void operator()(const F&, int, D t, D& nm_res,
                                             D& xl) const {
    const D a = fabs(t);
    D k = (a - D(fmod_exact(a.v, STEPP, INV_STEPP))) * INV_STEPP;
    k = k > (double)n_steps ? D((double)n_steps) : k;
    const size_t row = (size_t)(long long)k.v + (t < 0.0 ? n_steps + 1 : 0);
    const size_t table = (size_t)(2 * (n_steps + 1)) * n_deep;
    const double* tb = tables + row * n_deep + col;
    const D xli = tb[0], xni = tb[table], xndt = tb[2 * table];
    const D xldot = tb[3 * table], xnddt = tb[4 * table];
    const D atime = k * (t > 0.0 ? D(STEPP) : D(-STEPP));
    const D ft = t - atime;
    nm_res = xni + xndt * ft + xnddt * ft * ft * 0.5;
    xl = xli + xldot * ft + xndt * ft * ft * 0.5;
  }
};

// ---- ops/sgp4.py kepler_and_posvel ----------------------------------------
template <bool WANT_VEL>
__device__ __forceinline__ Out kepler_and_posvel(
    const Consts& c, D am, D nm, D ep, D xincp, D nodep, D argpp, D mp,
    D aycof, D xlcof, D con41, D x1mth2, D x7thm1, int error) {
  const D sinip = sin(xincp), cosip = cos(xincp);
  const D axnl = ep * cos(argpp);
  const D temp0 = recip(am * (D(1.0) - ep * ep));
  const D aynl = ep * sin(argpp) + temp0 * aycof;
  const D xl = mp + argpp + nodep + temp0 * xlcof * axnl;
  const D u = rem2pi(xl - nodep);

  // ops/sgp4.py solve_kepler: 10 trips, a lane frozen once its step is
  // under 1e-12 (sin and cos of the frozen value do not change)
  D eo1 = u, sineo1 = sin(eo1), coseo1 = cos(eo1);
  for (int i = 0; i < 10; ++i) {
    const D denom = D(1.0) - coseo1 * axnl - sineo1 * aynl;
    const D tem5 = clamp((u - aynl * coseo1 + axnl * sineo1 - eo1) / denom,
                         -0.95, 0.95);
    eo1 = eo1 + tem5;
    sineo1 = sin(eo1);
    coseo1 = cos(eo1);
    if (fabs(tem5) < 1.0e-12) break;
  }

  const D ecose = axnl * coseo1 + aynl * sineo1;
  const D esine = axnl * sineo1 - aynl * coseo1;
  const D el2 = axnl * axnl + aynl * aynl;
  const D pl = am * (D(1.0) - el2);
  if (pl < 0.0 && error == 0) error = 4;
  const D pl_safe = pl > 0.0 ? pl : D(1.0);

  const D rl = am * (D(1.0) - ecose);
  const D rdotl = sqrt(am) * esine / rl;
  const D rvdotl = sqrt(pl_safe) / rl;
  const D betal = sqrt(fabs(D(1.0) - el2));
  const D temp = esine / (D(1.0) + betal);
  const D sinu = am / rl * (sineo1 - aynl - axnl * temp);
  const D cosu = am / rl * (coseo1 - axnl + aynl * temp);
  D su = atan2(sinu, cosu);
  const D sin2u = (cosu + cosu) * sinu;
  const D cos2u = D(1.0) - D(2.0) * sinu * sinu;
  const D tp = recip(pl_safe);
  const D temp1 = c.half_j2 * tp;
  const D temp2 = temp1 * tp;

  const D mrt = rl * (D(1.0) - D(1.5) * temp2 * betal * con41) +
                D(0.5) * temp1 * x1mth2 * cos2u;
  su = su - D(0.25) * temp2 * x7thm1 * sin2u;
  const D xnode = nodep + D(1.5) * temp2 * cosip * sin2u;
  const D xinc = xincp + D(1.5) * temp2 * cosip * sinip * cos2u;

  const D sinsu = sin(su), cossu = cos(su);
  const D snod = sin(xnode), cnod = cos(xnode);
  const D sini = sin(xinc), cosi = cos(xinc);
  const D xmx = -snod * cosi;
  const D xmy = cnod * cosi;
  const D ux = xmx * sinsu + cnod * cossu;
  const D uy = xmy * sinsu + snod * cossu;
  const D uz = sini * sinsu;

  if (mrt < 1.0 && error == 0) error = 6;
  const bool ok = error == 0;
  Out o;
  o.error = error;
  const D mrt_re = mrt * c.re;
  o.r[0] = ok ? mrt_re * ux : D(0.0);
  o.r[1] = ok ? mrt_re * uy : D(0.0);
  o.r[2] = ok ? mrt_re * uz : D(0.0);
  if (WANT_VEL) {
    const D mvt = rdotl - nm * temp1 * x1mth2 * sin2u * c.inv_xke;
    const D rvdot =
        rvdotl + nm * temp1 * (x1mth2 * cos2u + D(1.5) * con41) * c.inv_xke;
    const D vx = xmx * cossu - cnod * sinsu;
    const D vy = xmy * cossu - snod * sinsu;
    const D vz = sini * cossu;
    o.v[0] = ok ? c.vkmpersec * (mvt * ux + rvdot * vx) : D(0.0);
    o.v[1] = ok ? c.vkmpersec * (mvt * uy + rvdot * vy) : D(0.0);
    o.v[2] = ok ? c.vkmpersec * (mvt * uz + rvdot * vz) : D(0.0);
  }
  return o;
}

// ---- ops/sdp4.py dpper on a deep lane --------------------------------------
template <class F>
__device__ __forceinline__ void dpper(const F& L, D t, D& ep, D& inclp,
                                      D& nodep, D& argpp, D& mp) {
  // solar periodics
  D zm = L[ZMOS] + ZNS * t;
  D zf = zm + TWO_ZES * sin(zm);
  D sinzf = sin(zf);
  D f2 = D(0.5) * sinzf * sinzf - 0.25;
  D f3 = D(-0.5) * sinzf * cos(zf);
  const D ses = L[SE2] * f2 + L[SE3] * f3;
  const D sis = L[SI2] * f2 + L[SI3] * f3;
  const D sls = L[SL2] * f2 + L[SL3] * f3 + L[SL4] * sinzf;
  const D sghs = L[SGH2] * f2 + L[SGH3] * f3 + L[SGH4] * sinzf;
  const D shs = L[SH2] * f2 + L[SH3] * f3;
  // lunar periodics
  zm = L[ZMOL] + ZNL * t;
  zf = zm + TWO_ZEL * sin(zm);
  sinzf = sin(zf);
  f2 = D(0.5) * sinzf * sinzf - 0.25;
  f3 = D(-0.5) * sinzf * cos(zf);
  const D sel = L[EE2] * f2 + L[E3] * f3;
  const D sil = L[XI2] * f2 + L[XI3] * f3;
  const D sll = L[XL2] * f2 + L[XL3] * f3 + L[XL4] * sinzf;
  const D sghl = L[XGH2] * f2 + L[XGH3] * f3 + L[XGH4] * sinzf;
  const D shll = L[XH2] * f2 + L[XH3] * f3;

  const D pe = ses + sel;
  const D pinc = sis + sil;
  const D pl = sls + sll;
  const D pgh = sghs + sghl;
  const D ph = shs + shll;

  const D inclp_new = inclp + pinc;
  const D ep_new = ep + pe;
  const D sinip = sin(inclp_new), cosip = cos(inclp_new);
  if (inclp_new < 0.2) {
    // Lyddane path
    const D sinop = sin(nodep), cosop = cos(nodep);
    const D alfdp = sinip * sinop + ph * cosop + pinc * cosip * sinop;
    const D betdp = sinip * cosop - ph * sinop + pinc * cosip * cosop;
    const D nodep_w = fmod2pi(nodep);
    const D xls = mp + argpp + cosip * nodep_w + pl + pgh -
                  pinc * nodep_w * sinip;
    const D xnoh = nodep_w;
    D nodep_l = atan2(alfdp, betdp);
    const bool far = fabs(xnoh - nodep_l) > PI;
    if (far && nodep_l < xnoh) {
      nodep_l = nodep_l + TWO_PI;
    } else if (far && nodep_l >= xnoh) {
      nodep_l = nodep_l - TWO_PI;
    }
    const D mp_l = mp + pl;
    argpp = xls - mp_l - cosip * nodep_l;
    nodep = nodep_l;
    mp = mp_l;
  } else {
    const D sin_safe = fabs(sinip) > 1e-12 ? sinip : D(1e-12);
    const D ph_n = ph / sin_safe;
    const D pgh_n = pgh - cosip * ph_n;
    argpp = argpp + pgh_n;
    nodep = nodep + ph_n;
    mp = mp + pl;
  }
  ep = ep_new;
  inclp = inclp_new;
}

// ---- one point ---------------------------------------------------------------
// SGP4: ops/sgp4.py sgp4_propagate. SDP4: ops/sdp4.py sdp4_propagate (dspace,
// then sdp4_finish), the resonance from `res`. TABLES: ops/fast.py
// sdp4_propagate_tables (then sdp4_finish), the resonance from `res`.
template <int MODE, bool WANT_VEL, class F, class Res>
__device__ __forceinline__ Out f64_point(D t, const F& L, const Flags& fl,
                                         const Consts& c, Res& res) {
  const Secular s = update_secular(L, fl.isimp, t);
  D mm = s.mm, argpm = s.argpm, nodem = s.nodem, nm, em, inclm;
  if (MODE == SGP4) {
    nm = L[NO_UNKOZAI];
    em = L[ECCO];
    inclm = L[INCLO];
  } else if (MODE == TABLES) {
    const D theta = fmod2pi(L[GSTO] + t * RPTIM);
    em = L[ECCO] + L[DEDT] * t;
    inclm = L[INCLO] + L[DIDT] * t;
    argpm = argpm + L[DOMDT] * t;
    nodem = nodem + L[DNODT] * t;
    mm = mm + L[DMDT] * t;
    nm = L[NO_UNKOZAI];
    if (fl.irez != 0) {
      D nm_res, xl;
      res(L, fl.irez, t, nm_res, xl);
      mm = fl.irez == 1 ? xl - nodem - argpm + theta
                        : xl - D(2.0) * nodem + D(2.0) * theta;
      nm = nm_res;
    }
  } else {
    nm = L[NO_UNKOZAI] + 0.0;
    em = L[ECCO] + 0.0;
    inclm = L[INCLO] + 0.0;
    if (fl.is_deep) {
      // ops/sdp4.py dspace
      const D theta = fmod2pi(L[GSTO] + t * RPTIM);
      em = em + L[DEDT] * t;
      inclm = inclm + L[DIDT] * t;
      argpm = argpm + L[DOMDT] * t;
      nodem = nodem + L[DNODT] * t;
      mm = mm + L[DMDT] * t;
      if (fl.irez != 0) {
        D nm_res, xl;
        res(L, fl.irez, t, nm_res, xl);
        mm = fl.irez == 1 ? xl - nodem - argpm + theta
                          : xl - D(2.0) * nodem + D(2.0) * theta;
        nm = nm_res;
      }
    }
  }

  // the drag-updated elements (sgp4_propagate; sdp4_finish's head)
  int error = fl.error;
  if (nm <= 0.0 && error == 0) error = 2;
  const D nm_safe = nm > 0.0 ? nm : D(1e-8);
  const D am = pow(recip(nm_safe) * c.xke, X2O3) * s.tempa * s.tempa;
  nm = recip(pow(am > 0.0 ? am : D(1.0), 1.5)) * c.xke;
  em = em - s.tempe;
  if ((em >= 1.0 || em < -0.001) && error == 0) error = 1;
  em = clamp(em, 1.0e-6, 0.999999);
  mm = mm + L[NO_UNKOZAI] * s.templ;
  D xlm = mm + argpm + nodem;
  if (MODE == SGP4) {
    nodem = rem2pi(nodem);
    argpm = rem2pi(argpm);
    xlm = rem2pi(xlm);
    mm = rem2pi(xlm - argpm - nodem);
    return kepler_and_posvel<WANT_VEL>(
        c, am, nm, em, inclm, nodem, argpm, mm, L[AYCOF], L[XLCOF], L[CON41],
        L[X1MTH2], L[X7THM1], error);
  }
  nodem = fmod2pi(nodem);
  argpm = fmod2pi(argpm);
  xlm = fmod2pi(xlm);
  mm = fmod2pi(xlm - argpm - nodem);

  // ops/sdp4.py sdp4_finish: lunisolar periodics on deep lanes
  D ep = em, xincp = inclm, nodep = nodem, argpp = argpm, mp = mm;
  if (fl.is_deep) dpper(L, t, ep, xincp, nodep, argpp, mp);
  if (xincp < 0.0) {
    nodep = nodep + PI;
    argpp = argpp - PI;
  }
  xincp = fabs(xincp);
  if ((ep < 0.0 || ep > 1.0) && error == 0) error = 3;
  ep = clamp(ep, 1e-12, 0.999999);

  // per-point inclination-dependent coefficients on deep lanes
  D aycof = L[AYCOF], xlcof = L[XLCOF], con41 = L[CON41];
  D x1mth2 = L[X1MTH2], x7thm1 = L[X7THM1];
  if (fl.is_deep) {
    const D sinip = sin(xincp), cosip = cos(xincp);
    aycof = c.aycof_c * sinip;
    const D num = c.xlcof_c * sinip * (D(3.0) + D(5.0) * cosip);
    xlcof = fabs(cosip + 1.0) > 1.5e-12 ? num / (D(1.0) + cosip)
                                        : num * INV_TEMP4;
    const D cosisq = cosip * cosip;
    con41 = D(3.0) * cosisq - 1.0;
    x1mth2 = D(1.0) - cosisq;
    x7thm1 = D(7.0) * cosisq - 1.0;
  }
  return kepler_and_posvel<WANT_VEL>(c, am, nm, ep, xincp, nodep, argpp, mp,
                                     aycof, xlcof, con41, x1mth2, x7thm1,
                                     error);
}

// one point of the time-major (T, N, 3) r, v and (T, N) codes, f64
template <bool WANT_VEL>
__device__ __forceinline__ void store_f64(const Out& o, size_t p, double* r,
                                          double* v, int* err) {
  double* rp = r + 3 * p;
  rp[0] = o.r[0].v;
  rp[1] = o.r[1].v;
  rp[2] = o.r[2].v;
  if (WANT_VEL) {
    double* vp = v + 3 * p;
    vp[0] = o.v[0].v;
    vp[1] = o.v[1].v;
    vp[2] = o.v[2].v;
  }
  err[p] = o.error;
}

// DENSE's inputs and outputs
struct GridArgs {
  // point (t, n) at t * t_row + n * t_col: its tsince, or with `fr` the
  // jd of its epoch (t_row 1, t_col 0)
  const double* tsince;
  long long t_row, t_col;
  // null, or the (T,) fr row of the sweep's epochs: point (t, n) then takes
  // tsince ((jd[t] - epoch_jd) + fr[t]) * 1440 of its lane's epoch_jd
  const double* fr;
  const double* fields;  // (F, n_lanes) f64
  const int* flags;      // (N_FLAGS, n_lanes) i32
  long long n_lanes;     // S
  long long lane_step;   // 1: column n is lane SLOT_LANE[slot n]; 0: lane 0
  long long n_times, n_out;  // T, N
  Consts c;
  double* r;  // (T, N, 3) f64
  double* v;  // (T, N, 3) f64, or null
  int* err;   // (T, N) i32
};

// The first warp column of the slot order that holds a deep slot (the
// order puts them last), or n_cols: the slot of each column's last thread
// searched in halves
__device__ __forceinline__ int first_deep_column(const GridArgs& a,
                                                 int n_cols) {
  const size_t S = (size_t)a.n_lanes;
  int lo = 0, hi = n_cols;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    const int last = min(mid * WARP + WARP - 1, (int)a.n_out - 1);
    const int lane = a.flags[SLOT_LANE * S + last];
    if (a.flags[IS_DEEP * S + lane] != 0) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// DENSE: the points (warp column, time row), column after column,
// are cut into balanced runs (sgp4_common.cuh: warp_run), a row of a
// column that holds a deep slot weighing F64_DEEP_WEIGHT units, of the
// others one, and each warp walks the points whose units start in its
// run; thread slot s of a column computes the output column of its slot
// at the column's rows in the run, staging the lane once and carrying the
// resonance from row to row
template <int MODE, bool WANT_VEL>
__global__ void __launch_bounds__(
    BLOCK, MODE == SGP4 ? F64_SGP4_MIN_BLOCKS : F64_MIN_BLOCKS)
sgp4_f64_walk_kernel(const GridArgs a) {
  __shared__ double body[N_BODY][BLOCK];
  constexpr int W = F64_DEEP_WEIGHT;
  const int n_times = (int)a.n_times, n_out = (int)a.n_out;
  const int n_cols = (n_out + WARP - 1) / WARP;
  const int heavy =
      MODE == SDP4 && a.lane_step ? first_deep_column(a, n_cols) : n_cols;
  const long long light = (long long)heavy * n_times;
  const WarpRun run =
      warp_run(light + (long long)(n_cols - heavy) * n_times * W);
  const long long end = run.first + run.count;
  // the first point whose units start at or after the run's first
  const long long p = run.first <= light
                          ? run.first
                          : light + (run.first - light + W - 1) / W;
  long long pos = p <= light ? p : light + (p - light) * W;
  int col = (int)(p / max(n_times, 1));
  int ti = (int)(p % max(n_times, 1));
  const size_t S = (size_t)a.n_lanes;
  for (; pos < end; ++col, ti = 0) {
    const int w = col < heavy ? 1 : W;
    // the column's rows whose units start in the run
    const int rows =
        (int)min((long long)(n_times - ti), (end - pos + w - 1) / w);
    pos += (long long)rows * w;
    const int slot = col * WARP + (int)(threadIdx.x % WARP);
    if (slot >= n_out) continue;
    const int n = a.lane_step ? a.flags[SLOT_LANE * S + slot] : slot;
    const size_t lane = (size_t)n * (size_t)a.lane_step;
    StagedLane L{a.fields + lane, S, body};
    L.stage();
    const Flags fl = read_flags(a.flags, S, lane);
    FromCarry carry{D(0.0), D(0.0), D(0.0)};
    const double* tp = a.tsince + ti * a.t_row + n * a.t_col;
    size_t q = (size_t)ti * n_out + n;
    for (int r = 0; r < rows; ++r, tp += a.t_row, q += n_out) {
      // a compiler fence: the staged fields are read again at each row
      // where they are used, not held in registers across the rows
      asm volatile("" ::: "memory");
      // the minutes since epoch of ops/cuda_sgp4.py epoch_tsince, torch's
      // three ops in their order
      const D t = a.fr == nullptr
                      ? D(*tp)
                      : (D(*tp) - L[EPOCH_JD] + D(a.fr[tp - a.tsince])) *
                            MINUTES_PER_DAY;
      const Out o = f64_point<MODE, WANT_VEL>(t, L, fl, a.c, carry);
      store_f64<WANT_VEL>(o, q, a.r, a.v, a.err);
    }
  }
}

// ESCAPE's inputs and outputs
struct EscapeArgs {
  const double* t_time;  // (T,) f64
  const double* t_sat;   // (X,) f64
  const double* fields;  // (F, X) f64
  const int* flags;      // (N_FLAGS, X) i32
  const int* idx;        // (X,) i32: the lane's column of the deep subset
  const double* tables;  // (5, 2 (n_steps + 1), D) f64
  long long n_times, n_esc, n_deep;
  int n_steps;
  Consts c;
  float* r;  // (3, T, D) f32 planes of K2
  float* v;  // (3, T, D) f32, or null
  int* err;  // (T, D) i32
};

template <bool WANT_VEL>
__global__ void __launch_bounds__(BLOCK) sgp4_f64_escape_kernel(
    const EscapeArgs a) {
  const long long p = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (p >= a.n_times * a.n_esc) return;
  const long long ti = p / a.n_esc, x = p % a.n_esc;
  const GlobalLane L{a.fields + x, (size_t)a.n_esc};
  const Flags fl = read_flags(a.flags, (size_t)a.n_esc, (size_t)x);
  const size_t col = (size_t)a.idx[x];
  FromTables res{a.tables, col, (size_t)a.n_deep, a.n_steps};
  const Out o = f64_point<TABLES, WANT_VEL>(D(a.t_time[ti]) - D(a.t_sat[x]),
                                            L, fl, a.c, res);
  const size_t plane = (size_t)a.n_times * (size_t)a.n_deep;
  const size_t q = (size_t)ti * (size_t)a.n_deep + col;
  for (int k = 0; k < 3; ++k) a.r[k * plane + q] = __double2float_rn(o.r[k].v);
  if (WANT_VEL) {
    for (int k = 0; k < 3; ++k)
      a.v[k * plane + q] = __double2float_rn(o.v[k].v);
  }
  a.err[q] = o.error;
}

int blocks_of(long long points) {
  return (int)((points + BLOCK - 1) / BLOCK);
}

template <class Kernel, class Args>
int launch(Kernel kernel, int blocks, const Args& a, void* stream) {
  if (blocks > 0) {
    kernel<<<blocks, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// the row walk's persistent grid of one instantiation, then (with
// `launch`) the launch on it
template <int MODE, bool WANT_VEL>
cudaError_t walk_run(const GridArgs& a, cudaStream_t stream, bool launch,
                     Grid* g) {
  static int per_sm = 0;  // this instantiation's blocks an SM
  // the units of the walk with every column weighed as one that holds a
  // deep slot (the kernel finds the columns that do)
  const long long units = (a.n_out + WARP - 1) / WARP * a.n_times *
                          (MODE == SDP4 && a.lane_step ? F64_DEEP_WEIGHT : 1);
  const cudaError_t rc = persistent_grid(
      sgp4_f64_walk_kernel<MODE, WANT_VEL>, BLOCK, per_sm, units, g);
  if (rc != cudaSuccess || !launch || g->blocks == 0) return rc;
  sgp4_f64_walk_kernel<MODE, WANT_VEL><<<g->blocks, BLOCK, 0, stream>>>(a);
  return cudaGetLastError();
}

int walk(int sdp4, int want_vel, const GridArgs& a, void* stream,
         bool launch, int* grid) {
  Grid g{0, 0, 0};
  // the walk counts rows and output columns in 32-bit ints
  if (a.n_times > INT_MAX || a.n_out > INT_MAX) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      sdp4 ? (want_vel ? walk_run<SDP4, true>(a, st, launch, &g)
                       : walk_run<SDP4, false>(a, st, launch, &g))
           : (want_vel ? walk_run<SGP4, true>(a, st, launch, &g)
                       : walk_run<SGP4, false>(a, st, launch, &g));
  if (grid != nullptr) {
    grid[0] = g.per_sm;
    grid[1] = g.sms;
    grid[2] = g.blocks;
  }
  return static_cast<int>(rc);
}

}  // namespace

// Plain C entry points (bound with ctypes by astroz_tpu_torch/_build.py).
// The Consts are the gravity model's numbers as ops/cuda_sgp4.py forms
// them; all tensors contiguous on the current device; each launches on
// `stream` and returns the launch's cudaError_t.

// DENSE: tsince (T, C) f64 read at t * t_row + n * t_col; fields (F, S)
// f64 (F = 37, or 83 with the deep rows, which sdp4 != 0 needs); flags
// (N_FLAGS, S) i32; output column n computes lane SLOT_LANE[slot n] when
// lane_step is 1, lane 0 when it is 0; r, v (T, N, 3) f64 (v null when
// want_vel == 0), err (T, N) i32.
extern "C" int astroz_sgp4_f64_dense(
    const double* tsince, long long t_row, long long t_col,
    const double* fields, const int* flags, long long n_lanes,
    long long lane_step, long long n_times, long long n_out, int sdp4,
    int want_vel, double xke, double inv_xke, double half_j2, double re,
    double vkmpersec, double aycof_c, double xlcof_c, double* r, double* v,
    int* err, void* stream) {
  const GridArgs a{tsince, t_row, t_col, nullptr, fields, flags, n_lanes,
                   lane_step, n_times, n_out,
                   Consts{xke, inv_xke, half_j2, re, vkmpersec, aycof_c,
                          xlcof_c},
                   r, v, err};
  return walk(sdp4, want_vel, a, stream, true, nullptr);
}

// DENSE on the sweep's epochs: jd, fr (T,) f64; point (t, n) at tsince
// ((jd[t] - epoch_jd) + fr[t]) * 1440 of the epoch_jd row of its lane,
// formed in the walk (no tsince grid); fields, flags, r, v, err as DENSE's
// with output column n computing lane SLOT_LANE[slot n] (N = S).
extern "C" int astroz_sgp4_f64_dense_epochs(
    const double* jd, const double* fr, const double* fields,
    const int* flags, long long n_lanes, long long n_times, int sdp4,
    int want_vel, double xke, double inv_xke, double half_j2, double re,
    double vkmpersec, double aycof_c, double xlcof_c, double* r, double* v,
    int* err, void* stream) {
  const GridArgs a{jd, 1, 0, fr, fields, flags, n_lanes, 1, n_times,
                   n_lanes,
                   Consts{xke, inv_xke, half_j2, re, vkmpersec, aycof_c,
                          xlcof_c},
                   r, v, err};
  return walk(sdp4, want_vel, a, stream, true, nullptr);
}

// The row walk's grid at (n_times, n_out) without a launch: grid[0] blocks
// an SM of the instantiation, grid[1] the card's SMs, grid[2] blocks
// launched
extern "C" int astroz_sgp4_f64_grid(long long n_times, long long n_out,
                                    int sdp4, int want_vel, int* grid) {
  GridArgs a{};
  a.n_times = n_times;
  a.n_out = n_out;
  return walk(sdp4, want_vel, a, nullptr, false, grid);
}

// ESCAPE: t_time (T,) f64; t_sat (X,) f64; fields (83, X) f64; flags (5, X)
// i32; idx (X,) i32 columns of the deep subset; tables (5, 2 (n_steps + 1),
// D) f64; writes the columns idx of r, v (3, T, D) f32 (v null when
// want_vel == 0) and err (T, D) i32 in place.
extern "C" int astroz_sgp4_f64_escape(
    const double* t_time, const double* t_sat, const double* fields,
    const int* flags, const int* idx, const double* tables,
    long long n_times, long long n_esc, long long n_deep, int n_steps,
    int want_vel, double xke, double inv_xke, double half_j2, double re,
    double vkmpersec, double aycof_c, double xlcof_c, float* r, float* v,
    int* err, void* stream) {
  const EscapeArgs a{t_time, t_sat, fields, flags, idx, tables, n_times,
                     n_esc, n_deep, n_steps,
                     Consts{xke, inv_xke, half_j2, re, vkmpersec, aycof_c,
                            xlcof_c},
                     r, v, err};
  const int blocks = blocks_of(n_times * n_esc);
  return want_vel
             ? launch(sgp4_f64_escape_kernel<true>, blocks, a, stream)
             : launch(sgp4_f64_escape_kernel<false>, blocks, a, stream);
}
