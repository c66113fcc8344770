// The numerical stack's integrators in f64, for Hopper: the integrator
// kernel.
//
// Not a TPU kernel. The JAX package compiles its fixed-step and adaptive
// integrators and its attitude propagation into one XLA program each
// (astroz_tpu/propagators/driver.py:30 propagate_fixed, a lax.scan;
// astroz_tpu/propagators/integrators.py:131 dp87_adaptive, a
// lax.while_loop, which astroz_tpu/propagators/driver.py:76 Propagator
// calls once an outer step; astroz_tpu/calculations.py:273
// propagate_attitude, a lax.scan). The port's plain versions run them as
// Python loops of small torch ops. This file runs each loop whole, one
// thread carrying one state through every step:
//   FIXED       propagate_fixed: `substeps` RK4 or fixed DP8(7) steps a
//               sample, n samples, one thread a lane; states (n + 1, L, 6)
//   TRAJECTORY  Propagator.propagate over a DormandPrince87: once an
//               outer step, dp87_adaptive's loop (the overshoot clamp, the
//               13-stage step with its embedded 7th-order error, the error
//               norm, accept or reject, the step-size law, the substep
//               cap), h carried from one outer step to the next, every
//               state written, one thread, one launch a call;
//               dp87_adaptive alone is its one outer step
//   ATTITUDE    propagate_attitude: n RK4 steps of quaternion kinematics
//               and Euler's equations, the quaternion renormalized each
//               step; one thread a body
// The force model is a short list of terms (kinds below), summed left to
// right as the plain Composite sums its members; a model the kernel
// cannot compute (one that calls a Python function of t) never reaches it
// (propagators/forces.py kernel_terms).
//
// How the bits are kept (FIXED and ATTITUDE equal their plain versions on
// the card bit for bit, a TRAJECTORY launch the launches of its outer
// steps one by one; TRAJECTORY takes its step-size factor's err^(-1/8)
// from the device's pow where the plain loop takes the host's):
// - built with --fmad=true, as torch's own kernels are (libdevice's pow
//   and exp give torch's bits only so); this file's own arithmetic goes
//   through the D type, whose operators are rounded intrinsics, never
//   contracted, so each + - * / rounds once as a torch op does;
// - torch on CUDA divides by a python float as a multiply by its
//   reciprocal, and a python float by a tensor as reciprocal then multiply
//   (Tensor.__rtruediv__); x ** 2 and x ** 3 are products, x ** 5 and x ** 7
//   libdevice's pow;
// - torch.linalg.vector_norm over the last axis of 3 values sums the
//   squares of values 0 and 2, then adds that of value 1 (two threads of
//   a reduction); over 4 values, (0 + 2) + (1 + 3); torch.linalg.cross
//   computes a*b - c*d as fma(a, b, -(c*d)) (norm3, norm4, cross_term:
//   found by shallow_variants.py --torch-rounding on the card);
// - Python's order of evaluation: (0.5 * h) * k, (h / 6.0) * (((k1 + 2 k2)
//   + 2 k3) + k4), products left to right, DP8(7) adding (h * a_ij) * k_j
//   only where a_ij != 0;
// - a correctly rounded quotient a / b, where several share b, from one
//   y = RN(1/b) and two of Markstein's corrections (div_by_rcp); a
//   reciprocal (torch.reciprocal, 1.0 / x) as __drcp_rn. Both are RN of
//   the exact value, as __ddiv_rn is (divide_probe_kernel holds them to it
//   on the card).
//
// Bound. FIXED at the Monte-Carlo shape (100,000 lanes, 180 RK4 steps of
// TwoBody + J2 + Drag) writes 0.87 GB of states (0.26 ms at 3.35 TB/s) and
// does ~1,000 f64 instructions a lane-step (libdevice's pow and exp and
// the correctly rounded divides and square roots take tens each), so the
// f64 pipe (132 SMs x 64 lanes) bounds it near 1.1 ms. TRAJECTORY and
// ATTITUDE carry one state through thousands of dependent steps: they are
// bound by the latency of that chain on one thread (8.2 cycles an f64
// add, multiply or FMA, 58 a reciprocal, 79 a square root, 693
// libdevice's pow; shallow_variants.py --integrate-probes, whose
// chain_cycles follows this file's arithmetic): ~6,400 cycles a DP8(7)
// substep of TwoBody + J2 (a stage's position waits for the acceleration
// two stages back, so six of the thirteen pow(|r|, 5) lie on the path,
// and the step-size law's pow)
// and ~440 an attitude step (~540 where each step ends before the next).
//
// Design: the state lives in registers across all steps; RK4 accumulates
// k1 + 2 k2 + 2 k3 + k4 as each stage ends, in the plain order, so four
// stage vectors are never live together. DP8(7)'s tableau is unrolled at
// compile time (dp87_stages: a stage sum adds only the nonzero a_ij, the
// coefficients are immediates) and its 8th (and 7th) order sums are
// accumulated as each stage ends; deriv is called out of line, so that
// the unrolled stages hold one copy of the terms' code (the substep's
// instructions stay in the instruction cache); its 13 stage vectors live
// in registers
// on the one-thread modes (RegStages, __launch_bounds__(1)) and in shared
// memory on FIXED (SharedStages: 78 f64 a thread of a block of 64). The
// model is copied once a block into shared memory, and every derivative
// computes |r| once for all its terms (the plain terms compute it each, to
// the same bits). A correctly rounded divide is a reciprocal sequence
// fenced by a branch to its slow path, so divides never overlap, and the
// term kinds' dispatch is another branch: the divides that share a divisor
// (TwoBody's three by |r|^3, Euler's three by the inertia, the
// normalisation's four by |q|) run from one reciprocal with their
// corrections side by side, behind a test that all operands lie where the
// corrections are exact; the one-thread modes are compiled for the models
// propagate_numerical builds (Signature), whose derivatives are
// straight-line code; an ATTITUDE step is straight-line code (its four
// stages written out, its divides tested once a step, the step taken
// again through __ddiv_rn where a test fails), so that the w chain
// (Euler's equations, which do not read q) and the q chain are scheduled
// together.

#include <cstdint>

namespace {

constexpr int FIXED_BLOCK = 128;
// DP8(7)'s stage vectors on FIXED: 13 x 6 f64 a thread in shared memory,
// 39 KB a block of 64
constexpr int DP87_BLOCK = 64;
constexpr int ATTITUDE_BLOCK = 128;
constexpr int STAGES = 13;

// An f64 value whose arithmetic rounds once an operation and is never
// contracted into a fused multiply-add (see above). No conversion back to
// double, so no builtin f64 arithmetic slips in.
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
__device__ __forceinline__ D fma(D a, D b, D c) {
  return __fma_rn(a.v, b.v, c.v);
}
__device__ __forceinline__ D sqrt(D a) { return __dsqrt_rn(a.v); }
__device__ __forceinline__ D fabs(D a) { return ::fabs(a.v); }
__device__ __forceinline__ D exp(D a) { return ::exp(a.v); }
__device__ __forceinline__ D pow(D a, double e) { return ::pow(a.v, e); }
// torch.reciprocal, and 1.0 / a: RN(1 / a)
__device__ __forceinline__ D recip(D a) { return __drcp_rn(a.v); }
// torch.maximum: NaN wins
__device__ __forceinline__ D maximum(D a, D b) {
  return a.v != a.v ? a : (b.v != b.v ? b : (b > a ? b : a));
}
// Python's max(a, b) and min(a, b) on floats
__device__ __forceinline__ D py_max(D a, D b) { return b > a ? b : a; }
__device__ __forceinline__ D py_min(D a, D b) { return b < a ? b : a; }

// torch.linalg.vector_norm(x, dim=-1) on CUDA over 3 and over 4 values
__device__ __forceinline__ D norm3(D x0, D x1, D x2) {
  return sqrt((x0 * x0 + x2 * x2) + x1 * x1);
}
__device__ __forceinline__ D norm4(D x0, D x1, D x2, D x3) {
  return sqrt((x0 * x0 + x2 * x2) + (x1 * x1 + x3 * x3));
}
// one component of torch.linalg.cross on CUDA: a * b - c * d
__device__ __forceinline__ D cross_term(D a, D b, D c, D d) {
  return fma(a, b, -(c * d));
}

// ---------------------------------------------------------------------------
// Divides through a reciprocal
// ---------------------------------------------------------------------------

// x is normal with 2^-400 <= |x| < 2^401 (not zero, subnormal, inf or
// NaN): where a and b both are, no product, residual or quotient below
// under- or overflows
__device__ __forceinline__ bool in_window(D x) {
  const unsigned e = (static_cast<unsigned>(__double2hiint(x.v)) >> 20) &
                     0x7ffu;
  return e - (1023u - 400u) <= 800u;
}

// RN(a / b) from y = RN(1 / b), a and b in_window: q0 = a y, then twice
// q = q + (a - b q) y, the residual exact in an FMA. After the first
// correction q is within an ulp of a / b (q0 itself can be 1.5 ulps off
// where a / b lies in the lower half of its binade), and from such a q and
// y = RN(1 / b) the second gives RN(a / b) (Markstein's theorem)
__device__ __forceinline__ D div_by_rcp(D a, D b, D y) {
  const D q0 = a * y;
  const D q1 = fma(fma(-q0, b, a), y, q0);
  return fma(fma(-q1, b, a), y, q1);
}

// q[i] = n[i] / b for three numerators sharing b
__device__ __forceinline__ void divide3(const D n[3], D b, D q[3]) {
  if (in_window(b) && in_window(n[0]) && in_window(n[1]) &&
      in_window(n[2])) {
    const D y = recip(b);
#pragma unroll
    for (int i = 0; i < 3; ++i) q[i] = div_by_rcp(n[i], b, y);
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) q[i] = n[i] / b;
  }
}

// div_by_rcp(n, b, y), b in_window; ok falls to false unless n is
// in_window too (then the caller divides again with __ddiv_rn)
__device__ __forceinline__ D div_checked(D n, D b, D y, bool& ok) {
  ok = ok & in_window(n);
  return div_by_rcp(n, b, y);
}

// ---------------------------------------------------------------------------
// Force models
// ---------------------------------------------------------------------------

// The term kinds, in the order of ops/cuda_integrate.py KINDS (which
// tests/test_torch_integrate.py holds to this list), and each one's
// parameters: the python floats its plain arithmetic applies, a divisor as
// its reciprocal (propagators/forces.py, each model's `terms`)
enum Kind {
  TWO_BODY,       // -mu
  J2,             // -1.5 j2 mu re^2
  J3,             // -2.5 j3 mu re^3
  J4,             // 1.875 j4 mu re^4
  DRAG,           // re, rho0, 1 / scale height (m), cd area / mass
  IMPROVED_DRAG,  // re, cd area / mass, solar factor, rotation rate, then
                  // (base km, rho0, 1 / scale height km) of 5 layers
  SRP,            // -k, re, AU (km): the sun fixed on +X at 1 AU
  N_KINDS
};
constexpr int MAX_TERMS = 8;
constexpr int MAX_PARAMS = 19;
constexpr int ATMO_LAYERS = 5;

struct Term {
  int kind;
  double p[MAX_PARAMS];
};
struct Model {
  int n;
  Term t[MAX_TERMS];
};

// the acceleration of one term of kind KIND, parameters p, at r (|r| =
// rn) and v
template <int KIND>
__device__ __forceinline__ void kind_accel(const double* p, const D r[3],
                                           const D v[3], D rn, D a[3]) {
  if constexpr (KIND == TWO_BODY) {  // -mu * r / rn ** 3
    const D c = (rn * rn) * rn;
    const D n[3] = {r[0] * D(p[0]), r[1] * D(p[0]), r[2] * D(p[0])};
    divide3(n, c, a);
  } else if constexpr (KIND == J2) {
    const D zr = r[2] / rn;
    const D z2 = zr * zr;
    const D k = recip(pow(rn, 5.0)) * D(p[0]);
    const D xy = D(1.0) - D(5.0) * z2;
    const D zt = D(3.0) - D(5.0) * z2;
    a[0] = k * (r[0] * xy);
    a[1] = k * (r[1] * xy);
    a[2] = k * (r[2] * zt);
  } else if constexpr (KIND == J3) {
    const D z = r[2];
    const D zr = z / rn;
    const D k = recip(pow(rn, 7.0)) * D(p[0]);
    const D z7 = D(7.0) * z;
    const D xy = D(3.0) * z - (z7 * zr) * zr;
    const D zt = ((D(6.0) * z) * zr - z7 * ((zr * zr) * zr)) - D(0.6) * rn;
    a[0] = (k * r[0]) * xy;
    a[1] = (k * r[1]) * xy;
    a[2] = (k * rn) * zt;
  } else if constexpr (KIND == J4) {
    const D zr = r[2] / rn;
    const D zr2 = zr * zr;
    const D zr4 = zr2 * zr2;
    const D k = recip(pow(rn, 7.0)) * D(p[0]);
    const D xy = (D(1.0) - D(14.0) * zr2) + D(21.0) * zr4;
    const D zt = (D(5.0) - (D(70.0) * zr2) * D(1.0 / 3.0)) + D(21.0) * zr4;
    a[0] = k * (r[0] * xy);
    a[1] = k * (r[1] * xy);
    a[2] = k * (r[2] * zt);
  } else if constexpr (KIND == DRAG) {
    const D alt_m = (rn - D(p[0])) * D(1000.0);
    const D rho = D(p[1]) * exp(-alt_m * D(p[2]));
    const D vn = norm3(v[0], v[1], v[2]);
    const D c = (((D(-0.5) * rho) * D(p[3])) * D(1000.0)) * vn;
    for (int i = 0; i < 3; ++i) a[i] = c * v[i];
  } else if constexpr (KIND == IMPROVED_DRAG) {
    const D alt = rn - D(p[0]);
    // the one layer that holds alt (none: 0, as below the first or NaN)
    D rho = 0.0;
    for (int l = 0; l < ATMO_LAYERS; ++l) {
      const double* L = p + 4 + 3 * l;
      const bool below_next = l + 1 == ATMO_LAYERS || alt < D(L[3]);
      if (alt >= D(L[0]) && below_next) {
        rho = D(L[1]) * exp(-(alt - D(L[0])) * D(L[2]));
      }
    }
    rho = rho * D(p[2]);
    const D vr[3] = {v[0] + D(p[3]) * r[1], v[1] - D(p[3]) * r[0], v[2]};
    const D vn = norm3(vr[0], vr[1], vr[2]);
    const D c = (((D(-0.5) * rho) * D(p[1])) * D(1000.0)) * vn;
    for (int i = 0; i < 3; ++i) a[i] = c * vr[i];
  } else if constexpr (KIND == SRP) {
    const D au = p[2];
    const D zero = 0.0;
    const D s[3] = {au - r[0], zero - r[1], zero - r[2]};
    const D d = norm3(s[0], s[1], s[2]);
    const D sn = norm3(au, zero, zero);
    const D n[3] = {au / sn, zero / sn, zero / sn};
    // torch.sum over the last axis of 3 sums as vector_norm does
    const D along = (r[0] * n[0] + r[2] * n[2]) + r[1] * n[1];
    const D perp = norm3(r[0] - along * n[0], r[1] - along * n[1],
                         r[2] - along * n[2]);
    const bool lit = along > zero || perp > D(p[1]);
    D scale = recip(d) * au;
    scale = scale * scale;
    const D c = D(p[0]) * scale;
    for (int i = 0; i < 3; ++i) a[i] = lit ? c * (s[i] / d) : zero;
  }
}

// one term's acceleration at r (|r| = rn) and v, its kind read at run
// time
__device__ __forceinline__ void term_accel(const Term& T, const D r[3],
                                           const D v[3], D rn, D a[3]) {
  switch (T.kind) {
#define KIND_CASE(K)                   \
  case K:                              \
    kind_accel<K>(T.p, r, v, rn, a);   \
    break;
    KIND_CASE(TWO_BODY) KIND_CASE(J2) KIND_CASE(J3) KIND_CASE(J4)
    KIND_CASE(DRAG) KIND_CASE(IMPROVED_DRAG) KIND_CASE(SRP)
#undef KIND_CASE
    default:
      for (int i = 0; i < 3; ++i) a[i] = 0.0;
  }
}

// [v, a(r, v)] of the state y, the model's terms summed left to right
__device__ __forceinline__ void deriv(const Model& m, const D y[6], D k[6]) {
  const D r[3] = {y[0], y[1], y[2]};
  const D v[3] = {y[3], y[4], y[5]};
  const D rn = norm3(r[0], r[1], r[2]);
  D a[3];
  term_accel(m.t[0], r, v, rn, a);
#pragma unroll 1
  for (int i = 1; i < m.n; ++i) {
    D b[3];
    term_accel(m.t[i], r, v, rn, b);
    for (int c = 0; c < 3; ++c) a[c] = a[c] + b[c];
  }
  for (int c = 0; c < 3; ++c) {
    k[c] = v[c];
    k[c + 3] = a[c];
  }
}

// deriv out of line, for DP8(7)'s 13 stages written out: one copy of the
// terms' code (all their kinds) in place of thirteen
struct V6 {
  D x[6];
};
__device__ __noinline__ V6 deriv_call(const Model& m, V6 s) {
  V6 k;
  deriv(m, s.x, k.x);
  return k;
}

// The models a one-thread kernel is compiled for: any model, its terms'
// kinds read at run time (GENERIC, deriv_call), or one of the fixed
// sequences of kinds that propagate_numerical builds, whose derivative is
// straight-line code inlined in each stage (no dispatch on the kind, no
// call)
enum Signature { GENERIC, SIG_TB, SIG_TB_J2, SIG_TB_J2_DRAG, N_SIGNATURES };
constexpr int SIG_KINDS[N_SIGNATURES][3] = {
    {-1, -1, -1}, {TWO_BODY, -1, -1}, {TWO_BODY, J2, -1},
    {TWO_BODY, J2, DRAG}};
__host__ __device__ constexpr int sig_kind(int sig, int i) {
  return SIG_KINDS[sig][i];
}

// term I onwards of a fixed signature, summed left to right into a
template <int SIG, int I>
__device__ __forceinline__ void sig_terms(const Model& m, const D r[3],
                                          const D v[3], D rn, D a[3]) {
  constexpr int KIND = I < 3 ? sig_kind(SIG, I < 3 ? I : 0) : -1;
  if constexpr (KIND >= 0) {
    D b[3];
    kind_accel<KIND>(m.t[I].p, r, v, rn, b);
#pragma unroll
    for (int c = 0; c < 3; ++c) a[c] = a[c] + b[c];
    sig_terms<SIG, I + 1>(m, r, v, rn, a);
  }
}

// deriv of a model of signature SIG
template <int SIG>
__device__ __forceinline__ void deriv_sig(const Model& m, const D y[6],
                                          D k[6]) {
  if constexpr (SIG == GENERIC) {
    V6 s;
#pragma unroll
    for (int c = 0; c < 6; ++c) s.x[c] = y[c];
    const V6 kv = deriv_call(m, s);
#pragma unroll
    for (int c = 0; c < 6; ++c) k[c] = kv.x[c];
  } else {
    const D r[3] = {y[0], y[1], y[2]};
    const D v[3] = {y[3], y[4], y[5]};
    const D rn = norm3(r[0], r[1], r[2]);
    D a[3];
    kind_accel<sig_kind(SIG, 0)>(m.t[0].p, r, v, rn, a);
    sig_terms<SIG, 1>(m, r, v, rn, a);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      k[c] = v[c];
      k[c + 3] = a[c];
    }
  }
}

// the model from the kernel's parameters into shared memory, once a block
__device__ __forceinline__ void stage_model(Model& shared, const Model& arg) {
  if (threadIdx.x == 0) shared = arg;
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Steps
// ---------------------------------------------------------------------------

// one RK4 step of y by h (propagators/integrators.py rk4_step)
__device__ __forceinline__ void rk4_step(const Model& m, D y[6], D h) {
  const D half = D(0.5) * h;
  D s[6], k[6], acc[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) s[c] = y[c];
#pragma unroll 1
  for (int st = 0; st < 4; ++st) {
    deriv(m, s, k);
    // the stage weights 1, 2, 2, 1 and the next stage's offsets
    // h/2, h/2, h
    const D w = st == 1 || st == 2 ? D(2.0) : D(1.0);
    const D off = st == 2 ? h : half;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      acc[c] = st == 0 ? k[c] : acc[c] + w * k[c];
      s[c] = y[c] + off * k[c];
    }
  }
  const D sixth = h / D(6.0);
#pragma unroll
  for (int c = 0; c < 6; ++c) y[c] = y[c] + sixth * acc[c];
}

// the RK8(7)-13M tableau (Prince & Dormand 1981) as
// propagators/integrators.py writes it (tests/test_torch_integrate.py
// holds these expressions to its floats)
constexpr double DP_A[STAGES][STAGES - 1] = {
    {},
    {1.0 / 18},
    {1.0 / 48, 1.0 / 16},
    {1.0 / 32, 0, 3.0 / 32},
    {5.0 / 16, 0, -75.0 / 64, 75.0 / 64},
    {3.0 / 80, 0, 0, 3.0 / 16, 3.0 / 20},
    {29443841.0 / 614563906, 0, 0, 77736538.0 / 692538347,
     -28693883.0 / 1125000000, 23124283.0 / 1800000000},
    {16016141.0 / 946692911, 0, 0, 61564180.0 / 158732637,
     22789713.0 / 633445777, 545815736.0 / 2771057229,
     -180193667.0 / 1043307555},
    {39632708.0 / 573591083, 0, 0, -433636366.0 / 683701615,
     -421739975.0 / 2616292301, 100302831.0 / 723423059,
     790204164.0 / 839813087, 800635310.0 / 3783071287},
    {246121993.0 / 1340847787, 0, 0, -37695042795.0 / 15268766246,
     -309121744.0 / 1061227803, -12992083.0 / 490766935,
     6005943493.0 / 2108947869, 393006217.0 / 1396673457,
     123872331.0 / 1001029789},
    {-1028468189.0 / 846180014, 0, 0, 8478235783.0 / 508512852,
     1311729495.0 / 1432422823, -10304129995.0 / 1701304382,
     -48777925059.0 / 3047939560, 15336726248.0 / 1032824649,
     -45442868181.0 / 3398467696, 3065993473.0 / 597172653},
    {185892177.0 / 718116043, 0, 0, -3185094517.0 / 667107341,
     -477755414.0 / 1098053517, -703635378.0 / 230739211,
     5731566787.0 / 1027545527, 5232866602.0 / 850066563,
     -4093664535.0 / 808688257, 3962137247.0 / 1805957418,
     65686358.0 / 487910083},
    {403863854.0 / 491063109, 0, 0, -5068492393.0 / 434740067,
     -411421997.0 / 543043805, 652783627.0 / 914296604,
     11173962825.0 / 925320556, -13158990841.0 / 6184727034,
     3936647629.0 / 1978049680, -160528059.0 / 685178525,
     248638103.0 / 1413531060, 0},
};
// 8th-order weights
constexpr double DP_B8[STAGES] = {
    14005451.0 / 335480064, 0, 0, 0, 0, -59238493.0 / 1068277825,
    181606767.0 / 758867731, 561292985.0 / 797845732,
    -1041891430.0 / 1371343529, 760417239.0 / 1151165299,
    118820643.0 / 751138087, -528747749.0 / 2220607170, 1.0 / 4};
// 7th-order (embedded) weights
constexpr double DP_B7[STAGES] = {
    13451932.0 / 455176623, 0, 0, 0, 0, -808719846.0 / 976000145,
    1757004468.0 / 5645159321, 656045339.0 / 265891186,
    -3867574721.0 / 1518517206, 465885868.0 / 322736535,
    53011238.0 / 667516719, 2.0 / 45, 0};

__host__ __device__ constexpr double dp_a(int i, int j) { return DP_A[i][j]; }
__host__ __device__ constexpr double dp_b8(int i) { return DP_B8[i]; }
__host__ __device__ constexpr double dp_b7(int i) { return DP_B7[i]; }

// DP8(7)'s 13 stage vectors: a thread's own registers (the one-thread
// modes; every index is a compile-time constant) or its column of a
// block's shared memory (FIXED)
struct RegStages {
  D k[STAGES][6];
  __device__ __forceinline__ D get(int i, int c) const { return k[i][c]; }
  __device__ __forceinline__ void set(int i, int c, D x) { k[i][c] = x; }
};
template <int NT>
struct SharedStages {
  double (*ks)[6][NT];
  __device__ __forceinline__ D get(int i, int c) const {
    return ks[i][c][threadIdx.x];
  }
  __device__ __forceinline__ void set(int i, int c, D x) {
    ks[i][c][threadIdx.x] = x.v;
  }
};

// s += (h * a_IJ) * k_J for J = J0 .. I - 1 where a_IJ != 0, in order
template <int I, int J, class K>
__device__ __forceinline__ void stage_sum(D s[6], D h, const K& ks) {
  if constexpr (J < I) {
    constexpr double a = dp_a(I, J);
    if constexpr (a != 0.0) {
      const D ha = h * D(a);
#pragma unroll
      for (int c = 0; c < 6; ++c) s[c] = s[c] + ha * ks.get(J, c);
    }
    stage_sum<I, J + 1>(s, h, ks);
  }
}

// stages I .. 12 of one DP8(7) step of y by h (propagators/integrators.py
// dp87_step) for a model of signature SIG, each stage's 8th (and, with
// EMBEDDED, 7th) order term added to y8 (y7) as it ends
template <int I, int SIG, bool EMBEDDED, class K>
__device__ __forceinline__ void dp87_stages(const Model& m, const D y[6],
                                            D h, K& ks, D y8[6], D y7[6]) {
  if constexpr (I < STAGES) {
    D s[6], k[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) s[c] = y[c];
    stage_sum<I, 0>(s, h, ks);
    deriv_sig<SIG>(m, s, k);
#pragma unroll
    for (int c = 0; c < 6; ++c) ks.set(I, c, k[c]);
    constexpr double b8 = dp_b8(I), b7 = dp_b7(I);
    if constexpr (b8 != 0.0) {
      const D hb = h * D(b8);
#pragma unroll
      for (int c = 0; c < 6; ++c) y8[c] = y8[c] + hb * k[c];
    }
    if constexpr (EMBEDDED && b7 != 0.0) {
      const D hb = h * D(b7);
#pragma unroll
      for (int c = 0; c < 6; ++c) y7[c] = y7[c] + hb * k[c];
    }
    dp87_stages<I + 1, SIG, EMBEDDED>(m, y, h, ks, y8, y7);
  }
}

// one DP8(7) step of y by h: the 8th-order state into y8 and, with
// EMBEDDED, the 7th-order one into y7
template <int SIG, bool EMBEDDED, class K>
__device__ __forceinline__ void dp87_step(const Model& m, K& ks,
                                          const D y[6], D h, D y8[6],
                                          D y7[6]) {
#pragma unroll
  for (int c = 0; c < 6; ++c) y8[c] = y7[c] = y[c];
  dp87_stages<0, SIG, EMBEDDED>(m, y, h, ks, y8, y7);
}

// dp87_adaptive's control: the end of the interval, the direction of time,
// tolerances and the step's limits
struct Control {
  D end, dir, rtol, atol, h_min, h_max;
};

// dp87_adaptive's loop from t to c.end with the signed step h, on one
// thread (propagators/integrators.py adaptive_reference), for a model of
// signature SIG: y, t and h are carried out; returns the substeps taken
template <int SIG>
__device__ __forceinline__ long long adaptive_run(const Model& m,
                                                  const Control& c, D y[6],
                                                  D& t, D& h,
                                                  long long max_substeps) {
  const D zero = 0.0;
  long long steps = 0;
#pragma unroll 1
  while ((t - c.end) * c.dir < zero && steps < max_substeps) {
    // a step that would overshoot the end ends on it
    const D hs = ((t + h) - c.end) * c.dir > zero ? c.end - t : h;
    RegStages ks;
    D y8[6], y7[6];
    dp87_step<SIG, true>(m, ks, y, hs, y8, y7);
    // max(|y8 - y7| / (atol + rtol * max(|y|, |y8|))), NaN wins
    D err_norm = 0.0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const D scale = c.rtol * maximum(fabs(y[i]), fabs(y8[i])) + c.atol;
      const D e = fabs(y8[i] - y7[i]) / scale;
      err_norm = i == 0 ? e : maximum(err_norm, e);
    }
    const D factor = py_min(
        py_max(D(0.9) * pow(py_max(err_norm, D(1e-16)), -1.0 / 8.0), D(0.1)),
        D(5.0));
    h = py_min(py_max(fabs(hs * factor), c.h_min), c.h_max) * c.dir;
    if (err_norm <= D(1.0)) {
#pragma unroll
      for (int i = 0; i < 6; ++i) y[i] = y8[i];
      t = t + hs;
    }
    ++steps;
  }
  return steps;
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// FIXED: lane x's state0[x] into out[0, x], then each sample k + 1 after
// `substeps` steps of h (no kernel term reads t, so none is carried)
template <bool DP87>
__global__ void __launch_bounds__(DP87 ? DP87_BLOCK : FIXED_BLOCK)
    integrate_fixed_kernel(const double* __restrict__ state0,
                           double* __restrict__ out, long long n_lanes,
                           int n_steps, int substeps, double h,
                           Model model) {
  constexpr int NT = DP87 ? DP87_BLOCK : FIXED_BLOCK;
  __shared__ Model m;
  __shared__ double ks[DP87 ? STAGES : 1][6][NT];
  stage_model(m, model);
  const long long lane = (long long)blockIdx.x * NT + threadIdx.x;
  if (lane >= n_lanes) return;
  D y[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    y[c] = state0[lane * 6 + c];
    out[lane * 6 + c] = y[c].v;
  }
#pragma unroll 1
  for (int k = 0; k < n_steps; ++k) {
#pragma unroll 1
    for (int s = 0; s < substeps; ++s) {
      if constexpr (DP87) {
        SharedStages<NT> stages{ks};
        D y8[6], y7[6];
        dp87_step<GENERIC, false>(m, stages, y, D(h), y8, y7);
#pragma unroll
        for (int c = 0; c < 6; ++c) y[c] = y8[c];
      } else {
        rk4_step(m, y, D(h));
      }
    }
    double* o = out + ((long long)(k + 1) * n_lanes + lane) * 6;
#pragma unroll
    for (int c = 0; c < 6; ++c) o[c] = y[c].v;
  }
}

// TRAJECTORY: Propagator.propagate over a DormandPrince87 on one thread,
// and dp87_adaptive as its one outer step. Outer step k (1 .. n_outer)
// runs dp87_adaptive from t = t0 + dt * (k - 1) to t + dt, each rounded as
// the Python loop rounds them (numpy's t0 + dt * arange, then a float
// add), the last to t_last (the loop's own end, or dp87_adaptive's t1),
// starting with h as DormandPrince87.step gives it: |h| carried from the
// step before times the direction, or, with no |h| yet (h_carried NaN),
// min(|t1 - t0|, h_max) times it. states (n_outer + 1, 6): row 0 the
// start, row k the state after outer step k; substeps and hs (n_outer,):
// each outer step's substeps and |h| after it. The walk stops after the
// first outer step that takes max_substeps (where DormandPrince87.step
// raises: its row holds the state where the cap left it, and its |h| is
// not carried); rows and entries past the stop hold NaN and 0. info =
// [outer steps completed, |h| carried out (NaN if none), substeps in all,
// the signed h after the last outer step run (NaN if none)]
template <int SIG>
__global__ void __launch_bounds__(1) integrate_trajectory_kernel(
    const double* __restrict__ state0, double* __restrict__ states,
    long long* __restrict__ substeps, double* __restrict__ hs,
    double* __restrict__ info, double t0, double dt, double t_last,
    long long n_outer, double h_carried, double rtol, double atol,
    double h_min, double h_max, long long max_substeps, Model model) {
  __shared__ Model m;
  stage_model(m, model);
  D y[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    y[c] = state0[c];
    states[c] = y[c].v;
  }
  const double nan = __longlong_as_double(0x7ff8000000000000ll);
  const D zero = 0.0, one = 1.0;
  D h_abs = h_carried, h_last = nan;
  bool carried = h_carried == h_carried;
  long long ran = 0, done = 0, total = 0;
#pragma unroll 1
  for (long long k = 1; k <= n_outer; ++k) {
    const D ta = k == 1 ? D(t0)
                        : D(t0) + D(dt) * D(static_cast<double>(k - 1));
    const D tb = k == n_outer ? D(t_last) : ta + D(dt);
    const D dir = tb > ta ? one : (tb < ta ? -one : zero);
    const D sign = dir.v != 0.0 ? dir : one;
    D h = carried ? h_abs * sign
                  : (dir.v != 0.0 ? py_min(fabs(tb - ta), D(h_max))
                                  : D(h_max)) * sign;
    D t = ta;
    const Control ctl{tb, dir, rtol, atol, h_min, h_max};
    const long long n = adaptive_run<SIG>(m, ctl, y, t, h, max_substeps);
    total += n;
    substeps[k - 1] = n;
    hs[k - 1] = fabs(h).v;
    h_last = h;
#pragma unroll
    for (int c = 0; c < 6; ++c) states[k * 6 + c] = y[c].v;
    ran = k;
    if (n >= max_substeps) break;
    h_abs = fabs(h);
    carried = true;
    done = k;
  }
#pragma unroll 1
  for (long long k = ran + 1; k <= n_outer; ++k) {
#pragma unroll
    for (int c = 0; c < 6; ++c) states[k * 6 + c] = nan;
    substeps[k - 1] = 0;
    hs[k - 1] = nan;
  }
  info[0] = static_cast<double>(done);
  info[1] = carried ? h_abs.v : nan;
  info[2] = static_cast<double>(total);
  info[3] = h_last.v;
}

// quaternion kinematics and Euler's equations (calculations.py
// propagate_attitude's deriv): qd = 0.5 q * [0, w], wd = (T - w x (I w)) / I;
// with FAST the divides go through the inertia's reciprocals y
// (div_checked), else through __ddiv_rn
template <bool FAST>
__device__ __forceinline__ void attitude_deriv(const D q[4], const D w[3],
                                               const D I[3], const D y[3],
                                               const D T[3], D qd[4],
                                               D wd[3], bool& ok) {
  const D z = 0.0, half = 0.5;
  qd[0] = half * (((q[0] * z - q[1] * w[0]) - q[2] * w[1]) - q[3] * w[2]);
  qd[1] = half * (((q[0] * w[0] + q[1] * z) + q[2] * w[2]) - q[3] * w[1]);
  qd[2] = half * (((q[0] * w[1] - q[1] * w[2]) + q[2] * z) + q[3] * w[0]);
  qd[3] = half * (((q[0] * w[2] + q[1] * w[1]) - q[2] * w[0]) + q[3] * z);
  const D iw[3] = {I[0] * w[0], I[1] * w[1], I[2] * w[2]};
  const D n[3] = {T[0] - cross_term(w[1], iw[2], w[2], iw[1]),
                  T[1] - cross_term(w[2], iw[0], w[0], iw[2]),
                  T[2] - cross_term(w[0], iw[1], w[1], iw[0])};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if constexpr (FAST) {
      wd[c] = div_checked(n[c], I[c], y[c], ok);
    } else {
      wd[c] = n[c] / I[c];
    }
  }
}

// one RK4 stage ST (0 .. 3) of the attitude step from (q, w): its
// derivative at (sq, sw) added to the weighted sums (weights 1, 2, 2, 1)
// and the next stage's point q + off * k (off h/2, h/2, h)
template <int ST, bool FAST>
__device__ __forceinline__ void attitude_stage(
    const D q[4], const D w[3], D sq[4], D sw[3], D aq[4], D aw[3],
    const D I[3], const D y[3], const D T[3], D half, D h, bool& ok) {
  D kq[4], kw[3];
  attitude_deriv<FAST>(sq, sw, I, y, T, kq, kw, ok);
  const D off = ST == 2 ? h : half;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if constexpr (ST == 0) aq[c] = kq[c];
    if constexpr (ST == 1 || ST == 2) aq[c] = aq[c] + D(2.0) * kq[c];
    if constexpr (ST == 3) aq[c] = aq[c] + kq[c];
    if constexpr (ST < 3) sq[c] = q[c] + off * kq[c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if constexpr (ST == 0) aw[c] = kw[c];
    if constexpr (ST == 1 || ST == 2) aw[c] = aw[c] + D(2.0) * kw[c];
    if constexpr (ST == 3) aw[c] = aw[c] + kw[c];
    if constexpr (ST < 3) sw[c] = w[c] + off * kw[c];
  }
}

// one RK4 attitude step of h from (q, w) into (qn, wn), qn renormalized.
// FAST: every divide through a reciprocal, the step straight-line code, ok
// falling to false where an operand leaves the window (the caller then
// takes the step again without FAST, every divide by __ddiv_rn)
template <bool FAST>
__device__ __forceinline__ void attitude_step(const D q[4], const D w[3],
                                              const D I[3], const D y[3],
                                              const D T[3], D half, D h,
                                              D sixth, D qn[4], D wn[3],
                                              bool& ok) {
  D sq[4] = {q[0], q[1], q[2], q[3]}, sw[3] = {w[0], w[1], w[2]};
  D aq[4], aw[3];
  attitude_stage<0, FAST>(q, w, sq, sw, aq, aw, I, y, T, half, h, ok);
  attitude_stage<1, FAST>(q, w, sq, sw, aq, aw, I, y, T, half, h, ok);
  attitude_stage<2, FAST>(q, w, sq, sw, aq, aw, I, y, T, half, h, ok);
  attitude_stage<3, FAST>(q, w, sq, sw, aq, aw, I, y, T, half, h, ok);
#pragma unroll
  for (int c = 0; c < 4; ++c) qn[c] = q[c] + sixth * aq[c];
#pragma unroll
  for (int c = 0; c < 3; ++c) wn[c] = w[c] + sixth * aw[c];
  const D n4 = norm4(qn[0], qn[1], qn[2], qn[3]);
  if constexpr (FAST) {
    ok = ok & in_window(n4);
    const D yn = recip(n4);
#pragma unroll
    for (int c = 0; c < 4; ++c) qn[c] = div_checked(qn[c], n4, yn, ok);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) qn[c] = qn[c] / n4;
  }
}

// ATTITUDE: body x's (q, w) through n_steps RK4 steps of dt
__global__ void __launch_bounds__(ATTITUDE_BLOCK) integrate_attitude_kernel(
    const double* __restrict__ q0, const double* __restrict__ w0,
    const double* __restrict__ inertia, const double* __restrict__ torque,
    double* __restrict__ q_out, double* __restrict__ w_out,
    long long n_bodies, long long n_steps, double dt) {
  const long long b = (long long)blockIdx.x * ATTITUDE_BLOCK + threadIdx.x;
  if (b >= n_bodies) return;
  D q[4], w[3], I[3], y[3], T[3];
#pragma unroll
  for (int c = 0; c < 4; ++c) q[c] = q0[b * 4 + c];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    w[c] = w0[b * 3 + c];
    I[c] = inertia[b * 3 + c];
    y[c] = recip(I[c]);
    T[c] = torque[b * 3 + c];
  }
  const bool i_ok = in_window(I[0]) && in_window(I[1]) && in_window(I[2]);
  const D h = dt, half = D(0.5) * h, sixth = h / D(6.0);
#pragma unroll 1
  for (long long n = 0; n < n_steps; ++n) {
    D qn[4], wn[3];
    bool ok = i_ok;
    if (i_ok) {
      attitude_step<true>(q, w, I, y, T, half, h, sixth, qn, wn, ok);
    }
    if (!ok) {
      attitude_step<false>(q, w, I, y, T, half, h, sixth, qn, wn, ok);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) q[c] = qn[c];
#pragma unroll
    for (int c = 0; c < 3; ++c) w[c] = wn[c];
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) q_out[b * 4 + c] = q[c].v;
#pragma unroll
  for (int c = 0; c < 3; ++c) w_out[b * 3 + c] = w[c].v;
}

// the divides of this file against __ddiv_rn, pair by pair: got[k] =
// a[k] / b[k] as ATTITUDE's groups and TwoBody take it (div_by_rcp from
// recip(b) where both are in_window, else __ddiv_rn), want[k] =
// __ddiv_rn(a[k], b[k]); rcp[k] = recip(b[k]), rcp_want[k] = __ddiv_rn(1,
// b[k])
__global__ void divide_probe_kernel(const double* __restrict__ a,
                                    const double* __restrict__ b,
                                    double* __restrict__ got,
                                    double* __restrict__ want,
                                    double* __restrict__ rcp,
                                    double* __restrict__ rcp_want,
                                    long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       k < n; k += stride) {
    const D x = a[k], d = b[k];
    const D n3[3] = {x, x, x};
    D q[3];
    divide3(n3, d, q);
    got[k] = q[0].v;
    want[k] = (x / d).v;
    rcp[k] = recip(d).v;
    rcp_want[k] = (D(1.0) / d).v;
  }
}

// the model of n terms from kinds (n,) and params (n, MAX_PARAMS), host
// arrays; false if it does not fit
bool make_model(int n, const int* kinds, const double* params, Model* m) {
  if (n < 1 || n > MAX_TERMS) return false;
  *m = Model{};
  m->n = n;
  for (int i = 0; i < n; ++i) {
    if (kinds[i] < 0 || kinds[i] >= N_KINDS) return false;
    m->t[i].kind = kinds[i];
    for (int k = 0; k < MAX_PARAMS; ++k) {
      m->t[i].p[k] = params[i * MAX_PARAMS + k];
    }
  }
  return true;
}

long long blocks_of(long long n, int block) { return (n + block - 1) / block; }

// the signature whose kinds are the model's, else GENERIC
int signature_of(const Model& m) {
  for (int sig = N_SIGNATURES - 1; sig > GENERIC; --sig) {
    int n = 0;
    while (n < 3 && SIG_KINDS[sig][n] >= 0) ++n;
    bool same = n == m.n;
    for (int i = 0; same && i < n; ++i) same = m.t[i].kind == SIG_KINDS[sig][i];
    if (same) return sig;
  }
  return GENERIC;
}

// launch KERNEL<SIG> for the model's signature
#define LAUNCH_BY_SIGNATURE(KERNEL, m, st, ...)                     \
  switch (signature_of(m)) {                                        \
    case SIG_TB:                                                    \
      KERNEL<SIG_TB><<<1, 1, 0, st>>>(__VA_ARGS__);                 \
      break;                                                        \
    case SIG_TB_J2:                                                 \
      KERNEL<SIG_TB_J2><<<1, 1, 0, st>>>(__VA_ARGS__);              \
      break;                                                        \
    case SIG_TB_J2_DRAG:                                            \
      KERNEL<SIG_TB_J2_DRAG><<<1, 1, 0, st>>>(__VA_ARGS__);         \
      break;                                                        \
    default:                                                        \
      KERNEL<GENERIC><<<1, 1, 0, st>>>(__VA_ARGS__);                \
  }

}  // namespace

// FIXED: state0 (L, 6) f64, out (n_steps + 1, L, 6) f64; dp87 0 for RK4;
// the model's n_terms kinds and (n_terms, 19) params are host arrays.
extern "C" int astroz_integrate_fixed(const double* state0, double* out,
                                      long long n_lanes, int n_steps,
                                      int substeps, double h,
                                      int dp87, int n_terms,
                                      const int* kinds, const double* params,
                                      void* stream) {
  Model m;
  if (!make_model(n_terms, kinds, params, &m) || n_steps < 0 ||
      substeps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_lanes > 0) {
    if (dp87) {
      integrate_fixed_kernel<true>
          <<<blocks_of(n_lanes, DP87_BLOCK), DP87_BLOCK, 0, st>>>(
              state0, out, n_lanes, n_steps, substeps, h, m);
    } else {
      integrate_fixed_kernel<false>
          <<<blocks_of(n_lanes, FIXED_BLOCK), FIXED_BLOCK, 0, st>>>(
              state0, out, n_lanes, n_steps, substeps, h, m);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// TRAJECTORY: state0 (6,) f64; states (n_outer + 1, 6) f64, substeps
// (n_outer,) i64, hs (n_outer,) f64, info (4,) f64; h_carried NaN for none.
extern "C" int astroz_integrate_trajectory(
    const double* state0, double* states, long long* substeps, double* hs,
    double* info, double t0, double dt, double t_last, long long n_outer,
    double h_carried, double rtol, double atol, double h_min, double h_max,
    long long max_substeps, int n_terms, const int* kinds,
    const double* params, void* stream) {
  Model m;
  if (!make_model(n_terms, kinds, params, &m) || n_outer < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  LAUNCH_BY_SIGNATURE(integrate_trajectory_kernel, m, st, state0, states,
                      substeps, hs, info, t0, dt, t_last, n_outer, h_carried,
                      rtol, atol, h_min, h_max, max_substeps, m);
  return static_cast<int>(cudaGetLastError());
}

// ATTITUDE: q0 (B, 4), w0, inertia, torque (B, 3) f64; q_out (B, 4), w_out
// (B, 3) f64.
extern "C" int astroz_integrate_attitude(
    const double* q0, const double* w0, const double* inertia,
    const double* torque, double* q_out, double* w_out, long long n_bodies,
    long long n_steps, double dt, void* stream) {
  if (n_bodies > 0) {
    integrate_attitude_kernel<<<blocks_of(n_bodies, ATTITUDE_BLOCK),
                                ATTITUDE_BLOCK, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        q0, w0, inertia, torque, q_out, w_out, n_bodies, n_steps, dt);
  }
  return static_cast<int>(cudaGetLastError());
}

// the divides against __ddiv_rn: a, b (n,) f64; got, want, rcp, rcp_want
// (n,) f64.
extern "C" int astroz_integrate_divide_probe(const double* a, const double* b,
                                             double* got, double* want,
                                             double* rcp, double* rcp_want,
                                             long long n, void* stream) {
  if (n > 0) {
    divide_probe_kernel<<<264, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        a, b, got, want, rcp, rcp_want, n);
  }
  return static_cast<int>(cudaGetLastError());
}
