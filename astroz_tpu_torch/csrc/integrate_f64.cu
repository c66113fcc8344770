// The numerical stack's integrators in f64, for Hopper: the integrator
// kernel.
//
// Not a TPU kernel. The JAX package compiles its fixed-step and adaptive
// integrators and its attitude propagation into one XLA program each
// (astroz_tpu/propagators/driver.py:30 propagate_fixed, a lax.scan;
// astroz_tpu/propagators/integrators.py:131 dp87_adaptive, a
// lax.while_loop; astroz_tpu/calculations.py:273 propagate_attitude, a
// lax.scan). The port's plain versions (ops/cuda_integrate.py) run them as
// Python loops of small torch ops. This file runs each loop whole, one
// thread carrying one state through every step:
//   FIXED     propagate_fixed: `substeps` RK4 or fixed DP8(7) steps a
//             sample, n samples, one thread a lane; states (n + 1, L, 6)
//   ADAPTIVE  dp87_adaptive from t0 to t1: the overshoot clamp, the
//             13-stage step with its embedded 7th-order error, the error
//             norm, accept or reject, the step-size law, the substep cap;
//             one thread; writes state, t, h and the substep count
//   ATTITUDE  propagate_attitude: n RK4 steps of quaternion kinematics
//             and Euler's equations, the quaternion renormalized each
//             step; one thread a body
// The force model is a short list of terms (kinds below), summed left to
// right as the plain Composite sums its members; a model the kernel
// cannot compute (one that calls a Python function of t) never reaches it
// (propagators/forces.py kernel_terms).
//
// How the bits are kept (FIXED and ATTITUDE equal their plain versions on
// the card bit for bit; ADAPTIVE takes its step-size factor's err^(-1/8)
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
//   only where a_ij != 0.
//
// Bound. FIXED at the Monte-Carlo shape (100,000 lanes, 180 RK4 steps of
// TwoBody + J2 + Drag) writes 0.87 GB of states (0.26 ms at 3.35 TB/s) and
// does ~1,000 f64 instructions a lane-step (libdevice's pow and exp and
// the correctly rounded divides and square roots take tens each), so the
// f64 pipe (132 SMs x 64 lanes) bounds it near 1.1 ms. ADAPTIVE and
// ATTITUDE carry one state through thousands of dependent steps: their
// time is the latency of that chain on one thread, which no bound by bytes
// or operations sees.
//
// Design: the state lives in registers across all steps; RK4 accumulates
// k1 + 2 k2 + 2 k3 + k4 as each stage ends, in the plain order, so four
// stage vectors are never live together; DP8(7)'s 13 stage vectors (78
// f64 values a thread) live in shared memory, one column a thread, so
// ptxas spills none of them, and its 8th (and 7th) order sums are
// accumulated as each stage ends; the model is copied once a block into
// shared memory, and every derivative computes |r| once for all its
// terms (the plain terms compute it each, to the same bits).

#include <cstdint>

namespace {

constexpr int FIXED_BLOCK = 128;
// DP8(7)'s stage vectors: 13 x 6 f64 a thread in shared memory, 39 KB a
// block of 64
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
// torch.reciprocal
__device__ __forceinline__ D recip(D a) { return D(1.0) / a; }
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

// one term's acceleration at r (|r| = rn) and v
__device__ __forceinline__ void term_accel(const Term& T, const D r[3],
                                           const D v[3], D rn, D a[3]) {
  const double* p = T.p;
  switch (T.kind) {
    case TWO_BODY: {  // -mu * r / rn ** 3
      const D c = (rn * rn) * rn;
      for (int i = 0; i < 3; ++i) a[i] = (r[i] * D(p[0])) / c;
      break;
    }
    case J2: {
      const D zr = r[2] / rn;
      const D z2 = zr * zr;
      const D k = recip(pow(rn, 5.0)) * D(p[0]);
      const D xy = D(1.0) - D(5.0) * z2;
      const D zt = D(3.0) - D(5.0) * z2;
      a[0] = k * (r[0] * xy);
      a[1] = k * (r[1] * xy);
      a[2] = k * (r[2] * zt);
      break;
    }
    case J3: {
      const D z = r[2];
      const D zr = z / rn;
      const D k = recip(pow(rn, 7.0)) * D(p[0]);
      const D z7 = D(7.0) * z;
      const D xy = D(3.0) * z - (z7 * zr) * zr;
      const D zt = ((D(6.0) * z) * zr - z7 * ((zr * zr) * zr)) - D(0.6) * rn;
      a[0] = (k * r[0]) * xy;
      a[1] = (k * r[1]) * xy;
      a[2] = (k * rn) * zt;
      break;
    }
    case J4: {
      const D zr = r[2] / rn;
      const D zr2 = zr * zr;
      const D zr4 = zr2 * zr2;
      const D k = recip(pow(rn, 7.0)) * D(p[0]);
      const D xy = (D(1.0) - D(14.0) * zr2) + D(21.0) * zr4;
      const D zt = (D(5.0) - (D(70.0) * zr2) * D(1.0 / 3.0)) + D(21.0) * zr4;
      a[0] = k * (r[0] * xy);
      a[1] = k * (r[1] * xy);
      a[2] = k * (r[2] * zt);
      break;
    }
    case DRAG: {
      const D alt_m = (rn - D(p[0])) * D(1000.0);
      const D rho = D(p[1]) * exp(-alt_m * D(p[2]));
      const D vn = norm3(v[0], v[1], v[2]);
      const D c = (((D(-0.5) * rho) * D(p[3])) * D(1000.0)) * vn;
      for (int i = 0; i < 3; ++i) a[i] = c * v[i];
      break;
    }
    case IMPROVED_DRAG: {
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
      break;
    }
    case SRP: {
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
      break;
    }
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
__constant__ double DP_A[STAGES][STAGES - 1] = {
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
__constant__ double DP_B8[STAGES] = {
    14005451.0 / 335480064, 0, 0, 0, 0, -59238493.0 / 1068277825,
    181606767.0 / 758867731, 561292985.0 / 797845732,
    -1041891430.0 / 1371343529, 760417239.0 / 1151165299,
    118820643.0 / 751138087, -528747749.0 / 2220607170, 1.0 / 4};
// 7th-order (embedded) weights
__constant__ double DP_B7[STAGES] = {
    13451932.0 / 455176623, 0, 0, 0, 0, -808719846.0 / 976000145,
    1757004468.0 / 5645159321, 656045339.0 / 265891186,
    -3867574721.0 / 1518517206, 465885868.0 / 322736535,
    53011238.0 / 667516719, 2.0 / 45, 0};

// one DP8(7) step of y by h (propagators/integrators.py dp87_step): the
// 8th-order state into y8 and, with EMBEDDED, the 7th-order one into y7;
// ks is the thread's column of the block's stage vectors
template <int NT, bool EMBEDDED>
__device__ __forceinline__ void dp87_step(const Model& m,
                                          double (*ks)[6][NT],
                                          const D y[6], D h, D y8[6],
                                          D y7[6]) {
  const int me = threadIdx.x;
#pragma unroll
  for (int c = 0; c < 6; ++c) y8[c] = y7[c] = y[c];
#pragma unroll 1
  for (int i = 0; i < STAGES; ++i) {
    D s[6], k[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) s[c] = y[c];
#pragma unroll 1
    for (int j = 0; j < i; ++j) {
      const double a = DP_A[i][j];
      if (a != 0.0) {
        const D ha = h * D(a);
#pragma unroll
        for (int c = 0; c < 6; ++c) s[c] = s[c] + ha * D(ks[j][c][me]);
      }
    }
    deriv(m, s, k);
#pragma unroll
    for (int c = 0; c < 6; ++c) ks[i][c][me] = k[c].v;
    if (DP_B8[i] != 0.0) {
      const D hb = h * D(DP_B8[i]);
#pragma unroll
      for (int c = 0; c < 6; ++c) y8[c] = y8[c] + hb * k[c];
    }
    if (EMBEDDED && DP_B7[i] != 0.0) {
      const D hb = h * D(DP_B7[i]);
#pragma unroll
      for (int c = 0; c < 6; ++c) y7[c] = y7[c] + hb * k[c];
    }
  }
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
        D y8[6], y7[6];
        dp87_step<NT, false>(m, ks, y, D(h), y8, y7);
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

// ADAPTIVE: dp87_adaptive from t0 to t1 on one thread, starting with step
// h0 (signed); out = [state (6), t, h, substeps]
__global__ void __launch_bounds__(1) integrate_adaptive_kernel(
    const double* __restrict__ state0, double* __restrict__ out, double t0,
    double t1, double h0, double direction, double rtol, double atol,
    double h_min, double h_max, long long max_substeps, Model model) {
  __shared__ Model m;
  __shared__ double ks[STAGES][6][1];
  stage_model(m, model);
  D y[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) y[c] = state0[c];
  const D end = t1, dir = direction, zero = 0.0;
  D t = t0, h = h0;
  long long steps = 0;
#pragma unroll 1
  while ((t - end) * dir < zero && steps < max_substeps) {
    // a step that would overshoot t1 ends on it
    const D hs = ((t + h) - end) * dir > zero ? end - t : h;
    D y8[6], y7[6];
    dp87_step<1, true>(m, ks, y, hs, y8, y7);
    // max(|y8 - y7| / (atol + rtol * max(|y|, |y8|))), NaN wins
    D err_norm = 0.0;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const D scale = D(rtol) * maximum(fabs(y[c]), fabs(y8[c])) + D(atol);
      const D e = fabs(y8[c] - y7[c]) / scale;
      err_norm = c == 0 ? e : maximum(err_norm, e);
    }
    const D factor = py_min(
        py_max(D(0.9) * pow(py_max(err_norm, D(1e-16)), -1.0 / 8.0), D(0.1)),
        D(5.0));
    h = py_min(py_max(fabs(hs * factor), D(h_min)), D(h_max)) * dir;
    if (err_norm <= D(1.0)) {
#pragma unroll
      for (int c = 0; c < 6; ++c) y[c] = y8[c];
      t = t + hs;
    }
    ++steps;
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) out[c] = y[c].v;
  out[6] = t.v;
  out[7] = h.v;
  out[8] = (double)steps;
}

// quaternion kinematics and Euler's equations (calculations.py
// propagate_attitude's deriv): qd = 0.5 q * [0, w], wd = (T - w x (I w)) / I
__device__ __forceinline__ void attitude_deriv(const D q[4], const D w[3],
                                               const D I[3], const D T[3],
                                               D qd[4], D wd[3]) {
  const D z = 0.0, half = 0.5;
  qd[0] = half * (((q[0] * z - q[1] * w[0]) - q[2] * w[1]) - q[3] * w[2]);
  qd[1] = half * (((q[0] * w[0] + q[1] * z) + q[2] * w[2]) - q[3] * w[1]);
  qd[2] = half * (((q[0] * w[1] - q[1] * w[2]) + q[2] * z) + q[3] * w[0]);
  qd[3] = half * (((q[0] * w[2] + q[1] * w[1]) - q[2] * w[0]) + q[3] * z);
  const D iw[3] = {I[0] * w[0], I[1] * w[1], I[2] * w[2]};
  const D cr[3] = {cross_term(w[1], iw[2], w[2], iw[1]),
                   cross_term(w[2], iw[0], w[0], iw[2]),
                   cross_term(w[0], iw[1], w[1], iw[0])};
#pragma unroll
  for (int c = 0; c < 3; ++c) wd[c] = (T[c] - cr[c]) / I[c];
}

// ATTITUDE: body x's (q, w) through n_steps RK4 steps of dt
__global__ void __launch_bounds__(ATTITUDE_BLOCK) integrate_attitude_kernel(
    const double* __restrict__ q0, const double* __restrict__ w0,
    const double* __restrict__ inertia, const double* __restrict__ torque,
    double* __restrict__ q_out, double* __restrict__ w_out,
    long long n_bodies, long long n_steps, double dt) {
  const long long b = (long long)blockIdx.x * ATTITUDE_BLOCK + threadIdx.x;
  if (b >= n_bodies) return;
  D q[4], w[3], I[3], T[3];
#pragma unroll
  for (int c = 0; c < 4; ++c) q[c] = q0[b * 4 + c];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    w[c] = w0[b * 3 + c];
    I[c] = inertia[b * 3 + c];
    T[c] = torque[b * 3 + c];
  }
  const D h = dt, half = D(0.5) * h, sixth = h / D(6.0);
#pragma unroll 1
  for (long long n = 0; n < n_steps; ++n) {
    D sq[4], sw[3], kq[4], kw[3], aq[4], aw[3];
#pragma unroll
    for (int c = 0; c < 4; ++c) sq[c] = q[c];
#pragma unroll
    for (int c = 0; c < 3; ++c) sw[c] = w[c];
#pragma unroll 1
    for (int st = 0; st < 4; ++st) {
      attitude_deriv(sq, sw, I, T, kq, kw);
      const D wt = st == 1 || st == 2 ? D(2.0) : D(1.0);
      const D off = st == 2 ? h : half;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        aq[c] = st == 0 ? kq[c] : aq[c] + wt * kq[c];
        sq[c] = q[c] + off * kq[c];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        aw[c] = st == 0 ? kw[c] : aw[c] + wt * kw[c];
        sw[c] = w[c] + off * kw[c];
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) q[c] = q[c] + sixth * aq[c];
#pragma unroll
    for (int c = 0; c < 3; ++c) w[c] = w[c] + sixth * aw[c];
    const D n4 = norm4(q[0], q[1], q[2], q[3]);
#pragma unroll
    for (int c = 0; c < 4; ++c) q[c] = q[c] / n4;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) q_out[b * 4 + c] = q[c].v;
#pragma unroll
  for (int c = 0; c < 3; ++c) w_out[b * 3 + c] = w[c].v;
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

// ADAPTIVE: state0 (6,) f64, out (9,) f64 = state, t, h, substeps.
extern "C" int astroz_integrate_adaptive(
    const double* state0, double* out, double t0, double t1, double h0,
    double direction, double rtol, double atol, double h_min, double h_max,
    long long max_substeps, int n_terms, const int* kinds,
    const double* params, void* stream) {
  Model m;
  if (!make_model(n_terms, kinds, params, &m)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  integrate_adaptive_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      state0, out, t0, t1, h0, direction, rtol, atol, h_min, h_max,
      max_substeps, m);
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
