// Near-earth SGP4 propagation for Hopper: kernel K1, its merge variant
// K3, its two dense-grid variants K5 and K6, which share the f32 tail
// (shallow_tail below), and the f64 spine kernel that feeds K6. K1 and K3
// are modes of one blocked kernel (sgp4_shallow_kernel), K5 and K6
// instantiations of one persistent kernel (sgp4_dense_kernel).
//
// K1 (SEP) replaces the TPU kernel astroz_tpu/ops/pallas_sgp4.py:
// _kernel_fused_sep (wrapper propagate_fast_pallas_sep). For every
// (time t, satellite s):
//   tsince = t_time[t] - t_sat[s]                         (f64)
//   spine: secular angles in f64, reduced mod 2pi, cast to f32
//   tail:  drag, Newton Kepler (3/4/5/8 trips), J2 short-period terms,
//          TEME r (and v) in f32 with a polynomial sincos
//   errors 1/4/6 over the init error; failed points zero-filled.
// K3 (MERGE) replaces _kernel_fused_sep_merge (wrapper
// propagate_fast_pallas_sep_merge): K1 over a mixed catalog whose deep
// columns are copied from kernel K2's (3, T, D) / (T, D) planes. One
// launch has two ranges of blocks: tail blocks, whose thread k runs K1's
// body for column near_cols[k], and copy blocks, whose consecutive
// threads take consecutive deep slots and copy K2's planes to
// deep_cols[slot]. No warp mixes the copy with the tail, no thread
// branches on a slot, and a deep column's shallow fields are never read:
// it is a select, never a blend, and every near-earth column is K1, bit
// for bit. The TPU kernel scattered the deep columns with a bf16 one-hot
// matmul on its matrix unit; here the maps do it, with no bound on the
// deep fraction.
// K5 (sgp4_dense_kernel<..., TSINCE>) replaces _kernel_fused (wrapper
// propagate_fast_pallas_fused): K1 on a dense tsince grid, read directly
// as f64, either a (T, S) grid or a (T, 1) column read with a satellite
// stride of 0, so a grid shared by every satellite is never materialised
// at (T, S). The TPU kernel took tsince split into f32 hi/lo grids, ran a
// double-f32 (Dekker) spine and wrote planes that XLA transposed; here
// the spine is K1's, in native f64.
// K6 (sgp4_dense_kernel<..., GRIDS>) replaces _kernel (wrapper
// propagate_fast_pallas): the tail alone, on the six (T, S) f32 grids
// (t32, u_base, mm, argp32, node32, xmdf32) of the f64 spine.
// The spine kernel (sgp4_spine_grids_kernel) writes those grids: the f64
// spine of K5 (spine_f64) on a (T, S) or (T, 1) f64 tsince, one pass. On
// the TPU XLA fused that spine around the Pallas call
// (pallas_sgp4.py:139); it is not a Pallas kernel.
// K5 and K6 write the time-major (T, S, 3) r and v that their callers
// return (store_point_time_major), and nothing else.
//
// The plain torch version is astroz_tpu_torch/ops/fast.py (spine_f64 +
// shallow_tail_f32); this file runs the same operations in the same order
// (sgp4_common.cuh says how the bits are kept), so a K5 point equals the
// K1 point of the same tsince, a spine grid the plain spine, and a K6
// point the K5 point of the same spine, bit for bit.
//
// Bound. At 13,478 x 1,440 each point stores 28 bytes (16 without
// velocities) and does ~440 f32 and ~28 f64 operations, five reductions
// mod 2pi and ~8 IEEE divides and square roots. The stores alone would
// take 0.163 ms at 3.35 TB/s; K1 takes ~0.66 ms on an H100 SXM at a 700 W
// limit, ~1,150 issue slots a point at 3.35e13 lane-instructions/s, so
// instruction issue bounds it, and K3 and K5 with it. K6 reads 24 bytes
// of grids a point and skips the spine; the spine kernel reads 8 bytes
// (or none, from a column) and writes 24, so bytes bound it. What the
// design does about it (each choice timed in turns on the card by
// shallow_variants.py at the repository root, which builds each variant
// from an edited copy):
// - the five reductions are one FMA each with an f64 quotient
//   (sgp4_common.cuh: fmod_two_pi) in place of CUDA's fmod, a loop of f64
//   steps once per bit of the quotient whose lanes diverge: K1 0.86 ->
//   0.66 ms, K5 0.26 -> 0.20 ms on a year of seconds;
// - K3 runs the tail on the near-earth columns only and copies the deep
//   ones in blocks of their own: 0.92 -> 0.66 ms, no slower than K1;
// - 128-thread blocks at 96 registers, 5 blocks (31% occupancy) an SM:
//   forcing 6 spills and slows K3, 8 slows K3 more; 16 or 32 time rows a
//   thread, and two rows in flight in one thread, were slower;
// - no FMA contraction (--fmad=false, for the plain versions' bits), so
//   every multiply-add is two instructions: contracting all of them would
//   save 10% of K1 (the f32 tail 9%), but most sit in the polynomial
//   sincos, angle_add and the Newton step, which the plain versions keep
//   equal to the JAX package's; the rest would save 3%;
// - K5 and K6 run on a persistent grid (sgp4_common.cuh: warp_run): no
//   more blocks than fit on the card at once, each warp a run of (warp
//   column, time row) units that differ by at most one, so no wave runs
//   part full (the grid of 8-row blocks ran 6.2 waves at a bench chunk,
//   K6's 3.9). K5's walk alone cost registers (101, so 4 blocks an SM,
//   and it was slower), so its 33 fields live in shared memory, read
//   where they are used, and __launch_bounds__ holds the tail to 64
//   registers without a spill: 8 blocks (50% occupancy) an SM; each unit
//   loads the next unit's tsince before its own tail runs. K5 at one
//   (4,096, 1,024) chunk, replayed from a CUDA graph: 0.195 -> 0.186-0.190
//   ms; its row loop's hot path is 979 SASS instructions a point with
//   both sides of each branch counted (chip_smoke.kernel_report on the
//   built library), so it issues at no more than ~66% of the card's rate.
//   K6 has no spine fields: its 21 tail fields fit in registers at 64
//   without a spill, 8 blocks an SM, and it loads a unit's six grid
//   values at the head of the unit: 742 hot instructions a point, 0.159
//   ms a chunk, time-major as in planes (on K1's blocked layout of 8
//   rows a thread: 644, 0.159 ms, planes only). In shared memory the
//   fields cost 52 more instructions a point (+0.8%); loading the next
//   unit's values ahead cost 26 more and +4.9% (both: +3.5%), so K6 does
//   not wait on those loads; a cp.async ring of 2 units (+3.8%), 8-byte
//   loads of satellite pairs (a spill) and 6, 7 or 10 blocks an SM were
//   no better (PERF.md);
// - the spine kernel keeps each satellite's 12 spine fields in registers
//   over SPINE_ROWS = 4 time rows of its column (2 rows +0.5%, 8 +2.2%,
//   16 +4.3%, 64 +34%: at 64 a chunk has 512 blocks, under half of what
//   the card holds at once); neighbouring threads take neighbouring
//   satellites, so every load and store is contiguous across a warp.
// K1 and K3: one thread owns one satellite and ROWS time rows, loads
// the satellite's fields into registers once, and neighbouring threads
// take neighbouring satellites, so the loads of the (rows, S) field
// matrices and the stores to the (3, T, S) planes are contiguous across a
// warp; K5's and K6's warps keep the same satellite-per-lane layout.
// Outputs are exact-shape; the ragged satellite and time edges are
// masked.

#include "sgp4_common.cuh"

namespace {

constexpr int BLOCK = 128;  // satellites per block
constexpr int ROWS = 8;     // time rows per thread (K1, K3)

constexpr int N_SPINE = 12;  // ops/fast.py SPINE_FIELD_NAMES
constexpr int N_TAIL = 21;   // ops/fast.py TAIL_FIELD_NAMES

// where each mode of sgp4_shallow_kernel finds its times; the values
// name the instantiations in ptxas' reports (shallow_variants.py)
enum Mode : int {
  SEP = 0,    // K1: t_time[t] - t_sat[s]
  MERGE = 1,  // K3: K1 on the near-earth columns, K2's planes on the rest
};

// where sgp4_dense_kernel finds a unit's spine
enum Source : int {
  TSINCE = 0,  // K5: spine_f64 of the f64 tsince
  GRIDS = 1,   // K6: the six f32 spine grids
};

// blocks an SM that __launch_bounds__ asks registers for (the fields
// live in shared memory, so the tail alone sets the registers): K5, K6
constexpr int DENSE_MIN_BLOCKS = 8;
constexpr int GRIDS_MIN_BLOCKS = 8;

// the spine kernel: time rows a thread
constexpr int SPINE_ROWS = 4;

// kernel K2's outputs and the column maps of a mixed catalog (K3 only)
struct DeepPlanes {
  const int* near_cols;  // (S - D,) i32: the near-earth columns
  int n_near;            // S - D
  const int* deep_cols;  // (D,) i32: the column of each deep slot
  const float* r;        // (3, T, D) f32
  const float* v;        // (3, T, D) f32, null without velocities
  const int* err;        // (T, D) i32
  int n_deep;            // D
};

// the f32 angles of one point (fast.spine_f64's returns)
struct Spine {
  float t32, u_base, mm, argp32, node32, xmdf32;
};

// fast.spine_f64 at t minutes from epoch; sp[k] is SPINE_FIELD_NAMES[k]
// (registers, or SharedFields)
template <class SpineFields>
__device__ __forceinline__ Spine spine_f64(double t, const SpineFields& sp) {
  const double mo = sp[0], mdot = sp[1], argpo = sp[2], argpdot = sp[3];
  const double nodeo = sp[4], nodedot = sp[5], nodecf = sp[6];
  const double no_unkozai = sp[7], t2cof = sp[8], t3cof = sp[9];
  const double t4cof = sp[10], t5cof = sp[11];
  const double xmdf = mo + mdot * t;
  const double argpdf = argpo + argpdot * t;
  const double t2 = t * t;
  const double nodem64 = nodeo + nodedot * t + nodecf * t2;
  const double templ_big =
      no_unkozai * t2 * (t2cof + t * (t3cof + t * (t4cof + t * t5cof)));
  const double mm_spine = xmdf + templ_big;
  Spine g;
  g.t32 = __double2float_rn(t);
  g.u_base = __double2float_rn(rem_two_pi(mm_spine + argpdf));
  g.mm = __double2float_rn(rem_two_pi(mm_spine));
  g.argp32 = __double2float_rn(rem_two_pi(argpdf));
  g.node32 = __double2float_rn(rem_two_pi(nodem64));
  g.xmdf32 = __double2float_rn(rem_two_pi(xmdf));
  return g;
}

// fast.shallow_tail_f32 at one point; tf[k] is TAIL_FIELD_NAMES[k]
// (registers, or SharedFields)
template <bool WANT_VEL, int ITERS, class TailFields>
__device__ __forceinline__ PosVel shallow_tail(
    const Spine& g, const TailFields& tf, bool not_simp, int error0,
    float j2, float re, float vkmpersec) {
  const float omgcof = tf[0], eta = tf[1], xmcof = tf[2], delmo = tf[3];
  const float cc1 = tf[4], d2 = tf[5], d3 = tf[6], d4 = tf[7];
  const float bstar = tf[8], cc4 = tf[9], cc5 = tf[10], sinmao = tf[11];
  const float ecco = tf[12], sinip = tf[13], cosip = tf[14], a = tf[15];
  const float aycof = tf[16], xlcof = tf[17], con41 = tf[18];
  const float x1mth2 = tf[19], x7thm1 = tf[20];
  const float t32 = g.t32;

  // ---- drag; cos(xmdf) as in SGP4 --------------------------------------
  int error = error0;
  float cos_xmdf, sin_unused;
  sincos_poly(g.xmdf32, sin_unused, cos_xmdf);
  const float delmtemp = 1.0f + eta * cos_xmdf;
  const float tempd =
      omgcof * t32 + xmcof * (delmtemp * delmtemp * delmtemp - delmo);
  const float mm_drag = not_simp ? g.mm + tempd : g.mm;
  const float t2_32 = t32 * t32;
  const float tempa = 1.0f - cc1 * t32 - d2 * t2_32 - d3 * t2_32 * t32 -
                      d4 * t2_32 * t2_32;
  float sin_mm, cos_unused;
  sincos_poly(mm_drag, sin_mm, cos_unused);
  const float tempe = bstar * cc4 * t32 +
                      (not_simp ? bstar * cc5 * (sin_mm - sinmao) : 0.0f);

  const float am = a * tempa * tempa;
  const float am_safe = am > 0.0f ? am : 1.0f;
  const float rsq_am = 1.0f / sqrtf(am_safe);

  float em = ecco - tempe;
  if ((em >= 1.0f || em < F32(-0.001)) && error == 0) error = 1;
  em = clampf(em, F32(1.0e-6), F32(0.999999));

  // "+ 0.0f" as in the plain version (it turns -0 into +0)
  float sin_node, cos_node;
  sincos_poly(g.node32 + 0.0f, sin_node, cos_node);
  const float argpp = (not_simp ? g.argp32 - tempd : g.argp32) + 0.0f;

  // ---- long-period terms -> Kepler -> TEME (fast._kepler_posvel_f32) ---
  return kepler_posvel<WANT_VEL, ITERS>(
      g.u_base, am, am_safe, rsq_am, em, argpp, sin_node, cos_node, sinip,
      cosip, aycof, xlcof, con41, x1mth2, x7thm1, error, j2, re, vkmpersec);
}

// K3's copy blocks: deep slot `slot`'s rows [t_begin, t_end) of K2's
// planes, as they are, into its column of the outputs
template <bool WANT_VEL>
__device__ __forceinline__ void copy_deep_slot(const DeepPlanes& deep,
                                               int slot, int t_begin,
                                               int t_end, int n_times,
                                               size_t ns, float* r, float* v,
                                               int* err) {
  const size_t col = (size_t)deep.deep_cols[slot];
  const size_t nd = (size_t)deep.n_deep;
  const size_t plane = (size_t)n_times * ns;
  const size_t dplane = (size_t)n_times * nd;
  for (int ti = t_begin; ti < t_end; ++ti) {
    const size_t idx = (size_t)ti * ns + col;
    const size_t di = (size_t)ti * nd + slot;
#pragma unroll
    for (int c = 0; c < 3; ++c) r[c * plane + idx] = deep.r[c * dplane + di];
    err[idx] = deep.err[di];
    if (WANT_VEL) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        v[c * plane + idx] = deep.v[c * dplane + di];
    }
  }
}

template <bool WANT_VEL, int ITERS, int MODE>
__global__ void __launch_bounds__(BLOCK)
sgp4_shallow_kernel(const double* __restrict__ t_time,
                    const double* __restrict__ t_sat,
                    const double* __restrict__ spine,
                    const float* __restrict__ tail,
                    const int* __restrict__ flags, int n_times, int n_sats,
                    float j2, float re, float vkmpersec, DeepPlanes deep,
                    float* __restrict__ r, float* __restrict__ v,
                    int* __restrict__ err) {
  const int t_begin = blockIdx.y * ROWS;
  const int t_end = min(t_begin + ROWS, n_times);
  const size_t ns = (size_t)n_sats;
  const size_t plane = (size_t)n_times * ns;
  int s = blockIdx.x * BLOCK + threadIdx.x;

  if constexpr (MODE == MERGE) {
    // blocks [0, tail_blocks) run the tail, the rest copy deep slots
    const int tail_blocks = (deep.n_near + BLOCK - 1) / BLOCK;
    if ((int)blockIdx.x >= tail_blocks) {
      const int slot = ((int)blockIdx.x - tail_blocks) * BLOCK + threadIdx.x;
      if (slot < deep.n_deep)
        copy_deep_slot<WANT_VEL>(deep, slot, t_begin, t_end, n_times, ns, r,
                                 v, err);
      return;
    }
    if (s >= deep.n_near) return;
    s = deep.near_cols[s];
  } else {
    if (s >= n_sats) return;
  }

  // per-satellite fields, loaded once (rows of SoA matrices: coalesced)
  double sp[N_SPINE];
#pragma unroll
  for (int k = 0; k < N_SPINE; ++k) sp[k] = spine[k * ns + s];
  float tf[N_TAIL];
#pragma unroll
  for (int k = 0; k < N_TAIL; ++k) tf[k] = tail[k * ns + s];
  const bool not_simp = flags[s] == 0;
  const int error0 = flags[ns + s];
  const double epoch = t_sat[s];

  for (int ti = t_begin; ti < t_end; ++ti) {
    const Spine g = spine_f64(t_time[ti] - epoch, sp);
    const PosVel o = shallow_tail<WANT_VEL, ITERS>(g, tf, not_simp, error0,
                                                   j2, re, vkmpersec);
    store_point<WANT_VEL>(o, (size_t)ti * ns + s, plane, r, v, err);
  }
}

// K5's and K6's inputs and outputs; each reads only its own inputs
struct DenseArgs {
  const double* tsince;   // K5: (T, S) f64, or (T, 1) with sat_stride 0
  int sat_stride;         // 1 for a (T, S) grid (K6 always), 0 for (T, 1)
  const double* spine;    // K5: (12, S) f64
  const float* grids[6];  // K6: (T, S) f32 t32, u_base, mm, argp32,
                          // node32, xmdf32
  const float* tail;
  const int* flags;
  int n_times, n_sats;
  float j2, re, vkmpersec;
  float* r;  // (T, S, 3) f32
  float* v;  // (T, S, 3) f32, or null
  int* err;  // (T, S) i32
};

// what a thread loads for one unit, and the unit's spine from it: K5
// its tsince, K6 its six grid values; idx = t * row_stride + s *
// sat_stride
template <int SRC>
struct UnitInput;

template <>
struct UnitInput<TSINCE> {
  double t;
  __device__ __forceinline__ void load(const DenseArgs& a, size_t idx) {
    t = a.tsince[idx];
  }
  template <class SpineFields>
  __device__ __forceinline__ Spine spine(const SpineFields& sp) const {
    return spine_f64(t, sp);
  }
};

template <>
struct UnitInput<GRIDS> {
  Spine g;
  __device__ __forceinline__ void load(const DenseArgs& a, size_t idx) {
    g.t32 = a.grids[0][idx];
    g.u_base = a.grids[1][idx];
    g.mm = a.grids[2][idx];
    g.argp32 = a.grids[3][idx];
    g.node32 = a.grids[4][idx];
    g.xmdf32 = a.grids[5][idx];
  }
  template <class SpineFields>
  __device__ __forceinline__ Spine spine(const SpineFields&) const {
    return g;
  }
};

// K5 and K6: each warp walks its run of (warp column, time row) units
// (sgp4_common.cuh: warp_run); a thread owns one satellite of the column.
// K5 keeps its 33 fields in shared memory and loads the next unit's
// tsince before it runs the current one's tail; K6, which has no spine
// fields, keeps its 21 tail fields in registers and loads a unit's six
// grid values at the head of the unit (timed in turns against the
// alternatives: PERF.md).
template <bool WANT_VEL, int ITERS, int SRC>
__global__ void __launch_bounds__(
    BLOCK, SRC == GRIDS ? GRIDS_MIN_BLOCKS : DENSE_MIN_BLOCKS)
sgp4_dense_kernel(const DenseArgs a) {
  constexpr bool AHEAD = SRC == TSINCE;
  __shared__ double spine_rows[SRC == TSINCE ? N_SPINE : 1][BLOCK];
  __shared__ float tail_rows[SRC == TSINCE ? N_TAIL : 1][BLOCK];
  SharedFields<double, N_SPINE, BLOCK> sp{spine_rows};
  auto tf = [&] {
    if constexpr (SRC == GRIDS)
      return RegFields<float, N_TAIL>{};
    else
      return SharedFields<float, N_TAIL, BLOCK>{tail_rows};
  }();
  const int n_times = a.n_times, n_sats = a.n_sats;
  const size_t ns = (size_t)n_sats;
  const size_t row_stride = a.sat_stride ? ns : 1;
  const WarpRun run =
      warp_run((long long)((n_sats + WARP - 1) / WARP) * n_times);
  if (run.count == 0) return;
  int col = (int)(run.first / n_times);
  int ti = (int)(run.first % n_times);
  int s = col * WARP + (int)(threadIdx.x % WARP);
  int loaded = -1;
  bool not_simp = false;
  int error0 = 0;
  UnitInput<SRC> in{};
  if (AHEAD && s < n_sats)
    in.load(a, (size_t)ti * row_stride + (size_t)s * a.sat_stride);
  for (long long k = run.count; k > 0; --k) {
    if (col != loaded) {
      if (s < n_sats) {
        if constexpr (SRC == TSINCE) sp.load(a.spine, ns, s);
        tf.load(a.tail, ns, s);
        not_simp = a.flags[s] == 0;
        error0 = a.flags[ns + s];
      }
      loaded = col;
    }
    const int t_row = ti, t_sat = s;
    if (!AHEAD && t_sat < n_sats)
      in.load(a, (size_t)t_row * row_stride + (size_t)t_sat * a.sat_stride);
    const UnitInput<SRC> cur = in;
    if (++ti == n_times) {
      ti = 0;
      ++col;
      s += WARP;
    }
    if (AHEAD && k > 1 && s < n_sats)
      in.load(a, (size_t)ti * row_stride + (size_t)s * a.sat_stride);
    if (t_sat < n_sats) {
      const PosVel o = shallow_tail<WANT_VEL, ITERS>(
          cur.spine(sp), tf, not_simp, error0, a.j2, a.re, a.vkmpersec);
      store_point_time_major<WANT_VEL>(o, (size_t)t_row * ns + t_sat, a.r,
                                       a.v, a.err);
    }
  }
}

// The spine kernel: the six (T, S) f32 grids of fast.spine_f64 on a
// (T, S) f64 tsince, or a (T, 1) column read with a satellite stride of
// 0. Thread k of block (x, y) owns satellite x * BLOCK + k at rows
// [y * SPINE_ROWS, (y + 1) * SPINE_ROWS).
__global__ void __launch_bounds__(BLOCK)
sgp4_spine_grids_kernel(const double* __restrict__ tsince, int sat_stride,
                        const double* __restrict__ spine, int n_times,
                        int n_sats, float* __restrict__ t32,
                        float* __restrict__ u_base, float* __restrict__ mm,
                        float* __restrict__ argp32,
                        float* __restrict__ node32,
                        float* __restrict__ xmdf32) {
  const int s = blockIdx.x * BLOCK + threadIdx.x;
  if (s >= n_sats) return;
  const size_t ns = (size_t)n_sats;
  const size_t row_stride = sat_stride ? ns : 1;
  double sp[N_SPINE];
#pragma unroll
  for (int k = 0; k < N_SPINE; ++k) sp[k] = spine[k * ns + s];
  const int t_begin = blockIdx.y * SPINE_ROWS;
  const int t_end = min(t_begin + SPINE_ROWS, n_times);
  for (int ti = t_begin; ti < t_end; ++ti) {
    const Spine g = spine_f64(
        tsince[(size_t)ti * row_stride + (size_t)s * sat_stride], sp);
    const size_t idx = (size_t)ti * ns + s;
    t32[idx] = g.t32;
    u_base[idx] = g.u_base;
    mm[idx] = g.mm;
    argp32[idx] = g.argp32;
    node32[idx] = g.node32;
    xmdf32[idx] = g.xmdf32;
  }
}

// every argument of K1 and K3; K1 reads no deep planes
struct Args {
  const double* t_time;
  const double* t_sat;
  const double* spine;
  const float* tail;
  const int* flags;
  int n_times, n_sats;
  float j2, re, vkmpersec;
  DeepPlanes deep;
  float* r;
  float* v;
  int* err;
};

template <bool WANT_VEL, int MODE>
cudaError_t launch(int kepler_iters, dim3 grid, cudaStream_t stream,
                   const Args& a) {
#define ASTROZ_LAUNCH(IT)                                                  \
  sgp4_shallow_kernel<WANT_VEL, IT, MODE><<<grid, BLOCK, 0, stream>>>(     \
      a.t_time, a.t_sat, a.spine, a.tail, a.flags, a.n_times, a.n_sats,    \
      a.j2, a.re, a.vkmpersec, a.deep, a.r, a.v, a.err)
  switch (kepler_iters) {
    case 3: ASTROZ_LAUNCH(3); break;
    case 4: ASTROZ_LAUNCH(4); break;
    case 5: ASTROZ_LAUNCH(5); break;
    case 8: ASTROZ_LAUNCH(8); break;
    default: return cudaErrorInvalidValue;
  }
#undef ASTROZ_LAUNCH
  return cudaGetLastError();
}

int blocks_of(int n) { return (n + BLOCK - 1) / BLOCK; }

template <int MODE>
int launch_vel(int want_vel, int kepler_iters, const Args& a, void* stream) {
  // K3: the tail blocks of the near-earth columns, then the copy blocks
  const int x_blocks =
      MODE == MERGE ? blocks_of(a.deep.n_near) + blocks_of(a.deep.n_deep)
                    : blocks_of(a.n_sats);
  const dim3 grid(x_blocks, (a.n_times + ROWS - 1) / ROWS);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      want_vel ? launch<true, MODE>(kepler_iters, grid, st, a)
               : launch<false, MODE>(kepler_iters, grid, st, a);
  return static_cast<int>(rc);
}

constexpr DeepPlanes NO_DEEP{nullptr, 0, nullptr, nullptr, nullptr, nullptr,
                             0};

// K5 or K6: the persistent grid of one instantiation, then (with
// `launch`) the launch on it
template <bool WANT_VEL, int ITERS, int SRC>
cudaError_t dense_run(const DenseArgs& a, cudaStream_t stream, bool launch,
                      Grid* g) {
  static int per_sm = 0;  // this instantiation's blocks an SM
  const long long units =
      (long long)((a.n_sats + WARP - 1) / WARP) * a.n_times;
  const cudaError_t rc = persistent_grid(
      sgp4_dense_kernel<WANT_VEL, ITERS, SRC>, BLOCK, per_sm, units, g);
  if (rc != cudaSuccess || !launch || g->blocks == 0) return rc;
  sgp4_dense_kernel<WANT_VEL, ITERS, SRC><<<g->blocks, BLOCK, 0, stream>>>(
      a);
  return cudaGetLastError();
}

template <bool WANT_VEL, int SRC>
cudaError_t dense_iters(int kepler_iters, const DenseArgs& a,
                        cudaStream_t stream, bool launch, Grid* g) {
  switch (kepler_iters) {
    case 3: return dense_run<WANT_VEL, 3, SRC>(a, stream, launch, g);
    case 4: return dense_run<WANT_VEL, 4, SRC>(a, stream, launch, g);
    case 5: return dense_run<WANT_VEL, 5, SRC>(a, stream, launch, g);
    case 8: return dense_run<WANT_VEL, 8, SRC>(a, stream, launch, g);
    default: return cudaErrorInvalidValue;
  }
}

template <int SRC>
int dense(int want_vel, int kepler_iters, const DenseArgs& a, void* stream,
          bool launch, int* grid) {
  Grid g{0, 0, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      want_vel ? dense_iters<true, SRC>(kepler_iters, a, st, launch, &g)
               : dense_iters<false, SRC>(kepler_iters, a, st, launch, &g);
  if (grid != nullptr) {
    grid[0] = g.per_sm;
    grid[1] = g.sms;
    grid[2] = g.blocks;
  }
  return static_cast<int>(rc);
}

template <int SRC>
int dense_grid(int n_times, int n_sats, int kepler_iters, int want_vel,
               int* grid) {
  DenseArgs a{};
  a.n_times = n_times;
  a.n_sats = n_sats;
  return dense<SRC>(want_vel, kepler_iters, a, nullptr, false, grid);
}

}  // namespace

// Plain C entry points (bound with ctypes by astroz_tpu_torch/_build.py).
// Shapes: t_time (T,) f64; t_sat (S,) f64; spine (12, S) f64;
// tail (21, S) f32; flags (2, S) i32 = [isimp, init error];
// r (3, T, S) f32; v (3, T, S) f32 or null when want_vel == 0;
// err (T, S) i32. All contiguous on the current device. Launch on
// `stream` and return the launch's cudaError_t (0 = success).

// K1
extern "C" int astroz_sgp4_shallow(const double* t_time, const double* t_sat,
                                   const double* spine, const float* tail,
                                   const int* flags, int n_times, int n_sats,
                                   int kepler_iters, int want_vel, float j2,
                                   float re, float vkmpersec, float* r,
                                   float* v, int* err, void* stream) {
  const Args a{t_time, t_sat, spine,  tail,     flags,   n_times, n_sats,
               j2,     re,    vkmpersec, NO_DEEP, r,       v,       err};
  return launch_vel<SEP>(want_vel, kepler_iters, a, stream);
}

// K3: K1's arguments plus the column maps near_cols (S - D,) i32 and
// deep_cols (D,) i32 (the column of each deep slot; together they hold
// every column once) and kernel K2's planes dr (3, T, D) f32, dv (3, T,
// D) f32 (null when want_vel == 0) and de (T, D) i32.
extern "C" int astroz_sgp4_shallow_merge(
    const double* t_time, const double* t_sat, const double* spine,
    const float* tail, const int* flags, int n_times, int n_sats,
    int kepler_iters, int want_vel, float j2, float re, float vkmpersec,
    const int* near_cols, int n_near, const int* deep_cols, const float* dr,
    const float* dv, const int* de, int n_deep, float* r, float* v, int* err,
    void* stream) {
  const Args a{t_time, t_sat, spine, tail, flags, n_times, n_sats, j2, re,
               vkmpersec,
               DeepPlanes{near_cols, n_near, deep_cols, dr, dv, de, n_deep},
               r, v, err};
  return launch_vel<MERGE>(want_vel, kepler_iters, a, stream);
}

// K5: K1 on tsince (T, S) f64 minutes since each satellite's epoch, or a
// (T, 1) column shared by every satellite (sat_stride 0; 1 for (T, S)).
// r and v are (T, S, 3) f32 (v null when want_vel == 0), err (T, S) i32.
extern "C" int astroz_sgp4_shallow_dense(
    const double* tsince, int sat_stride, const double* spine,
    const float* tail, const int* flags, int n_times, int n_sats,
    int kepler_iters, int want_vel, float j2, float re, float vkmpersec,
    float* r, float* v, int* err, void* stream) {
  const DenseArgs a{tsince, sat_stride, spine, {}, tail, flags, n_times,
                    n_sats, j2,         re,    vkmpersec, r, v,  err};
  return dense<TSINCE>(want_vel, kepler_iters, a, stream, true, nullptr);
}

// K5's grid at (n_times, n_sats) without a launch: grid[0] blocks an SM
// of the instantiation, grid[1] the card's SMs, grid[2] blocks launched
extern "C" int astroz_sgp4_shallow_dense_grid(int n_times, int n_sats,
                                              int kepler_iters, int want_vel,
                                              int* grid) {
  return dense_grid<TSINCE>(n_times, n_sats, kepler_iters, want_vel, grid);
}

// K6: the tail on six (T, S) f32 spine grids t32, u_base, mm, argp32,
// node32, xmdf32 (ops/fast.py:spine_f64's returns); no spine rows.
// r, v and err as K5's.
extern "C" int astroz_sgp4_shallow_grids(
    const float* t32, const float* u_base, const float* mm,
    const float* argp32, const float* node32, const float* xmdf32,
    const float* tail, const int* flags, int n_times, int n_sats,
    int kepler_iters, int want_vel, float j2, float re, float vkmpersec,
    float* r, float* v, int* err, void* stream) {
  const DenseArgs a{nullptr, 1,      nullptr,
                    {t32, u_base, mm, argp32, node32, xmdf32},
                    tail,    flags,  n_times, n_sats, j2, re, vkmpersec,
                    r,       v,      err};
  return dense<GRIDS>(want_vel, kepler_iters, a, stream, true, nullptr);
}

// K6's grid, as astroz_sgp4_shallow_dense_grid gives K5's
extern "C" int astroz_sgp4_shallow_grids_grid(int n_times, int n_sats,
                                              int kepler_iters, int want_vel,
                                              int* grid) {
  return dense_grid<GRIDS>(n_times, n_sats, kepler_iters, want_vel, grid);
}

// The spine kernel: tsince (T, S) f64, or (T, 1) with sat_stride 0; spine
// (12, S) f64; the six outputs (T, S) f32 each.
extern "C" int astroz_sgp4_spine_grids(
    const double* tsince, int sat_stride, const double* spine, int n_times,
    int n_sats, float* t32, float* u_base, float* mm, float* argp32,
    float* node32, float* xmdf32, void* stream) {
  const dim3 grid(blocks_of(n_sats),
                  (n_times + SPINE_ROWS - 1) / SPINE_ROWS);
  sgp4_spine_grids_kernel<<<grid, BLOCK, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      tsince, sat_stride, spine, n_times, n_sats, t32, u_base, mm, argp32,
      node32, xmdf32);
  return static_cast<int>(cudaGetLastError());
}
