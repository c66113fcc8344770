// Near-earth SGP4 propagation over a separable time grid, for Hopper:
// kernel K1 and its merge variant K3.
//
// K1 replaces the TPU kernel astroz_tpu/ops/pallas_sgp4.py:_kernel_fused_sep
// (wrapper propagate_fast_pallas_sep). For every (time t, satellite s):
//   tsince = t_time[t] - t_sat[s]                         (f64)
//   spine: secular angles in f64, reduced mod 2pi, cast to f32
//   tail:  drag, Newton Kepler (3/4/5/8 trips), J2 short-period terms,
//          TEME r (and v) in f32 with a polynomial sincos
//   errors 1/4/6 over the init error; failed points zero-filled.
// K3 (MERGE = true) replaces _kernel_fused_sep_merge (wrapper
// propagate_fast_pallas_sep_merge): the same kernel, given a per-column
// deep_slot map (-1 on near-earth columns, else the column's index in the
// deep subset) and kernel K2's (3, T, D) / (T, D) planes. A deep column
// does not run the tail: its thread copies r, v and err from the deep
// planes at its slot. It is a select, never a blend, so no shallow value
// reaches a deep column; every other column is K1, bit for bit. The TPU
// kernel scattered the deep columns with a bf16 one-hot matmul on its
// matrix unit; on Hopper a direct indexed read does it, with no bound on
// the deep fraction.
//
// The plain torch version is astroz_tpu_torch/ops/fast.py (spine_f64 +
// shallow_tail_f32); this file runs the same operations in the same order
// (sgp4_common.cuh says how the bits are kept). The TPU kernel ran the
// spine in double-f32 (Dekker) arithmetic because the TPU has no f64;
// Hopper has, so the spine here is native f64, as the JAX package's XLA
// path spine_f64 computes it.
//
// Bound. At 13,478 x 1,440 each point stores 28 bytes (16 without
// velocities) and does ~350 f32 and ~20 f64 operations, five f64 fmods
// and ~8 IEEE divides and square roots: ~12 flops per stored byte, on
// paper a near-balance between store bandwidth and f32 issue rate. The
// stores alone would take ~0.17 ms at 3.35 TB/s; measured on an H100
// SXM at a 700 W limit the kernel takes 0.855 ms (635 GB/s of stores),
// so instruction issue bounds it (the fmods, the divide and square-root
// sequences, 31% occupancy at 96 registers a thread). The merge adds a
// branch per thread and, on the ~5% deep columns, 28-byte reads per point
// in place of the tail. The design keeps it simple and coalesced: one
// thread owns one satellite and ROWS time rows, loads the satellite's
// fields into registers once, and neighbouring threads take neighbouring
// satellites, so the loads of the (rows, S) field matrices and the stores
// to the (3, T, S) planes are contiguous across a warp. Outputs are
// exact-shape; the ragged satellite and time edges are masked. Making it
// fast (FMA, occupancy, staging the field rows) is later work.

#include "sgp4_common.cuh"

namespace {

constexpr int BLOCK = 128;  // satellites per block
constexpr int ROWS = 8;     // time rows per thread

constexpr int N_SPINE = 12;  // ops/fast.py SPINE_FIELD_NAMES
constexpr int N_TAIL = 21;   // ops/fast.py TAIL_FIELD_NAMES

// kernel K2's outputs and the per-column map into them (K3 only)
struct DeepPlanes {
  const int* slot;  // (S,) i32: -1, or the column's deep-subset index
  const float* r;   // (3, T, D) f32
  const float* v;   // (3, T, D) f32, null without velocities
  const int* err;   // (T, D) i32
  int n_deep;       // D
};

template <bool WANT_VEL, int ITERS, bool MERGE>
__global__ void __launch_bounds__(BLOCK)
sgp4_shallow_kernel(const double* __restrict__ t_time,
                    const double* __restrict__ t_sat,
                    const double* __restrict__ spine,
                    const float* __restrict__ tail,
                    const int* __restrict__ flags, int n_times, int n_sats,
                    float j2, float re, float vkmpersec, DeepPlanes deep,
                    float* __restrict__ r, float* __restrict__ v,
                    int* __restrict__ err) {
  const int s = blockIdx.x * BLOCK + threadIdx.x;
  if (s >= n_sats) return;
  const int t_begin = blockIdx.y * ROWS;
  const int t_end = min(t_begin + ROWS, n_times);
  const size_t ns = (size_t)n_sats;
  const size_t plane = (size_t)n_times * ns;

  if (MERGE) {
    const int slot = deep.slot[s];
    if (slot >= 0) {
      // a deep column: K2's values, as they are
      const size_t nd = (size_t)deep.n_deep;
      const size_t dplane = (size_t)n_times * nd;
      for (int ti = t_begin; ti < t_end; ++ti) {
        const size_t idx = (size_t)ti * ns + s;
        const size_t di = (size_t)ti * nd + slot;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          r[c * plane + idx] = deep.r[c * dplane + di];
        err[idx] = deep.err[di];
        if (WANT_VEL) {
#pragma unroll
          for (int c = 0; c < 3; ++c)
            v[c * plane + idx] = deep.v[c * dplane + di];
        }
      }
      return;
    }
  }

  // per-satellite fields, loaded once (rows of SoA matrices: coalesced)
  double sp[N_SPINE];
#pragma unroll
  for (int k = 0; k < N_SPINE; ++k) sp[k] = spine[k * ns + s];
  const double mo = sp[0], mdot = sp[1], argpo = sp[2], argpdot = sp[3];
  const double nodeo = sp[4], nodedot = sp[5], nodecf = sp[6];
  const double no_unkozai = sp[7], t2cof = sp[8], t3cof = sp[9];
  const double t4cof = sp[10], t5cof = sp[11];
  float tf[N_TAIL];
#pragma unroll
  for (int k = 0; k < N_TAIL; ++k) tf[k] = tail[k * ns + s];
  const float omgcof = tf[0], eta = tf[1], xmcof = tf[2], delmo = tf[3];
  const float cc1 = tf[4], d2 = tf[5], d3 = tf[6], d4 = tf[7];
  const float bstar = tf[8], cc4 = tf[9], cc5 = tf[10], sinmao = tf[11];
  const float ecco = tf[12], sinip = tf[13], cosip = tf[14], a = tf[15];
  const float aycof = tf[16], xlcof = tf[17], con41 = tf[18];
  const float x1mth2 = tf[19], x7thm1 = tf[20];
  const bool not_simp = flags[s] == 0;
  const int error0 = flags[ns + s];
  const double epoch = t_sat[s];

  for (int ti = t_begin; ti < t_end; ++ti) {
    // ---- f64 spine (fast.spine_f64) ------------------------------------
    const double t = t_time[ti] - epoch;
    const double xmdf = mo + mdot * t;
    const double argpdf = argpo + argpdot * t;
    const double t2 = t * t;
    const double nodem64 = nodeo + nodedot * t + nodecf * t2;
    const double templ_big =
        no_unkozai * t2 * (t2cof + t * (t3cof + t * (t4cof + t * t5cof)));
    const double mm_spine = xmdf + templ_big;
    const float t32 = __double2float_rn(t);
    const float u_base = __double2float_rn(rem_two_pi(mm_spine + argpdf));
    const float mm = __double2float_rn(rem_two_pi(mm_spine));
    const float argp32 = __double2float_rn(rem_two_pi(argpdf));
    const float node32 = __double2float_rn(rem_two_pi(nodem64));
    const float xmdf32 = __double2float_rn(rem_two_pi(xmdf));

    // ---- drag (fast.shallow_tail_f32); cos(xmdf) as in SGP4 ------------
    int error = error0;
    float cos_xmdf, sin_unused;
    sincos_poly(xmdf32, sin_unused, cos_xmdf);
    const float delmtemp = 1.0f + eta * cos_xmdf;
    const float tempd =
        omgcof * t32 + xmcof * (delmtemp * delmtemp * delmtemp - delmo);
    const float mm_drag = not_simp ? mm + tempd : mm;
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
    sincos_poly(node32 + 0.0f, sin_node, cos_node);
    const float argpp = (not_simp ? argp32 - tempd : argp32) + 0.0f;

    // ---- long-period terms -> Kepler -> TEME (fast._kepler_posvel_f32) -
    const PosVel o = kepler_posvel<WANT_VEL, ITERS>(
        u_base, am, am_safe, rsq_am, em, argpp, sin_node, cos_node, sinip,
        cosip, aycof, xlcof, con41, x1mth2, x7thm1, error, j2, re, vkmpersec);
    store_point<WANT_VEL>(o, (size_t)ti * ns + s, plane, r, v, err);
  }
}

template <bool WANT_VEL, bool MERGE>
cudaError_t launch(int kepler_iters, dim3 grid, cudaStream_t stream,
                   const double* t_time, const double* t_sat,
                   const double* spine, const float* tail, const int* flags,
                   int n_times, int n_sats, float j2, float re,
                   float vkmpersec, DeepPlanes deep, float* r, float* v,
                   int* err) {
#define ASTROZ_LAUNCH(IT)                                                   \
  sgp4_shallow_kernel<WANT_VEL, IT, MERGE><<<grid, BLOCK, 0, stream>>>(     \
      t_time, t_sat, spine, tail, flags, n_times, n_sats, j2, re, vkmpersec, \
      deep, r, v, err)
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

template <bool MERGE>
int launch_vel(int want_vel, int kepler_iters, const double* t_time,
               const double* t_sat, const double* spine, const float* tail,
               const int* flags, int n_times, int n_sats, float j2, float re,
               float vkmpersec, DeepPlanes deep, float* r, float* v,
               int* err, void* stream) {
  const dim3 grid((n_sats + BLOCK - 1) / BLOCK, (n_times + ROWS - 1) / ROWS);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      want_vel ? launch<true, MERGE>(kepler_iters, grid, st, t_time, t_sat,
                                     spine, tail, flags, n_times, n_sats, j2,
                                     re, vkmpersec, deep, r, v, err)
               : launch<false, MERGE>(kepler_iters, grid, st, t_time, t_sat,
                                      spine, tail, flags, n_times, n_sats,
                                      j2, re, vkmpersec, deep, r, v, err);
  return static_cast<int>(rc);
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
  return launch_vel<false>(want_vel, kepler_iters, t_time, t_sat, spine, tail,
                           flags, n_times, n_sats, j2, re, vkmpersec,
                           DeepPlanes{nullptr, nullptr, nullptr, nullptr, 0},
                           r, v, err, stream);
}

// K3: K1's arguments plus deep_slot (S,) i32 and kernel K2's planes
// dr (3, T, D) f32, dv (3, T, D) f32 (null when want_vel == 0) and
// de (T, D) i32.
extern "C" int astroz_sgp4_shallow_merge(
    const double* t_time, const double* t_sat, const double* spine,
    const float* tail, const int* flags, int n_times, int n_sats,
    int kepler_iters, int want_vel, float j2, float re, float vkmpersec,
    const int* deep_slot, const float* dr, const float* dv, const int* de,
    int n_deep, float* r, float* v, int* err, void* stream) {
  return launch_vel<true>(want_vel, kepler_iters, t_time, t_sat, spine, tail,
                          flags, n_times, n_sats, j2, re, vkmpersec,
                          DeepPlanes{deep_slot, dr, dv, de, n_deep}, r, v,
                          err, stream);
}
