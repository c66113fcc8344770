// The output epilogue of a catalog sweep, for Hopper: the epilogue kernel.
//
// Not a TPU kernel. The JAX package traces its epilogue into the jitted
// sweeps, where XLA fuses it with the layout change
// (astroz_tpu/propagation.py:773 _finalize_planes on the fast path's
// (3, T, S) planes, :752 _finalize on the f64 path's time-major
// (T, S, 3) outputs, then the layouts and the satellite mask,
// :1296-1322). The port's plain version
// (ops/cuda_finalize.py:finalize_reference) runs it as a chain of eager
// torch ops. One launch here reads the sweep's r, v and codes once and
// writes the caller's frame and layout once:
//   frames   teme (as is), ecef (r and v turned by GMST about z),
//            geodetic / geodetic_deg (r as lat, lon, alt on WGS-84 by 10
//            fixed trips of the latitude iteration, in registers; v stays
//            ECEF)
//   layouts  time_major (T, S, 3), sat_major (S, T, 3), planes (3, T, S),
//            from planes (the fast path) or from time-major (the f64 path)
//   mask     masked satellites zero-filled, their codes -1
// sin and cos of GMST come in as (T,) tensors that torch computed, as the
// plain version computes them (f64 gstime, cast, torch.sin / torch.cos).
//
// How the bits are kept (the outputs equal the plain version's on the
// card bit for bit, chip_smoke.py phase 2e):
// - built with --fmad=true (_build.FMAD_SOURCES), as torch's kernels are,
//   so that libdevice's sin, cos and atan2 in f32 and f64 give torch's
//   bits; this file's own arithmetic goes through rounded intrinsics
//   (mul, add, sub, div, sqrt_rn below), never contracted, so each torch
//   op rounds once here too: cg * x + sg * y is three roundings;
// - a / sqrt(...) is a true divide (a is a 0-dim tensor in
//   frames.ecef_to_geodetic_xyz), and so are p_safe / cos(lat) and
//   (e2 * n) / (n + alt), left to right; a python float against an f32
//   tensor is its f32 rounding (e2, 1 - e2 taken in f64 first, RAD2DEG,
//   the 1e-12 clamp, whose compare is false for NaN as torch.where's is).
//
// Bound. The epilogue moves bytes: at 13,478 x 1,440 the f32 r and v are
// 233 MB each, read once and written once (0.28 ms at 3.35 TB/s); f64
// twice that. Geodetic's 10 trips (sin, cos, atan2, a square root and
// three divides each, ~1,500 instructions a point in f32, several times
// that in f64) can outweigh the bytes. What the design does about it:
// - time_major and planes outputs transpose no (time, satellite) pair:
//   the sweep's layout and the caller's walk the T x S points in the same
//   order, as planes (3, N) or as rows of 3 (N, 3). flat_kernel gives a
//   thread 4 neighbouring f32 points (2 f64) and moves each plane's and
//   each run of rows' values as whole 16-byte vectors where they start on
//   one (else one value at a time: the walk's last points, and the
//   planes after the first where N is not a multiple of the vector), so
//   that a warp reads and writes contiguous runs and no value goes
//   through shared memory (the first design staged these through 32 x 32
//   tiles too: 0.50 ms for the headline planes to time-major, slower than
//   torch's permute copy, 0.42);
// - sat_major transposes: tile_kernel takes a tile of 32 rows (times) x
//   256 bytes of lanes (64 f32 satellites, 32 f64) and stages each vector
//   field through shared memory, component planes padded so that neither
//   the reads nor the transposed writes collide on a bank; the loads are
//   whole rows of the sweep's layout, the stores whole runs of 96 values
//   of a lane;
// - r, v and the codes are separate blocks (the grid's y), so the
//   geodetic r blocks and the rotation-only v blocks share the card; the
//   codes are only touched for sat_major or a mask.
// In the identity cases (teme + planes on the fast path, teme +
// time_major on the f64 path, no mask) the wrapper launches nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_T = 32;  // rows (times) of a sat_major tile
// lanes (satellites) of a sat_major tile: a row of the sweep's planes is
// read as 256 bytes in either type (64 f32 values, 32 f64)
template <typename T>
constexpr int TILE_S = 256 / sizeof(T);
// a padded row of a plane (= 1 mod 32 words), and a plane (= 11 mod 32
// words: the 3 planes start on different banks)
template <typename T>
constexpr int ROW = TILE_S<T> + 1;
template <typename T>
constexpr int PLANE = TILE_T * ROW<T> + (43 - (TILE_T * ROW<T>) % 32) % 32;
constexpr int GEODETIC_TRIPS = 10;        // frames.ecef_to_geodetic_xyz

// the order of ops/cuda_finalize.py SOURCES, propagation.LAYOUTS and
// propagation.OUTPUT_MODES
enum Source { FROM_PLANES = 0, FROM_TIME_MAJOR = 1 };
enum Layout { TIME_MAJOR = 0, SAT_MAJOR = 1, PLANES = 2 };
enum Frame { TEME = 0, ECEF = 1, GEODETIC = 2, GEODETIC_DEG = 3 };
enum Field { R = 0, V = 1, ERR = 2 };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float sin_(float a) { return sinf(a); }
__device__ __forceinline__ double sin_(double a) { return sin(a); }
__device__ __forceinline__ float cos_(float a) { return cosf(a); }
__device__ __forceinline__ double cos_(double a) { return cos(a); }
__device__ __forceinline__ float atan2_(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double atan2_(double y, double x) { return atan2(y, x); }

// python floats as torch rounds them against a tensor of type T
template <typename T>
struct Consts {
  T a;         // WGS-84 equatorial radius, km
  T e2;        // WGS-84 eccentricity squared
  T one_m_e2;  // 1 - e2, taken in f64
  T rad2deg;
  T eps;       // the clamp of p, 1e-12
};

template <typename T>
struct Args {
  const T* r;           // (3, T, S) or (T, S, 3) by source
  const T* v;           // the same, or null
  const int* err;       // (T, S)
  const T* sg;          // (T,) sin(gmst), null for teme
  const T* cg;          // (T,) cos(gmst)
  const unsigned char* mask;  // (S,) bool, null for none
  T* r_out;             // by layout
  T* v_out;             // by layout, or null
  int* err_out;         // (S, T) for sat_major, else (T, S); or null
  long long n_times;
  long long n_sats;
  int source;
  int layout;
  int frame;
  int fields[3];        // the fields the grid's y walks
  Consts<T> k;
};

// frames.ecef_to_geodetic_xyz in place: (x, y, z) -> (lat, lon, alt)
template <typename T>
__device__ __forceinline__ void geodetic(const Consts<T>& k, T& x, T& y,
                                         T& z) {
  const T one = T(1);
  const T lon = atan2_(y, x);
  const T p = sqrt_rn(add(mul(x, x), mul(y, y)));
  const T p_safe = (p > k.eps) ? p : k.eps;
  T lat = atan2_(z, mul(p_safe, k.one_m_e2));
  for (int i = 0; i < GEODETIC_TRIPS; ++i) {
    const T s = sin_(lat);
    const T n = div(k.a, sqrt_rn(sub(one, mul(mul(k.e2, s), s))));
    const T alt = sub(div(p_safe, cos_(lat)), n);
    lat = atan2_(z, mul(p_safe, sub(one, div(mul(k.e2, n), add(n, alt)))));
  }
  const T s = sin_(lat);
  const T n = div(k.a, sqrt_rn(sub(one, mul(mul(k.e2, s), s))));
  z = sub(div(p_safe, cos_(lat)), n);
  x = lat;
  y = lon;
}

// one point of a vector field in the caller's frame (the plain version's
// _finalize_planes / _finalize)
template <typename T>
__device__ __forceinline__ void point(const Args<T>& a, bool is_r,
                                      long long t, T& x, T& y, T& z) {
  if (a.frame == TEME) return;
  const T sg = a.sg[t], cg = a.cg[t];
  const T xe = add(mul(cg, x), mul(sg, y));
  const T ye = add(mul(-sg, x), mul(cg, y));
  x = xe;
  y = ye;
  if (!is_r || a.frame == ECEF) return;
  geodetic(a.k, x, y, z);
  if (a.frame == GEODETIC_DEG) {
    x = mul(x, a.k.rad2deg);
    y = mul(y, a.k.rad2deg);
  }
}

// ---- the flat walk: time_major and planes outputs -------------------------

// W values of type U, moved as one vector (16 bytes where W fills them)
template <typename U, int W>
struct alignas(sizeof(U) * W) Pack {
  U v[W];
};

// the vector width of a run of N values of type U
template <typename U, int N>
constexpr int RUN_W = N * sizeof(U) < 16 ? N : 16 / sizeof(U);

// the first m of a run of N values at p: whole vectors where all N are
// wanted and p starts a vector, else one value at a time
template <int N, typename U>
__device__ __forceinline__ bool whole_run(const U* p, int m) {
  constexpr int W = RUN_W<U, N>;
  static_assert(N % W == 0, "a run is whole vectors");
  return m == N &&
         reinterpret_cast<unsigned long long>(p) % (sizeof(U) * W) == 0;
}

template <int N, typename U>
__device__ __forceinline__ void load_run(const U* p, int m, U (&x)[N]) {
  constexpr int W = RUN_W<U, N>;
  if (whole_run<N>(p, m)) {
#pragma unroll
    for (int k = 0; k < N / W; ++k) {
      const Pack<U, W> q = reinterpret_cast<const Pack<U, W>*>(p)[k];
#pragma unroll
      for (int j = 0; j < W; ++j) x[k * W + j] = q.v[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < m) x[j] = p[j];
  }
}

template <int N, typename U>
__device__ __forceinline__ void store_run(U* p, int m, const U (&x)[N]) {
  constexpr int W = RUN_W<U, N>;
  if (whole_run<N>(p, m)) {
#pragma unroll
    for (int k = 0; k < N / W; ++k) {
      Pack<U, W> q;
#pragma unroll
      for (int j = 0; j < W; ++j) q.v[j] = x[k * W + j];
      reinterpret_cast<Pack<U, W>*>(p)[k] = q;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < m) p[j] = x[j];
  }
}

// Neither the sweep's layout nor a time_major / planes output transposes
// (time, satellite): both walk the N = T x S points in the same order, as
// planes (3, N) or as rows of 3 (N, 3). A thread takes VEC neighbouring
// points (16 bytes of a plane): a vector of each plane, or 3 vectors of a
// run of rows, so that a warp's loads and stores are whole 16-byte
// vectors in contiguous runs (512 B of each plane, 1.5 KB of rows for
// f32). The thread whose points end the walk takes the last 1..VEC - 1
// one at a time, and so does every thread on the planes after the first
// where N is not a multiple of VEC (they start off a vector).
template <typename T>
__global__ void __launch_bounds__(THREADS) flat_kernel(const Args<T> a) {
  constexpr int VEC = 16 / sizeof(T);
  const long long n = a.n_times * a.n_sats;
  const long long p0 =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * VEC;
  if (p0 >= n) return;
  const int m = static_cast<int>(min(static_cast<long long>(VEC), n - p0));
  long long t = p0 / a.n_sats, s = p0 - t * a.n_sats;
  const int field = a.fields[blockIdx.y];
  if (field == ERR) {
    // a mask on a layout that keeps (T, S) codes
    int e[VEC];
    load_run(a.err + p0, m, e);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (j < m && !a.mask[s]) e[j] = -1;
      if (++s == a.n_sats) s = 0;
    }
    store_run(a.err_out + p0, m, e);
    return;
  }
  const bool is_r = field == R;
  const T* in = is_r ? a.r : a.v;
  T* out = is_r ? a.r_out : a.v_out;
  T x[VEC], y[VEC], z[VEC];
  if (a.source == FROM_PLANES) {
    load_run(in + p0, m, x);
    load_run(in + n + p0, m, y);
    load_run(in + 2 * n + p0, m, z);
  } else {
    T q[3 * VEC];
    load_run(in + 3 * p0, 3 * m, q);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      x[j] = q[3 * j];
      y[j] = q[3 * j + 1];
      z[j] = q[3 * j + 2];
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    if (j >= m) break;
    if (a.mask != nullptr && !a.mask[s]) {
      x[j] = y[j] = z[j] = T(0);
    } else {
      point(a, is_r, t, x[j], y[j], z[j]);
    }
    if (++s == a.n_sats) {
      s = 0;
      ++t;
    }
  }
  if (a.layout == PLANES) {
    store_run(out + p0, m, x);
    store_run(out + n + p0, m, y);
    store_run(out + 2 * n + p0, m, z);
  } else {
    T q[3 * VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      q[3 * j] = x[j];
      q[3 * j + 1] = y[j];
      q[3 * j + 2] = z[j];
    }
    store_run(out + 3 * p0, 3 * m, q);
  }
}

// ---- the tile walk: sat_major outputs --------------------------------------

// tile[c * PLANE + tt * ROW + ts]: component c of the point (t0 + tt,
// s0 + ts), read as the sweep's layout runs and written as lanes' runs
template <typename T>
__device__ void vector_tile(const Args<T>& a, bool is_r, T* tile,
                            long long t0, long long s0, int nt, int ns) {
  const T* in = is_r ? a.r : a.v;
  T* out = is_r ? a.r_out : a.v_out;
  const long long NT = a.n_times, NS = a.n_sats;
  if (a.source == FROM_PLANES) {
    // a row's TILE_S lanes of one component, 256 bytes
#pragma unroll
    for (int i = threadIdx.x; i < 3 * TILE_T * TILE_S<T>; i += THREADS) {
      const int c = i / (TILE_T * TILE_S<T>);
      const int tt = (i / TILE_S<T>) % TILE_T, ts = i % TILE_S<T>;
      if (tt < nt && ts < ns)
        tile[c * PLANE<T> + tt * ROW<T> + ts] =
            in[(c * NT + t0 + tt) * NS + s0 + ts];
    }
  } else {
    // a row's run of 3 x TILE_S values
#pragma unroll
    for (int i = threadIdx.x; i < TILE_T * 3 * TILE_S<T>; i += THREADS) {
      const int tt = i / (3 * TILE_S<T>), j = i % (3 * TILE_S<T>);
      if (tt < nt && j < 3 * ns)
        tile[(j % 3) * PLANE<T> + tt * ROW<T> + j / 3] =
            in[((t0 + tt) * NS + s0) * 3 + j];
    }
  }
  __syncthreads();
#pragma unroll 1
  for (int i = threadIdx.x; i < TILE_T * TILE_S<T>; i += THREADS) {
    const int tt = i / TILE_S<T>, ts = i % TILE_S<T>;
    if (tt >= nt || ts >= ns) continue;
    T* p = tile + tt * ROW<T> + ts;
    T x = p[0], y = p[PLANE<T>], z = p[2 * PLANE<T>];
    if (a.mask != nullptr && !a.mask[s0 + ts]) {
      x = y = z = T(0);
    } else {
      point(a, is_r, t0 + tt, x, y, z);
    }
    p[0] = x;
    p[PLANE<T>] = y;
    p[2 * PLANE<T>] = z;
  }
  __syncthreads();
  // a lane's run of 3 x 32 values
#pragma unroll
  for (int i = threadIdx.x; i < TILE_S<T> * 3 * TILE_T; i += THREADS) {
    const int ts = i / (3 * TILE_T), j = i % (3 * TILE_T);
    if (ts < ns && j < 3 * nt)
      out[((s0 + ts) * NT + t0) * 3 + j] =
          tile[(j % 3) * PLANE<T> + (j / 3) * ROW<T> + ts];
  }
}

// the codes transposed, -1 where masked
template <typename T>
__device__ void err_tile(const Args<T>& a, int* tile, long long t0,
                         long long s0, int nt, int ns) {
  const long long NT = a.n_times, NS = a.n_sats;
#pragma unroll
  for (int i = threadIdx.x; i < TILE_T * TILE_S<T>; i += THREADS) {
    const int tt = i / TILE_S<T>, ts = i % TILE_S<T>;
    if (tt >= nt || ts >= ns) continue;
    int e = a.err[(t0 + tt) * NS + s0 + ts];
    if (a.mask != nullptr && !a.mask[s0 + ts]) e = -1;
    tile[tt * ROW<T> + ts] = e;
  }
  __syncthreads();
#pragma unroll
  for (int i = threadIdx.x; i < TILE_S<T> * TILE_T; i += THREADS) {
    const int ts = i / TILE_T, tt = i % TILE_T;
    if (tt < nt && ts < ns)
      a.err_out[(s0 + ts) * NT + t0 + tt] = tile[tt * ROW<T> + ts];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) tile_kernel(const Args<T> a) {
  __shared__ __align__(16) T tile[3 * PLANE<T>];
  const long long tiles_s = (a.n_sats + TILE_S<T> - 1) / TILE_S<T>;
  const long long t0 = (blockIdx.x / tiles_s) * TILE_T;
  const long long s0 = (blockIdx.x % tiles_s) * TILE_S<T>;
  const int nt = static_cast<int>(min(static_cast<long long>(TILE_T),
                                      a.n_times - t0));
  const int ns = static_cast<int>(min(static_cast<long long>(TILE_S<T>),
                                      a.n_sats - s0));
  const int field = a.fields[blockIdx.y];
  if (field == ERR)
    err_tile(a, reinterpret_cast<int*>(tile), t0, s0, nt, ns);
  else
    vector_tile(a, field == R, tile, t0, s0, nt, ns);
}

template <typename T>
int finalize(const T* r, const T* v, const int* err, const T* sg,
             const T* cg, const unsigned char* mask, long long n_times,
             long long n_sats, int source, int layout, int frame, T* r_out,
             T* v_out, int* err_out, double a_km, double e2, double rad2deg,
             void* stream) {
  if (n_times <= 0 || n_sats <= 0) return 0;
  if (source < FROM_PLANES || source > FROM_TIME_MAJOR || layout < TIME_MAJOR
      || layout > PLANES || frame < TEME || frame > GEODETIC_DEG
      || (frame != TEME && (sg == nullptr || cg == nullptr))
      || (v_out != nullptr && v == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args<T> a{r, v, err, sg, cg, mask, r_out, v_out, err_out, n_times, n_sats,
            source, layout, frame, {0, 0, 0},
            {static_cast<T>(a_km), static_cast<T>(e2),
             static_cast<T>(1.0 - e2), static_cast<T>(rad2deg),
             static_cast<T>(1e-12)}};
  int n_fields = 0;
  if (r_out != nullptr) a.fields[n_fields++] = R;
  if (v_out != nullptr) a.fields[n_fields++] = V;
  if (err_out != nullptr) a.fields[n_fields++] = ERR;
  if (n_fields == 0) return 0;
  if (err_out != nullptr && layout != SAT_MAJOR && mask == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout == SAT_MAJOR) {
    const long long tiles = ((n_times + TILE_T - 1) / TILE_T)
                            * ((n_sats + TILE_S<T> - 1) / TILE_S<T>);
    if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    tile_kernel<T><<<dim3(static_cast<unsigned>(tiles), n_fields), THREADS,
                     0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int VEC = 16 / sizeof(T);
  const long long per_block = static_cast<long long>(THREADS) * VEC;
  const long long blocks = (n_times * n_sats + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flat_kernel<T><<<dim3(static_cast<unsigned>(blocks), n_fields), THREADS, 0,
                   st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes by astroz_tpu_torch/_build.py).
// r, v: (3, n_times, n_sats) with source 0 (planes), (n_times, n_sats, 3)
// with source 1 (time-major); v null without velocities. err (n_times,
// n_sats) i32. sg, cg (n_times,) sin and cos of GMST in the outputs' type
// (null for frame 0, teme). mask (n_sats,) bool, null for none. layout 0
// time_major (r_out (n_times, n_sats, 3)), 1 sat_major ((n_sats, n_times,
// 3)), 2 planes ((3, n_times, n_sats)); frame 0 teme, 1 ecef, 2 geodetic,
// 3 geodetic_deg. v_out null: v is not written; err_out null: the codes
// are not written (err_out is (n_sats, n_times) for sat_major, else
// (n_times, n_sats)). a_km, e2: WGS-84's radius and eccentricity squared;
// rad2deg. All contiguous on the current device. Launches on `stream` and
// returns the launch's cudaError_t.
extern "C" int astroz_finalize_f32(const float* r, const float* v,
                                   const int* err, const float* sg,
                                   const float* cg, const unsigned char* mask,
                                   long long n_times, long long n_sats,
                                   int source, int layout, int frame,
                                   float* r_out, float* v_out, int* err_out,
                                   double a_km, double e2, double rad2deg,
                                   void* stream) {
  return finalize<float>(r, v, err, sg, cg, mask, n_times, n_sats, source,
                         layout, frame, r_out, v_out, err_out, a_km, e2,
                         rad2deg, stream);
}

extern "C" int astroz_finalize_f64(const double* r, const double* v,
                                   const int* err, const double* sg,
                                   const double* cg, const unsigned char* mask,
                                   long long n_times, long long n_sats,
                                   int source, int layout, int frame,
                                   double* r_out, double* v_out, int* err_out,
                                   double a_km, double e2, double rad2deg,
                                   void* stream) {
  return finalize<double>(r, v, err, sg, cg, mask, n_times, n_sats, source,
                          layout, frame, r_out, v_out, err_out, a_km, e2,
                          rad2deg, stream);
}
