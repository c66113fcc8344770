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
//            geodetic / geodetic_deg (r as lat, lon, alt on WGS-84: the
//            plain version's 10 trips of the latitude iteration, cut
//            short where lat repeats its bits, which gives the same bits;
//            v stays ECEF)
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
//   the 1e-12 clamp, whose compare is false for NaN as torch.where's is);
// - sin and cos of one lat come from one sincosf / sincos call, which
//   gives sinf's and cosf's (sin's, cos's) bits.
//
// Bound. The epilogue moves bytes: at 13,478 x 1,440 the f32 r and v are
// 233 MB each, read once and written once (0.28 ms at 3.35 TB/s); f64
// twice that. Geodetic's latitude iteration (sincos, atan2, a square root
// and three divides a trip) can outweigh the bytes. What the design does
// about it:
// - geodetic stops each point's iteration where lat repeats its bit
//   pattern (geodetic() below): most points repeat after 2-4 trips in f32
//   and 3-8 in f64, in place of the plain version's 10;
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
// - sat_major transposes: tile_kernel is a persistent grid whose blocks
//   walk items of tiles of 32 rows (times) x 256 bytes of lanes (64 f32
//   satellites, 32 f64), the tiles times first. An item's rows land in a
//   stage of a ring of STAGES in shared memory by cp.async while the block
//   converts and stores the item before it; a thread converts times of a
//   lane in place (its warp neighbours the neighbouring lanes, so that
//   the reads collide on no bank) and a warp stores a lane's run whole.
//   f32: an item is one field of a tile (r over all tiles, then v, then
//   the codes), 4 blocks an SM, a time a thread, rows moved in 4-byte
//   pieces; f64: an item is a whole tile (r, v and codes), 2 blocks an SM
//   with 128 registers, 2 times a thread, 16-byte pieces where the address
//   allows. Each the fastest of the forms timed in turns
//   (shallow_variants.py --epilogue-turns and its variants); slower were
//   one block of 16 warps an SM walking whole tiles through a separate
//   output stage (f32 planes at half the parent's speed), threads storing
//   their own 16-byte vectors to 32 lanes' runs at once, and 16-byte
//   pieces for f32.
// In the identity cases (teme + planes on the fast path, teme +
// time_major on the f64 path, no mask) the wrapper launches nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;       // a block of the flat walk
constexpr int TILE_THREADS = 256;  // a block of the tile walk
constexpr int TILE_T = 32;  // rows (times) of a sat_major tile
// lanes (satellites) of a sat_major tile: a row of the sweep's planes is
// read as 256 bytes in either type (64 f32 values, 32 f64)
template <typename T>
constexpr int TILE_S = 256 / sizeof(T);
// points of a thread in the flat walk: one 16-byte vector of a plane
template <typename T>
constexpr int VEC = 16 / sizeof(T);
constexpr int STAGES = 2;  // the tile walk's ring of stages
// the tile walk by type, each the fastest timed (see the top of the
// file): its blocks an SM, at most; the widest piece (bytes) its rows
// move in; whether an item is a whole tile (r, v and codes) or one field;
// the times of a lane a thread converts
template <typename T>
constexpr int TILE_BLOCKS = sizeof(T) == 4 ? 4 : 2;
template <typename T>
constexpr int PIECE = sizeof(T) == 4 ? 4 : 16;
template <typename T>
constexpr bool WHOLE_TILES = sizeof(T) == 8;
template <typename T>
constexpr int TILE_TIMES = sizeof(T) == 4 ? 1 : VEC<T>;
constexpr int MAX_DEVICES = 64;
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
__device__ __forceinline__ void sincos_(float a, float* s, float* c) { sincosf(a, s, c); }
__device__ __forceinline__ void sincos_(double a, double* s, double* c) { sincos(a, s, c); }
__device__ __forceinline__ float atan2_(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double atan2_(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ int bits(float a) { return __float_as_int(a); }
__device__ __forceinline__ long long bits(double a) { return __double_as_longlong(a); }

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
  int fields[3];        // the fields written: the flat walk's grid y, the
                        // vector fields first
  int n_vec;            // R and V among them
  Consts<T> k;
};

// alt of one lat, as a trip of the iteration and its final step take it;
// n for the trip's next lat
template <typename T>
__device__ __forceinline__ T altitude(const Consts<T>& k, T p_safe, T lat,
                                      T& n) {
  T s, c;
  sincos_(lat, &s, &c);
  n = div(k.a, sqrt_rn(sub(T(1), mul(mul(k.e2, s), s))));
  return sub(div(p_safe, c), n);
}

// frames.ecef_to_geodetic_xyz in place: (x, y, z) -> (lat, lon, alt)
template <typename T>
__device__ __forceinline__ void geodetic(const Consts<T>& k, T& x, T& y,
                                         T& z) {
  const T lon = atan2_(y, x);
  const T p = sqrt_rn(add(mul(x, x), mul(y, y)));
  const T p_safe = (p > k.eps) ? p : k.eps;
  T lat = atan2_(z, mul(p_safe, k.one_m_e2));
  // The plain version runs 10 trips, then takes alt of the last lat. A
  // trip is a function of lat's bits alone (n and alt are recomputed from
  // lat, p_safe and z; nothing else is carried), and so is alt. So once
  // lat repeats a bit pattern, every later trip repeats too, and the loop
  // stops there with the bits of 10 trips:
  // - the next lat is this one: the later trips return it again, and
  //   this trip's alt is the final step's;
  // - the next lat is the one before (a two-value cycle): the later trips
  //   alternate, and the 10th ends on the next lat if the trips left
  //   after this one are even in number, else on this one; the alt of
  //   each came out of its own trip;
  // - else the loop goes on, to the 10th trip and the final step.
  // Bits, not values, are compared, so that -0.0 and +0.0 are told
  // apart; a NaN repeats its bits like any other value, and stops as
  // exactly. `prev` starts as lat: on the first trip its test is the
  // first one's.
  T prev = lat, alt_prev = T(0), alt;
  for (int i = 0;; ++i) {  // i trips done, lat the i-th one's
    T n;
    alt = altitude(k, p_safe, lat, n);
    if (i == GEODETIC_TRIPS) break;
    const T next = atan2_(
        z, mul(p_safe, sub(T(1), div(mul(k.e2, n), add(n, alt)))));
    if (bits(next) == bits(lat)) break;
    if (bits(next) == bits(prev)) {
      if ((GEODETIC_TRIPS - i - 1) % 2 == 0) {
        lat = next;
        alt = alt_prev;
      }
      break;
    }
    prev = lat;
    alt_prev = alt;
    lat = next;
  }
  x = lat;
  y = lon;
  z = alt;
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

// ---- runs of values in 16-byte vectors ------------------------------------

// W values of type U, moved as one vector (16 bytes where W fills them)
template <typename U, int W>
struct alignas(sizeof(U) * W) Pack {
  U v[W];
};

// the vector width of a run of N values of type U: the most values, up
// to 16 bytes, a power of two that divides N
template <typename U, int N>
__host__ __device__ constexpr int run_w() {
  int w = 16 / sizeof(U);
  while (N % w != 0) w /= 2;
  return w;
}

// the first m of a run of N values at p: whole vectors where all N are
// wanted and p starts a vector, else one value at a time
template <int N, typename U>
__device__ __forceinline__ bool whole_run(const U* p, int m) {
  constexpr int W = run_w<U, N>();
  return m == N &&
         reinterpret_cast<unsigned long long>(p) % (sizeof(U) * W) == 0;
}

template <int N, typename U>
__device__ __forceinline__ void load_run(const U* p, int m, U (&x)[N]) {
  constexpr int W = run_w<U, N>();
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
  constexpr int W = run_w<U, N>();
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

// ---- the flat walk: time_major and planes outputs -------------------------

// Neither the sweep's layout nor a time_major / planes output transposes
// (time, satellite): both walk the N = T x S points in the same order, as
// planes (3, N) or as rows of 3 (N, 3). A thread takes VEC neighbouring
// points (16 bytes of a plane), one after another, each with its own end
// of the latitude iteration: a vector of each plane, or 3 vectors of a
// run of rows, so that a warp's loads and stores are whole 16-byte
// vectors in contiguous runs (512 B of each plane, 1.5 KB of rows for
// f32). The thread whose points end the walk takes the last 1..VEC - 1
// one at a time, and so does every thread on the planes after the first
// where N is not a multiple of VEC (they start off a vector).
template <typename T>
__global__ void __launch_bounds__(THREADS) flat_kernel(const Args<T> a) {
  constexpr int P = VEC<T>;
  const long long n = a.n_times * a.n_sats;
  const long long p0 =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * P;
  if (p0 >= n) return;
  const int m = static_cast<int>(min(static_cast<long long>(P), n - p0));
  long long t = p0 / a.n_sats, s = p0 - t * a.n_sats;
  const int field = a.fields[blockIdx.y];
  if (field == ERR) {
    // a mask on a layout that keeps (T, S) codes
    int e[P];
    load_run(a.err + p0, m, e);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (j < m && !a.mask[s]) e[j] = -1;
      if (++s == a.n_sats) s = 0;
    }
    store_run(a.err_out + p0, m, e);
    return;
  }
  const bool is_r = field == R;
  const T* in = is_r ? a.r : a.v;
  T* out = is_r ? a.r_out : a.v_out;
  T x[P], y[P], z[P];
  if (a.source == FROM_PLANES) {
    load_run(in + p0, m, x);
    load_run(in + n + p0, m, y);
    load_run(in + 2 * n + p0, m, z);
  } else {
    T q[3 * P];
    load_run(in + 3 * p0, 3 * m, q);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      x[j] = q[3 * j];
      y[j] = q[3 * j + 1];
      z[j] = q[3 * j + 2];
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
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
    T q[3 * P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      q[3 * j] = x[j];
      q[3 * j + 1] = y[j];
      q[3 * j + 2] = z[j];
    }
    store_run(out + 3 * p0, 3 * m, q);
  }
}

// ---- the tile walk: sat_major outputs --------------------------------------

// A tile is TILE_T rows (times) x 256 bytes of lanes. A stage of the ring
// holds one item: one field of a tile, or a whole tile's vector fields
// FIELD_BYTES apart and then its codes. A field lies there first as the
// sweep lays it out (a vector field's planes [c][tt][ts] or rows
// [tt][3 ts + c], 24 KB in either type at 32 rows; the codes [tt][ts]),
// then, converted in place, as the caller lays it out (a vector field's
// lanes [ts][3 tt + c], the codes' [ts][tt]), a lane's run padded by 16
// bytes: an odd number of 16-byte vectors, so that 8 neighbouring lanes'
// vectors fall on 8 different groups of banks.
template <typename T>
constexpr int OUT_PITCH = 3 * TILE_T + 16 / sizeof(T);  // a lane's run
constexpr int ERR_PITCH = TILE_T + 4;
template <typename T>
constexpr int FIELD_BYTES = TILE_S<T> * OUT_PITCH<T> * sizeof(T);
static_assert((3 * TILE_T * 8 / 16) % 2 == 0 && (3 * TILE_T * 4 / 16) % 2 == 0
              && (TILE_T / 4) % 2 == 0, "a padded run is an odd number of "
              "16-byte vectors");
static_assert(TILE_S<float> * ERR_PITCH * 4 <= FIELD_BYTES<float> &&
              TILE_S<double> * ERR_PITCH * 4 <= FIELD_BYTES<double>,
              "the codes' runs fit a stage");
template <typename T>
constexpr int ITEM_BYTES =
    WHOLE_TILES<T> ? 2 * FIELD_BYTES<T> + TILE_S<T> * ERR_PITCH * 4
                   : FIELD_BYTES<T>;

// the tile's corner and extent; tiles walk the times first, so that the
// blocks at work at once store whole runs of a few lanes
struct Tile {
  long long t0, s0;
  int nt, ns;
};

template <typename T>
__device__ __forceinline__ Tile tile_at(const Args<T>& a, long long tile) {
  const long long tiles_t = (a.n_times + TILE_T - 1) / TILE_T;
  Tile g;
  g.t0 = (tile % tiles_t) * TILE_T;
  g.s0 = (tile / tiles_t) * TILE_S<T>;
  g.nt = static_cast<int>(min(static_cast<long long>(TILE_T),
                              a.n_times - g.t0));
  g.ns = static_cast<int>(min(static_cast<long long>(TILE_S<T>),
                              a.n_sats - g.s0));
  return g;
}

template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(W)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// the widest piece, 16, 8 or 4 bytes and at most PIECE<T>, that a run at
// `at` of `bytes` allows
template <typename T>
__device__ __forceinline__ int piece(const void* at, int bytes) {
  const unsigned long long x =
      reinterpret_cast<unsigned long long>(at) | static_cast<unsigned>(bytes);
  return x % 16 == 0 && PIECE<T> >= 16 ? 16
         : x % 8 == 0 && PIECE<T> >= 8 ? 8 : 4;
}

// a warp's copy of a run of `bytes` at `src` (device memory) into `dst`
// (shared, 16-byte aligned) by cp.async
template <typename T>
__device__ __forceinline__ void load_row(unsigned char* dst, const void* src,
                                         int bytes, int lane) {
  const char* s = static_cast<const char*>(src);
  const int w = piece<T>(src, bytes);
  if (w == 16) {
    for (int o = lane * 16; o < bytes; o += 32 * 16) cp_async<16>(dst + o, s + o);
  } else if (w == 8) {
    for (int o = lane * 8; o < bytes; o += 32 * 8) cp_async<8>(dst + o, s + o);
  } else {
    for (int o = lane * 4; o < bytes; o += 32 * 4) cp_async<4>(dst + o, s + o);
  }
}

template <int W>
__device__ __forceinline__ void move(void* dst, const void* src) {
  using P = Pack<int, W / 4>;
  *static_cast<P*>(dst) = *static_cast<const P*>(src);
}

// a warp's store of a run of `bytes` of shared memory at `src` (16-byte
// aligned) to `dst` in device memory: neighbouring lanes store
// neighbouring pieces
template <typename T>
__device__ __forceinline__ void store_row(void* dst, const unsigned char* src,
                                          int bytes, int lane) {
  char* d = static_cast<char*>(dst);
  const int w = piece<T>(dst, bytes);
  if (w == 16) {
    for (int o = lane * 16; o < bytes; o += 32 * 16) move<16>(d + o, src + o);
  } else if (w == 8) {
    for (int o = lane * 8; o < bytes; o += 32 * 8) move<8>(d + o, src + o);
  } else {
    for (int o = lane * 4; o < bytes; o += 32 * 4) move<4>(d + o, src + o);
  }
}

// an item's rows into a stage: a warp a row (of one component of a field
// on planes, of the 3 interleaved on time-major rows, or of the codes)
template <typename T>
__device__ void load_item(const Args<T>& a, unsigned char* stage,
                          const Tile& g, int field) {
  constexpr int S = TILE_S<T>;
  const long long NT = a.n_times, NS = a.n_sats;
  const int lane = threadIdx.x % 32;
  if (field == ERR) {
    for (int tt = threadIdx.x / 32; tt < g.nt; tt += TILE_THREADS / 32)
      load_row<T>(stage + tt * S * sizeof(int), a.err + (g.t0 + tt) * NS + g.s0,
               g.ns * static_cast<int>(sizeof(int)), lane);
    return;
  }
  const T* in = field == R ? a.r : a.v;
  if (a.source == FROM_PLANES) {
    for (int k = threadIdx.x / 32; k < 3 * g.nt; k += TILE_THREADS / 32) {
      const int c = k / g.nt, tt = k % g.nt;
      load_row<T>(stage + (c * TILE_T + tt) * S * sizeof(T),
               in + (c * NT + g.t0 + tt) * NS + g.s0,
               g.ns * static_cast<int>(sizeof(T)), lane);
    }
  } else {
    for (int tt = threadIdx.x / 32; tt < g.nt; tt += TILE_THREADS / 32)
      load_row<T>(stage + tt * 3 * S * sizeof(T),
               in + ((g.t0 + tt) * NS + g.s0) * 3,
               3 * g.ns * static_cast<int>(sizeof(T)), lane);
  }
}

// a staged item in the caller's frame, in place: a thread takes
// TILE_TIMES times of UNITS lanes (f64: 3 16-byte vectors of each lane's
// run), its warp neighbours the neighbouring lanes, so that the reads
// collide on no bank; of the codes, 4 times of a lane. Every thread reads
// its values before any is written.
template <typename T>
__device__ void convert_item(const Args<T>& a, unsigned char* stage,
                             const Tile& g, int field) {
  constexpr int S = TILE_S<T>, P = TILE_TIMES<T>;
  constexpr int UNITS = S * TILE_T / P / TILE_THREADS;
  constexpr int CODE_UNITS = S * TILE_T / 4 / TILE_THREADS;
  static_assert(UNITS * P * TILE_THREADS == S * TILE_T &&
                CODE_UNITS * 4 * TILE_THREADS == S * TILE_T, "whole units");
  if (field == ERR) {
    const int* tile = reinterpret_cast<const int*>(stage);
    int e[CODE_UNITS][4];
#pragma unroll
    for (int u = 0; u < CODE_UNITS; ++u) {
      const int q = threadIdx.x + u * TILE_THREADS;
      const int ts = q % S, tt0 = (q / S) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        e[u][j] = tile[min(tt0 + j, TILE_T - 1) * S + ts];
    }
    __syncthreads();
    int* runs = reinterpret_cast<int*>(stage);
#pragma unroll
    for (int u = 0; u < CODE_UNITS; ++u) {
      const int q = threadIdx.x + u * TILE_THREADS;
      const int ts = q % S, tt0 = (q / S) * 4;
      if (a.mask != nullptr && ts < g.ns && !a.mask[g.s0 + ts])
        e[u][0] = e[u][1] = e[u][2] = e[u][3] = -1;
      store_run(runs + ts * ERR_PITCH + tt0, 4, e[u]);
    }
    return;
  }
  const bool is_r = field == R;
  const T* tile = reinterpret_cast<const T*>(stage);
  T o[UNITS][3 * P];
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    const int q = threadIdx.x + u * TILE_THREADS;
    const int ts = q % S, tt0 = (q / S) * P;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int tt = tt0 + j;
      if (a.source == FROM_PLANES) {
#pragma unroll
        for (int c = 0; c < 3; ++c) o[u][3 * j + c] = tile[(c * TILE_T + tt) * S + ts];
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) o[u][3 * j + c] = tile[tt * 3 * S + 3 * ts + c];
      }
    }
  }
  __syncthreads();
  T* runs = reinterpret_cast<T*>(stage);
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    const int q = threadIdx.x + u * TILE_THREADS;
    const int ts = q % S, tt0 = (q / S) * P;
    if (ts >= g.ns || tt0 >= g.nt) continue;
    const bool masked = a.mask != nullptr && !a.mask[g.s0 + ts];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (tt0 + j >= g.nt) break;
      T& x = o[u][3 * j];
      T& y = o[u][3 * j + 1];
      T& z = o[u][3 * j + 2];
      if (masked) {
        x = y = z = T(0);
      } else {
        point(a, is_r, g.t0 + tt0 + j, x, y, z);
      }
    }
    // whole vectors: the values past the tile's last time are never
    // stored
    store_run(runs + ts * OUT_PITCH<T> + 3 * tt0, 3 * P, o[u]);
  }
}

// the converted lanes' runs to device memory, a warp a run
template <typename T>
__device__ void store_item(const Args<T>& a, const unsigned char* stage,
                           const Tile& g, int field) {
  const long long NT = a.n_times;
  const int lane = threadIdx.x % 32;
  for (int ts = threadIdx.x / 32; ts < g.ns; ts += TILE_THREADS / 32) {
    if (field == ERR) {
      store_row<T>(a.err_out + (g.s0 + ts) * NT + g.t0,
                stage + ts * ERR_PITCH * sizeof(int),
                g.nt * static_cast<int>(sizeof(int)), lane);
    } else {
      store_row<T>((field == R ? a.r_out : a.v_out) + ((g.s0 + ts) * NT + g.t0) * 3,
                stage + ts * OUT_PITCH<T> * sizeof(T),
                3 * g.nt * static_cast<int>(sizeof(T)), lane);
    }
  }
}

// an item of the walk: with WHOLE_TILES<T> a tile's every field, else one
// field of a tile (item i: field i / n_tiles of tile i % n_tiles, so that
// every block takes its share of each field)
template <typename T>
constexpr int ITEM_FIELDS = WHOLE_TILES<T> ? 3 : 1;

struct Item {
  Tile g;
  int first, count;  // the item's fields: a.fields[first, first + count)
};

template <typename T>
__device__ __forceinline__ Item item_at(const Args<T>& a, long long item,
                                           long long n_tiles, int n_fields) {
  if (WHOLE_TILES<T>) return {tile_at(a, item), 0, n_fields};
  return {tile_at(a, item % n_tiles), static_cast<int>(item / n_tiles), 1};
}

// where field k of an item lies in its stage
template <typename T>
__device__ __forceinline__ int region(int k, int n_vec) {
  return WHOLE_TILES<T> ? (k < n_vec ? k : n_vec) * FIELD_BYTES<T> : 0;
}

template <typename T>
__device__ __forceinline__ void load_stage(const Args<T>& a,
                                           unsigned char* stage,
                                           const Item& it) {
#pragma unroll
  for (int j = 0; j < ITEM_FIELDS<T>; ++j) {
    if (j == it.count) break;
    const int k = it.first + j;
    load_item(a, stage + region<T>(k, a.n_vec), it.g, a.fields[k]);
  }
}

// The persistent tile walk: block b takes items b, b + gridDim.x, ...
// The next STAGES - 1 items' loads are in flight while an item is
// converted and stored; a stage is refilled only after every warp has
// stored from it.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS, TILE_BLOCKS<T>)
    tile_kernel(const Args<T> a, long long n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_fields = a.n_vec + (a.err_out != nullptr ? 1 : 0);
  const long long n_items = WHOLE_TILES<T> ? n_tiles : n_tiles * n_fields;
  const long long step = gridDim.x;
  long long item = blockIdx.x;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    const long long ahead = item + k * step;
    if (ahead < n_items)
      load_stage(a, smem + k * ITEM_BYTES<T>,
                 item_at(a, ahead, n_tiles, n_fields));
    cp_async_commit();
  }
  for (int k = 0; item < n_items; ++k, item += step) {
    const long long ahead = item + (STAGES - 1) * step;
    if (ahead < n_items)
      load_stage(a, smem + ((k + STAGES - 1) % STAGES) * ITEM_BYTES<T>,
                 item_at(a, ahead, n_tiles, n_fields));
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const Item it = item_at(a, item, n_tiles, n_fields);
    unsigned char* stage = smem + (k % STAGES) * ITEM_BYTES<T>;
#pragma unroll
    for (int j = 0; j < ITEM_FIELDS<T>; ++j) {
      if (j == it.count) break;
      const int f = it.first + j;
      convert_item(a, stage + region<T>(f, a.n_vec), it.g, a.fields[f]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEM_FIELDS<T>; ++j) {
      if (j == it.count) break;
      const int f = it.first + j;
      store_item(a, stage + region<T>(f, a.n_vec), it.g, a.fields[f]);
    }
    __syncthreads();
  }
}

// the tile walk's grid on the current device: blocks an SM (its
// occupancy, at most TILE_BLOCKS; queried once a device), the card's SMs,
// and the blocks launched (no more than fit at once, nor than there are
// items)
template <typename T>
cudaError_t tile_grid(long long n_items, int* grid) {
  static int per_sm[MAX_DEVICES];
  static int sms[MAX_DEVICES];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    rc = cudaFuncSetAttribute(tile_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              STAGES * ITEM_BYTES<T>);
    if (rc == cudaSuccess)
      rc = cudaFuncSetAttribute(tile_kernel<T>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                  dev);
    int fit = 0;
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &fit, tile_kernel<T>, TILE_THREADS, STAGES * ITEM_BYTES<T>);
    if (rc != cudaSuccess) return rc;
    if (fit < 1) return cudaErrorInvalidConfiguration;
    per_sm[dev] = fit < TILE_BLOCKS<T> ? fit : TILE_BLOCKS<T>;
  }
  const long long resident = static_cast<long long>(per_sm[dev]) * sms[dev];
  grid[0] = per_sm[dev];
  grid[1] = sms[dev];
  grid[2] = static_cast<int>(n_items < resident ? n_items : resident);
  return cudaSuccess;
}

template <typename T>
long long tile_count(long long n_times, long long n_sats) {
  return ((n_times + TILE_T - 1) / TILE_T) *
         ((n_sats + TILE_S<T> - 1) / TILE_S<T>);
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
            source, layout, frame, {0, 0, 0}, 0,
            {static_cast<T>(a_km), static_cast<T>(e2),
             static_cast<T>(1.0 - e2), static_cast<T>(rad2deg),
             static_cast<T>(1e-12)}};
  int n_fields = 0;
  if (r_out != nullptr) a.fields[n_fields++] = R;
  if (v_out != nullptr) a.fields[n_fields++] = V;
  a.n_vec = n_fields;
  if (err_out != nullptr) a.fields[n_fields++] = ERR;
  if (n_fields == 0) return 0;
  if (err_out != nullptr && layout != SAT_MAJOR && mask == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout == SAT_MAJOR) {
    const long long tiles = tile_count<T>(n_times, n_sats);
    int grid[3];
    const cudaError_t rc =
        tile_grid<T>(WHOLE_TILES<T> ? tiles : tiles * n_fields, grid);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    tile_kernel<T><<<grid[2], TILE_THREADS, STAGES * ITEM_BYTES<T>, st>>>(
        a, tiles);
    return static_cast<int>(cudaGetLastError());
  }
  const long long per_block = static_cast<long long>(THREADS) * VEC<T>;
  const long long blocks = (n_times * n_sats + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flat_kernel<T><<<dim3(static_cast<unsigned>(blocks), n_fields), THREADS, 0,
                   st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int finalize_grid(long long n_times, long long n_sats, int want_vel,
                  int want_err, int* grid) {
  const long long items =
      tile_count<T>(n_times, n_sats) *
      (WHOLE_TILES<T> ? 1 : 1 + (want_vel != 0) + (want_err != 0));
  const cudaError_t rc = tile_grid<T>(items, grid);
  if (rc == cudaSuccess) grid[3] = static_cast<int>(items);
  return static_cast<int>(rc);
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

// The sat_major tile walk's grid on the current device at n_times x
// n_sats, with velocities (want_vel) and codes (want_err) or without:
// grid (4,) i32 out: blocks an SM, the card's SMs, blocks launched,
// items walked. Returns a cudaError_t.
extern "C" int astroz_finalize_grid_f32(long long n_times, long long n_sats,
                                        int want_vel, int want_err,
                                        int* grid) {
  return finalize_grid<float>(n_times, n_sats, want_vel, want_err, grid);
}

extern "C" int astroz_finalize_grid_f64(long long n_times, long long n_sats,
                                        int want_vel, int want_err,
                                        int* grid) {
  return finalize_grid<double>(n_times, n_sats, want_vel, want_err, grid);
}
