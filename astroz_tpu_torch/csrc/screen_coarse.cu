// All-vs-all conjunction screening, coarse pass, for Hopper: kernel K4.
//
// K4 replaces the TPU kernel astroz_tpu/ops/pallas_screen.py:_kernel
// (wrappers _coarse_chunk and coarse_min_all). From the (3, T, N) f32 TEME
// position planes it takes, for every pair (i, j) with j > i,
//   min over t of fma(dz, dz, fma(dx, dx, dy * dy)),
//   dx = x[t, i] - x[t, j]   (dy, dz alike)
// in f32 with the explicit intrinsics (the library is built with
// --fmad=false, so nothing else is contracted), and a min that keeps a NaN
// as torch.minimum does. That chain is the contraction XLA:CPU gives the
// TPU kernel's dx*dx + dy*dy + dz*dz. The plain torch versions are in
// ops/cuda_screen.py (coarse_min_chunk_reference emulates the FMA by
// rounding to odd in f64); kernel and plain version agree bit for bit.
//
// One kernel body, two exported modes:
//  * matrix mode (astroz_screen_coarse): the (N, width) f32 matrix of the
//    column chunk [j0, j0 + width), +inf at and below the diagonal. A tile
//    with no pair j > i writes +inf and skips its time loop.
//  * candidate mode (astroz_screen_candidates): the grid holds only the
//    tiles with a pair j > i (a linear block index maps to ti <= tj). After
//    the time loop each thread appends the (i, j) of its pairs whose
//    minimum is <= thr2 (NaN never is): one vote and, where a warp has
//    hits, one warp-wide prefix sum and one atomicAdd on a 64-bit counter
//    that counts every hit, even past the room given. The matrix is never
//    written.
//
// Bound. At 13,478 satellites x 240 epochs the strict upper triangle holds
// 2.18e10 pair-times. Counted as 9 f32 operations each (3 subtracts, 3
// multiplies, 2 adds, 1 min) at 67 TFLOP/s the card needs 2.928 ms; the
// inputs are 39 MB, so operations bound it. With FMA a pair-time is 7
// instructions (3 FADD, 1 FMUL, 2 FFMA, 1 FMNMX), and the card issues
// 132 SMs x 128 lanes x 1.98 GHz = 3.35e13 of them a second: a floor of
// 4.56 ms. The 2.928 ms bound counts an FFMA as two operations and is out
// of reach for the direct difference; the Gram form that would reach the
// tensor cores cancels by |r|^2 x eps (several km^2 in f32) against a
// 100 km^2 threshold, so it is not the function.
//
// Design, against that floor:
//  * FMA: 7 instructions a pair-time instead of 9.
//  * A 128 x 128 tile of pairs a block, 256 threads, an 8 x 8 micro-tile of
//    running minima in registers: rows 4*ty + a and 64 + 4*ty + a, columns
//    likewise with tx, so that each thread reads its 8 i-values and 8
//    j-values of a coordinate as two 16-byte shared loads (12 LDS.128 a
//    thread and epoch for 64 pair-times). The larger tile halves the L2
//    traffic of the 64 x 64 design (each plane is read about 106 times).
//  * Asynchronous staging, double-buffered: 16 epochs of the tile's 128 +
//    128 satellites (48 KiB a stage) are copied with cp.async (4 bytes, so
//    rows need no alignment: N is rarely a multiple of 4), zero-filled past
//    the ragged edge, while the previous 16 epochs compute. Each thread
//    stages one satellite of one side over 3 coordinates x 16 epochs with
//    64-bit pointer steps, no integer divide. A short last chunk is cut by
//    its epoch count, never padded.
//  * In candidate mode the epilogue replaces the 0.73 GB of stores, the
//    bool mask, the count pass and nonzero of a matrix screen.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TILE = 128;   // satellites per tile side (rows i, columns j)
constexpr int HALF = TILE / 2;
constexpr int SIDE = 16;    // threads per block side
constexpr int MICRO = 8;    // 8 x 8 pairs per thread
constexpr int TCHUNK = 16;  // epochs per stage
constexpr int THREADS = SIDE * SIDE;
// floats of one stage: [side (i, j)][coordinate][epoch][satellite]
constexpr int STAGE = 2 * 3 * TCHUNK * TILE;
constexpr size_t SMEM_BYTES = 2 * STAGE * sizeof(float);  // two stages
static_assert(THREADS == 2 * TILE, "one staging thread per satellite side");

// min that returns NaN when either argument is NaN (torch.minimum);
// fminf would drop it
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// 4-byte asynchronous copy to shared memory; zero-fills when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// row (or column) offset within the tile of micro-tile entry a
__device__ __forceinline__ int micro_offset(int t, int a) {
  return (a < 4 ? 0 : HALF - 4) + 4 * t + a;
}

// first linear index of row ti of the upper triangle (ti <= tj) of a
// tiles x tiles grid
__device__ __forceinline__ long long tri_row_start(long long ti,
                                                   long long tiles) {
  return ti * tiles - ti * (ti - 1) / 2;
}

// Stage epochs t0 .. t0 + TCHUNK - 1 of one satellite (column g of the
// planes, on side `side`) into stage buffer `buf`.
__device__ __forceinline__ void stage_chunk(float* buf, const float* r,
                                            size_t plane, size_t ns,
                                            int side, int s, int g,
                                            bool g_ok, int t0, int n_times) {
  float* dst = buf + side * 3 * TCHUNK * TILE + s;
  const float* col = r + (g_ok ? g : 0);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float* src = col + q * plane + (size_t)t0 * ns;
#pragma unroll
    for (int tt = 0; tt < TCHUNK; ++tt) {
      const bool ok = g_ok && t0 + tt < n_times;
      cp_async4(dst + (q * TCHUNK + tt) * TILE, ok ? src : r, ok);
      src += ns;
    }
  }
}

template <bool CANDIDATES>
__global__ void __launch_bounds__(THREADS)
screen_coarse_kernel(const float* __restrict__ r, int n_times, int n_sats,
                     int j0, int width, float* __restrict__ out, float thr2,
                     long long cap, int* __restrict__ out_ij,
                     unsigned long long* __restrict__ count) {
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int ty = tid / SIDE, tx = tid % SIDE;  // constants: shifts

  // the tile: rows [i_base, i_base + TILE), global columns [j_base, ...),
  // valid below j_end
  int i_base, j_base, j_end;
  if (CANDIDATES) {
    const long long tiles = (n_sats + TILE - 1) / TILE;
    const long long lin = blockIdx.x;
    const double b = 2.0 * (double)tiles + 1.0;
    long long ti = (long long)((b - sqrt(b * b - 8.0 * (double)lin)) * 0.5);
    ti = ti < 0 ? 0 : (ti >= tiles ? tiles - 1 : ti);
    while (ti + 1 < tiles && tri_row_start(ti + 1, tiles) <= lin) ++ti;
    while (ti > 0 && tri_row_start(ti, tiles) > lin) --ti;
    const long long tj = ti + (lin - tri_row_start(ti, tiles));
    i_base = (int)ti * TILE;
    j_base = (int)tj * TILE;
    j_end = n_sats;
  } else {
    i_base = blockIdx.y * TILE;
    j_base = j0 + blockIdx.x * TILE;
    j_end = j0 + width;
  }

  float m[MICRO][MICRO];
#pragma unroll
  for (int a = 0; a < MICRO; ++a)
#pragma unroll
    for (int b = 0; b < MICRO; ++b) m[a][b] = __int_as_float(0x7f800000);

  // the tile's largest column against its smallest row: no pair j > i in
  // it, so it keeps +inf
  const bool any_pair = min(j_base + TILE, j_end) - 1 > i_base;
  if (CANDIDATES && !any_pair) return;
  if (any_pair && n_times > 0) {
    const size_t ns = (size_t)n_sats;
    const size_t plane = (size_t)n_times * ns;
    // staging role: one satellite of one side
    const int side = tid / TILE, s = tid % TILE;
    const int g = (side == 0 ? i_base : j_base) + s;
    const bool g_ok = g < (side == 0 ? n_sats : j_end);
    const int n_chunks = (n_times + TCHUNK - 1) / TCHUNK;

    stage_chunk(smem, r, plane, ns, side, s, g, g_ok, 0, n_times);
    cp_async_commit();
    for (int c = 0; c < n_chunks; ++c) {
      const int t0 = c * TCHUNK;
      if (c + 1 < n_chunks) {
        stage_chunk(smem + ((c + 1) & 1) * STAGE, r, plane, ns, side, s, g,
                    g_ok, t0 + TCHUNK, n_times);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // chunk c has landed for every thread

      const float* st = smem + (c & 1) * STAGE;
      const int tn = min(TCHUNK, n_times - t0);
#pragma unroll 4
      for (int tt = 0; tt < tn; ++tt) {
        float vi[3][MICRO], vj[3][MICRO];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float* pi = st + (q * TCHUNK + tt) * TILE;
          const float* pj = pi + 3 * TCHUNK * TILE;
          const float4 i0 = *reinterpret_cast<const float4*>(pi + 4 * ty);
          const float4 i1 =
              *reinterpret_cast<const float4*>(pi + HALF + 4 * ty);
          const float4 j0v = *reinterpret_cast<const float4*>(pj + 4 * tx);
          const float4 j1v =
              *reinterpret_cast<const float4*>(pj + HALF + 4 * tx);
          vi[q][0] = i0.x; vi[q][1] = i0.y; vi[q][2] = i0.z; vi[q][3] = i0.w;
          vi[q][4] = i1.x; vi[q][5] = i1.y; vi[q][6] = i1.z; vi[q][7] = i1.w;
          vj[q][0] = j0v.x; vj[q][1] = j0v.y; vj[q][2] = j0v.z;
          vj[q][3] = j0v.w; vj[q][4] = j1v.x; vj[q][5] = j1v.y;
          vj[q][6] = j1v.z; vj[q][7] = j1v.w;
        }
#pragma unroll
        for (int a = 0; a < MICRO; ++a)
#pragma unroll
          for (int b = 0; b < MICRO; ++b) {
            const float dx = vi[0][a] - vj[0][b];
            const float dy = vi[1][a] - vj[1][b];
            const float dz = vi[2][a] - vj[2][b];
            m[a][b] = min_nan(m[a][b],
                              __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, dy * dy)));
          }
      }
      __syncthreads();  // chunk c has been read before it is overwritten
    }
  }

  if (!CANDIDATES) {
    const size_t w = (size_t)width;
#pragma unroll
    for (int a = 0; a < MICRO; ++a) {
      const int gi = i_base + micro_offset(ty, a);
      if (gi >= n_sats) continue;
#pragma unroll
      for (int b = 0; b < MICRO; ++b) {
        const int gj = j_base + micro_offset(tx, b);
        if (gj < j_end)
          out[(size_t)gi * w + (gj - j0)] =
              gj > gi ? m[a][b] : __int_as_float(0x7f800000);
      }
    }
    return;
  }

  // candidate epilogue: gj > gi and gj < n_sats imply gi < n_sats
  int n_hit = 0;
#pragma unroll
  for (int a = 0; a < MICRO; ++a) {
    const int gi = i_base + micro_offset(ty, a);
#pragma unroll
    for (int b = 0; b < MICRO; ++b) {
      const int gj = j_base + micro_offset(tx, b);
      n_hit += (gj < n_sats && gj > gi && m[a][b] <= thr2) ? 1 : 0;
    }
  }
  const unsigned full = 0xffffffffu;
  if (!__any_sync(full, n_hit > 0)) return;
  const int lane = tid & 31;
  int incl = n_hit;  // inclusive prefix sum over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(full, incl, d);
    if (lane >= d) incl += v;
  }
  unsigned long long base = 0;
  if (lane == 31) base = atomicAdd(count, (unsigned long long)incl);
  base = __shfl_sync(full, base, 31);
  unsigned long long k = base + (unsigned long long)(incl - n_hit);
  const unsigned long long room = (unsigned long long)cap;
#pragma unroll
  for (int a = 0; a < MICRO; ++a) {
    const int gi = i_base + micro_offset(ty, a);
#pragma unroll
    for (int b = 0; b < MICRO; ++b) {
      const int gj = j_base + micro_offset(tx, b);
      if (gj < n_sats && gj > gi && m[a][b] <= thr2) {
        if (k < room) {
          out_ij[2 * k] = gi;
          out_ij[2 * k + 1] = gj;
        }
        ++k;
      }
    }
  }
}

template <bool CANDIDATES>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(screen_coarse_kernel<CANDIDATES>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SMEM_BYTES);
}

}  // namespace

// Plain C entry points (bound with ctypes by astroz_tpu_torch/_build.py).
// Each launches on `stream` and returns the launch's cudaError_t
// (0 = success).
//
// Matrix mode. r: (3, T, N) f32 position planes; out: (N, width) f32, for
// the columns j0 .. j0 + width - 1 (0 <= j0, j0 + width <= N). Both
// contiguous on the current device.
extern "C" int astroz_screen_coarse(const float* r, int n_times, int n_sats,
                                    int j0, int width, float* out,
                                    void* stream) {
  if (n_sats <= 0 || width <= 0) return 0;
  cudaError_t err = allow_smem<false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((width + TILE - 1) / TILE, (n_sats + TILE - 1) / TILE);
  screen_coarse_kernel<false>
      <<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
          r, n_times, n_sats, j0, width, out, 0.0f, 0, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// Candidate mode. r: (3, T, N) f32 position planes; out_ij: (cap, 2) int32
// (i, j) pairs, in no order; count: one uint64, zeroed by the caller, to
// which the kernel adds every pair with j > i and minimum <= thr2 (only the
// first cap of them are written).
extern "C" int astroz_screen_candidates(const float* r, int n_times,
                                        int n_sats, float thr2,
                                        long long cap, int* out_ij,
                                        unsigned long long* count,
                                        void* stream) {
  if (n_sats <= 0) return 0;
  cudaError_t err = allow_smem<true>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (n_sats + TILE - 1) / TILE;
  const long long blocks = tiles * (tiles + 1) / 2;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  screen_coarse_kernel<true>
      <<<(unsigned)blocks, THREADS, SMEM_BYTES,
         static_cast<cudaStream_t>(stream)>>>(r, n_times, n_sats, 0, n_sats,
                                              nullptr, thr2, cap, out_ij,
                                              count);
  return static_cast<int>(cudaGetLastError());
}
