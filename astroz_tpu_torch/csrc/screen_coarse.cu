// All-vs-all conjunction screening, coarse pass, for Hopper: kernel K4.
//
// K4 replaces the TPU kernel astroz_tpu/ops/pallas_screen.py:_kernel
// (wrappers _coarse_chunk and coarse_min_all). Given the (3, T, N) f32
// TEME position planes and one column chunk [j0, j0 + width), it writes
// out (N, width) f32 with, for every pair (i, j = j0 + c) with j > i,
//   out[i, c] = min over t of (dx*dx + dy*dy) + dz*dz,
//   dx = x[t, i] - x[t, j]   (dy, dz alike)
// in f32, in that order, with no FMA (the library is built with
// --fmad=false), and a min that keeps a NaN as torch.minimum does. The
// plain torch version is ops/cuda_screen.py:coarse_min_chunk_reference;
// the two agree bit for bit. Entries at or below the diagonal (j <= i)
// are +inf: a tile holding no pair j > i writes +inf and skips its time
// loop (the TPU kernel's diagonal skip), a tile that straddles the
// diagonal stores +inf there, so a caller thresholds the chunk with no
// triangle mask of its own.
//
// Bound. At 13,478 satellites x 240 epochs the strict upper triangle holds
// 2.18e10 pair-times of 9 f32 operations each (3 subtracts, 3 multiplies,
// 2 adds, 1 min: without FMA each is one instruction), 1.96e11 in all;
// the inputs are 39 MB and the output 0.73 GB. Operations bound it: the
// design must reuse every loaded position many times from on-chip memory.
//
// Design, simple first. One block of 16 x 16 threads owns a 64 x 64 tile of
// pairs; each thread keeps a 4 x 4 micro-tile of running minima in
// registers (rows ty + 16a, columns tx + 16b, so that a warp's shared-memory
// reads are broadcasts or 16 consecutive words). The block walks the time
// axis in chunks of 16 epochs: each chunk stages x, y, z of its 64 i and 64
// j satellites into shared memory with loads coalesced along the satellite
// axis of the planes, then every thread updates its 16 minima from shared
// memory. The kernel masks its own ragged edges, so the output is the exact
// (N, width) with no padded rows or columns, and addresses are 64-bit (a
// row offset i * width overflows 32 bits past ~46,000 satellites). What the
// TPU kernel needed and this one does not: the pre-transposed i-side copy,
// time padding by repeated epochs, parking of padding satellites and the
// scalar prefetch of j0 (a kernel argument). wgmma, TMA and a persistent
// grid are later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TILE = 64;    // satellites per tile side (rows i, columns j)
constexpr int SIDE = 16;    // threads per block side
constexpr int MICRO = TILE / SIDE;  // 4 x 4 pairs per thread
constexpr int TCHUNK = 16;  // epochs staged in shared memory per pass
constexpr int THREADS = SIDE * SIDE;

// min that returns NaN when either argument is NaN (torch.minimum);
// fminf would drop it
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__global__ void __launch_bounds__(THREADS)
screen_coarse_kernel(const float* __restrict__ r, int n_times, int n_sats,
                     int j0, int width, float* __restrict__ out) {
  __shared__ float s_i[3][TCHUNK][TILE];
  __shared__ float s_j[3][TCHUNK][TILE];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * SIDE + tx;
  const int i_base = blockIdx.y * TILE;  // first row of the tile
  const int c_base = blockIdx.x * TILE;  // first column, within the chunk
  const size_t w = (size_t)width;

  float m[MICRO][MICRO];
#pragma unroll
  for (int a = 0; a < MICRO; ++a)
#pragma unroll
    for (int b = 0; b < MICRO; ++b) m[a][b] = __int_as_float(0x7f800000);

  // the tile's largest global column against its smallest row: no pair
  // j > i in it, so it keeps +inf
  const int gj_max = j0 + min(c_base + TILE, width) - 1;
  if (gj_max > i_base) {
    const size_t ns = (size_t)n_sats;
    const size_t plane = (size_t)n_times * ns;
    for (int t0 = 0; t0 < n_times; t0 += TCHUNK) {
      const int tn = min(TCHUNK, n_times - t0);
      __syncthreads();  // the previous chunk has been read
      for (int k = tid; k < TCHUNK * TILE; k += THREADS) {
        const int tt = k / TILE, s = k % TILE;
        const int gi = i_base + s, c = c_base + s;
        const size_t row = (size_t)(t0 + tt) * ns;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          s_i[q][tt][s] =
              (tt < tn && gi < n_sats) ? r[q * plane + row + gi] : 0.0f;
          s_j[q][tt][s] =
              (tt < tn && c < width) ? r[q * plane + row + j0 + c] : 0.0f;
        }
      }
      __syncthreads();
      for (int tt = 0; tt < tn; ++tt) {
        float xi[MICRO], yi[MICRO], zi[MICRO];
        float xj[MICRO], yj[MICRO], zj[MICRO];
#pragma unroll
        for (int a = 0; a < MICRO; ++a) {
          xi[a] = s_i[0][tt][ty + SIDE * a];
          yi[a] = s_i[1][tt][ty + SIDE * a];
          zi[a] = s_i[2][tt][ty + SIDE * a];
          xj[a] = s_j[0][tt][tx + SIDE * a];
          yj[a] = s_j[1][tt][tx + SIDE * a];
          zj[a] = s_j[2][tt][tx + SIDE * a];
        }
#pragma unroll
        for (int a = 0; a < MICRO; ++a)
#pragma unroll
          for (int b = 0; b < MICRO; ++b) {
            const float dx = xi[a] - xj[b];
            const float dy = yi[a] - yj[b];
            const float dz = zi[a] - zj[b];
            m[a][b] = min_nan(m[a][b], (dx * dx + dy * dy) + dz * dz);
          }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < MICRO; ++a) {
    const int gi = i_base + ty + SIDE * a;
    if (gi >= n_sats) continue;
#pragma unroll
    for (int b = 0; b < MICRO; ++b) {
      const int c = c_base + tx + SIDE * b;
      if (c < width)
        out[(size_t)gi * w + c] =
            j0 + c > gi ? m[a][b] : __int_as_float(0x7f800000);
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes by astroz_tpu_torch/_build.py).
// r: (3, T, N) f32 position planes; out: (N, width) f32, for the columns
// j0 .. j0 + width - 1 (0 <= j0, j0 + width <= N). Both contiguous on the
// current device. Launch on `stream` and return the launch's cudaError_t
// (0 = success).
extern "C" int astroz_screen_coarse(const float* r, int n_times, int n_sats,
                                    int j0, int width, float* out,
                                    void* stream) {
  if (n_sats <= 0 || width <= 0) return 0;
  const dim3 grid((width + TILE - 1) / TILE, (n_sats + TILE - 1) / TILE);
  const dim3 block(SIDE, SIDE);
  screen_coarse_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      r, n_times, n_sats, j0, width, out);
  return static_cast<int>(cudaGetLastError());
}
