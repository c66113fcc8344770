"""Time variants of the port's near-earth kernel source on one NVIDIA GPU,
in turns; or measure on the CPU how FMA contraction moves the tail's
sincos and angle_add.

Run from the repository root::

    python3 shallow_variants.py [--variants NAME ...] [--tree DIR]
        [--rounds N] [--tag TAG] [--kernels NAME ...]
    python3 shallow_variants.py --fma-ulps

A variant is a copy of the package ``astroz_tpu_torch`` with the named
edits of :data:`VARIANTS` made to its sources, imported under a name of
its own, so that its wrappers build and launch its own kernel library
(in the copy's ``csrc/build/``). The copies live in
``astroz_tpu_torch/csrc/build/variants/``. ``default`` is the package as
it is; ``--tree DIR`` adds ``tree``, the package of another checkout as
it is (for example the parent commit unpacked with ``git archive`` into
a directory that ``.gitignore`` lists). Every variant's kernels are timed
with CUDA events at the main path's shapes, round after round, the order
of the variants reversed on every other round:

* K1 (``propagate_fast_sep``): ``chip_smoke.near_earth_catalog_text`` x
  1,440 one-minute epochs, with velocities;
* K3 (``propagate_fast_sep_merge``): ``chip_smoke.mixed_catalog_text`` x
  1,440, on the default build's K2 planes;
* K5 and K6: one (4,096, 1,024) chunk of bench_single_sat's 1year_1s
  grid (the ISS x 1,024 lanes, 5 trips), into the (3, T, S) planes;
  ``K5tm``: the same through ``propagate_fast_fused`` (time-major, the
  elements staged); ``K6tm``: K6 into the time-major layout, as
  ``propagate_fast_grids`` runs it (a tree without K6's time-major store:
  K6's planes and their relayout); ``spine``: the f64 spine's six grids
  of the chunk (``spine_grids``: the spine kernel, or a tree's torch
  spine); ``grids``: the whole ``propagate_fast_grids`` call, replayed,
  and ``grids_b2b`` launched back to back; ``sweep``: the whole 1year_1s
  grid (8 chunks) through ``propagate_fast_fused``;
* K2: the mixed catalog's deep subset x 1,440, its slots grouped by
  regime (``propagation.deep_slots``); ``K2c``: the same with the slots
  in catalog order, so that warps mix the Lyddane branch with the
  other.

It prints, for each variant, ptxas' registers and spills of every
kernel instantiation, the static SASS instructions of K5's and K2's row
loops (``chip_smoke.row_loop_instructions``), whether its outputs equal
the default build's bit for bit, each kernel's time in every round and
the mean, the card's name and power limit, and a JSON line with all of
it, also written to ``variants_<tag>.json`` in the output directory
beside this script. A kernel's
calls are replayed from a CUDA graph between CUDA events
(``chip_smoke._graph_ms``), so that the host's time a call does not count
where it is longer than the kernel's; the sweep and ``grids_b2b`` are
timed with CUDA events around their calls, host gaps included.
``--kernels`` times only the named workloads.

``--fma-ulps`` runs on the CPU: sincos and angle_add of
``ops/fastmath.py`` with every multiply-add fused as ``--fmad=true``
would fuse it (each emulated with ``ops/cuda_screen.fma_f32``, the
first product of a sum of two products fused), against the plain
versions on the inputs of ``tests/test_torch_fastmath.py``: the largest
distance in f32 ulps of the result and the share of outputs more than
one ulp away.
"""

import argparse
import concurrent.futures
import importlib
import importlib.util
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
VARIANT_DIR = ROOT / "astroz_tpu_torch" / "csrc" / "build" / "variants"
N_SATS, N_TIMES = 13478, 1440
K_REPS = {"K1": 20, "K3": 20, "K5": 50, "K6": 50, "K2": 50, "K5tm": 50,
          "K6tm": 50, "spine": 50, "grids": 50, "grids_b2b": 20,
          "sweep": 5, "K2c": 50}
#: workloads timed with CUDA events around calls launched back to back
_BACK_TO_BACK = ("sweep", "grids_b2b")
#: mangled template arguments of the kernels: (velocities, trips, mode);
#: in older trees K5 is mode 2 of the shallow kernel or the dense one
#: without a source, K6 mode 3 of the shallow one
_SHALLOW = re.compile(r"sgp4_shallow_kernelILb(\d)ELi(\d+)ELi(\d)E")
_DENSE = re.compile(r"sgp4_dense_kernelILb(\d)ELi(\d+)E(?:Li(\d)E)?")
_DEEP = re.compile(r"sgp4_deep_kernelILb(\d)ELi(\d+)E")
_SPINE = re.compile(r"sgp4_spine_grids_kernel")
_MODES = ("K1", "K3", "K5", "K6")
#: K5, K6 and K2 with velocities at the timed trips, in this tree and
#: before (the first name a library has)
_LOOPS = {"K5": ("sgp4_dense_kernelILb1ELi5ELi0E",
                 "sgp4_dense_kernelILb1ELi5E",
                 "sgp4_shallow_kernelILb1ELi5ELi2E"),
          "K6": ("sgp4_dense_kernelILb1ELi5ELi1E",
                 "sgp4_shallow_kernelILb1ELi5ELi3E"),
          "K2": ("sgp4_deep_kernelILb1ELi6E",)}

_SHALLOW_CU = "csrc/sgp4_shallow.cu"
_DEEP_CU = "csrc/sgp4_deep.cu"
_COMMON = "csrc/sgp4_common.cuh"

#: --fmad=true in place of --fmad=false: every multiply-add contracted
#: (timing only; its bits are not the plain versions')
FMAD = [("_build.py", '"--fmad=false"', '"--fmad=true"', 1)]


def _rows(n):
    return [(_SHALLOW_CU, "constexpr int ROWS = 8;",
             f"constexpr int ROWS = {n};", 1)]


def _min_blocks(n):
    return [(_SHALLOW_CU, "__launch_bounds__(BLOCK)\nsgp4_shallow_kernel",
             f"__launch_bounds__(BLOCK, {n})\nsgp4_shallow_kernel", 1)]


def _constant(rel, name, value):
    """Set ``constexpr int <name>`` of the package file ``rel``."""
    text = (ROOT / "astroz_tpu_torch" / rel).read_text()
    old = re.search(rf"constexpr int {name} = \d+;", text).group(0)
    return [(rel, old, f"constexpr int {name} = {value};", 1)]


# K5 and K2 keep their satellites' fields in registers across the rows
# in place of shared memory; with no register cap
REGISTERS = [(_COMMON, """\
  T (*rows)[B];
  __device__ __forceinline__ T operator[](int k) const {
    return rows[k][threadIdx.x];
  }
  // field k of satellite s from row k of an (N, stride) matrix
  __device__ __forceinline__ void load(const T* src, size_t stride,
                                       size_t s) {
#pragma unroll
    for (int k = 0; k < N; ++k) rows[k][threadIdx.x] = src[k * stride + s];
  }
""", """\
  T x[N];
  __device__ __forceinline__ SharedFields(T (*)[B]) {}
  __device__ __forceinline__ T operator[](int k) const { return x[k]; }
  __device__ __forceinline__ void load(const T* src, size_t stride,
                                       size_t s) {
#pragma unroll
    for (int k = 0; k < N; ++k) x[k] = src[k * stride + s];
  }
""", 1)]
# fmod_exact's fallback for |x| >= 2^52 (CUDA's f64 fmod, a loop) in a
# function of its own, out of the row loops
FMOD_OUT_OF_LINE = [
    (_COMMON, """\
__device__ __forceinline__ double fmod_exact(double x, double d,
""", """\
__device__ __noinline__ double fmod_slow(double x, double d) {
  return fmod(x, d);
}
__device__ __forceinline__ double fmod_exact(double x, double d,
""", 1),
    (_COMMON, "  if (!(a < 0x1p52)) return fmod(x, d);",
     "  if (!(a < 0x1p52)) return fmod_slow(x, d);", 1)]
NO_MIN_BLOCKS = (_constant(_SHALLOW_CU, "DENSE_MIN_BLOCKS", 1)
                 + _constant(_DEEP_CU, "DEEP_MIN_BLOCKS", 1))

# K5 loads each unit's tsince at the head of the unit (K6 always does)
NO_PREFETCH = [(_SHALLOW_CU, "constexpr bool AHEAD = SRC == TSINCE;",
                "constexpr bool AHEAD = false;", 1)]
# K6 loads the next unit's six grid values ahead, as K5 its tsince
K6_LOOKAHEAD = [(_SHALLOW_CU, "constexpr bool AHEAD = SRC == TSINCE;",
                 "constexpr bool AHEAD = true;", 1)]
# K6 keeps its 21 tail fields in shared memory, as K5 does
K6_SHARED = [
    (_SHALLOW_CU, "tail_rows[SRC == TSINCE ? N_TAIL : 1][BLOCK];",
     "tail_rows[N_TAIL][BLOCK];", 1),
    (_SHALLOW_CU, "      return RegFields<float, N_TAIL>{};",
     "      return SharedFields<float, N_TAIL, BLOCK>{tail_rows};", 1)]

# the end of the dense kernel: its walk, after the fields and the run
_DENSE_WALK_END = """\
        store_point<WANT_VEL>(o, idx, plane, a.r, a.v, a.err);
    }
  }
}
"""
_DENSE_WALK_START = """\
  UnitInput<SRC> in{};
"""
_CP_ASYNC = """\
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\\n" ::"n"(PENDING));
}

"""


def _k6_ring(stages):
    """K6 stages its next ``stages - 1`` units' six grid values in a ring
    of shared memory with 4-byte ``cp.async`` copies, in place of loading
    them at the head of each unit (K5 as it is)."""
    return [
        (_SHALLOW_CU, "// K5 and K6: each warp walks its run",
         _CP_ASYNC + "// K5 and K6: each warp walks its run", 1),
        (_SHALLOW_CU, _DENSE_WALK_START, f"""\
  if constexpr (SRC == GRIDS) {{
    constexpr int STAGES = {stages};
    __shared__ float ring[STAGES][6][BLOCK];
    int f_ti = ti, f_s = s;  // the next unit to fetch
    long long fetched = 0;
    auto fetch = [&]() {{
      if (fetched < run.count) {{
        const int slot = (int)(fetched % STAGES);
        const bool ok = f_s < n_sats;
        const size_t idx = ok ? (size_t)f_ti * ns + f_s : 0;
#pragma unroll
        for (int c = 0; c < 6; ++c)
          cp_async4(&ring[slot][c][threadIdx.x], a.grids[c] + idx, ok);
        if (++f_ti == n_times) {{
          f_ti = 0;
          f_s += WARP;
        }}
        ++fetched;
      }}
      cp_async_commit();
    }};
    for (int j = 0; j < STAGES - 1; ++j) fetch();
    for (long long k = 0; k < run.count; ++k) {{
      if (col != loaded) {{
        if (s < n_sats) {{
          tf.load(a.tail, ns, s);
          not_simp = a.flags[s] == 0;
          error0 = a.flags[ns + s];
        }}
        loaded = col;
      }}
      const int t_row = ti, t_sat = s;
      if (++ti == n_times) {{
        ti = 0;
        ++col;
        s += WARP;
      }}
      fetch();
      cp_async_wait<STAGES - 1>();
      const int slot = (int)(k % STAGES);
      Spine g;
      g.t32 = ring[slot][0][threadIdx.x];
      g.u_base = ring[slot][1][threadIdx.x];
      g.mm = ring[slot][2][threadIdx.x];
      g.argp32 = ring[slot][3][threadIdx.x];
      g.node32 = ring[slot][4][threadIdx.x];
      g.xmdf32 = ring[slot][5][threadIdx.x];
      if (t_sat < n_sats) {{
        const PosVel o = shallow_tail<WANT_VEL, ITERS>(
            g, tf, not_simp, error0, a.j2, a.re, a.vkmpersec);
        const size_t idx = (size_t)t_row * ns + t_sat;
        if (a.time_major)
          store_point_time_major<WANT_VEL>(o, idx, a.r, a.v, a.err);
        else
          store_point<WANT_VEL>(o, idx, plane, a.r, a.v, a.err);
      }}
    }}
  }} else {{
""" + _DENSE_WALK_START, 1),
        (_SHALLOW_CU, _DENSE_WALK_END, _DENSE_WALK_END[:-2] + "  }\n}\n", 1)]


# K6 on an even S: a lane owns two neighbouring satellites of a 64-wide
# column and reads each grid as one 8-byte pair, runs the two tails and
# writes 8-byte pairs (timing only: it assumes an even S)
K6_PAIRS = [
    (_SHALLOW_CU, "// K5 and K6: each warp walks its run", """\
// the tail fields of a lane's satellite `off / BLOCK` of its pair
struct PairFields {
  float (*rows)[2 * BLOCK];
  int off;
  __device__ __forceinline__ float operator[](int k) const {
    return rows[k][off + threadIdx.x];
  }
};

// K5 and K6: each warp walks its run""", 1),
    (_SHALLOW_CU, """\
sgp4_dense_kernel(const DenseArgs a) {
""", """\
sgp4_dense_kernel(const DenseArgs a) {
  if constexpr (SRC == GRIDS) {
    __shared__ float pair_rows[N_TAIL][2 * BLOCK];
    const int n_times = a.n_times, n_pairs = a.n_sats / 2;
    const size_t ns = (size_t)a.n_sats, np = (size_t)n_pairs;
    const size_t plane = (size_t)n_times * ns;
    const WarpRun run =
        warp_run((long long)((n_pairs + WARP - 1) / WARP) * n_times);
    if (run.count == 0) return;
    int col = (int)(run.first / n_times);
    int ti = (int)(run.first % n_times);
    int p = col * WARP + (int)(threadIdx.x % WARP);
    int loaded = -1;
    bool not_simp[2] = {false, false};
    int error0[2] = {0, 0};
    float2 next[6];
    if (p < n_pairs) {
#pragma unroll
      for (int c = 0; c < 6; ++c)
        next[c] = reinterpret_cast<const float2*>(a.grids[c])[
            (size_t)ti * np + p];
    }
    for (long long k = run.count; k > 0; --k) {
      if (col != loaded) {
        if (p < n_pairs) {
#pragma unroll
          for (int f = 0; f < N_TAIL; ++f) {
            pair_rows[f][threadIdx.x] = a.tail[f * ns + 2 * p];
            pair_rows[f][BLOCK + threadIdx.x] = a.tail[f * ns + 2 * p + 1];
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            not_simp[j] = a.flags[2 * p + j] == 0;
            error0[j] = a.flags[ns + 2 * p + j];
          }
        }
        loaded = col;
      }
      const int t_row = ti, t_pair = p;
      float2 cur[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) cur[c] = next[c];
      if (++ti == n_times) {
        ti = 0;
        ++col;
        p += WARP;
      }
      if (k > 1 && p < n_pairs) {
#pragma unroll
        for (int c = 0; c < 6; ++c)
          next[c] = reinterpret_cast<const float2*>(a.grids[c])[
              (size_t)ti * np + p];
      }
      if (t_pair < n_pairs) {
        PosVel o[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          Spine g;
          g.t32 = j ? cur[0].y : cur[0].x;
          g.u_base = j ? cur[1].y : cur[1].x;
          g.mm = j ? cur[2].y : cur[2].x;
          g.argp32 = j ? cur[3].y : cur[3].x;
          g.node32 = j ? cur[4].y : cur[4].x;
          g.xmdf32 = j ? cur[5].y : cur[5].x;
          o[j] = shallow_tail<WANT_VEL, ITERS>(
              g, PairFields{pair_rows, j * BLOCK}, not_simp[j], error0[j],
              a.j2, a.re, a.vkmpersec);
        }
        const size_t idx = (size_t)t_row * ns + 2 * (size_t)t_pair;
        if (a.time_major) {
          float2* rp = reinterpret_cast<float2*>(a.r + 3 * idx);
          rp[0] = make_float2(o[0].r[0], o[0].r[1]);
          rp[1] = make_float2(o[0].r[2], o[1].r[0]);
          rp[2] = make_float2(o[1].r[1], o[1].r[2]);
          if (WANT_VEL) {
            float2* vp = reinterpret_cast<float2*>(a.v + 3 * idx);
            vp[0] = make_float2(o[0].v[0], o[0].v[1]);
            vp[1] = make_float2(o[0].v[2], o[1].v[0]);
            vp[2] = make_float2(o[1].v[1], o[1].v[2]);
          }
        } else {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            *reinterpret_cast<float2*>(a.r + c * plane + idx) =
                make_float2(o[0].r[c], o[1].r[c]);
            if (WANT_VEL)
              *reinterpret_cast<float2*>(a.v + c * plane + idx) =
                  make_float2(o[0].v[c], o[1].v[c]);
          }
        }
        *reinterpret_cast<int2*>(a.err + idx) =
            make_int2(o[0].error, o[1].error);
      }
    }
  } else {
""", 1),
    (_SHALLOW_CU, _DENSE_WALK_END, _DENSE_WALK_END[:-2] + "  }\n}\n", 1)]


# The guards write a function's multiply-adds with __fmul_rn / __fadd_rn
# (and __dmul_rn / __dadd_rn), which nvcc never contracts: the same
# operations in the same order, so with --fmad=false the bits do not move.
GUARD_SPINE = [(_SHALLOW_CU, """\
  const double xmdf = mo + mdot * t;
  const double argpdf = argpo + argpdot * t;
  const double t2 = t * t;
  const double nodem64 = nodeo + nodedot * t + nodecf * t2;
  const double templ_big =
      no_unkozai * t2 * (t2cof + t * (t3cof + t * (t4cof + t * t5cof)));
""", """\
  const double xmdf = __dadd_rn(mo, __dmul_rn(mdot, t));
  const double argpdf = __dadd_rn(argpo, __dmul_rn(argpdot, t));
  const double t2 = t * t;
  const double nodem64 = __dadd_rn(__dadd_rn(nodeo, __dmul_rn(nodedot, t)),
                                   __dmul_rn(nodecf, t2));
  const double poly = __dadd_rn(t2cof, __dmul_rn(t, __dadd_rn(
      t3cof, __dmul_rn(t, __dadd_rn(t4cof, __dmul_rn(t, t5cof))))));
  const double templ_big = __dmul_rn(no_unkozai * t2, poly);
""", 1)]
GUARD_SINCOS = [(_COMMON, """\
  const float y = ((x - k * PIO2_HI) - k * PIO2_MED) - k * PIO2_LO;
  const float y2 = y * y;
  const float sp = y + y * y2 * (S1 + y2 * (S2 + y2 * S3));
  const float cp = 1.0f - 0.5f * y2 + y2 * y2 * (C1 + y2 * (C2 + y2 * C3));
""", """\
  const float y = __fsub_rn(__fsub_rn(__fsub_rn(x, __fmul_rn(k, PIO2_HI)),
                                      __fmul_rn(k, PIO2_MED)),
                            __fmul_rn(k, PIO2_LO));
  const float y2 = y * y;
  const float ps = __fadd_rn(S1, __fmul_rn(y2, __fadd_rn(S2,
                                                         __fmul_rn(y2, S3))));
  const float sp = __fadd_rn(y, __fmul_rn(y * y2, ps));
  const float pc = __fadd_rn(C1, __fmul_rn(y2, __fadd_rn(C2,
                                                         __fmul_rn(y2, C3))));
  const float cp = __fadd_rn(__fsub_rn(1.0f, __fmul_rn(0.5f, y2)),
                             __fmul_rn(y2 * y2, pc));
""", 1)]
GUARD_ANGLE_ADD = [(_COMMON, """\
  const float sd = delta * (1.0f - d2 * SIXTH * (1.0f - F32(0.05) * d2));
  const float cd = 1.0f - 0.5f * d2 * (1.0f - d2 * TWELFTH);
  s = sin_a * cd + cos_a * sd;
  c = cos_a * cd - sin_a * sd;
""", """\
  const float sd = delta * __fsub_rn(1.0f, __fmul_rn(d2 * SIXTH, __fsub_rn(
                               1.0f, __fmul_rn(F32(0.05), d2))));
  const float cd = __fsub_rn(1.0f, __fmul_rn(0.5f * d2, __fsub_rn(
                                       1.0f, __fmul_rn(d2, TWELFTH))));
  s = __fadd_rn(__fmul_rn(sin_a, cd), __fmul_rn(cos_a, sd));
  c = __fsub_rn(__fmul_rn(cos_a, cd), __fmul_rn(sin_a, sd));
""", 1)]
GUARD_NEWTON = [
    (_COMMON, """\
const float denom = 1.0f - coseo1 * axnl - sineo1 * aynl;""", """\
const float denom = __fsub_rn(__fsub_rn(1.0f, __fmul_rn(coseo1, axnl)),
                                  __fmul_rn(sineo1, aynl));""", 2),
    (_COMMON, """\
const float tem5 = (u - aynl * coseo1 + axnl * sineo1 - eo1) / denom;""",
     """\
const float tem5 = __fsub_rn(__fadd_rn(__fsub_rn(u, __fmul_rn(aynl, coseo1)),
                                           __fmul_rn(axnl, sineo1)),
                                 eo1) / denom;""", 2),
    (_COMMON, """\
  const float sind = d * (1.0f - THIRD * d2h);
  const float cosd = 1.0f - d2h;
  const float s = sineo1 * cosd + coseo1 * sind;
  const float c = coseo1 * cosd - sineo1 * sind;
""", """\
  const float sind = d * __fsub_rn(1.0f, __fmul_rn(THIRD, d2h));
  const float cosd = 1.0f - d2h;
  const float s = __fadd_rn(__fmul_rn(sineo1, cosd), __fmul_rn(coseo1, sind));
  const float c = __fsub_rn(__fmul_rn(coseo1, cosd), __fmul_rn(sineo1, sind));
""", 1)]
GUARDS = GUARD_SPINE + GUARD_SINCOS + GUARD_ANGLE_ADD + GUARD_NEWTON

#: name -> [(file in the package, text, replacement, times it occurs)]
VARIANTS = {
    "default": [],
    "rows16": _rows(16),
    "rows32": _rows(32),
    "minblocks5": _min_blocks(5),
    "minblocks6": _min_blocks(6),
    "minblocks8": _min_blocks(8),
    # two time rows in flight in one thread: two Newton chains to overlap
    "pairs": [(_SHALLOW_CU, """\
  for (int ti = t_begin; ti < t_end; ++ti) {
    const Spine g = spine_f64(t_time[ti] - epoch, sp);
    const PosVel o = shallow_tail<WANT_VEL, ITERS>(g, tf, not_simp, error0,
                                                   j2, re, vkmpersec);
    store_point<WANT_VEL>(o, (size_t)ti * ns + s, plane, r, v, err);
  }
""", """\
  for (int ti = t_begin; ti < t_end; ti += 2) {
    const int tj = min(ti + 1, t_end - 1);
    const Spine g0 = spine_f64(t_time[ti] - epoch, sp);
    const Spine g1 = spine_f64(t_time[tj] - epoch, sp);
    const PosVel o0 = shallow_tail<WANT_VEL, ITERS>(g0, tf, not_simp,
                                                    error0, j2, re,
                                                    vkmpersec);
    const PosVel o1 = shallow_tail<WANT_VEL, ITERS>(g1, tf, not_simp,
                                                    error0, j2, re,
                                                    vkmpersec);
    store_point<WANT_VEL>(o0, (size_t)ti * ns + s, plane, r, v, err);
    if (tj != ti)
      store_point<WANT_VEL>(o1, (size_t)tj * ns + s, plane, r, v, err);
  }
""", 1)],
    # the guards alone: must equal the default build bit for bit
    "guards": GUARDS,
    "fmad": FMAD,
    # the f32 tail contracted, K1's f64 spine not
    "fmad_tail": FMAD + GUARD_SPINE,
    # only the multiply-adds outside the spine, sincos, angle_add and
    # the Newton solve contracted
    "fmad_outer": FMAD + GUARDS,
    # K5 and K2: the kept build is the balanced persistent grid
    # (a), fields in shared memory under a register cap (b) and, in K5,
    # the next row's tsince loaded ahead (c)
    "grid_only": REGISTERS + NO_MIN_BLOCKS + NO_PREFETCH,  # a alone
    "registers": REGISTERS + NO_MIN_BLOCKS,  # a + c
    "shared_no_cap": NO_MIN_BLOCKS,  # a + b without a register cap
    "no_prefetch": NO_PREFETCH,  # a + b
    "fmod_out_of_line": FMOD_OUT_OF_LINE,
    # K6: its own block count an SM (the kept one is 8, at 64 registers
    # without a spill), the next unit's grid values loaded ahead, its
    # tail fields in shared memory (both: the walk as K5 runs it), a
    # cp.async ring of 2 or 4 units, 8-byte pairs; the spine kernel's
    # rows a thread (the kept one is 4)
    **{f"k6_min{n}": _constant(_SHALLOW_CU, "GRIDS_MIN_BLOCKS", n)
       for n in (6, 7, 10)},
    "k6_lookahead": K6_LOOKAHEAD,
    "k6_shared": K6_SHARED,
    "k6_shared_lookahead": K6_SHARED + K6_LOOKAHEAD,
    "k6_ring2": _k6_ring(2),
    "k6_ring4": _k6_ring(4),
    "k6_pairs8": K6_PAIRS,
    **{f"spine_rows{n}": _constant(_SHALLOW_CU, "SPINE_ROWS", n)
       for n in (1, 2, 8, 16)},
    # K2's resonance row by CUDA's f64 fmod (a loop) in place of
    # fmod_exact's one FMA
    "k2_cuda_fmod": [(_DEEP_CU, "fmod_exact(at, STEPP, 1.0 / STEPP)",
                      "fmod(at, STEPP)", 1)],
    # the kept caps are K5's 8 and K2's 6 blocks an SM
    **{f"k5_min{n}": _constant(_SHALLOW_CU, "DENSE_MIN_BLOCKS", n)
       for n in (5, 6, 7)},
    **{f"k2_min{n}": _constant(_DEEP_CU, "DEEP_MIN_BLOCKS", n)
       for n in (4, 5, 7)},
}


def make_variant(name, src=ROOT / "astroz_tpu_torch", edits=()):
    """Copy the package ``src`` with ``edits`` made and import it as
    ``astroz_variant_<name>``; raise unless each edit's text occurs as
    many times as it says."""
    pkg = f"astroz_variant_{name}"
    dst = VARIANT_DIR / name / pkg
    shutil.rmtree(dst.parent, ignore_errors=True)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("build",
                                                            "__pycache__"))
    for rel, old, new, count in edits:
        path = dst / rel
        text = path.read_text()
        if text.count(old) != count:
            raise SystemExit(f"variant {name}: {rel}: expected {count} of "
                             f"{old!r}, found {text.count(old)}")
        path.write_text(text.replace(old, new))
    spec = importlib.util.spec_from_file_location(
        pkg, dst / "__init__.py", submodule_search_locations=[str(dst)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[pkg] = module
    spec.loader.exec_module(module)
    return (importlib.import_module(f"{pkg}._build"),
            importlib.import_module(f"{pkg}.ops.cuda_sgp4"))


def ptxas_summary(report):
    """{"K1 v1 i5": (registers, spill stores, spill loads), ...} for the
    kernels' instantiations (v: velocities, i: Newton trips)."""
    out = {}
    for name, regs, st, ld in report:
        m = _SHALLOW.search(name)
        if m:
            out[f"{_MODES[int(m.group(3))]} v{m.group(1)} i{m.group(2)}"] = (
                regs, st, ld)
        m = _DENSE.search(name)
        if m:
            kernel = "K6" if m.group(3) == "1" else "K5"
            out[f"{kernel} v{m.group(1)} i{m.group(2)}"] = (regs, st, ld)
        if _SPINE.search(name):
            out["spine"] = (regs, st, ld)
        m = _DEEP.search(name)
        if m:
            out[f"K2 v{m.group(1)} i{m.group(2)}"] = (regs, st, ld)
    return out


def timed(chip_smoke, name, fn):
    """The time of a call of workload ``name``, ms (see the module's
    docstring)."""
    if name in _BACK_TO_BACK:
        return chip_smoke._cuda_ms(fn, K_REPS[name])
    return chip_smoke._graph_ms(fn, K_REPS[name])


def inputs(chip_smoke, default_ops):
    """The kernels' inputs at the main path's shapes, staged by this
    tree's package; K3 takes K2's planes from ``default_ops``."""
    from astroz_tpu_torch import build_catalog
    from astroz_tpu_torch.ops.fast import shallow_staging
    from astroz_tpu_torch.propagation import resonance_steps

    near = build_catalog(chip_smoke.near_earth_catalog_text(N_SATS))
    mixed = build_catalog(chip_smoke.mixed_catalog_text(N_SATS))
    t_time = torch.arange(N_TIMES, dtype=torch.float64, device="cuda")
    st = near.fast_staging
    mst, ds = mixed.fast_staging, mixed.fast_staging.deep
    steps = resonance_steps(mixed.epoch_min_jd + np.arange(N_TIMES) / 1440.0,
                            mixed.deep_epochs_jd)
    k2 = (t_time, ds.t_sat, ds.spine, ds.tail, ds.flags,
          mixed.resonance_tables(steps))
    k2_kw = dict(grav=mixed.grav, kepler_iters=mixed.deep_kepler_iters)
    iss = build_catalog(chip_smoke.GOLDEN_L1 + "\n" + chip_smoke.GOLDEN_L2)
    els = chip_smoke.single_sat_elements(iss)
    chunks = list(chip_smoke.single_sat_chunks(
        *chip_smoke.SINGLE_SAT_SCENARIOS[-1][1:]))
    chunk = chunks[0]
    # the deep slots in catalog order
    order = torch.as_tensor(np.argsort(mixed.deep_idx), device="cuda")
    k2c = (t_time, *(x[..., order].contiguous()
                     for x in (ds.t_sat, ds.spine, ds.tail, ds.flags,
                               k2[5])))
    return dict(
        k1=((t_time, st.t_sat, st.spine, st.tail, st.flags),
            dict(grav=near.grav, kepler_iters=near.kepler_iters)),
        k2=(k2, k2_kw), k2c=k2c, order=order, chunks=chunks, els=els,
        k3=((t_time, mst.t_sat, mst.spine, mst.tail, mst.flags, ds.slot,
             *default_ops.propagate_deep_sep(*k2, **k2_kw)),
            dict(grav=mixed.grav, kepler_iters=mixed.kepler_iters)),
        maps=ds.maps, chunk=chunk, staged=shallow_staging(els),
        grids=default_ops.spine_grids(els, chunk),
        dense_kw=dict(grav=iss.grav, kepler_iters=5))


def workloads(ops, x):
    """{kernel: fn()} through the wrappers of one variant's package."""
    k3_kw = dict(x["k3"][1])
    if "maps" in inspect.signature(ops.propagate_fast_sep_merge).parameters:
        k3_kw["maps"] = x["maps"]
    grids, tail, flags = x["grids"]
    kw = x["dense_kw"]
    if hasattr(ops, "_grids_tail"):
        def k6_time_major():
            return ops._grids_tail(grids, tail, flags, kw["grav"],
                                   kw["kepler_iters"], True,
                                   time_major=True)
    else:  # a tree whose K6 writes planes only
        def k6_time_major():
            return ops._time_major(*ops.propagate_fast_spine_grids(
                grids, tail, flags, **kw))
    return {
        "K1": lambda: ops.propagate_fast_sep(*x["k1"][0], **x["k1"][1]),
        "K3": lambda: ops.propagate_fast_sep_merge(*x["k3"][0], **k3_kw),
        "K5": lambda: ops.propagate_fast_dense(x["chunk"], *x["staged"],
                                               **x["dense_kw"]),
        "K6": lambda: ops.propagate_fast_spine_grids(grids, tail, flags,
                                                     **x["dense_kw"]),
        "K2": lambda: ops.propagate_deep_sep(*x["k2"][0], **x["k2"][1]),
        "K5tm": lambda: ops.propagate_fast_fused(x["els"], x["chunk"],
                                                 **x["dense_kw"]),
        "sweep": lambda: [ops.propagate_fast_fused(x["els"], c,
                                                   **x["dense_kw"])
                          for c in x["chunks"]][-1],
        "K2c": lambda: ops.propagate_deep_sep(*x["k2c"], **x["k2"][1]),
        "K6tm": k6_time_major,
        "spine": lambda: tuple(ops.spine_grids(x["els"], x["chunk"])[0]),
        "grids": lambda: ops.propagate_fast_grids(x["els"], x["chunk"], **kw),
        "grids_b2b": lambda: ops.propagate_fast_grids(x["els"], x["chunk"],
                                                      **kw),
    }


def loop_counts(build, chip_smoke):
    """{"K5": n, "K6": n, "K2": n}: the static SASS instructions of each
    kernel's row loop in one variant's library (None where not found)."""
    out = {}
    for k, names in _LOOPS.items():
        counts = [chip_smoke.row_loop_instructions(build.library_path(), n)
                  for n in names]
        out[k] = next((c for c in counts if c is not None), None)
    return out


def time_variants(args):
    if not torch.cuda.is_available():
        raise SystemExit("shallow_variants: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    pkgs = {v: make_variant(v, edits=VARIANTS[v]) for v in args.variants}
    if args.tree:
        pkgs["tree"] = make_variant(
            "tree", Path(args.tree).resolve() / "astroz_tpu_torch")
    t0 = time.perf_counter()

    def build(item):
        try:
            item[1][0].build()
        except RuntimeError as exc:  # nvcc's output
            return item[0], str(exc)
        return None

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        failed = [f for f in pool.map(build, pkgs.items()) if f]
    for v, text in failed:
        print(f"# {args.tag}: variant {v} did not build and is left out:\n"
              f"{text[-4000:]}")
        if v == "default":
            raise SystemExit("shallow_variants: the default build failed")
        del pkgs[v]
    print(f"# {args.tag}: built {len(pkgs)} variants in "
          f"{time.perf_counter() - t0:.1f} s")
    x = inputs(chip_smoke, pkgs["default"][1])
    fns = {v: {k: fn for k, fn in workloads(ops, x).items()
               if k in args.kernels}
           for v, (_, ops) in pkgs.items()}
    ref = {k: fn() for k, fn in fns["default"].items()}
    if "K2" in ref and "K2c" in ref:
        # the slot order moves K2's slots, and nothing else
        reordered = tuple(y[..., x["order"]] for y in ref["K2"])
        print(f"# {args.tag}: K2 on catalog-order slots bit-equal to K2's "
              "regime-order slots reordered: " + str(all(
                  torch.equal(a, b) for a, b in zip(ref["K2c"], reordered))))
        ref["K2c"] = reordered

    result = {"tag": args.tag, "card": smi, "tree": args.tree,
              "variants": {}}
    for v, (build, _) in pkgs.items():
        equal = {k: all(a is b is None or torch.equal(a, b)
                        for a, b in zip(fn(), ref[k]))
                 for k, fn in fns[v].items()}
        ptxas = ptxas_summary(build.ptxas_report())
        loops = loop_counts(build, chip_smoke)
        result["variants"][v] = {"edits": len(VARIANTS.get(v, ())),
                                 "equal_to_default": equal, "ptxas": ptxas,
                                 "row_loop_instructions": loops,
                                 "ms": {k: [] for k in fns[v]}}
        print(f"# {args.tag} {v}: bit-equal to the default build {equal}; "
              f"static SASS instructions of the row loops {loops}")
        for kname, (regs, st, ld) in sorted(ptxas.items()):
            print(f"# {args.tag} {v}: ptxas {kname}: {regs} registers, "
                  f"spill stores {st} B, spill loads {ld} B")
    for rnd in range(args.rounds):
        order = list(pkgs) if rnd % 2 == 0 else list(pkgs)[::-1]
        for v in order:
            for k, fn in fns[v].items():
                result["variants"][v]["ms"][k].append(
                    timed(chip_smoke, k, fn))
    for v, res in result["variants"].items():
        res["mean_ms"] = {k: sum(xs) / len(xs) for k, xs in res["ms"].items()}
        print(f"# {args.tag} {v} [{smi}]: " + "; ".join(
            f"{k} {res['mean_ms'][k]:.4f} ms ("
            + ", ".join(f"{t:.4f}" for t in xs) + ")"
            for k, xs in res["ms"].items()))
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / f"variants_{args.tag}.json", "w") as fh:
        json.dump(result, fh, indent=1)
    print(smi)
    print(json.dumps({k: {v: round(r["mean_ms"][k], 4)
                          for v, r in result["variants"].items()}
                      for k in args.kernels}))


def _ulps(a, b):
    """|a - b| in units of the f32 spacing at max(|a|, |b|)."""
    a, b = a.numpy(), b.numpy()
    scale = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return (np.abs(a.astype(np.float64) - b.astype(np.float64))
            / scale.astype(np.float64))


def fma_ulps():
    """Print how far the FMA-contracted sincos and angle_add lie from the
    plain versions."""
    from astroz_tpu_torch.ops import fastmath as fm
    from astroz_tpu_torch.ops.cuda_screen import fma_f32

    def fma(a, b, c):
        a, b, c = torch.broadcast_tensors(*(torch.as_tensor(
            t, dtype=torch.float32) for t in (a, b, c)))
        return fma_f32(a, b, c)

    def sincos(x):
        k = torch.round(x * fm.TWO_OVER_PI)
        y = fma(-k, fm.PIO2_HI, x)
        y = fma(-k, fm.PIO2_MED, y)
        y = fma(-k, fm.PIO2_LO, y)
        y2 = y * y
        sp = fma(y * y2, fma(y2, fma(y2, fm._S3, fm._S2), fm._S1), y)
        cp = fma(y2 * y2, fma(y2, fma(y2, fm._C3, fm._C2), fm._C1),
                 fma(-0.5, y2, 1.0))
        q = k.to(torch.int32) & 3
        swap = (q & 1) == 1
        s, c = torch.where(swap, cp, sp), torch.where(swap, sp, cp)
        return (torch.where((q & 2) == 2, -s, s),
                torch.where(((q + 1) & 2) == 2, -c, c))

    def angle_add(sa, ca, d):
        d2 = d * d
        sd = d * fma(-(d2 * (1.0 / 6.0)), fma(-0.05, d2, 1.0), 1.0)
        cd = fma(-(0.5 * d2), fma(-d2, 1.0 / 12.0, 1.0), 1.0)
        return fma(sa, cd, ca * sd), fma(ca, cd, -(sa * sd))

    # tests/test_torch_fastmath.py's inputs
    x = np.random.default_rng(0).uniform(-1e3, 1e3, 200000).astype(
        np.float32)
    ties = ((np.arange(-64, 65) + 0.5) * np.float32(np.pi / 2)).astype(
        np.float32)
    x = torch.from_numpy(np.concatenate(
        [x, ties, np.nextafter(ties, np.float32(np.inf)),
         np.asarray([0.0, -0.0, 1e-30, -1e-30], np.float32)]))
    rng = np.random.default_rng(1)
    a = rng.uniform(-np.pi, np.pi, 100000)
    sa, ca = (torch.from_numpy(f(a).astype(np.float32))
              for f in (np.sin, np.cos))
    d = torch.from_numpy(rng.uniform(-0.1, 0.1, 100000).astype(np.float32))
    for name, got, plain in (
            ("sincos", sincos(x), fm.sincos(x)),
            ("angle_add", angle_add(sa, ca, d), fm.angle_add(sa, ca, d))):
        for part, g, p in zip(("sin", "cos"), got, plain):
            u = _ulps(g, p)
            print(f"# {name} {part}, FMA-contracted vs plain: max "
                  f"{u.max():.0f} ulps, {np.mean(u > 1):.3e} of "
                  f"{u.size} outputs over 1 ulp, {np.mean(u > 0):.3e} "
                  "differ")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="+", default=["default"],
                    choices=list(VARIANTS))
    ap.add_argument("--tree", default=None)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--tag", default="change")
    ap.add_argument("--kernels", nargs="+", default=list(K_REPS),
                    choices=list(K_REPS))
    ap.add_argument("--fma-ulps", action="store_true")
    args = ap.parse_args()
    if args.fma_ulps:
        fma_ulps()
        return
    if "default" not in args.variants:
        args.variants.insert(0, "default")
    time_variants(args)


if __name__ == "__main__":
    main()
