"""Time variants of the port's near-earth kernel source on one NVIDIA GPU,
in turns; or measure on the CPU how FMA contraction moves the tail's
sincos and angle_add.

Run from the repository root::

    python3 shallow_variants.py [--variants NAME ...] [--tree DIR]
        [--rounds N] [--tag TAG] [--kernels NAME ...]
    python3 shallow_variants.py --fma-ulps
    python3 shallow_variants.py --f64-routes [--rounds N]
    python3 shallow_variants.py --torch-rounding
    python3 shallow_variants.py --epilogue-turns [--tree DIR]
        [--variants NAME ...] [--forms TEXT ...] [--rounds N] [--tag TAG]

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
  grid (the ISS x 1,024 lanes, 5 trips), into their time-major (T, S, 3)
  store (in a tree whose K5 and K6 also write (3, T, S) planes, their
  time-major branch); ``K5tm``: the same through
  ``propagate_fast_fused`` (the elements staged); ``K6tm``: K6 again,
  as ``propagate_fast_grids`` runs it; ``spine``: the f64 spine's six grids
  of the chunk (``spine_grids``: the spine kernel, or a tree's torch
  spine); ``grids``: the whole ``propagate_fast_grids`` call, replayed,
  and ``grids_b2b`` launched back to back; ``sweep``: the whole 1year_1s
  grid (8 chunks) through ``propagate_fast_fused``;
* K2: the mixed catalog's deep subset x 1,440, its slots grouped by
  regime (``propagation.deep_slots``); ``K2c``: the same with the slots
  in catalog order, so that warps mix the Lyddane branch with the
  other;
* the f64 kernel (``csrc/sgp4_f64.cu``), each package's own staging
  (``f64_staging``): ``f64``, DENSE in SDP4 mode on the mixed catalog x
  1,440 minutes since each epoch (as ``propagate(method="f64")`` forms
  them); ``f64s``, the same on ``chip_smoke.mixed_catalog_text(...,
  epoch_spread_days=7.0)``, epochs spread over +-7 days; ``f64scan``,
  the scan on the mixed catalog's first 240 epochs (``sgp4_f64_scan`` on
  the jd and fr rows, DENSE's launch; in a tree with a SCAN entry, that
  entry on the tsince grid); ``f64year``, the whole
  1year_1s grid (8 chunks) through DENSE in SGP4 mode, back to back;
  ``f64day``, the f64 kernel's part of ``propagate(method="f64")`` on
  the mixed catalog x a day of 1,440 epochs (the day in jd, the minutes
  in fr): DENSE on the rows (``sgp4_f64_dense_epochs``), or in a tree
  without it torch's tsince grid and DENSE on it; ``gen2``, DENSE in
  SGP4 mode on the rows of a 72-hour request of the Starlink Gen2 fleet
  (``portbench/configs/starlink-gen2-29988.json``, 29,988 lanes x 4,320
  one-minute epochs), back to back; ``gen2epi``, the epilogue kernel's
  f64 ``sat_major`` walk to ECEF (``tile_kernel<double>``, the GMST row
  included) on the default build's outputs of ``gen2``, back to back.

It prints, for each variant, ptxas' registers and spills of every
kernel instantiation, the static SASS instructions of the row loops of
K5, K6, K2 and the f64 row walk (``chip_smoke.sass_loop_instructions``),
the f64 row walk's blocks an SM in each mode, whether its outputs equal
the default build's bit for bit, each kernel's time in every round and
the mean, the card's name and power limit, and a JSON line with all of
it, also written to ``variants_<tag>.json`` in the output directory
beside this script. A kernel's
calls are replayed from a CUDA graph between CUDA events
(``chip_smoke._graph_ms``), so that the host's time a call does not count
where it is longer than the kernel's; the sweep and ``grids_b2b`` are
timed with CUDA events around their calls, host gaps included.
``--kernels`` times only the named workloads.

``--epilogue-turns`` times the epilogue kernel (``csrc/finalize.cu``) of
this checkout, of its variants and of ``--tree`` in every form on the
headline mixed sweeps, in turns, with the trips of the latitude
iteration and torch's like-for-like relayout copies
(:func:`epilogue_turns`); ``--forms`` keeps the forms whose names hold
one of its texts (e.g. ``sat_major``).

``--f64-routes`` times on the card three routes of the python-sgp4
API's f32 outputs to f64 numpy on the host (:func:`f64_routes`).

``--torch-rounding`` finds on the card how torch's CUDA kernels round the
reductions and products the integrator kernel (``csrc/integrate_f64.cu``)
repeats: ``torch.linalg.vector_norm`` over 3 and 4 values, ``torch.sum``
over 3 and ``torch.linalg.cross``, on strided, contiguous and 1-D inputs,
each against candidate formulas evaluated exactly on the host
(:func:`torch_rounding`); then the f32 chains the epilogue kernel
(``csrc/finalize.cu``) repeats (:func:`epilogue_rounding`).

It ends with :func:`host_pow_rounding`: how often the host's pow misrounds
the step-size law's ``err ** (-1/8)``.

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
import functools
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
          "sweep": 5, "K2c": 50, "f64": 10, "f64s": 10, "f64scan": 20,
          "f64year": 3, "f64day": 10, "gen2": 10, "gen2epi": 10}
#: workloads timed with CUDA events around calls launched back to back
_BACK_TO_BACK = ("sweep", "grids_b2b", "f64year", "gen2", "gen2epi")
#: mangled template arguments of the kernels: (velocities, trips, mode);
#: in older trees K5 is mode 2 of the shallow kernel or the dense one
#: without a source, K6 mode 3 of the shallow one
_SHALLOW = re.compile(r"sgp4_shallow_kernelILb(\d)ELi(\d+)ELi(\d)E")
_DENSE = re.compile(r"sgp4_dense_kernelILb(\d)ELi(\d+)E(?:Li(\d)E)?")
_DEEP = re.compile(r"sgp4_deep_kernelILb(\d)ELi(\d+)E")
_SPINE = re.compile(r"sgp4_spine_grids_kernel")
#: the f64 kernel's modes: the row walk (mode 0 SGP4, 1 SDP4) and, in
#: older trees, the one-point DENSE kernel, the SCAN walkers and ESCAPE
_F64 = re.compile(r"sgp4_f64_(\w+?)_kernelI(?:Li(\d)E)?Lb(\d)E")
#: the epilogue kernel's walks (``csrc/finalize.cu``) by their type
_EPILOGUE = re.compile(r"(flat|tile)_kernelI([df])E")
_MODES = ("K1", "K3", "K5", "K6")
#: K5, K6 and K2 with velocities at the timed trips, in this tree and
#: before (the first name a library has)
_LOOPS = {"K5": ("sgp4_dense_kernelILb1ELi5ELi0E",
                 "sgp4_dense_kernelILb1ELi5E",
                 "sgp4_shallow_kernelILb1ELi5ELi2E"),
          "K6": ("sgp4_dense_kernelILb1ELi5ELi1E",
                 "sgp4_shallow_kernelILb1ELi5ELi3E"),
          "K2": ("sgp4_deep_kernelILb1ELi6E",),
          "f64": ("sgp4_f64_walk_kernelILi1ELb1EE",
                  "sgp4_f64_dense_kernelILi1ELb1EE"),
          "f64year": ("sgp4_f64_walk_kernelILi0ELb1EE",
                      "sgp4_f64_dense_kernelILi0ELb1EE")}

_SHALLOW_CU = "csrc/sgp4_shallow.cu"
_DEEP_CU = "csrc/sgp4_deep.cu"
_COMMON = "csrc/sgp4_common.cuh"
_F64_CU = "csrc/sgp4_f64.cu"
_FINALIZE_CU = "csrc/finalize.cu"

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
      store_point_time_major<WANT_VEL>(o, (size_t)t_row * ns + t_sat, a.r,
                                       a.v, a.err);
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
        store_point_time_major<WANT_VEL>(o, (size_t)t_row * ns + t_sat,
                                         a.r, a.v, a.err);
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
    # the f64 row walk's register caps in SDP4 and SGP4 mode
    **{f"f64_min{n}": _constant(_F64_CU, "F64_MIN_BLOCKS", n)
       for n in (4, 5, 6)},
    **{f"f64_sgp4_min{n}": _constant(_F64_CU, "F64_SGP4_MIN_BLOCKS", n)
       for n in (5, 6, 7, 8)},
    # the weight of a row of a warp column with deep slots in the f64 row
    # walk's split (the kept 4)
    **{f"f64_w{n}": _constant(_F64_CU, "F64_DEEP_WEIGHT", n)
       for n in (1, 2, 3, 5, 8)},
    # the f64 row walk without the compiler fence at each row
    "f64_no_fence": [(_F64_CU, '      asm volatile("" ::: "memory");\n',
                      "", 1)],
    # the epilogue kernel (--epilogue-turns): sin and cos of lat by two
    # calls in place of one sincos; one point a thread in the flat walk
    # (and one time of a lane in f64's tile walk) in place of a 16-byte
    # vector's; f32's tile walk 4 times of a lane a thread (a 16-byte
    # vector's) in place of one; the tile walk with its f64 items one
    # field each (3 blocks an SM) or its f32 items whole tiles (2 blocks
    # an SM), f64 on 3 blocks an SM, f32 rows in 16-byte pieces, 3 stages,
    # the tiles walked lanes first
    "sin_cos_calls": [
        (_FINALIZE_CU, "{ sincosf(a, s, c); }",
         "{ *s = sinf(a); *c = cosf(a); }", 1),
        (_FINALIZE_CU, "{ sincos(a, s, c); }",
         "{ *s = sin(a); *c = cos(a); }", 1)],
    "one_point": [(_FINALIZE_CU, "constexpr int VEC = 16 / sizeof(T);",
                   "constexpr int VEC = 1;", 1)],
    "f32_tile_vec": [(_FINALIZE_CU,
                      "constexpr int TILE_TIMES = sizeof(T) == 4 ? 1 : VEC<T>;",
                      "constexpr int TILE_TIMES = VEC<T>;", 1)],
    "stages3": _constant(_FINALIZE_CU, "STAGES", 3),
    "f32_pieces16": [(_FINALIZE_CU,
                      "constexpr int PIECE = sizeof(T) == 4 ? 4 : 16;",
                      "constexpr int PIECE = 16;", 1)],
    "f64_fields": [
        (_FINALIZE_CU, "constexpr bool WHOLE_TILES = sizeof(T) == 8;",
         "constexpr bool WHOLE_TILES = false;", 1),
        (_FINALIZE_CU, "constexpr int TILE_BLOCKS = sizeof(T) == 4 ? 4 : 2;",
         "constexpr int TILE_BLOCKS = sizeof(T) == 4 ? 4 : 3;", 1)],
    "f32_whole": [
        (_FINALIZE_CU, "constexpr bool WHOLE_TILES = sizeof(T) == 8;",
         "constexpr bool WHOLE_TILES = true;", 1),
        (_FINALIZE_CU, "constexpr int TILE_BLOCKS = sizeof(T) == 4 ? 4 : 2;",
         "constexpr int TILE_BLOCKS = 2;", 1)],
    "f64_blocks3": [(_FINALIZE_CU,
                     "constexpr int TILE_BLOCKS = sizeof(T) == 4 ? 4 : 2;",
                     "constexpr int TILE_BLOCKS = sizeof(T) == 4 ? 4 : 3;",
                     1)],
    "lanes_first": [(_FINALIZE_CU, """\
  const long long tiles_t = (a.n_times + TILE_T - 1) / TILE_T;
  Tile g;
  g.t0 = (tile % tiles_t) * TILE_T;
  g.s0 = (tile / tiles_t) * TILE_S<T>;""", """\
  const long long tiles_s = (a.n_sats + TILE_S<T> - 1) / TILE_S<T>;
  Tile g;
  g.t0 = (tile / tiles_s) * TILE_T;
  g.s0 = (tile % tiles_s) * TILE_S<T>;""", 1)],
    # the f64 kernel's slots in catalog order, not grouped by regime
    "f64_catalog_order": [(
        "ops/cuda_sgp4.py",
        "    return torch.sort(key, stable=True).indices.to(I32)",
        "    return torch.arange(key.numel(), dtype=I32, device=key.device)",
        1)],
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
        m = _F64.search(name)
        if m:
            mode = "" if m.group(2) is None else f" m{m.group(2)}"
            out[f"f64 {m.group(1)}{mode} v{m.group(3)}"] = (regs, st, ld)
        m = _EPILOGUE.search(name)
        if m:
            kind = "f64" if m.group(2) == "d" else "f32"
            out[f"epilogue {m.group(1)} {kind}"] = (regs, st, ld)
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
    spread = build_catalog(chip_smoke.mixed_catalog_text(
        N_SATS, epoch_spread_days=7.0))
    jd = torch.as_tensor(chip_smoke.EPOCH_JD + np.arange(N_TIMES) / 1440.0,
                         device="cuda")

    def tsince(cat):
        return ((jd[:, None] - cat.els.epoch_jd[None, :]) * 1440.0)

    t_head = tsince(mixed)
    # a day's epochs as the benchmark's f64 sweeps send them: the day in
    # jd, the minutes in fr
    fr = torch.arange(N_TIMES, dtype=torch.float64, device="cuda") / 1440.0
    f64 = dict(mixed=mixed, spread=spread, t_head=t_head,
               t_spread=tsince(spread),
               t_scan=t_head[:chip_smoke.SCREEN_TIMES].contiguous(),
               jd_scan=jd[:chip_smoke.SCREEN_TIMES],
               fr_scan=torch.zeros(chip_smoke.SCREEN_TIMES,
                                   dtype=torch.float64, device="cuda"),
               jd=torch.full_like(fr, chip_smoke.EPOCH_JD + 1.0), fr=fr)
    return dict(
        f64=f64, gen2=functools.cache(lambda: gen2_inputs(default_ops)),
        k1=((t_time, st.t_sat, st.spine, st.tail, st.flags),
            dict(grav=near.grav, kepler_iters=near.kepler_iters)),
        k2=(k2, k2_kw), k2c=k2c, order=order, chunks=chunks, els=els,
        k3=((t_time, mst.t_sat, mst.spine, mst.tail, mst.flags, ds.slot,
             *default_ops.propagate_deep_sep(*k2, **k2_kw)),
            dict(grav=mixed.grav, kepler_iters=mixed.kepler_iters)),
        maps=ds.maps, chunk=chunk, staged=shallow_staging(els),
        grids=default_ops.spine_grids(els, chunk),
        dense_kw=dict(grav=iss.grav, kepler_iters=5))


def gen2_inputs(default_ops):
    """The Starlink Gen2 fleet's catalog (its benchmark configuration, one
    seed) and the rows of a 72-hour request from a day after its epoch;
    the default build's DENSE outputs on them and their GMST argument, the
    epilogue's input."""
    from astroz_tpu_torch import build_catalog
    from portbench.catalogs import walker_shells

    config = json.loads((ROOT / "portbench" / "configs"
                         / "starlink-gen2-29988.json").read_text())
    cat = build_catalog(walker_shells.text(config, 2**31 + 77))
    n = 4320
    fr = torch.arange(n, dtype=torch.float64, device="cuda") / 1440.0
    jd = torch.full_like(fr, config["epoch_jd"] + 1.0)
    rows = default_ops.sgp4_f64_dense_epochs(
        jd, fr, *default_ops.f64_staging(cat.els), grav=cat.grav,
        sdp4=False)
    return dict(cat=cat, jd=jd, fr=fr, rows=rows,
                jd_sum=(jd + fr)[:, None].contiguous())


def workloads(ops, x):
    """{kernel: fn()} through the wrappers of one variant's package."""
    f = x["f64"]
    fin = importlib.import_module(
        ops.__name__.replace("cuda_sgp4", "cuda_finalize"))

    @functools.cache
    def gen2_staged():
        # built at the first call, which precedes the timed rounds
        g = x["gen2"]()
        return g, ops.f64_staging(g["cat"].els)

    def gen2():
        g, st = gen2_staged()
        return ops.sgp4_f64_dense_epochs(g["jd"], g["fr"], *st,
                                         grav=g["cat"].grav, sdp4=False)

    def gen2epi():
        g = x["gen2"]()
        return fin.finalize(*g["rows"], g["jd_sum"], source="time_major",
                            output="ecef", layout="sat_major",
                            velocities=True)

    m_st = ops.f64_staging(f["mixed"].els, f["mixed"].deep)
    s_st = ops.f64_staging(f["spread"].els, f["spread"].deep)
    y_st = ops.f64_staging(x["els"])
    grav = f["mixed"].grav
    k3_kw = dict(x["k3"][1])
    if hasattr(ops, "sgp4_f64_dense_epochs"):
        def f64day():
            return ops.sgp4_f64_dense_epochs(f["jd"], f["fr"], *m_st,
                                             grav=grav, sdp4=True)
    else:  # a tree whose DENSE reads a tsince grid that torch writes
        def f64day():
            tsince = ((f["jd"][:, None] - f["mixed"].els.epoch_jd[None, :])
                      + f["fr"][:, None]) * 1440.0
            return ops.sgp4_f64_dense(tsince, *m_st, grav=grav, sdp4=True)
    if "maps" in inspect.signature(ops.propagate_fast_sep_merge).parameters:
        k3_kw["maps"] = x["maps"]
    grids, tail, flags = x["grids"]
    kw = x["dense_kw"]
    if hasattr(ops, "_grids_tail"):
        # a tree whose K5 and K6 also write planes: their time-major store
        def k5():
            return ops._dense(x["chunk"], *x["staged"], kw["grav"],
                              kw["kepler_iters"], True, time_major=True)

        def k6():
            return ops._grids_tail(grids, tail, flags, kw["grav"],
                                   kw["kepler_iters"], True,
                                   time_major=True)
    else:
        def k5():
            return ops.propagate_fast_dense(x["chunk"], *x["staged"], **kw)

        def k6():
            return ops.propagate_fast_spine_grids(grids, tail, flags, **kw)
    if "jd" in inspect.signature(ops.sgp4_f64_scan).parameters:
        def f64scan():
            return ops.sgp4_f64_scan(f["jd_scan"], f["fr_scan"], *m_st,
                                     grav=grav)
    else:  # a tree whose scan reads a tsince grid
        def f64scan():
            return ops.sgp4_f64_scan(f["t_scan"], *m_st, grav=grav)
    return {
        "K1": lambda: ops.propagate_fast_sep(*x["k1"][0], **x["k1"][1]),
        "K3": lambda: ops.propagate_fast_sep_merge(*x["k3"][0], **k3_kw),
        "K5": k5,
        "K6": k6,
        "K2": lambda: ops.propagate_deep_sep(*x["k2"][0], **x["k2"][1]),
        "K5tm": lambda: ops.propagate_fast_fused(x["els"], x["chunk"],
                                                 **x["dense_kw"]),
        "sweep": lambda: [ops.propagate_fast_fused(x["els"], c,
                                                   **x["dense_kw"])
                          for c in x["chunks"]][-1],
        "K2c": lambda: ops.propagate_deep_sep(*x["k2c"], **x["k2"][1]),
        "K6tm": k6,
        "spine": lambda: tuple(ops.spine_grids(x["els"], x["chunk"])[0]),
        "grids": lambda: ops.propagate_fast_grids(x["els"], x["chunk"], **kw),
        "grids_b2b": lambda: ops.propagate_fast_grids(x["els"], x["chunk"],
                                                      **kw),
        "f64": lambda: ops.sgp4_f64_dense(f["t_head"], *m_st, grav=grav,
                                          sdp4=True),
        "f64s": lambda: ops.sgp4_f64_dense(f["t_spread"], *s_st, grav=grav,
                                           sdp4=True),
        "f64scan": f64scan,
        "f64year": lambda: [ops.sgp4_f64_dense(c, *y_st, grav=grav,
                                               sdp4=False)
                            for c in x["chunks"]][-1],
        "f64day": f64day,
        "gen2": gen2,
        "gen2epi": gen2epi,
    }


def loop_counts(build, chip_smoke):
    """{"K5": n, "K6": n, "K2": n, "f64": n, "f64year": n}: the static
    SASS instructions of each kernel's row loop in one variant's library,
    from one ``cuobjdump -sass`` of it
    (:func:`chip_smoke.sass_loop_instructions`; the f64 row walk's loop
    over a run's rows, ``inner``; None where not found)."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    dump = subprocess.run([str(tool), "-sass", str(build.library_path())],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout
    out = {}
    for k, names in _LOOPS.items():
        counts = [chip_smoke.sass_loop_instructions(
            dump, n, inner=k.startswith("f64")) for n in names]
        out[k] = next((c for c in counts if c is not None), None)
    return out


def f64_blocks_per_sm(ops):
    """{"f64 m<mode> v<velocities>": blocks an SM}: the occupancy of each
    instantiation of the f64 row walk in one variant's library (mode 1
    SDP4, 0 SGP4; ``cuda_sgp4.launch_grid``)."""
    return {f"f64 m{m} v{v}": ops.launch_grid(
        "sgp4_f64_dense", N_TIMES, N_SATS, want_vel=bool(v),
        sdp4=bool(m))["per_sm"] for m in (1, 0) for v in (1, 0)}


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
        per_sm = f64_blocks_per_sm(pkgs[v][1])
        result["variants"][v] = {"edits": len(VARIANTS.get(v, ())),
                                 "equal_to_default": equal, "ptxas": ptxas,
                                 "row_loop_instructions": loops,
                                 "f64_blocks_per_sm": per_sm,
                                 "ms": {k: [] for k in fns[v]}}
        print(f"# {args.tag} {v}: bit-equal to the default build {equal}; "
              f"static SASS instructions of the row loops {loops}; the f64 "
              f"row walk's blocks an SM {per_sm}")
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


def f64_routes(rounds):
    """Time three routes of the python-sgp4 API's largest outputs, f32 r
    and v of a 13,478 x 1,440 ``sat_major`` propagate on the card, to f64
    numpy on the host, round after round, the order reversed on every
    other round: the API's (``api._host_f64``: a copy into page-locked
    memory, the cast on the host), a copy into pageable memory then the
    cast on the host, and the cast on the card then a copy into pageable
    memory. The values are random (seed 0): a copy's time does not
    depend on them."""
    if not torch.cuda.is_available():
        raise SystemExit("shallow_variants: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from astroz_tpu_torch.api import _host_f64

    smi = chip_smoke.phase0_card()
    shape = (N_SATS, N_TIMES, 3)
    gen = torch.Generator(device="cuda").manual_seed(0)
    r, v = (torch.randn(shape, generator=gen, device="cuda") * 7000.0
            for _ in range(2))

    def pinned():
        for x in (r, v):
            _host_f64(x)

    def pageable():
        for x in (r, v):
            torch.from_numpy(np.empty(shape)).copy_(x)

    def card_cast():
        for x in (r, v):
            torch.from_numpy(np.empty(shape)).copy_(x.double())

    routes = {"page-locked, host cast (the API's)": pinned,
              "pageable, host cast": pageable,
              "card cast, pageable": card_cast}
    ms = {name: [] for name in routes}
    for rnd in range(rounds):
        for name in (list(routes) if rnd % 2 == 0 else list(routes)[::-1]):
            ms[name].append(chip_smoke._wall_ms(routes[name], 3)[0])
    print(f"# f64 routes [{smi}]: r and v ({shape}, f32 on the card) to "
          f"f64 numpy, ms a pair (host clock, mean of 3 synchronized calls "
          f"a round, {rounds} rounds in turns): " + "; ".join(
              f"{name} {np.mean(t):.2f} (" + ", ".join(f"{x:.2f}" for x in t)
              + ")" for name, t in ms.items()))
    print(smi)


def _exact_formulas():
    """Candidate roundings of torch's CUDA reductions and products, each
    evaluated exactly (``fractions.Fraction``) and rounded once where the
    formula says: R is one rounding to f64, F a fused multiply-add."""
    import math
    from fractions import Fraction as Q

    def R(x):
        return float(x)

    def sq(x):
        return Q(x) * Q(x)

    def F(a, b, c):
        return R(Q(a) * Q(b) + Q(c))

    def rs(x):  # a rounded square
        return R(sq(x))

    norm3 = {
        "(0+2)+1": lambda a, b, c: math.sqrt(R(Q(R(Q(rs(a)) + Q(rs(c))))
                                                + Q(rs(b)))),
        "(0+1)+2": lambda a, b, c: math.sqrt(R(Q(R(Q(rs(a)) + Q(rs(b))))
                                                + Q(rs(c)))),
        "fma 0,1,2": lambda a, b, c: math.sqrt(F(c, c, F(b, b, rs(a)))),
        "fma 0,2 then +1": lambda a, b, c: math.sqrt(R(Q(F(c, c, rs(a)))
                                                        + Q(rs(b)))),
        "fma 0,2,1": lambda a, b, c: math.sqrt(F(b, b, F(c, c, rs(a)))),
    }
    norm4 = {
        "(0+2)+(1+3)": lambda a, b, c, d: math.sqrt(R(
            Q(R(Q(rs(a)) + Q(rs(c)))) + Q(R(Q(rs(b)) + Q(rs(d)))))),
        "(0+1)+(2+3)": lambda a, b, c, d: math.sqrt(R(
            Q(R(Q(rs(a)) + Q(rs(b)))) + Q(R(Q(rs(c)) + Q(rs(d)))))),
        "((0+1)+2)+3": lambda a, b, c, d: math.sqrt(R(Q(R(Q(R(
            Q(rs(a)) + Q(rs(b)))) + Q(rs(c)))) + Q(rs(d)))),
        "fma 0,1,2,3": lambda a, b, c, d: math.sqrt(
            F(d, d, F(c, c, F(b, b, rs(a))))),
    }
    sum3 = {
        "(0+2)+1": lambda a, b, c: R(Q(R(Q(a) + Q(c))) + Q(b)),
        "(0+1)+2": lambda a, b, c: R(Q(R(Q(a) + Q(b))) + Q(c)),
    }
    # one component a*b - c*d of a cross product
    cross = {
        "fma(a,b,-(c*d))": lambda a, b, c, d: F(a, b, -R(Q(c) * Q(d))),
        "fma(-c,d,a*b)": lambda a, b, c, d: F(-c, d, R(Q(a) * Q(b))),
        "a*b - c*d": lambda a, b, c, d: R(Q(R(Q(a) * Q(b)))
                                          - Q(R(Q(c) * Q(d)))),
    }
    return norm3, norm4, sum3, cross


def torch_rounding(n=4000):
    """``--torch-rounding`` (needs a card): for each case, the share of
    ``n`` random inputs (magnitudes 1e-3 to 1e4, both signs) on which
    each candidate of :func:`_exact_formulas` gives torch's bits on the
    card."""
    if not torch.cuda.is_available():
        raise SystemExit("shallow_variants: no CUDA device")
    norm3, norm4, sum3, cross = _exact_formulas()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, 8)) * 10.0 ** rng.uniform(-3.0, 4.0, (n, 8))
    dev = torch.device("cuda")
    t = torch.as_tensor(x, device=dev)
    one = min(n, 500)  # 1-D cases, one launch a row

    def vn(a):
        return torch.linalg.vector_norm(a, dim=-1, keepdim=True)

    def rows_1d(fn, width):
        return np.stack([fn(t[i, :width]).cpu().numpy() for i in range(one)])

    cases = [
        ("vector_norm, 3 of a (N, 6) row", vn(t[:, :6][..., :3]), norm3, 3),
        ("vector_norm, 3 of a (N, 6) row, the second half",
         vn(t[:, :6][..., 3:]), norm3, 3, 3),
        ("vector_norm, (N, 3) contiguous", vn(t[:, :3].contiguous()), norm3,
         3),
        ("vector_norm, (3,)", rows_1d(vn, 3), norm3, 3),
        ("vector_norm, (N, 4) contiguous", vn(t[:, :4].contiguous()), norm4,
         4),
        ("vector_norm, (4,)", rows_1d(vn, 4), norm4, 4),
        ("sum, (N, 3) contiguous",
         torch.sum(t[:, :3].contiguous(), dim=-1, keepdim=True), sum3, 3),
    ]
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    for case in cases:
        label, got, forms, width = case[:4]
        off = case[4] if len(case) > 4 else 0
        got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got
                         ).reshape(-1)
        rows = x[:len(got), off:off + width]
        share = {name: np.mean([f(*map(float, r)) == g
                                for r, g in zip(rows, got)])
                 for name, f in forms.items()}
        print(f"# {label}: " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in share.items()))
    a, b = t[:, :3].contiguous(), t[:, 3:6].contiguous()
    for label, got in (("cross, (N, 3)", torch.linalg.cross(a, b, dim=-1)),
                       ("cross, (3,)", torch.stack([torch.linalg.cross(
                           a[i], b[i], dim=-1) for i in range(one)]))):
        got = got.cpu().numpy()
        xa, xb = x[:len(got), :3], x[:len(got), 3:6]
        share = {}
        for name, f in cross.items():
            hit = 0
            for ra, rb, g in zip(xa, xb, got):
                want = (f(ra[1], rb[2], ra[2], rb[1]),
                        f(ra[2], rb[0], ra[0], rb[2]),
                        f(ra[0], rb[1], ra[1], rb[0]))
                hit += all(w == v for w, v in zip(want, g))
            share[name] = hit / len(got)
        print(f"# {label}: " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in share.items()))
    epilogue_rounding()
    host_pow_rounding()


def epilogue_rounding(n=4000):
    """The f32 roundings the epilogue kernel (``csrc/finalize.cu``) repeats:
    torch's result on the card of each chain of ``ops/cuda_finalize.py``'s
    rotation and ``frames.ecef_to_geodetic_xyz`` against candidates
    evaluated on the host (numpy f32, each op correctly rounded; a fused
    multiply-add through ``cuda_screen.fma_f32``), the share of ``n``
    random inputs on which each gives torch's bits."""
    from astroz_tpu_torch.constants import RAD2DEG, WGS84, WGS84_ECC_SQ
    from astroz_tpu_torch.ops.cuda_screen import fma_f32

    f32 = np.float32
    rng = np.random.default_rng(6)
    x, y = (rng.uniform(-8000.0, 8000.0, n).astype(f32) for _ in range(2))
    ang = rng.uniform(-1.6, 1.6, n).astype(f32)
    sg, cg = np.sin(ang), np.cos(ang)
    nn = rng.uniform(6378.0, 6400.0, n).astype(f32)
    alt = rng.uniform(-100.0, 30000.0, n).astype(f32)
    w = rng.uniform(0.99, 1.0, n).astype(f32)
    e2, a, one_m_e2 = f32(WGS84_ECC_SQ), f32(WGS84.radius_earth_km), \
        f32(1.0 - WGS84_ECC_SQ)

    def dev(v):
        return torch.as_tensor(v, device="cuda")

    def fma(p, q, r):
        return fma_f32(*(torch.as_tensor(np.asarray(v, f32)).expand(n)
                         for v in (p, q, r))).numpy()

    a_dev = torch.tensor(WGS84.radius_earth_km, dtype=torch.float32,
                         device="cuda")
    cases = [
        ("cg * x + sg * y", dev(cg) * dev(x) + dev(sg) * dev(y),
         {"three roundings": cg * x + sg * y,
          "fma(cg, x, sg * y)": fma(cg, x, sg * y)}),
        ("1.0 - e2 * s * s", 1.0 - WGS84_ECC_SQ * dev(sg) * dev(sg),
         {"op by op, f32(e2)": f32(1.0) - (e2 * sg) * sg,
          "fma(-(e2 * s), s, 1)": fma(-(e2 * sg), sg, f32(1.0))}),
        ("a / sqrt(w), a 0-dim", a_dev / torch.sqrt(dev(w)),
         {"true divide": a / np.sqrt(w),
          "reciprocal, multiply": a * (f32(1.0) / np.sqrt(w))}),
        ("e2 * n / (n + alt)", WGS84_ECC_SQ * dev(nn) / (dev(nn) + dev(alt)),
         {"(f32(e2) * n) / (n + alt)": (e2 * nn) / (nn + alt)}),
        ("p * (1.0 - e2)", dev(x) * (1.0 - WGS84_ECC_SQ),
         {"p * f32(1 - e2)": x * one_m_e2}),
        ("lat * RAD2DEG", dev(ang) * RAD2DEG,
         {"lat * f32(RAD2DEG)": ang * f32(RAD2DEG),
          "f64 product, rounded": (ang.astype(np.float64)
                                   * RAD2DEG).astype(f32)}),
    ]
    for label, got, forms in cases:
        got = got.cpu().numpy()
        print(f"# epilogue, {label}: " + ", ".join(
            f"{k} {np.mean(np.asarray(v, f32) == got):.4f}"
            for k, v in forms.items()))


def host_pow_rounding(n=50000):
    """The host's ``x ** (-1 / 8)`` (the C library's pow, as
    ``dp87_adaptive``'s plain loop takes it) against the correctly rounded
    value (a 60-digit ``decimal`` power, then one rounding) on ``n`` inputs
    spread log-uniformly over [1e-16, 1e3], the range of its error norms."""
    import decimal
    import platform

    decimal.getcontext().prec = 60
    xs = 10.0 ** np.random.default_rng(8).uniform(-16.0, 3.0, n)
    e = decimal.Decimal(-0.125)
    off = sum(float(decimal.Decimal(float(x)) ** e) != float(x) ** -0.125
              for x in xs)
    print(f"# host pow ({platform.libc_ver()}): x ** (-1/8) differs from "
          f"the correctly rounded value on {off} of {n} inputs")


# ---------------------------------------------------------------------------
# --integrate-probes: where the integrator kernel's serial modes spend their
# cycles
# ---------------------------------------------------------------------------

_INTEGRATE_CU = "csrc/integrate_f64.cu"

#: dependent-latency microbenchmarks on one thread, and the divide
#: corrections against __ddiv_rn; built with --fmad=true, as the integrator
#: kernel is
_LATENCY_CU = r"""
#include <cstdint>

namespace {

// Markstein's correction of q0 = a * y, y = RN(1/b): RN(a / b) when q0 is
// within an ulp of a / b
__device__ __forceinline__ double div1(double a, double b, double y) {
  const double q0 = __dmul_rn(a, y);
  return __fma_rn(__fma_rn(-q0, b, a), y, q0);
}
// the same correction twice
__device__ __forceinline__ double div2(double a, double b, double y) {
  const double q1 = div1(a, b, y);
  return __fma_rn(__fma_rn(-q1, b, a), y, q1);
}

enum { ADD, MUL, FMA, RESET, DIV, RCP, SQRT, POW5, EXP, DIV1, DIV2 };

template <int OP>
__device__ __forceinline__ double op(double a, double x, double b,
                                     double yb) {
  if (OP == ADD) return __dadd_rn(a, b);
  if (OP == MUL) return __dmul_rn(a, b);
  if (OP == FMA) return __fma_rn(a, b, x);
  const double t = __fma_rn(a, 0.0, x);  // x again, once a is known
  if (OP == RESET) return t;
  if (OP == DIV) return __ddiv_rn(t, b);
  if (OP == RCP) return __drcp_rn(t);
  if (OP == SQRT) return __dsqrt_rn(t);
  if (OP == POW5) return pow(t, 5.0);
  if (OP == EXP) return exp(t);
  if (OP == DIV1) return div1(t, b, yb);
  return div2(t, b, yb);
}

template <int OP>
__global__ void __launch_bounds__(1)
    latency_kernel(double x, double b, long long n, double* out,
                   long long* cycles) {
  double a = x;
  const double yb = __drcp_rn(b);
  const long long c0 = clock64();
#pragma unroll 1
  for (long long i = 0; i < n; ++i) {
#pragma unroll
    for (int u = 0; u < 16; ++u) a = op<OP>(a, x, b, yb);
  }
  const long long c1 = clock64();
  out[0] = a;
  cycles[0] = c1 - c0;
}

__device__ __forceinline__ uint64_t mix(uint64_t z) {
  z += 0x9e3779b97f4a7c15ull;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}
// a double in [1, 2) with the 52 low bits of r as its mantissa
__device__ __forceinline__ double unit(uint64_t r) {
  return __longlong_as_double(
      (long long)((r & 0xfffffffffffffull) | 0x3ff0000000000000ull));
}

// pair k of a set: 0 random significands, signs and exponents in
// [-40, 40]; 1 a / b just below a power of two (b in [1.5, 2), a = b (1 -
// d), d in [2^-52, 2^-8]), where RN(a RN(1/b)) is furthest from a / b; 2
// a / b near a midpoint (a = RN((q + 2^-53) b)); sets 1 and 2 scaled by
// powers of two in [-30, 30]
__device__ __forceinline__ void pair(int set, uint64_t seed, long long k,
                                     double& a, double& b) {
  const uint64_t r1 = mix(seed ^ (2 * k)), r2 = mix(seed ^ (2 * k + 1));
  const uint64_t r3 = mix(r1 ^ r2);
  const int e1 = (int)(r3 % 61) - 30, e2 = (int)((r3 >> 16) % 61) - 30;
  if (set == 0) {
    a = ldexp(unit(r1), (int)(r3 % 81) - 40) * ((r3 >> 40) & 1 ? -1 : 1);
    b = ldexp(unit(r2), (int)((r3 >> 8) % 81) - 40) *
        ((r3 >> 41) & 1 ? -1 : 1);
    return;
  }
  if (set == 1) {
    b = 1.5 + 0.5 * (unit(r2) - 1.0);
    const double d = ldexp(unit(r1), -52 + (int)((r3 >> 24) % 45));
    a = __dmul_rn(b, __dsub_rn(1.0, d));
  } else {
    const double q = unit(r1);
    b = unit(r2);
    a = __fma_rn(q, b, ldexp(b, -53));
  }
  a = ldexp(a, e1);
  b = ldexp(b, e2);
}

__global__ void divide_probe_kernel(int set, long long n, uint64_t seed,
                                    unsigned long long* miss,
                                    double* example) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       k < n; k += stride) {
    double a, b;
    pair(set, seed, k, a, b);
    const double want = __ddiv_rn(a, b), y = __drcp_rn(b);
    const double got[2] = {div1(a, b, y), div2(a, b, y)};
    for (int v = 0; v < 2; ++v) {
      if (__double_as_longlong(got[v]) != __double_as_longlong(want)) {
        if (atomicAdd(&miss[v], 1ull) == 0) {
          example[2 * v] = a;
          example[2 * v + 1] = b;
        }
      }
    }
  }
}

}  // namespace

extern "C" int astroz_latency(int op, double x, double b, long long n,
                              double* out, long long* cycles) {
  switch (op) {
#define CASE(k) \
  case k:       \
    latency_kernel<k><<<1, 1>>>(x, b, n, out, cycles); \
    break;
    CASE(ADD) CASE(MUL) CASE(FMA) CASE(RESET) CASE(DIV) CASE(RCP)
    CASE(SQRT) CASE(POW5) CASE(EXP) CASE(DIV1) CASE(DIV2)
#undef CASE
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

extern "C" int astroz_divide_probe(int set, long long n,
                                   unsigned long long seed,
                                   unsigned long long* miss,
                                   double* example) {
  divide_probe_kernel<<<264, 256>>>(set, n, seed, miss, example);
  return (int)cudaGetLastError();
}
"""
#: the microbenchmarks' ops in the order of the source's enum, with the
#: divisor ``b`` each takes; those from RESET on run after a reset (an FMA
#: by 0), whose latency is taken off theirs
LATENCY_OPS = (("DADD", 1.0), ("DMUL", 1.0), ("DFMA", 1.0),
               ("reset", 3.0), ("__ddiv_rn", 3.0), ("__drcp_rn", 3.0),
               ("__dsqrt_rn", 3.0), ("pow(x, 5.0)", 3.0), ("exp", 3.0),
               ("one correction", 3.0), ("two corrections", 3.0))
DIVIDE_SETS = ("random", "a/b just below a power of two",
               "a/b near a midpoint")

#: clock64() probes in the integrator kernel as it stood before its
#: one-launch trajectory mode: a region's cycles accumulate in shared
#: memory between two probes, and are copied out when the kernel ends.
#: Regions: 0 a DP8(7) stage's sum, 3 deriv's |r| (norm3's sqrt), 4
#: TwoBody (three divides by |r|^3), 7 J2's z / |r|, 5 J2's pow(|r|, 5)
#: and its reciprocal, 6 the rest of J2, 1 the terms' sum, 2 the stage's
#: store and its 8th and 7th order sums, 8 the error norm, 9 the
#: step-size law and the accept, 10 the loop's head and the clamp;
#: ATTITUDE: 11 the four stages, 12 the weighted sum, 13 the
#: normalisation; 15 back-to-back probes (a probe's own cost)
_PROBE_HEAD = r"""#include <cstdint>
__shared__ long long PROBE_ACC[16];
__shared__ long long PROBE_LAST;
__device__ long long PROBE_OUT[16];
#define PROBE(k)                              \
  do {                                        \
    const long long _c = clock64();           \
    PROBE_ACC[k] += _c - PROBE_LAST;          \
    PROBE_LAST = _c;                          \
  } while (0)
#define PROBE_START()                                  \
  do {                                                 \
    for (int _k = 0; _k < 16; ++_k) PROBE_ACC[_k] = 0; \
    PROBE_LAST = clock64();                            \
    _Pragma("unroll") for (int _k = 0; _k < 64; ++_k) PROBE(15); \
  } while (0)
#define PROBE_END() \
  for (int _k = 0; _k < 16; ++_k) PROBE_OUT[_k] = PROBE_ACC[_k]
"""
INTEGRATE_PROBES = [
    (_INTEGRATE_CU, "#include <cstdint>\n", _PROBE_HEAD, 1),
    (_INTEGRATE_CU, "  const D rn = norm3(r[0], r[1], r[2]);\n  D a[3];\n",
     "  const D rn = norm3(r[0], r[1], r[2]);\n  PROBE(3);\n  D a[3];\n", 1),
    (_INTEGRATE_CU, "      for (int i = 0; i < 3; ++i) a[i] = (r[i] * "
     "D(p[0])) / c;\n      break;", "      for (int i = 0; i < 3; ++i) "
     "a[i] = (r[i] * D(p[0])) / c;\n      PROBE(4);\n      break;", 1),
    (_INTEGRATE_CU, "      const D z2 = zr * zr;\n      const D k = recip("
     "pow(rn, 5.0)) * D(p[0]);\n", "      const D z2 = zr * zr;\n      "
     "PROBE(7);\n      const D k = recip(pow(rn, 5.0)) * D(p[0]);\n      "
     "PROBE(5);\n", 1),
    (_INTEGRATE_CU, "      const D zt = D(3.0) - D(5.0) * z2;\n      a[0] = "
     "k * (r[0] * xy);\n      a[1] = k * (r[1] * xy);\n      a[2] = k * "
     "(r[2] * zt);\n      break;", "      const D zt = D(3.0) - D(5.0) * "
     "z2;\n      a[0] = k * (r[0] * xy);\n      a[1] = k * (r[1] * xy);\n"
     "      a[2] = k * (r[2] * zt);\n      PROBE(6);\n      break;", 1),
    (_INTEGRATE_CU, "    deriv(m, s, k);\n#pragma unroll\n    for (int c = 0; "
     "c < 6; ++c) ks[i][c][me] = k[c].v;", "    PROBE(0);\n    deriv(m, s, "
     "k);\n    PROBE(1);\n#pragma unroll\n    for (int c = 0; c < 6; ++c) "
     "ks[i][c][me] = k[c].v;", 1),
    (_INTEGRATE_CU, "y7[c] = y7[c] + hb * k[c];\n    }\n  }\n}",
     "y7[c] = y7[c] + hb * k[c];\n    }\n    PROBE(2);\n  }\n}", 1),
    (_INTEGRATE_CU, "  stage_model(m, model);\n  D y[6];\n",
     "  stage_model(m, model);\n  PROBE_START();\n  D y[6];\n", 1),
    (_INTEGRATE_CU, "    dp87_step<1, true>(m, ks, y, hs, y8, y7);",
     "    PROBE(10);\n    dp87_step<1, true>(m, ks, y, hs, y8, y7);", 1),
    (_INTEGRATE_CU, "      err_norm = c == 0 ? e : maximum(err_norm, e);\n"
     "    }\n", "      err_norm = c == 0 ? e : maximum(err_norm, e);\n    }"
     "\n    PROBE(8);\n", 1),
    (_INTEGRATE_CU, "    ++steps;\n  }\n", "    PROBE(9);\n    ++steps;\n  }"
     "\n  PROBE_END();\n", 1),
    (_INTEGRATE_CU, "  const D h = dt, half = D(0.5) * h, sixth = h / D(6.0);"
     "\n", "  const D h = dt, half = D(0.5) * h, sixth = h / D(6.0);\n  "
     "PROBE_START();\n", 1),
    (_INTEGRATE_CU, "#pragma unroll\n    for (int c = 0; c < 4; ++c) q[c] = "
     "q[c] + sixth * aq[c];", "    PROBE(11);\n#pragma unroll\n    for (int "
     "c = 0; c < 4; ++c) q[c] = q[c] + sixth * aq[c];", 1),
    (_INTEGRATE_CU, "    const D n4 = norm4(q[0], q[1], q[2], q[3]);",
     "    PROBE(12);\n    const D n4 = norm4(q[0], q[1], q[2], q[3]);", 1),
    (_INTEGRATE_CU, "for (int c = 0; c < 4; ++c) q[c] = q[c] / n4;\n  }\n",
     "for (int c = 0; c < 4; ++c) q[c] = q[c] / n4;\n    PROBE(13);\n  }\n"
     "  PROBE_END();\n", 1),
    (_INTEGRATE_CU, "n_bodies, n_steps, dt);\n  }\n  return static_cast<int>("
     "cudaGetLastError());\n}\n", "n_bodies, n_steps, dt);\n  }\n  return "
     "static_cast<int>(cudaGetLastError());\n}\n\nextern \"C\" int "
     "astroz_probe_read(long long* out) {\n  return static_cast<int>("
     "cudaMemcpyFromSymbol(out, PROBE_OUT, sizeof(PROBE_OUT)));\n}\n", 1)]
#: the same regions in the integrator kernel with the one-launch
#: trajectory mode (``dp87_adaptive`` one outer step of it): DP8(7)'s
#: stages written out, the derivative of a fixed signature (TwoBody + J2)
#: inlined, TwoBody's divides through one reciprocal; ATTITUDE: 0-3 its
#: four stages, 4 the weighted sum, 5 the normalisation and the
#: fallback's test. INTEGRATE_PROBES stays for the kernel before it, whose
#: regions PERF.md's step 0 gives (``--tree`` a checkout of it)
INTEGRATE_PROBES_V2 = [
    INTEGRATE_PROBES[0],
    (_INTEGRATE_CU, "    const D rn = norm3(r[0], r[1], r[2]);\n    D a[3];\n"
     "    kind_accel<sig_kind(SIG, 0)>", "    const D rn = norm3(r[0], r[1], "
     "r[2]);\n    PROBE(3);\n    D a[3];\n    kind_accel<sig_kind(SIG, 0)>",
     1),
    (_INTEGRATE_CU, "    divide3(n, c, a);\n  } else if constexpr (KIND == J2)",
     "    divide3(n, c, a);\n    PROBE(4);\n  } else if constexpr (KIND == "
     "J2)", 1),
    (_INTEGRATE_CU, "    const D z2 = zr * zr;\n    const D k = recip(pow(rn, "
     "5.0)) * D(p[0]);\n", "    const D z2 = zr * zr;\n    PROBE(7);\n    "
     "const D k = recip(pow(rn, 5.0)) * D(p[0]);\n    PROBE(5);\n", 1),
    (_INTEGRATE_CU, "    a[2] = k * (r[2] * zt);\n  } else if constexpr (KIND "
     "== J3)", "    a[2] = k * (r[2] * zt);\n    PROBE(6);\n  } else if "
     "constexpr (KIND == J3)", 1),
    (_INTEGRATE_CU, "    sig_terms<SIG, 1>(m, r, v, rn, a);\n",
     "    sig_terms<SIG, 1>(m, r, v, rn, a);\n    PROBE(1);\n", 1),
    (_INTEGRATE_CU, "    stage_sum<I, 0>(s, h, ks);\n    deriv_sig<SIG>(m, s, "
     "k);\n", "    stage_sum<I, 0>(s, h, ks);\n    PROBE(0);\n    deriv_sig"
     "<SIG>(m, s, k);\n", 1),
    (_INTEGRATE_CU, "    dp87_stages<I + 1, SIG, EMBEDDED>(m, y, h, ks, y8, "
     "y7);", "    PROBE(2);\n    dp87_stages<I + 1, SIG, EMBEDDED>(m, y, h, "
     "ks, y8, y7);", 1),
    (_INTEGRATE_CU, "    dp87_step<SIG, true>(m, ks, y, hs, y8, y7);",
     "    PROBE(10);\n    dp87_step<SIG, true>(m, ks, y, hs, y8, y7);", 1),
    (_INTEGRATE_CU, "      err_norm = i == 0 ? e : maximum(err_norm, e);\n"
     "    }\n", "      err_norm = i == 0 ? e : maximum(err_norm, e);\n    }"
     "\n    PROBE(8);\n", 1),
    (_INTEGRATE_CU, "    ++steps;\n  }\n  return steps;",
     "    PROBE(9);\n    ++steps;\n  }\n  return steps;", 1),
    (_INTEGRATE_CU, "    states[c] = y[c].v;\n  }\n  const double nan",
     "    states[c] = y[c].v;\n  }\n  PROBE_START();\n  const double nan",
     1),
    (_INTEGRATE_CU, "  info[3] = h_last.v;\n", "  info[3] = h_last.v;\n"
     "  PROBE_END();\n", 1),
    INTEGRATE_PROBES[11],
    *[(_INTEGRATE_CU, f"  attitude_stage<{k}, FAST>(q, w, sq, sw, aq, aw, I, "
       f"y, T, half, h, ok);\n", f"  attitude_stage<{k}, FAST>(q, w, sq, sw, "
       f"aq, aw, I, y, T, half, h, ok);\n  PROBE({k});\n", 1)
      for k in range(4)],
    (_INTEGRATE_CU, "  const D n4 = norm4(qn[0], qn[1], qn[2], qn[3]);",
     "  PROBE(4);\n  const D n4 = norm4(qn[0], qn[1], qn[2], qn[3]);", 1),
    (_INTEGRATE_CU, "    for (int c = 0; c < 3; ++c) w[c] = wn[c];\n  }\n",
     "    for (int c = 0; c < 3; ++c) w[c] = wn[c];\n    PROBE(5);\n  }\n"
     "  PROBE_END();\n", 1),
    INTEGRATE_PROBES[-1]]
#: the ATTITUDE regions of each set: slot -> name
ATTITUDE_REGIONS = {"v1": {11: "4 stages", 12: "weighted sum",
                           13: "normalisation (sqrt, 4 divides)"},
                    "v2": {0: "stage 1", 1: "stage 2", 2: "stage 3",
                           3: "stage 4", 4: "weighted sum",
                           5: "normalisation (sqrt, one reciprocal, 4 "
                              "corrections) and the fallback's test"}}
#: region names of INTEGRATE_PROBES by slot
PROBE_REGIONS = {0: "stage sum", 3: "deriv: norm3 (sqrt)",
                 4: "deriv: TwoBody (3 divides)", 7: "deriv: J2 z/|r|",
                 5: "deriv: J2 pow(|r|, 5) and recip",
                 6: "deriv: J2 rest", 1: "deriv: terms' sum",
                 2: "stage store, 8th/7th sums", 8: "error norm",
                 9: "step-size law, accept", 10: "loop head, clamp",
                 11: "ATTITUDE: 4 stages", 12: "ATTITUDE: weighted sum",
                 13: "ATTITUDE: normalisation (sqrt, 4 divides)"}


# The chain bound of the serial modes: the integrator kernel's arithmetic
# of one DP8(7) substep (TwoBody + J2, adaptive_run) and of one ATTITUDE
# step (attitude_step<true>), mirrored on the cycle at which each value is
# ready on one thread: an operation starts when its last operand is ready
# and takes its dependent latency. A compare or select (torch.maximum,
# Python's min and max) counts as one f64 add; a sign change or |x| as
# nothing (an operand modifier); the divides' window tests overlap. No
# schedule beats the result: it is the dataflow's critical path.


def _dp87_substep_times(lat, y, h, t):
    """Ready cycles of (y, h, t) after one DP8(7) substep of TwoBody + J2
    from ready cycles ``y`` (6), ``h`` and ``t``, at latencies ``lat``."""
    from astroz_tpu_torch.propagators.integrators import _A, _B7, _B8

    add, mul, fma = lat["DADD"], lat["DMUL"], lat["DFMA"]
    div, rcp, sqrt = lat["__ddiv_rn"], lat["__drcp_rn"], lat["__dsqrt_rn"]
    pow_, cmp = lat["pow(x, 5.0)"], lat["DADD"]
    # the loop's test (t - end) * dir < 0, then the clamp's select between
    # end - t and h on ((t + h) - end) * dir > 0
    test = t + add + mul + cmp
    hs = max(test, max(t, h) + add + add + mul + cmp, t + add)

    def by_rcp(n, b, yb):  # div_by_rcp: a product, four FMAs
        return max(max(n, yb) + mul, b) + 4 * fma

    def deriv(s):
        r, v = s[:3], s[3:]
        rn = max(max(r[0], r[2]) + mul + add, r[1] + mul) + add + sqrt
        # TwoBody: -mu r / rn^3 through one reciprocal
        c3 = rn + mul + mul
        tb = [by_rcp(x + mul, c3, c3 + rcp) for x in r]
        # J2: zr = z / rn, k = recip(rn^5) * p, a = k * (r * xy)
        z2 = max(r[2], rn) + div + mul
        k = rn + pow_ + rcp + mul
        poly = z2 + mul + add
        j2 = [max(k, max(x, poly) + mul) + mul for x in r]
        return list(v) + [max(a, b) + add for a, b in zip(tb, j2)]

    ks, y8, y7 = [], list(y), list(y)
    for i in range(13):
        s = list(y)
        for j, a in enumerate(_A[i]):
            if a != 0:
                ha = hs + mul
                s = [max(x, max(ha, k) + mul) + add
                     for x, k in zip(s, ks[j])]
        ks.append(deriv(s))
        if _B8[i] != 0:
            y8 = [max(x, max(hs + mul, k) + mul) + add
                  for x, k in zip(y8, ks[i])]
        if _B7[i] != 0:
            y7 = [max(x, max(hs + mul, k) + mul) + add
                  for x, k in zip(y7, ks[i])]
    # err = max(|y8 - y7| / (rtol * maximum(|y|, |y8|) + atol))
    err = None
    for a, b, c in zip(y, y8, y7):
        e = max(max(b, c) + add, max(a, b) + cmp + mul + add) + div
        err = e if err is None else max(err, e) + cmp
    factor = err + cmp + pow_ + mul + cmp + cmp
    h_new = max(hs, factor) + mul + cmp + cmp + mul
    accept = err + cmp
    y_new = [max(accept, b, a) for a, b in zip(y, y8)]
    return y_new, h_new, max(accept, t, hs) + add


def _attitude_step_times(lat, q, w):
    """Ready cycles of (q, w) after one ATTITUDE step from ready cycles
    ``q`` (4) and ``w`` (3), the inertia, its reciprocals and the torque
    ready before, at latencies ``lat``."""
    add, mul, fma = lat["DADD"], lat["DMUL"], lat["DFMA"]
    rcp, sqrt = lat["__drcp_rn"], lat["__dsqrt_rn"]

    def by_rcp(n, b, yb):
        return max(max(n, yb) + mul, b) + 4 * fma

    def deriv(sq, sw):
        # qd = 0.5 q * [0, w]: three products summed left to right, then
        # the half; each component's operands in attitude_deriv's order
        order = (((0, None), (1, 0), (2, 1), (3, 2)),
                 ((0, 0), (1, None), (2, 2), (3, 1)),
                 ((0, 1), (1, 2), (2, None), (3, 0)),
                 ((0, 2), (1, 1), (2, 0), (3, None)))
        qd = []
        for terms in order:
            acc = None
            for qi, wi in terms:
                p = (sq[qi] if wi is None else max(sq[qi], sw[wi])) + mul
                acc = p if acc is None else max(acc, p) + add
            qd.append(acc + mul)
        # wd = (T - w x (I w)) / I, the divide through 1 / I
        iw = [x + mul for x in sw]
        wd = []
        for a, b in ((1, 2), (2, 0), (0, 1)):
            cross = max(sw[a], iw[b], max(sw[b], iw[a]) + mul) + fma
            wd.append(by_rcp(cross + add, 0.0, 0.0))
        return qd, wd

    sq, sw = list(q), list(w)
    aq = aw = None
    for st in range(4):
        kq, kw = deriv(sq, sw)
        if st == 0:
            aq, aw = kq, kw
        else:
            wgt = mul if st in (1, 2) else 0.0
            aq = [max(a, k + wgt) + add for a, k in zip(aq, kq)]
            aw = [max(a, k + wgt) + add for a, k in zip(aw, kw)]
        if st < 3:
            sq = [max(x, k + mul) + add for x, k in zip(q, kq)]
            sw = [max(x, k + mul) + add for x, k in zip(w, kw)]
    qn = [max(x, a + mul) + add for x, a in zip(q, aq)]
    wn = [max(x, a + mul) + add for x, a in zip(w, aw)]
    n4 = max(max(qn[0], qn[2]) + mul + add,
             max(qn[1], qn[3]) + mul + add) + add + sqrt
    return [by_rcp(x, n4, n4 + rcp) for x in qn], wn


def chain_cycles(lat, steps=64):
    """The serial modes' chain bounds in cycles at latencies ``lat`` (the
    keys of :func:`latencies`): for a DP8(7) substep of TwoBody + J2 and
    an ATTITUDE step, the critical path of one step from inputs ready
    together (``one``: a schedule that ends each step before the next,
    as the kernel's loops do) and the steady-state cycles a step over
    ``steps`` steps (``dataflow``: where values that do not wait for the
    others, such as ATTITUDE's w, run steps ahead)."""
    out = {}
    for name, fn, init in (
            ("dp87_substep",
             lambda st: (lambda y, h, t: (*_dp87_substep_times(lat, y, h,
                                                               t),))(*st),
             ([0.0] * 6, 0.0, 0.0)),
            ("attitude_step",
             lambda st: _attitude_step_times(lat, *st),
             ([0.0] * 4, [0.0] * 3))):
        def ready(st):
            return max(max(x) if isinstance(x, list) else x for x in st)

        st = fn(init)
        one = ready(st)
        half = None
        for k in range(1, steps):
            if k == steps // 2:
                half = ready(st)
            st = fn(st)
        out[name] = {"one": one,
                     "dataflow": (ready(st) - half) / (steps - steps // 2)}
    return out


def _latency_library():
    """The microbenchmarks of :data:`_LATENCY_CU`, built and bound."""
    import ctypes

    from astroz_tpu_torch import _build

    d = VARIANT_DIR / "latency"
    d.mkdir(parents=True, exist_ok=True)
    (d / "latency.cu").write_text(_LATENCY_CU)
    out = d / "liblatency.so"
    flags = [f.replace("=false", "=true") for f in _build.NVCC_FLAGS]
    subprocess.run([_build._nvcc(), *flags, "-shared", "-o", str(out),
                    str(d / "latency.cu")], check=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    P, L, D = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double
    lib.astroz_latency.argtypes = [ctypes.c_int, D, D, L, P, P]
    lib.astroz_divide_probe.argtypes = [ctypes.c_int, L, ctypes.c_ulonglong,
                                        P, P]
    return lib


def latencies(lib, n=1 << 14):
    """Cycles of one dependent op on one thread (clock64 over 16 n ops),
    by op; an op run after a reset has the reset's cycles taken off."""
    out = torch.empty(1, dtype=torch.float64, device="cuda")
    cyc = torch.empty(1, dtype=torch.int64, device="cuda")
    raw = {}
    for k, (name, b) in enumerate(LATENCY_OPS):
        for _ in range(2):  # the second run is kept
            rc = lib.astroz_latency(k, 1.7, b, n, out.data_ptr(),
                                    cyc.data_ptr())
            if rc != 0:
                raise RuntimeError(f"latency kernel {name}: cudaError {rc}")
            torch.cuda.synchronize()
        raw[name] = int(cyc.item()) / (16 * n)
    reset = raw["reset"]
    return {name: (c - reset if k > 3 else c)
            for k, (name, c) in enumerate(raw.items())}


def divide_probes(lib, n):
    """Mismatches of one and of two corrections against __ddiv_rn over
    ``n`` pairs of each of :data:`DIVIDE_SETS`."""
    out = {}
    for s, name in enumerate(DIVIDE_SETS):
        miss = torch.zeros(2, dtype=torch.int64, device="cuda")
        ex = torch.zeros(4, dtype=torch.float64, device="cuda")
        rc = lib.astroz_divide_probe(s, n, 0x5eed + s, miss.data_ptr(),
                                     ex.data_ptr())
        if rc != 0:
            raise RuntimeError(f"divide probe: cudaError {rc}")
        torch.cuda.synchronize()
        m, e = miss.tolist(), ex.tolist()
        out[name] = {"pairs": n, "one correction": m[0],
                     "two corrections": m[1],
                     "example": [e[:2] if m[0] else None,
                                 e[2:] if m[1] else None]}
    return out


def sass_summary(lib_path, kernel, tag):
    """The SASS of the kernel whose mangled name contains ``kernel``
    (``cuobjdump -sass``), written to ``chiprun_out/sass_<tag>_<kernel>.txt``,
    and a count of what sits in it: the divide and reciprocal sequences
    (MUFU.RCP64H), square roots (MUFU.RSQ64H), calls, f64 adds,
    multiplies and fused multiply-adds, and its backward branches (loops)
    with their spans in instructions."""
    from astroz_tpu_torch import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    dump = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout
    body = next((f for f in re.split(r"\n\s*Function : ", dump)[1:]
                 if kernel in f.split(None, 1)[0]), None)
    if body is None:
        return None
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    (ROOT / "chiprun_out" / f"sass_{tag}_{kernel}.txt").write_text(body)
    ins = [(int(m.group(1), 16), m.group(2).strip()) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]

    def n(pattern):
        return sum(bool(re.search(pattern, t)) for _, t in ins)

    loops = []
    for a, t in ins:
        m = re.search(r"\bBRA\b[^;]*?(0x[0-9a-f]+)", t)
        if m and int(m.group(1), 16) < a:
            loops.append((int(m.group(1), 16), a,
                          sum(int(m.group(1), 16) <= b <= a for b, _ in ins)))
    return {"instructions": len(ins), "MUFU.RCP64H": n(r"MUFU\.RCP64H"),
            "MUFU.RSQ64H": n(r"MUFU\.RSQ64H"), "CALL": n(r"\bCALL\b"),
            "DADD": n(r"^(@!?P\d+\s+)?DADD"),
            "DMUL": n(r"^(@!?P\d+\s+)?DMUL"),
            "DFMA": n(r"^(@!?P\d+\s+)?DFMA"), "loops": loops}


def integrate_probes(args):
    """``--integrate-probes`` (needs a card): the dependent latencies of
    one thread, the divide corrections against __ddiv_rn over
    ``--divide-pairs`` pairs a set, the clock64 regions of
    :data:`INTEGRATE_PROBES` over 10b's trajectory (``chip_smoke``'s ISS,
    TwoBody + J2, rtol 1e-10, 360 outer steps of 60 s) and 10d's 10,000
    attitude steps, in a variant of the package of ``--tree`` (this
    checkout without it), and the SASS of its one-thread and ATTITUDE
    kernels."""
    import ctypes

    if not torch.cuda.is_available():
        raise SystemExit("shallow_variants: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    smi = chip_smoke.card_line()
    src = (Path(args.tree).resolve() if args.tree else ROOT) / \
        "astroz_tpu_torch"
    version = "v2" if "deriv_sig" in (src / _INTEGRATE_CU).read_text() \
        else "v1"
    plain_build, _ = make_variant("unprobed", src)
    probe_build, _ = make_variant("probed", src, {
        "v1": INTEGRATE_PROBES, "v2": INTEGRATE_PROBES_V2}[version])
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(b.build) for b in (plain_build, probe_build)]
        jobs.append(pool.submit(_latency_library))
        lat_lib = jobs[2].result()
        for j in jobs[:2]:
            j.result()
    print(f"# integrate probes: built in {time.perf_counter() - t0:.1f} s")
    result = {"tag": args.tag, "card": smi, "tree": args.tree,
              "sm_clock_max_hz": chip_smoke._max_sm_clock_hz()}
    result["latency_cycles"] = latencies(lat_lib)
    print(f"# integrate probes [{smi}]: dependent latency, cycles an op on "
          f"one thread: " + ", ".join(
              f"{k} {v:.2f}" for k, v in result["latency_cycles"].items()))
    result["chain_cycles"] = chain_cycles(result["latency_cycles"])
    print(f"# integrate probes [{smi}]: chain bounds at these latencies, "
          f"cycles a step (one: a step from inputs ready together; "
          f"dataflow: the steady state over steps): "
          f"{json.dumps(result['chain_cycles'])}")
    result["divide"] = divide_probes(lat_lib, args.divide_pairs)
    print(f"# integrate probes [{smi}]: divide corrections against "
          f"__ddiv_rn: {json.dumps(result['divide'])}")
    for build, tag in ((plain_build, "unprobed"), (probe_build, "probed")):
        result[f"ptxas_{tag}"] = [r for r in build.ptxas_report()
                                  if "integrate" in r[0]]
    for kernel in ("integrate_adaptive_kernel", "integrate_attitude_kernel",
                   "integrate_trajectory_kernel"):
        result[f"sass_{kernel}"] = sass_summary(plain_build.library_path(),
                                                kernel, args.tag)
        print(f"# integrate probes: SASS of {kernel}: "
              f"{json.dumps(result[f'sass_{kernel}'])}")
    pkg = "astroz_variant_probed"
    props = importlib.import_module(f"{pkg}.propagators")
    calc = importlib.import_module(f"{pkg}.calculations")
    lib = probe_build.library()
    read = lib.astroz_probe_read
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    buf = np.zeros(16, np.int64)

    def probe_sums():
        torch.cuda.synchronize()
        if read(buf.ctypes.data) != 0:
            raise RuntimeError("astroz_probe_read failed")
        return buf.copy()

    # dp87_adaptive (an older tree's ADAPTIVE kernel, else TRAJECTORY for
    # one outer step): 10b's trajectory, one launch an outer step
    integ = props.DormandPrince87(props.Composite([props.TwoBody(),
                                                   props.J2()]),
                                  rtol=1e-10, device="cuda")
    state = torch.as_tensor(chip_smoke.iss_state(), device="cuda")
    acc = np.zeros(16, np.int64)
    launches = 360
    for k in range(launches):
        state = integ.step(state, 60.0 * k, 60.0)
        acc += probe_sums()
    subs = integ.n_substeps
    over = acc[15] / (64 * launches)  # one probe's own cycles
    # a substep's regions: 13 stages of slots 0, 3, 4, 7, 5, 6, 1, 2; one
    # of 8, 9, 10
    per = {}
    for slot, name in PROBE_REGIONS.items():
        if slot > 10:
            continue
        count = subs * (13 if slot <= 7 else 1)
        per[name] = (acc[slot] / count - over) * (13 if slot <= 7 else 1)
    result["adaptive"] = {"launches": launches, "substeps": subs,
                          "probe_cycles": over,
                          "cycles_a_substep_by_region": per,
                          "cycles_a_substep": sum(per.values()),
                          "probes_a_substep": 13 * 8 + 3}
    print(f"# integrate probes [{smi}]: ADAPTIVE, {subs} substeps in "
          f"{launches} outer steps; a probe {over:.1f} cycles (taken off "
          f"each region); cycles a substep by region: " + ", ".join(
              f"{k} {v:.0f}" for k, v in per.items())
          + f"; total {sum(per.values()):.0f}")
    # ATTITUDE: 10d's 10,000 steps of one body
    q0 = torch.tensor([0.6, 0.0, 0.8, 0.0], dtype=torch.float64,
                      device="cuda")
    args_att = [q0] + [torch.as_tensor(x, device="cuda") for x in (
        np.array([0.01, -0.02, 0.1]), np.array([10.0, 12.0, 20.0]),
        np.zeros(3))]
    calc.propagate_attitude(*args_att, 0.01, 10000, device="cuda")
    acc = probe_sums()
    over = acc[15] / 64
    per = {name: acc[slot] / 10000 - over
           for slot, name in ATTITUDE_REGIONS[version].items()}
    result["attitude"] = {"steps": 10000, "probe_cycles": over,
                          "cycles_a_step_by_region": per,
                          "cycles_a_step": sum(per.values())}
    print(f"# integrate probes [{smi}]: ATTITUDE, 10,000 steps; a probe "
          f"{over:.1f} cycles; cycles a step by region: " + ", ".join(
              f"{k} {v:.0f}" for k, v in per.items())
          + f"; total {sum(per.values()):.0f}")
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / f"integrate_probes_{args.tag}.json",
              "w") as fh:
        json.dump(result, fh, indent=1, default=float)
    print(smi)


#: --integrate-turns: the numerical stack's entry points at phase 10's
#: shapes, each tree's package on the same inputs: (workload, calls a
#: timing, replayed from a CUDA graph)
INTEGRATE_WORKLOADS = (("trajectory", 3, False), ("adaptive_step", 50, False),
                       ("attitude", 3, True), ("fixed", 3, True),
                       ("fixed_dp87", 10, True), ("spacecraft", 3, False))


def _integrate_workloads(pkg, chip_smoke):
    """The workloads of INTEGRATE_WORKLOADS through the entry points of
    the package ``pkg`` (a variant's import name): each a function that
    returns the tensors it computes (numpy for the spacecraft)."""
    props = importlib.import_module(f"{pkg}.propagators")
    calc = importlib.import_module(f"{pkg}.calculations")
    craft = importlib.import_module(f"{pkg}.spacecraft")
    tle = importlib.import_module(f"{pkg}.tle")
    dev = "cuda"
    one = torch.as_tensor(chip_smoke.iss_state(), device=dev)
    lanes = torch.as_tensor(chip_smoke.monte_carlo_lanes(
        chip_smoke.NUMERICAL_LANES), device=dev)
    mc = props.Composite([props.TwoBody(), props.J2(), props.Drag()])
    dp = props.Composite([props.TwoBody(), props.J2()])
    deriv = props.make_deriv(dp)
    att = [torch.as_tensor(x, device=dev) for x in (
        np.array([0.6, 0.0, 0.8, 0.0]), np.array([0.01, -0.02, 0.1]),
        np.array([10.0, 12.0, 20.0]), np.zeros(3))]
    elements = tle.parse_lines(chip_smoke.GOLDEN_L1, chip_smoke.GOLDEN_L2)
    burns = [craft.Impulse(time=3600.0, kind=craft.ImpulseKind.PROGRADE,
                           magnitude=0.1),
             craft.Impulse(time=10800.0, kind=craft.ImpulseKind.PLANE_CHANGE,
                           delta_inclination=np.deg2rad(5.0))]

    def trajectory():
        integ = props.DormandPrince87(dp, rtol=1e-10, device=dev)
        states = props.Propagator(integ).propagate(
            one, 0.0, chip_smoke.NUMERICAL_DP87_S, 60.0)[1]
        return states, torch.tensor([integ.h_current, integ.n_substeps],
                                    dtype=torch.float64)

    def adaptive_step():
        y, h, n = props.dp87_adaptive(deriv, one, 0.0, 60.0, rtol=1e-10)
        return y, torch.tensor([h, n], dtype=torch.float64)

    def attitude():
        return calc.propagate_attitude(*att, 0.01,
                                       chip_smoke.NUMERICAL_ATTITUDE_STEPS)

    def fixed():
        return (props.propagate_fixed(mc, lanes, 0.0,
                                      chip_smoke.NUMERICAL_ORBIT_S,
                                      chip_smoke.NUMERICAL_DT_S)[1],)

    def fixed_dp87():
        return (props.propagate_fixed(
            mc, lanes[:chip_smoke.NUMERICAL_DP87_FIXED_LANES], 0.0,
            chip_smoke.NUMERICAL_DP87_FIXED_STEPS * chip_smoke.NUMERICAL_DT_S,
            chip_smoke.NUMERICAL_DT_S, method="dp87")[1],)

    def spacecraft():
        sc = craft.Spacecraft.from_tle(elements, device=dev)
        return (torch.as_tensor(sc.propagate(0.0, 0.25, 30.0,
                                             impulses=burns)[1]),)

    return {"trajectory": trajectory, "adaptive_step": adaptive_step,
            "attitude": attitude, "fixed": fixed, "fixed_dp87": fixed_dp87,
            "spacecraft": spacecraft}


def integrate_turns(args):
    """``--integrate-turns`` (needs a card): the numerical stack's entry
    points (INTEGRATE_WORKLOADS) through this checkout's package and the
    package of ``--tree``, on the same inputs, round after round in turns
    (the order reversed on every other round): whether each output equals
    the tree's bit for bit, and each one's ms (CUDA events; the replayed
    ones from a CUDA graph of one call, the others back to back, host
    time included)."""
    if not torch.cuda.is_available():
        raise SystemExit("shallow_variants: no CUDA device")
    if not args.tree:
        raise SystemExit("shallow_variants: --integrate-turns needs --tree")
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    smi = chip_smoke.card_line()
    pkgs = {"change": make_variant("change"),
            "tree": make_variant("tree", Path(args.tree).resolve()
                                 / "astroz_tpu_torch")}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for job in [pool.submit(b.build) for b, _ in pkgs.values()]:
            job.result()
    print(f"# integrate turns: built in {time.perf_counter() - t0:.1f} s")
    fns = {v: _integrate_workloads(f"astroz_variant_{v}", chip_smoke)
           for v in pkgs}
    outs = {v: {k: fn() for k, fn in f.items()} for v, f in fns.items()}
    equal = {k: all(torch.equal(a, b) for a, b in zip(outs["change"][k],
                                                       outs["tree"][k]))
             for k in fns["change"]}
    print(f"# integrate turns [{smi}]: this checkout bit-equal to "
          f"{args.tree}: {equal}")
    ms = {v: {k: [] for k in fns[v]} for v in pkgs}
    for rnd in range(args.rounds):
        for v in (list(pkgs) if rnd % 2 == 0 else list(pkgs)[::-1]):
            for k, reps, replay in INTEGRATE_WORKLOADS:
                fn = fns[v][k]
                ms[v][k].append(chip_smoke._graph_ms(fn, reps, per_graph=1)
                                if replay else chip_smoke._cuda_ms(fn, reps))
    for v in pkgs:
        for (k, _, replay) in INTEGRATE_WORKLOADS:
            xs = ms[v][k]
            print(f"# integrate turns {v} [{smi}]: {k} "
                  f"{np.mean(xs):.4f} ms ({', '.join(f'{x:.4f}' for x in xs)}"
                  f"; {'replayed' if replay else 'back to back'})")
    for build, tag in ((pkgs["change"][0], "change"),
                       (pkgs["tree"][0], "tree")):
        for name, regs, st, ld in build.ptxas_report():
            if "integrate" in name or "deriv" in name:
                print(f"# integrate turns {tag}: ptxas {name}: {regs} "
                      f"registers, spill stores {st} B, spill loads {ld} B")
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / f"integrate_turns_{args.tag}.json",
              "w") as fh:
        json.dump({"card": smi, "tree": args.tree, "equal": equal, "ms": ms},
                  fh, indent=1)
    print(smi)


#: --epilogue-turns: calls of the epilogue kernel a timing (replayed from a
#: CUDA graph)
EPILOGUE_REPS = 20


def _bits_differ(a, b):
    """The values of ``a`` and ``b`` whose bit patterns differ (NaN where
    NaN counts as equal)."""
    if a is None or b is None:
        return 0 if a is b else -1
    if a.shape != b.shape or a.dtype != b.dtype:
        return -1
    if not a.is_floating_point():
        return int((a != b).sum().item())
    ity = torch.int32 if a.dtype == torch.float32 else torch.int64
    nan = torch.isnan(a) & torch.isnan(b)
    return int(((a.view(ity) != b.view(ity)) & ~nan).sum().item())


def epilogue_turns(args):
    """``--epilogue-turns`` (needs a card): the epilogue kernel
    (``csrc/finalize.cu``) of this checkout (``change``), of each variant
    named by ``--variants`` and of ``--tree``'s package, on the same
    inputs: the mixed catalog's f32 planes and f64 DENSE output x 1,440
    (``propagate(..., layout="planes")`` and ``propagate(..., method=
    "f64")`` of this checkout), every frame x layout but the identity,
    with velocities. Prints how many values of each differ from the
    tree's (or the change's) bit for bit, the trips of the latitude
    iteration on both sweeps (``chip_smoke.trips_report``), each kernel's
    ptxas report and the tile walk's grid, then each form's ms replayed
    from a CUDA graph, round after round in turns (the order reversed on
    every other round), beside torch's copies of the relayout
    (``chip_smoke._relayout``: r, v and, for sat_major, the codes) timed
    in the same rounds."""
    if not torch.cuda.is_available():
        raise SystemExit("shallow_variants: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from astroz_tpu_torch import build_catalog, propagate

    smi = chip_smoke.card_line()
    names = ["change"] + [v for v in args.variants if v != "default"]
    pkgs = {v: make_variant(v, edits=VARIANTS.get(v, ())) for v in names}
    if args.tree:
        pkgs["tree"] = make_variant(
            "tree", Path(args.tree).resolve() / "astroz_tpu_torch")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for job in [pool.submit(b.build) for b, _ in pkgs.values()]:
            job.result()
    print(f"# epilogue turns: built {len(pkgs)} packages in "
          f"{time.perf_counter() - t0:.1f} s")
    fins = {v: importlib.import_module(f"astroz_variant_{v}.ops.cuda_finalize")
            for v in pkgs}
    mixed = build_catalog(chip_smoke.mixed_catalog_text(N_SATS))
    jd = chip_smoke.EPOCH_JD + np.arange(N_TIMES) / 1440.0
    jd_sum = torch.as_tensor(jd[:, None], device="cuda")
    sweeps = {"f32": (propagate(mixed, jd, method="fast", layout="planes"),
                      "planes"),
              "f64": (propagate(mixed, jd, method="f64"), "time_major")}
    # the other source of each type, for its sat_major forms
    other = {"f32 time-major": (propagate(mixed, jd, method="fast"),
                                "time_major"),
             "f64 planes": (propagate(mixed, jd, method="f64",
                                      layout="planes"), "planes")}
    trips = {k: chip_smoke.trips_report(
        propagate(mixed, jd, method="fast" if k == "f32" else "f64",
                  output="ecef", layout="planes")[0],
        f"mixed {N_SATS} x {N_TIMES} {k} ECEF", smi) for k in sweeps}
    forms = {}
    for k, ((r, v, err), source) in sweeps.items():
        for output in fins["change"].OUTPUT_MODES:
            for layout in fins["change"].LAYOUTS:
                if not fins["change"].is_identity(source, output, layout,
                                                  None):
                    forms[f"{k} {output} {layout}"] = (
                        (r, v, err, jd_sum),
                        dict(source=source, output=output, layout=layout,
                             velocities=True))
    for k, ((r, v, err), source) in other.items():
        for output in ("teme", "geodetic"):
            forms[f"{k} {output} sat_major"] = (
                (r, v, err, jd_sum),
                dict(source=source, output=output, layout="sat_major",
                     velocities=True))
    if args.forms:
        forms = {k: x for k, x in forms.items()
                 if any(f in k for f in args.forms)}
    ref_pkg = "tree" if "tree" in pkgs else "change"
    differ = {v: {} for v in pkgs}
    for name, (xs, kw) in forms.items():
        want = fins[ref_pkg].finalize(*xs, **kw)
        for v in pkgs:
            got = fins[v].finalize(*xs, **kw)
            differ[v][name] = sum(_bits_differ(a, b)
                                  for a, b in zip(got, want))
            del got
        del want
    for v in pkgs:
        print(f"# epilogue turns: {v}: values differing bit for bit from "
              f"{ref_pkg}: {differ[v]}")
        for name, regs, st, ld in pkgs[v][0].ptxas_report():
            if "flat_kernel" in name or "tile_kernel" in name:
                print(f"# epilogue turns: {v}: ptxas {name}: {regs} "
                      f"registers, spill stores {st} B, spill loads {ld} B")
        if hasattr(fins[v], "launch_grid"):
            for dt in (torch.float32, torch.float64):
                print(f"# epilogue turns: {v}: tile walk grid {dt} "
                      f"{fins[v].launch_grid(dt, N_TIMES, N_SATS)}")
    fns = {v: {name: (lambda f=fins[v], xs=xs, kw=kw: f.finalize(*xs, **kw))
               for name, (xs, kw) in forms.items()} for v in pkgs}
    lib = {}
    for name, ((r, v, err, _), kw) in forms.items():
        perm = chip_smoke.RELAYOUT.get((kw["source"], kw["layout"]))
        if perm is not None and kw["output"] == "teme":
            lib[name] = (lambda r=r, v=v, err=err, perm=perm, kw=kw:
                         chip_smoke._relayout(r, v, err, perm, kw["layout"]))
    fns["torch"] = lib
    ms = {v: {name: [] for name in fns[v]} for v in fns}
    for rnd in range(args.rounds):
        for v in (list(fns) if rnd % 2 == 0 else list(fns)[::-1]):
            for name, fn in fns[v].items():
                ms[v][name].append(chip_smoke._graph_ms(fn, EPILOGUE_REPS))
    for v in fns:
        print(f"# epilogue turns {v} [{smi}]: " + "; ".join(
            f"{name} {np.mean(xs):.4f} ms ({', '.join(f'{x:.4f}' for x in xs)})"
            for name, xs in ms[v].items()))
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / f"epilogue_turns_{args.tag}.json",
              "w") as fh:
        json.dump({"card": smi, "tree": args.tree, "differ": differ,
                   "trips": trips, "ms": ms}, fh, indent=1)
    print(smi)


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
    ap.add_argument("--f64-routes", action="store_true")
    ap.add_argument("--torch-rounding", action="store_true")
    ap.add_argument("--integrate-probes", action="store_true")
    ap.add_argument("--integrate-turns", action="store_true")
    ap.add_argument("--epilogue-turns", action="store_true")
    ap.add_argument("--forms", nargs="+", default=None)
    ap.add_argument("--divide-pairs", type=int, default=10 ** 7)
    args = ap.parse_args()
    if args.integrate_probes:
        integrate_probes(args)
        return
    if args.integrate_turns:
        integrate_turns(args)
        return
    if args.epilogue_turns:
        epilogue_turns(args)
        return
    if args.torch_rounding:
        torch_rounding()
        return
    if args.fma_ulps:
        fma_ulps()
        return
    if args.f64_routes:
        f64_routes(args.rounds)
        return
    if "default" not in args.variants:
        args.variants.insert(0, "default")
    time_variants(args)


if __name__ == "__main__":
    main()
