"""Build the CUDA sources of ``csrc/`` with nvcc and bind them with ctypes.

The library is built at first use, never at import, into ``csrc/build/``
(listed in ``.gitignore``), and rebuilt when the hash of a source or of
the flags changes: one nvcc per ``.cu`` file, all started together, then
one link. Every exported function has a plain C interface; pointers and
the stream go through ``ctypes.c_void_p``. A failed build raises with
nvcc's output; ptxas' report (registers and spills of each kernel) is
kept beside the library (:func:`ptxas_report`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"

#: no FMA contraction and no fast math: the kernels then give the bits
#: of their plain torch versions (see csrc/sgp4_common.cuh)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: sources built with contraction on, in place of NVCC_FLAGS' --fmad=false:
#: the f64 kernel and the integrator kernel call libdevice's f64 pow (and
#: exp), the epilogue kernel its sin, cos and atan2, which give the bits of
#: torch's only when built as torch's kernels are; their own arithmetic
#: goes through rounded intrinsics, which are never contracted (see
#: csrc/sgp4_f64.cu, csrc/integrate_f64.cu, csrc/finalize.cu)
FMAD_SOURCES = ("sgp4_f64.cu", "integrate_f64.cu", "finalize.cu")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_D = ctypes.c_double

#: exported C functions: name -> (restype, argtypes)
SIGNATURES = {
    # t_time, t_sat, spine, tail, flags, n_times, n_sats, kepler_iters,
    # want_vel, j2, re, vkmpersec, r, v, err, stream
    "astroz_sgp4_shallow": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _F, _F, _F, _P, _P, _P, _P]),
    # the same, then near_cols, n_near, deep_cols, dr, dv, de, n_deep
    # before r, v, err, stream
    "astroz_sgp4_shallow_merge": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _F, _F, _F, _P, _I, _P, _P, _P, _P,
                                       _I, _P, _P, _P, _P]),
    # tsince, sat_stride, spine, tail, flags, n_times, n_sats,
    # kepler_iters, want_vel, j2, re, vkmpersec, r, v, err, stream
    "astroz_sgp4_shallow_dense": (_I, [_P, _I, _P, _P, _P, _I, _I, _I, _I,
                                       _F, _F, _F, _P, _P, _P, _P]),
    # n_times, n_sats, kepler_iters, want_vel, grid (3,) i32 out
    "astroz_sgp4_shallow_dense_grid": (_I, [_I, _I, _I, _I, _P]),
    # t32, u_base, mm, argp32, node32, xmdf32, tail, flags, n_times,
    # n_sats, kepler_iters, want_vel, j2, re, vkmpersec, r, v, err, stream
    "astroz_sgp4_shallow_grids": (_I, [_P] * 8 + [_I] * 4 + [_F] * 3
                                  + [_P] * 4),
    # n_times, n_sats, kepler_iters, want_vel, grid (3,) i32 out
    "astroz_sgp4_shallow_grids_grid": (_I, [_I, _I, _I, _I, _P]),
    # tsince, sat_stride, spine, n_times, n_sats, t32, u_base, mm, argp32,
    # node32, xmdf32, stream
    "astroz_sgp4_spine_grids": (_I, [_P, _I, _P, _I, _I] + [_P] * 7),
    # t_time, t_sat, spine, tail, flags, tables, n_times, n_deep, n_steps,
    # kepler_iters, want_vel, j2, re, vkmpersec, xke, j3oj2, r, v, err,
    # stream
    "astroz_sgp4_deep": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _F, _F, _F, _F, _F, _P, _P, _P, _P]),
    # n_times, n_deep, kepler_iters, want_vel, grid (3,) i32 out
    "astroz_sgp4_deep_grid": (_I, [_I, _I, _I, _I, _P]),
    # fields, n_deep, n_steps, shifts (host array), tables, stream
    "astroz_resonance_tables": (_I, [_P, _I, _I, _P, _P, _P]),
    # tsince, t_row, t_col, fields, flags, n_lanes, lane_step, n_times,
    # n_out, sdp4, want_vel, 7 constants (ops/cuda_sgp4.py _f64_consts), r,
    # v, err, stream
    "astroz_sgp4_f64_dense": (_I, [_P, _L, _L, _P, _P, _L, _L, _L, _L, _I,
                                   _I] + [_D] * 7 + [_P] * 4),
    # jd, fr, fields, flags, n_lanes, n_times, sdp4, want_vel, 7
    # constants, r, v, err, stream
    "astroz_sgp4_f64_dense_epochs": (_I, [_P, _P, _P, _P, _L, _L, _I, _I]
                                     + [_D] * 7 + [_P] * 4),
    # n_times, n_out, sdp4, want_vel, grid (3,) i32 out
    "astroz_sgp4_f64_grid": (_I, [_L, _L, _I, _I, _P]),
    # t_time, t_sat, fields, flags, idx, tables, n_times, n_esc, n_deep,
    # n_steps, want_vel, 7 constants, r, v, err, stream
    "astroz_sgp4_f64_escape": (_I, [_P] * 6 + [_L, _L, _L, _I, _I]
                               + [_D] * 7 + [_P] * 4),
    # state0, out, n_lanes, n_steps, substeps, h, dp87, n_terms, kinds,
    # params (host arrays), stream
    "astroz_integrate_fixed": (_I, [_P, _P, _L, _I, _I, _D, _I, _I, _P, _P,
                                    _P]),
    # state0, states, substeps, hs, info, t0, dt, t_last, n_outer,
    # h_carried, rtol, atol, h_min, h_max, max_substeps, n_terms, kinds,
    # params (host arrays), stream
    "astroz_integrate_trajectory": (_I, [_P] * 5 + [_D, _D, _D, _L]
                                    + [_D] * 5 + [_L, _I, _P, _P, _P]),
    # q0, w0, inertia, torque, q_out, w_out, n_bodies, n_steps, dt, stream
    "astroz_integrate_attitude": (_I, [_P] * 6 + [_L, _L, _D, _P]),
    # a, b, got, want, rcp, rcp_want, n, stream
    "astroz_integrate_divide_probe": (_I, [_P] * 6 + [_L, _P]),
    # r, v, err, sg, cg, mask, n_times, n_sats, source, layout, frame,
    # r_out, v_out, err_out, a_km, e2, rad2deg, stream
    "astroz_finalize_f32": (_I, [_P] * 6 + [_L, _L, _I, _I, _I]
                            + [_P] * 3 + [_D] * 3 + [_P]),
    "astroz_finalize_f64": (_I, [_P] * 6 + [_L, _L, _I, _I, _I]
                            + [_P] * 3 + [_D] * 3 + [_P]),
    # n_times, n_sats, want_vel, want_err, grid (4,) i32 out
    "astroz_finalize_grid_f32": (_I, [_L, _L, _I, _I, _P]),
    "astroz_finalize_grid_f64": (_I, [_L, _L, _I, _I, _P]),
    # r, n_times, n_sats, j0, width, out, stream
    "astroz_screen_coarse": (_I, [_P, _I, _I, _I, _I, _P, _P]),
    # r, n_times, n_sats, thr2, cap, out_ij, count, stream
    "astroz_screen_candidates": (_I, [_P, _I, _I, _F, _L, _P, _P, _P]),
    # rows, n_times, n_rows, cols, n_cols, thr2, cap, out_ij, count, stream
    "astroz_screen_candidates_rect": (_I, [_P, _I, _I, _P, _I, _F, _L, _P,
                                           _P, _P]),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME and "
                       "/usr/local/cuda): the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    sources, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS + FMAD_SOURCES).encode())
    for p in sources + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libastroz_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands together; raise with the output of a failed one,
    else return their combined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, text in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{text}")
    return "".join(outs)


def _flags(src: Path):
    """NVCC_FLAGS, with contraction on for FMAD_SOURCES."""
    if src.name not in FMAD_SOURCES:
        return NVCC_FLAGS
    return tuple(f.replace("=false", "=true") if f.startswith("--fmad")
                 else f for f in NVCC_FLAGS)


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for this hash exists."""
    out = library_path()
    if out.exists():
        return out
    sources, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    nvcc = _nvcc()
    try:
        log = _run_all([[nvcc, *_flags(src), "-c", "-o", str(obj), str(src)]
                        for src, obj in zip(sources, objs)])
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def ptxas_report():
    """``[(kernel, registers, spill_stores, spill_loads)]`` from ptxas'
    output of the current build (mangled kernel names)."""
    log = library_path().with_suffix(".log").read_text()
    report, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report.append((name, int(m.group(1))) + spills)
            name, spills = None, (0, 0)
    return report


@functools.cache
def library() -> ctypes.CDLL:
    """The built and bound kernel library (built on the first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib
