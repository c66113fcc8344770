"""The native (C++) scalar SGP4/SDP4 host engine, bound with ctypes.

Counterpart of the scalar part of ``astroz_tpu/native/`` (its
``__init__.py:220-404``): ``scalar_sgp4.cpp`` propagates one packed
element vector (``SCALAR_FIELDS``, laid out by ``scalar_fields.h``) to
one time, to a time array (an 8-wide SIMD block for near-earth lanes),
or over an (n_sats, n_times) grid; ``scalar_ext.c`` is a CPython
extension whose ``SatCore`` runs a whole ``Satrec.sgp4(jd, fr)`` call in
C. ``api.Satrec`` routes single-point calls here, and
``api.SatrecArray`` routes its ``device="cpu"`` sweeps to
:func:`sgp4_grid`.

Both libraries are built with g++ at first use, never at import, into
``native/build/`` (listed in ``.gitignore``), and rebuilt when the hash
of the sources, the flags or (for the extension) the Python ABI
changes. The ctypes library is required: a failed build raises with
g++'s output. The extension is optional: a failed build is reported once
on stderr and single-point calls take the ctypes path. The shared
library and the module keep names of their own (``libastroz_torch_scalar``,
``_astroz_torch_scalar``), so that they load beside the JAX package's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import sysconfig
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR / "build"
_HEADER = _DIR / "scalar_fields.h"
_SRC = _DIR / "scalar_sgp4.cpp"
_SRC_EXT = _DIR / "scalar_ext.c"
_EXT_NAME = "_astroz_torch_scalar"

# -fno-math-errno: no errno bookkeeping around sqrt/sin/cos -> inline
# sqrtsd + fused sincos calls (results unchanged); -march=native is safe
# because the library is a per-machine build artifact (gitignored);
# -fopenmp-simd: honor `#pragma omp simd` (forces if-conversion and
# vectorization of the 8-wide lane loops) without an OpenMP runtime.
# The JAX package's flags (astroz_tpu/native/__init__.py:73-75), so that
# both engines give the same bits on one machine.
BUILD_FLAGS = ("-O3", "-march=native", "-fno-math-errno", "-fopenmp-simd",
               "-mprefer-vector-width=512", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_EXT = None
_EXT_TRIED = False

_D = ctypes.POINTER(ctypes.c_double)
_I = ctypes.POINTER(ctypes.c_int)
_L = ctypes.c_longlong

#: exported C functions: name -> (restype, argtypes)
SIGNATURES = {
    "astroz_scalar_sgp4": (ctypes.c_int, [_D, ctypes.c_double, _D]),
    "astroz_scalar_sgp4_array": (_L, [_D, _D, _L, _D, _I]),
    "astroz_sgp4_grid": (_L, [_D, _L, _L, _D, _L, _D, _I]),
}


def _target(stem: str, sources, extra: str = "") -> Path:
    h = hashlib.sha256(" ".join(BUILD_FLAGS).encode() + extra.encode())
    for p in (*sources, _HEADER):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def _compile(out: Path, cmd_tail) -> None:
    """Run g++ into a temporary file beside ``out`` and move it into
    place (several processes may build at once); raises
    ``subprocess.CalledProcessError`` with g++'s output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *BUILD_FLAGS, *cmd_tail, "-o", str(tmp)],
                       check=True, capture_output=True, text=True,
                       timeout=300)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def library_path() -> Path:
    """Where the ctypes library for the current sources and flags lives."""
    return _target("libastroz_torch_scalar", (_SRC,))


def _ext_path() -> Path:
    return _target(_EXT_NAME, (_SRC_EXT, _SRC),
                   sys.version + str(sysconfig.get_config_var("EXT_SUFFIX")))


def get_lib() -> ctypes.CDLL:
    """The built and bound ctypes library (built on the first call);
    raises ``RuntimeError`` with g++'s output when it does not build."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            out = library_path()
            if not out.exists():
                try:
                    _compile(out, [str(_SRC)])
                except (OSError, subprocess.SubprocessError) as exc:
                    raise RuntimeError(
                        "the native scalar engine did not build: "
                        + str(getattr(exc, "stderr", None) or exc)) from exc
            lib = ctypes.CDLL(str(out))
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _LIB = lib
        return _LIB


def _get_ext():
    """The CPython extension module (the all-C per-call path), or None
    when it does not build here; the failure is reported once."""
    global _EXT, _EXT_TRIED
    get_lib()
    with _LOCK:
        if _EXT_TRIED:
            return _EXT
        _EXT_TRIED = True
        out = _ext_path()
        try:
            if not out.exists():
                inc = sysconfig.get_paths()["include"]
                _compile(out, [f"-I{inc}", str(_SRC_EXT), str(_SRC)])
            import importlib.util
            spec = importlib.util.spec_from_file_location(
                f"{__name__}.{_EXT_NAME}", out)
            ext = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(ext)
            _EXT = ext
        except (OSError, ImportError, subprocess.SubprocessError) as exc:
            sys.stderr.write(
                "astroz_tpu_torch.native: the CPython extension did not "
                "build; single-point calls take the ctypes path:\n"
                + str(getattr(exc, "stderr", None) or exc) + "\n")
        return _EXT


#: packed element-vector layout for the native scalar propagator —
#: MUST match the F enum in scalar_fields.h
SCALAR_FIELDS = (
    "radiusearthkm", "xke", "j2", "j3oj2",
    "mo", "mdot", "argpo", "argpdot", "nodeo", "nodedot", "nodecf",
    "cc1", "bstar", "cc4", "t2cof", "isimp", "omgcof", "eta",
    "xmcof", "delmo", "sinmao", "d2", "d3", "d4", "cc5",
    "t3cof", "t4cof", "t5cof", "no_unkozai", "ecco", "inclo",
    "deep", "aycof", "xlcof", "con41", "x1mth2", "x7thm1",
    "gsto", "dedt", "didt", "domdt", "dnodt", "dmdt", "irez",
    "xlamo", "del1", "del2", "del3", "xfact",
    "d2201", "d2211", "d3210", "d3222", "d4410", "d4422",
    "d5220", "d5232", "d5421", "d5433",
    "zmos", "zmol",
    "se2", "se3", "si2", "si3", "sl2", "sl3", "sl4",
    "sgh2", "sgh3", "sgh4", "sh2", "sh3",
    "ee2", "e3", "xi2", "xi3", "xl2", "xl3", "xl4",
    "xgh2", "xgh3", "xgh4", "xh2", "xh3",
    "peo", "pinco", "plo", "pgho", "pho")

_GRAV_FIELDS = frozenset(("radiusearthkm", "xke", "j2", "j3oj2"))


def pack_scalar_sat(sat) -> np.ndarray:
    """Pack an initialized ``ops.scalar.Sat`` into the native
    propagator's element vector."""
    vec = np.zeros(len(SCALAR_FIELDS), np.float64)
    grav = sat.whichconst
    deep = sat.method == "d"
    for i, name in enumerate(SCALAR_FIELDS):
        if name in _GRAV_FIELDS:
            vec[i] = getattr(grav, name)
        elif name == "deep":
            vec[i] = 1.0 if deep else 0.0
        else:
            src = sat.__dict__.get(name, sat.extra.get(name))
            if src is None and not deep:
                continue  # deep-only coefficient on a shallow sat
            vec[i] = float(src if src is not None else 0.0)
    return vec


class ScalarEngine:
    """Per-satellite native scalar propagator handle (caches the packed
    vector; one call goes through the CPython extension where it built,
    else through ctypes)."""

    __slots__ = ("_vec", "_vec_p", "_vec_addr", "_out", "_out_p", "_ext",
                 "_lib")

    def __init__(self, vec: np.ndarray):
        self._lib = get_lib()
        self._vec = np.ascontiguousarray(vec, np.float64)
        self._vec_p = self._vec.ctypes.data_as(_D)
        self._vec_addr = self._vec.ctypes.data
        self._out = np.zeros(6, np.float64)
        self._out_p = self._out.ctypes.data_as(_D)
        self._ext = _get_ext()

    def sgp4(self, tsince_min: float):
        """Returns (error, (rx, ry, rz), (vx, vy, vz))."""
        if self._ext is not None:
            return self._ext.propagate(self._vec_addr, tsince_min)
        e = self._lib.astroz_scalar_sgp4(self._vec_p, tsince_min,
                                         self._out_p)
        o = self._out
        return e, (o[0], o[1], o[2]), (o[3], o[4], o[5])

    def sgp4_array(self, tsince_min: np.ndarray):
        """Vectorized loop over a tsince array (one native crossing)."""
        t = np.ascontiguousarray(tsince_min, np.float64)
        n = t.shape[0]
        out = np.empty((n, 6), np.float64)
        err = np.empty(n, np.int32)
        self._lib.astroz_scalar_sgp4_array(
            self._vec_p, t.ctypes.data_as(_D), n, out.ctypes.data_as(_D),
            err.ctypes.data_as(_I))
        return err, out[:, :3], out[:, 3:]


def scalar_engine(sat) -> ScalarEngine:
    """A native scalar engine for an initialized ``ops.scalar.Sat``."""
    return ScalarEngine(pack_scalar_sat(sat))


def sgp4_grid(vecs: np.ndarray, tsince: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(n_sats, n_times) grid in one native crossing a thread.

    ``vecs`` is the packed element matrix ``(n_sats, len(SCALAR_FIELDS))``
    (rows from :func:`pack_scalar_sat`); ``tsince`` is ``(n_sats,
    n_times)`` minutes past each satellite's epoch. Returns ``(err, r,
    v)`` shaped ``(n_sats, n_times)`` / ``(n_sats, n_times, 3)``; r and
    v are views into one interleaved buffer."""
    lib = get_lib()
    vecs = np.ascontiguousarray(vecs, np.float64)
    tsince = np.ascontiguousarray(tsince, np.float64)
    n_s, nf = vecs.shape
    n_t = tsince.shape[1]
    out = np.empty((n_s, n_t, 6), np.float64)
    err = np.empty((n_s, n_t), np.int32)

    def run(lo, hi):
        lib.astroz_sgp4_grid(
            vecs[lo:hi].ctypes.data_as(_D), hi - lo, nf,
            tsince[lo:hi].ctypes.data_as(_D), n_t,
            out[lo:hi].ctypes.data_as(_D), err[lo:hi].ctypes.data_as(_I))

    n_workers = min(os.cpu_count() or 1, n_s, 16)
    if n_workers > 1 and n_s * n_t >= 10_000:
        # disjoint satellite ranges of the shared buffers (ctypes
        # releases the GIL while each range runs)
        bounds = np.linspace(0, n_s, n_workers + 1).astype(int)
        with ThreadPoolExecutor(n_workers) as pool:
            futures = [pool.submit(run, int(lo), int(hi))
                       for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]
            for f in futures:
                f.result()
    else:
        run(0, n_s)
    return err, out[:, :, :3], out[:, :, 3:]


def sat_core(sat, jdsatepoch: float, jdsatepochF: float):
    """A ``SatCore`` of the extension: the all-C per-call propagator
    (tsince, propagate and the result tuple in one C round trip), or
    None when the extension did not build. The core copies the element
    vector, so nothing needs keeping alive."""
    ext = _get_ext()
    if ext is None:
        return None
    vec = np.ascontiguousarray(pack_scalar_sat(sat))
    return ext.SatCore(vec.ctypes.data, vec.shape[0], float(jdsatepoch),
                       float(jdsatepochF))
