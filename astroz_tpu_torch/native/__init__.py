"""The port's native (C++) runtime, bound with ctypes.

Counterpart of ``astroz_tpu/native/``. One shared library is built from
four sources, as the JAX package builds its own:

* ``tle_parser.cpp``: the bulk TLE parser (:func:`parse_catalog`), the
  route of ``TleArrays.from_text`` and of ``build_catalog`` on two-line
  text; its columns equal the Python parser's (``tle.py``) bit for bit;
* ``frame_scanner.cpp``: the CCSDS / VITA-49 frame scanner
  (:func:`scan_frames`), the route of ``io.Parser.iter_frames`` on large
  buffers;
* ``scalar_sgp4.cpp``: the scalar SGP4/SDP4 host engine; it propagates
  one packed element vector (``SCALAR_FIELDS``, laid out by
  ``scalar_fields.h``) to one time, to a time array (an 8-wide SIMD
  block for near-earth lanes), or over an (n_sats, n_times) grid
  (:func:`sgp4_grid`); ``api.Satrec`` routes single-point calls here;
* ``c_api.cpp``: the C ABI for callers outside Python, declared in
  ``astroz_c.h`` (:data:`HEADER`); a C program links the library at
  :func:`library_path`.

``scalar_ext.c`` is a CPython extension whose ``SatCore`` runs a whole
``Satrec.sgp4(jd, fr)`` call in C.

Both are built with g++ at first use, never at import, into
``native/build/`` (listed in ``.gitignore``), and rebuilt when the hash
of the sources, the flags or (for the extension) the Python ABI changes.
The library is required: a failed build raises ``RuntimeError`` with
g++'s output, and nothing falls back to Python. The extension is
optional: a failed build is reported once on stderr and single-point
calls take the ctypes path. The library and the module keep names of
their own (``libastroz_torch_native``, ``_astroz_torch_scalar``) and
are loaded with ``RTLD_LOCAL`` (ctypes' and the import system's
default), so that they load beside the JAX package's, which exports the
same C names.
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
#: the C ABI's public header (declarations of ``c_api.cpp``)
HEADER = _DIR / "astroz_c.h"
_HEADERS = (_DIR / "scalar_fields.h", HEADER)
_SRC = _DIR / "scalar_sgp4.cpp"
_SOURCES = (_SRC, _DIR / "tle_parser.cpp", _DIR / "frame_scanner.cpp",
            _DIR / "c_api.cpp")
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

N_COLS = 12  # must match tle_parser.cpp's Col enum

_D = ctypes.POINTER(ctypes.c_double)
_I = ctypes.POINTER(ctypes.c_int)
_L = ctypes.c_longlong
_LP = ctypes.POINTER(ctypes.c_longlong)
_H = ctypes.c_void_p
_F = ctypes.c_double


class HohmannResult(ctypes.Structure):
    """``AstrozHohmannResult`` of ``astroz_c.h``."""

    _fields_ = [("semi_major_axis", _F), ("delta_v1", _F),
                ("delta_v2", _F), ("total_delta_v", _F),
                ("transfer_time", _F), ("transfer_time_days", _F)]


#: exported C functions: name -> (restype, argtypes)
SIGNATURES = {
    "astroz_scalar_sgp4": (ctypes.c_int, [_D, _F, _D]),
    "astroz_scalar_sgp4_array": (_L, [_D, _D, _L, _D, _I]),
    "astroz_sgp4_grid": (_L, [_D, _L, _L, _D, _L, _D, _I]),
    "astroz_parse_catalog": (ctypes.c_int,
                             [ctypes.c_char_p, _L, _D, _LP, _L, _L]),
    "astroz_scan_ccsds": (_L, [ctypes.c_char_p, _L, ctypes.c_char_p, _L,
                               _LP, _LP, _L]),
    "astroz_scan_vita49": (_L, [ctypes.c_char_p, _L, ctypes.c_char_p, _L,
                                _LP, _LP, _L]),
    # the C ABI (astroz_c.h)
    "astroz_version": (ctypes.c_uint, []),
    "astroz_init": (None, []),
    "astroz_deinit": (None, []),
    "tle_parse": (ctypes.c_int, [ctypes.c_char_p, ctypes.POINTER(_H)]),
    "tle_free": (None, [_H]),
    "tle_get_satellite_number": (ctypes.c_uint, [_H]),
    "tle_get_epoch": (_F, [_H]),
    "tle_get_inclination": (_F, [_H]),
    "tle_get_eccentricity": (_F, [_H]),
    "tle_get_mean_motion": (_F, [_H]),
    "sgp4_init": (ctypes.c_int, [_H, ctypes.c_int, ctypes.POINTER(_H)]),
    "sgp4_free": (None, [_H]),
    "sgp4_propagate": (ctypes.c_int, [_H, _F, _D, _D]),
    "sgp4_propagate_batch": (ctypes.c_int, [_H, _D, _D, ctypes.c_uint]),
    "orbital_hohmann": (ctypes.c_int,
                        [_F, _F, _F, ctypes.POINTER(HohmannResult)]),
    "orbital_velocity": (_F, [_F, _F, _F]),
    "orbital_period": (_F, [_F, _F]),
    "orbital_escape_velocity": (_F, [_F, _F]),
    "coords_eci_to_ecef": (None, [_D, _F, _D]),
    "coords_ecef_to_geodetic": (None, [_D, _D]),
    "coords_julian_to_gmst": (_F, [_F]),
}


def _target(stem: str, sources, extra: str = "") -> Path:
    h = hashlib.sha256(" ".join(BUILD_FLAGS).encode() + extra.encode())
    for p in (*sources, *_HEADERS):
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
    """Where the library for the current sources and flags lives (built
    by :func:`get_lib`); a C program links it with :data:`HEADER`."""
    return _target("libastroz_torch_native", _SOURCES)


def _ext_path() -> Path:
    return _target(_EXT_NAME, (_SRC_EXT, _SRC),
                   sys.version + str(sysconfig.get_config_var("EXT_SUFFIX")))


def get_lib() -> ctypes.CDLL:
    """The built and bound library (built on the first call); raises
    ``RuntimeError`` with g++'s output when it does not build."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            out = library_path()
            if not out.exists():
                try:
                    _compile(out, [str(p) for p in _SOURCES])
                except (OSError, subprocess.SubprocessError) as exc:
                    raise RuntimeError(
                        "the native library did not build: "
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


def parse_catalog(text: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse TLE / 3LE catalog text natively.

    Returns ``(cols, satnums)``: ``cols`` f64 ``(N_COLS, n)`` in
    ``TleArrays``' column order (epoch_jd, jdsatepoch, jdsatepochF,
    no_kozai, ecco, inclo, nodeo, argpo, mo, bstar, ndot, nddot),
    ``satnums`` int64 ``(n,)``. Records the Python parser would skip are
    skipped; names are not kept."""
    lib = get_lib()
    data = text.encode("utf-8", errors="replace")
    # every pair of lines could be one satellite
    max_sats = data.count(b"\n") // 2 + 1
    cols = np.zeros((N_COLS, max_sats), np.float64)
    satnums = np.zeros(max_sats, np.int64)
    n = lib.astroz_parse_catalog(data, len(data), cols.ctypes.data_as(_D),
                                 satnums.ctypes.data_as(_LP), max_sats,
                                 max_sats)
    return cols[:, :n].copy(), satnums[:n].copy()


def scan_frames(kind: str, data: bytes,
                sync_pattern: Optional[bytes] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Frame boundaries in a telemetry buffer, found natively.

    ``kind`` is ``"ccsds"`` or ``"vita49"``. Returns ``(offsets,
    lengths)`` int64 arrays of the frames that ``io.Parser``'s Python
    walk finds: with a sync pattern, the frame after each occurrence;
    without one, a frame at every position that parses, else one byte
    on (validation mirrors ``io.Ccsds.parse`` / ``io.Vita49.parse``)."""
    names = {"ccsds": "astroz_scan_ccsds", "vita49": "astroz_scan_vita49"}
    if kind not in names:
        raise ValueError(f"unknown frame kind {kind!r}")
    fn = getattr(get_lib(), names[kind])
    data = bytes(data)
    sync = bytes(sync_pattern or b"")
    # every frame holds at least a 4-byte header
    max_frames = len(data) // 4 + 1
    offsets = np.zeros(max_frames, np.int64)
    lengths = np.zeros(max_frames, np.int64)
    n = fn(data, len(data), sync, len(sync), offsets.ctypes.data_as(_LP),
           lengths.ctypes.data_as(_LP), max_frames)
    return offsets[:n].copy(), lengths[:n].copy()


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
