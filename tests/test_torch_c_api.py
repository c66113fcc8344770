"""The port's C ABI (``astroz_tpu_torch/native/c_api.cpp``,
``astroz_c.h``) on the CPU: every case of ``tests/test_c_api.py``, run
against the port's library, and against the JAX package where both
compute the same thing.

Tolerances:

* ``sgp4_init`` writes the packed element vector of ``ops/scalar.py``'s
  ``sgp4init`` and ``native.pack_scalar_sat``, bit for bit (the port's
  init is compiled without FMA contraction; JAX's differs from its own
  Python init by ulps), so ``sgp4_propagate`` equals the native scalar
  engine on that vector bit for bit, and JAX's C ABI within 1e-9 km
  (km/s);
* against the Python scalar propagator (``ops/scalar.py``, both
  packages' copies): 1e-9 km, as ``tests/test_c_api.py`` gates it (the
  native engine's -O3 build contracts FMAs);
* ``sgp4_propagate_batch`` equals the native engine's array path
  (``ScalarEngine.sgp4_array``, the 8-wide SIMD block) bit for bit and
  the per-point path within 1e-9 km;
* the orbital and coordinate helpers: JAX's Python within 1e-12
  relative, the geodetic within 1e-6 (deg, km), GMST within 1e-9 rad, as
  ``tests/test_c_api.py`` has them; the ECEF rotation equals the port's
  ``frames.teme_to_ecef`` within 1e-12 relative.
"""

import ctypes
import json
import math
import subprocess

import numpy as np
import pytest
import torch

from astroz_tpu import native as jnative
from astroz_tpu.calculations import hohmann_transfer
from astroz_tpu.frames import ecef_to_geodetic_deg, teme_to_ecef
from astroz_tpu.ops import scalar as jsc
from astroz_tpu.time import gstime_scalar

from astroz_tpu_torch import frames as pframes
from astroz_tpu_torch import native as pnative
from astroz_tpu_torch import time as ptime
from astroz_tpu_torch import tle as ptle
from astroz_tpu_torch.ops import scalar as sc

from test_screening import synthetic_leo_text
from test_sdp4 import GEO_L1, GEO_L2, GPS_L1, GPS_L2, HEO_L1, HEO_L2
from test_sgp4 import ISS_L1, ISS_L2, TRAJ_L1, TRAJ_L2

_D3 = ctypes.c_double * 3

DEMO_L1 = ("1 25544U 98067A   24001.50000000  .00016717  00000-0"
           "  10270-3 0  9993")
DEMO_L2 = ("2 25544  51.6400 200.0000 0001234  90.0000 270.0000 "
           "15.50000000000017")


@pytest.fixture(scope="module")
def lib():
    return pnative.get_lib()


def _parse(lib, l1, l2):
    h = ctypes.c_void_p()
    assert lib.tle_parse(f"{l1}\n{l2}".encode(), ctypes.byref(h)) == 0
    return h


def _sgp4_init(lib, tle_h, grav=0):
    h = ctypes.c_void_p()
    assert lib.sgp4_init(tle_h, grav, ctypes.byref(h)) == 0
    return h


def _vector(sgp4_h):
    """The packed element vector behind an sgp4_init handle."""
    n = len(pnative.SCALAR_FIELDS)
    return np.ctypeslib.as_array(
        (ctypes.c_double * n).from_address(sgp4_h.value)).copy()


def _python_sat(scalar, l1, l2, grav):
    tle = next(ptle.iter_tles(f"{l1}\n{l2}"))
    return scalar.sgp4init(scalar.wgs72() if grav else scalar.wgs84(),
                           tle.epoch_jd, tle.bstar, tle.ecco, tle.argpo,
                           tle.inclo, tle.mo, tle.no_kozai, tle.nodeo)


def _jax_lib():
    lib = jnative.get_lib()
    lib.tle_parse.argtypes = [ctypes.c_char_p,
                              ctypes.POINTER(ctypes.c_void_p)]
    lib.sgp4_init.argtypes = [ctypes.c_void_p, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_void_p)]
    lib.sgp4_propagate.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                   ctypes.POINTER(ctypes.c_double),
                                   ctypes.POINTER(ctypes.c_double)]
    for f in ("tle_free", "sgp4_free"):
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    return lib


def test_version(lib):
    v = lib.astroz_version()
    assert (v >> 16, (v >> 8) & 0xFF, v & 0xFF) == (0, 1, 0)
    lib.astroz_init()
    lib.astroz_deinit()


def test_tle_parse_and_getters(lib):
    tle = next(ptle.iter_tles(f"{ISS_L1}\n{ISS_L2}"))
    h = _parse(lib, ISS_L1, ISS_L2)
    try:
        assert lib.tle_get_satellite_number(h) == tle.satnum == 25544
        assert lib.tle_get_epoch(h) == (tle.epoch_jd - 2451545.0) * 86400.0
        assert lib.tle_get_inclination(h) == pytest.approx(
            math.degrees(tle.inclo), rel=1e-15)
        assert lib.tle_get_eccentricity(h) == tle.ecco
        assert lib.tle_get_mean_motion(h) == pytest.approx(
            tle.no_kozai * 1440.0 / (2.0 * math.pi), rel=1e-15)
    finally:
        lib.tle_free(h)


def test_tle_parse_bad_input(lib):
    h = ctypes.c_void_p()
    assert lib.tle_parse(b"not a tle", ctypes.byref(h)) == -1
    assert lib.tle_parse(b"1 short\n2 short", ctypes.byref(h)) == -1
    assert lib.tle_parse(None, ctypes.byref(h)) == -101


@pytest.mark.parametrize("l1,l2,grav", [
    (ISS_L1, ISS_L2, 0), (TRAJ_L1, TRAJ_L2, 1),
    (GPS_L1, GPS_L2, 1), (GEO_L1, GEO_L2, 1), (HEO_L1, HEO_L2, 1),
])
def test_propagate_matches_python_scalar(lib, l1, l2, grav):
    """C-ABI init + propagate: the init vector equals the Python init's,
    bit for bit; each point equals the native engine on it bit for bit,
    both packages' Python scalar and JAX's C ABI within 1e-9. Deep-space
    lines (GPS/GEO/HEO) run SDP4, which the reference's C API refuses."""
    sat = _python_sat(sc, l1, l2, grav)
    jsat = _python_sat(jsc, l1, l2, grav)
    engine = pnative.scalar_engine(sat)
    jlib = _jax_lib()
    th, jth = _parse(lib, l1, l2), _parse(jlib, l1, l2)
    sh, jsh = _sgp4_init(lib, th, grav), _sgp4_init(jlib, jth, grav)
    pos, vel, jpos, jvel = _D3(), _D3(), _D3(), _D3()
    try:
        np.testing.assert_array_equal(_vector(sh),
                                      pnative.pack_scalar_sat(sat))
        for t in np.linspace(-720.0, 2880.0, 31):
            code = lib.sgp4_propagate(sh, float(t), pos, vel)
            e, r, v = engine.sgp4(float(t))
            assert (code == 0) == (e == 0)
            if e != 0:
                continue
            assert list(pos) + list(vel) == list(r) + list(v)
            jlib.sgp4_propagate(jsh, float(t), jpos, jvel)
            for ref in (sc.sgp4(sat, float(t)), jsc.sgp4(jsat, float(t)),
                        (0, list(jpos), list(jvel))):
                got = np.asarray(list(pos) + list(vel))
                want = np.asarray(list(ref[1]) + list(ref[2]))
                assert np.abs(got - want).max() < 1e-9, (t, ref)
    finally:
        lib.sgp4_free(sh)
        lib.tle_free(th)
        jlib.sgp4_free(jsh)
        jlib.tle_free(jth)


@pytest.mark.parametrize("l1,l2", [(ISS_L1, ISS_L2), (GEO_L1, GEO_L2)])
def test_propagate_batch(lib, l1, l2):
    """The batch equals the native engine's array path (the 8-wide SIMD
    block near earth, the scalar loop deep) bit for bit, and the
    per-point path within 1e-9 km (the SIMD block's FMA contraction)."""
    th = _parse(lib, l1, l2)
    sh = _sgp4_init(lib, th, 1)
    n = 17
    times = np.linspace(0.0, 360.0, n)
    results = np.zeros((n, 6))
    pos, vel = _D3(), _D3()
    try:
        assert lib.sgp4_propagate_batch(
            sh, times.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            results.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n) == 0
        err, r, v = pnative.scalar_engine(
            _python_sat(sc, l1, l2, 1)).sgp4_array(times)
        assert (err == 0).all()
        np.testing.assert_array_equal(results, np.concatenate([r, v], -1))
        for i in range(n):
            lib.sgp4_propagate(sh, times[i], pos, vel)
            assert np.abs(results[i] - np.asarray(
                list(pos) + list(vel))).max() < 1e-9
    finally:
        lib.sgp4_free(sh)
        lib.tle_free(th)


def test_hohmann_matches_python(lib):
    mu = 398600.4418
    r1, r2 = 6678.0, 42164.0
    out = pnative.HohmannResult()
    assert lib.orbital_hohmann(mu, r1, r2, ctypes.byref(out)) == 0
    dv1, dv2, tot, t = (float(x) for x in hohmann_transfer(r1, r2, mu))
    assert out.delta_v1 == pytest.approx(dv1, rel=1e-12)
    assert out.delta_v2 == pytest.approx(dv2, rel=1e-12)
    assert out.total_delta_v == pytest.approx(tot, rel=1e-12)
    assert out.transfer_time == pytest.approx(t, rel=1e-12)
    assert out.transfer_time_days == pytest.approx(t / 86400.0, rel=1e-12)
    assert out.semi_major_axis == pytest.approx(0.5 * (r1 + r2))
    # value errors match the reference guards
    assert lib.orbital_hohmann(mu, -1.0, r2, ctypes.byref(out)) == -20
    assert lib.orbital_hohmann(mu, r1, r1 + 500.0, ctypes.byref(out)) == -20


def test_orbital_scalars(lib):
    mu = 398600.4418
    assert lib.orbital_velocity(mu, 7000.0, 7000.0) == pytest.approx(
        math.sqrt(mu / 7000.0), rel=1e-15)
    assert lib.orbital_period(mu, 42164.0) == pytest.approx(
        2 * math.pi * math.sqrt(42164.0 ** 3 / mu), rel=1e-15)
    assert lib.orbital_escape_velocity(mu, 6378.137) == pytest.approx(
        math.sqrt(2 * mu / 6378.137), rel=1e-15)
    assert lib.orbital_velocity(mu, -1.0, 7000.0) == -1.0
    assert lib.orbital_period(mu, 0.0) == -1.0


def test_coords_match_python(lib):
    eci = _D3(6524.834, 6862.875, 6448.296)
    out = _D3()
    gmst = 1.2345
    lib.coords_eci_to_ecef(eci, gmst, out)
    ref = np.asarray(teme_to_ecef(np.array(list(eci)), gmst))
    np.testing.assert_allclose(list(out), ref, rtol=1e-12)
    pref = pframes.teme_to_ecef(torch.tensor(list(eci), dtype=torch.float64),
                                torch.tensor(gmst, dtype=torch.float64))
    np.testing.assert_allclose(list(out), pref.numpy(), rtol=1e-12)

    lla = _D3()
    lib.coords_ecef_to_geodetic(out, lla)
    ref_lla = np.asarray(ecef_to_geodetic_deg(np.array(list(out))))
    np.testing.assert_allclose(list(lla), ref_lla, rtol=0, atol=1e-6)
    plla = pframes.ecef_to_geodetic_deg(torch.tensor(list(out),
                                                     dtype=torch.float64))
    np.testing.assert_allclose(list(lla), plla.numpy(), rtol=0, atol=1e-6)

    jd = 2460310.5
    # 1e-9 rad: the Python gstime reduces the polynomial in another
    # association order (7e-12 rad apart at J2024)
    assert lib.coords_julian_to_gmst(jd) == pytest.approx(
        float(gstime_scalar(jd)), abs=1e-9)
    assert lib.coords_julian_to_gmst(jd) == pytest.approx(
        ptime.gstime_scalar(jd), abs=1e-9)
    assert lib.coords_julian_to_gmst(jd) == sc.gstime(jd)


def test_c_init_matches_python_pack_fuzz(lib):
    """The C++ sgp4_init writes the packed element vector of the Python
    sgp4init + pack_scalar_sat bit for bit, across real deep-space lines
    and a synthetic LEO catalog, under both gravity models."""
    text = "\n".join([ISS_L1, ISS_L2, GPS_L1, GPS_L2, GEO_L1, GEO_L2,
                      HEO_L1, HEO_L2, synthetic_leo_text(30)])
    n_checked = 0
    for tle in ptle.iter_tles(text):
        for grav in (0, 1):
            sat = _python_sat(sc, tle.line1, tle.line2, grav)
            th = _parse(lib, tle.line1, tle.line2)
            sh = _sgp4_init(lib, th, grav)
            try:
                np.testing.assert_array_equal(
                    _vector(sh), pnative.pack_scalar_sat(sat))
            finally:
                lib.sgp4_free(sh)
                lib.tle_free(th)
        n_checked += 1
    assert n_checked >= 30


def test_c_consumer_compiles_and_runs(lib, tmp_path):
    """Compile a C program against the port's astroz_c.h and run it
    linked to the port's library, by its hashed file name: the ABI from
    C, not just ctypes."""
    src = tmp_path / "demo.c"
    src.write_text(r'''
#define DEMO_LINES @LINES@
#include <stdio.h>
#include <math.h>
#include "astroz_c.h"

int main(void) {
    astroz_init();
    if (astroz_version() != ((0u<<16)|(1u<<8)|0u)) return 1;
    void *tle = 0, *sat = 0;
    if (tle_parse(DEMO_LINES, &tle) != ASTROZ_OK) return 2;
    if (tle_get_satellite_number(tle) != 25544u) return 3;
    if (sgp4_init(tle, 0, &sat) != ASTROZ_OK) return 4;
    double pos[3], vel[3];
    if (sgp4_propagate(sat, 360.0, pos, vel) != ASTROZ_OK) return 5;
    double r = sqrt(pos[0]*pos[0] + pos[1]*pos[1] + pos[2]*pos[2]);
    if (!(r > 6500.0 && r < 7100.0)) return 6;
    printf("%.17g %.17g %.17g\n", pos[0], pos[1], pos[2]);
    sgp4_free(sat);
    tle_free(tle);
    astroz_deinit();
    return 0;
}
'''.replace("@LINES@", json.dumps(f"{DEMO_L1}\n{DEMO_L2}")))
    so = pnative.library_path()
    exe = tmp_path / "demo"
    subprocess.run(
        ["gcc", str(src), f"-I{pnative.HEADER.parent}", f"-L{so.parent}",
         f"-l:{so.name}", f"-Wl,-rpath,{so.parent}", "-lm", "-o", str(exe)],
        check=True, capture_output=True, timeout=60)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         timeout=30, text=True)
    got = [float(x) for x in out.stdout.split()]
    th = _parse(lib, DEMO_L1, DEMO_L2)
    sh = _sgp4_init(lib, th, 0)
    pos, vel = _D3(), _D3()
    try:
        assert lib.sgp4_propagate(sh, 360.0, pos, vel) == 0
        assert got == list(pos)  # %.17g round-trips a double
    finally:
        lib.sgp4_free(sh)
        lib.tle_free(th)
