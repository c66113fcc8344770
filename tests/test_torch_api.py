"""The python-sgp4 drop-in API of astroz_tpu_torch (``api.py``), its host
scalar engines (``ops/scalar.py``, ``native/``) and the tensor init entry
points, on the CPU (``device="cpu"``), against astroz_tpu on the same
inputs.

* Every case of ``tests/test_api.py``, run against the port.
* Cross-package, with the tolerances stated:
  - Satrec properties from ``twoline2rv``: equal; from ``sgp4init``,
    whose JAX init is jitted (XLA rounds its fusions differently from
    numpy): within 1e-12 relative or 1e-10 absolute (measured 2.9e-11,
    on ``xlamo``);
  - ``Satrec.sgp4`` / ``sgp4_tsince`` on each host engine (the Python
    scalar, the native ctypes engine, the native core): equal, bit for
    bit (the same code and the same g++ flags);
  - ``SatrecArray.sgp4`` with the native grid off on both sides (the
    port runs K1-K3's plain versions): 0.05 km and 5e-5 km/s of JAX's
    fast path (PERF.md §2), identical error codes; positions without
    velocities against JAX's with velocities;
  - the time-as-lanes path (``_on_accel`` on both sides) and
    ``create_sgp4_propagator``: 2e-7 km and 3e-10 km/s, the repo's f64
    gate;
  - ``ops.sgp4_init`` / ``ops.sdp4_init``: equal, field by field, to
    JAX's ``sgp4_init_np`` / ``sdp4_init_np`` (the same init formulas,
    which its ``build_catalog`` runs), and within the sgp4init tolerance
    above of its jitted ``sgp4_init`` / ``sdp4_init``.
* The native engine against ``ops/scalar.py`` (the gates of
  ``tests/test_native.py``), its SIMD array path, its SatCore and its
  threaded grid.
* ``torch.func``: ``jacrev`` of r within 1e-6 relative of a central
  difference (h = 1e-3 min); ``vmap`` equal to the loop, near-earth and
  deep, with and without ``max_steps``; on deep TLEs without
  ``max_steps``, ``vmap`` and ``jacrev`` against JAX's ``jax.vmap`` and
  ``jax.jacrev`` (the f64 gate; 1e-9 relative on dr/dt).
"""

import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import astroz_tpu.api as japi
from astroz_tpu import native as jnative
from astroz_tpu import tle as jtle
from astroz_tpu.constants import WGS72 as J_WGS72
from astroz_tpu.ops.sdp4 import sdp4_init as j_sdp4_init
from astroz_tpu.ops.sdp4 import sdp4_init_np as j_sdp4_init_np
from astroz_tpu.ops.sgp4 import sgp4_init as j_sgp4_init
from astroz_tpu.ops.sgp4 import sgp4_init_np as j_sgp4_init_np

import astroz_tpu_torch.api as papi
from astroz_tpu_torch import Constellation, native as pnative
from astroz_tpu_torch import ops as pops
from astroz_tpu_torch.api import (Satrec, SatrecArray, WGS72, WGS84,
                                  create_sgp4_propagator, days2mdhms, jday)
from astroz_tpu_torch.constants import WGS72 as P_WGS72
from astroz_tpu_torch.ops import scalar as sc

from test_propagation import MIXED_TEXT as CON_TEXT
from test_sdp4 import GEO_L1, GEO_L2, GPS_L1, GPS_L2, HEO_L1, HEO_L2
from test_sgp4 import ISS_L1, ISS_L2, TRAJ_L1, TRAJ_L2, TRAJ_REF
from test_torch_fast import jax_drag_fixed  # noqa: F401  (fixture)
from test_torch_mixed import jax_fixed  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

#: a decaying ISS: bstar 999.99 -> error 1 within a day
DECAY_L1 = ("1 25544U 98067A   24001.50000000  .00016717  00000-0  99999+2 0"
            "  9999")
TLES = {"iss": (ISS_L1, ISS_L2), "traj": (TRAJ_L1, TRAJ_L2),
        "gps": (GPS_L1, GPS_L2), "geo": (GEO_L1, GEO_L2),
        "heo": (HEO_L1, HEO_L2), "decay": (DECAY_L1, TRAJ_L2)}

POS_TOL_KM = 0.05
VEL_TOL_KMS = 5e-5
F64_POS_KM = 2e-7
F64_VEL_KMS = 3e-10
#: port (numpy) init vs JAX's jitted init
INIT_RTOL = 1e-12
INIT_ATOL = 1e-10

ATTRS = ("satnum", "jdsatepoch", "jdsatepochF", "epochyr", "epochdays",
         "ndot", "nddot", "bstar", "inclo", "nodeo", "ecco", "argpo", "mo",
         "no_kozai", "no_unkozai", "no", "a", "alta", "altp", "error", "t",
         "method", "operationmode", "classification", "intldesg", "elnum",
         "revnum", "ephtype", "gsto", "mdot", "argpdot", "nodedot",
         "is_deep_space")


def psat(l1, l2, grav=WGS72):
    return Satrec.twoline2rv(l1, l2, grav, device="cpu")


# ---------------------------------------------------------------------------
# tests/test_api.py, run against the port
# ---------------------------------------------------------------------------


def test_jday_matches_python_sgp4_convention():
    jd, fr = jday(2024, 1, 1, 12, 0, 0.0)
    assert jd == 2460310.5
    assert fr == 0.5


def test_days2mdhms():
    mon, day, hr, minute, sec = days2mdhms(2024, 127.82853009)
    assert (mon, day) == (5, 6)
    assert hr == 19
    assert minute == 53
    assert abs(sec - 4.999776) < 1e-3


def test_twoline2rv_properties():
    sat = psat(ISS_L1, ISS_L2, WGS84)
    assert sat.satnum == 25544
    assert abs(sat.no_kozai - 0.06767329492593213) < 1e-14
    assert abs(sat.ecco - 0.0003580) < 1e-12
    assert sat.epochyr == 24
    assert not sat.is_deep_space
    assert sat.method == "n"
    assert sat.error == 0
    assert sat.classification == "U"
    assert sat.intldesg == "98067A"


def test_sgp4_golden_trajectory():
    sat = psat(TRAJ_L1, TRAJ_L2)
    for t_min, r_ref, v_ref in TRAJ_REF:
        jd = sat.jdsatepoch
        fr = sat.jdsatepochF + t_min / 1440.0
        e, r, v = sat.sgp4(jd, fr)
        assert e == 0
        assert np.linalg.norm(np.subtract(r, r_ref)) < 0.1
        assert np.linalg.norm(np.subtract(v, v_ref)) < 1e-4
        assert abs(sat.t - t_min) < 1e-9


def test_sgp4_tsince():
    sat = psat(TRAJ_L1, TRAJ_L2)
    e, r, v = sat.sgp4_tsince(360.0)
    assert e == 0
    assert np.linalg.norm(np.subtract(r, TRAJ_REF[6][1])) < 0.1


def test_sgp4_array_single_sat():
    sat = psat(TRAJ_L1, TRAJ_L2)
    times = np.array([row[0] for row in TRAJ_REF])
    jd = np.full_like(times, sat.jdsatepoch)
    fr = sat.jdsatepochF + times / 1440.0
    e, r, v = sat.sgp4_array(jd, fr)
    assert r.shape == (len(times), 3)
    for i, (_, r_ref, _) in enumerate(TRAJ_REF):
        assert np.linalg.norm(r[i] - r_ref) < 0.1


@pytest.mark.parametrize("native_grid", [True, False])
def test_satrec_array_mixed(monkeypatch, native_grid):
    """The native grid and, with it off, the catalog path (the plain
    versions of K2, the escape and K3)."""
    if not native_grid:
        monkeypatch.setattr(SatrecArray, "_sgp4_native",
                            lambda self, jd, fr: None)
    sats = [psat(TRAJ_L1, TRAJ_L2), psat(GEO_L1, GEO_L2)]
    arr = SatrecArray(sats)
    times = np.array([0.0, 360.0, 720.0])
    jd = np.full_like(times, sats[0].jdsatepoch)
    fr = sats[0].jdsatepochF + times / 1440.0
    e, r, v = arr.sgp4(jd, fr)
    assert e.shape == (2, 3)
    assert r.shape == (2, 3, 3)
    assert r.dtype == v.dtype == np.float64
    assert np.all(e == 0)
    assert np.linalg.norm(r[0, 0] - TRAJ_REF[0][1]) < 0.1
    assert np.linalg.norm(r[0, 1] - TRAJ_REF[6][1]) < 0.1
    assert 42000 < np.linalg.norm(r[1, 0]) < 42400
    e2, r2 = arr.sgp4(jd, fr, velocities=False)
    np.testing.assert_allclose(r2, r, atol=1e-9)


def test_sgp4init_elementwise():
    sat_tle = psat(TRAJ_L1, TRAJ_L2)
    epoch_1949 = sat_tle.jdsatepoch + sat_tle.jdsatepochF - 2433281.5
    sat = Satrec()
    ret = sat.sgp4init(
        WGS72, "i", 25544, epoch_1949, sat_tle.bstar, 0.0, 0.0,
        sat_tle.ecco, sat_tle.argpo, sat_tle.inclo, sat_tle.mo,
        sat_tle.no_kozai, sat_tle.nodeo, device="cpu")
    assert ret is sat
    assert sat.error == 0
    jd, fr = sat_tle.jdsatepoch, sat_tle.jdsatepochF + 0.25
    e1, r1, v1 = sat_tle.sgp4(jd, fr)
    e2, r2, v2 = sat.sgp4(jd, fr)
    assert np.linalg.norm(np.subtract(r1, r2)) < 1e-6


def test_sgp4init_after_sgp4_rebinds_core():
    """An in-place ``sgp4init`` after a propagate call drops the bound
    native core (a copy of the old element vector that shadows
    ``sgp4``)."""
    sat = psat(TRAJ_L1, TRAJ_L2)
    jd, fr = sat.jdsatepoch, sat.jdsatepochF
    e1, r1, v1 = sat.sgp4(jd, fr)
    assert e1 == 0
    assert np.linalg.norm(r1) < 8000
    epoch_1949 = jd + fr - 2433281.5
    sat.sgp4init(WGS72, "i", 99999, epoch_1949, 0.0, 0.0, 0.0,
                 2e-4, 1.0, 0.01, 2.0, 0.004375, 1.0, device="cpu")
    e2, r2, v2 = sat.sgp4(jd, fr)
    assert e2 == 0
    assert np.linalg.norm(r2) > 40000, "stale pre-init elements served"
    e3, r3, v3 = sat.sgp4(jd, fr)
    np.testing.assert_allclose(r3, r2, atol=1e-9)


def test_decay_error_code():
    sat = psat(DECAY_L1, TRAJ_L2)
    e, r, v = sat.sgp4(sat.jdsatepoch + 1.0, sat.jdsatepochF)
    assert e != 0
    assert r == (0.0, 0.0, 0.0)


def test_python_sgp4_attribute_parity():
    sat = psat(TRAJ_L1, TRAJ_L2)
    for attr in ATTRS:
        assert hasattr(sat, attr), attr
        getattr(sat, attr)


@pytest.mark.parametrize("lanes", [False, True])
def test_sgp4_array_large_lanes_path(monkeypatch, lanes):
    """>= 4096 times: on an accelerator (``_on_accel``) the time-as-lanes
    f64 path (here from the reference's 4,096 times on), else the native
    array engine; either matches the small path within 2e-6 km."""
    if lanes:
        monkeypatch.setattr(Satrec, "_on_accel", lambda self: True)
        monkeypatch.setattr(papi, "_LANES_MIN_TIMES",
                            {False: 4096, True: 4096})
    sat = psat(TRAJ_L1, TRAJ_L2)
    n = 5000
    times = np.linspace(0.0, 1440.0, n)
    jd = np.full(n, sat.jdsatepoch)
    fr = sat.jdsatepochF + times / 1440.0
    e, r, v = sat.sgp4_array(jd, fr)
    assert r.shape == (n, 3) and np.all(e == 0)
    e2, r2, v2 = sat.sgp4_array(jd[::100], fr[::100])
    np.testing.assert_allclose(r[::100], r2, atol=2e-6)

    g = psat(GEO_L1, GEO_L2)
    jd = np.full(4608, g.jdsatepoch)
    fr = g.jdsatepochF + np.linspace(0, 1, 4608)
    e, r, v = g.sgp4_array(jd, fr)
    assert np.all(e == 0)
    rn = np.linalg.norm(r, axis=-1)
    assert 42000 < rn.min() < rn.max() < 42400


def test_sgp4_array_lanes_threshold_by_regime(monkeypatch):
    """On an accelerator ``sgp4_array`` takes time as lanes from the
    threshold of the satrec's regime on (near-earth or deep), else the
    native array engine."""
    monkeypatch.setattr(Satrec, "_on_accel", lambda self: True)
    monkeypatch.setattr(papi, "_LANES_MIN_TIMES", {False: 64, True: 128})
    taken = []
    lanes = Satrec._sgp4_lanes
    monkeypatch.setattr(Satrec, "_sgp4_lanes", lambda self, jd, fr: (
        taken.append((self.is_deep_space, len(jd))) or lanes(self, jd, fr)))
    for l1, l2 in ((ISS_L1, ISS_L2), (GEO_L1, GEO_L2)):
        sat = psat(l1, l2)
        for n in (63, 64, 127, 128):
            e, r, v = sat.sgp4_array(np.full(n, sat.jdsatepoch),
                                     np.full(n, sat.jdsatepochF))
            assert r.shape == (n, 3) and np.all(e == 0)
    assert taken == [(False, 64), (False, 127), (False, 128), (True, 128)]


def test_create_sgp4_propagator_astrojax_style():
    params, fn = create_sgp4_propagator(ISS_L1, ISS_L2, device="cpu")
    t = torch.linspace(0.0, 1440.0, 5, dtype=torch.float64)
    r, v = fn(params, t)
    assert tuple(r.shape) == (5, 3) and tuple(v.shape) == (5, 3)
    sat = psat(ISS_L1, ISS_L2)
    _, r0, v0 = sat.sgp4_tsince(720.0)
    d = np.linalg.norm(r[2].numpy() - np.asarray(r0))
    assert d < 1e-6, d


@pytest.mark.parametrize("native_grid", [True, False])
def test_satrec_array_sgp4_into(monkeypatch, native_grid):
    if not native_grid:
        monkeypatch.setattr(SatrecArray, "_sgp4_native",
                            lambda self, jd, fr: None)
    sats = [psat(ISS_L1, ISS_L2), psat(TRAJ_L1, TRAJ_L2)]
    arr = SatrecArray(sats)
    jd = np.full(5, sats[0].jdsatepoch)
    fr = sats[0].jdsatepochF + np.linspace(0.0, 1.0, 5)
    e_ref, r_ref, v_ref = arr.sgp4(jd, fr)
    r_out = np.zeros((2, 5, 3))
    v_out = np.zeros((2, 5, 3))
    e_out = np.zeros((2, 5), np.int32)
    arr.sgp4_into(jd, fr, r_out, v_out, e_out)
    np.testing.assert_array_equal(r_out, r_ref)
    np.testing.assert_array_equal(v_out, v_ref)
    np.testing.assert_array_equal(e_out, e_ref)


def test_satrec_array_mixed_gravity_device_path(monkeypatch):
    """Each satellite propagates under its own gravity model on the
    catalog path too: one propagate a model."""
    s72 = psat(ISS_L1, ISS_L2, WGS72)
    s84 = psat(ISS_L1, ISS_L2, WGS84)
    arr = SatrecArray([s72, s84])
    assert arr._grav_groups is not None
    monkeypatch.setattr(SatrecArray, "_sgp4_native",
                        lambda self, jd, fr: None)
    jd0, fr0 = jday(2024, 5, 7, 0, 0, 0.0)
    jds = np.full(5, jd0)
    frs = fr0 + np.arange(5) / 48.0
    e, r, v = arr.sgp4(jds, frs)
    assert not e.any()
    e72, r72, _ = SatrecArray([s72]).sgp4(jds, frs)
    e84, r84, _ = SatrecArray([s84]).sgp4(jds, frs)
    np.testing.assert_allclose(r[0], r72[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(r[1], r84[0], rtol=0, atol=1e-6)
    assert np.abs(r[0] - r[1]).max() > 1e-3
    assert len(arr.catalog) == 2


# ---------------------------------------------------------------------------
# cross-package: the port against astroz_tpu on the same inputs
# ---------------------------------------------------------------------------


def _sgp4init_args(l1, l2):
    s = japi.Satrec.twoline2rv(l1, l2, japi.WGS72)
    epoch = s.jdsatepoch + s.jdsatepochF - 2433281.5
    return (WGS72, "i", 12345, epoch, s.bstar, 0.0, 0.0, s.ecco, s.argpo,
            s.inclo, s.mo, s.no_kozai, s.nodeo)


@pytest.mark.parametrize("grav", [WGS72, WGS84])
@pytest.mark.parametrize("name", sorted(TLES))
def test_properties_match_jax(name, grav):
    l1, l2 = TLES[name]
    j = japi.Satrec.twoline2rv(l1, l2, grav)
    p = psat(l1, l2, grav)
    for attr in ATTRS:
        assert getattr(p, attr) == getattr(j, attr), attr
    # element-wise init: JAX's is jitted
    args = _sgp4init_args(l1, l2)
    j = japi.Satrec().sgp4init(*args)
    p = Satrec().sgp4init(*args, device="cpu")
    for attr in ATTRS:
        a, b = getattr(p, attr), getattr(j, attr)
        if isinstance(a, float):
            np.testing.assert_allclose(a, b, rtol=INIT_RTOL, atol=INIT_ATOL,
                                       err_msg=attr)
        else:
            assert a == b, attr


def _pin_engine(monkeypatch, engine):
    """Make both packages' Satrecs bind one host engine: ``python``
    (ops/scalar.py), ``ctypes`` (the native library through ctypes) or
    ``core`` (the CPython extension's SatCore)."""
    for nat in (jnative, pnative):
        if engine == "python":
            monkeypatch.setattr(nat, "scalar_engine", lambda sat: None)
        if engine != "core":
            monkeypatch.setattr(nat, "sat_core", lambda *a: None)
        if engine == "ctypes":
            monkeypatch.setattr(nat, "_get_ext", lambda: None)


@pytest.mark.parametrize("engine", ["python", "ctypes", "core"])
@pytest.mark.parametrize("name", sorted(TLES))
def test_single_point_engines_match_jax(monkeypatch, name, engine):
    _pin_engine(monkeypatch, engine)
    l1, l2 = TLES[name]
    j = japi.Satrec.twoline2rv(l1, l2, japi.WGS72)
    p = psat(l1, l2)
    for k, t in enumerate((0.0, -1440.0, -100.5, 360.0, 1440.0, 4000.0)):
        fr = p.jdsatepochF + t / 1440.0
        got, want = p.sgp4(p.jdsatepoch, fr), j.sgp4(j.jdsatepoch, fr)
        assert got == want, (t, got, want)
        assert (p.t, p.error) == (j.t, j.error)
        assert p.sgp4_tsince(t) == j.sgp4_tsince(t)
        if k == 0:
            bound = {"python": p._scalar_native is None,
                     "ctypes": p._scalar_native is not None
                     and p._scalar_native._ext is None
                     and p._core is None,
                     "core": "sgp4" in p.__dict__}[engine]
            assert bound, engine


def _mixed_arrays():
    names = ("iss", "traj", "gps", "geo", "heo", "decay")
    return (japi.SatrecArray([japi.Satrec.twoline2rv(*TLES[n])
                              for n in names]),
            SatrecArray([psat(*TLES[n]) for n in names]))


def test_satrec_array_device_path_matches_jax(monkeypatch, jax_fixed):
    """The catalog path (native grid off on both sides): the port's
    plain K1-K3 versions against JAX's fast path on XLA:CPU."""
    for cls in (japi.SatrecArray, SatrecArray):
        monkeypatch.setattr(cls, "_sgp4_native", lambda self, jd, fr: None)
    jarr, parr = _mixed_arrays()
    sat0 = parr._satrecs[0]
    t = np.linspace(-250.0, 2000.0, 9)
    jd = np.full(len(t), sat0.jdsatepoch)
    fr = sat0.jdsatepochF + t / 1440.0
    ej, rj, vj = jarr.sgp4(jd, fr)
    ep, rp, vp = parr.sgp4(jd, fr)
    assert rp.dtype == vp.dtype == np.float64 and rp.shape == (6, 9, 3)
    np.testing.assert_array_equal(ep, ej)
    assert set(np.unique(ep)) >= {0, 1}
    np.testing.assert_allclose(rp, rj, rtol=0, atol=POS_TOL_KM)
    np.testing.assert_allclose(vp, vj, rtol=0, atol=VEL_TOL_KMS)
    ep2, rp2 = parr.sgp4(jd, fr, velocities=False)
    np.testing.assert_array_equal(ep2, ej)
    np.testing.assert_allclose(rp2, rj, rtol=0, atol=POS_TOL_KM)


def test_satrec_array_native_grid_matches_jax():
    """The native grid, including the zero-filled decayed lane: the same
    engine on both sides."""
    jarr, parr = _mixed_arrays()
    sat0 = parr._satrecs[0]
    jd = np.full(7, sat0.jdsatepoch)
    fr = sat0.jdsatepochF + np.linspace(-0.5, 3.0, 7)
    for got, want in zip(parr.sgp4(jd, fr), jarr.sgp4(jd, fr)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("name,n", [("iss", 5000), ("geo", 4608)])
def test_time_as_lanes_matches_jax(monkeypatch, name, n):
    monkeypatch.setattr(japi.Satrec, "_on_accel", staticmethod(lambda: True))
    monkeypatch.setattr(Satrec, "_on_accel", lambda self: True)
    monkeypatch.setattr(papi, "_LANES_MIN_TIMES", {False: 4096, True: 4096})
    j = japi.Satrec.twoline2rv(*TLES[name])
    p = psat(*TLES[name])
    jd = np.full(n, p.jdsatepoch)
    fr = p.jdsatepochF + np.linspace(-1.0, 2.0, n)
    ej, rj, vj = j.sgp4_array(jd, fr)
    ep, rp, vp = p.sgp4_array(jd, fr)
    assert rp.shape == (n, 3) and rp.dtype == np.float64
    np.testing.assert_array_equal(ep, ej)
    np.testing.assert_allclose(rp, rj, rtol=0, atol=F64_POS_KM)
    np.testing.assert_allclose(vp, vj, rtol=0, atol=F64_VEL_KMS)


@pytest.mark.parametrize("name", ["iss", "geo", "heo"])
def test_create_sgp4_propagator_matches_jax(name):
    jparams, jfn = japi.create_sgp4_propagator(*TLES[name])
    pparams, pfn = create_sgp4_propagator(*TLES[name], device="cpu")
    t = np.linspace(-1440.0, 2880.0, 7)
    rj, vj = jfn(jparams, jnp.asarray(t))
    rp, vp = pfn(pparams, torch.as_tensor(t))
    assert rp.dtype == torch.float64 and tuple(rp.shape) == (7, 3)
    np.testing.assert_allclose(rp.numpy(), np.asarray(rj), rtol=0,
                               atol=F64_POS_KM)
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), rtol=0,
                               atol=F64_VEL_KMS)


def _init_inputs():
    text = "\n".join(f"{a}\n{b}" for a, b in TLES.values())
    a = jtle.TleArrays.from_tles(list(jtle.iter_tles(text)))
    return dict(no_kozai=a.no_kozai, ecco=a.ecco, inclo=a.inclo,
                nodeo=a.nodeo, argpo=a.argpo, mo=a.mo, bstar=a.bstar,
                epoch_jd=a.epoch_jd)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_init_entry_points_match_jax(as_tensor):
    kw = _init_inputs()
    if as_tensor:
        kw = {k: torch.as_tensor(v) for k, v in kw.items()}
    els = pops.sgp4_init(P_WGS72, **kw, device="cpu")
    deep = pops.sdp4_init(P_WGS72, els, device="cpu")
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
               for x in (*els, *deep))
    assert bool(els.is_deep.any()) and bool((deep.irez != 0).any())
    host = _init_inputs()
    want_np = j_sgp4_init_np(J_WGS72, **host)
    want_jit = j_sgp4_init(J_WGS72, **host)
    for f, got, a, b in zip(els._fields, els, want_np, want_jit):
        np.testing.assert_array_equal(got.numpy(), np.asarray(a),
                                      err_msg=f)
        np.testing.assert_allclose(got.numpy(), np.asarray(b),
                                   rtol=INIT_RTOL, atol=INIT_ATOL,
                                   err_msg=f)
    want_np = j_sdp4_init_np(J_WGS72, want_np)
    want_jit = j_sdp4_init(J_WGS72, want_jit)
    for f, got, a, b in zip(deep._fields, deep, want_np, want_jit):
        np.testing.assert_array_equal(got.numpy(), np.asarray(a),
                                      err_msg=f)
        np.testing.assert_allclose(got.numpy(), np.asarray(b),
                                   rtol=INIT_RTOL, atol=INIT_ATOL,
                                   err_msg=f)


# ---------------------------------------------------------------------------
# torch.func
# ---------------------------------------------------------------------------


def test_jacrev_matches_central_difference():
    params, fn = create_sgp4_propagator(ISS_L1, ISS_L2, device="cpu")
    h = 1e-3
    for t0 in (-300.0, 10.0, 720.0):
        t = torch.tensor(t0, dtype=torch.float64)
        jac = torch.func.jacrev(lambda x: fn(params, x)[0])(t)
        fd = (fn(params, t + h)[0] - fn(params, t - h)[0]) / (2 * h)
        rel = float(((jac - fd).abs().max() / fd.abs().max()))
        assert rel < 1e-6, (t0, rel)
        # dr/dt in km/min is about the velocity in km/s x 60: SGP4's
        # velocity is not the exact derivative of its position
        # (measured 2.7e-6 relative)
        np.testing.assert_allclose(jac.numpy(), 60.0 * fn(params, t)[1]
                                   .numpy(), rtol=1e-5)


@pytest.mark.parametrize("name,max_steps", [("iss", None), ("traj", None),
                                            ("geo", 5), ("heo", 5),
                                            ("geo", None), ("heo", None)])
def test_vmap_equals_loop(name, max_steps):
    """Bit for bit. Six points keep torch's CPU elementwise kernels on
    their scalar loop for the batch as for a single point (from 8 f64
    elements on, their vectorized sin and cos round some last bits
    otherwise); on the card a batch and a point run the same code
    (``test_torch_cuda.py``, ``chip_smoke.py`` phase 8: 1,440 points)."""
    params, fn = create_sgp4_propagator(*TLES[name], device="cpu")
    t = torch.linspace(-2000.0, 3000.0, 6, dtype=torch.float64)
    kw = {} if max_steps is None else {"max_steps": max_steps}
    r, v = torch.func.vmap(lambda x: fn(params, x, **kw))(t)
    for k in range(len(t)):
        rk, vk = fn(params, t[k])
        assert torch.equal(r[k], rk) and torch.equal(v[k], vk)
    # the plain call (the deep loop runs until every lane is done)
    r2, v2 = fn(params, t)
    assert torch.equal(r, r2) and torch.equal(v, v2)


@pytest.mark.parametrize("name", ["geo", "heo"])
def test_func_transforms_on_deep_tle_match_jax(name):
    """vmap and jacrev of a deep TLE's function with no ``max_steps``
    (the function reads the step count under the transforms' wrappers)
    against JAX's jax.vmap and jax.jacrev of its own: r and v within the
    f64 gate; dr/dt (km/min, up to ~300) within 1e-9 relative (measured
    2e-15)."""
    jparams, jfn = japi.create_sgp4_propagator(*TLES[name])
    pparams, pfn = create_sgp4_propagator(*TLES[name], device="cpu")
    t = np.linspace(-2000.0, 3000.0, 6)
    rp, vp = torch.func.vmap(lambda x: pfn(pparams, x))(torch.as_tensor(t))
    rj, vj = jax.vmap(lambda x: jfn(jparams, x))(jnp.asarray(t))
    np.testing.assert_allclose(rp.numpy(), np.asarray(rj), rtol=0,
                               atol=F64_POS_KM)
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), rtol=0,
                               atol=F64_VEL_KMS)
    jac_p = torch.func.vmap(torch.func.jacrev(
        lambda x: pfn(pparams, x)[0]))(torch.as_tensor(t))
    jac_j = jax.vmap(jax.jacrev(lambda x: jfn(jparams, x)[0]))(
        jnp.asarray(t))
    np.testing.assert_allclose(jac_p.numpy(), np.asarray(jac_j), rtol=1e-9,
                               atol=0)
    one = torch.func.jacrev(lambda x: pfn(pparams, x)[0])(
        torch.tensor(t[-1], dtype=torch.float64))
    assert torch.equal(one, jac_p[-1])


# ---------------------------------------------------------------------------
# the native engine
# ---------------------------------------------------------------------------


def _regime_sats(seed, count):
    rng = np.random.default_rng(seed)
    g72, g84 = sc.wgs72(), sc.wgs84()
    sats = []
    for k in range(count):
        regime = k % 5
        if regime == 0:    # LEO
            no = rng.uniform(12, 16) * 2 * math.pi / 1440
            e, i = rng.uniform(1e-4, 0.05), rng.uniform(0.3, 1.8)
        elif regime == 1:  # low perigee (isimp)
            no = rng.uniform(16.2, 16.5) * 2 * math.pi / 1440
            e, i = rng.uniform(1e-4, 0.01), rng.uniform(0.5, 1.7)
        elif regime == 2:  # GEO irez=1 (often Lyddane)
            no = rng.normal(1.0027, 1e-4) * 2 * math.pi / 1440
            e, i = rng.uniform(1e-4, 5e-4), rng.uniform(0.0, 0.15)
        elif regime == 3:  # half-day irez=2
            no = rng.uniform(1.9, 2.1) * 2 * math.pi / 1440
            e, i = rng.uniform(0.5, 0.74), rng.uniform(0.9, 1.2)
        else:              # deep non-resonant
            no = rng.uniform(0.9, 1.8) * 2 * math.pi / 1440
            e, i = rng.uniform(0.01, 0.3), rng.uniform(0.3, 1.2)
        sats.append(sc.sgp4init(
            g72 if k % 2 else g84, 2460310.5,
            float(rng.uniform(-1e-5, 1e-4)), e,
            float(rng.uniform(0, 2 * math.pi)), i,
            float(rng.uniform(0, 2 * math.pi)), no,
            float(rng.uniform(0, 2 * math.pi))))
    return sats


def test_native_scalar_parity_all_regimes():
    """The native engine against ops/scalar.py over LEO, low-perigee,
    GEO (Lyddane), half-day and deep non-resonant regimes (the gates of
    tests/test_native.py: 1e-9 km within +-1 day, 1e-6 km at year-scale
    probes), and against the JAX package's native engine bit for bit."""
    times = np.linspace(-1440.0, 1440.0, 25)
    long_near = np.array([-525960.0, -131490.0, 131490.0, 525960.0])
    long_deep = np.array([-43200.0, 43200.0])
    for sat in _regime_sats(17, 40):
        eng = pnative.scalar_engine(sat)
        jeng = jnative.scalar_engine(sat)
        np.testing.assert_array_equal(eng._vec, jeng._vec)
        deep = sat.method == "d"
        for t in np.concatenate([times, long_deep if deep else long_near]):
            e1, r1, v1 = sc.sgp4(sat, float(t))
            e2, r2, v2 = eng.sgp4(float(t))
            assert e1 == e2, (e1, e2, t)
            assert (e2, r2, v2) == jeng.sgp4(float(t))
            gate = 1e-9 if abs(t) <= 1440.0 else 1e-6
            if e1 == 0:
                for a, b in zip(r1 + v1, r2 + v2):
                    assert a == b or abs(a - b) < gate, (a, b, t)


def test_sgp4_array_simd_parity():
    """The 8-wide SIMD array path against the per-point engine, lane for
    lane (error codes exactly, 1e-9 km), over non-multiple-of-8 tails,
    decaying lanes and the deep scalar fallback."""
    rng = np.random.default_rng(11)
    sats = []
    for k in range(12):
        no = rng.uniform(11.0, 16.45) * 2 * math.pi / 1440
        bstar = 2e-3 if k % 4 == 0 else float(rng.uniform(-1e-5, 3e-4))
        sats.append(sc.sgp4init(
            sc.wgs72() if k % 2 else sc.wgs84(), 2460310.5, bstar,
            rng.uniform(1e-4, 0.1), float(rng.uniform(0, 2 * math.pi)),
            float(rng.uniform(0.0, 1.8)), float(rng.uniform(0, 2 * math.pi)),
            no, float(rng.uniform(0, 2 * math.pi))))
    sats.append(sc.sgp4init(sc.wgs72(), 2460310.5, 0.0, 3e-4, 0.3, 0.01,
                            1.0, 1.0027 * 2 * math.pi / 1440, 2.0))
    t = np.linspace(-1440.0, 40000.0, 203)
    n_err = 0
    for sat in sats:
        eng = pnative.scalar_engine(sat)
        ea, ra, va = eng.sgp4_array(t)
        for got, want in zip((ea, ra, va),
                             jnative.scalar_engine(sat).sgp4_array(t)):
            np.testing.assert_array_equal(got, want)
        for j, tj in enumerate(t):
            e2, r2, v2 = eng.sgp4(float(tj))
            assert ea[j] == e2, (ea[j], e2, tj)
            n_err += e2 != 0
            if e2 == 0:
                for a, b in zip(list(ra[j]) + list(va[j]),
                                list(r2) + list(v2)):
                    assert a == b or abs(a - b) < 1e-9, (a, b, tj)
            else:
                assert not ra[j].any() and not va[j].any()
    assert n_err > 0


def test_satcore_builds_binds_and_reuses_results():
    """The CPython extension builds here and binds its SatCore to the
    Satrec; results the caller keeps are never mutated by later calls
    (the core reuses only a result the caller dropped)."""
    ext = pnative._get_ext()
    assert ext is not None and ext.__name__.endswith("_astroz_torch_scalar")
    sat = psat(ISS_L1, ISS_L2)
    jd, fr = jday(2024, 5, 6, 12, 0, 0.0)
    e, r, v = sat.sgp4(jd, fr)
    assert e == 0
    assert "sgp4" in sat.__dict__
    assert type(sat.sgp4).__name__ == "builtin_function_or_method"
    assert sat.t == pytest.approx(
        ((jd - sat.jdsatepoch) + (fr - sat.jdsatepochF)) * 1440.0)
    a = sat.sgp4(jd, fr)
    b = sat.sgp4(jd, fr + 0.1)
    assert a is not b
    snap_a = (a[0], tuple(a[1]), tuple(a[2]))
    sat.sgp4(jd, fr + 0.2)
    assert (a[0], tuple(a[1]), tuple(a[2])) == snap_a
    x = sat.sgp4(jd, fr)[1][0]
    x0 = float(x)
    sat.sgp4(jd, fr + 0.4)
    assert float(x) == x0
    vals = {round(sat.sgp4(jd, fr + k / 100.0)[1][0], 6) for k in range(5)}
    assert len(vals) == 5


def test_sgp4_grid_threaded_matches_serial(monkeypatch):
    vecs = np.asarray([pnative.pack_scalar_sat(s)
                       for s in _regime_sats(7, 23)])
    rng = np.random.default_rng(7)
    tsince = np.broadcast_to(np.linspace(0, 1440.0, 600), (23, 600)).copy()
    tsince += rng.normal(0, 1.0, tsince.shape)
    monkeypatch.setattr(pnative.os, "cpu_count", lambda: 1)
    serial = pnative.sgp4_grid(vecs, tsince)
    monkeypatch.setattr(pnative.os, "cpu_count", lambda: 4)
    threaded = pnative.sgp4_grid(vecs, tsince)
    for a, b in zip(serial, threaded):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_native_build_is_keyed_on_sources():
    """The library's file name carries the hash of its sources and
    flags, under the port's own names."""
    pnative.get_lib()
    path = pnative.library_path()
    assert path.parent == pnative.BUILD_DIR
    assert path.name.startswith("libastroz_torch_native_")
    assert pnative._ext_path().name.startswith("_astroz_torch_scalar_")
    assert path.exists()


# ---------------------------------------------------------------------------
# imports, devices, Constellation
# ---------------------------------------------------------------------------


def test_api_imports_no_jax():
    """Every module of the port imports without JAX or astroz_tpu."""
    modules = ("astroz_tpu_torch", "astroz_tpu_torch.api",
               "astroz_tpu_torch.io", "astroz_tpu_torch.fits",
               "astroz_tpu_torch.mission", "astroz_tpu_torch.spice",
               "astroz_tpu_torch.equatorial", "astroz_tpu_torch.profiling",
               "astroz_tpu_torch.config", "astroz_tpu_torch.native")
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'astroz_tpu.')) or m == 'astroz_tpu']\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Satrec.twoline2rv(ISS_L1, ISS_L2)
    with pytest.raises(RuntimeError, match="cuda"):
        Satrec().sgp4init(*_sgp4init_args(ISS_L1, ISS_L2))
    with pytest.raises(RuntimeError, match="cuda"):
        create_sgp4_propagator(ISS_L1, ISS_L2)
    with pytest.raises(RuntimeError, match="cuda"):
        pops.sgp4_init(P_WGS72, **_init_inputs())
    els = pops.sgp4_init(P_WGS72, **_init_inputs(), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        pops.sdp4_init(P_WGS72, els)


def test_init_rejects_inputs_on_another_device():
    """Tensor inputs of the init entry points must lie on the device
    asked for."""
    kw = {k: torch.as_tensor(v) for k, v in _init_inputs().items()}
    with pytest.raises(ValueError, match="meta"):
        pops.sgp4_init(P_WGS72, **kw, device="meta")
    els = pops.sgp4_init(P_WGS72, **kw, device="cpu")
    with pytest.raises(ValueError, match="meta"):
        pops.sdp4_init(P_WGS72, els, device="meta")


def test_satrec_array_rejects_mixed_devices():
    a, b = psat(ISS_L1, ISS_L2), psat(TRAJ_L1, TRAJ_L2)
    b._device = torch.device("meta")
    with pytest.raises(ValueError, match="devices"):
        SatrecArray([a, b])
    with pytest.raises(ValueError, match="empty"):
        SatrecArray([])


def test_constellation_num_satellites():
    con = Constellation(CON_TEXT, device="cpu")
    assert con.num_satellites == len(con) == 5
    assert con.select([28626]).num_satellites == 1


def test_module_constants():
    assert (papi.WGS72OLD, papi.WGS72, papi.WGS84) == (0, 1, 2)
    assert papi.accelerated is True
    assert papi._resolve_grav(WGS84) is papi._GRAV_BY_ENUM[2]
    assert papi._resolve_grav(P_WGS72) is P_WGS72
    with pytest.raises(ValueError):
        papi._resolve_grav(7)
