"""astroz_tpu_torch host foundations against astroz_tpu: TLE/OMM parsing,
calendar helpers, frames and SGP4 element init.

Parsing and init must agree bit for bit (f64): both packages run the
same Python parser and the same numpy init formulas. The JAX package's
2-line fast path goes through its C++ parser, which differs by an ulp
on some fields, so the catalogs here are 3-line text (named records
keep the JAX package on its Python parser).

``LEO_TEXT`` (ISS, the golden-trajectory TLE and 64 synthetic
near-earth satellites) is shared with the other ``test_torch_*`` files.
"""

import dataclasses
import inspect
import json

import numpy as np
import pytest
import torch

import astroz_tpu.constants as jconst
from astroz_tpu import frames as jframes
from astroz_tpu import time as jtime
from astroz_tpu import tle as jtle
from astroz_tpu.ops.sgp4 import sgp4_init_np as j_sgp4_init_np

import astroz_tpu_torch.constants as pconst
from astroz_tpu_torch import frames as pframes
from astroz_tpu_torch import time as ptime
from astroz_tpu_torch import tle as ptle
from astroz_tpu_torch.ops.sgp4 import Sgp4Elements
from astroz_tpu_torch.ops.sgp4 import sgp4_init_np as p_sgp4_init_np

from test_sdp4 import GEO_L1, GEO_L2, GPS_L1, GPS_L2, HEO_L1, HEO_L2
from test_sgp4 import ISS_L1, ISS_L2, TRAJ_L1, TRAJ_L2
from test_torch_cuda import synthetic_leo_text

torch.set_num_threads(1)


LEO_TEXT = "\n".join(["ISS (ZARYA)", ISS_L1, ISS_L2, "TRAJ", TRAJ_L1, TRAJ_L2,
                      synthetic_leo_text()])
DEEP_TEXT = "\n".join(["GPS", GPS_L1, GPS_L2, "GEO", GEO_L1, GEO_L2,
                       "HEO", HEO_L1, HEO_L2])

OMM = [{
    "OBJECT_NAME": "ISS (ZARYA)", "OBJECT_ID": "1998-067A",
    "EPOCH": "2024-05-06T19:53:05.000", "MEAN_MOTION": 15.50957674,
    "ECCENTRICITY": 0.0003580, "INCLINATION": 51.6393,
    "RA_OF_ASC_NODE": 160.4574, "ARG_OF_PERICENTER": 140.6673,
    "MEAN_ANOMALY": 205.7250, "NORAD_CAT_ID": 25544, "BSTAR": 0.00027310,
    "MEAN_MOTION_DOT": 0.00015698, "REV_AT_EPOCH": 45212,
}, {
    "OBJECT_NAME": "DOY FORM", "OBJECT_ID": "2020-001B",
    "EPOCH": "2024-123T01:02:03.5", "MEAN_MOTION": 14.2,
    "ECCENTRICITY": 0.0101, "INCLINATION": 97.5, "RA_OF_ASC_NODE": 10.0,
    "ARG_OF_PERICENTER": 20.0, "MEAN_ANOMALY": 30.0, "NORAD_CAT_ID": "A0001",
}]


def _assert_bit_equal(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.dtype.kind == "f":
        assert np.array_equal(a, b, equal_nan=True), name
    else:
        assert np.array_equal(a, b), name


def test_tle_arrays_match_jax():
    text = LEO_TEXT + "\n" + DEEP_TEXT
    p = ptle.TleArrays.from_text(text)
    j = jtle.TleArrays.from_text(text, allow_native=False)
    assert len(p) == len(j) == 64 + 2 + 3
    for f in dataclasses.fields(jtle.TleArrays):
        _assert_bit_equal(getattr(j, f.name), getattr(p, f.name), f.name)


def test_tle_records_match_jax():
    """Every parsed record (names, raw lines, OMM JSON) field for field,
    and a malformed record is skipped by both."""
    text = LEO_TEXT + "\n1 99999U bad line\n" + DEEP_TEXT
    p = list(ptle.iter_tles(text))
    j = list(jtle.iter_tles(text))
    assert [dataclasses.asdict(t) for t in p] == \
        [dataclasses.asdict(t) for t in j]
    po, jo = ptle.parse_omm(json.dumps(OMM)), jtle.parse_omm(json.dumps(OMM))
    assert [dataclasses.asdict(t) for t in po] == \
        [dataclasses.asdict(t) for t in jo]


def test_format_lines_matches_jax():
    rng = np.random.default_rng(3)
    for k in range(32):
        kw = dict(satnum=int(rng.integers(1, 339999)),
                  epoch_jd=float(2451545.0 + rng.uniform(0, 9000)),
                  ecco=float(rng.uniform(0, 0.9)),
                  inclo_deg=float(rng.uniform(0, 180)),
                  nodeo_deg=float(rng.uniform(-360, 720)),
                  argpo_deg=float(rng.uniform(0, 360)),
                  mo_deg=float(rng.uniform(0, 360)),
                  no_rev_day=float(rng.uniform(0.9, 16.5)),
                  bstar=float(rng.uniform(-1e-3, 1e-3)),
                  ndot_rev_day2=float(rng.uniform(-1e-3, 1e-3)),
                  nddot_rev_day3=float(rng.uniform(-1e-6, 1e-6)))
        assert ptle.format_lines(**kw) == jtle.format_lines(**kw)


def test_time_helpers_match_jax():
    for year, doy in ((2024, 1.5), (2024, 366.99999), (1999, 59.25),
                      (2000, 60.0), (2057, 200.123456)):
        assert ptime.days2mdhms(year, doy) == jtime.days2mdhms(year, doy)
    for yy, days in ((24, 127.82853009), (57, 1.0), (56, 365.5)):
        assert ptime.epoch_to_jd(yy, days) == jtime.epoch_to_jd(yy, days)
    for jd in (2451545.0, 2460310.5, 2460437.3285, 2299160.7):
        assert ptime.jd_to_datetime_parts(jd) == \
            jtime.jd_to_datetime_parts(jd)
    for s in ("2024-05-06T19:53:05.000", "2024-123T01:02:03.5Z"):
        assert ptime.iso8601_to_jd(s) == jtime.iso8601_to_jd(s)


def test_gstime_matches_jax():
    jd = 2460310.5 + np.linspace(-400.0, 400.0, 1001)
    ref = jtime.gstime(jd, xp=np)
    _assert_bit_equal(ref, ptime.gstime(jd), "gstime numpy")
    _assert_bit_equal(ref, ptime.gstime(torch.from_numpy(jd)).numpy(),
                      "gstime torch")


def test_frames_match_jax():
    """teme_to_ecef and ecef_to_geodetic_xyz in f64 within 1e-9 (km,
    rad): the same formulas, with each library's own sin/cos/atan2."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    r = rng.normal(0.0, 7000.0, (64, 3))
    r[0] = 0.0  # the zero-filled point of a failed lane
    g = rng.uniform(0.0, 2 * np.pi, 64)
    ep = pframes.teme_to_ecef(torch.from_numpy(r),
                              torch.from_numpy(g)).numpy()
    ej = np.asarray(jframes.teme_to_ecef(jnp.asarray(r), jnp.asarray(g)))
    np.testing.assert_allclose(ep, ej, rtol=0, atol=1e-9)
    lp = pframes.ecef_to_geodetic_xyz(*torch.from_numpy(ej.T.copy()))
    lj = jframes.ecef_to_geodetic_xyz(*jnp.asarray(ej.T))
    for a, b in zip(lp, lj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)


@pytest.mark.parametrize("grav", ["WGS72", "WGS84", "WGS72OLD"])
def test_sgp4_init_np_matches_jax(grav):
    """Every Sgp4Elements field bit-equal, on near-earth, deep-space
    and invalid lanes (ecco >= 1 -> error 1, no_kozai <= 0 -> error 2)."""
    a = jtle.TleArrays.from_text(LEO_TEXT + "\n" + DEEP_TEXT,
                                 allow_native=False)
    kw = {f: np.asarray(getattr(a, f)) for f in
          ("no_kozai", "ecco", "inclo", "nodeo", "argpo", "mo", "bstar",
           "epoch_jd")}
    kw["ecco"] = np.append(kw["ecco"], [1.2, 0.001])
    kw["no_kozai"] = np.append(kw["no_kozai"], [0.06, -0.01])
    for f in ("inclo", "nodeo", "argpo", "mo", "bstar", "epoch_jd"):
        kw[f] = np.append(kw[f], kw[f][:2])
    j = j_sgp4_init_np(getattr(jconst, grav), **kw)
    p = p_sgp4_init_np(getattr(pconst, grav), **kw)
    assert Sgp4Elements._fields == type(j)._fields
    for f in Sgp4Elements._fields:
        _assert_bit_equal(getattr(j, f), getattr(p, f), f)
    assert p.is_deep[:-2].sum() == 3 and set(p.error.tolist()) == {0, 1, 2}
    assert p.isimp[2] and not p.isimp[3]  # SYN-0 is the low-perigee lane


def test_frame_leftovers_match_jax():
    """ecef_to_teme, teme_to_ecef_at_jd, geodetic_to_ecef within 1e-9
    km and ecef_to_geodetic_deg within 1e-12 deg (1e-9 km in altitude);
    a float or numpy GMST / Julian date follows the position tensor."""
    import jax.numpy as jnp

    rng = np.random.default_rng(12)
    r = rng.normal(0.0, 7000.0, (64, 3))
    g = rng.uniform(0.0, 2 * np.pi, 64)
    jd = 2460310.5 + rng.uniform(-10.0, 10.0, 64)
    rt = torch.from_numpy(r)
    np.testing.assert_allclose(
        pframes.ecef_to_teme(rt, g).numpy(),
        np.asarray(jframes.ecef_to_teme(jnp.asarray(r), jnp.asarray(g))),
        rtol=0, atol=1e-9)
    np.testing.assert_allclose(
        pframes.ecef_to_teme(rt, 1.25).numpy(),
        np.asarray(jframes.ecef_to_teme(jnp.asarray(r), 1.25)),
        rtol=0, atol=1e-9)
    np.testing.assert_allclose(
        pframes.teme_to_ecef_at_jd(rt, jd).numpy(),
        np.asarray(jframes.teme_to_ecef_at_jd(jnp.asarray(r),
                                              jnp.asarray(jd))),
        rtol=0, atol=1e-9)
    lla_p = pframes.ecef_to_geodetic_deg(rt).numpy()
    lla_j = np.asarray(jframes.ecef_to_geodetic_deg(jnp.asarray(r)))
    np.testing.assert_allclose(lla_p[:, :2], lla_j[:, :2], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(lla_p[:, 2], lla_j[:, 2], rtol=0, atol=1e-9)
    lat = rng.uniform(-1.5, 1.5, 64)
    lon = rng.uniform(-np.pi, np.pi, 64)
    alt = rng.uniform(0.0, 2000.0, 64)
    ep = pframes.geodetic_to_ecef(lat, lon, alt, device="cpu")
    assert ep.dtype == torch.float64
    np.testing.assert_allclose(
        ep.numpy(), np.asarray(jframes.geodetic_to_ecef(
            jnp.asarray(lat), jnp.asarray(lon), jnp.asarray(alt))),
        rtol=0, atol=1e-9)


def test_gstime_scalar_matches_jax():
    for jd in (2451545.0, 2460310.5, 2460437.3285, 2299160.7, 2400000.5):
        assert ptime.gstime_scalar(jd) == jtime.gstime_scalar(jd)


def test_tle_parse_and_epoch_year_match_jax():
    for text in (f"ISS (ZARYA)\n{ISS_L1}\n{ISS_L2}",
                 f"\n\n{GEO_L1}\n{GEO_L2}\n", DEEP_TEXT):
        p, j = ptle.parse(text), jtle.parse(text)
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
        assert p.epoch_year == j.epoch_year
    for t in ptle.iter_tles(LEO_TEXT):
        assert t.epoch_year == jtle.tle_year(t.epochyr)
    with pytest.raises(ptle.TleError, match="no TLE"):
        ptle.parse("no lines here")


def test_sat_catalog_n_sats_matches_jax():
    from astroz_tpu.propagation import build_catalog as j_build
    from astroz_tpu_torch.propagation import build_catalog as p_build

    text = LEO_TEXT + "\n" + DEEP_TEXT
    assert p_build(text, device="cpu").n_sats == j_build(text).n_sats \
        == 64 + 2 + 3


def test_ops_exports_are_the_ports_functions():
    """The ``ops`` names of the JAX package are the port's own
    functions, not copies or JAX's."""
    import astroz_tpu.ops as jops
    import astroz_tpu_torch.ops as pops
    from astroz_tpu_torch.ops import fast, fastmath, sgp4

    assert set(jops.__all__) <= set(pops.__all__)
    assert pops.solve_kepler is sgp4.solve_kepler
    assert pops.kepler_and_posvel is sgp4.kepler_and_posvel
    assert pops.update_secular is sgp4.update_secular
    assert pops.solve_kepler_fast is fast.solve_kepler_fast
    assert pops.fastmath is fastmath
    for name in pops.__all__:
        obj = getattr(pops, name)
        owner = obj.__name__ if inspect.ismodule(obj) else obj.__module__
        assert owner.startswith("astroz_tpu_torch."), name
