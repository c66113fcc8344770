"""The near-earth slice end to end: astroz_tpu_torch ``build_catalog`` ->
``propagate(method="fast")`` against astroz_tpu on the same TLE text.

The JAX side runs its XLA:CPU fast path (true divides) with the drag
term corrected (``jax_drag_fixed``, see ``test_torch_fast.py``: the JAX
tail takes sin(xmdf) where SGP4 takes cos(xmdf)). Tolerances are
those of the kernel tests (``test_torch_fast.py``): positions 5e-3 km,
velocities 5e-6 km/s, error codes identical. Frame conversion adds
f32 sin/cos/atan2 from two libraries, so geodetic angles get 1e-6 rad
(~6 m at the surface), and geodetic altitude 0.02 km: ``alt = p /
cos(lat) - N`` in f32 turns a 1-ulp difference of cos(lat) near a pole
into metres (measured 7 m at latitude 82.7 deg from identical TEME
inputs). Against the JAX f64 path the gate is the JAX package's own
``test_fast_vs_f64_pure_leo``: 0.02 km.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import astroz_tpu as J
from astroz_tpu import tle as jtle
import astroz_tpu_torch as P
from astroz_tpu_torch.constants import RAD2DEG, WGS72
from astroz_tpu_torch.convert import (carry_from_numpy,
                                      deep_elements_from_numpy,
                                      elements_from_numpy)
from astroz_tpu_torch.ops.sdp4 import DeepElements
from astroz_tpu_torch.ops import cuda_sgp4

from test_sgp4 import ISS_L1, ISS_L2, TRAJ_L1, TRAJ_L2
from test_torch_cuda import synthetic_leo_text
from test_torch_fast import jax_drag_fixed  # noqa: F401  (fixture)
from test_torch_init import DEEP_TEXT, LEO_TEXT

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: JD split: the earliest epoch, and -250 .. +2000 minutes from it
JD = np.full(9, 2460308.5)
FR = np.linspace(-250.0, 2000.0, 9) / 1440.0

POS_TOL_KM = 5e-3
VEL_TOL_KMS = 5e-6
ANGLE_TOL = {"geodetic": 1e-6, "geodetic_deg": 1e-6 * RAD2DEG}
ALT_TOL_KM = 0.02


@pytest.fixture(scope="module")
def cats():
    return J.build_catalog(LEO_TEXT), P.build_catalog(LEO_TEXT, device="cpu")


def _assert_r_close(rj, rp, output, layout):
    """Positions (or geodetic lat/lon/alt) within their tolerances;
    ``layout`` says which axis holds the 3 components."""
    rj, rp = np.asarray(rj), rp.numpy()
    axis = 0 if layout == "planes" else -1
    for c in range(3):
        a, b = np.take(rj, c, axis), np.take(rp, c, axis)
        tol = POS_TOL_KM
        if output in ANGLE_TOL:
            tol = ANGLE_TOL[output] if c < 2 else ALT_TOL_KM
        d = np.abs(a - b)
        if output in ANGLE_TOL and c == 1:  # longitude wraps at +-pi
            d = np.minimum(d, 2 * np.pi * (1 if output == "geodetic"
                                           else RAD2DEG) - d)
        assert d.max() <= tol, (output, layout, c, d.max())


@pytest.mark.parametrize("layout", ["time_major", "sat_major", "planes"])
@pytest.mark.parametrize("output",
                         ["teme", "ecef", "geodetic", "geodetic_deg"])
def test_propagate_matches_jax(cats, jax_drag_fixed, output, layout):
    jcat, pcat = cats
    rj, vj, ej = J.propagate(jcat, JD, FR, method="fast", output=output,
                             layout=layout)
    rp, vp, ep = P.propagate(pcat, JD, FR, method="fast", output=output,
                             layout=layout)
    assert tuple(rp.shape) == tuple(rj.shape)
    assert tuple(vp.shape) == tuple(vj.shape)
    assert rp.dtype == vp.dtype == torch.float32 and ep.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ej), ep.numpy())
    _assert_r_close(rj, rp, output, layout)
    assert np.abs(np.asarray(vj) - vp.numpy()).max() <= VEL_TOL_KMS


@pytest.mark.parametrize("output", ["teme", "geodetic"])
def test_velocities_false(cats, jax_drag_fixed, output):
    """v is None; positions match JAX and are bit-equal to the port's
    own positions with velocities."""
    jcat, pcat = cats
    rj, vj, ej = J.propagate(jcat, JD, FR, method="fast", output=output,
                             velocities=False)
    rp, vp, ep = P.propagate(pcat, JD, FR, method="fast", output=output,
                             velocities=False)
    assert vj is None and vp is None
    np.testing.assert_array_equal(np.asarray(ej), ep.numpy())
    _assert_r_close(rj, rp, output, "time_major")
    r_vel, _, e_vel = P.propagate(pcat, JD, FR, method="fast",
                                  output=output)
    assert torch.equal(rp, r_vel) and torch.equal(ep, e_vel)


@pytest.mark.parametrize("layout", ["time_major", "sat_major", "planes"])
def test_satellite_mask(cats, jax_drag_fixed, layout):
    jcat, pcat = cats
    mask = np.random.default_rng(5).random(len(pcat)) < 0.5
    rj, vj, ej = J.propagate(jcat, JD, FR, method="fast", layout=layout,
                             satellite_mask=mask)
    rp, vp, ep = P.propagate(pcat, JD, FR, method="fast", layout=layout,
                             satellite_mask=mask)
    np.testing.assert_array_equal(np.asarray(ej), ep.numpy())
    _assert_r_close(rj, rp, "teme", layout)
    assert np.abs(np.asarray(vj) - vp.numpy()).max() <= VEL_TOL_KMS
    sat_err = ep.numpy() if layout == "sat_major" else ep.numpy().T
    assert (sat_err[~mask] == -1).all() and (sat_err[mask] != -1).all()
    r_sat = np.moveaxis(rp.numpy(), {"time_major": 1, "sat_major": 0,
                                     "planes": 2}[layout], 0)
    assert (r_sat[~mask] == 0).all()


@pytest.mark.parametrize("lines", [(ISS_L1, ISS_L2), (TRAJ_L1, TRAJ_L2)])
def test_fast_vs_jax_f64(lines):
    """The port's fast path vs the JAX f64 path within 0.02 km over the
    day after the epoch, as the JAX package gates its own fast path."""
    text = "\n".join(lines)
    jcat = J.build_catalog(jtle.TleArrays.from_text(text,
                                                    allow_native=False))
    pcat = P.build_catalog(text, device="cpu")
    jd = np.full(97, pcat.epochs_jd[0])
    fr = np.linspace(0.0, 1.0, 97)
    r64, _, e64 = J.propagate(jcat, jd, fr, method="f64")
    rp, _, ep = P.propagate(pcat, jd, fr, method="fast")
    np.testing.assert_array_equal(np.asarray(e64), ep.numpy())
    dr = np.linalg.norm(np.asarray(r64) - rp.numpy().astype(np.float64),
                        axis=-1)
    assert dr.max() < 0.02


def test_drag_term_vs_jax_f64():
    """With cos(xmdf) in the drag term the fast path stays within 0.02 km
    of the JAX f64 path over +-1 day on drag-carrying near-earth lanes
    with e up to 0.02. Measured: 6.6 m (the JAX fast path, with
    sin(xmdf), is 33.6 m off on this catalog)."""
    text = synthetic_leo_text(48, seed=9, decaying=False)
    jcat = J.build_catalog(jtle.TleArrays.from_text(text,
                                                    allow_native=False))
    pcat = P.build_catalog(text, device="cpu")
    jd = np.full(25, 2460310.5)
    fr = np.linspace(-1.0, 1.0, 25)
    r64, _, e64 = J.propagate(jcat, jd, fr, method="f64")
    rp, _, ep = P.propagate(pcat, jd, fr, method="fast")
    np.testing.assert_array_equal(np.asarray(e64), ep.numpy())
    dr = np.linalg.norm(np.asarray(r64) - rp.numpy().astype(np.float64),
                        axis=-1)
    assert dr.max() < 0.02


def test_elements_from_numpy_round_trip(cats):
    """The JAX catalog's elements carried across give the same outputs,
    bit for bit, as the port's own ingest of the same text."""
    jcat, pcat = cats
    for src in (jcat.els, jcat.els._asdict()):
        els = elements_from_numpy(src, "cpu")
        assert els.no_kozai.dtype == torch.float64
        assert els.isimp.dtype == torch.bool
        assert els.error.dtype == torch.int32
        cat = P.catalog_from_elements(els, WGS72, device="cpu")
        r, v, e = P.propagate(cat, JD, FR, method="fast")
        r0, v0, e0 = P.propagate(pcat, JD, FR, method="fast")
        assert torch.equal(r, r0) and torch.equal(v, v0)
        assert torch.equal(e, e0)


def test_carrying_functions_default_to_the_card(cats):
    """``elements_from_numpy``, ``deep_elements_from_numpy`` and
    ``carry_from_numpy`` put their tensors on the card unless asked for
    another device, and raise where there is none."""
    jcat, _ = cats
    zeros = {name: np.zeros(2) for name in DeepElements._fields}
    carry = {"atime": np.zeros(2), "xli": np.zeros(2), "xni": np.zeros(2)}
    calls = ((elements_from_numpy, jcat.els),
             (deep_elements_from_numpy, zeros), (carry_from_numpy, carry))
    for fn, src in calls:
        assert all(x.device.type == "cpu" for x in fn(src, "cpu"))
        if torch.cuda.is_available():
            assert all(x.device.type == "cuda" for x in fn(src))
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                fn(src)


def test_unported_paths_raise(cats):
    """Every path of ``propagate`` now runs: ``method="f64"`` (the
    default) with and without ``scan_times`` gives the JAX f64 path's
    outputs (error codes identical, 1e-5 km, ``test_torch_f64.py``), and
    ``scan_times=True`` with ``method="fast"`` is ignored, as the JAX
    package ignores it. Bad arguments still raise."""
    jcat, pcat = cats
    text = LEO_TEXT + "\n" + DEEP_TEXT
    mixed = P.build_catalog(text, device="cpu")
    jmixed = J.build_catalog(jtle.TleArrays.from_text(text,
                                                      allow_native=False))
    assert mixed.n_deep == 3
    r, _, e = P.Constellation(mixed).propagate([0.0], start_time=2460310.5)
    assert tuple(r.shape) == (1, len(mixed), 3)
    assert (e[:, mixed.deep_idx] == 0).all()
    fr = np.sort(FR)
    for jc, cat in ((jcat, pcat), (jmixed, mixed)):
        for scan in (False, True):
            rj, vj, ej = J.propagate(jc, JD, fr, method="f64",
                                     scan_times=scan)
            rp, vp, ep = P.propagate(cat, JD, fr, scan_times=scan)
            assert rp.dtype == torch.float64
            np.testing.assert_array_equal(np.asarray(ej), ep.numpy())
            assert np.abs(np.asarray(rj) - rp.numpy()).max() <= 1e-5
            assert np.abs(np.asarray(vj) - vp.numpy()).max() <= 1e-8
        fast = P.propagate(cat, JD, fr, method="fast")
        fast_scan = P.propagate(cat, JD, fr, method="fast", scan_times=True)
        assert all(torch.equal(a, b) for a, b in zip(fast, fast_scan))
    with pytest.raises(ValueError, match="output"):
        P.propagate(pcat, JD, FR, method="fast", output="gcrs")
    with pytest.raises(ValueError, match="no TLEs"):
        P.build_catalog("not a catalog", device="cpu")


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="cuda"):
        P.build_catalog(LEO_TEXT)  # device defaults to "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        P.Constellation(LEO_TEXT)


def test_import_loads_no_jax():
    code = ("import sys, astroz_tpu_torch, astroz_tpu_torch.convert, "
            "astroz_tpu_torch.calculations, "
            "astroz_tpu_torch.orbital_mechanics, "
            "astroz_tpu_torch.propagators, astroz_tpu_torch.spacecraft, "
            "astroz_tpu_torch.montecarlo; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'astroz_tpu')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_constellation_matches_jax(tmp_path, jax_drag_fixed):
    path = tmp_path / "leo.tle"
    path.write_text(LEO_TEXT)
    start = 2460310.5
    times = np.arange(0.0, 120.0, 15.0)
    jcon = J.Constellation(str(path))
    pcon = P.Constellation(str(path), device="cpu")
    assert len(pcon) == len(jcon) and pcon.names == jcon.names
    assert pcon.catalog.device == torch.device("cpu")
    rj, vj, ej = jcon.propagate(times, start_time=start, output="ecef")
    rp, vp, ep = pcon.propagate(times, start_time=start, output="ecef")
    np.testing.assert_array_equal(np.asarray(ej), ep.numpy())
    _assert_r_close(rj, rp, "ecef", "time_major")

    sub = pcon.select([25544, 40003])  # ISS and TRAJ share 25544
    assert list(sub.satnums) == [25544, 25544, 40003]
    assert sub.names == ("ISS (ZARYA)", "TRAJ", "SYN-3")
    rs, _, _ = sub.propagate(times, start_time=start, output="ecef")
    assert torch.equal(rs, rp[:, [0, 1, 5]])

    import datetime
    rj1, _, _ = J.constellation.propagate(
        str(path), times, datetime.datetime(2024, 1, 1, 12),
        norad_id=25544)
    rp1, _, _ = P.constellation.propagate(
        str(path), times, datetime.datetime(2024, 1, 1, 12),
        norad_id=25544, device="cpu")
    assert tuple(rp1.shape) == (len(times), 2, 3)
    _assert_r_close(rj1, rp1, "teme", "time_major")

    urls = []
    fetched = P.Constellation("group:starlink", device="cpu",
                              fetch=lambda u: urls.append(u) or LEO_TEXT)
    assert len(fetched) == len(pcon) and "GROUP=starlink" in urls[0]


def test_main_path_runs_the_wrapper(cats, monkeypatch):
    """propagate reaches the kernel's wrapper once per call, with the
    catalog's staging and trip count."""
    calls = []
    real = cuda_sgp4.propagate_fast_sep

    def spy(*args, **kw):
        calls.append(kw["kepler_iters"])
        return real(*args, **kw)

    monkeypatch.setattr(P.propagation, "propagate_fast_sep", spy)
    P.propagate(cats[1], JD, FR, method="fast", layout="planes")
    assert calls == [3]
