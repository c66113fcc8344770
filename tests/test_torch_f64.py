"""The port's f64 propagators against astroz_tpu's on the same inputs.

``sgp4_propagate``, ``sdp4_propagate`` (its resonance integrator
``dspace`` and carry), ``sdp4_propagate_scan``, ``propagate(method="f64")``
and ``propagate_tsince`` of astroz_tpu_torch against the JAX package's f64
path: error codes identical, TEME positions within 2e-7 km and velocities
within 3e-10 km/s, about ten times the largest differences measured on
the CPU (1.955e-8 km, 2.784e-11 km/s). Both are the published f64
algorithm in the same order of operations; they differ by the two
libraries' f64 sin, cos and atan2. The Earth-fixed outputs add the
rotation by the sidereal angle: within 6e-6 km and 1e-9 km/s (measured
6.134e-7 km, 8.658e-11 km/s).
Then the port alone against the python-sgp4 goldens of
``test_sgp4.py`` / ``test_sdp4.py`` at their own tolerances, and against
the scalar oracle ``astroz_tpu/ops/scalar.py`` on a sample of
``test_differential.py``'s sweep at its f64 tolerance.
"""

import os
import sys

import numpy as np
import pytest
import torch

import astroz_tpu as J
from astroz_tpu import tle as jtle
from astroz_tpu.constants import WGS72 as J_WGS72
from astroz_tpu.ops import sdp4 as jsdp4
from astroz_tpu.ops import sgp4 as jsgp4
from astroz_tpu.propagation import propagate_tsince as j_propagate_tsince

import astroz_tpu_torch as P
from astroz_tpu_torch.constants import RAD2DEG, WGS72, WGS84
from astroz_tpu_torch.convert import (carry_from_numpy,
                                      deep_elements_from_numpy,
                                      elements_from_numpy)
from astroz_tpu_torch.ops import (sdp4_propagate, sdp4_propagate_scan,
                                  sgp4_propagate)
from astroz_tpu_torch.ops.sdp4 import dspace, fresh_carry

from test_differential import (EPOCH_JD, SWEEP_TIMES, _compare,
                               oracle_sweep, random_elements)
from test_escape import MIXED_TEXT
from test_sdp4 import GEO_L1, GEO_L2, GPS_L1, GPS_L2, HEO_L1, HEO_L2
from test_sgp4 import TRAJ_L1, TRAJ_L2, TRAJ_REF
from test_torch_cuda import synthetic_deep_text
from test_torch_init import LEO_TEXT

torch.set_num_threads(1)

POS_TOL_KM = 2e-7
VEL_TOL_KMS = 3e-10
#: ECEF and geodetic altitude, after the rotation by the sidereal angle
FIXED_POS_TOL_KM = 6e-6
FIXED_VEL_TOL_KMS = 1e-9

#: the mixed catalog: ISS, TRAJ, GPS, GEO, Molniya, then 16 synthetic
#: deep lanes (GEO, 12-hour, Molniya-class, a perigee under the surface
#: and a huge bstar)
MIXED = MIXED_TEXT + "\n" + synthetic_deep_text(16, seed=3)


def _jax_catalog(text):
    return J.build_catalog(jtle.TleArrays.from_text(text,
                                                    allow_native=False))


@pytest.fixture(scope="module")
def mixed():
    return _jax_catalog(MIXED), P.build_catalog(MIXED, device="cpu")


@pytest.fixture(scope="module")
def leo():
    return J.build_catalog(LEO_TEXT), P.build_catalog(LEO_TEXT, device="cpu")


def _assert_close(out_j, out_p, pos_tol=POS_TOL_KM, vel_tol=VEL_TOL_KMS):
    rj, vj, ej = (np.asarray(x) for x in out_j[:3])
    rp, vp, ep = out_p[:3]
    np.testing.assert_array_equal(ej, ep.numpy())
    assert rp.dtype == torch.float64 and ep.dtype == torch.int32
    dr = np.abs(rj - rp.numpy()).max()
    dv = np.abs(vj - vp.numpy()).max()
    print(f"f64 vs JAX: max|dr| {dr:.3e} km, max|dv| {dv:.3e} km/s")
    assert dr <= pos_tol
    assert dv <= vel_tol


def _grid(n_sats, dense, seed=0):
    """Minutes since epoch of mixed sign: (9, 1) or (9, n_sats)."""
    col = np.linspace(-2000.0, 2600.0, 9)[:, None]
    if not dense:
        return col
    rng = np.random.default_rng(seed)
    return col + rng.uniform(-600.0, 600.0, (9, n_sats))


@pytest.mark.parametrize("dense", [False, True])
def test_sgp4_propagate_matches_jax(leo, dense):
    jcat, pcat = leo
    t = _grid(len(pcat), dense)
    out_j = jsgp4.sgp4_propagate(jcat.els, t, J_WGS72)
    out_p = sgp4_propagate(elements_from_numpy(jcat.els, "cpu"),
                           torch.from_numpy(t), WGS72)
    assert set(out_p[2].numpy().ravel().tolist()) >= {0, 1}
    _assert_close(out_j, out_p)
    assert tuple(out_p[0].shape) == (9, len(pcat), 3)


@pytest.mark.parametrize("dense", [False, True])
def test_sdp4_propagate_matches_jax(mixed, dense):
    jcat, pcat = mixed
    t = _grid(len(pcat), dense)
    out_j = jsdp4.sdp4_propagate(jcat.els, jcat.deep, t, J_WGS72)
    out_p = sdp4_propagate(pcat.els, pcat.deep, torch.from_numpy(t), WGS72)
    assert set(out_p[2].numpy().ravel().tolist()) >= {0, 1}
    _assert_close(out_j, out_p)
    for a, b in zip(out_j[3], out_p[3]):    # the carries
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-12,
                                   atol=0)


def test_dspace_restart_across_sign_change(mixed):
    """A carry integrated forward to +3000 minutes, resumed at +4500
    (continues) and at -1500 (restarts from epoch) and at +1000 (behind
    the carry: restarts), seeded on both sides from the JAX carry."""
    jcat, pcat = mixed
    jd, pd = jcat.deep, pcat.deep
    n = len(pcat)
    _, _, _, jcarry = jsdp4.sdp4_propagate(jcat.els, jd, np.full(n, 3000.0),
                                           J_WGS72)
    pcarry = carry_from_numpy(jcarry, "cpu")
    assert pcarry.atime.dtype == torch.float64
    irez = pd.irez.numpy()
    np.testing.assert_array_equal(pcarry.atime.numpy()[irez != 0], 2880.0)
    for t in (4500.0, -1500.0, 1000.0):
        tt = np.full(n, t)
        args = [np.asarray(x) + np.zeros(n) for x in
                (jcat.els.ecco, jcat.els.argpo, jcat.els.inclo, jcat.els.mo,
                 jcat.els.nodeo, jcat.els.no_unkozai)]
        out_j = jsdp4.dspace(jd, jcat.els, tt, tt, *args, jcarry)
        out_p = dspace(pd, pcat.els, torch.from_numpy(tt),
                       torch.from_numpy(tt),
                       *(torch.from_numpy(a) for a in args), pcarry)
        for a, b in zip(out_j[:6] + tuple(out_j[6]),
                        out_p[:6] + tuple(out_p[6])):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-12,
                                       atol=1e-12)
        steps = {4500.0: 4320.0, -1500.0: -1440.0, 1000.0: 720.0}[t]
        np.testing.assert_array_equal(out_p[6].atime.numpy()[irez != 0],
                                      steps)
    # a fixed step count gives the loop's result when it covers it
    fixed = dspace(pd, pcat.els, torch.full((n,), 4500.0),
                   torch.full((n,), 4500.0),
                   *(torch.from_numpy(a) for a in args), pcarry, max_steps=4)
    loop = dspace(pd, pcat.els, torch.full((n,), 4500.0),
                  torch.full((n,), 4500.0),
                  *(torch.from_numpy(a) for a in args), pcarry)
    for a, b in zip(fixed[:6], loop[:6]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("times", [
    [-2880.0, -1440.0, -700.0, 0.0, 500.0, 1440.0, 2900.0],
    [2900.0, 1440.0, 700.0, 0.0, -500.0, -1440.0]])
def test_sdp4_propagate_scan_matches_jax(mixed, times):
    """The scan over a time axis sorted either way, across epoch (the
    restart rule at the sign change), against JAX's scan, and against
    the port's own stateless propagate within the JAX test's 1e-6 km and
    1e-9 km/s."""
    jcat, pcat = mixed
    times = np.asarray(times)
    out_j = jsdp4.sdp4_propagate_scan(jcat.els, jcat.deep, times, J_WGS72)
    out_p = sdp4_propagate_scan(pcat.els, pcat.deep, torch.from_numpy(times),
                                WGS72)
    _assert_close(out_j, out_p)
    flat = sdp4_propagate(pcat.els, pcat.deep,
                          torch.from_numpy(times[:, None]), WGS72)
    assert torch.equal(flat[2], out_p[2])
    assert (flat[0] - out_p[0]).abs().max().item() <= 1e-6
    assert (flat[1] - out_p[1]).abs().max().item() <= 1e-9
    carry = fresh_carry(pcat.deep, pcat.els.no_unkozai)
    again = sdp4_propagate_scan(pcat.els, pcat.deep, times, WGS72,
                                carry=carry)
    assert all(torch.equal(a, b) for a, b in zip(again, out_p))


JD = np.full(7, 2460494.5)
FR = np.linspace(-1.0, 1.5, 7)


def _assert_output_close(rj, rp, output, layout):
    rj, rp = np.asarray(rj), rp.numpy()
    axis = 0 if layout == "planes" else -1
    for c in range(3):
        d = np.abs(np.take(rj, c, axis) - np.take(rp, c, axis))
        tol = POS_TOL_KM if output == "teme" else FIXED_POS_TOL_KM
        if output in ("geodetic", "geodetic_deg") and c < 2:
            tol = 1e-9 * (RAD2DEG if output == "geodetic_deg" else 1.0)
            if c == 1:  # longitude wraps
                d = np.minimum(d, 2 * np.pi * (1.0 if output == "geodetic"
                                               else RAD2DEG) - d)
        print(f"f64 vs JAX, {output} {layout} component {c}: max "
              f"{d.max():.3e}")
        assert d.max() <= tol, (output, layout, c, d.max())


@pytest.mark.parametrize("layout", ["time_major", "sat_major", "planes"])
@pytest.mark.parametrize("output",
                         ["teme", "ecef", "geodetic", "geodetic_deg"])
def test_propagate_f64_matches_jax(mixed, output, layout):
    jcat, pcat = mixed
    rj, vj, ej = J.propagate(jcat, JD, FR, method="f64", output=output,
                             layout=layout)
    rp, vp, ep = P.propagate(pcat, JD, FR, output=output, layout=layout)
    assert tuple(rp.shape) == tuple(rj.shape) == tuple(vp.shape)
    assert rp.dtype == vp.dtype == torch.float64
    np.testing.assert_array_equal(np.asarray(ej), ep.numpy())
    assert rp.is_contiguous() and ep.is_contiguous()
    _assert_output_close(rj, rp, output, layout)
    dv = np.abs(np.asarray(vj) - vp.numpy()).max()
    print(f"f64 vs JAX, {output} {layout}: max|dv| {dv:.3e}")
    assert dv <= (VEL_TOL_KMS if output == "teme" else FIXED_VEL_TOL_KMS)


@pytest.mark.parametrize("layout", ["time_major", "sat_major", "planes"])
def test_propagate_f64_mask_scan_and_no_velocities(mixed, layout):
    """``satellite_mask`` zero-fills with error -1; ``scan_times=True``
    gives the dense call's outputs (1e-6 km); ``velocities=False``
    returns v None and the same positions; both against JAX."""
    jcat, pcat = mixed
    fr = np.sort(FR)
    mask = np.random.default_rng(4).random(len(pcat)) < 0.5
    kw = dict(layout=layout, satellite_mask=mask)
    out_j = J.propagate(jcat, JD, fr, method="f64", **kw)
    out_p = P.propagate(pcat, JD, fr, method="f64", **kw)
    _assert_close(out_j, out_p)
    sat_err = out_p[2].numpy() if layout == "sat_major" else out_p[2].numpy().T
    assert (sat_err[~mask] == -1).all() and (sat_err[mask] != -1).all()

    scan_j = J.propagate(jcat, JD, fr, method="f64", scan_times=True, **kw)
    scan_p = P.propagate(pcat, JD, fr, method="f64", scan_times=True, **kw)
    _assert_close(scan_j, scan_p)
    assert torch.equal(scan_p[2], out_p[2])
    assert (scan_p[0] - out_p[0]).abs().max().item() <= 1e-6

    r0, v0, e0 = P.propagate(pcat, JD, fr, method="f64", velocities=False,
                             **kw)
    assert v0 is None and torch.equal(r0, out_p[0])
    assert torch.equal(e0, out_p[2])


def test_propagate_tsince_matches_jax(mixed, leo):
    """The ``__graft_entry__.entry`` step: a (16, 1) grid over a day, and
    a (n_sats,) single shot, on a mixed and a near-earth catalog."""
    for jcat, pcat in (mixed, leo):
        t = np.linspace(0.0, 1440.0, 16)[:, None]
        out_j = j_propagate_tsince(jcat, t)
        out_p = P.propagate_tsince(pcat, t)
        _assert_close(out_j, out_p)
        assert tuple(out_p[0].shape) == (16, len(pcat), 3)
        if pcat.has_deep:
            direct = sdp4_propagate(pcat.els, pcat.deep, torch.from_numpy(t),
                                    WGS72)
            assert all(torch.equal(a, b) for a, b in zip(direct[:3], out_p))
        shot = np.linspace(-100.0, 100.0, len(pcat))
        _assert_close(j_propagate_tsince(jcat, shot),
                      P.propagate_tsince(pcat, shot))
        r, v, e = P.propagate_tsince(pcat, shot, velocities=False)
        assert v is None and tuple(r.shape) == (len(pcat), 3)


def test_goldens_near_earth():
    """python-sgp4's trajectory of TRAJ (WGS-84, 0.1 km / 1e-4 km/s) and
    Vallado's 00005 and 06251 vectors (WGS-72, 0.01 km / 1e-6 km/s)."""
    cat = P.build_catalog(TRAJ_L1 + "\n" + TRAJ_L2, WGS84, device="cpu")
    times = torch.tensor([row[0] for row in TRAJ_REF], dtype=torch.float64)
    r, v, err = sgp4_propagate(cat.els, times[:, None], WGS84)
    assert (err == 0).all()
    for i, (_, ref_r, ref_v) in enumerate(TRAJ_REF):
        np.testing.assert_allclose(r[i, 0].numpy(), ref_r, atol=0.1)
        np.testing.assert_allclose(v[i, 0].numpy(), ref_v, atol=1e-4)
    vallado = P.build_catalog("\n".join([
        "1 00005U 58002B   00179.78495062  .00000023  00000-0  28098-4 0  4753",
        "2 00005  34.2682 348.7242 1859667 331.7664  19.3264 10.82419157413667",
        "1 06251U 62025E   06176.82412014  .00008885  00000-0  12808-3 0  3985",
        "2 06251  58.0579  54.0425 0030035 139.1568 221.1854 15.56387291  6774",
    ]), WGS72, device="cpu")
    r, v, err = sgp4_propagate(vallado.els,
                               torch.tensor([[0.0], [360.0]],
                                            dtype=torch.float64), WGS72)
    assert (err == 0).all()
    np.testing.assert_allclose(r[0, 0].numpy(),
                               [7022.46529266, -1400.08296755, 0.03995155],
                               atol=0.01)
    np.testing.assert_allclose(v[0, 0].numpy(),
                               [1.893841015, 6.405893759, 4.534807250],
                               atol=1e-6)
    np.testing.assert_allclose(r[1, 0].numpy(),
                               [-7154.03120202, -3783.17682504,
                                -3536.19412294], atol=0.01)
    np.testing.assert_allclose(v[1, 0].numpy(),
                               [4.741887409, -4.151817765, -2.093935425],
                               atol=1e-6)
    np.testing.assert_allclose(r[0, 1].numpy(),
                               [3988.31022699, 5498.96657235, 0.90055879],
                               atol=0.01)
    np.testing.assert_allclose(v[0, 1].numpy(),
                               [-3.290032738, 2.357652820, 6.496623475],
                               atol=1e-6)


def test_goldens_deep_space():
    """GPS 20413, GEO 28626 (Lyddane) and Molniya 09880 (half-day
    resonance) at 0, 720 and 1440 minutes: 0.01 km and 1e-5 km/s."""
    cat = P.build_catalog("\n".join([GPS_L1, GPS_L2, GEO_L1, GEO_L2, HEO_L1,
                                     HEO_L2]), WGS72, device="cpu")
    t = torch.tensor([[0.0], [720.0], [1440.0]], dtype=torch.float64)
    r, v, err, _ = sdp4_propagate(cat.els, cat.deep, t, WGS72)
    assert (err == 0).all()
    r, v = r.numpy(), v.numpy()
    np.testing.assert_allclose(r[0, 0], [12743.39105131, 23518.44806062,
                                         28.23195962], atol=0.01)
    np.testing.assert_allclose(v[0, 0], [-1.93584727, 1.00575086,
                                         3.16821707], atol=1e-5)
    np.testing.assert_allclose(r[1, 0], [12513.21380970, 23633.30126287,
                                         414.75154681], atol=0.01)
    np.testing.assert_allclose(r[2, 0], [12279.27857794, 23740.96214221,
                                         801.15912584], atol=0.01)
    np.testing.assert_allclose(r[0, 1], [9727.65902952, -41014.43193269,
                                         -9.39974955], atol=0.01)
    np.testing.assert_allclose(v[0, 1], [2.99252607, 0.71003488,
                                         0.00039212], atol=1e-5)
    np.testing.assert_allclose(r[2, 1, :2], [10430.11028794,
                                             -40841.32649665], atol=0.01)
    np.testing.assert_allclose(r[0, 2], [2575.93297901, 13237.27540045,
                                         1419.07364030], atol=0.01)
    np.testing.assert_allclose(v[0, 2], [-1.59368245, 3.99224937,
                                         5.03078896], atol=1e-5)
    np.testing.assert_allclose(r[2, 2], [2175.00194988, 14214.96552375,
                                         2741.44350110], atol=0.01)


def test_differential_sample_vs_scalar_oracle():
    """120 lanes of the differential sweep (every regime of
    ``random_elements``) x 13 times over +-1 day through
    ``propagate_tsince``, against the scalar oracle at the sweep's f64
    tolerance: 1e-3 km and 1e-6 km/s."""
    fields = random_elements(120, seed=17)
    o_err, o_r, o_v = oracle_sweep(fields, SWEEP_TIMES)
    jels = J.ops.sgp4_init(J_WGS72, **fields)
    cat = P.catalog_from_elements(jels, WGS72, device="cpu")
    assert cat.has_deep and not cat.is_deep.all()
    r, v, err = P.propagate_tsince(cat, SWEEP_TIMES[:, None])
    _compare(err.numpy(), r.numpy(), v.numpy(), o_err, o_r, o_v,
             pos_tol_km=1e-3, vel_tol_kms=1e-6)
    assert float(np.asarray(fields["epoch_jd"]).mean()) == pytest.approx(
        EPOCH_JD, abs=0.5)


def test_unported_arguments_still_checked(mixed):
    pcat = mixed[1]
    with pytest.raises(ValueError, match="method"):
        P.propagate(pcat, JD, FR, method="f32")
    with pytest.raises(ValueError, match="layout"):
        P.propagate(pcat, JD, FR, layout="column_major")
    deep = deep_elements_from_numpy(mixed[0].deep, "cpu")
    assert deep.irez.dtype == torch.int32


def _screening_shell():
    """bench_screening's shell at 150 satellites: close pairs within 100
    km over an hour."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    return chip_smoke.screening_shell_text(150)


def test_screens_and_constellation_take_f64():
    """``screen_all``, ``screen_target`` and ``Constellation.propagate``
    run with ``method="f64"``: the pairs and epochs of the JAX package's
    f64 screen on a shell with close pairs (distances within 1e-3 km, the
    f32 positions both screens take), the target's per-satellite minimum
    distances within 1e-3 km, and the constellation's outputs those of
    the module-level call."""
    text = _screening_shell()
    jcat, pcat = _jax_catalog(text), P.build_catalog(text, device="cpu")
    jd = 2460311.0 + np.arange(60.0) / 1440.0
    ji, jj, jdist, jt = J.screen_all(jcat, jd, threshold_km=100.0,
                                     method="f64")
    pi, pj, pdist, pt = P.screen_all(pcat, jd, threshold_km=100.0,
                                     method="f64")
    assert len(pi) > 0
    np.testing.assert_array_equal(ji, pi)
    np.testing.assert_array_equal(jj, pj)
    np.testing.assert_array_equal(jt, pt)
    assert np.abs(jdist - pdist).max() <= 1e-3
    target = "\n".join(text.splitlines()[:2])
    jmin = J.screen_target(jcat, target, jd, method="f64")[0]
    pmin = P.screen_target(pcat, target, jd, method="f64")[0]
    assert np.abs(np.asarray(jmin) - pmin.numpy()).max() <= 1e-3
    con = P.Constellation(text, device="cpu")
    got = con.propagate(np.arange(60.0), start_time=2460311.0, method="f64")
    ref = P.propagate(pcat, jd, method="f64")
    assert all(torch.equal(a, b) for a, b in zip(got, ref))

