"""The mixed near-earth / deep-space slice end to end: astroz_tpu_torch
``build_catalog`` -> ``propagate(method="fast")`` against astroz_tpu on
the same TLE text, and the merge kernel K3's plain version against the
TPU kernel in interpret mode.

The catalog is ``tests/test_escape.py``'s MIXED_TEXT ten times over (50
satellites: 20 near-earth, 10 GPS, 10 GEO on the Lyddane branch, 10
Molniya-class escape lanes). The JAX side runs with its shallow drag
term corrected (``jax_drag_fixed``, see ``test_torch_fast.py``).
Tolerances, each with the value measured on these inputs:

* Against the JAX fast path on XLA:CPU and the TPU kernels in interpret
  mode: positions 0.05 km, velocities 5e-5 km/s, the JAX package's own
  Pallas-vs-XLA gate (one f32 ulp is 3.9 m at GEO radius); measured
  0.012 km and 1.4e-6 km/s against XLA, 0.012 km and 4.1e-6 km/s
  against interpret mode. Geodetic angles get 1e-5 rad (0.05 km at the
  surface), measured 2.4e-7 rad.
* The escape columns against the JAX f64 path: 5e-3 km and 5e-6 km/s
  (the gate of ``tests/test_escape.py``); measured 1.6e-3 km and
  2.4e-7 km/s, the f32 rounding of the outputs.

Error codes are identical everywhere.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

import astroz_tpu as J
from astroz_tpu import propagation as jprop
from astroz_tpu.ops import pallas_sgp4
import astroz_tpu_torch as P
from astroz_tpu_torch.constants import WGS72
from astroz_tpu_torch.ops import cuda_sgp4
from astroz_tpu_torch.propagation import (HEO_ESCAPE_ECC, _apply_escape,
                                          resonance_steps)

from test_escape import MIXED_TEXT
from test_torch_fast import jax_drag_fixed  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

TEXT = "\n".join([MIXED_TEXT] * 10)
#: minutes from the earliest epoch (the near-earth lanes'); the deep
#: lanes' epochs lie ~185 days later, so they run backward
T_MIN = np.linspace(-250.0, 2000.0, 9)

POS_TOL_KM = 0.05
VEL_TOL_KMS = 5e-5
ANGLE_TOL_RAD = 1e-5


@pytest.fixture(scope="module")
def cats():
    jcat = J.build_catalog(TEXT)
    pcat = P.build_catalog(TEXT, device="cpu")
    jd = np.full(len(T_MIN), pcat.epoch_min_jd)
    return jcat, pcat, jd, T_MIN / 1440.0


@pytest.fixture
def jax_fixed(jax_drag_fixed):
    """``jax_drag_fixed``, with the caches of the jitted JAX mixed-path
    entry points cleared while the patch holds and after it."""
    jitted = (jprop._propagate_fast_partitioned, jprop._propagate_fast_fused,
              pallas_sgp4.propagate_fast_pallas_sep_merge)
    for f in jitted:
        f.clear_cache()
    yield
    for f in jitted:
        f.clear_cache()


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def test_heo_escape_lanes(cats):
    """The escape takes exactly the deep subset's half-day resonant lanes
    with e > 0.7, the JAX package's lanes."""
    jcat, pcat = cats[:2]
    esc = pcat.heo_escape
    irez = np.asarray(pcat.deep_host.irez)[pcat.deep_idx]
    ecc = pcat.host.ecco[pcat.deep_idx]
    expect = np.nonzero((irez == 2) & (ecc > HEO_ESCAPE_ECC))[0]
    assert len(expect) == 10
    np.testing.assert_array_equal(esc.idx.numpy(), expect)
    np.testing.assert_array_equal(
        np.sort(pcat.deep_idx[esc.idx.numpy()]),
        np.sort(np.asarray(jcat.deep_idx)[np.asarray(jcat.heo_escape[4])]))
    els, deep = cuda_sgp4.f64_unstage(*esc.staged)
    assert (deep.irez == 2).all() and (els.ecco > 0.7).all()
    no_escape = P.build_catalog("\n".join(MIXED_TEXT.splitlines()[:6]),
                                device="cpu")
    assert no_escape.n_deep == 2 and no_escape.heo_escape is None


@pytest.mark.parametrize("layout,output", [("time_major", "teme"),
                                           ("sat_major", "ecef"),
                                           ("planes", "geodetic")])
def test_propagate_matches_jax(cats, jax_fixed, layout, output):
    jcat, pcat, jd, fr = cats
    rj, vj, ej = J.propagate(jcat, jd, fr, method="fast", output=output,
                             layout=layout)
    rp, vp, ep = P.propagate(pcat, jd, fr, method="fast", output=output,
                             layout=layout)
    assert tuple(rp.shape) == tuple(rj.shape)
    assert tuple(vp.shape) == tuple(vj.shape)
    assert rp.dtype == vp.dtype == torch.float32 and ep.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ej), ep.numpy())
    if output == "geodetic":
        rj, rp = np.asarray(rj), rp.numpy()
        d = np.abs(rj[:2] - rp[:2])
        d[1] = np.minimum(d[1], 2 * np.pi - d[1])  # longitude wraps
        assert d.max() <= ANGLE_TOL_RAD
        assert _max_abs(rj[2], rp[2]) <= POS_TOL_KM
    else:
        assert _max_abs(rj, rp) <= POS_TOL_KM
    assert _max_abs(vj, vp) <= VEL_TOL_KMS


def test_velocities_false(cats, jax_fixed):
    """v is None; positions match JAX and are bit-equal to the port's own
    positions with velocities."""
    jcat, pcat, jd, fr = cats
    rj, vj, ej = J.propagate(jcat, jd, fr, method="fast", velocities=False)
    rp, vp, ep = P.propagate(pcat, jd, fr, method="fast", velocities=False)
    assert vj is None and vp is None
    np.testing.assert_array_equal(np.asarray(ej), ep.numpy())
    assert _max_abs(rj, rp) <= POS_TOL_KM
    r_vel, _, e_vel = P.propagate(pcat, jd, fr, method="fast")
    assert torch.equal(rp, r_vel) and torch.equal(ep, e_vel)


def _port_planes(pcat, jd, fr):
    """K2's plain version, the escape, then K3's plain version: the
    (3, T, S) planes of the mixed path, and the deep planes."""
    st, ds = pcat.fast_staging, pcat.fast_staging.deep
    t_time = torch.as_tensor(((jd - pcat.epoch_min_jd) + fr) * 1440.0)
    steps = resonance_steps(jd + fr, pcat.deep_epochs_jd)
    deep = list(cuda_sgp4.propagate_deep_sep(
        t_time, ds.t_sat, ds.spine, ds.tail, ds.flags,
        pcat.resonance_tables(steps), grav=WGS72,
        kepler_iters=pcat.deep_kepler_iters))
    _apply_escape(pcat.heo_escape, pcat.resonance_tables(steps), t_time,
                  WGS72, True, *deep)
    args = (t_time, st.t_sat, st.spine, st.tail, st.flags, ds.slot, *deep)
    return args, steps


def test_merge_twin_matches_fused_interpret(cats, jax_fixed):
    """K3's plain version (on K2's plain planes with the escape applied)
    against the JAX package's fused Pallas path in interpret mode: the
    TPU kernels K2 and K3 with the same escape."""
    jcat, pcat, jd, fr = cats
    args, steps = _port_planes(pcat, jd, fr)
    r3, v3, err = cuda_sgp4.propagate_fast_sep_merge_reference(
        *args, grav=WGS72, kepler_iters=pcat.kepler_iters)

    onehot, keep, _k, g, els_p, deep_p, t_sat_p = jcat.merge_staging
    esc = jcat.heo_escape
    t_time = jax.numpy.asarray(((jd - jcat.epoch_min_jd) + fr) * 1440.0)
    rj, vj, ej = jprop._propagate_fast_fused(
        jcat.els, els_p, deep_p, onehot, keep, t_time,
        jcat.fast_staging[0], t_sat_p, jax.numpy.asarray(jd + fr)[:, None],
        jcat.grav, "teme", True, jcat.kepler_iters, steps, "planes",
        jprop._resonance_window(jcat.deep_epochs_jd),
        jcat.resonance_tables_packed(steps), g, interpret=True,
        deep_kepler_iters=jcat.deep_kepler_iters,
        escape=(esc[0], esc[1], esc[2], esc[3], jcat.escape_tables(steps)))
    np.testing.assert_array_equal(np.asarray(ej), err.numpy())
    assert _max_abs(rj, r3) <= POS_TOL_KM
    assert _max_abs(vj, v3) <= VEL_TOL_KMS


def test_merge_select_does_not_leak(cats):
    """inf and NaN planted in the shallow fields of the deep columns never
    reach the output: the merge selects the deep planes there."""
    pcat, jd, fr = cats[1:]
    args, _ = _port_planes(pcat, jd, fr)
    deep_cols = torch.as_tensor(pcat.deep_idx)
    tail = args[3].clone()
    tail[:, deep_cols] = torch.where(
        torch.arange(tail.shape[0])[:, None] % 2 == 0, float("inf"),
        float("nan"))
    spine = args[2].clone()
    spine[0, deep_cols] = float("nan")
    planted = (args[0], args[1], spine, tail) + args[4:]
    kw = dict(grav=WGS72, kepler_iters=pcat.kepler_iters)
    shallow = cuda_sgp4.propagate_fast_sep_reference(*planted[:5], **kw)
    assert not torch.isfinite(shallow[0][:, :, deep_cols]).any()
    r3, v3, err = cuda_sgp4.propagate_fast_sep_merge(*planted, **kw)
    dr, dv, de = args[6:]
    assert torch.isfinite(r3).all() and torch.isfinite(v3).all()
    assert torch.equal(r3[:, :, deep_cols], dr)
    assert torch.equal(v3[:, :, deep_cols], dv)
    assert torch.equal(err[:, deep_cols], de)
    clean = cuda_sgp4.propagate_fast_sep_merge(*args, **kw)
    assert torch.equal(r3, clean[0]) and torch.equal(err, clean[2])


def test_escape_columns_match_jax_f64(cats):
    """Over +-0.5 day around the deep epochs the escape columns of the
    port's fast path are the JAX f64 path's to f32 rounding."""
    jcat, pcat = cats[:2]
    jd = pcat.deep_epochs_jd[0] + np.linspace(-0.5, 0.5, 9)
    rp, vp, ep = P.propagate(pcat, jd, method="fast")
    r64, v64, e64 = J.propagate(jcat, jd, method="f64")
    cols = pcat.deep_idx[pcat.heo_escape.idx.numpy()]
    np.testing.assert_array_equal(np.asarray(e64)[:, cols],
                                  ep.numpy()[:, cols])
    dr = np.linalg.norm(np.asarray(r64)[:, cols]
                        - rp.numpy()[:, cols].astype(np.float64), axis=-1)
    dv = np.linalg.norm(np.asarray(v64)[:, cols]
                        - vp.numpy()[:, cols].astype(np.float64), axis=-1)
    assert dr.max() < 5e-3 and dv.max() < 5e-6


def test_deep_slots_by_regime_move_no_bit(cats, monkeypatch):
    """K2's slots are grouped by regime (Lyddane lanes apart, then by
    resonance), and a mixed ``propagate(method="fast")`` gives the
    outputs of the catalog-order slots bit for bit, escape lanes
    included."""
    pcat, jd, fr = cats[1:]
    key = ((pcat.host.inclo[pcat.deep_idx] < P.propagation.LYDDANE_INCL) * 3
           + np.asarray(pcat.deep_host.irez)[pcat.deep_idx])
    assert (np.diff(key) >= 0).all() and len(set(key.tolist())) > 1
    assert not (np.diff(pcat.deep_idx) > 0).all()
    monkeypatch.setattr(P.propagation, "deep_slots",
                        lambda host, deep: np.nonzero(host.is_deep)[0])
    plain = P.build_catalog(TEXT, device="cpu")
    assert (np.diff(plain.deep_idx) > 0).all()
    for kw in (dict(layout="planes"), dict(velocities=False)):
        got = P.propagate(pcat, jd, fr, method="fast", **kw)
        ref = P.propagate(plain, jd, fr, method="fast", **kw)
        assert all(a is b is None or torch.equal(a, b)
                   for a, b in zip(got, ref))


def test_mixed_path_runs_the_deep_and_merge_wrappers(cats, monkeypatch):
    """A mixed propagate reaches K2's and K3's wrappers once each and
    K1's never."""
    pcat, jd, fr = cats[1:]
    calls = []

    def spy(name, real):
        def f(*args, **kw):
            calls.append(name)
            return real(*args, **kw)
        return f

    for name in ("propagate_fast_sep", "propagate_deep_sep",
                 "propagate_fast_sep_merge"):
        monkeypatch.setattr(P.propagation, name,
                            spy(name, getattr(P.propagation, name)))
    P.propagate(pcat, jd, fr, method="fast", layout="planes")
    assert calls == ["propagate_deep_sep", "propagate_fast_sep_merge"]


def test_headline_generator_matches_bench():
    """``chip_smoke.mixed_catalog_text`` is bench.py's generator: the same
    text for a small n, and at the headline 13,478 satellites 667 deep
    lanes, 14 of them escape lanes."""
    sys.path.insert(0, REPO)
    try:
        import bench
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    assert (chip_smoke.mixed_catalog_text(300)
            == bench.synthetic_catalog_text(300))
    cat = P.build_catalog(chip_smoke.mixed_catalog_text(chip_smoke.N_SATS),
                          device="cpu")
    assert cat.n_deep == chip_smoke.HEADLINE_DEEP == 667
    assert len(cat.heo_escape.idx) == chip_smoke.HEADLINE_ESCAPE == 14
