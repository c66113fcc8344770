"""astroz_tpu_torch ``spacecraft`` and ``montecarlo`` against astroz_tpu
on the CPU: every spacecraft and Monte-Carlo case of
``tests/test_mission_mc.py``, run on the port beside JAX on the same
numpy states (its three mission-plan cases run in
``tests/test_torch_io.py``).

Tolerances: ``Spacecraft.propagate`` with impulses and the abnormal-orbit
guard: the same samples and cut index as JAX, 1e-6 km;
``propagate_attitude`` 1e-12; the delta-v formulas are the same numpy
code, so equal; ``run_hohmann_monte_carlo``: ``torch.Generator`` draws
other samples than ``jax.random``, so each mean is held within 4
combined standard errors of JAX's, with ``n + n_failed`` equal to the
sample count and the same CSV header.
"""

import numpy as np
import pytest
import torch

import astroz_tpu.montecarlo as JM
import astroz_tpu.spacecraft as JS
from astroz_tpu import tle as jtle

import astroz_tpu_torch.montecarlo as M
import astroz_tpu_torch.spacecraft as S
from astroz_tpu_torch import tle as ptle
from astroz_tpu_torch.calculations import state_to_elements
from astroz_tpu_torch.constants import EARTH

from test_sgp4 import TRAJ_L1, TRAJ_L2

torch.set_num_threads(1)

RE = EARTH.eq_radius
MU = EARTH.mu


def circular_pair(alt=700.0, **kw):
    """The same circular-orbit spacecraft in both packages."""
    r = RE + alt
    vc = np.sqrt(MU / r)
    state = np.array([r, 0, 0, 0, vc, 0])
    return (S.Spacecraft(state=state.copy(), mass_kg=500.0,
                         size=S.SatelliteSize.MEDIUM, device="cpu", **kw),
            JS.Spacecraft(state=state.copy(), mass_kg=500.0,
                          size=JS.SatelliteSize.MEDIUM, **kw))


def propagate_both(sc, jsc, *args, impulses=()):
    """Propagate both spacecraft; the port must give JAX's sample times
    and states within 1e-6 km. Returns the port's (times, states)."""
    jimp = [JS.Impulse(**{**vars(i), "kind": JS.ImpulseKind(i.kind.value)})
            for i in impulses]
    times, states = sc.propagate(*args, impulses=impulses)
    jtimes, jstates = jsc.propagate(*args, impulses=jimp)
    assert isinstance(states, np.ndarray) and states.dtype == np.float64
    np.testing.assert_array_equal(times, jtimes)
    assert states.shape == jstates.shape
    assert np.abs(states[:, :3] - jstates[:, :3]).max() <= 1e-6
    assert np.abs(sc.state[:3] - jsc.state[:3]).max() <= 1e-6
    return times, states


def sma(state):
    return float(state_to_elements(state[:3], state[3:],
                                   device="cpu").semi_major_axis)


def test_spacecraft_from_tle_propagates():
    sc = S.Spacecraft.from_tle(ptle.parse_lines(TRAJ_L1, TRAJ_L2),
                               device="cpu")
    jsc = JS.Spacecraft.from_tle(jtle.parse_lines(TRAJ_L1, TRAJ_L2))
    np.testing.assert_allclose(sc.state, jsc.state, rtol=1e-12, atol=1e-12)
    _, states = propagate_both(sc, jsc, 0.0, 0.1, 10.0)
    rn = np.linalg.norm(states[:, :3], axis=-1)
    assert np.all((rn > RE + 200) & (rn < RE + 800))


def test_prograde_impulse_raises_orbit():
    sc, jsc = circular_pair(700.0)
    a0 = sma(sc.state)
    imp = S.Impulse(time=600.0, kind=S.ImpulseKind.PROGRADE, magnitude=0.1)
    propagate_both(sc, jsc, 0.0, 0.05, 10.0, impulses=[imp])
    assert sma(sc.state) > a0 + 100.0  # 100 m/s prograde: +~350 km sma


def test_plane_change_impulse_changes_inclination():
    sc, jsc = circular_pair(700.0)
    di = np.deg2rad(5.0)
    imp = S.Impulse(time=300.0, kind=S.ImpulseKind.PLANE_CHANGE,
                    delta_inclination=di)
    propagate_both(sc, jsc, 0.0, 0.02, 5.0, impulses=[imp])
    el = state_to_elements(sc.state[:3], sc.state[3:], device="cpu")
    assert abs(float(el.inclination) - di) < np.deg2rad(0.5)


@pytest.mark.parametrize("kind", ["absolute", "phase", "mixed"])
def test_impulse_kinds_match_jax(kind):
    """The other impulse kinds, and several impulses in one run (one
    outside the window, dropped), against JAX."""
    sc, jsc = circular_pair(600.0)
    imps = {
        "absolute": [S.Impulse(time=400.0, delta_v=[0.0, 0.02, 0.01])],
        "phase": [S.Impulse(time=250.0, kind=S.ImpulseKind.PHASE,
                            phase_change=np.deg2rad(10.0))],
        "mixed": [S.Impulse(time=900.0, kind=S.ImpulseKind.PLANE_CHANGE,
                            delta_inclination=-0.01, delta_raan=0.02),
                  S.Impulse(time=120.0, kind=S.ImpulseKind.PROGRADE,
                            magnitude=-0.02),
                  S.Impulse(time=1e7, kind=S.ImpulseKind.PROGRADE,
                            magnitude=1.0)],
    }[kind]
    times, _ = propagate_both(sc, jsc, 0.0, 0.015, 20.0, impulses=imps)
    # one sample before and one after each impulse inside the window
    in_window = sum(1 for i in imps if i.time <= 0.015 * 86400.0)
    assert len(times) == int(0.015 * 86400.0 / 20.0) + 1 + in_window


def test_phase_change_dv_formula():
    dv, t_phase = S.phase_change_dv(7000.0, np.deg2rad(10.0))
    assert (dv, t_phase) == JS.phase_change_dv(7000.0, np.deg2rad(10.0))
    assert 0.0 < dv < 0.2
    t_orig = 2 * np.pi * np.sqrt(7000.0 ** 3 / MU)
    assert t_phase < t_orig  # positive phase shift -> faster orbit


def test_plane_change_dv_small_angle():
    v = 7.5
    dv = S.plane_change_dv(v, np.deg2rad(1.0), 0.0, np.deg2rad(51.6))
    assert dv == JS.plane_change_dv(v, np.deg2rad(1.0), 0.0,
                                    np.deg2rad(51.6))
    assert abs(dv - 2 * v * np.sin(np.deg2rad(0.5))) < 1e-12


def test_abnormal_orbit_guard():
    """An escape orbit is cut at the same sample as in JAX, and the
    spacecraft keeps the last good state."""
    r = RE + 500.0
    v_esc = np.sqrt(2 * MU / r) * 1.1
    state = np.array([r, 0, 0, 0, v_esc, 0])
    sc = S.Spacecraft(state=state.copy(), device="cpu")
    jsc = JS.Spacecraft(state=state.copy())
    times, states = propagate_both(sc, jsc, 0.0, 0.5, 60.0)
    assert times[-1] < 0.5 * 86400.0
    assert len(times) < int(0.5 * 86400.0 / 60.0) + 1
    np.testing.assert_array_equal(sc.state, states[-1])


def test_attitude_triad_and_propagation():
    sc, jsc = circular_pair()
    v1 = np.array([1.0, 0.0, 0.0])
    v2 = np.array([0.0, 1.0, 0.0])
    sc.update_attitude(v1, v2, v1, v2)  # identity attitude
    np.testing.assert_allclose(sc.quaternion, [1, 0, 0, 0], atol=1e-12)
    for s in (sc, jsc):
        s.angular_velocity = np.array([0.0, 0.0, 0.1])
        s.inertia_diag = np.array([2.0, 3.0, 4.0])
        s.propagate_attitude(0.1, 10.0, torque=(0.0, 0.001, 0.0))
    np.testing.assert_allclose(sc.quaternion, jsc.quaternion, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(sc.angular_velocity, jsc.angular_velocity,
                               rtol=1e-12, atol=1e-12)
    sc, _ = circular_pair()
    sc.angular_velocity = np.array([0.0, 0.0, 0.1])
    sc.propagate_attitude(0.1, 10.0)
    # rotated about z by ~1 rad: q = [cos .5, 0, 0, sin .5]
    assert abs(sc.quaternion[0] - np.cos(0.5)) < 1e-6
    assert abs(sc.quaternion[3] - np.sin(0.5)) < 1e-6


def _assert_stats_match(res, jres):
    """Each metric's mean within 4 combined standard errors of JAX's."""
    for name, s in res.items():
        j = jres[name]
        se = np.hypot(s.std / np.sqrt(s.n), j.std / np.sqrt(j.n))
        assert abs(s.mean - j.mean) <= 4 * se + 1e-12 * abs(j.mean), name
        assert s.n + s.n_failed == j.n + j.n_failed


def test_monte_carlo_statistics(tmp_path):
    cfg = dict(n_samples=2000, r1_sigma_km=5.0, r2_sigma_km=20.0)
    res = M.run_hohmann_monte_carlo(M.MonteCarloConfig(**cfg), device="cpu")
    _assert_stats_match(res, JM.run_hohmann_monte_carlo(
        JM.MonteCarloConfig(**cfg)))
    tot = res["total_delta_v"]
    assert abs(tot.mean - 3.85) < 0.1  # LEO->GEO ~3.85 km/s
    assert tot.std > 0
    assert tot.ci95_low < tot.mean < tot.ci95_high
    assert tot.n + tot.n_failed == 2000
    # CI shrinks with more samples
    res_small = M.run_hohmann_monte_carlo(
        M.MonteCarloConfig(n_samples=100, r1_sigma_km=5.0, r2_sigma_km=20.0),
        device="cpu")
    width_big = tot.ci95_high - tot.ci95_low
    ts = res_small["total_delta_v"]
    assert width_big < (ts.ci95_high - ts.ci95_low)
    # the same seed draws the same samples
    again = M.run_hohmann_monte_carlo(M.MonteCarloConfig(**cfg),
                                      device="cpu")
    assert again == res
    # CSV export: the same header and rows as JAX's writer
    p, jp = tmp_path / "mc.csv", tmp_path / "jmc.csv"
    M.export_csv(res, str(p))
    JM.export_csv(res, str(jp))
    assert p.read_text().startswith("metric,mean")
    assert p.read_text() == jp.read_text()


def test_monte_carlo_mu_sigma_has_effect():
    base = M.run_hohmann_monte_carlo(M.MonteCarloConfig(
        n_samples=500, r1_sigma_km=0.0, r2_sigma_km=0.0, mu_sigma=0.0),
        device="cpu")
    wide_cfg = dict(n_samples=500, r1_sigma_km=0.0, r2_sigma_km=0.0,
                    mu_sigma=2000.0)
    wide = M.run_hohmann_monte_carlo(M.MonteCarloConfig(**wide_cfg),
                                     device="cpu")
    _assert_stats_match(wide, JM.run_hohmann_monte_carlo(
        JM.MonteCarloConfig(**wide_cfg)))
    assert base["total_delta_v"].std < 1e-12
    assert wide["total_delta_v"].std > 1e-5


def test_monte_carlo_failed_samples_are_counted():
    """Radii drawn within 1 km of each other are failures: dropped from
    the statistics and counted, in both packages."""
    cfg = dict(n_samples=4000, r1_km=10000.0, r2_km=10000.5,
               r1_sigma_km=1.0, r2_sigma_km=1.0)
    res = M.run_hohmann_monte_carlo(M.MonteCarloConfig(**cfg), device="cpu")
    jres = JM.run_hohmann_monte_carlo(JM.MonteCarloConfig(**cfg))
    tot, jtot = res["total_delta_v"], jres["total_delta_v"]
    assert tot.n + tot.n_failed == 4000 and 0 < tot.n_failed < 4000
    # P(|r2 - r1| <= 1) with r2 - r1 ~ N(0.5, sqrt(2)): ~0.50
    assert abs(tot.n_failed - jtot.n_failed) < 0.1 * 4000
