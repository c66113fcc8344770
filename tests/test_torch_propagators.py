"""astroz_tpu_torch ``propagators`` against astroz_tpu on the CPU: every
case of ``tests/test_propagators.py``, run on the port beside JAX on the
same numpy states, plus each force model and integrator one by one, the
dtype of every entry point, its device rule, and the public names of
the ported modules.

Tolerances:

* every force model: rtol 1e-12, atol 1e-12 (km/s^2) of JAX; J2-J4 also
  rtol 1e-9 of ``torch.autograd.grad`` of the zonal potential, as the
  reference holds them to ``jax.grad``;
* RK4 ``propagate_fixed``, 32 lanes over one orbit at 60 s: 1e-8 km of
  JAX; longer fixed-step runs (10 orbits at 10 s): 1e-6 km;
* DP8(7): the same substep count as JAX, and 1e-6 km, over 10 orbits
  (the reference's energy case runs 100; 10 keep the CPU run short);
* ``propagate_numerical``, both integrators: 1e-6 km.
"""

import ast
import inspect
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import astroz_tpu.propagators as JP
import astroz_tpu.propagators.integrators as JI
from astroz_tpu.api import Satrec as JSatrec

import astroz_tpu_torch.calculations as C
import astroz_tpu_torch.propagators as P
import astroz_tpu_torch.propagators.integrators as PI
from astroz_tpu_torch.api import Satrec
from astroz_tpu_torch.constants import AU_KM, EARTH

from test_sgp4 import ISS_L1, ISS_L2

torch.set_num_threads(1)

MU = EARTH.mu
RE = EARTH.eq_radius
TOL = dict(rtol=1e-12, atol=1e-12)


def circular_state(alt_km=500.0, incl=0.9):
    r = RE + alt_km
    vc = np.sqrt(MU / r)
    return np.array([r, 0.0, 0.0,
                     0.0, vc * np.cos(incl), vc * np.sin(incl)])


def energy(states):
    states = np.asarray(states)
    r = np.linalg.norm(states[..., :3], axis=-1)
    v = np.linalg.norm(states[..., 3:], axis=-1)
    return 0.5 * v * v - MU / r


def period(alt_km):
    return 2 * np.pi * np.sqrt((RE + alt_km) ** 3 / MU)


def max_dr(port, ref):
    """Largest position difference (km) of two (..., 6) trajectories."""
    d = port.numpy()[..., :3] - np.asarray(ref)[..., :3]
    return float(np.abs(d).max())


def random_states(n, seed):
    """``n`` states from 150 km to GEO radius, every direction."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(n, 3))
    r *= (RE + rng.uniform(150.0, 36000.0, n))[:, None] \
        / np.linalg.norm(r, axis=-1, keepdims=True)
    v = rng.normal(0.0, 4.0, (n, 3))
    return r, v


# ---------------------------------------------------------------------------
# Zonal formulas vs potential gradient
# ---------------------------------------------------------------------------


def zonal_potential(r_vec, n):
    """Force function V = mu/r (... - Jn (R/r)^n Pn(z/r)) for one term."""
    r = torch.linalg.vector_norm(r_vec)
    s = r_vec[2] / r
    if n == 2:
        pn, jn = 0.5 * (3 * s ** 2 - 1), EARTH.j2
    elif n == 3:
        pn, jn = 0.5 * (5 * s ** 3 - 3 * s), EARTH.j3
    else:
        pn, jn = 0.125 * (35 * s ** 4 - 30 * s ** 2 + 3), EARTH.j4
    return -MU / r * jn * (RE / r) ** n * pn


@pytest.mark.parametrize("n,name", [(2, "J2"), (3, "J3"), (4, "J4")])
def test_zonal_accel_is_potential_gradient(n, name):
    rng = np.random.default_rng(n)
    model, jmodel = getattr(P, name)(), getattr(JP, name)()
    for _ in range(5):
        r_vec = rng.normal(size=3)
        r_vec = r_vec / np.linalg.norm(r_vec) * rng.uniform(6800, 42000)
        rt = torch.tensor(r_vec, requires_grad=True)
        (a_ref,) = torch.autograd.grad(zonal_potential(rt, n), rt)
        a = model(torch.from_numpy(r_vec), torch.zeros(3, dtype=rt.dtype),
                  0.0)
        np.testing.assert_allclose(a.numpy(), a_ref.numpy(), rtol=1e-9,
                                   atol=1e-18)
        np.testing.assert_allclose(
            a.numpy(), np.asarray(jmodel(jnp.asarray(r_vec), jnp.zeros(3),
                                         0.0)), **TOL)


def test_j3_j4_much_smaller_than_j2():
    r = torch.from_numpy(circular_state()[:3])
    v = torch.zeros(3, dtype=r.dtype)
    a2 = float(torch.linalg.vector_norm(P.J2()(r, v, 0.0)))
    a3 = float(torch.linalg.vector_norm(P.J3()(r, v, 0.0)))
    a4 = float(torch.linalg.vector_norm(P.J4()(r, v, 0.0)))
    assert a3 < 0.01 * a2
    assert a4 < 0.01 * a2


def test_j2_magnitude_formula():
    r = RE + 500.0
    a = P.J2()(torch.tensor([r, 0.0, 0.0], dtype=torch.float64),
               torch.zeros(3, dtype=torch.float64), 0.0)
    expected = 1.5 * EARTH.j2 * MU * RE ** 2 / r ** 4
    assert abs(float(torch.linalg.vector_norm(a)) / expected - 1.0) < 0.01


def test_j2_nodal_regression_direction():
    """Prograde orbit under J2 regresses westward, at Vallado's rate
    within 1%; the trajectory within 1e-6 km of JAX."""
    state = circular_state(700.0, incl=np.deg2rad(51.6))
    per = period(700.0)
    _, states = P.propagate_fixed(P.Composite([P.TwoBody(), P.J2()]), state,
                                  0.0, 10 * per, 10.0, device="cpu")
    _, ref = JP.propagate_fixed(JP.Composite([JP.TwoBody(), JP.J2()]),
                                state, 0.0, 10 * per, 10.0)
    assert max_dr(states, ref) <= 1e-6
    s = states.numpy()
    h = np.cross(s[:, :3], s[:, 3:])
    node = np.arctan2(h[:, 0], -h[:, 1])
    dnode = np.unwrap(node) - node[0]
    assert dnode[-1] < -1e-4  # westward
    n_mm = np.sqrt(MU / (RE + 700.0) ** 3)
    rate_ref = -1.5 * n_mm * EARTH.j2 * (RE / (RE + 700.0)) ** 2 \
        * np.cos(np.deg2rad(51.6))
    rate = dnode[-1] / (10 * per)
    assert abs(rate / rate_ref - 1.0) < 0.01


# ---------------------------------------------------------------------------
# Integrators
# ---------------------------------------------------------------------------


def _count_jax_substeps(monkeypatch):
    """Patch the JAX integrators' ``dp87_adaptive`` (as the JAX
    ``DormandPrince87.step`` calls it) to count its substeps."""
    counted = []
    inner = JI.dp87_adaptive

    def counting(*args, **kwargs):
        out = inner(*args, **kwargs)
        counted.append(int(out[2]))
        return out

    monkeypatch.setattr(JI, "dp87_adaptive", counting)
    return counted


def test_two_body_energy_conservation_dp87_10_orbits(monkeypatch):
    state = circular_state(800.0)
    per = period(800.0)
    integ = P.DormandPrince87(P.TwoBody(), rtol=1e-12, atol=1e-12,
                              device="cpu")
    _, states = P.Propagator(integ).propagate(state, 0.0, 10 * per, per)
    counted = _count_jax_substeps(monkeypatch)
    jinteg = JP.DormandPrince87(JP.TwoBody(), rtol=1e-12, atol=1e-12)
    _, ref = JP.Propagator(jinteg).propagate(state, 0.0, 10 * per, per)
    assert integ.n_substeps == sum(counted) > 10
    assert max_dr(states, ref) <= 1e-6
    e = energy(states)
    assert np.abs(e / e[0] - 1.0).max() < 1e-10


def test_circular_orbit_returns_to_start():
    state = circular_state(500.0)
    per = period(500.0)
    prop = P.Propagator(P.DormandPrince87(P.TwoBody(), rtol=1e-12,
                                          atol=1e-12, device="cpu"))
    end = prop.propagate_to(state, 0.0, per, per)
    ref = JP.Propagator(JP.DormandPrince87(JP.TwoBody(), rtol=1e-12,
                                           atol=1e-12)).propagate_to(
        state, 0.0, per, per)
    assert max_dr(end, ref) <= 1e-6
    assert np.linalg.norm(end.numpy()[:3] - state[:3]) < 0.001  # < 1 m


def test_dp87_beats_rk4():
    state = circular_state(500.0)
    per = period(500.0)
    dt = per / 20.0
    rk4_tr = P.Propagator(P.Rk4(P.TwoBody(), device="cpu")).propagate(
        state, 0.0, per, dt)[1]
    dp_tr = P.Propagator(P.DormandPrince87(P.TwoBody(), device="cpu")
                         ).propagate(state, 0.0, per, dt)[1]
    assert max_dr(rk4_tr, JP.Propagator(JP.Rk4(JP.TwoBody())).propagate(
        state, 0.0, per, dt)[1]) <= 1e-8
    assert max_dr(dp_tr, JP.Propagator(JP.DormandPrince87(JP.TwoBody())
                                       ).propagate(state, 0.0, per, dt)[1]
                  ) <= 1e-6
    err_rk4 = abs(energy(rk4_tr)[-1] / energy(rk4_tr)[0] - 1.0)
    err_dp = abs(energy(dp_tr)[-1] / energy(dp_tr)[0] - 1.0)
    assert err_dp < err_rk4 / 100.0


def test_fixed_step_batched():
    """32 perturbed lanes through one fixed-step call, RK4 at 60 s over
    one orbit: within 1e-8 km of JAX."""
    base = circular_state(600.0)
    batch = base[None, :] + np.random.default_rng(0).normal(
        0, 1e-3, (32, 6))
    times, states = P.propagate_fixed(P.TwoBody(), batch, 0.0, 5400.0, 60.0,
                                      device="cpu")
    jtimes, ref = JP.propagate_fixed(JP.TwoBody(), batch, 0.0, 5400.0, 60.0)
    assert states.shape == (91, 32, 6)
    assert states.dtype == torch.float64
    np.testing.assert_array_equal(times, jtimes)
    assert max_dr(states, ref) <= 1e-8
    e = energy(states)
    assert np.abs(e[-1] / e[0] - 1.0).max() < 1e-5  # rk4 at 60 s


@pytest.mark.parametrize("method,substeps", [("rk4", 3), ("dp87", 1)])
def test_fixed_step_methods_and_substeps(method, substeps):
    """The other branches of propagate_fixed: RK4 sub-stepping and the
    fixed-step DP8 step, with a drag-bearing model, against JAX."""
    state = circular_state(300.0)[None] + np.random.default_rng(1).normal(
        0, 1e-3, (4, 6))
    accel = P.earth_default_forces(drag=True)
    jaccel = JP.earth_default_forces(drag=True)
    _, s = P.propagate_fixed(accel, state, 10.0, 1800.0, 120.0,
                             method=method, substeps=substeps, device="cpu")
    _, ref = JP.propagate_fixed(jaccel, state, 10.0, 1800.0, 120.0,
                                method=method, substeps=substeps)
    assert s.shape == (16, 4, 6)
    assert max_dr(s, ref) <= 1e-8
    with pytest.raises(ValueError, match="method"):
        P.propagate_fixed(accel, state, 0.0, 60.0, 60.0, method="euler",
                          device="cpu")


def test_dp87_adaptive_matches_jax_over_10_orbits():
    """One adaptive call over 10 orbits of TwoBody + J2 and one
    backwards: the same substep count as JAX, 1e-6 km; one cut at
    ``max_substeps``: the same count. (The step sizes agree only
    roughly: where the error estimate is round-off, as in a first short
    step, XLA's fused loop body rounds it otherwise than op-by-op
    arithmetic, and err^(-1/8) carries that into h, so a cut run ends at
    another time.)"""
    state = circular_state(550.0, incl=1.2)
    per = period(550.0)
    deriv = P.make_deriv(P.Composite([P.TwoBody(), P.J2()]))
    jderiv = JP.make_deriv(JP.Composite([JP.TwoBody(), JP.J2()]))
    for t1 in (10 * per, -per):
        out, h, n = P.dp87_adaptive(deriv, state, 0.0, t1, rtol=1e-10,
                                    device="cpu")
        jout, jh, jn = JP.dp87_adaptive(jderiv, jnp.asarray(state), 0.0, t1,
                                        rtol=1e-10)
        assert isinstance(n, int) and n == int(jn)
        assert max_dr(out, jout) <= 1e-6
    out, h, n = P.dp87_adaptive(deriv, state, 0.0, per, rtol=1e-10, h0=7.0,
                                max_substeps=5, device="cpu")
    jout, jh, jn = JP.dp87_adaptive(jderiv, jnp.asarray(state), 0.0, per,
                                    rtol=1e-10, h0=7.0, max_substeps=5)
    assert n == int(jn) == 5


def test_dp87_raises_at_the_substep_cap(monkeypatch):
    integ = P.DormandPrince87(P.TwoBody(), device="cpu")
    monkeypatch.setattr(PI, "dp87_adaptive",
                        lambda *a, **k: (a[1], 1e-3, 10000))
    with pytest.raises(RuntimeError, match="substep cap"):
        integ.step(circular_state(), 0.0, 60.0)


def test_sgp4_integrator_matches_jax():
    sat = Satrec.twoline2rv(ISS_L1, ISS_L2, device="cpu")
    jsat = JSatrec.twoline2rv(ISS_L1, ISS_L2)
    integ, jinteg = P.Sgp4Integrator(sat), JP.Sgp4Integrator(jsat)
    assert integ.device == torch.device("cpu")
    for t in (0.0, 600.0, 86400.0):
        out = integ.step(None, t, 60.0)
        assert out.dtype == torch.float64 and out.shape == (6,)
        np.testing.assert_allclose(out.numpy(),
                                   np.asarray(jinteg.step(None, t, 60.0)),
                                   rtol=0, atol=1e-8)


# ---------------------------------------------------------------------------
# Force models one by one
# ---------------------------------------------------------------------------


def _sun(xp):
    return lambda t: xp.asarray([AU_KM * np.cos(1e-7 * t),
                                 AU_KM * np.sin(1e-7 * t), 0.0])


def _moon(xp):
    return lambda t: xp.asarray([384400.0, 1000.0, -2000.0])


FORCES = {
    "TwoBody": lambda m, xp: m.TwoBody(),
    "J2": lambda m, xp: m.J2(),
    "J3": lambda m, xp: m.J3(),
    "J4": lambda m, xp: m.J4(),
    "Drag": lambda m, xp: m.Drag(cd=2.0, area_m2=3.0, mass_kg=500.0),
    "ImprovedDrag": lambda m, xp: m.ImprovedDrag(f107=220.0),
    "SRP": lambda m, xp: m.SolarRadiationPressure(),
    "SRP(sun_pos_fn)": lambda m, xp: m.SolarRadiationPressure(
        sun_pos_fn=_sun(xp)),
    "ThirdBody(moon)": lambda m, xp: m.ThirdBody(4902.800066, _moon(xp)),
    "ThirdBody(sun)": lambda m, xp: m.ThirdBody(1.32712440018e11, _sun(xp)),
    "Composite": lambda m, xp: m.Composite([m.TwoBody(), m.J2(), m.J3(),
                                            m.J4(), m.Drag()]),
    "earth_default_forces": lambda m, xp: m.earth_default_forces(
        drag=True, cd=2.5),
}


@pytest.mark.parametrize("name", sorted(FORCES))
def test_force_model_matches_jax(name):
    """Each model on 256 random states (150 km to GEO, sunlit and
    shadowed lanes) within rtol 1e-12, atol 1e-12 of JAX."""
    r, v = random_states(256, seed=len(name))
    r[:8] = [[-7000.0, y, 0.0] for y in np.linspace(-3000, 3000, 8)]
    model = FORCES[name](P, torch)
    jmodel = FORCES[name](JP, jnp)
    a = model(torch.from_numpy(r), torch.from_numpy(v), 1234.5)
    assert a.dtype == torch.float64 and a.shape == r.shape
    ref = np.asarray(jmodel(jnp.asarray(r), jnp.asarray(v), 1234.5))
    np.testing.assert_allclose(a.numpy(), ref, **TOL)
    if name == "SRP":
        assert (a[:8] == 0).all() and (a[8:].abs().sum(-1) > 0).any()


# ---------------------------------------------------------------------------
# Drag / SRP / third body
# ---------------------------------------------------------------------------


def _accel(model, state):
    s = torch.from_numpy(np.asarray(state, np.float64))
    return model(s[:3], s[3:], 0.0).numpy()


def test_drag_opposes_velocity_and_scales_with_altitude():
    low = circular_state(200.0)
    high = circular_state(800.0)
    d = P.Drag()
    a_low, a_high = _accel(d, low), _accel(d, high)
    assert np.dot(a_low, low[3:]) < 0  # opposes velocity
    assert np.linalg.norm(a_low) > 100 * np.linalg.norm(a_high)


def test_improved_drag_corotation():
    state = circular_state(300.0)
    a = _accel(P.ImprovedDrag(), state)
    assert np.linalg.norm(a) > 0
    a_hot = _accel(P.ImprovedDrag(f107=250.0), state)
    assert np.linalg.norm(a_hot) > np.linalg.norm(a)


def test_srp_magnitude_and_shadow():
    srp = P.SolarRadiationPressure(cr=1.3, area_m2=4.0, mass_kg=1000.0)
    a_lit = _accel(srp, [7000.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    expected = 4.56e-6 * 1.3 * 4.0 / 1000.0 / 1000.0  # km/s^2
    assert abs(np.linalg.norm(a_lit) / expected - 1.0) < 0.01
    assert a_lit[0] < 0  # pushes away from sun (+x)
    a_dark = _accel(srp, [-7000.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    assert np.linalg.norm(a_dark) == 0.0


def test_third_body_tidal_magnitude():
    mu_sun = 1.32712440018e11
    tb = P.ThirdBody(mu_sun, lambda t: torch.tensor([AU_KM, 0.0, 0.0],
                                                    dtype=torch.float64))
    a = _accel(tb, [7000.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    expected = 2 * mu_sun * 7000.0 / AU_KM ** 3
    assert abs(np.linalg.norm(a) / expected - 1.0) < 0.01


def test_third_body_battin_matches_naive_where_naive_is_accurate():
    r = torch.tensor([[7000.0, 1000.0, -2000.0]], dtype=torch.float64)
    for mu_b, rb in ((4902.800066, np.array([384400.0, 0.0, 0.0])),
                     (1.32712440018e11, np.array([1.496e8, 0.0, 0.0]))):
        a_b = P.ThirdBody(mu_b, lambda t: torch.from_numpy(rb))(
            r, None, 0.0).numpy()[0]
        d = rb - r.numpy()[0]
        a_n = mu_b * (d / np.linalg.norm(d) ** 3
                      - rb / np.linalg.norm(rb) ** 3)
        assert abs((a_b - a_n) / np.linalg.norm(a_b)).max() < 1e-11


# ---------------------------------------------------------------------------
# propagate_numerical surface
# ---------------------------------------------------------------------------


def test_propagate_numerical_api():
    state = circular_state(500.0)
    times, states = P.propagate_numerical(state, 0.0, 5400.0, 600.0,
                                          j2=EARTH.j2, device="cpu")
    jtimes, ref = JP.propagate_numerical(state, 0.0, 5400.0, 600.0,
                                         j2=EARTH.j2)
    assert times.shape == (10,) and states.shape == (10, 6)
    np.testing.assert_array_equal(times, jtimes)
    assert max_dr(states, ref) <= 1e-6
    rn = np.linalg.norm(states.numpy()[:, :3], axis=-1)
    assert np.all((rn > RE + 400) & (rn < RE + 600))
    t2, s2 = P.propagate_numerical(state, 0.0, 5400.0, 60.0,
                                   integrator="rk4", drag_cd=2.2,
                                   device="cpu")
    _, ref2 = JP.propagate_numerical(state, 0.0, 5400.0, 60.0,
                                     integrator="rk4", drag_cd=2.2)
    assert s2.shape[0] == 91
    assert max_dr(s2, ref2) <= 1e-6
    with pytest.raises(ValueError, match="integrator"):
        P.propagate_numerical(state, 0.0, 60.0, 60.0, integrator="euler",
                              device="cpu")


# ---------------------------------------------------------------------------
# dtypes, devices, public names
# ---------------------------------------------------------------------------

STATE = [RE + 500.0, 0.0, 0.0, 0.0, 7.6, 0.0]

#: every entry point of the numerical stack with Python-float or f64
#: numpy inputs; each returns f64 tensors (``device`` is appended)
ENTRY_POINTS = {
    "solve_kepler_newton": lambda d: C.solve_kepler_newton(1.0, 0.1,
                                                           device=d),
    "true_anomaly_from_eccentric": lambda d: C.true_anomaly_from_eccentric(
        1.0, 0.1, device=d),
    "elements_to_state": lambda d: C.elements_to_state(
        C.OrbitalElements(7000.0, 0.01, 0.9, 0.1, 0.2, 0.3, 0.0), device=d),
    "state_to_elements": lambda d: C.state_to_elements(
        np.array(STATE[:3]), STATE[3:], device=d),
    "mean_elements_to_state": lambda d: C.mean_elements_to_state(
        7000.0, 0.01, 0.9, 0.1, 0.2, 0.3, device=d),
    "hohmann_transfer": lambda d: C.hohmann_transfer(7000.0, 42164.0,
                                                     device=d),
    "impulse": lambda d: C.impulse([7.0, 0.0, 0.0], [0.1, 0.0, 0.0],
                                   device=d),
    "triad": lambda d: C.triad([1.0, 0, 0], [0, 1.0, 0], [1.0, 0, 0],
                               [0, 1.0, 0], device=d),
    "rotmat_to_quaternion": lambda d: C.rotmat_to_quaternion(np.eye(3),
                                                             device=d),
    "quaternion_multiply": lambda d: C.quaternion_multiply(
        [1.0, 0, 0, 0], [0, 1.0, 0, 0], device=d),
    "quaternion_derivative": lambda d: C.quaternion_derivative(
        [1.0, 0, 0, 0], [0.1, 0, 0], device=d),
    "propagate_attitude": lambda d: C.propagate_attitude(
        [1.0, 0, 0, 0], [0.1, 0, 0], [1.0, 2.0, 3.0], [0.0, 0, 0], 0.1, 3,
        device=d),
    "propagate_fixed": lambda d: P.propagate_fixed(
        P.TwoBody(), STATE, 0.0, 120.0, 60.0, device=d)[1],
    "dp87_adaptive": lambda d: P.dp87_adaptive(
        P.make_deriv(P.TwoBody()), STATE, 0.0, 60.0, device=d)[0],
    "Propagator(Rk4)": lambda d: P.Propagator(P.Rk4(
        P.TwoBody(), device=d)).propagate(np.array(STATE), 0, 120.0, 60.0)[1],
    "Propagator(DormandPrince87)": lambda d: P.Propagator(P.DormandPrince87(
        P.TwoBody(), device=d)).propagate_to(STATE, 0.0, 120.0, 60.0),
    "propagate_numerical": lambda d: P.propagate_numerical(
        np.array(STATE), 0.0, 120.0, 60.0, j2=EARTH.j2, device=d)[1],
}


def _tensors_of(out):
    return [out] if isinstance(out, torch.Tensor) else \
        [x for o in out for x in _tensors_of(o)]


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_returns_f64(name):
    """Python floats and f64 numpy in, f64 tensors out: a silent f32
    would put a day's integration metres off."""
    out = _tensors_of(ENTRY_POINTS[name]("cpu"))
    assert out and all(x.dtype == torch.float64 for x in out), name
    assert all(x.device == torch.device("cpu") for x in out)


def test_entry_points_default_to_cuda_and_raise_without_it():
    """Every entry point defaults to ``device="cuda"`` and raises where
    CUDA is missing: no silent CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    from astroz_tpu_torch import montecarlo, orbital_mechanics, spacecraft

    calls = [lambda f=f: f("cuda") for f in ENTRY_POINTS.values()]
    calls += [
        lambda: C.solve_kepler_newton(1.0, 0.1),
        lambda: P.propagate_fixed(P.TwoBody(), STATE, 0.0, 60.0, 60.0),
        lambda: P.Propagator(P.DormandPrince87(P.TwoBody())).propagate(
            STATE, 0.0, 60.0, 60.0),
        lambda: P.propagate_numerical(STATE, 0.0, 60.0, 60.0),
        lambda: orbital_mechanics.hohmann_transfer(7000.0, 42164.0),
        lambda: orbital_mechanics.orbital_velocity(7000.0),
        lambda: orbital_mechanics.lambert_solver_simple(
            [7000.0, 0, 0], [0, 8000.0, 0], 3000.0),
        lambda: montecarlo.run_hohmann_monte_carlo(
            montecarlo.MonteCarloConfig(n_samples=10)),
        lambda: spacecraft.Spacecraft(state=np.array(STATE)).propagate(
            0.0, 0.001, 30.0),
        lambda: spacecraft.Spacecraft().propagate_attitude(0.1, 1.0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()


#: the JAX modules of the numerical stack and their ports
PORTED = ("calculations", "orbital_mechanics", "propagators",
          "propagators.forces", "propagators.integrators",
          "propagators.driver", "spacecraft", "montecarlo")


def _public_names(mod):
    """A JAX module's ``__all__``, or, lacking one, the public names its
    source defines at top level (loggers aside)."""
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    tree = ast.parse(inspect.getsource(mod))
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")
            and not isinstance(getattr(mod, n), logging.Logger)}


@pytest.mark.parametrize("name", PORTED)
def test_port_names_every_public_name_of_jax(name):
    import importlib

    jmod = importlib.import_module(f"astroz_tpu.{name}")
    pmod = importlib.import_module(f"astroz_tpu_torch.{name}")
    missing = _public_names(jmod) - set(pmod.__all__)
    assert not missing, missing
    assert all(hasattr(pmod, n) for n in pmod.__all__)

