"""astroz_tpu_torch ``calculations`` and ``orbital_mechanics`` against
astroz_tpu on the CPU: every case of ``tests/test_calculations.py``, run
on the port beside JAX on the same numpy inputs, plus the elementwise
functions one by one.

Tolerances: the elementwise functions (Kepler, the anomaly conversions,
elements <-> state, transfers, TRIAD, quaternions) rtol 1e-12, atol
1e-12 (the two libraries' sin, cos, atan2 and torch's ``float / tensor``,
a reciprocal times the float, differ in last bits); ``hohmann_transfer``
on identical samples 1e-12 relative; ``propagate_attitude`` 1e-12. The
Lambert solver is the same numpy code in both packages, so its
velocities are equal. Each case also keeps the reference's own gate,
applied to the port's result.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import astroz_tpu.calculations as J
import astroz_tpu.orbital_mechanics as JO
from astroz_tpu import tle as jtle

import astroz_tpu_torch.calculations as C
import astroz_tpu_torch.orbital_mechanics as O
from astroz_tpu_torch import tle as ptle
from astroz_tpu_torch.constants import EARTH
from astroz_tpu_torch.convert import orbital_elements_from_numpy
from astroz_tpu_torch.propagators import DormandPrince87, Propagator, TwoBody

from test_sgp4 import ISS_L1, ISS_L2
from test_torch_init import LEO_TEXT

torch.set_num_threads(1)

MU = EARTH.mu
RE = EARTH.eq_radius
TOL = dict(rtol=1e-12, atol=1e-12)


def close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.cpu() if isinstance(
        port, torch.Tensor) else port), np.asarray(ref), **(tol or TOL))


def random_elements(rng, n):
    return dict(
        semi_major_axis=rng.uniform(6700, 45000, n),
        eccentricity=rng.uniform(0.001, 0.8, n),
        inclination=rng.uniform(0.01, np.pi - 0.01, n),
        raan=rng.uniform(0, 2 * np.pi, n),
        argument_of_perigee=rng.uniform(0, 2 * np.pi, n),
        true_anomaly=rng.uniform(0, 2 * np.pi, n),
        mean_anomaly=np.zeros(n))


def test_kepler_newton_roundtrip():
    rng = np.random.default_rng(0)
    m = rng.uniform(0, 2 * np.pi, 1000)
    e = rng.uniform(0, 0.95, 1000)
    big_e = C.solve_kepler_newton(m, e, device="cpu")
    assert big_e.dtype == torch.float64
    close(big_e, J.solve_kepler_newton(m, e))
    m_back = C.mean_from_eccentric(big_e, e).numpy()
    close(m_back, J.mean_from_eccentric(np.asarray(big_e), e))
    err = np.abs((m_back - m + np.pi) % (2 * np.pi) - np.pi)
    assert err.max() < 1e-10
    nu = C.true_anomaly_from_eccentric(big_e, e)
    close(nu, J.true_anomaly_from_eccentric(big_e.numpy(), e))
    close(C.eccentric_from_true(nu, e),
          J.eccentric_from_true(nu.numpy(), e))


def test_elements_state_roundtrip():
    """20 random element sets in one batch: elements -> state and back
    against JAX, and the reference's round-trip gates on the port."""
    rng = np.random.default_rng(1)
    el = random_elements(rng, 20)
    jel = J.OrbitalElements(**{k: jnp.asarray(v) for k, v in el.items()})
    pel = orbital_elements_from_numpy(jel, device="cpu")
    assert all(x.dtype == torch.float64 for x in pel)
    r, v = C.elements_to_state(pel)
    rj, vj = J.elements_to_state(jel)
    close(r, rj)
    close(v, vj)
    back = C.state_to_elements(r, v)
    backj = J.state_to_elements(rj, vj)
    for a, b in zip(back, backj):
        close(a, b)
    assert np.abs(back.semi_major_axis.numpy() - el["semi_major_axis"]
                  ).max() < 1e-4
    assert np.abs(back.eccentricity.numpy() - el["eccentricity"]
                  ).max() < 1e-9
    assert np.abs(back.inclination.numpy() - el["inclination"]).max() < 1e-9
    d_raan = (back.raan.numpy() - el["raan"] + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(d_raan).max() < 1e-8


def test_hohmann_leo_to_geo_published_values():
    """LEO (6678 km) -> GEO (42164 km): dv1 ~ 2.44, dv2 ~ 1.47 km/s,
    ~5.25 h; equal to JAX within 1e-12 relative."""
    res = O.hohmann_transfer(6678.0, 42164.0, device="cpu")
    ref = JO.hohmann_transfer(6678.0, 42164.0)
    np.testing.assert_allclose(res, ref, rtol=1e-12, atol=0)
    assert abs(res.delta_v1 - 2.4258) < 0.003
    assert abs(res.delta_v2 - 1.4668) < 0.003
    assert abs(res.transfer_time / 3600.0 - 5.2750) < 0.01
    assert res.transfer_time_days == res.transfer_time / 86400.0


def test_hohmann_samples_match_jax():
    """The raw transfer on identical sample arrays (radii and mu), and
    on a scalar mu: 1e-12 relative."""
    rng = np.random.default_rng(2)
    r1 = RE + 400.0 + rng.normal(0, 10.0, 4096)
    r2 = 42164.0 + rng.normal(0, 50.0, 4096)
    mu = MU + rng.normal(0, 2000.0, 4096)
    for m in (mu, MU):
        port = C.hohmann_transfer(r1, r2, m if np.isscalar(m)
                                  else torch.from_numpy(m), device="cpu")
        ref = J.hohmann_transfer(r1, r2, m)
        for a, b in zip(port, ref):
            assert a.dtype == torch.float64
            close(a, b, rtol=1e-12, atol=0)


def test_orbital_period_iss():
    a = 6790.0
    p = O.orbital_period(a, device="cpu")
    close(p, JO.orbital_period(a), rtol=1e-12, atol=0)
    assert abs(float(p) / (2 * np.pi * np.sqrt(a ** 3 / MU)) - 1.0) < 1e-12


def test_velocities():
    v = O.orbital_velocity(RE + 400, device="cpu")
    close(v, JO.orbital_velocity(RE + 400), rtol=1e-12, atol=0)
    close(O.orbital_velocity(RE + 400, 8000.0, device="cpu"),
          JO.orbital_velocity(RE + 400, 8000.0), rtol=1e-12, atol=0)
    esc = O.escape_velocity(RE, device="cpu")
    close(esc, JO.escape_velocity(RE), rtol=1e-12, atol=0)
    assert abs(float(v) - 7.6686) < 1e-3
    assert abs(float(esc) - 11.18) < 5e-3


def test_bi_elliptic_beats_hohmann_for_large_ratio():
    r1 = 7000.0
    r2 = 7000.0 * 20.0
    hoh = O.hohmann_transfer(r1, r2, device="cpu")
    bi = O.bi_elliptic_transfer(r1, r2, r2 * 10.0)
    assert tuple(bi) == tuple(JO.bi_elliptic_transfer(r1, r2, r2 * 10.0))
    assert bi.total_delta_v < hoh.total_delta_v


def test_bi_elliptic_validation():
    for bad in ((7000.0, 14000.0, 10000.0), (-1.0, 14000.0, 20000.0)):
        with pytest.raises(ValueError):
            O.bi_elliptic_transfer(*bad)
    for bad in ((7000.0, 7000.5), (0.0, 7000.0)):
        with pytest.raises(ValueError):
            O.hohmann_transfer(*bad, device="cpu")


def test_lambert_matches_two_body_propagation():
    """Lambert velocities connect r1 to r2 in tof under two-body DP87 on
    the port; the solver's velocities equal JAX's."""
    r1 = np.array([7000.0, 0.0, 0.0])
    r2 = np.array([0.0, 8000.0, 1000.0])
    tof = 3000.0
    res = O.lambert_solver_simple(r1, r2, tof, device="cpu")
    ref = JO.lambert_solver_simple(r1, r2, tof)
    assert res.v1.dtype == torch.float64
    np.testing.assert_array_equal(res.v1.numpy(), np.asarray(ref.v1))
    np.testing.assert_array_equal(res.v2.numpy(), np.asarray(ref.v2))
    state0 = np.concatenate([r1, res.v1.numpy()])
    prop = Propagator(DormandPrince87(TwoBody(), rtol=1e-12, atol=1e-12,
                                      device="cpu"))
    end = prop.propagate_to(state0, 0.0, tof, tof).numpy()
    assert np.linalg.norm(end[:3] - r2) < 1.0  # < 1 km closure
    assert np.linalg.norm(end[3:] - res.v2.numpy()) < 1e-3
    on_tensor = O.lambert_solver_simple(torch.from_numpy(r1), r2, tof)
    assert on_tensor.v1.device == torch.device("cpu")


def test_triad_recovers_rotation():
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    v1 = np.array([1.0, 0.2, -0.3])
    v2 = np.array([0.1, 1.0, 0.4])
    a = C.triad(q @ v1, q @ v2, v1, v2, device="cpu")
    close(a, J.triad(q @ v1, q @ v2, v1, v2))
    np.testing.assert_allclose(a.numpy(), q, atol=1e-10)
    # a batch of rotations
    qs = np.linalg.qr(rng.normal(size=(16, 3, 3)))[0]
    b1, b2 = qs @ v1, qs @ v2
    close(C.triad(b1, b2, v1, v2, device="cpu"), J.triad(b1, b2, v1, v2))


def test_rotmat_to_quaternion_identity_and_multiply():
    q = C.rotmat_to_quaternion(np.eye(3), device="cpu")
    np.testing.assert_allclose(q.numpy(), [1, 0, 0, 0], atol=1e-12)
    rz = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    qz = C.rotmat_to_quaternion(rz, device="cpu")
    np.testing.assert_allclose(qz.numpy(), [np.sqrt(0.5), 0, 0,
                                            np.sqrt(0.5)], atol=1e-12)
    q180 = C.quaternion_multiply(qz, qz)
    np.testing.assert_allclose(q180.numpy(), [0, 0, 0, 1], atol=1e-12)
    # every branch of the construction, against JAX
    rng = np.random.default_rng(4)
    ms = np.linalg.qr(rng.normal(size=(64, 3, 3)))[0]
    ms[np.linalg.det(ms) < 0, :, 0] *= -1
    ms[:4] = [np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
              np.diag([-1.0, -1, 1])]
    qp = C.rotmat_to_quaternion(ms, device="cpu")
    # JAX's select does not broadcast over a batch: one matrix a call
    close(qp, np.stack([J.rotmat_to_quaternion(m) for m in ms]))
    w = rng.normal(size=(64, 3))
    close(C.quaternion_multiply(qp, qp.flip(0)),
          J.quaternion_multiply(qp.numpy(), qp.numpy()[::-1]))
    close(C.quaternion_derivative(qp, w),
          J.quaternion_derivative(qp.numpy(), w))


def test_attitude_propagation_torque_free_conserves_momentum():
    inertia = np.array([10.0, 12.0, 20.0])
    w0 = np.array([0.05, -0.02, 0.1])
    q0 = np.array([1.0, 0.0, 0.0, 0.0])
    q, w = C.propagate_attitude(q0, w0, inertia, np.zeros(3), 0.1, 3000,
                                device="cpu")
    qj, wj = J.propagate_attitude(jnp.asarray(q0), jnp.asarray(w0),
                                  jnp.asarray(inertia), jnp.zeros(3), 0.1,
                                  3000)
    close(q, qj)
    close(w, wj)
    assert abs(float(torch.linalg.vector_norm(q)) - 1.0) < 1e-9
    t0 = 0.5 * float(np.sum(inertia * w0 * w0))
    t1 = 0.5 * float(torch.sum(torch.from_numpy(inertia) * w * w))
    assert abs(t1 / t0 - 1.0) < 1e-6


def test_tle_to_elements_and_mean_elements_match_jax():
    """A Tle and a TleArrays batch through tle_to_elements, and
    mean_elements_to_state / impulse, against JAX."""
    one = ptle.parse_lines(ISS_L1, ISS_L2)
    jone = jtle.parse_lines(ISS_L1, ISS_L2)
    for port, ref in ((C.tle_to_elements(one, device="cpu"),
                       J.tle_to_elements(jone)),
                      (C.tle_to_elements(ptle.TleArrays.from_text(LEO_TEXT),
                                         device="cpu"),
                       J.tle_to_elements(jtle.TleArrays.from_text(
                           LEO_TEXT, allow_native=False)))):
        for a, b in zip(port, ref):
            assert a.dtype == torch.float64
            close(a, b)
    rng = np.random.default_rng(5)
    el = random_elements(rng, 32)
    m = rng.uniform(0, 2 * np.pi, 32)
    args = (el["semi_major_axis"], el["eccentricity"], el["inclination"],
            el["raan"], el["argument_of_perigee"], m)
    for a, b in zip(C.mean_elements_to_state(*args, device="cpu"),
                    J.mean_elements_to_state(*args)):
        close(a, b)
    dv = rng.normal(size=(32, 3))
    close(C.impulse(el["semi_major_axis"][:, None] * 0 + 7.5, dv,
                    device="cpu"),
          J.impulse(el["semi_major_axis"][:, None] * 0 + 7.5, dv))
