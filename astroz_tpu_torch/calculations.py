"""Astrodynamics math toolbox.

Counterpart of ``astroz_tpu/calculations.py`` in plain torch: Kepler's
equation by Newton, element <-> state conversions, Hohmann transfers and
impulses, TRIAD, quaternions and rigid-body attitude propagation. Every
function is elementwise and broadcasts over leading axes, so the same
code serves scalars, catalogs and Monte-Carlo ensembles.

Tensors run on their own device and keep their dtype. Python floats and
numpy arrays become ``config.DEFAULT_DTYPE`` (f64) tensors on the
keyword ``device``, the card unless the caller asks for the CPU; a
``"cuda"`` request without CUDA raises.

Formulas are the standard published ones (Vallado ch. 2; Markley &
Crassidis for TRIAD/quaternions).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .config import DEFAULT_DTYPE
from .constants import EARTH, TWO_PI
from .ops import cuda_integrate
from .ops.sgp4 import _device

__all__ = ["MU_EARTH", "OrbitalElements", "attitude_reference",
           "eccentric_from_true",
           "elements_to_state", "hohmann_transfer", "impulse",
           "mean_elements_to_state", "mean_from_eccentric",
           "propagate_attitude", "quaternion_derivative",
           "quaternion_multiply", "rotmat_to_quaternion",
           "solve_kepler_newton", "state_to_elements", "tle_to_elements",
           "triad", "true_anomaly_from_eccentric"]

MU_EARTH = EARTH.mu


def _tensors(*values, device="cuda", dtype=None):
    """``values`` as tensors on one device: the first tensor's among
    them, else ``device`` (checked: ``"cuda"`` without CUDA raises).
    Non-tensors take ``dtype`` or ``DEFAULT_DTYPE``; tensors keep their
    dtype unless ``dtype`` is given."""
    dev = next((v.device for v in values if isinstance(v, torch.Tensor)),
               None)
    if dev is None:
        dev = _device(device)
    return tuple(
        v.to(dtype) if isinstance(v, torch.Tensor) and dtype is not None
        else v if isinstance(v, torch.Tensor)
        else torch.as_tensor(v, dtype=dtype or DEFAULT_DTYPE, device=dev)
        for v in values)


def _norm(x, keepdim=False):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


class OrbitalElements(NamedTuple):
    """Classical Keplerian elements (angles rad, sma km)."""

    semi_major_axis: torch.Tensor
    eccentricity: torch.Tensor
    inclination: torch.Tensor
    raan: torch.Tensor
    argument_of_perigee: torch.Tensor
    true_anomaly: torch.Tensor
    mean_anomaly: torch.Tensor


# ---------------------------------------------------------------------------
# Kepler equation
# ---------------------------------------------------------------------------


def solve_kepler_newton(mean_anomaly, eccentricity, iters: int = 20,
                        tol: float = 1e-12, *, device="cuda"):
    """Classical Kepler M = E - e sin E by Newton: a fixed-trip masked
    loop (a lane stops moving once its step falls under ``tol``)."""
    m, e = _tensors(mean_anomaly, eccentricity, device=device)
    m = torch.remainder(m, TWO_PI)
    big_e = torch.where(e > 0.8, torch.full_like(m, math.pi), m)
    done = torch.zeros(torch.broadcast_shapes(m.shape, e.shape),
                       dtype=torch.bool, device=m.device)
    for _ in range(iters):
        f = big_e - e * torch.sin(big_e) - m
        fp = 1.0 - e * torch.cos(big_e)
        step = f / fp
        big_e = torch.where(done, big_e, big_e - step)
        done = done | (torch.abs(step) < tol)
    return big_e


def true_anomaly_from_eccentric(big_e, ecc, *, device="cuda"):
    big_e, ecc = _tensors(big_e, ecc, device=device)
    return 2.0 * torch.atan2(torch.sqrt(1.0 + ecc) * torch.sin(big_e / 2.0),
                             torch.sqrt(1.0 - ecc) * torch.cos(big_e / 2.0))


def eccentric_from_true(nu, ecc, *, device="cuda"):
    nu, ecc = _tensors(nu, ecc, device=device)
    return 2.0 * torch.atan2(torch.sqrt(1.0 - ecc) * torch.sin(nu / 2.0),
                             torch.sqrt(1.0 + ecc) * torch.cos(nu / 2.0))


def mean_from_eccentric(big_e, ecc, *, device="cuda"):
    big_e, ecc = _tensors(big_e, ecc, device=device)
    return big_e - ecc * torch.sin(big_e)


# ---------------------------------------------------------------------------
# Element <-> state conversions
# ---------------------------------------------------------------------------


def elements_to_state(el: OrbitalElements, mu: float = MU_EARTH, *,
                      device="cuda"):
    """Keplerian elements -> inertial (r km, v km/s), each (..., 3)."""
    el = OrbitalElements(*_tensors(*el, device=device))
    a, e = el.semi_major_axis, el.eccentricity
    nu = el.true_anomaly
    p = a * (1.0 - e * e)
    r_mag = p / (1.0 + e * torch.cos(nu))
    # perifocal
    cnu, snu = torch.cos(nu), torch.sin(nu)
    zero = torch.zeros_like(r_mag)
    r_pf = torch.stack([r_mag * cnu, r_mag * snu, zero], dim=-1)
    sqmp = torch.sqrt(mu / p)
    v_pf = torch.stack([-sqmp * snu, sqmp * (e + cnu), zero], dim=-1)
    # rotation perifocal -> inertial: Rz(-raan) Rx(-i) Rz(-argp)
    co, so = torch.cos(el.raan), torch.sin(el.raan)
    ci, si = torch.cos(el.inclination), torch.sin(el.inclination)
    cw = torch.cos(el.argument_of_perigee)
    sw = torch.sin(el.argument_of_perigee)
    r11 = co * cw - so * sw * ci
    r12 = -co * sw - so * cw * ci
    r21 = so * cw + co * sw * ci
    r22 = -so * sw + co * cw * ci
    r31 = sw * si
    r32 = cw * si

    def rot(p3):
        x, y = p3[..., 0], p3[..., 1]
        return torch.stack([r11 * x + r12 * y, r21 * x + r22 * y,
                            r31 * x + r32 * y], dim=-1)

    return rot(r_pf), rot(v_pf)


def state_to_elements(r, v, mu: float = MU_EARTH, *,
                      device="cuda") -> OrbitalElements:
    """Inertial state (..., 3) r km, v km/s -> classical elements."""
    r, v = _tensors(r, v, device=device)
    r_mag = _norm(r)
    v_mag = _norm(v)
    h = _cross(r, v)
    h_mag = _norm(h)
    n = torch.stack([-h[..., 1], h[..., 0], torch.zeros_like(h_mag)], dim=-1)
    n_mag = _norm(n)
    rv = torch.sum(r * v, dim=-1)
    e_vec = ((v_mag ** 2 - mu / r_mag)[..., None] * r
             - rv[..., None] * v) / mu
    ecc = _norm(e_vec)
    energy = 0.5 * v_mag ** 2 - mu / r_mag
    a = -mu / (2.0 * energy)
    incl = torch.arccos(torch.clamp(h[..., 2] / h_mag, -1.0, 1.0))

    n_safe = torch.where(n_mag > 1e-12, n_mag, 1.0)
    raan = torch.arccos(torch.clamp(n[..., 0] / n_safe, -1.0, 1.0))
    raan = torch.where(n[..., 1] < 0.0, TWO_PI - raan, raan)
    raan = torch.where(n_mag > 1e-12, raan, 0.0)

    e_safe = torch.where(ecc > 1e-12, ecc, 1.0)
    ne = torch.sum(n * e_vec, dim=-1) / (n_safe * e_safe)
    argp = torch.arccos(torch.clamp(ne, -1.0, 1.0))
    argp = torch.where(e_vec[..., 2] < 0.0, TWO_PI - argp, argp)
    argp = torch.where((n_mag > 1e-12) & (ecc > 1e-12), argp, 0.0)

    re_cos = torch.sum(r * e_vec, dim=-1) / (r_mag * e_safe)
    nu = torch.arccos(torch.clamp(re_cos, -1.0, 1.0))
    nu = torch.where(rv < 0.0, TWO_PI - nu, nu)
    # circular orbit: true anomaly from node line
    nr = torch.sum(n * r, dim=-1) / (n_safe * r_mag)
    nu_circ = torch.arccos(torch.clamp(nr, -1.0, 1.0))
    nu_circ = torch.where(r[..., 2] < 0.0, TWO_PI - nu_circ, nu_circ)
    nu = torch.where(ecc > 1e-12, nu, nu_circ)

    big_e = eccentric_from_true(nu, ecc)
    m = torch.remainder(mean_from_eccentric(big_e, ecc), TWO_PI)
    return OrbitalElements(a, ecc, incl, raan, argp, nu, m)


def mean_elements_to_state(a, e, i, raan, argp, mean_anom,
                           mu: float = MU_EARTH, *, device="cuda"):
    """Elements with mean anomaly -> state (solves Kepler)."""
    a, e, i, raan, argp, mean_anom = _tensors(a, e, i, raan, argp, mean_anom,
                                              device=device)
    big_e = solve_kepler_newton(mean_anom, e)
    nu = true_anomaly_from_eccentric(big_e, e)
    return elements_to_state(
        OrbitalElements(a, e, i, raan, argp, nu, mean_anom), mu)


def tle_to_elements(tle, mu: float = MU_EARTH, *,
                    device="cuda") -> OrbitalElements:
    """TLE mean elements -> osculating-ish classical elements (a direct
    Kepler conversion, no SGP4). ``tle`` is a :class:`~.tle.Tle` or a
    :class:`~.tle.TleArrays` batch; the semi-major axis is computed on
    the host, as the JAX package does."""
    n_rad_s = tle.no_kozai / 60.0
    a = (mu / (n_rad_s * n_rad_s)) ** (1.0 / 3.0)
    a, ecco, inclo, nodeo, argpo, mo = _tensors(
        a, tle.ecco, tle.inclo, tle.nodeo, tle.argpo, tle.mo, device=device)
    big_e = solve_kepler_newton(mo, ecco)
    nu = true_anomaly_from_eccentric(big_e, ecco)
    return OrbitalElements(a, ecco, inclo, nodeo, argpo, nu, mo)


# ---------------------------------------------------------------------------
# Simple transfers / impulses
# ---------------------------------------------------------------------------


def hohmann_transfer(r1_km, r2_km, mu: float = MU_EARTH, *, device="cuda"):
    """Coplanar circular-to-circular transfer. Returns
    (dv1, dv2, total_dv, transfer_time_s); ``mu`` may be a tensor of
    samples."""
    r1, r2 = _tensors(r1_km, r2_km, device=device, dtype=DEFAULT_DTYPE)
    a_t = 0.5 * (r1 + r2)
    v1 = torch.sqrt(mu / r1)
    v2 = torch.sqrt(mu / r2)
    v_p = torch.sqrt(mu * (2.0 / r1 - 1.0 / a_t))
    v_a = torch.sqrt(mu * (2.0 / r2 - 1.0 / a_t))
    dv1 = torch.abs(v_p - v1)
    dv2 = torch.abs(v2 - v_a)
    t = math.pi * torch.sqrt(a_t ** 3 / mu)
    return dv1, dv2, dv1 + dv2, t


def impulse(v, dv, *, device="cuda"):
    """Apply an instantaneous delta-V."""
    v, dv = _tensors(v, dv, device=device)
    return v + dv


# ---------------------------------------------------------------------------
# Attitude: TRIAD, quaternions, rigid-body propagation
# ---------------------------------------------------------------------------


def triad(v1_body, v2_body, v1_ref, v2_ref, *, device="cuda"):
    """TRIAD attitude determination: the rotation matrix taking the
    reference frame to the body frame, from two vector pairs."""
    v1_body, v2_body, v1_ref, v2_ref = _tensors(v1_body, v2_body, v1_ref,
                                                v2_ref, device=device)

    def tri(v1, v2):
        t1 = v1 / _norm(v1, keepdim=True)
        c = _cross(v1, v2)
        t2 = c / _norm(c, keepdim=True)
        t3 = _cross(t1, t2)
        return torch.stack([t1, t2, t3], dim=-1)  # columns

    b = tri(v1_body, v2_body)
    r = tri(v1_ref, v2_ref)
    return b @ r.transpose(-1, -2)


def rotmat_to_quaternion(m, *, device="cuda"):
    """Rotation matrix -> quaternion (w, x, y, z), Shepperd's branchless
    variant: all four constructions, the best picked by mask."""
    (m,) = _tensors(m, device=device)
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    t = m00 + m11 + m22
    qw = torch.sqrt(torch.clamp(1.0 + t, min=1e-12)) / 2.0
    qx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) / 2.0
    qy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-12)) / 2.0
    qz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-12)) / 2.0
    c0 = torch.stack([qw,
                      (m[..., 2, 1] - m[..., 1, 2]) / (4 * qw),
                      (m[..., 0, 2] - m[..., 2, 0]) / (4 * qw),
                      (m[..., 1, 0] - m[..., 0, 1]) / (4 * qw)], dim=-1)
    c1 = torch.stack([(m[..., 2, 1] - m[..., 1, 2]) / (4 * qx), qx,
                      (m[..., 0, 1] + m[..., 1, 0]) / (4 * qx),
                      (m[..., 0, 2] + m[..., 2, 0]) / (4 * qx)], dim=-1)
    c2 = torch.stack([(m[..., 0, 2] - m[..., 2, 0]) / (4 * qy),
                      (m[..., 0, 1] + m[..., 1, 0]) / (4 * qy), qy,
                      (m[..., 1, 2] + m[..., 2, 1]) / (4 * qy)], dim=-1)
    c3 = torch.stack([(m[..., 1, 0] - m[..., 0, 1]) / (4 * qz),
                      (m[..., 0, 2] + m[..., 2, 0]) / (4 * qz),
                      (m[..., 1, 2] + m[..., 2, 1]) / (4 * qz), qz], dim=-1)
    best = torch.argmax(torch.stack([t, m00, m11, m22], dim=-1),
                        dim=-1)[..., None]
    q = torch.where(best == 0, c0, torch.where(
        best == 1, c1, torch.where(best == 2, c2, c3)))
    return q / _norm(q, keepdim=True)


def quaternion_multiply(q1, q2, *, device="cuda"):
    q1, q2 = _tensors(q1, q2, device=device)
    w1, x1, y1, z1 = (q1[..., i] for i in range(4))
    w2, x2, y2, z2 = (q2[..., i] for i in range(4))
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], dim=-1)


def quaternion_derivative(q, omega_body, *, device="cuda"):
    """qdot = 0.5 q * [0, omega]."""
    q, omega_body = _tensors(q, omega_body, device=device)
    zero = torch.zeros_like(omega_body[..., 0])
    oq = torch.stack([zero, omega_body[..., 0], omega_body[..., 1],
                      omega_body[..., 2]], dim=-1)
    return 0.5 * quaternion_multiply(q, oq)


def propagate_attitude(q0, omega0, inertia_diag, torque, dt, n_steps: int,
                       *, device="cuda"):
    """Rigid-body attitude propagation: quaternion kinematics + Euler's
    equations by RK4 over ``n_steps`` fixed steps of ``dt`` seconds (a
    python float), as JAX's ``lax.scan``: on CUDA (f64) one launch of the
    integrator kernel's ATTITUDE mode, bit-equal to the plain loop of
    device ops (:func:`attitude_reference`) that runs on the CPU; no host
    read. Returns (q, omega)."""
    q, w, inertia, torque = _tensors(q0, omega0, inertia_diag, torque,
                                     device=device)
    if q.is_cuda:
        return cuda_integrate.attitude(q, w, inertia, torque, dt, n_steps)
    return attitude_reference(q, w, inertia, torque, dt, n_steps)


def attitude_reference(q, w, inertia, torque, dt, n_steps: int):
    """The plain attitude loop: ``n_steps`` RK4 steps of ``dt`` of
    quaternion kinematics and Euler's equations, ``q`` renormalized each
    step. Returns (q, omega)."""

    def deriv(q, w):
        qd = quaternion_derivative(q, w)
        # Euler: I wdot = T - w x (I w)
        iw = inertia * w
        wd = (torque - _cross(w, iw)) / inertia
        return qd, wd

    for _ in range(n_steps):
        k1q, k1w = deriv(q, w)
        k2q, k2w = deriv(q + 0.5 * dt * k1q, w + 0.5 * dt * k1w)
        k3q, k3w = deriv(q + 0.5 * dt * k2q, w + 0.5 * dt * k2w)
        k4q, k4w = deriv(q + dt * k3q, w + dt * k3w)
        q = q + dt / 6.0 * (k1q + 2 * k2q + 2 * k3q + k4q)
        w = w + dt / 6.0 * (k1w + 2 * k2w + 2 * k3w + k4w)
        q = q / _norm(q, keepdim=True)
    return q, w
