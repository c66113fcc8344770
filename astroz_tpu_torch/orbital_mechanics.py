"""Validated orbital-mechanics wrappers (mu-parameterized).

Counterpart of ``astroz_tpu/orbital_mechanics.py``: vis-viva velocity,
period, escape velocity, the validated Hohmann and three-burn
bi-elliptic transfers, and a simplified universal-variable Lambert
solver. Scalar host-side validation raises; the math broadcasts over
tensors. The bi-elliptic transfer and the Lambert solver run in numpy on
the host, as in the JAX package; the Lambert velocities come back as f64
tensors on ``device``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .calculations import _tensors
from .calculations import hohmann_transfer as _hohmann
from .config import DEFAULT_DTYPE
from .constants import EARTH

__all__ = ["BiEllipticTransferResult", "LambertResult", "MU_EARTH",
           "TransferResult", "bi_elliptic_transfer", "escape_velocity",
           "hohmann_transfer", "lambert_solver_simple", "orbital_period",
           "orbital_velocity"]

MU_EARTH = EARTH.mu


class TransferResult(NamedTuple):
    delta_v1: float
    delta_v2: float
    total_delta_v: float
    transfer_time: float  # seconds

    @property
    def transfer_time_days(self):
        return self.transfer_time / 86400.0


class BiEllipticTransferResult(NamedTuple):
    delta_v1: float
    delta_v2: float
    delta_v3: float
    total_delta_v: float
    transfer_time: float


class LambertResult(NamedTuple):
    v1: torch.Tensor  # departure velocity, km/s
    v2: torch.Tensor  # arrival velocity, km/s


def orbital_velocity(r_km, a_km=None, mu: float = MU_EARTH, *,
                     device="cuda"):
    """Vis-viva: v = sqrt(mu (2/r - 1/a)); circular when ``a_km`` is
    omitted."""
    (r,) = _tensors(r_km, device=device, dtype=DEFAULT_DTYPE)
    a = r if a_km is None else _tensors(a_km, r, dtype=r.dtype)[0]
    return torch.sqrt(mu * (2.0 / r - 1.0 / a))


def orbital_period(a_km, mu: float = MU_EARTH, *, device="cuda"):
    (a,) = _tensors(a_km, device=device, dtype=DEFAULT_DTYPE)
    return 2.0 * math.pi * torch.sqrt(a ** 3 / mu)


def escape_velocity(r_km, mu: float = MU_EARTH, *, device="cuda"):
    (r,) = _tensors(r_km, device=device, dtype=DEFAULT_DTYPE)
    return torch.sqrt(2.0 * mu / r)


def hohmann_transfer(r1_km: float, r2_km: float, mu: float = MU_EARTH, *,
                     device="cuda") -> TransferResult:
    """Validated Hohmann: radii positive and distinct by >= 1 km."""
    if r1_km <= 0 or r2_km <= 0:
        raise ValueError("radii must be positive")
    if abs(r2_km - r1_km) < 1.0:
        raise ValueError("transfer radii must differ")
    dv1, dv2, tot, t = _hohmann(r1_km, r2_km, mu, device=device)
    return TransferResult(float(dv1), float(dv2), float(tot), float(t))


def bi_elliptic_transfer(r1_km: float, r2_km: float, rb_km: float,
                         mu: float = MU_EARTH) -> BiEllipticTransferResult:
    """Three-burn transfer through apoapsis ``rb_km``, which must exceed
    both terminal radii (numpy, on the host)."""
    if min(r1_km, r2_km, rb_km) <= 0:
        raise ValueError("radii must be positive")
    if rb_km <= max(r1_km, r2_km):
        raise ValueError("intermediate apoapsis must exceed both radii")
    a1 = 0.5 * (r1_km + rb_km)
    a2 = 0.5 * (r2_km + rb_km)
    v_c1 = np.sqrt(mu / r1_km)
    v_p1 = np.sqrt(mu * (2.0 / r1_km - 1.0 / a1))
    v_a1 = np.sqrt(mu * (2.0 / rb_km - 1.0 / a1))
    v_a2 = np.sqrt(mu * (2.0 / rb_km - 1.0 / a2))
    v_p2 = np.sqrt(mu * (2.0 / r2_km - 1.0 / a2))
    v_c2 = np.sqrt(mu / r2_km)
    dv1 = abs(v_p1 - v_c1)
    dv2 = abs(v_a2 - v_a1)
    dv3 = abs(v_c2 - v_p2)
    t = np.pi * (np.sqrt(a1 ** 3 / mu) + np.sqrt(a2 ** 3 / mu))
    return BiEllipticTransferResult(dv1, dv2, dv3, dv1 + dv2 + dv3, t)


def lambert_solver_simple(r1, r2, tof_s: float, mu: float = MU_EARTH,
                          prograde: bool = True, iters: int = 60, *,
                          device="cuda") -> LambertResult:
    """Single-revolution Lambert via universal variables with bisection
    on z (Bate-Mueller-White algorithm 5.2), in numpy on the host.
    Returns departure/arrival velocities from the Lagrange f/g relations
    as f64 tensors on ``device`` (a tensor ``r1``'s device if given)."""
    dev = next((x.device for x in (r1, r2) if isinstance(x, torch.Tensor)),
               device)
    r1, r2 = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                         np.float64) for x in (r1, r2))
    r1n = np.linalg.norm(r1)
    r2n = np.linalg.norm(r2)
    if tof_s <= 0:
        raise ValueError("time of flight must be positive")

    cos_dnu = np.dot(r1, r2) / (r1n * r2n)
    cross = np.cross(r1, r2)
    sin_dnu = np.linalg.norm(cross) / (r1n * r2n)
    if (cross[2] < 0) == prograde:
        sin_dnu = -sin_dnu
    dnu = np.arctan2(sin_dnu, cos_dnu) % (2 * np.pi)
    A = np.sin(dnu) * np.sqrt(r1n * r2n / (1.0 - np.cos(dnu)))
    if abs(A) < 1e-12:
        raise ValueError("degenerate geometry (180-degree transfer)")

    def stumpff(z):
        if z > 1e-8:
            sz = np.sqrt(z)
            return ((sz - np.sin(sz)) / sz ** 3,
                    (1.0 - np.cos(sz)) / z)
        if z < -1e-8:
            sz = np.sqrt(-z)
            return ((np.sinh(sz) - sz) / sz ** 3,
                    (np.cosh(sz) - 1.0) / (-z))
        return 1.0 / 6.0, 0.5

    def tof_of_z(z):
        s, c = stumpff(z)
        y = r1n + r2n + A * (z * s - 1.0) / np.sqrt(c)
        if y < 0:
            return None, y
        chi = np.sqrt(y / c)
        return (chi ** 3 * s + A * np.sqrt(y)) / np.sqrt(mu), y

    # bisection bracket
    z_lo, z_hi = -4.0 * np.pi ** 2, 4.0 * np.pi ** 2
    while True:
        t_lo, _ = tof_of_z(z_lo)
        if t_lo is not None:
            break
        z_lo *= 0.5
    for _ in range(iters):
        z = 0.5 * (z_lo + z_hi)
        t, y = tof_of_z(z)
        if t is None or t < tof_s:
            z_lo = z
        else:
            z_hi = z
    z = 0.5 * (z_lo + z_hi)
    s, c = stumpff(z)
    y = r1n + r2n + A * (z * s - 1.0) / np.sqrt(c)

    f = 1.0 - y / r1n
    g = A * np.sqrt(y / mu)
    gdot = 1.0 - y / r2n
    v1 = (r2 - f * r1) / g
    v2 = (gdot * r2 - r1) / g
    return LambertResult(*_tensors(v1, v2, device=dev))
