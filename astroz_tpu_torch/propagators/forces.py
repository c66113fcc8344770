"""Force models as composable pure acceleration functions.

Counterpart of ``astroz_tpu/propagators/forces.py`` in plain torch:
TwoBody, the zonal terms J2-J4, exponential and layered-atmosphere drag,
cannonball solar radiation pressure with a cylindrical shadow, Battin's
third-body tide, and their sum. Formulas are the standard published ones
(Vallado, "Fundamentals of Astrodynamics and Applications", ch. 8-9).

A force model is any callable ``accel(r, v, t) -> a`` on tensors with a
trailing axis of 3: r in km, v in km/s, t in seconds, a in km/s^2. It
runs on the tensors' device and dtype and broadcasts over leading axes,
so one model propagates a whole Monte-Carlo ensemble. Time-varying
geometry is a ``pos_fn(t)`` callable that returns a tensor of
geocentric km.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..constants import AU_KM, EARTH, SOLAR_PRESSURE

__all__ = ["Accel", "Composite", "Drag", "ImprovedDrag", "J2", "J3", "J4",
           "SolarRadiationPressure", "ThirdBody", "TwoBody",
           "earth_default_forces"]

Accel = Callable[..., torch.Tensor]

_MU = EARTH.mu
_RE = EARTH.eq_radius
_J2 = EARTH.j2
_J3 = EARTH.j3
_J4 = EARTH.j4


def _norm(r):
    return torch.linalg.vector_norm(r, dim=-1, keepdim=True)


def _like(x, r):
    """``x`` (a tensor from ``pos_fn``) on ``r``'s device and dtype,
    broadcast to its shape."""
    return torch.as_tensor(x, dtype=r.dtype, device=r.device).expand(r.shape)


def TwoBody(mu: float = _MU) -> Accel:
    """Point-mass gravity."""

    def accel(r, v, t):
        rn = _norm(r)
        return -mu * r / rn ** 3

    return accel


def J2(mu: float = _MU, j2: float = _J2, r_eq: float = _RE) -> Accel:
    """First zonal harmonic."""

    def accel(r, v, t):
        rn = _norm(r)
        z2 = (r[..., 2:3] / rn) ** 2
        k = -1.5 * j2 * mu * r_eq ** 2 / rn ** 5
        xy_term = 1.0 - 5.0 * z2
        z_term = 3.0 - 5.0 * z2
        return k * torch.cat(
            [r[..., 0:1] * xy_term, r[..., 1:2] * xy_term,
             r[..., 2:3] * z_term], dim=-1)

    return accel


def J3(mu: float = _MU, j3: float = _J3, r_eq: float = _RE) -> Accel:
    """Second zonal harmonic."""

    def accel(r, v, t):
        rn = _norm(r)
        z = r[..., 2:3]
        zr = z / rn
        k = -2.5 * j3 * mu * r_eq ** 3 / rn ** 7
        xy_term = 3.0 * z - 7.0 * z * zr * zr
        z_term = 6.0 * z * zr - 7.0 * z * zr ** 3 - 0.6 * rn
        ax = k * r[..., 0:1] * xy_term
        ay = k * r[..., 1:2] * xy_term
        az = k * rn * z_term
        return torch.cat([ax, ay, az], dim=-1)

    return accel


def J4(mu: float = _MU, j4: float = _J4, r_eq: float = _RE) -> Accel:
    """Third zonal harmonic."""

    def accel(r, v, t):
        rn = _norm(r)
        zr = r[..., 2:3] / rn
        zr2 = zr * zr
        zr4 = zr2 * zr2
        k = 1.875 * j4 * mu * r_eq ** 4 / rn ** 7
        xy_term = 1.0 - 14.0 * zr2 + 21.0 * zr4
        z_term = 5.0 - 70.0 * zr2 / 3.0 + 21.0 * zr4
        return k * torch.cat(
            [r[..., 0:1] * xy_term, r[..., 1:2] * xy_term,
             r[..., 2:3] * z_term], dim=-1)

    return accel


def Drag(cd: float = 2.2, area_m2: float = 4.0, mass_kg: float = 1000.0,
         rho0: float = EARTH.sea_level_density,
         scale_height_m: float = EARTH.scale_height,
         r_eq: float = _RE) -> Accel:
    """Exponential-atmosphere drag; a static atmosphere (no
    co-rotation)."""
    bc = cd * area_m2 / mass_kg  # m^2/kg

    def accel(r, v, t):
        rn = _norm(r)
        alt_m = (rn - r_eq) * 1000.0
        rho = rho0 * torch.exp(-alt_m / scale_height_m)  # kg/m^3
        vn = _norm(v)
        # a [km/s^2] = -0.5 rho bc |v| v * 1000 (v in km/s; rho*bc in
        # 1/m; 0.5*rho*bc*|v|^2 [km^2/s^2 / m] -> *1e3 km)
        return -0.5 * rho * bc * 1000.0 * vn * v

    return accel


#: US Standard Atmosphere layers (base altitude km, density kg/m^3,
#: scale height km)
_ATMO_LAYERS = (
    (0.0, 1.225, 8.44),
    (100.0, 5.297e-7, 6.05),
    (200.0, 2.789e-10, 37.5),
    (500.0, 6.967e-13, 71.8),
    (1000.0, 3.019e-15, 268.0),
)


def ImprovedDrag(cd: float = 2.2, area_m2: float = 4.0,
                 mass_kg: float = 1000.0, f107: float = 150.0,
                 r_eq: float = _RE,
                 rotation_rate: float = EARTH.rotation_rate) -> Accel:
    """Layered-atmosphere drag with solar-activity scaling and a
    co-rotating atmosphere."""
    bc = cd * area_m2 / mass_kg

    def accel(r, v, t):
        rn = _norm(r)
        alt = rn - r_eq  # km
        # piecewise-exponential density, branchless over the 5 layers
        rho = torch.zeros_like(alt)
        for i, (base, rho0, h) in enumerate(_ATMO_LAYERS):
            upper = (_ATMO_LAYERS[i + 1][0] if i + 1 < len(_ATMO_LAYERS)
                     else float("inf"))
            in_layer = (alt >= base) & (alt < upper)
            rho = torch.where(in_layer,
                              rho0 * torch.exp(-(alt - base) / h), rho)
        # solar activity scaling (linear in F10.7 around 150)
        rho = rho * (1.0 + 0.3 * (f107 - 150.0) / 150.0)
        # velocity relative to the co-rotating atmosphere:
        # v_rel = v - omega x r, omega = [0, 0, rotation_rate]
        vrel = torch.stack(
            [v[..., 0] + rotation_rate * r[..., 1],
             v[..., 1] - rotation_rate * r[..., 0],
             v[..., 2]], dim=-1)
        vn = _norm(vrel)
        return -0.5 * rho * bc * 1000.0 * vn * vrel

    return accel


def SolarRadiationPressure(cr: float = 1.3, area_m2: float = 4.0,
                           mass_kg: float = 1000.0,
                           sun_pos_fn: Optional[Callable] = None,
                           r_eq: float = _RE) -> Accel:
    """Cannonball SRP with a cylindrical Earth shadow. ``sun_pos_fn(t)
    -> (..., 3) km`` defaults to a fixed sun on the +X axis at 1 AU."""
    k = SOLAR_PRESSURE * cr * area_m2 / mass_kg / 1000.0  # km/s^2 at 1 AU

    def accel(r, v, t):
        if sun_pos_fn is None:
            sun = torch.zeros_like(r)
            sun[..., 0] = AU_KM
        else:
            sun = _like(sun_pos_fn(t), r)
        to_sun = sun - r
        d = _norm(to_sun)
        u = to_sun / d
        # cylindrical shadow: dark iff anti-sunward and within one
        # earth radius of the sun-earth axis
        sun_n = sun / _norm(sun)
        along = torch.sum(r * sun_n, dim=-1, keepdim=True)
        perp = _norm(r - along * sun_n)
        lit = (along > 0.0) | (perp > r_eq)
        scale = (AU_KM / d) ** 2
        return torch.where(lit, -k * scale * u, 0.0)

    return accel


def ThirdBody(mu_body: float, pos_fn: Callable) -> Accel:
    """Third-body tidal acceleration, Battin's formulation. ``pos_fn(t)
    -> (..., 3)`` gives the body's geocentric position in km as a
    tensor.

    The naive ``d/|d|^3 - rb/|rb|^3`` difference cancels its ~4-5
    leading digits for a distant body (Sun at 1 AU vs a LEO radius:
    |r|/|rb| ~ 5e-5); Battin's identity rewrites it without the
    subtraction:  a = -mu_b (r + f(q) rb) / |d|^3  with
    q = r.(r - 2 rb)/(rb.rb)  and
    f(q) = q (3 + 3q + q^2) / (1 + (1+q)^{3/2}),
    where every term is O(q) ~ 2 |r|/|rb|."""

    def accel(r, v, t):
        rb = _like(pos_fn(t), r)
        d = rb - r                     # satellite -> body
        dn = _norm(d)
        rbsq = torch.sum(rb * rb, dim=-1, keepdim=True)
        q = torch.sum(r * (r - 2.0 * rb), dim=-1, keepdim=True) / rbsq
        fq = q * (3.0 + q * (3.0 + q)) \
            / (1.0 + (1.0 + q) * torch.sqrt(1.0 + q))
        return -mu_body * (r + fq * rb) / dn ** 3

    return accel


def Composite(models: Sequence[Accel]) -> Accel:
    """Sum of force models."""
    models = tuple(models)

    def accel(r, v, t):
        total = models[0](r, v, t)
        for m in models[1:]:
            total = total + m(r, v, t)
        return total

    return accel


def earth_default_forces(j2: bool = True, drag: bool = False,
                         **drag_kwargs) -> Accel:
    """TwoBody [+J2] [+Drag], ``propagate_numerical``'s default stack."""
    models = [TwoBody()]
    if j2:
        models.append(J2())
    if drag:
        models.append(Drag(**drag_kwargs))
    return Composite(models)
