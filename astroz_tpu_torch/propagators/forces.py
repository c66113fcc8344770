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

The models here are small callable objects whose ``terms`` tell the
integrator kernel (``ops/cuda_integrate.py``) what they compute: TwoBody,
J2-J4, both drags and SRP with its fixed sun run in the kernel on the
card; ThirdBody, SRP with a ``sun_pos_fn`` and any other callable hold a
python function of t, and a model of more than the kernel's ``MAX_TERMS``
terms does not fit it: those run the plain torch loop
(:func:`kernel_terms`).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..constants import AU_KM, EARTH, SOLAR_PRESSURE
from ..ops.cuda_integrate import MAX_TERMS

__all__ = ["Accel", "Composite", "Drag", "ImprovedDrag", "J2", "J3", "J4",
           "SolarRadiationPressure", "ThirdBody", "TwoBody",
           "earth_default_forces", "kernel_route", "kernel_terms"]

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


class _Model:
    """A force model: ``model(r, v, t) -> a``. ``terms`` says what the
    integrator kernel computes for it: a tuple of ``(kind, params)``, the
    kind one of ``ops.cuda_integrate.KINDS`` and ``params`` the python
    floats its arithmetic applies, a divisor as its reciprocal (torch on
    CUDA divides by a python float so); ``None`` where the model calls a
    python function of t, which no kernel can."""

    terms: Optional[tuple] = None

    def __call__(self, r, v, t):
        raise NotImplementedError


class TwoBody(_Model):
    """Point-mass gravity."""

    def __init__(self, mu: float = _MU):
        self.mu = mu

    @property
    def terms(self):
        return (("TWO_BODY", (-self.mu,)),)

    def __call__(self, r, v, t):
        rn = _norm(r)
        return -self.mu * r / rn ** 3


class J2(_Model):
    """First zonal harmonic."""

    def __init__(self, mu: float = _MU, j2: float = _J2, r_eq: float = _RE):
        self.mu, self.j2, self.r_eq = mu, j2, r_eq

    @property
    def _k(self):
        return -1.5 * self.j2 * self.mu * self.r_eq ** 2

    @property
    def terms(self):
        return (("J2", (self._k,)),)

    def __call__(self, r, v, t):
        rn = _norm(r)
        z2 = (r[..., 2:3] / rn) ** 2
        k = self._k / rn ** 5
        xy_term = 1.0 - 5.0 * z2
        z_term = 3.0 - 5.0 * z2
        return k * torch.cat(
            [r[..., 0:1] * xy_term, r[..., 1:2] * xy_term,
             r[..., 2:3] * z_term], dim=-1)


class J3(_Model):
    """Second zonal harmonic."""

    def __init__(self, mu: float = _MU, j3: float = _J3, r_eq: float = _RE):
        self.mu, self.j3, self.r_eq = mu, j3, r_eq

    @property
    def _k(self):
        return -2.5 * self.j3 * self.mu * self.r_eq ** 3

    @property
    def terms(self):
        return (("J3", (self._k,)),)

    def __call__(self, r, v, t):
        rn = _norm(r)
        z = r[..., 2:3]
        zr = z / rn
        k = self._k / rn ** 7
        xy_term = 3.0 * z - 7.0 * z * zr * zr
        z_term = 6.0 * z * zr - 7.0 * z * zr ** 3 - 0.6 * rn
        ax = k * r[..., 0:1] * xy_term
        ay = k * r[..., 1:2] * xy_term
        az = k * rn * z_term
        return torch.cat([ax, ay, az], dim=-1)


class J4(_Model):
    """Third zonal harmonic."""

    def __init__(self, mu: float = _MU, j4: float = _J4, r_eq: float = _RE):
        self.mu, self.j4, self.r_eq = mu, j4, r_eq

    @property
    def _k(self):
        return 1.875 * self.j4 * self.mu * self.r_eq ** 4

    @property
    def terms(self):
        return (("J4", (self._k,)),)

    def __call__(self, r, v, t):
        rn = _norm(r)
        zr = r[..., 2:3] / rn
        zr2 = zr * zr
        zr4 = zr2 * zr2
        k = self._k / rn ** 7
        xy_term = 1.0 - 14.0 * zr2 + 21.0 * zr4
        z_term = 5.0 - 70.0 * zr2 / 3.0 + 21.0 * zr4
        return k * torch.cat(
            [r[..., 0:1] * xy_term, r[..., 1:2] * xy_term,
             r[..., 2:3] * z_term], dim=-1)


class Drag(_Model):
    """Exponential-atmosphere drag; a static atmosphere (no
    co-rotation)."""

    def __init__(self, cd: float = 2.2, area_m2: float = 4.0,
                 mass_kg: float = 1000.0,
                 rho0: float = EARTH.sea_level_density,
                 scale_height_m: float = EARTH.scale_height,
                 r_eq: float = _RE):
        self.bc = cd * area_m2 / mass_kg  # m^2/kg
        self.rho0, self.scale_height_m, self.r_eq = rho0, scale_height_m, r_eq

    @property
    def terms(self):
        return (("DRAG", (self.r_eq, self.rho0, 1.0 / self.scale_height_m,
                          self.bc)),)

    def __call__(self, r, v, t):
        rn = _norm(r)
        alt_m = (rn - self.r_eq) * 1000.0
        rho = self.rho0 * torch.exp(-alt_m / self.scale_height_m)  # kg/m^3
        vn = _norm(v)
        # a [km/s^2] = -0.5 rho bc |v| v * 1000 (v in km/s; rho*bc in
        # 1/m; 0.5*rho*bc*|v|^2 [km^2/s^2 / m] -> *1e3 km)
        return -0.5 * rho * self.bc * 1000.0 * vn * v


#: US Standard Atmosphere layers (base altitude km, density kg/m^3,
#: scale height km)
_ATMO_LAYERS = (
    (0.0, 1.225, 8.44),
    (100.0, 5.297e-7, 6.05),
    (200.0, 2.789e-10, 37.5),
    (500.0, 6.967e-13, 71.8),
    (1000.0, 3.019e-15, 268.0),
)


class ImprovedDrag(_Model):
    """Layered-atmosphere drag with solar-activity scaling and a
    co-rotating atmosphere."""

    def __init__(self, cd: float = 2.2, area_m2: float = 4.0,
                 mass_kg: float = 1000.0, f107: float = 150.0,
                 r_eq: float = _RE,
                 rotation_rate: float = EARTH.rotation_rate):
        self.bc = cd * area_m2 / mass_kg
        self.f107, self.r_eq, self.rotation_rate = f107, r_eq, rotation_rate

    @property
    def _solar(self):
        # solar activity scaling (linear in F10.7 around 150)
        return 1.0 + 0.3 * (self.f107 - 150.0) / 150.0

    @property
    def terms(self):
        layers = tuple(x for base, rho0, h in _ATMO_LAYERS
                       for x in (base, rho0, 1.0 / h))
        return (("IMPROVED_DRAG", (self.r_eq, self.bc, self._solar,
                                   self.rotation_rate) + layers),)

    def __call__(self, r, v, t):
        rn = _norm(r)
        alt = rn - self.r_eq  # km
        # piecewise-exponential density, branchless over the 5 layers
        rho = torch.zeros_like(alt)
        for i, (base, rho0, h) in enumerate(_ATMO_LAYERS):
            upper = (_ATMO_LAYERS[i + 1][0] if i + 1 < len(_ATMO_LAYERS)
                     else float("inf"))
            in_layer = (alt >= base) & (alt < upper)
            rho = torch.where(in_layer,
                              rho0 * torch.exp(-(alt - base) / h), rho)
        rho = rho * self._solar
        # velocity relative to the co-rotating atmosphere:
        # v_rel = v - omega x r, omega = [0, 0, rotation_rate]
        rot = self.rotation_rate
        vrel = torch.stack(
            [v[..., 0] + rot * r[..., 1],
             v[..., 1] - rot * r[..., 0],
             v[..., 2]], dim=-1)
        vn = _norm(vrel)
        return -0.5 * rho * self.bc * 1000.0 * vn * vrel


class SolarRadiationPressure(_Model):
    """Cannonball SRP with a cylindrical Earth shadow. ``sun_pos_fn(t)
    -> (..., 3) km`` defaults to a fixed sun on the +X axis at 1 AU (the
    only case the integrator kernel computes)."""

    def __init__(self, cr: float = 1.3, area_m2: float = 4.0,
                 mass_kg: float = 1000.0,
                 sun_pos_fn: Optional[Callable] = None, r_eq: float = _RE):
        # km/s^2 at 1 AU
        self.k = SOLAR_PRESSURE * cr * area_m2 / mass_kg / 1000.0
        self.sun_pos_fn, self.r_eq = sun_pos_fn, r_eq

    @property
    def terms(self):
        if self.sun_pos_fn is not None:
            return None
        return (("SRP", (-self.k, self.r_eq, AU_KM)),)

    def __call__(self, r, v, t):
        if self.sun_pos_fn is None:
            sun = torch.zeros_like(r)
            sun[..., 0] = AU_KM
        else:
            sun = _like(self.sun_pos_fn(t), r)
        to_sun = sun - r
        d = _norm(to_sun)
        u = to_sun / d
        # cylindrical shadow: dark iff anti-sunward and within one
        # earth radius of the sun-earth axis
        sun_n = sun / _norm(sun)
        along = torch.sum(r * sun_n, dim=-1, keepdim=True)
        perp = _norm(r - along * sun_n)
        lit = (along > 0.0) | (perp > self.r_eq)
        scale = (AU_KM / d) ** 2
        return torch.where(lit, -self.k * scale * u, 0.0)


class ThirdBody(_Model):
    """Third-body tidal acceleration, Battin's formulation. ``pos_fn(t)
    -> (..., 3)`` gives the body's geocentric position in km as a
    tensor (so no kernel computes it: ``terms`` is None).

    The naive ``d/|d|^3 - rb/|rb|^3`` difference cancels its ~4-5
    leading digits for a distant body (Sun at 1 AU vs a LEO radius:
    |r|/|rb| ~ 5e-5); Battin's identity rewrites it without the
    subtraction:  a = -mu_b (r + f(q) rb) / |d|^3  with
    q = r.(r - 2 rb)/(rb.rb)  and
    f(q) = q (3 + 3q + q^2) / (1 + (1+q)^{3/2}),
    where every term is O(q) ~ 2 |r|/|rb|."""

    def __init__(self, mu_body: float, pos_fn: Callable):
        self.mu_body, self.pos_fn = mu_body, pos_fn

    def __call__(self, r, v, t):
        rb = _like(self.pos_fn(t), r)
        d = rb - r                     # satellite -> body
        dn = _norm(d)
        rbsq = torch.sum(rb * rb, dim=-1, keepdim=True)
        q = torch.sum(r * (r - 2.0 * rb), dim=-1, keepdim=True) / rbsq
        fq = q * (3.0 + q * (3.0 + q)) \
            / (1.0 + (1.0 + q) * torch.sqrt(1.0 + q))
        return -self.mu_body * (r + fq * rb) / dn ** 3


class Composite(_Model):
    """Sum of force models, left to right."""

    def __init__(self, models: Sequence[Accel]):
        self.models = tuple(models)

    @property
    def terms(self):
        """The members' terms in order; ``None`` if a member's is, or if a
        member after the first has several terms (it would be summed
        first, which the kernel's left-to-right sum does not do)."""
        out = []
        for i, m in enumerate(self.models):
            t = kernel_terms(m)
            if t is None or (i > 0 and len(t) > 1):
                return None
            out.extend(t)
        return tuple(out) or None

    def __call__(self, r, v, t):
        total = self.models[0](r, v, t)
        for m in self.models[1:]:
            total = total + m(r, v, t)
        return total


def kernel_terms(accel) -> Optional[tuple]:
    """``accel``'s terms for the integrator kernel, or ``None`` where it
    has none (a model of a python function of t, any other callable) or
    more than the kernel's ``MAX_TERMS``: such a model runs the plain loop
    on every device."""
    terms = getattr(accel, "terms", None)
    if terms is not None and len(terms) > MAX_TERMS:
        return None
    return terms


def kernel_route(state, accel) -> bool:
    """The integrators' one choice of route: the integrator kernel for a
    CUDA ``state`` and a model it computes (``kernel_terms`` not
    ``None``), else the plain loop of torch ops."""
    return state.is_cuda and kernel_terms(accel) is not None


def earth_default_forces(j2: bool = True, drag: bool = False,
                         **drag_kwargs) -> Accel:
    """TwoBody [+J2] [+Drag], ``propagate_numerical``'s default stack."""
    models = [TwoBody()]
    if j2:
        models.append(J2())
    if drag:
        models.append(Drag(**drag_kwargs))
    return Composite(models)
