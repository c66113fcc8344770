"""The integrator kernel's CPU side (``ops/cuda_integrate.py``,
``csrc/integrate_f64.cu`` of astroz_tpu_torch) and the plain loops beside
its callers, against astroz_tpu on the CPU.

* every force model object equals, bit for bit on the CPU, the closure it
  replaced (copied below as it stood), and JAX's model within the
  tolerance of ``tests/test_torch_propagators.py`` (rtol 1e-12, atol
  1e-12 km/s^2);
* ``terms`` and ``kernel_terms`` of every model, of nested Composites and
  of the models no kernel computes (``None``);
* each mode's plain version against JAX: ``driver.fixed_reference`` (RK4
  and fixed DP8(7), 1 and 2 substeps, batch shapes (), (7,) and (3, 5))
  within 1e-8 km of ``propagate_fixed``; ``integrators.adaptive_reference``
  with JAX's substep count and within 1e-6 km of ``dp87_adaptive`` (the
  tolerance of ``tests/test_torch_propagators.py``: XLA's fused loop
  rounds the error estimate otherwise); ``calculations.attitude_reference``
  within 1e-12 of ``propagate_attitude``;
* TRAJECTORY's plain version, ``integrators.adaptive_trajectory_reference``:
  bit for bit the loop of ``Propagator(DormandPrince87)`` on the CPU
  (states, ``h_current``, ``n_substeps``), within 1e-6 km of JAX's
  ``Propagator`` with its substep counts, and the substep cap's
  ``RuntimeError`` at the same outer step as the loop's;
* the route, chosen once (``forces.kernel_route``): the CPU runs the plain
  loops and counts no launch; a CUDA state of a model with kernel terms
  takes the kernel, one without terms or a batched state the loop (a
  tensor that says it is on CUDA stands in for the card); the launch
  wrappers take CUDA tensors only; the kernel's ``enum Kind`` and DP8(7)
  tableau against the python lists they mirror; the model packing and its
  errors.

The card's side (each mode bit for bit against its plain version, the
trajectory against the per-step launches, the divide probe, launch
counts) is in ``tests/test_torch_cuda.py``.
"""

import math
import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import astroz_tpu.calculations as JC
import astroz_tpu.propagators as JP

import astroz_tpu_torch.calculations as C
import astroz_tpu_torch.propagators as P
import astroz_tpu_torch.propagators.driver as PD
import astroz_tpu_torch.propagators.integrators as PI
from astroz_tpu_torch.constants import AU_KM, EARTH, SOLAR_PRESSURE
from astroz_tpu_torch.ops import cuda_integrate as CI

torch.set_num_threads(1)

SOURCE = (Path(__file__).resolve().parents[1] / "astroz_tpu_torch" / "csrc"
          / "integrate_f64.cu").read_text()
TOL = dict(rtol=1e-12, atol=1e-12)
MU, RE = EARTH.mu, EARTH.eq_radius


# ---------------------------------------------------------------------------
# The closures the force objects replaced, as they stood
# ---------------------------------------------------------------------------


def _norm(r):
    return torch.linalg.vector_norm(r, dim=-1, keepdim=True)


def _like(x, r):
    return torch.as_tensor(x, dtype=r.dtype, device=r.device).expand(r.shape)


def old_two_body(mu=MU):
    def accel(r, v, t):
        rn = _norm(r)
        return -mu * r / rn ** 3
    return accel


def old_j2(mu=MU, j2=EARTH.j2, r_eq=RE):
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


def old_j3(mu=MU, j3=EARTH.j3, r_eq=RE):
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


def old_j4(mu=MU, j4=EARTH.j4, r_eq=RE):
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


def old_drag(cd=2.2, area_m2=4.0, mass_kg=1000.0,
             rho0=EARTH.sea_level_density, scale_height_m=EARTH.scale_height,
             r_eq=RE):
    bc = cd * area_m2 / mass_kg

    def accel(r, v, t):
        rn = _norm(r)
        alt_m = (rn - r_eq) * 1000.0
        rho = rho0 * torch.exp(-alt_m / scale_height_m)
        vn = _norm(v)
        return -0.5 * rho * bc * 1000.0 * vn * v
    return accel


_ATMO_LAYERS = ((0.0, 1.225, 8.44), (100.0, 5.297e-7, 6.05),
                (200.0, 2.789e-10, 37.5), (500.0, 6.967e-13, 71.8),
                (1000.0, 3.019e-15, 268.0))


def old_improved_drag(cd=2.2, area_m2=4.0, mass_kg=1000.0, f107=150.0,
                      r_eq=RE, rotation_rate=EARTH.rotation_rate):
    bc = cd * area_m2 / mass_kg

    def accel(r, v, t):
        rn = _norm(r)
        alt = rn - r_eq
        rho = torch.zeros_like(alt)
        for i, (base, rho0, h) in enumerate(_ATMO_LAYERS):
            upper = (_ATMO_LAYERS[i + 1][0] if i + 1 < len(_ATMO_LAYERS)
                     else float("inf"))
            in_layer = (alt >= base) & (alt < upper)
            rho = torch.where(in_layer,
                              rho0 * torch.exp(-(alt - base) / h), rho)
        rho = rho * (1.0 + 0.3 * (f107 - 150.0) / 150.0)
        vrel = torch.stack(
            [v[..., 0] + rotation_rate * r[..., 1],
             v[..., 1] - rotation_rate * r[..., 0],
             v[..., 2]], dim=-1)
        vn = _norm(vrel)
        return -0.5 * rho * bc * 1000.0 * vn * vrel
    return accel


def old_srp(cr=1.3, area_m2=4.0, mass_kg=1000.0, sun_pos_fn=None, r_eq=RE):
    k = SOLAR_PRESSURE * cr * area_m2 / mass_kg / 1000.0

    def accel(r, v, t):
        if sun_pos_fn is None:
            sun = torch.zeros_like(r)
            sun[..., 0] = AU_KM
        else:
            sun = _like(sun_pos_fn(t), r)
        to_sun = sun - r
        d = _norm(to_sun)
        u = to_sun / d
        sun_n = sun / _norm(sun)
        along = torch.sum(r * sun_n, dim=-1, keepdim=True)
        perp = _norm(r - along * sun_n)
        lit = (along > 0.0) | (perp > r_eq)
        scale = (AU_KM / d) ** 2
        return torch.where(lit, -k * scale * u, 0.0)
    return accel


def old_third_body(mu_body, pos_fn):
    def accel(r, v, t):
        rb = _like(pos_fn(t), r)
        d = rb - r
        dn = _norm(d)
        rbsq = torch.sum(rb * rb, dim=-1, keepdim=True)
        q = torch.sum(r * (r - 2.0 * rb), dim=-1, keepdim=True) / rbsq
        fq = q * (3.0 + q * (3.0 + q)) \
            / (1.0 + (1.0 + q) * torch.sqrt(1.0 + q))
        return -mu_body * (r + fq * rb) / dn ** 3
    return accel


def old_composite(models):
    models = tuple(models)

    def accel(r, v, t):
        total = models[0](r, v, t)
        for m in models[1:]:
            total = total + m(r, v, t)
        return total
    return accel


def _sun(xp):
    return lambda t: xp.asarray([AU_KM * np.cos(1e-7 * t),
                                 AU_KM * np.sin(1e-7 * t), 0.0])


def _moon(xp):
    return lambda t: xp.asarray([384400.0, 1000.0, -2000.0])


#: name -> (the port's model, the closure it replaced, JAX's model)
MODELS = {
    "TwoBody": lambda: (P.TwoBody(), old_two_body(), JP.TwoBody()),
    "TwoBody(mu)": lambda: (P.TwoBody(3.5e5), old_two_body(3.5e5),
                            JP.TwoBody(3.5e5)),
    "J2": lambda: (P.J2(), old_j2(), JP.J2()),
    "J3": lambda: (P.J3(), old_j3(), JP.J3()),
    "J4": lambda: (P.J4(), old_j4(), JP.J4()),
    "Drag": lambda: (P.Drag(cd=2.0, area_m2=3.0, mass_kg=500.0),
                     old_drag(cd=2.0, area_m2=3.0, mass_kg=500.0),
                     JP.Drag(cd=2.0, area_m2=3.0, mass_kg=500.0)),
    "ImprovedDrag": lambda: (P.ImprovedDrag(f107=220.0),
                             old_improved_drag(f107=220.0),
                             JP.ImprovedDrag(f107=220.0)),
    "SRP": lambda: (P.SolarRadiationPressure(), old_srp(),
                    JP.SolarRadiationPressure()),
    "SRP(sun_pos_fn)": lambda: (
        P.SolarRadiationPressure(sun_pos_fn=_sun(torch)),
        old_srp(sun_pos_fn=_sun(torch)),
        JP.SolarRadiationPressure(sun_pos_fn=_sun(jnp))),
    "ThirdBody": lambda: (P.ThirdBody(4902.800066, _moon(torch)),
                          old_third_body(4902.800066, _moon(torch)),
                          JP.ThirdBody(4902.800066, _moon(jnp))),
    "Composite": lambda: (
        P.Composite([P.TwoBody(), P.J2(), P.J3(), P.J4(), P.Drag()]),
        old_composite([old_two_body(), old_j2(), old_j3(), old_j4(),
                       old_drag()]),
        JP.Composite([JP.TwoBody(), JP.J2(), JP.J3(), JP.J4(), JP.Drag()])),
    "earth_default_forces": lambda: (
        P.earth_default_forces(drag=True, cd=2.5),
        old_composite([old_two_body(), old_j2(), old_drag(cd=2.5)]),
        JP.earth_default_forces(drag=True, cd=2.5)),
}


def random_states(n, seed):
    """``n`` states from 150 km to GEO radius, every direction; the first
    8 in the Earth's shadow for a sun on +X."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(n, 3))
    r *= (RE + rng.uniform(150.0, 36000.0, n))[:, None] \
        / np.linalg.norm(r, axis=-1, keepdims=True)
    r[:8] = [[-7000.0, y, 0.0] for y in np.linspace(-3000, 3000, 8)]
    v = rng.normal(0.0, 4.0, (n, 3))
    return r, v


@pytest.mark.parametrize("name", sorted(MODELS))
def test_force_object_equals_its_closure_and_jax(name):
    """On 256 random states: the object's acceleration equals the
    closure's bit for bit, and JAX's within rtol 1e-12, atol 1e-12."""
    model, closure, jmodel = MODELS[name]()
    r, v = random_states(256, seed=len(name))
    rt, vt = torch.from_numpy(r), torch.from_numpy(v)
    a = model(rt, vt, 1234.5)
    assert torch.equal(a, closure(rt, vt, 1234.5))
    ref = np.asarray(jmodel(jnp.asarray(r), jnp.asarray(v), 1234.5))
    np.testing.assert_allclose(a.numpy(), ref, **TOL)


def test_terms_of_every_model():
    """Each kernel model's terms: its kind and the python floats its
    arithmetic applies, a divisor as its reciprocal."""
    kt = P.kernel_terms
    assert kt(P.TwoBody(3.5e5)) == (("TWO_BODY", (-3.5e5,)),)
    assert kt(P.J2()) == (("J2", (-1.5 * EARTH.j2 * MU * RE ** 2,)),)
    assert kt(P.J3()) == (("J3", (-2.5 * EARTH.j3 * MU * RE ** 3,)),)
    assert kt(P.J4()) == (("J4", (1.875 * EARTH.j4 * MU * RE ** 4,)),)
    assert kt(P.Drag(cd=2.0, area_m2=3.0, mass_kg=500.0)) == (
        ("DRAG", (RE, EARTH.sea_level_density, 1.0 / EARTH.scale_height,
                  2.0 * 3.0 / 500.0)),)
    (kind, p), = kt(P.ImprovedDrag(f107=220.0))
    assert kind == "IMPROVED_DRAG" and len(p) == CI.N_PARAMS[kind]
    assert p[:4] == (RE, 2.2 * 4.0 / 1000.0, 1.0 + 0.3 * 70.0 / 150.0,
                     EARTH.rotation_rate)
    assert p[4:] == tuple(x for b, rho, h in _ATMO_LAYERS
                          for x in (b, rho, 1.0 / h))
    assert kt(P.SolarRadiationPressure()) == (("SRP", (
        -(SOLAR_PRESSURE * 1.3 * 4.0 / 1000.0 / 1000.0), RE, AU_KM)),)
    for kind, params in (kt(P.earth_default_forces(drag=True)) or ()):
        assert kind in CI.KINDS and len(params) == CI.N_PARAMS[kind]


def test_terms_of_composites_and_models_without_a_kernel():
    """A Composite's terms are its members' in order (a first member may
    itself be a Composite); ``None`` where a member's is, where a later
    member has several terms (it would be summed first), and for an
    empty one. ThirdBody, SRP with a ``sun_pos_fn`` and any other
    callable have none; ``make_deriv`` carries the model's."""
    kt = P.kernel_terms
    two, j2, drag = P.TwoBody(), P.J2(), P.Drag()
    flat = kt(P.Composite([two, j2, drag]))
    assert [k for k, _ in flat] == ["TWO_BODY", "J2", "DRAG"]
    assert kt(P.Composite([P.Composite([two, j2]), drag])) == flat
    assert kt(P.Composite([P.Composite([P.Composite([two]), j2]),
                           P.Composite([drag])])) == flat
    assert kt(P.Composite([two, P.Composite([j2, drag])])) is None
    assert kt(P.Composite([])) is None
    moon = P.ThirdBody(4902.800066, _moon(torch))
    srp_fn = P.SolarRadiationPressure(sun_pos_fn=_sun(torch))
    for model in (moon, srp_fn, lambda r, v, t: -r, P.Composite([two, moon]),
                  P.Composite([srp_fn, two])):
        assert kt(model) is None
    assert PI.make_deriv(P.Composite([two, j2])).terms == kt(
        P.Composite([two, j2]))
    assert PI.make_deriv(moon).terms is None
    assert PI.make_deriv(lambda r, v, t: -r).terms is None


def test_models_past_max_terms_take_the_plain_route():
    """A model of more than the kernel's MAX_TERMS terms (one drag or SRP
    term a surface, say) has no kernel terms, so it runs the plain loop on
    every device, as its ``make_deriv`` does; MAX_TERMS of them still fit.
    On the CPU ``propagate_fixed`` of it equals the plain loop."""
    members = [P.TwoBody(), P.J2()] + [P.Drag()] * (CI.MAX_TERMS - 1)
    over, full = P.Composite(members), P.Composite(members[:-1])
    assert len(over.terms) == CI.MAX_TERMS + 1
    assert P.kernel_terms(over) is None
    assert PI.make_deriv(over).terms is None
    assert len(P.kernel_terms(full)) == CI.MAX_TERMS
    assert PI.make_deriv(full).terms == full.terms
    state = torch.as_tensor(np.random.default_rng(9).normal(
        [7000.0, 0.0, 0.0, 0.0, 7.5, 0.0], [50.0, 50.0, 50.0, 0.01, 0.01,
                                            0.01], (3, 6)))
    _, got = P.propagate_fixed(over, state, 0.0, 120.0, 30.0, device="cpu")
    want = PD.fixed_reference(over, state, 0.0, 4, 30.0)
    assert torch.equal(got, want)


def test_model_packing():
    """The wrapper's host arrays: kinds as the kernel's enum, parameters
    zero-padded; an unknown kind, a wrong parameter count, no terms or
    more than MAX_TERMS raise ``ValueError``."""
    terms = P.kernel_terms(P.Composite([P.TwoBody(), P.ImprovedDrag(),
                                        P.SolarRadiationPressure()]))
    n, kinds, params = CI._model(terms)
    assert n == 3 and list(kinds[:3]) == [0, 5, 6] and not kinds[3:].any()
    assert params.shape == (CI.MAX_TERMS, CI.MAX_PARAMS)
    assert params[0, 0] == -MU and not params[0, 1:].any()
    assert tuple(params[1]) == terms[1][1]
    assert tuple(params[2, :3]) == terms[2][1] and not params[3:].any()
    for bad in ((("THIRD_BODY", (1.0,)),), (("J2", (1.0, 2.0)),), (),
                (("J2", (1.0,)),) * (CI.MAX_TERMS + 1)):
        with pytest.raises(ValueError):
            CI._model(bad)


def test_kernel_enum_and_tableau_match_python():
    """``enum Kind`` lists ``KINDS`` in order with the same limits; the
    DP8(7) tableau of the source evaluates to the python floats of
    ``propagators/integrators.py`` (C and python both round p / q once)."""
    enum = re.search(r"enum Kind \{(.*?)\};", SOURCE, re.S).group(1)
    names = re.findall(r"^\s*([A-Z_0-9]+),", enum, re.M)
    assert tuple(names) == CI.KINDS and "N_KINDS" in enum
    assert f"MAX_TERMS = {CI.MAX_TERMS};" in SOURCE
    assert f"MAX_PARAMS = {CI.MAX_PARAMS};" in SOURCE

    def table(name):
        body = re.search(name + r"\[[^=]*=\s*\{(.*?)\};", SOURCE,
                         re.S).group(1)
        rows = re.findall(r"\{([^{}]*)\}", body) or [body]
        out = []
        for row in rows:
            vals = []
            for item in filter(None, (x.strip() for x in row.split(","))):
                num, _, den = item.partition("/")
                frac = Fraction(num.strip()) / Fraction(den.strip() or 1)
                vals.append(float(frac))
            out.append(tuple(vals))
        return out

    a = table("DP_A")
    assert len(a) == 13
    for i, row in enumerate(PI._A):
        assert a[i] == tuple(float(x) for x in row), i
    assert table("DP_B8")[0] == PI._B8
    assert table("DP_B7")[0] == PI._B7


def _lanes(batch, seed=0):
    """States around a 400 km circular orbit of the given batch shape."""
    r = RE + 400.0
    vc = np.sqrt(MU / r)
    base = np.array([r, 0.0, 0.0, 0.0, vc * np.cos(0.9), vc * np.sin(0.9)])
    return base + np.random.default_rng(seed).normal(
        0.0, [1.0, 1.0, 1.0, 1e-3, 1e-3, 1e-3], (*batch, 6))


@pytest.mark.parametrize("batch", [(), (7,), (3, 5)])
@pytest.mark.parametrize("substeps", [1, 2])
@pytest.mark.parametrize("method", ["rk4", "dp87"])
def test_fixed_reference_matches_jax(method, substeps, batch):
    """``fixed_reference`` (and ``propagate_fixed`` on the CPU, with no
    launch) of TwoBody + J2 + Drag, 12 samples of 120 s, against JAX's
    ``propagate_fixed``: 1e-8 km."""
    state = _lanes(batch, seed=len(batch) + substeps)
    accel = P.earth_default_forces(drag=True)
    before = dict(CI.LAUNCHES)
    got = PD.fixed_reference(accel, torch.from_numpy(state), 10.0, 12,
                             120.0 / substeps, method=method,
                             substeps=substeps)
    _, via = P.propagate_fixed(accel, torch.from_numpy(state), 10.0, 1440.0,
                               120.0, method=method, substeps=substeps,
                               device="cpu")
    assert CI.LAUNCHES == before and torch.equal(got, via)
    _, ref = JP.propagate_fixed(JP.earth_default_forces(drag=True), state,
                                10.0, 1440.0, 120.0, method=method,
                                substeps=substeps)
    assert got.shape == (13, *batch, 6) == ref.shape
    assert float(np.abs(got.numpy()[..., :3] - np.asarray(ref)[..., :3])
                 .max()) <= 1e-8


@pytest.mark.parametrize("t1", [3 * 5553.6, -5553.6])
def test_adaptive_reference_matches_jax(t1):
    """``adaptive_reference`` of TwoBody + J2 from a 400 km orbit: JAX's
    substep count and within 1e-6 km; ``dp87_adaptive`` on the CPU (a
    numpy state and a tensor) is the plain loop, with no launch."""
    state = _lanes((), seed=9)
    deriv = P.make_deriv(P.Composite([P.TwoBody(), P.J2()]))
    kw = dict(rtol=1e-10, atol=1e-12, h_min=1e-3, h_max=3600.0,
              max_substeps=10000)
    h = min(abs(t1), 3600.0) * np.sign(t1)
    before = dict(CI.LAUNCHES)
    out, h_out, n = PI.adaptive_reference(deriv, torch.from_numpy(state),
                                          0.0, t1, h, **kw)
    via = P.dp87_adaptive(deriv, torch.from_numpy(state), 0.0, t1,
                          rtol=1e-10)
    api = P.dp87_adaptive(deriv, state, 0.0, t1, rtol=1e-10, device="cpu")
    assert CI.LAUNCHES == before
    assert torch.equal(via[0], out) and via[1:] == (h_out, n)
    assert torch.equal(api[0], out) and api[1:] == (h_out, n)
    jout, _, jn = JP.dp87_adaptive(
        JP.make_deriv(JP.Composite([JP.TwoBody(), JP.J2()])),
        jnp.asarray(state), 0.0, t1, rtol=1e-10)
    assert isinstance(n, int) and n == int(jn) > 10
    assert float(np.abs(out.numpy()[:3] - np.asarray(jout)[:3]).max()) \
        <= 1e-6


@pytest.mark.parametrize("batch", [(), (4,)])
def test_attitude_reference_matches_jax(batch):
    """``attitude_reference`` (and ``propagate_attitude`` on the CPU, a
    tensor and numpy, with no launch) with a torque against JAX's
    ``propagate_attitude``: 1e-12."""
    rng = np.random.default_rng(3)
    q0 = rng.normal(size=(*batch, 4))
    q0 /= np.linalg.norm(q0, axis=-1, keepdims=True)
    w0 = rng.normal(0.0, 0.05, (*batch, 3))
    inertia, torque = np.array([10.0, 12.0, 20.0]), np.array([1e-3, 0, -2e-3])
    args = [torch.from_numpy(x) for x in (q0, w0, inertia, torque)]
    before = dict(CI.LAUNCHES)
    q, w = C.attitude_reference(*args, 0.05, 400)
    via = C.propagate_attitude(*args, 0.05, 400)
    api = C.propagate_attitude(q0, w0, inertia, torque, 0.05, 400,
                               device="cpu")
    assert CI.LAUNCHES == before
    for got in (via, api):
        assert torch.equal(got[0], q) and torch.equal(got[1], w)
    if batch:  # JAX's quaternion product takes one body a call
        refs = [JC.propagate_attitude(jnp.asarray(q0[i]), jnp.asarray(w0[i]),
                                      inertia, torque, 0.05, 400)
                for i in range(batch[0])]
        jq = np.stack([np.asarray(r[0]) for r in refs])
        jw = np.stack([np.asarray(r[1]) for r in refs])
    else:
        jq, jw = (np.asarray(x) for x in JC.propagate_attitude(
            jnp.asarray(q0), jnp.asarray(w0), inertia, torque, 0.05, 400))
    np.testing.assert_allclose(q.numpy(), jq, rtol=0, atol=1e-12)
    np.testing.assert_allclose(w.numpy(), jw, rtol=0, atol=1e-12)


def test_wrappers_check_their_inputs():
    """A kernel wrapper refuses what its kernel does not take before any
    launch: a state that is not f64 or (..., 6), an adaptive or
    trajectory state of more than one trajectory, an unknown method, a
    tensor on the CPU (the route sends those to the plain loops)."""
    accel = P.TwoBody()
    bad32 = torch.zeros((2, 6), dtype=torch.float32)
    with pytest.raises(ValueError, match="f64"):
        CI._check_f64("state", bad32, (6,))
    with pytest.raises(ValueError, match="6"):
        CI._check_f64("state", torch.zeros((2, 5), dtype=torch.float64),
                      (6,))
    deriv = P.make_deriv(accel)
    with pytest.raises(ValueError, match="one trajectory"):
        CI.adaptive(deriv, torch.zeros((2, 6), dtype=torch.float64), 0.0,
                    1.0, 1.0, rtol=1e-10, atol=1e-12, h_min=1e-3,
                    h_max=3600.0, max_substeps=10)
    with pytest.raises(ValueError, match="one trajectory"):
        CI.trajectory(deriv, torch.zeros((2, 6), dtype=torch.float64), 0.0,
                      60.0, 3, rtol=1e-10, atol=1e-12, h_carried=None,
                      h_min=1e-3, h_max=3600.0, max_substeps=10)
    with pytest.raises(ValueError, match="method"):
        P.propagate_fixed(accel, _lanes((2,)), 0.0, 60.0, 60.0,
                          method="euler", device="cpu")
    one = torch.from_numpy(_lanes(()))
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64)
    w = torch.zeros(3, dtype=torch.float64)
    before = dict(CI.LAUNCHES)
    for launch in (
            lambda: CI.fixed(accel, one, 0.0, 2, 60.0),
            lambda: CI.adaptive(deriv, one, 0.0, 60.0, 60.0, rtol=1e-10,
                                atol=1e-12, h_min=1e-3, h_max=3600.0,
                                max_substeps=10),
            lambda: CI.trajectory(deriv, one, 0.0, 60.0, 3, rtol=1e-10,
                                  atol=1e-12, h_carried=None, h_min=1e-3,
                                  h_max=3600.0, max_substeps=10),
            lambda: CI.attitude(q, w, w + 1.0, w, 0.1, 3),
            lambda: CI.divide_probe(w + 1.0, w + 3.0)):
        with pytest.raises(ValueError, match="CUDA"):
            launch()
    assert CI.LAUNCHES == before


# ---------------------------------------------------------------------------
# TRAJECTORY's plain version and the one route
# ---------------------------------------------------------------------------


def _dp87_loop(integ, state, t0, dt, n):
    """``Propagator(integ).propagate``'s loop of ``step`` calls, with each
    outer step's substeps and ``h_current`` after it."""
    times = t0 + dt * np.arange(n)
    states, subs, hs = [state], [], []
    for k in range(1, n):
        before = integ.n_substeps
        state = integ.step(state, float(times[k - 1]), dt)
        subs.append(integ.n_substeps - before)
        hs.append(integ.h_current)
        states.append(state)
    return torch.stack(states), subs, hs


@pytest.mark.parametrize("dt,n,h_carried", [(60.0, 25, None),
                                            (600.0, 7, None),
                                            (-300.0, 7, 150.0)])
def test_trajectory_reference_equals_the_propagator_loop(dt, n, h_carried):
    """``adaptive_trajectory_reference`` of TwoBody + J2 equals, bit for
    bit, the loop of ``DormandPrince87.step`` calls that
    ``Propagator.propagate`` runs on the CPU: every state, each outer
    step's substeps and |h| after it, and the integrator's ``h_current``
    and ``n_substeps``; forward with one substep an outer step (60 s) and
    several (600 s), and backward from a carried |h|."""
    state = torch.from_numpy(_lanes((), seed=9))
    accel = P.Composite([P.TwoBody(), P.J2()])
    integ = P.DormandPrince87(accel, rtol=1e-10, device="cpu")
    integ.h_current = h_carried
    want, subs, hs = _dp87_loop(integ, state, 30.0, dt, n)
    got, g_subs, g_hs, info = PI.adaptive_trajectory_reference(
        integ.deriv, state, 30.0, dt, n, rtol=1e-10, atol=1e-12,
        h_carried=h_carried)
    assert torch.equal(got, want)
    assert g_subs.tolist() == subs and g_hs.tolist() == hs
    assert info.tolist() == [n - 1, integ.h_current, integ.n_substeps,
                             math.copysign(integ.h_current, dt)]
    via = P.DormandPrince87(accel, rtol=1e-10, device="cpu")
    via.h_current = h_carried
    times, states = P.Propagator(via).propagate(state, 30.0, dt * (n - 1),
                                                dt)
    assert torch.equal(states, want) and len(times) == n
    assert (via.h_current, via.n_substeps) == (integ.h_current,
                                               integ.n_substeps)


@pytest.mark.parametrize("dt,n", [(60.0, 16), (600.0, 7)])
def test_trajectory_reference_matches_jax(dt, n):
    """``adaptive_trajectory_reference`` of TwoBody + J2 against JAX's
    ``Propagator(DormandPrince87)``: within 1e-6 km
    (``test_adaptive_reference_matches_jax``'s tolerance) over outer steps
    of one substep (60 s; JAX's substep count, its ``dp87_adaptive``
    called as its ``DormandPrince87.step`` calls it) and of several (600
    s, where the carried h parts in its last bits and a count may
    differ)."""
    state = _lanes((), seed=9)
    deriv = P.make_deriv(P.Composite([P.TwoBody(), P.J2()]))
    got, subs, _, info = PI.adaptive_trajectory_reference(
        deriv, torch.from_numpy(state), 0.0, dt, n, rtol=1e-10, atol=1e-12)
    _, ref = JP.Propagator(JP.DormandPrince87(
        JP.Composite([JP.TwoBody(), JP.J2()]), rtol=1e-10)).propagate(
        state, 0.0, dt * (n - 1), dt)
    assert got.shape == ref.shape == (n, 6) and info[0] == n - 1
    assert float(np.abs(got.numpy()[:, :3] - ref[:, :3]).max()) <= 1e-6
    if dt == 60.0:
        jderiv = JP.make_deriv(JP.Composite([JP.TwoBody(), JP.J2()]))
        y, h = jnp.asarray(state), None
        for k in range(n - 1):
            y, h_next, jn = JP.dp87_adaptive(jderiv, y, dt * k,
                                             dt * (k + 1), rtol=1e-10, h0=h)
            h = float(jnp.abs(h_next))
            assert int(jn) == int(subs[k]) == 1, k


def test_substep_cap_raises_at_the_same_outer_step(monkeypatch):
    """With an impossible cap (3 substeps) and a carried |h|, the loop of
    ``step`` calls raises the cap's ``RuntimeError`` at its third outer
    step of 300 s; the plain trajectory stops there, and
    ``DormandPrince87.trajectory`` (its launch replaced by the plain
    trajectory) raises the same error and leaves ``h_current`` and
    ``n_substeps`` as the loop does: |h| after the second outer step and
    every substep counted, those of the third too."""
    state = torch.from_numpy(_lanes((), seed=9))
    accel = P.Composite([P.TwoBody(), P.J2()])

    def warmed():
        integ = P.DormandPrince87(accel, rtol=1e-10, device="cpu")
        _, s = P.Propagator(integ).propagate(state, 0.0, 600.0, 60.0)
        return integ, s[-1]

    loop, start = warmed()
    h0, n0 = loop.h_current, loop.n_substeps
    monkeypatch.setattr(PI, "MAX_SUBSTEPS", 3)
    with pytest.raises(RuntimeError, match="substep cap"):
        _dp87_loop(loop, start, 600.0, 300.0, 13)
    _, subs, hs, info = PI.adaptive_trajectory_reference(
        loop.deriv, start, 600.0, 300.0, 13, rtol=1e-10, atol=1e-12,
        h_carried=h0, max_substeps=3)
    done = int(info[0])
    assert 0 < done < 12 and int(subs[done]) == 3
    assert (info[1].item(), n0 + int(info[2])) == (loop.h_current,
                                                   loop.n_substeps)
    monkeypatch.setattr(CI, "trajectory",
                        lambda deriv, y, *a, **kw:
                        PI.adaptive_trajectory_reference(deriv, y, *a, **kw))
    via, _ = warmed()
    with pytest.raises(RuntimeError, match="substep cap"):
        via.trajectory(start, 600.0, 300.0, 13)
    assert (via.h_current, via.n_substeps) == (loop.h_current,
                                               loop.n_substeps)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on CUDA: it takes the kernel's route,
    whose launch the route test replaces."""

    @property
    def is_cuda(self):
        return True


def test_the_route_is_chosen_once(monkeypatch):
    """``forces.kernel_route`` picks the route for every integrator entry
    point: on the CPU ``Propagator.propagate``, ``dp87_adaptive`` and
    ``propagate_fixed`` run their plain loops and launch nothing; a state
    on CUDA (``_OnCard``) with a model of kernel terms takes the kernel
    (TRAJECTORY once a ``Propagator`` call, then once a ``dp87_adaptive``
    call, FIXED), with the
    plain loop's results where the launch is replaced by the plain
    version; a model without terms, a batched state, or an integrator
    other than ``DormandPrince87`` keeps the loop."""
    accel = P.Composite([P.TwoBody(), P.J2()])
    lanes = _lanes((2,), seed=4)
    calls = []

    def record(name, plain):
        def fn(*args, **kw):
            calls.append(name)
            args = [a.as_subclass(torch.Tensor)
                    if isinstance(a, torch.Tensor) else a for a in args]
            return plain(*args, **kw)
        return fn

    def run(state, model, integ=None):
        integ = integ or P.DormandPrince87(model, rtol=1e-10, device="cpu")
        _, s = P.Propagator(integ).propagate(state, 0.0, 180.0, 60.0)
        a = P.dp87_adaptive(P.make_deriv(model), state, 0.0, 60.0)[0]
        _, f = P.propagate_fixed(model, state, 0.0, 120.0, 60.0)
        return s, a, f, integ

    base = torch.from_numpy(lanes[0])
    want = run(base, accel)
    before = dict(CI.LAUNCHES)
    monkeypatch.setattr(CI, "trajectory", record(
        "trajectory", lambda deriv, y, t0, dt, n, **kw:
        PI.adaptive_trajectory_reference(deriv, y, t0, dt, n, **kw)))
    monkeypatch.setattr(CI, "adaptive",
                        record("adaptive", PI.adaptive_reference))
    monkeypatch.setattr(CI, "fixed", record("fixed", PD.fixed_reference))
    got = run(base.as_subclass(_OnCard), accel)
    assert calls == ["trajectory", "adaptive", "fixed"]
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g.as_subclass(torch.Tensor), w)
    assert (got[3].h_current, got[3].n_substeps) == (want[3].h_current,
                                                     want[3].n_substeps)
    calls.clear()
    # a model of a python function of t has no terms
    run(base.as_subclass(_OnCard), lambda r, v, t: accel(r, v, t))
    run(torch.from_numpy(lanes).as_subclass(_OnCard), accel)
    rk4 = P.Rk4(accel, device="cpu")
    P.Propagator(rk4).propagate(base.as_subclass(_OnCard), 0.0, 120.0, 60.0)
    assert calls == ["fixed"]  # the batched state's propagate_fixed
    assert CI.LAUNCHES == before
