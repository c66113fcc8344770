"""Split-precision propagation: f64 angle spine, f32 tail.

Counterpart of ``astroz_tpu/ops/fast.py`` in plain torch. The
time-growing secular angles are accumulated in f64 and reduced mod 2pi
(:func:`spine_f64`, :func:`deep_spine_f64`); drag, the lunisolar
periodics, the Kepler solve, the short-period terms and the TEME vectors
run in f32 with :mod:`fastmath`'s polynomial sincos
(:func:`shallow_tail_f32`, :func:`deep_tail_f32`). These functions are
the plain versions of the CUDA kernels in ``csrc/``: the kernels run the
same operations in the same order.

Deep-space resonance (the 720-minute Euler-Maclaurin integrator) is
integrated once per satellite into tables (:func:`resonance_tables_reference`,
the plain version of ``ops/cuda_sgp4.py:resonance_tables``, the TABLES
kernel); each grid point reads its row by a direct index
(:func:`resonance_from_tables`). :func:`sdp4_propagate_tables` is the
full-f64 SDP4 on those tables, the accuracy escape of extreme half-day
lanes.

:func:`propagate_fast_mixed` is the mixed branch of the JAX package's
unified dense entry point (``astroz_tpu/ops/fast.py:644``), which the
JAX package runs in XLA, in plain torch; the entry point itself is
``ops/cuda_sgp4.py:propagate_fast`` (near-earth elements through kernel
K5, a mixed catalog through this tail on the TABLES kernel's tables).

The JAX package spells the reciprocal square roots of the tail as
``lax.rsqrt``; here they are ``1 / sqrt(x)`` (:func:`fastmath.rsqrt`),
correctly rounded on every device.
"""

from __future__ import annotations

import math

import torch

from ..constants import GravityModel, TWO_PI
from .fastmath import (angle_add, div_pos, fast_atan2, pow23, recip_pos,
                       rsqrt, sincos, sqrt_rn)
from .sdp4 import (FASX2, FASX4, FASX6, G22, G32, G44, G52, G54, PI, RPTIM,
                   STEP2, STEPP, ZEL, ZES, ZNL, ZNS, integrate_resonance,
                   sdp4_finish)
from .sgp4 import update_secular

F32 = torch.float32

#: per-satellite f64 rows the spine reads, in kernel row order
SPINE_FIELD_NAMES = ("mo", "mdot", "argpo", "argpdot", "nodeo", "nodedot",
                     "nodecf", "no_unkozai", "t2cof", "t3cof", "t4cof",
                     "t5cof")

#: per-satellite f32 rows the tail reads, in kernel row order (the
#: JAX kernel's ``_FIELD_NAMES``; inclination rides as its f32 sincos)
TAIL_FIELD_NAMES = ("omgcof", "eta", "xmcof", "delmo", "cc1", "d2", "d3",
                    "d4", "bstar", "cc4", "cc5", "sinmao", "ecco", "sinip",
                    "cosip", "a", "aycof", "xlcof", "con41", "x1mth2",
                    "x7thm1")


def _wrap_two_pi_f32(x: torch.Tensor) -> torch.Tensor:
    """Cheap wrap into [0, 2pi) for |x| < ~4pi (post-reduction sums)."""
    two_pi = torch.tensor(TWO_PI, dtype=F32, device=x.device)
    x = torch.where(x >= two_pi, x - two_pi, x)
    x = torch.where(x >= two_pi, x - two_pi, x)
    return torch.where(x < 0.0, x + two_pi, x)


def solve_kepler_fast(u, axnl, aynl, iters: int = 8):
    """f32 equinoctial Kepler: fixed-trip Newton with polynomial sincos.

    ``iters - 1`` full trips, then a last trip whose small step updates
    sin/cos by a small-angle rotation instead of a fresh sincos."""
    eo1 = u
    sineo1, coseo1 = sincos(eo1)
    for _ in range(iters - 1):
        denom = 1.0 - coseo1 * axnl - sineo1 * aynl
        tem5 = div_pos(u - aynl * coseo1 + axnl * sineo1 - eo1, denom)
        eo1 = eo1 + torch.clamp(tem5, -0.95, 0.95)
        sineo1, coseo1 = sincos(eo1)
    denom = 1.0 - coseo1 * axnl - sineo1 * aynl
    tem5 = div_pos(u - aynl * coseo1 + axnl * sineo1 - eo1, denom)
    d = torch.clamp(tem5, -0.95, 0.95)
    eo1 = eo1 + d
    d2h = 0.5 * d * d
    sind = d * (1.0 - (1.0 / 3.0) * d2h)
    cosd = 1.0 - d2h
    return (eo1, sineo1 * cosd + coseo1 * sind,
            coseo1 * cosd - sineo1 * sind)


def shallow_tail_f32(grav: GravityModel, kepler_iters: int, t32, u_base,
                     mm, argp32, node32, xmdf32, *, omgcof, eta, xmcof,
                     delmo, not_simp, cc1, d2, d3, d4, bstar, cc4, cc5,
                     sinmao, ecco, sinip, cosip, a, aycof, xlcof, con41,
                     x1mth2, x7thm1, error0, want_vel: bool = True):
    """The f32 near-earth tail: drag -> Kepler -> short-period -> TEME.

    Grid inputs are the spine's f32 angles; per-satellite fields
    broadcast against them. Returns ``(rx, ry, rz, vx, vy, vz, error)``,
    or ``(rx, ry, rz, error)`` with ``want_vel=False`` (the velocity
    terms are then never computed)."""
    error = error0 + torch.zeros(u_base.shape, dtype=torch.int32,
                                 device=u_base.device)

    # ---- drag -------------------------------------------------------------
    # cos(xmdf), as in SGP4's update_secular (the JAX package's fast tail
    # takes the sine here: a fault of up to ~50 m, see ROADMAP queue 3)
    _, cos_xmdf = sincos(xmdf32)
    delmtemp = 1.0 + eta * cos_xmdf
    tempd = omgcof * t32 + xmcof * (delmtemp * delmtemp * delmtemp - delmo)
    mm_drag = torch.where(not_simp, mm + tempd, mm)

    t2_32 = t32 * t32
    tempa = (1.0 - cc1 * t32 - d2 * t2_32 - d3 * t2_32 * t32
             - d4 * t2_32 * t2_32)
    sin_mm, _ = sincos(mm_drag)
    tempe = bstar * cc4 * t32 + torch.where(
        not_simp, bstar * cc5 * (sin_mm - sinmao),
        torch.zeros((), dtype=F32, device=u_base.device))

    # ---- semi-major axis / mean motion -----------------------------------
    am = a * tempa * tempa
    am_safe = torch.where(am > 0.0, am, torch.ones_like(am))
    rsq_am = rsqrt(am_safe)

    em = ecco - tempe
    error = torch.where(((em >= 1.0) | (em < -0.001)) & (error == 0),
                        1, error)
    em = torch.clamp(em, 1.0e-6, 0.999999)

    sin_node, cos_node = sincos(node32 + torch.zeros_like(u_base))
    argpp = torch.where(not_simp, argp32 - tempd, argp32) \
        + torch.zeros_like(u_base)

    return _kepler_posvel_f32(grav, kepler_iters, u_base, am, am_safe,
                              rsq_am, em, argpp, sin_node, cos_node, sinip,
                              cosip, aycof, xlcof, con41, x1mth2, x7thm1,
                              error, want_vel=want_vel)


def _kepler_posvel_f32(grav: GravityModel, kepler_iters: int, u, am,
                       am_safe, rsq_am, ep, argpp, sin_node, cos_node,
                       sinip, cosip, aycof, xlcof, con41, x1mth2, x7thm1,
                       error, want_vel: bool = True):
    """Long-period terms -> Kepler -> short-period -> TEME components,
    all f32. ``rsq_am`` is 1/sqrt(am_safe)."""
    sin_argpp, cos_argpp = sincos(argpp)
    axnl = ep * cos_argpp
    temp_lp = recip_pos(am_safe * (1.0 - ep * ep))
    aynl = ep * sin_argpp + temp_lp * aycof
    u_kep = _wrap_two_pi_f32(u + temp_lp * xlcof * axnl)
    _, sineo1, coseo1 = solve_kepler_fast(u_kep, axnl, aynl,
                                          iters=kepler_iters)

    # ---- short-period corrections + position/velocity --------------------
    ecose = axnl * coseo1 + aynl * sineo1
    esine = axnl * sineo1 - aynl * coseo1
    el2 = axnl * axnl + aynl * aynl
    pl = am * (1.0 - el2)
    error = torch.where((pl < 0.0) & (error == 0), 4, error)
    pl_safe = torch.where(pl > 0.0, pl, torch.ones_like(pl))

    rl = am * (1.0 - ecose)
    # a true divide: rl may go non-positive on failing lanes and its
    # sign must reach the mrt < 1 check
    rl_inv = 1.0 / rl
    betal = sqrt_rn(torch.abs(1.0 - el2))
    temp_b = div_pos(esine, 1.0 + betal)
    am_rl = am * rl_inv
    sinu = am_rl * (sineo1 - aynl - axnl * temp_b)
    cosu = am_rl * (coseo1 - axnl + aynl * temp_b)
    sin2u = (cosu + cosu) * sinu
    cos2u = 1.0 - 2.0 * sinu * sinu
    rsq_pl = rsqrt(pl_safe)
    temp_p = rsq_pl * rsq_pl
    temp1 = 0.5 * torch.tensor(grav.j2, dtype=F32, device=u.device) * temp_p
    temp2 = temp1 * temp_p

    mrt = (rl * (1.0 - 1.5 * temp2 * betal * con41)
           + 0.5 * temp1 * x1mth2 * cos2u)
    sinsu, cossu = angle_add(sinu, cosu, -0.25 * temp2 * x7thm1 * sin2u)
    snod, cnod = angle_add(sin_node, cos_node, 1.5 * temp2 * cosip * sin2u)
    sini, cosi = angle_add(sinip, cosip,
                           1.5 * temp2 * cosip * sinip * cos2u)

    xmx = -snod * cosi
    xmy = cnod * cosi
    ux = xmx * sinsu + cnod * cossu
    uy = xmy * sinsu + snod * cossu
    uz = sini * sinsu

    error = torch.where((mrt < 1.0) & (error == 0), 6, error)
    ok = error == 0
    zero = torch.zeros((), dtype=F32, device=u.device)
    mrt_re = torch.where(ok, mrt * grav.radius_earth_km, zero)
    if not want_vel:
        return mrt_re * ux, mrt_re * uy, mrt_re * uz, error

    rdotl = am_safe * rsq_am * esine * rl_inv
    rvdotl = pl_safe * rsq_pl * rl_inv
    nm_oxke = rsq_am * rsq_am * rsq_am
    mvt = rdotl - nm_oxke * temp1 * x1mth2 * sin2u
    rvdot = rvdotl + nm_oxke * temp1 * (x1mth2 * cos2u + 1.5 * con41)
    vx_ = xmx * cossu - cnod * sinsu
    vy_ = xmy * cossu - snod * sinsu
    vz_ = sini * cossu
    vkmpersec = grav.radius_earth_km * grav.xke / 60.0
    mvt_s = torch.where(ok, vkmpersec * mvt, zero)
    rvdot_s = torch.where(ok, vkmpersec * rvdot, zero)
    return (mrt_re * ux, mrt_re * uy, mrt_re * uz,
            mvt_s * ux + rvdot_s * vx_,
            mvt_s * uy + rvdot_s * vy_,
            mvt_s * uz + rvdot_s * vz_, error)


def _shallow_f32_fields(els) -> dict:
    """The per-satellite f32 field bundle :func:`shallow_tail_f32` reads,
    from elements held as tensors. Inclination enters as its f32 sincos
    pair, hoisted out of the per-point tail."""
    def f32(x):
        return x.to(F32)

    sinip, cosip = sincos(f32(els.inclo))
    return dict(
        omgcof=f32(els.omgcof), eta=f32(els.eta), xmcof=f32(els.xmcof),
        delmo=f32(els.delmo), not_simp=~els.isimp, cc1=f32(els.cc1),
        d2=f32(els.d2), d3=f32(els.d3), d4=f32(els.d4),
        bstar=f32(els.bstar), cc4=f32(els.cc4), cc5=f32(els.cc5),
        sinmao=f32(els.sinmao), ecco=f32(els.ecco),
        sinip=sinip, cosip=cosip, a=f32(els.a), aycof=f32(els.aycof),
        xlcof=f32(els.xlcof), con41=f32(els.con41),
        x1mth2=f32(els.x1mth2), x7thm1=f32(els.x7thm1),
        error0=els.error)


def shallow_staging(els):
    """The per-satellite matrices of the near-earth kernels (K1, K3, K5,
    K6), from elements held as tensors (a broadcast of one satellite's
    elements too): ``spine`` (12, S) f64 rows :data:`SPINE_FIELD_NAMES`,
    ``tail`` (21, S) f32 rows :data:`TAIL_FIELD_NAMES` and ``flags`` (2,
    S) i32 rows ``[isimp, init error]``, each contiguous."""
    fields = _shallow_f32_fields(els)
    return (torch.stack([getattr(els, n) for n in SPINE_FIELD_NAMES]),
            torch.stack([fields[n] for n in TAIL_FIELD_NAMES]),
            torch.stack([els.isimp.to(torch.int32),
                         els.error.to(torch.int32)]))


def spine_f64(t: torch.Tensor, *, mo, mdot, argpo, argpdot, nodeo, nodedot,
              nodecf, no_unkozai, t2cof, t3cof, t4cof, t5cof):
    """The f64 angle spine: accumulate the time-growing angles at
    ``t`` minutes since epoch in f64, reduce mod 2pi (the remainder takes
    the divisor's sign, so backward times land in [0, 2pi) too), cast to
    f32. Returns ``(t32, u_base, mm, argp32, node32, xmdf32)``."""
    xmdf = mo + mdot * t
    argpdf = argpo + argpdot * t
    t2 = t * t
    nodem64 = nodeo + nodedot * t + nodecf * t2
    templ_big = no_unkozai * t2 * (
        t2cof + t * (t3cof + t * (t4cof + t * t5cof)))
    mm_spine = xmdf + templ_big
    return (t.to(F32),
            torch.remainder(mm_spine + argpdf, TWO_PI).to(F32),
            torch.remainder(mm_spine, TWO_PI).to(F32),
            torch.remainder(argpdf, TWO_PI).to(F32),
            torch.remainder(nodem64, TWO_PI).to(F32),
            torch.remainder(xmdf, TWO_PI).to(F32))


# ---------------------------------------------------------------------------
# Deep space: resonance tables, f64 deep spine, f32 deep tail (kernel K2's
# plain version) and the f64 escape
# ---------------------------------------------------------------------------

#: per-satellite f32 coefficients of the lunisolar periodics, in kernel
#: row order
DPPER_FIELD_NAMES = ("zmos", "se2", "se3", "si2", "si3", "sl2", "sl3",
                     "sl4", "sgh2", "sgh3", "sgh4", "sh2", "sh3",
                     "zmol", "ee2", "e3", "xi2", "xi3", "xl2", "xl3",
                     "xl4", "xgh2", "xgh3", "xgh4", "xh2", "xh3")

#: per-satellite f32 rows the deep tail reads, in kernel row order
DEEP_FIELD_NAMES = ("cc1", "bstar", "cc4", "ecco", "inclo", "dedt",
                    "didt") + DPPER_FIELD_NAMES

#: per-satellite f64 rows the deep spine reads, in kernel row order
#: (Sgp4Elements fields, then DeepElements dmdt/domdt/dnodt)
DEEP_SPINE_FIELD_NAMES = ("mo", "mdot", "dmdt", "argpo", "argpdot",
                          "domdt", "nodeo", "nodedot", "dnodt", "nodecf",
                          "no_unkozai", "t2cof", "gsto")

#: rows of a resonance table, in kernel order
RESONANCE_TABLE_NAMES = ("xli", "xni", "xndt", "xldot", "xnddt")


def _resonance_derivs_fast(deep, els, xli, xni, atime):
    """Resonance accelerations at the integrator state (xli, xni, atime):
    the state stays f64, the bounded sine series runs in f32 with the
    polynomial sincos on arguments reduced in f64. Returns ``(xndt,
    xldot, xnddt * xldot)`` in f64."""
    xli32 = torch.remainder(xli, TWO_PI).to(F32)
    xomi32 = torch.remainder(els.argpo + els.argpdot * atime,
                             TWO_PI).to(F32)
    s_li, c_li = sincos(xli32)
    # double angles from the single-angle sincos
    s_2li = 2.0 * s_li * c_li
    c_2li = 1.0 - 2.0 * s_li * s_li
    s_omi, c_omi = sincos(xomi32)
    s_2omi = 2.0 * s_omi * c_omi
    c_2omi = 1.0 - 2.0 * s_omi * s_omi

    def sc_sum(sa, ca, sb, cb):
        # sin/cos of (a + b)
        return sa * cb + ca * sb, ca * cb - sa * sb

    def sc_shift(s, c, const):
        # sin/cos of (x - const)
        sk, ck = math.sin(const), math.cos(const)
        return s * ck - c * sk, c * ck + s * sk

    # geosynchronous 3-term series (irez == 1)
    s_3li, c_3li = sc_sum(s_2li, c_2li, s_li, c_li)
    s1, c1 = sc_shift(s_li, c_li, FASX2)
    s2, c2 = sc_shift(s_2li, c_2li, 2.0 * FASX4)
    s3, c3 = sc_shift(s_3li, c_3li, 3.0 * FASX6)
    del1, del2, del3 = (deep.del1.to(F32), deep.del2.to(F32),
                        deep.del3.to(F32))
    xndt_1 = del1 * s1 + del2 * s2 + del3 * s3
    xnddt_1 = del1 * c1 + 2.0 * del2 * c2 + 3.0 * del3 * c3

    # half-day 10-term series (irez == 2)
    s_o_l, c_o_l = sc_sum(s_omi, c_omi, s_li, c_li)          # omi + li
    s_no_l, c_no_l = sc_sum(-s_omi, c_omi, s_li, c_li)       # -omi + li
    s_2o_l, c_2o_l = sc_sum(s_2omi, c_2omi, s_li, c_li)      # 2omi + li
    s_2o_2l, c_2o_2l = sc_sum(s_2omi, c_2omi, s_2li, c_2li)  # 2omi + 2li
    s_o_2l, c_o_2l = sc_sum(s_omi, c_omi, s_2li, c_2li)      # omi + 2li
    s_no_2l, c_no_2l = sc_sum(-s_omi, c_omi, s_2li, c_2li)   # -omi + 2li
    terms = [
        (deep.d2201, sc_shift(s_2o_l, c_2o_l, G22)),
        (deep.d2211, sc_shift(s_li, c_li, G22)),
        (deep.d3210, sc_shift(s_o_l, c_o_l, G32)),
        (deep.d3222, sc_shift(s_no_l, c_no_l, G32)),
        (deep.d4410, sc_shift(s_2o_2l, c_2o_2l, G44)),
        (deep.d4422, sc_shift(s_2li, c_2li, G44)),
        (deep.d5220, sc_shift(s_o_l, c_o_l, G52)),
        (deep.d5232, sc_shift(s_no_l, c_no_l, G52)),
        (deep.d5421, sc_shift(s_o_2l, c_o_2l, G54)),
        (deep.d5433, sc_shift(s_no_2l, c_no_2l, G54)),
    ]
    xndt_2 = sum(d.to(F32) * s for d, (s, _) in terms)
    xnddt_2 = sum(d.to(F32) * c * (2.0 if i in (4, 5, 8, 9) else 1.0)
                  for i, (d, (_, c)) in enumerate(terms))

    half_day = deep.irez == 2
    xndt = torch.where(half_day, xndt_2, xndt_1).to(xli.dtype)
    xnddt = torch.where(half_day, xnddt_2, xnddt_1).to(xli.dtype)
    xldot = xni + deep.xfact
    return xndt, xldot, xnddt * xldot


def resonance_tables_reference(deep, els, n_steps: int) -> torch.Tensor:
    """Per-satellite resonance integration tables, f64, shaped
    ``(5, 2 * (n_steps + 1), n_sats)``: rows ``RESONANCE_TABLE_NAMES`` of
    the integrator state and its derivatives after k 720-minute steps,
    forward states first (row k), backward after (row k + n_steps + 1).

    ``deep`` and ``els`` hold the satellites' DeepElements and
    Sgp4Elements as tensors; the forward and backward integrations step
    together on a (2, n_sats) state. The plain version of
    ``ops/cuda_sgp4.py:resonance_tables`` (the TABLES kernel of
    ``csrc/sgp4_deep.cu``)."""
    xlamo = deep.xlamo
    delt = torch.stack([torch.full_like(xlamo, STEPP),
                        torch.full_like(xlamo, -STEPP)])
    zeros2 = torch.zeros_like(delt)
    xli, xni, atime = xlamo + zeros2, els.no_unkozai + zeros2, zeros2
    rows = []
    for _ in range(n_steps + 1):
        xndt, xldot, xnddt = _resonance_derivs_fast(deep, els, xli, xni,
                                                    atime)
        rows.append(torch.stack([xli, xni, xndt, xldot, xnddt]))
        xli, xni, atime = (xli + xldot * delt + xndt * STEP2,
                           xni + xndt * delt + xnddt * STEP2,
                           atime + delt)
    # (steps + 1, 5, 2, S) -> (5, 2 * (steps + 1), S), forward block first
    rows = torch.stack(rows)
    return torch.cat([rows[:, :, 0], rows[:, :, 1]]).permute(1, 0, 2) \
        .contiguous()


def resonance_from_tables(t: torch.Tensor, tables: torch.Tensor):
    """The resonance integral at ``t`` minutes from epoch (f64, shape
    (..., n_sats)), read from :func:`resonance_tables_reference`'s
    tables: row k =
    min(floor(|t| / 720), n_steps), plus n_steps + 1 when t < 0, then the
    Euler-Maclaurin quadratic over the remaining ``t - atime``. Returns
    ``(nm_res, xl)``, meaningful on resonant lanes."""
    n_steps = tables.shape[1] // 2 - 1
    a = torch.abs(t)
    # exact floor division: a - fmod(a, 720) is a multiple of 720
    k = torch.clamp((a - torch.fmod(a, STEPP)) / STEPP, max=float(n_steps))
    idx = k.to(torch.int64) + (t < 0.0).to(torch.int64) * (n_steps + 1)
    idx = idx.reshape(1, -1, tables.shape[2]).expand(len(tables), -1, -1)
    xli, xni, xndt, xldot, xnddt = torch.gather(tables, 1, idx).reshape(
        (len(tables),) + t.shape)
    atime = k * torch.where(t > 0.0, STEPP, -STEPP)
    ft = t - atime
    nm_res = xni + xndt * ft + xnddt * ft * ft * 0.5
    xl = xli + xldot * ft + xndt * ft * ft * 0.5
    return nm_res, xl


def deep_spine_f64(t: torch.Tensor, tables: torch.Tensor, *, mo, mdot,
                   dmdt, argpo, argpdot, domdt, nodeo, nodedot, dnodt,
                   nodecf, no_unkozai, t2cof, gsto, irez):
    """The f64 angle spine of an all-deep subset: secular and lunisolar
    secular angles, the table-form resonance, reduced mod 2pi and cast
    to f32. ``theta`` takes the dividend's sign (fmod); every other
    reduction the divisor's (remainder). Returns ``(t32, u_base, mm,
    argp32, node32, nm_deep)``."""
    xmdf = mo + (mdot + dmdt) * t
    argpdf = argpo + (argpdot + domdt) * t
    t2 = t * t
    nodem64 = nodeo + (nodedot + dnodt) * t + nodecf * t2
    # deep lanes are simplified-drag: only the t2cof term survives
    templ_big = no_unkozai * t2 * t2cof

    resonant = irez != 0
    nm_res, xl = resonance_from_tables(t, tables)
    theta = torch.fmod(gsto + t * RPTIM, TWO_PI)
    mm_geo = xl - nodem64 - argpdf + theta
    mm_half = xl - 2.0 * nodem64 + 2.0 * theta
    mm_res = torch.where(irez == 1, mm_geo, mm_half)
    mm_spine = torch.where(resonant, mm_res, xmdf)
    nm_res64 = torch.where(resonant, nm_res, no_unkozai)
    mm_spine = mm_spine + templ_big
    return (t.to(F32),
            torch.remainder(mm_spine + argpdf, TWO_PI).to(F32),
            torch.remainder(mm_spine, TWO_PI).to(F32),
            torch.remainder(argpdf, TWO_PI).to(F32),
            torch.remainder(nodem64, TWO_PI).to(F32),
            nm_res64.to(F32))


def _dpper_core(t32, ep, inclp, sin_node, cos_node, nodep, mp, argpp,
                u_sum, *, zmos, se2, se3, si2, si3, sl2, sl3, sl4, sgh2,
                sgh3, sgh4, sh2, sh3, zmol, ee2, e3, xi2, xi3, xl2, xl3,
                xl4, xgh2, xgh3, xgh4, xh2, xh3):
    """f32 lunisolar periodics: the perturbed (ep, inclp, nodep, sin/cos
    node, argpp) and the Kepler argument ``u_sum + d(mp + argpp)``, with
    the Lyddane path (inclination < 0.2 rad) chosen per point."""
    # solar then lunar terms
    zm = zmos + ZNS * t32
    szm, _ = sincos(zm)
    zf = zm + 2.0 * ZES * szm
    sinzf, coszf = sincos(zf)
    f2 = 0.5 * sinzf * sinzf - 0.25
    f3 = -0.5 * sinzf * coszf
    ses = se2 * f2 + se3 * f3
    sis = si2 * f2 + si3 * f3
    sls = sl2 * f2 + sl3 * f3 + sl4 * sinzf
    sghs = sgh2 * f2 + sgh3 * f3 + sgh4 * sinzf
    shs = sh2 * f2 + sh3 * f3

    zm = zmol + ZNL * t32
    szm, _ = sincos(zm)
    zf = zm + 2.0 * ZEL * szm
    sinzf, coszf = sincos(zf)
    f2 = 0.5 * sinzf * sinzf - 0.25
    f3 = -0.5 * sinzf * coszf
    sel = ee2 * f2 + e3 * f3
    sil = xi2 * f2 + xi3 * f3
    sll = xl2 * f2 + xl3 * f3 + xl4 * sinzf
    sghl = xgh2 * f2 + xgh3 * f3 + xgh4 * sinzf
    shll = xh2 * f2 + xh3 * f3

    pe = ses + sel
    pinc = sis + sil
    pl = sls + sll
    pgh = sghs + sghl
    ph = shs + shll

    inclp_new = inclp + pinc
    ep_new = ep + pe
    sinip, cosip = sincos(inclp_new)

    # normal path (inclination >= 0.2)
    sin_safe = torch.where(torch.abs(sinip) > 1e-12, sinip, 1e-12)
    ph_n = ph / sin_safe
    pgh_n = pgh - cosip * ph_n
    argpp_n = argpp + pgh_n
    du_n = pl + pgh_n                        # d(mp + argpp)
    nodep_n = nodep + ph_n
    sin_node_n, cos_node_n = angle_add(sin_node, cos_node, ph_n)

    # Lyddane path (inclination < 0.2)
    alfdp = sinip * sin_node + ph * cos_node + pinc * cosip * sin_node
    betdp = sinip * cos_node - ph * sin_node + pinc * cosip * cos_node
    nodep_l = fast_atan2(alfdp, betdp)
    far = torch.abs(nodep - nodep_l) > PI
    nodep_l = torch.where(far & (nodep_l < nodep), nodep_l + TWO_PI,
                          torch.where(far & (nodep_l >= nodep),
                                      nodep_l - TWO_PI, nodep_l))
    xls = (mp + argpp + cosip * nodep + pl + pgh
           - pinc * nodep * sinip)
    mp_l = mp + pl
    argpp_l = xls - mp_l - cosip * nodep_l
    # mp_l + argpp_l - (mp + argpp), algebraically
    du_l = pl + pgh + cosip * (nodep - nodep_l) - pinc * nodep * sinip
    sin_node_l, cos_node_l = sincos(nodep_l)

    lyddane = inclp_new < 0.2
    return (ep_new, inclp_new,
            torch.where(lyddane, nodep_l, nodep_n),
            torch.where(lyddane, sin_node_l, sin_node_n),
            torch.where(lyddane, cos_node_l, cos_node_n),
            torch.where(lyddane, argpp_l, argpp_n),
            u_sum + torch.where(lyddane, du_l, du_n))


def deep_f32_fields(els, deep) -> dict:
    """The per-satellite f32 field bundle :func:`deep_tail_f32` reads,
    from Sgp4Elements and DeepElements held as tensors."""
    d = dict(cc1=els.cc1, bstar=els.bstar, cc4=els.cc4, ecco=els.ecco,
             inclo=els.inclo, dedt=deep.dedt, didt=deep.didt)
    d.update((name, getattr(deep, name)) for name in DPPER_FIELD_NAMES)
    return {k: v.to(F32) for k, v in d.items()}


def deep_tail_f32(grav: GravityModel, kepler_iters: int, t32, u_base, mm,
                  argp32, node32, nm_deep, *, cc1, bstar, cc4, ecco,
                  inclo, dedt, didt, error0, want_vel: bool = True,
                  **dpper_coeffs):
    """The f32 deep-space tail: simplified drag -> lunisolar periodics ->
    inclination flip -> per-point inclination coefficients -> Kepler ->
    short-period -> TEME. Errors 2, 1, 3 (in that order, each only where
    no earlier code is set), then 4 and 6. Returns ``(rx, ry, rz, vx,
    vy, vz, error)``, or ``(rx, ry, rz, error)`` with ``want_vel=False``."""
    error = error0 + torch.zeros(u_base.shape, dtype=torch.int32,
                                 device=u_base.device)

    # ---- simplified drag --------------------------------------------------
    tempa = 1.0 - cc1 * t32
    tempe = bstar * cc4 * t32

    # ---- semi-major axis from the resonance mean motion ------------------
    bad_nm = nm_deep <= 0.0
    error = torch.where(bad_nm & (error == 0), 2, error)
    xke32 = torch.tensor(grav.xke, dtype=F32, device=u_base.device)
    a_base = pow23(xke32 / torch.where(bad_nm, 1e-8, nm_deep))
    am = a_base * tempa * tempa
    am_safe = torch.where(am > 0.0, am, 1.0)
    rsq_am = rsqrt(am_safe)

    em = ecco - tempe + dedt * t32
    inclm = inclo + didt * t32
    error = torch.where(((em >= 1.0) | (em < -0.001)) & (error == 0), 1,
                        error)
    em = torch.clamp(em, 1.0e-6, 0.999999)

    # ---- lunisolar periodics and node --------------------------------------
    sin_node, cos_node = sincos(node32)
    ep, xincp, _, sin_node, cos_node, argpp, u = _dpper_core(
        t32, em, inclm, sin_node, cos_node, node32, mm, argp32, u_base,
        **dpper_coeffs)
    # inclination flip: node += pi, argp -= pi, and u = mp + argp with it
    neg_inc = xincp < 0.0
    xincp = torch.abs(xincp)
    sin_node = torch.where(neg_inc, -sin_node, sin_node)
    cos_node = torch.where(neg_inc, -cos_node, cos_node)
    argpp = torch.where(neg_inc, argpp - PI, argpp)
    u = torch.where(neg_inc, u - PI, u)
    error = torch.where(((ep < 0.0) | (ep > 1.0)) & (error == 0), 3, error)
    ep = torch.clamp(ep, 1e-12, 0.999999)

    # ---- per-point inclination-dependent coefficients --------------------
    sinip, cosip = sincos(xincp)
    j3oj2 = torch.tensor(grav.j3oj2, dtype=F32, device=u_base.device)
    aycof = -0.5 * j3oj2 * sinip
    near180 = torch.abs(cosip + 1.0) > 1.5e-12
    denom = torch.where(near180, 1.0 + cosip, 1.5e-12)
    xlcof = -0.25 * j3oj2 * sinip * (3.0 + 5.0 * cosip) / denom
    cosisq = cosip * cosip
    con41 = 3.0 * cosisq - 1.0
    x1mth2 = 1.0 - cosisq
    x7thm1 = 7.0 * cosisq - 1.0

    return _kepler_posvel_f32(grav, kepler_iters, u, am, am_safe, rsq_am,
                              ep, argpp, sin_node, cos_node, sinip, cosip,
                              aycof, xlcof, con41, x1mth2, x7thm1, error,
                              want_vel=want_vel)


def sdp4_propagate_tables(els, deep, t: torch.Tensor, grav: GravityModel,
                          tables: torch.Tensor):
    """Full-f64 SDP4 of an all-deep subset at ``t`` minutes from each
    epoch (shape (..., n_sats)), the resonance read from the tables of
    :func:`resonance_tables_reference` instead of stepped per point. The
    accuracy escape of extreme half-day lanes. Returns ``(r, v,
    error)``, r and v stacked ``(..., 3)`` f64."""
    mm, argpm, nodem, tempa, tempe, templ = update_secular(els, t)
    theta = torch.fmod(els.gsto + t * RPTIM, TWO_PI)
    em = els.ecco + deep.dedt * t
    inclm = els.inclo + deep.didt * t
    argpm = argpm + deep.domdt * t
    nodem = nodem + deep.dnodt * t
    mm = mm + deep.dmdt * t

    resonant = deep.irez != 0
    nm_res, xl = resonance_from_tables(t, tables)
    mm_geo = xl - nodem - argpm + theta
    mm_half = xl - 2.0 * nodem + 2.0 * theta
    mm = torch.where(resonant,
                     torch.where(deep.irez == 1, mm_geo, mm_half), mm)
    nm = torch.where(resonant, nm_res, els.no_unkozai)
    error = els.error.to(torch.int32).expand(t.shape)
    return sdp4_finish(els, deep, grav, t, em, argpm, inclm, mm, nodem, nm,
                       tempa, tempe, templ, error, els.is_deep)


# ---------------------------------------------------------------------------
# The unified dense fast path (near-earth through kernel K5 on the card;
# mixed catalogs in plain torch, as the JAX package runs them in XLA)
# ---------------------------------------------------------------------------


def _dpper_fast(deep, t32, ep, inclp, sin_node, cos_node, nodep, mp, argpp,
                u_sum, apply_mask):
    """:func:`_dpper_core` on the f32 coefficients of ``deep``, its
    results taken where ``apply_mask`` holds and the inputs passed
    through elsewhere."""
    new = _dpper_core(t32, ep, inclp, sin_node, cos_node, nodep, mp, argpp,
                      u_sum, **{n: getattr(deep, n).to(F32)
                                for n in DPPER_FIELD_NAMES})
    old = (ep, inclp, nodep, sin_node, cos_node, argpp, u_sum)
    return tuple(torch.where(apply_mask, a, b) for a, b in zip(new, old))


def propagate_fast_mixed(els, deep, tsince, grav: GravityModel,
                         tables=None, carry=None, kepler_iters: int = 8):
    """Split-precision propagate of a mixed catalog to ``tsince`` minutes
    from each epoch (f64, broadcasting against the ``(n_sats,)``
    elements), in plain torch over every lane, the deep coefficients zero
    on near-earth lanes.

    The resonance is read from ``tables`` (:func:`resonance_tables_reference`'s
    over every lane) by :func:`resonance_from_tables`, or with a
    :class:`~.sdp4.ResonanceCarry` in place of the tables, from a masked
    720-minute loop resumed from ``carry`` per point. Returns ``(r, v,
    error)``: f32 TEME km and km/s stacked ``(..., 3)``, int32
    python-sgp4 codes. The drag term takes cos(xmdf), as SGP4 does (the
    JAX package's mixed tail takes the sine; ROADMAP queue 3)."""
    t = torch.as_tensor(tsince, dtype=els.no_kozai.dtype,
                        device=els.no_kozai.device)
    n_sats = els.no_kozai.shape[0]
    shape = torch.broadcast_shapes(t.shape, (n_sats,))

    # ---- f64 spine ---------------------------------------------------------
    xmdf = els.mo + els.mdot * t
    argpdf = els.argpo + els.argpdot * t
    t2 = t * t
    nodem64 = els.nodeo + els.nodedot * t + els.nodecf * t2
    # lunisolar secular rates (exact zeros on near-earth lanes)
    xmdf = xmdf + deep.dmdt * t
    argpdf = argpdf + deep.domdt * t
    nodem64 = nodem64 + deep.dnodt * t
    templ_big = els.no_unkozai * t2 * (
        els.t2cof + t * (els.t3cof + t * (els.t4cof + t * els.t5cof)))

    is_deep = els.is_deep
    nm_res64 = els.no_unkozai + torch.zeros_like(xmdf)
    resonant = deep.irez != 0
    if carry is None:
        nm_res, xl = resonance_from_tables(t.expand(shape), tables)
    else:
        nm_res, xl, _ = integrate_resonance(deep, els, t, carry,
                                            _resonance_derivs_fast)
    theta = torch.fmod(els.gsto + t * RPTIM, TWO_PI)
    mm_geo = xl - nodem64 - argpdf + theta
    mm_half = xl - 2.0 * nodem64 + 2.0 * theta
    mm_res = torch.where(deep.irez == 1, mm_geo, mm_half)
    mm_spine = torch.where(resonant, mm_res, xmdf)
    nm_res64 = torch.where(resonant, nm_res, nm_res64)
    mm_spine = mm_spine + templ_big

    # ---- f32 tail ----------------------------------------------------------
    t32 = t.to(F32)
    u_base = torch.remainder(mm_spine + argpdf, TWO_PI).to(F32)
    mm = torch.remainder(mm_spine, TWO_PI).to(F32)
    argp32 = torch.remainder(argpdf, TWO_PI).to(F32)
    nodem = torch.remainder(nodem64, TWO_PI).to(F32)
    xmdf32 = torch.remainder(xmdf, TWO_PI).to(F32)
    nm_deep = nm_res64.to(F32)

    def f32(x):
        return x.to(F32)

    ecco, inclo, bstar = f32(els.ecco), f32(els.inclo), f32(els.bstar)
    error = torch.zeros(u_base.shape, dtype=torch.int32,
                        device=u_base.device) + els.error

    # drag
    _, cos_xmdf = sincos(xmdf32)
    delomg = f32(els.omgcof) * t32
    delmtemp = 1.0 + f32(els.eta) * cos_xmdf
    delm = f32(els.xmcof) * (delmtemp * delmtemp * delmtemp - f32(els.delmo))
    tempd = delomg + delm
    not_simp = ~els.isimp
    mm_drag = torch.where(not_simp, mm + tempd, mm)

    t2_32 = t32 * t32
    tempa = (1.0 - f32(els.cc1) * t32 - f32(els.d2) * t2_32
             - f32(els.d3) * t2_32 * t32 - f32(els.d4) * t2_32 * t2_32)
    sin_mm, _ = sincos(mm_drag)
    tempe = bstar * f32(els.cc4) * t32
    tempe = tempe + torch.where(
        not_simp, bstar * f32(els.cc5) * (sin_mm - f32(els.sinmao)), 0.0)

    # semi-major axis: deep lanes from the resonance mean motion
    xke32 = torch.tensor(grav.xke, dtype=F32, device=u_base.device)
    bad_nm = nm_deep <= 0.0
    error = torch.where(bad_nm & is_deep & (error == 0), 2, error)
    a_base = torch.where(is_deep,
                         pow23(xke32 / torch.where(bad_nm, 1e-8, nm_deep)),
                         f32(els.a))
    am = a_base * tempa * tempa
    am_safe = torch.where(am > 0.0, am, 1.0)
    rsq_am = rsqrt(am_safe)

    em = ecco - tempe + f32(deep.dedt) * t32
    inclm = inclo + f32(deep.didt) * t32
    error = torch.where(((em >= 1.0) | (em < -0.001)) & (error == 0), 1,
                        error)
    em = torch.clamp(em, 1.0e-6, 0.999999)

    # lunisolar periodics and node (deep lanes)
    nodem = nodem.expand(u_base.shape)
    sin_node, cos_node = sincos(nodem)
    argpp = torch.where(not_simp, argp32 - tempd, argp32) \
        + torch.zeros_like(u_base)
    ep, xincp, nodem, sin_node, cos_node, argpp, u = _dpper_fast(
        deep, t32, em, inclm, sin_node, cos_node, nodem, mm, argpp, u_base,
        apply_mask=is_deep)
    # inclination flip: node += pi, argp -= pi, and u = mp + argp with it
    neg_inc = xincp < 0.0
    xincp = torch.abs(xincp)
    sin_node = torch.where(neg_inc, -sin_node, sin_node)
    cos_node = torch.where(neg_inc, -cos_node, cos_node)
    argpp = torch.where(neg_inc, argpp - PI, argpp)
    u = torch.where(neg_inc, u - PI, u)
    error = torch.where(((ep < 0.0) | (ep > 1.0)) & (error == 0), 3, error)
    ep = torch.clamp(ep, 1e-12, 0.999999)

    # inclination-dependent coefficients, per point on deep lanes
    sinip, cosip = sincos(xincp)
    j3oj2 = torch.tensor(grav.j3oj2, dtype=F32, device=u_base.device)
    aycof_d = -0.5 * j3oj2 * sinip
    near180 = torch.abs(cosip + 1.0) > 1.5e-12
    denom = torch.where(near180, 1.0 + cosip, 1.5e-12)
    xlcof_d = -0.25 * j3oj2 * sinip * (3.0 + 5.0 * cosip) / denom
    cosisq = cosip * cosip
    aycof = torch.where(is_deep, aycof_d, f32(els.aycof))
    xlcof = torch.where(is_deep, xlcof_d, f32(els.xlcof))
    con41 = torch.where(is_deep, 3.0 * cosisq - 1.0, f32(els.con41))
    x1mth2 = torch.where(is_deep, 1.0 - cosisq, f32(els.x1mth2))
    x7thm1 = torch.where(is_deep, 7.0 * cosisq - 1.0, f32(els.x7thm1))

    rx, ry, rz, vx, vy, vz, error = _kepler_posvel_f32(
        grav, kepler_iters, u, am, am_safe, rsq_am, ep, argpp, sin_node,
        cos_node, sinip, cosip, aycof, xlcof, con41, x1mth2, x7thm1, error)
    return (torch.stack([rx, ry, rz], dim=-1),
            torch.stack([vx, vy, vz], dim=-1), error)
