"""SGP4 element init (host, f64 numpy) and the f64 propagation tail
(torch).

Counterpart of ``astroz_tpu/ops/sgp4.py``: the published SGP4 init
(Vallado, "Revisiting Spacetrack Report #3", AIAA 2006-6753; JAX
:40-295), vectorized over a catalog, every data-dependent branch a
``where`` mask and every init error a per-lane python-sgp4 code. Init
runs once per catalog on the host in f64, as in the JAX package's ingest
path, and gives the same bits; the catalog layer moves the finished
elements to the device once. :func:`update_secular`,
:func:`solve_kepler` and :func:`kepler_and_posvel` (JAX :296-433) are
the f64 propagation stages in plain torch, on any device, and
:func:`sgp4_propagate` (JAX :436) the f64 near-earth propagator built
from them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import (GravityModel, SGP4_DEEP_SPACE_THRESHOLD_MINUTES,
                         TWO_PI)
from ..time import gstime

X2O3 = 2.0 / 3.0
_TEMP4 = 1.5e-12  # divide-by-zero guard near inclination = 180 deg


class Sgp4Elements(NamedTuple):
    """Struct of per-satellite SGP4 coefficients, each of shape
    ``(n_sats,)``: f64 numpy arrays after init, or torch tensors once a
    catalog has moved them to its device."""

    # mean elements at epoch
    no_kozai: object
    no_unkozai: object
    ecco: object
    inclo: object
    nodeo: object
    argpo: object
    mo: object
    bstar: object
    # epoch
    epoch_jd: object
    gsto: object
    # derived orbit geometry
    a: object  # semi-major axis, earth radii
    alta: object
    altp: object
    # secular rates
    mdot: object
    argpdot: object
    nodedot: object
    nodecf: object
    # drag coefficients
    cc1: object
    cc4: object
    cc5: object
    d2: object
    d3: object
    d4: object
    t2cof: object
    t3cof: object
    t4cof: object
    t5cof: object
    omgcof: object
    xmcof: object
    eta: object
    delmo: object
    sinmao: object
    # long-period / short-period coefficients
    aycof: object
    xlcof: object
    con41: object
    x1mth2: object
    x7thm1: object
    # masks / status
    isimp: object  # bool: simplified drag (perigee < 220 km or deep space)
    is_deep: object  # bool: period >= 225 min -> needs SDP4
    error: object  # int32 init error code (0 = ok)


def _unkozai(no_kozai, ecco, inclo, grav: GravityModel):
    """Kozai -> Brouwer mean motion recovery."""
    cosio = np.cos(inclo)
    cosio2 = cosio * cosio
    eccsq = ecco * ecco
    omeosq = 1.0 - eccsq
    rteosq = np.sqrt(omeosq)
    ak = (grav.xke / no_kozai) ** X2O3
    d1 = 0.75 * grav.j2 * (3.0 * cosio2 - 1.0) / (rteosq * omeosq)
    del_ = d1 / (ak * ak)
    adel = ak * (1.0 - del_ * del_
                 - del_ * (1.0 / 3.0 + 134.0 * del_ * del_ / 81.0))
    del_ = d1 / (adel * adel)
    no_unkozai = no_kozai / (1.0 + del_)
    return no_unkozai, omeosq, rteosq, cosio, cosio2


def _sgp4_init_core(grav: GravityModel, *, no_kozai, ecco, inclo, nodeo,
                    argpo, mo, bstar, epoch_jd) -> Sgp4Elements:
    """The init body: every formula an elementwise f64 numpy op, in the
    same order as the JAX package's, so the fields agree bit for bit."""
    dt = np.float64
    no_kozai = np.asarray(no_kozai, dt)
    ecco = np.asarray(ecco, dt)
    inclo = np.asarray(inclo, dt)
    nodeo = np.asarray(nodeo, dt)
    argpo = np.asarray(argpo, dt)
    mo = np.asarray(mo, dt)
    bstar = np.asarray(bstar, dt)
    epoch_jd = np.asarray(epoch_jd, dt)

    re = grav.radius_earth_km
    j2, j3oj2, j4 = grav.j2, grav.j3oj2, grav.j4

    # ---- input validation -> error flags ---------------------------------
    safe_no = np.where(no_kozai > 0.0, no_kozai, 1e-8)
    safe_ecc = np.clip(ecco, 0.0, 0.999999)

    no_unkozai, omeosq, rteosq, cosio, cosio2 = _unkozai(
        safe_no, safe_ecc, inclo, grav)

    ao = (grav.xke / no_unkozai) ** X2O3
    sinio = np.sin(inclo)
    po = ao * omeosq
    con42 = 1.0 - 5.0 * cosio2
    con41 = -con42 - cosio2 - cosio2
    posq = po * po
    rp = ao * (1.0 - safe_ecc)
    is_deep = (TWO_PI / no_unkozai) >= SGP4_DEEP_SPACE_THRESHOLD_MINUTES

    gsto = gstime(epoch_jd)

    # ---- s-parameter tuning for low perigee ------------------------------
    ss = 78.0 / re + 1.0
    qzms2t = ((120.0 - 78.0) / re) ** 4
    perige = (rp - 1.0) * re

    sfour_adj = np.where(perige < 98.0, 20.0, perige - 78.0)
    qzms24 = np.where(perige < 156.0, ((120.0 - sfour_adj) / re) ** 4,
                      qzms2t)
    sfour = np.where(perige < 156.0, sfour_adj / re + 1.0, ss)

    isimp = (rp < (220.0 / re + 1.0)) | is_deep

    pinvsq = 1.0 / posq
    tsi = 1.0 / (ao - sfour)
    eta = ao * safe_ecc * tsi
    etasq = eta * eta
    eeta = safe_ecc * eta
    psisq = np.abs(1.0 - etasq)
    coef = qzms24 * tsi ** 4
    coef1 = coef / psisq ** 3.5
    cc2 = coef1 * no_unkozai * (
        ao * (1.0 + 1.5 * etasq + eeta * (4.0 + etasq))
        + 0.375 * j2 * tsi / psisq * con41
        * (8.0 + 3.0 * etasq * (8.0 + etasq)))
    cc1 = bstar * cc2
    big_e = safe_ecc > 1.0e-4
    cc3 = np.where(
        big_e,
        -2.0 * coef * tsi * j3oj2 * no_unkozai * sinio
        / np.where(big_e, safe_ecc, 1.0),
        0.0)
    x1mth2 = 1.0 - cosio2
    cc4 = 2.0 * no_unkozai * coef1 * ao * omeosq * (
        eta * (2.0 + 0.5 * etasq)
        + safe_ecc * (0.5 + 2.0 * etasq)
        - j2 * tsi / (ao * psisq)
        * (-3.0 * con41 * (1.0 - 2.0 * eeta + etasq * (1.5 - 0.5 * eeta))
           + 0.75 * x1mth2 * (2.0 * etasq - eeta * (1.0 + etasq))
           * np.cos(2.0 * argpo)))
    cc5 = 2.0 * coef1 * ao * omeosq * (
        1.0 + 2.75 * (etasq + eeta) + eeta * etasq)

    cosio4 = cosio2 * cosio2
    temp1 = 1.5 * j2 * pinvsq * no_unkozai
    temp2 = 0.5 * temp1 * j2 * pinvsq
    temp3 = -0.46875 * j4 * pinvsq * pinvsq * no_unkozai
    mdot = (no_unkozai + 0.5 * temp1 * rteosq * con41
            + 0.0625 * temp2 * rteosq
            * (13.0 - 78.0 * cosio2 + 137.0 * cosio4))
    argpdot = (-0.5 * temp1 * con42
               + 0.0625 * temp2 * (7.0 - 114.0 * cosio2 + 395.0 * cosio4)
               + temp3 * (3.0 - 36.0 * cosio2 + 49.0 * cosio4))
    xhdot1 = -temp1 * cosio
    nodedot = xhdot1 + (0.5 * temp2 * (4.0 - 19.0 * cosio2)
                        + 2.0 * temp3 * (3.0 - 7.0 * cosio2)) * cosio
    omgcof = bstar * cc3 * np.cos(argpo)
    xmcof = np.where(big_e,
                     -X2O3 * coef * bstar / np.where(big_e, eeta, 1.0),
                     0.0)
    nodecf = 3.5 * omeosq * xhdot1 * cc1
    t2cof = 1.5 * cc1

    near_180 = np.abs(cosio + 1.0) > 1.5e-12
    xlcof = np.where(
        near_180,
        -0.25 * j3oj2 * sinio * (3.0 + 5.0 * cosio)
        / np.where(near_180, 1.0 + cosio, 1.0),
        -0.25 * j3oj2 * sinio * (3.0 + 5.0 * cosio) / _TEMP4)
    aycof = -0.5 * j3oj2 * sinio
    delmo = (1.0 + eta * np.cos(mo)) ** 3
    sinmao = np.sin(mo)
    x7thm1 = 7.0 * cosio2 - 1.0

    # ---- higher-order drag (non-simplified lanes only) -------------------
    cc1sq = cc1 * cc1
    d2 = 4.0 * ao * tsi * cc1sq
    temp = d2 * tsi * cc1 / 3.0
    d3 = (17.0 * ao + sfour) * temp
    d4 = 0.5 * temp * ao * tsi * (221.0 * ao + 31.0 * sfour) * cc1
    t3cof = d2 + 2.0 * cc1sq
    t4cof = 0.25 * (3.0 * d3 + cc1 * (12.0 * d2 + 10.0 * cc1sq))
    t5cof = 0.2 * (3.0 * d4 + 12.0 * cc1 * d3 + 6.0 * d2 * d2
                   + 15.0 * cc1sq * (2.0 * d2 + cc1sq))
    zero = np.zeros_like(d2)
    d2 = np.where(isimp, zero, d2)
    d3 = np.where(isimp, zero, d3)
    d4 = np.where(isimp, zero, d4)
    t3cof = np.where(isimp, zero, t3cof)
    t4cof = np.where(isimp, zero, t4cof)
    t5cof = np.where(isimp, zero, t5cof)

    error = np.zeros(np.shape(no_unkozai), np.int32)
    error = np.where((ecco >= 1.0) | (ecco < -0.001), np.int32(1), error)
    error = np.where(no_kozai <= 0.0, np.int32(2), error)

    return Sgp4Elements(
        no_kozai=no_kozai, no_unkozai=no_unkozai, ecco=ecco, inclo=inclo,
        nodeo=nodeo, argpo=argpo, mo=mo, bstar=bstar, epoch_jd=epoch_jd,
        gsto=gsto, a=ao, alta=ao * (1.0 + safe_ecc) - 1.0,
        altp=ao * (1.0 - safe_ecc) - 1.0, mdot=mdot, argpdot=argpdot,
        nodedot=nodedot, nodecf=nodecf, cc1=cc1, cc4=cc4, cc5=cc5, d2=d2,
        d3=d3, d4=d4, t2cof=t2cof, t3cof=t3cof, t4cof=t4cof, t5cof=t5cof,
        omgcof=omgcof, xmcof=xmcof, eta=eta, delmo=delmo, sinmao=sinmao,
        aycof=aycof, xlcof=xlcof, con41=con41, x1mth2=x1mth2,
        x7thm1=x7thm1, isimp=isimp, is_deep=is_deep, error=error,
    )


def sgp4_init_np(grav: GravityModel, *, no_kozai, ecco, inclo, nodeo,
                 argpo, mo, bstar, epoch_jd) -> Sgp4Elements:
    """Initialize a catalog's SGP4 coefficients on the host: returns an
    :class:`Sgp4Elements` of f64 numpy arrays (bool ``isimp``/``is_deep``,
    int32 ``error``)."""
    return _sgp4_init_core(
        grav, no_kozai=no_kozai, ecco=ecco, inclo=inclo, nodeo=nodeo,
        argpo=argpo, mo=mo, bstar=bstar, epoch_jd=epoch_jd)


def solve_kepler(u, axnl, aynl, iters: int = 10):
    """Equinoctial Kepler solve in f64: ``iters`` Newton trips, each lane
    frozen once its step falls below 1e-12."""
    eo1 = u
    done = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    sineo1 = torch.sin(eo1)
    coseo1 = torch.cos(eo1)
    for _ in range(iters):
        denom = 1.0 - coseo1 * axnl - sineo1 * aynl
        tem5 = (u - aynl * coseo1 + axnl * sineo1 - eo1) / denom
        tem5 = torch.clamp(tem5, -0.95, 0.95)
        eo1 = torch.where(done, eo1, eo1 + tem5)
        done = done | (torch.abs(tem5) < 1.0e-12)
        sineo1 = torch.sin(eo1)
        coseo1 = torch.cos(eo1)
    return eo1, sineo1, coseo1


def kepler_and_posvel(grav: GravityModel, *, am, nm, ep, xincp, nodep,
                      argpp, mp, aycof, xlcof, con41, x1mth2, x7thm1,
                      error):
    """Long-period terms, Kepler solve, short-period corrections and
    orientation vectors -> TEME r (km) and v (km/s), stacked ``(..., 3)``
    and zero-filled where ``error`` is set (codes 4 and 6 added here)."""
    sinip = torch.sin(xincp)
    cosip = torch.cos(xincp)

    axnl = ep * torch.cos(argpp)
    temp = 1.0 / (am * (1.0 - ep * ep))
    aynl = ep * torch.sin(argpp) + temp * aycof
    xl = mp + argpp + nodep + temp * xlcof * axnl

    u = torch.remainder(xl - nodep, TWO_PI)
    _, sineo1, coseo1 = solve_kepler(u, axnl, aynl)

    ecose = axnl * coseo1 + aynl * sineo1
    esine = axnl * sineo1 - aynl * coseo1
    el2 = axnl * axnl + aynl * aynl
    pl = am * (1.0 - el2)
    error = torch.where((pl < 0.0) & (error == 0), 4, error)
    pl_safe = torch.where(pl > 0.0, pl, 1.0)

    rl = am * (1.0 - ecose)
    rdotl = torch.sqrt(am) * esine / rl
    rvdotl = torch.sqrt(pl_safe) / rl
    betal = torch.sqrt(torch.abs(1.0 - el2))
    temp = esine / (1.0 + betal)
    sinu = am / rl * (sineo1 - aynl - axnl * temp)
    cosu = am / rl * (coseo1 - axnl + aynl * temp)
    su = torch.atan2(sinu, cosu)
    sin2u = (cosu + cosu) * sinu
    cos2u = 1.0 - 2.0 * sinu * sinu
    temp = 1.0 / pl_safe
    temp1 = 0.5 * grav.j2 * temp
    temp2 = temp1 * temp

    mrt = (rl * (1.0 - 1.5 * temp2 * betal * con41)
           + 0.5 * temp1 * x1mth2 * cos2u)
    su = su - 0.25 * temp2 * x7thm1 * sin2u
    xnode = nodep + 1.5 * temp2 * cosip * sin2u
    xinc = xincp + 1.5 * temp2 * cosip * sinip * cos2u
    mvt = rdotl - nm * temp1 * x1mth2 * sin2u / grav.xke
    rvdot = rvdotl + nm * temp1 * (x1mth2 * cos2u + 1.5 * con41) / grav.xke

    sinsu = torch.sin(su)
    cossu = torch.cos(su)
    snod = torch.sin(xnode)
    cnod = torch.cos(xnode)
    sini = torch.sin(xinc)
    cosi = torch.cos(xinc)
    xmx = -snod * cosi
    xmy = cnod * cosi
    ux = xmx * sinsu + cnod * cossu
    uy = xmy * sinsu + snod * cossu
    uz = sini * sinsu
    vx = xmx * cossu - cnod * sinsu
    vy = xmy * cossu - snod * sinsu
    vz = sini * cossu

    re = grav.radius_earth_km
    vkmpersec = re * grav.xke / 60.0
    mrt_re = mrt * re
    r = torch.stack([mrt_re * ux, mrt_re * uy, mrt_re * uz], dim=-1)
    v = torch.stack([vkmpersec * (mvt * ux + rvdot * vx),
                     vkmpersec * (mvt * uy + rvdot * vy),
                     vkmpersec * (mvt * uz + rvdot * vz)], dim=-1)

    error = torch.where((mrt < 1.0) & (error == 0), 6, error)
    ok = (error == 0)[..., None]
    return torch.where(ok, r, 0.0), torch.where(ok, v, 0.0), error


def update_secular(els: Sgp4Elements, t):
    """Secular gravity and drag update to ``t`` minutes from epoch, f64:
    returns ``(mm, argpm, nodem, tempa, tempe, templ)``."""
    xmdf = els.mo + els.mdot * t
    argpdf = els.argpo + els.argpdot * t
    nodedf = els.nodeo + els.nodedot * t
    t2 = t * t
    nodem = nodedf + els.nodecf * t2
    tempa = 1.0 - els.cc1 * t
    tempe = els.bstar * els.cc4 * t
    templ = els.t2cof * t2

    # higher-order drag on the non-simplified lanes
    delomg = els.omgcof * t
    delmtemp = 1.0 + els.eta * torch.cos(xmdf)
    delm = els.xmcof * (delmtemp ** 3 - els.delmo)
    tempd = delomg + delm
    not_simp = ~els.isimp
    mm = torch.where(not_simp, xmdf + tempd, xmdf)
    argpm = torch.where(not_simp, argpdf - tempd, argpdf)
    t3 = t2 * t
    t4 = t3 * t
    tempa = tempa - els.d2 * t2 - els.d3 * t3 - els.d4 * t4
    tempe = tempe + torch.where(
        not_simp, els.bstar * els.cc5 * (torch.sin(mm) - els.sinmao), 0.0)
    templ = templ + els.t3cof * t3 + els.t4cof * t4 + t4 * t * els.t5cof
    return mm, argpm, nodem, tempa, tempe, templ


def sgp4_propagate(els: Sgp4Elements, tsince, grav: GravityModel):
    """Propagate near-earth satellites to ``tsince`` minutes from epoch,
    in f64 (JAX :436).

    ``tsince`` broadcasts against the ``(n_sats,)`` element tensors:
    ``(n_times, 1)`` or ``(n_times, n_sats)`` times give a dense grid.
    Returns ``(r, v, error)``: TEME km and km/s stacked ``(..., 3)``, and
    int32 python-sgp4 error codes."""
    t = torch.as_tensor(tsince, dtype=els.no_kozai.dtype,
                        device=els.no_kozai.device)
    mm, argpm, nodem, tempa, tempe, templ = update_secular(els, t)

    nm = els.no_unkozai
    em = els.ecco
    inclm = els.inclo
    error = els.error.to(torch.int32).expand(
        torch.broadcast_shapes(els.error.shape, t.shape))

    error = torch.where((nm <= 0.0) & (error == 0), 2, error)
    nm_safe = torch.where(nm > 0.0, nm, 1e-8)
    am = (grav.xke / nm_safe) ** X2O3 * tempa * tempa
    nm = grav.xke / torch.where(am > 0.0, am, 1.0) ** 1.5
    em = em - tempe

    error = torch.where(((em >= 1.0) | (em < -0.001)) & (error == 0), 1,
                        error)
    em = torch.clamp(em, 1.0e-6, 0.999999)
    mm = mm + els.no_unkozai * templ
    xlm = mm + argpm + nodem

    nodem = torch.remainder(nodem, TWO_PI)
    argpm = torch.remainder(argpm, TWO_PI)
    xlm = torch.remainder(xlm, TWO_PI)
    mm = torch.remainder(xlm - argpm - nodem, TWO_PI)

    return kepler_and_posvel(
        grav, am=am, nm=nm, ep=em, xincp=inclm, nodep=nodem, argpp=argpm,
        mp=mm, aycof=els.aycof, xlcof=els.xlcof, con41=els.con41,
        x1mth2=els.x1mth2, x7thm1=els.x7thm1, error=error)
