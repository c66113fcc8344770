"""SDP4 deep-space init (host, f64 numpy) and the f64 deep-space
propagator (torch, on the catalog's device).

Counterpart of ``astroz_tpu/ops/sdp4.py``: the constants (:39-75),
:class:`DeepElements` (:77), ``_dscom`` (:162), ``_sdp4_init_core``
(:297) and ``sdp4_init_np`` (:511) run in numpy once per catalog, with
the same operations in the same order as the JAX package's numpy branch,
so every field agrees bit for bit. The rest is the published f64
algorithm (Vallado, "Revisiting Spacetrack Report #3", AIAA 2006-6753)
in plain torch: :func:`dpper` (:524) and :func:`sdp4_finish` (:777), the
tail shared with the fast path's f64 accuracy escape
(``ops/fast.py:sdp4_propagate_tables``); the 720-minute resonance
integrator :func:`dspace` (:651) with its :class:`ResonanceCarry`
(:140); and the unified propagators :func:`sdp4_propagate` (:722) and
:func:`sdp4_propagate_scan` (:841).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..constants import GravityModel, TWO_PI
from .sgp4 import (X2O3, _TEMP4, Sgp4Elements, kepler_and_posvel,
                   update_secular)

PI = math.pi

# deep-space constants (Vallado AIAA 2006-6753)
ZES = 0.01675
ZEL = 0.05490
ZNS = 1.19459e-5
ZNL = 1.5835218e-4
C1SS = 2.9864797e-6
C1L = 4.7968065e-7
ZSINIS = 0.39785416
ZCOSIS = 0.91744867
ZCOSGS = 0.1945905
ZSINGS = -0.98088458

# dsinit resonance constants
Q22 = 1.7891679e-6
Q31 = 2.1460748e-6
Q33 = 2.2123015e-7
ROOT22 = 1.7891679e-6
ROOT32 = 3.7393792e-7
ROOT44 = 7.3636953e-9
ROOT52 = 1.1428639e-7
ROOT54 = 2.1765803e-9
RPTIM = 4.37526908801129966e-3  # earth rotation rate, rad/min

# dspace integrator constants
FASX2 = 0.13130908
FASX4 = 2.8843198
FASX6 = 0.37448087
G22 = 5.7686396
G32 = 0.95240898
G44 = 1.8014998
G52 = 1.0508330
G54 = 4.4108898
STEPP = 720.0
STEP2 = 259200.0


class DeepElements(NamedTuple):
    """Per-satellite deep-space coefficients, each of shape ``(n_sats,)``
    (zeros on near-earth lanes): f64 numpy arrays after init (``irez``
    int32), or tensors once a catalog has moved them to its device."""

    irez: object  # 0 none, 1 geosynchronous, 2 half-day
    # lunisolar epoch phase angles
    zmol: object
    zmos: object
    # solar periodic coefficients
    se2: object
    se3: object
    si2: object
    si3: object
    sl2: object
    sl3: object
    sl4: object
    sgh2: object
    sgh3: object
    sgh4: object
    sh2: object
    sh3: object
    # lunar periodic coefficients
    ee2: object
    e3: object
    xi2: object
    xi3: object
    xl2: object
    xl3: object
    xl4: object
    xgh2: object
    xgh3: object
    xgh4: object
    xh2: object
    xh3: object
    # secular rates
    dedt: object
    didt: object
    dmdt: object
    dnodt: object
    domdt: object
    # geosynchronous resonance
    del1: object
    del2: object
    del3: object
    # half-day resonance
    d2201: object
    d2211: object
    d3210: object
    d3222: object
    d4410: object
    d4422: object
    d5220: object
    d5232: object
    d5421: object
    d5433: object
    # resonance integrator seeds
    xfact: object
    xlamo: object


class ResonanceCarry(NamedTuple):
    """Resumable state of the 720-minute resonance integrator: the time
    of the last step and the integrated mean longitude and motion."""

    atime: torch.Tensor
    xli: torch.Tensor
    xni: torch.Tensor


def fresh_carry(deep: DeepElements, no_unkozai) -> ResonanceCarry:
    """The integrator's state at epoch (atime 0), over ``deep.xlamo``'s
    shape."""
    return ResonanceCarry(atime=torch.zeros_like(deep.xlamo),
                          xli=deep.xlamo,
                          xni=no_unkozai + torch.zeros_like(deep.xlamo))


def _dscom(epoch_jd, ep, argpp, tc, inclp, nodep, np_):
    """Solar and lunar common terms of dsinit and the periodic
    coefficients. ``epoch_jd`` is the full Julian date."""
    nm = np_
    em = ep
    snodm = np.sin(nodep)
    cnodm = np.cos(nodep)
    sinomm = np.sin(argpp)
    cosomm = np.cos(argpp)
    sinim = np.sin(inclp)
    cosim = np.cos(inclp)
    emsq = em * em
    betasq = 1.0 - emsq
    rtemsq = np.sqrt(betasq)

    day = epoch_jd - 2415020.0 + tc / 1440.0
    xnodce = np.fmod(4.5236020 - 9.2422029e-4 * day, TWO_PI)
    stem = np.sin(xnodce)
    ctem = np.cos(xnodce)
    zcosil = 0.91375164 - 0.03568096 * ctem
    zsinil = np.sqrt(1.0 - zcosil * zcosil)
    zsinhl = 0.089683511 * stem / zsinil
    zcoshl = np.sqrt(1.0 - zsinhl * zsinhl)
    gam = 5.8351514 + 0.0019443680 * day
    zx = 0.39785416 * stem / zsinil
    zy = zcoshl * ctem + 0.91744867 * zsinhl * stem
    zx = np.arctan2(zx, zy)
    zx = gam + zx - xnodce
    zcosgl = np.cos(zx)
    zsingl = np.sin(zx)

    def pass_terms(zcosg, zsing, zcosi, zsini, zcosh, zsinh, cc):
        xnoi = 1.0 / nm
        a1 = zcosg * zcosh + zsing * zcosi * zsinh
        a3 = -zsing * zcosh + zcosg * zcosi * zsinh
        a7 = -zcosg * zsinh + zsing * zcosi * zcosh
        a8 = zsing * zsini
        a9 = zsing * zsinh + zcosg * zcosi * zcosh
        a10 = zcosg * zsini
        a2 = cosim * a7 + sinim * a8
        a4 = cosim * a9 + sinim * a10
        a5 = -sinim * a7 + cosim * a8
        a6 = -sinim * a9 + cosim * a10

        x1 = a1 * cosomm + a2 * sinomm
        x2 = a3 * cosomm + a4 * sinomm
        x3 = -a1 * sinomm + a2 * cosomm
        x4 = -a3 * sinomm + a4 * cosomm
        x5 = a5 * sinomm
        x6 = a6 * sinomm
        x7 = a5 * cosomm
        x8 = a6 * cosomm

        z31 = 12.0 * x1 * x1 - 3.0 * x3 * x3
        z32 = 24.0 * x1 * x2 - 6.0 * x3 * x4
        z33 = 12.0 * x2 * x2 - 3.0 * x4 * x4
        z1 = 3.0 * (a1 * a1 + a2 * a2) + z31 * emsq
        z2 = 6.0 * (a1 * a3 + a2 * a4) + z32 * emsq
        z3 = 3.0 * (a3 * a3 + a4 * a4) + z33 * emsq
        z11 = -6.0 * a1 * a5 + emsq * (-24.0 * x1 * x7 - 6.0 * x3 * x5)
        z12 = (-6.0 * (a1 * a6 + a3 * a5)
               + emsq * (-24.0 * (x2 * x7 + x1 * x8)
                         - 6.0 * (x3 * x6 + x4 * x5)))
        z13 = -6.0 * a3 * a6 + emsq * (-24.0 * x2 * x8 - 6.0 * x4 * x6)
        z21 = 6.0 * a2 * a5 + emsq * (24.0 * x1 * x5 - 6.0 * x3 * x7)
        z22 = (6.0 * (a4 * a5 + a2 * a6)
               + emsq * (24.0 * (x2 * x5 + x1 * x6)
                         - 6.0 * (x4 * x7 + x3 * x8)))
        z23 = 6.0 * a4 * a6 + emsq * (24.0 * x2 * x6 - 6.0 * x4 * x8)
        z1 = z1 + z1 + betasq * z31
        z2 = z2 + z2 + betasq * z32
        z3 = z3 + z3 + betasq * z33
        s3 = cc * xnoi
        s2 = -0.5 * s3 / rtemsq
        s4 = s3 * rtemsq
        s1 = -15.0 * em * s4
        s5 = x1 * x3 + x2 * x4
        s6 = x2 * x3 + x1 * x4
        s7 = x2 * x4 - x1 * x3
        return dict(s1=s1, s2=s2, s3=s3, s4=s4, s5=s5, s6=s6, s7=s7,
                    z1=z1, z2=z2, z3=z3, z11=z11, z12=z12, z13=z13,
                    z21=z21, z22=z22, z23=z23, z31=z31, z32=z32, z33=z33)

    # solar pass, then lunar pass
    sol = pass_terms(ZCOSGS, ZSINGS, ZCOSIS, ZSINIS, cnodm, snodm, C1SS)
    lun = pass_terms(zcosgl, zsingl, zcosil, zsinil,
                     zcoshl * cnodm + zsinhl * snodm,
                     snodm * zcoshl - cnodm * zsinhl, C1L)

    zmol = np.fmod(4.7199672 + 0.22997150 * day - gam, TWO_PI)
    zmos = np.fmod(6.2565837 + 0.017201977 * day, TWO_PI)

    out = dict(
        sinim=sinim, cosim=cosim, emsq=emsq, zmol=zmol, zmos=zmos,
        se2=2.0 * sol["s1"] * sol["s6"],
        se3=2.0 * sol["s1"] * sol["s7"],
        si2=2.0 * sol["s2"] * sol["z12"],
        si3=2.0 * sol["s2"] * (sol["z13"] - sol["z11"]),
        sl2=-2.0 * sol["s3"] * sol["z2"],
        sl3=-2.0 * sol["s3"] * (sol["z3"] - sol["z1"]),
        sl4=-2.0 * sol["s3"] * (-21.0 - 9.0 * emsq) * ZES,
        sgh2=2.0 * sol["s4"] * sol["z32"],
        sgh3=2.0 * sol["s4"] * (sol["z33"] - sol["z31"]),
        sgh4=-18.0 * sol["s4"] * ZES,
        sh2=-2.0 * sol["s2"] * sol["z22"],
        sh3=-2.0 * sol["s2"] * (sol["z23"] - sol["z21"]),
        ee2=2.0 * lun["s1"] * lun["s6"],
        e3=2.0 * lun["s1"] * lun["s7"],
        xi2=2.0 * lun["s2"] * lun["z12"],
        xi3=2.0 * lun["s2"] * (lun["z13"] - lun["z11"]),
        xl2=-2.0 * lun["s3"] * lun["z2"],
        xl3=-2.0 * lun["s3"] * (lun["z3"] - lun["z1"]),
        xl4=-2.0 * lun["s3"] * (-21.0 - 9.0 * emsq) * ZEL,
        xgh2=2.0 * lun["s4"] * lun["z32"],
        xgh3=2.0 * lun["s4"] * (lun["z33"] - lun["z31"]),
        xgh4=-18.0 * lun["s4"] * ZEL,
        xh2=-2.0 * lun["s2"] * lun["z22"],
        xh3=-2.0 * lun["s2"] * (lun["z23"] - lun["z21"]),
    )
    out["sol"] = sol
    out["lun"] = lun
    return out


def _sdp4_init_core(grav: GravityModel, els: Sgp4Elements) -> DeepElements:
    """The dsinit body in numpy: secular rates, resonance classification
    and coefficients, every branch a ``where`` mask."""
    ecco, inclo, nodeo, argpo, mo = (els.ecco, els.inclo, els.nodeo,
                                     els.argpo, els.mo)
    no = els.no_unkozai
    eccsq = ecco * ecco
    tc = np.zeros_like(no)

    d = _dscom(els.epoch_jd, ecco, argpo, tc, inclo, nodeo, no)
    sol, lun = d["sol"], d["lun"]
    sinim, cosim, emsq = d["sinim"], d["cosim"], d["emsq"]

    # ---- secular rates ---------------------------------------------------
    ses = sol["s1"] * ZNS * sol["s5"]
    sis = sol["s2"] * ZNS * (sol["z11"] + sol["z13"])
    sls = -ZNS * sol["s3"] * (sol["z1"] + sol["z3"] - 14.0 - 6.0 * emsq)
    sghs = sol["s4"] * ZNS * (sol["z31"] + sol["z33"] - 6.0)
    shs = -ZNS * sol["s2"] * (sol["z21"] + sol["z23"])
    near_eq = (inclo < 5.2359877e-2) | (inclo > PI - 5.2359877e-2)
    shs = np.where(near_eq, 0.0, shs)
    sin_ok = sinim != 0.0
    safe_sinim = np.where(sin_ok, sinim, 1.0)
    shs = np.where(sin_ok, shs / safe_sinim, shs)
    sgs = sghs - cosim * shs

    dedt = ses + lun["s1"] * ZNL * lun["s5"]
    didt = sis + lun["s2"] * ZNL * (lun["z11"] + lun["z13"])
    dmdt = sls - ZNL * lun["s3"] * (lun["z1"] + lun["z3"]
                                    - 14.0 - 6.0 * emsq)
    sghl = lun["s4"] * ZNL * (lun["z31"] + lun["z33"] - 6.0)
    shll = -ZNL * lun["s2"] * (lun["z21"] + lun["z23"])
    shll = np.where(near_eq, 0.0, shll)
    domdt = sgs + sghl
    dnodt = shs
    domdt = np.where(sin_ok, domdt - cosim / safe_sinim * shll, domdt)
    dnodt = np.where(sin_ok, dnodt + shll / safe_sinim, dnodt)

    # ---- resonance classification ----------------------------------------
    nm = no
    irez = np.zeros(np.shape(nm), np.int32)
    irez = np.where((nm < 0.0052359877) & (nm > 0.0034906585),
                    np.int32(1), irez)
    irez = np.where((nm >= 8.26e-3) & (nm <= 9.24e-3) & (ecco >= 0.5),
                    np.int32(2), irez)

    theta = np.fmod(els.gsto, TWO_PI)
    aonv = (nm / grav.xke) ** X2O3

    # ---- half-day resonance (irez == 2): G-functions and D-terms ---------
    em = ecco
    emsq_r = eccsq
    eoc = em * emsq_r
    g201 = -0.306 - (em - 0.64) * 0.440

    lo = em <= 0.65
    g211 = np.where(lo, 3.616 - 13.2470 * em + 16.2900 * emsq_r,
                    -72.099 + 331.819 * em - 508.738 * emsq_r
                    + 266.724 * eoc)
    g310 = np.where(lo, -19.302 + 117.3900 * em - 228.4190 * emsq_r
                    + 156.5910 * eoc,
                    -346.844 + 1582.851 * em - 2415.925 * emsq_r
                    + 1246.113 * eoc)
    g322 = np.where(lo, -18.9068 + 109.7927 * em - 214.6334 * emsq_r
                    + 146.5816 * eoc,
                    -342.585 + 1554.908 * em - 2366.899 * emsq_r
                    + 1215.972 * eoc)
    g410 = np.where(lo, -41.122 + 242.6940 * em - 471.0940 * emsq_r
                    + 313.9530 * eoc,
                    -1052.797 + 4758.686 * em - 7193.992 * emsq_r
                    + 3651.957 * eoc)
    g422 = np.where(lo, -146.407 + 841.8800 * em - 1629.014 * emsq_r
                    + 1083.4350 * eoc,
                    -3581.690 + 16178.110 * em - 24462.770 * emsq_r
                    + 12422.520 * eoc)
    g520 = np.where(
        lo,
        -532.114 + 3017.977 * em - 5740.032 * emsq_r + 3708.2760 * eoc,
        np.where(em > 0.715,
                 -5149.66 + 29936.92 * em - 54087.36 * emsq_r
                 + 31324.56 * eoc,
                 1464.74 - 4664.75 * em + 3763.64 * emsq_r))
    lo7 = em < 0.7
    g533 = np.where(lo7, -919.22770 + 4988.6100 * em
                    - 9064.7700 * emsq_r + 5542.21 * eoc,
                    -37995.780 + 161616.52 * em - 229838.20 * emsq_r
                    + 109377.94 * eoc)
    g521 = np.where(lo7, -822.71072 + 4568.6173 * em
                    - 8491.4146 * emsq_r + 5337.524 * eoc,
                    -51752.104 + 218913.95 * em - 309468.16 * emsq_r
                    + 146349.42 * eoc)
    g532 = np.where(lo7, -853.66600 + 4690.2500 * em
                    - 8624.7700 * emsq_r + 5341.4 * eoc,
                    -40023.880 + 170470.89 * em - 242699.48 * emsq_r
                    + 115605.82 * eoc)

    cosisq = cosim * cosim
    sini2 = sinim * sinim
    f220 = 0.75 * (1.0 + 2.0 * cosim + cosisq)
    f221 = 1.5 * sini2
    f321 = 1.875 * sinim * (1.0 - 2.0 * cosim - 3.0 * cosisq)
    f322 = -1.875 * sinim * (1.0 + 2.0 * cosim - 3.0 * cosisq)
    f441 = 35.0 * sini2 * f220
    f442 = 39.3750 * sini2 * sini2
    f522 = 9.84375 * sinim * (sini2 * (1.0 - 2.0 * cosim - 5.0 * cosisq)
                              + 0.33333333 * (-2.0 + 4.0 * cosim
                                              + 6.0 * cosisq))
    f523 = sinim * (4.92187512 * sini2 * (-2.0 - 4.0 * cosim
                                          + 10.0 * cosisq)
                    + 6.56250012 * (1.0 + 2.0 * cosim - 3.0 * cosisq))
    f542 = 29.53125 * sinim * (2.0 - 8.0 * cosim
                               + cosisq * (-12.0 + 8.0 * cosim
                                           + 10.0 * cosisq))
    f543 = 29.53125 * sinim * (-2.0 - 8.0 * cosim
                               + cosisq * (12.0 + 8.0 * cosim
                                           - 10.0 * cosisq))
    xno2 = nm * nm
    ainv2 = aonv * aonv
    temp1 = 3.0 * xno2 * ainv2
    temp = temp1 * ROOT22
    d2201 = temp * f220 * g201
    d2211 = temp * f221 * g211
    temp1 = temp1 * aonv
    temp = temp1 * ROOT32
    d3210 = temp * f321 * g310
    d3222 = temp * f322 * g322
    temp1 = temp1 * aonv
    temp = 2.0 * temp1 * ROOT44
    d4410 = temp * f441 * g410
    d4422 = temp * f442 * g422
    temp1 = temp1 * aonv
    temp = temp1 * ROOT52
    d5220 = temp * f522 * g520
    d5232 = temp * f523 * g532
    temp = 2.0 * temp1 * ROOT54
    d5421 = temp * f542 * g521
    d5433 = temp * f543 * g533
    xlamo2 = np.fmod(mo + nodeo + nodeo - theta - theta, TWO_PI)
    xfact2 = (els.mdot + dmdt
              + 2.0 * (els.nodedot + dnodt - RPTIM) - no)

    # ---- geosynchronous resonance (irez == 1) ----------------------------
    g200 = 1.0 + emsq * (-2.5 + 0.8125 * emsq)
    g310g = 1.0 + 2.0 * emsq
    g300 = 1.0 + emsq * (-6.0 + 6.60937 * emsq)
    f220g = 0.75 * (1.0 + cosim) * (1.0 + cosim)
    f311 = (0.9375 * sinim * sinim * (1.0 + 3.0 * cosim)
            - 0.75 * (1.0 + cosim))
    f330 = 1.0 + cosim
    f330 = 1.875 * f330 * f330 * f330
    del1 = 3.0 * nm * nm * aonv * aonv
    del2 = 2.0 * del1 * f220g * g200 * Q22
    del3 = 3.0 * del1 * f330 * g300 * Q33 * aonv
    del1 = del1 * f311 * g310g * Q31 * aonv
    xlamo1 = np.fmod(mo + nodeo + argpo - theta, TWO_PI)
    xpidot = els.argpdot + els.nodedot
    xfact1 = (els.mdot + xpidot - RPTIM + dmdt + domdt + dnodt - no)

    is1 = irez == 1
    is2 = irez == 2
    xlamo = np.where(is1, xlamo1, np.where(is2, xlamo2, 0.0))
    xfact = np.where(is1, xfact1, np.where(is2, xfact2, 0.0))

    def mask2(x):
        return np.where(is2, x, 0.0)

    def mask1(x):
        return np.where(is1, x, 0.0)

    # zero every coefficient on near-earth lanes
    deep_mask = els.is_deep

    def md(x):
        return np.where(deep_mask, x, 0.0)

    return DeepElements(
        irez=np.where(deep_mask, irez, np.int32(0)),
        zmol=d["zmol"], zmos=d["zmos"],
        se2=md(d["se2"]), se3=md(d["se3"]), si2=md(d["si2"]),
        si3=md(d["si3"]), sl2=md(d["sl2"]), sl3=md(d["sl3"]),
        sl4=md(d["sl4"]), sgh2=md(d["sgh2"]), sgh3=md(d["sgh3"]),
        sgh4=md(d["sgh4"]), sh2=md(d["sh2"]), sh3=md(d["sh3"]),
        ee2=md(d["ee2"]), e3=md(d["e3"]), xi2=md(d["xi2"]),
        xi3=md(d["xi3"]), xl2=md(d["xl2"]), xl3=md(d["xl3"]),
        xl4=md(d["xl4"]), xgh2=md(d["xgh2"]), xgh3=md(d["xgh3"]),
        xgh4=md(d["xgh4"]), xh2=md(d["xh2"]), xh3=md(d["xh3"]),
        dedt=md(dedt), didt=md(didt), dmdt=md(dmdt), dnodt=md(dnodt),
        domdt=md(domdt),
        del1=md(mask1(del1)), del2=md(mask1(del2)), del3=md(mask1(del3)),
        d2201=md(mask2(d2201)), d2211=md(mask2(d2211)),
        d3210=md(mask2(d3210)), d3222=md(mask2(d3222)),
        d4410=md(mask2(d4410)), d4422=md(mask2(d4422)),
        d5220=md(mask2(d5220)), d5232=md(mask2(d5232)),
        d5421=md(mask2(d5421)), d5433=md(mask2(d5433)),
        xfact=md(xfact), xlamo=md(xlamo),
    )


def sdp4_init_np(grav: GravityModel, els: Sgp4Elements) -> DeepElements:
    """Deep-space init of a whole catalog on the host: dscom/dsinit for
    every lane, every coefficient zeroed where ``~els.is_deep``.
    ``els`` holds numpy arrays (from :func:`~.sgp4.sgp4_init_np`)."""
    return _sdp4_init_core(grav, els)


def dpper(deep: DeepElements, t, ep, inclp, nodep, argpp, mp, apply_mask):
    """Lunisolar periodics at ``t`` minutes, f64, with the Lyddane
    low-inclination path chosen per point; where ``apply_mask`` is False
    the inputs pass through."""
    # solar periodics
    zm = deep.zmos + ZNS * t
    zf = zm + 2.0 * ZES * torch.sin(zm)
    sinzf = torch.sin(zf)
    f2 = 0.5 * sinzf * sinzf - 0.25
    f3 = -0.5 * sinzf * torch.cos(zf)
    ses = deep.se2 * f2 + deep.se3 * f3
    sis = deep.si2 * f2 + deep.si3 * f3
    sls = deep.sl2 * f2 + deep.sl3 * f3 + deep.sl4 * sinzf
    sghs = deep.sgh2 * f2 + deep.sgh3 * f3 + deep.sgh4 * sinzf
    shs = deep.sh2 * f2 + deep.sh3 * f3
    # lunar periodics
    zm = deep.zmol + ZNL * t
    zf = zm + 2.0 * ZEL * torch.sin(zm)
    sinzf = torch.sin(zf)
    f2 = 0.5 * sinzf * sinzf - 0.25
    f3 = -0.5 * sinzf * torch.cos(zf)
    sel = deep.ee2 * f2 + deep.e3 * f3
    sil = deep.xi2 * f2 + deep.xi3 * f3
    sll = deep.xl2 * f2 + deep.xl3 * f3 + deep.xl4 * sinzf
    sghl = deep.xgh2 * f2 + deep.xgh3 * f3 + deep.xgh4 * sinzf
    shll = deep.xh2 * f2 + deep.xh3 * f3

    pe = ses + sel
    pinc = sis + sil
    pl = sls + sll
    pgh = sghs + sghl
    ph = shs + shll

    inclp_new = inclp + pinc
    ep_new = ep + pe
    sinip = torch.sin(inclp_new)
    cosip = torch.cos(inclp_new)

    # ---- normal path (inclination >= 0.2 rad) ----------------------------
    sin_safe = torch.where(torch.abs(sinip) > 1e-12, sinip, 1e-12)
    ph_n = ph / sin_safe
    pgh_n = pgh - cosip * ph_n
    argpp_n = argpp + pgh_n
    nodep_n = nodep + ph_n
    mp_n = mp + pl

    # ---- Lyddane path (inclination < 0.2 rad) ----------------------------
    sinop = torch.sin(nodep)
    cosop = torch.cos(nodep)
    alfdp = sinip * sinop + ph * cosop + pinc * cosip * sinop
    betdp = sinip * cosop - ph * sinop + pinc * cosip * cosop
    nodep_w = torch.fmod(nodep, TWO_PI)
    xls = mp + argpp + cosip * nodep_w + pl + pgh - pinc * nodep_w * sinip
    xnoh = nodep_w
    nodep_l = torch.atan2(alfdp, betdp)
    # node continuity fix
    far = torch.abs(xnoh - nodep_l) > PI
    nodep_l = torch.where(far & (nodep_l < xnoh), nodep_l + TWO_PI,
                          torch.where(far & (nodep_l >= xnoh),
                                      nodep_l - TWO_PI, nodep_l))
    mp_l = mp + pl
    argpp_l = xls - mp_l - cosip * nodep_l

    lyddane = inclp_new < 0.2
    argpp_new = torch.where(lyddane, argpp_l, argpp_n)
    nodep_new = torch.where(lyddane, nodep_l, nodep_n)
    mp_new = torch.where(lyddane, mp_l, mp_n)

    return (torch.where(apply_mask, ep_new, ep),
            torch.where(apply_mask, inclp_new, inclp),
            torch.where(apply_mask, nodep_new, nodep),
            torch.where(apply_mask, argpp_new, argpp),
            torch.where(apply_mask, mp_new, mp))


def sdp4_finish(els: Sgp4Elements, deep: DeepElements, grav: GravityModel,
                t, em, argpm, inclm, mm, nodem, nm, tempa, tempe, templ,
                error, is_deep):
    """The f64 tail after the secular and resonance update: drag-updated
    elements -> dpper -> per-point inclination coefficients ->
    Kepler / position-velocity. Returns ``(r, v, error)`` with r and v
    stacked ``(..., 3)``."""
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

    nodem = torch.fmod(nodem, TWO_PI)
    argpm = torch.fmod(argpm, TWO_PI)
    xlm = torch.fmod(xlm, TWO_PI)
    mm = torch.fmod(xlm - argpm - nodem, TWO_PI)

    # ---- lunisolar periodics (deep lanes only) ---------------------------
    ep, xincp, nodep, argpp, mp = dpper(
        deep, t, em, inclm, nodem, argpm, mm, apply_mask=is_deep)
    neg_inc = xincp < 0.0
    nodep = torch.where(neg_inc, nodep + PI, nodep)
    argpp = torch.where(neg_inc, argpp - PI, argpp)
    xincp = torch.abs(xincp)
    error = torch.where(((ep < 0.0) | (ep > 1.0)) & (error == 0), 3, error)
    ep = torch.clamp(ep, 1e-12, 0.999999)

    # ---- per-point inclination-dependent coefficients (deep lanes) ------
    sinip = torch.sin(xincp)
    cosip = torch.cos(xincp)
    aycof_d = -0.5 * grav.j3oj2 * sinip
    near_180 = torch.abs(cosip + 1.0) > 1.5e-12
    xlcof_d = torch.where(
        near_180,
        -0.25 * grav.j3oj2 * sinip * (3.0 + 5.0 * cosip)
        / torch.where(near_180, 1.0 + cosip, 1.0),
        -0.25 * grav.j3oj2 * sinip * (3.0 + 5.0 * cosip) / _TEMP4)
    cosisq = cosip * cosip
    con41_d = 3.0 * cosisq - 1.0
    x1mth2_d = 1.0 - cosisq
    x7thm1_d = 7.0 * cosisq - 1.0

    aycof = torch.where(is_deep, aycof_d, els.aycof)
    xlcof = torch.where(is_deep, xlcof_d, els.xlcof)
    con41 = torch.where(is_deep, con41_d, els.con41)
    x1mth2 = torch.where(is_deep, x1mth2_d, els.x1mth2)
    x7thm1 = torch.where(is_deep, x7thm1_d, els.x7thm1)

    return kepler_and_posvel(
        grav, am=am, nm=nm, ep=ep, xincp=xincp, nodep=nodep, argpp=argpp,
        mp=mp, aycof=aycof, xlcof=xlcof, con41=con41, x1mth2=x1mth2,
        x7thm1=x7thm1, error=error)


def _resonance_derivs(deep: DeepElements, els: Sgp4Elements, xli, xni,
                      atime):
    """xndt, xldot and xnddt * xldot at the integrator state: the
    geosynchronous 3-term and the half-day 10-term series, merged by
    irez."""
    xndt_1 = (deep.del1 * torch.sin(xli - FASX2)
              + deep.del2 * torch.sin(2.0 * (xli - FASX4))
              + deep.del3 * torch.sin(3.0 * (xli - FASX6)))
    xnddt_1 = (deep.del1 * torch.cos(xli - FASX2)
               + 2.0 * deep.del2 * torch.cos(2.0 * (xli - FASX4))
               + 3.0 * deep.del3 * torch.cos(3.0 * (xli - FASX6)))
    xomi = els.argpo + els.argpdot * atime
    x2omi = xomi + xomi
    x2li = xli + xli
    xndt_2 = (deep.d2201 * torch.sin(x2omi + xli - G22)
              + deep.d2211 * torch.sin(xli - G22)
              + deep.d3210 * torch.sin(xomi + xli - G32)
              + deep.d3222 * torch.sin(-xomi + xli - G32)
              + deep.d4410 * torch.sin(x2omi + x2li - G44)
              + deep.d4422 * torch.sin(x2li - G44)
              + deep.d5220 * torch.sin(xomi + xli - G52)
              + deep.d5232 * torch.sin(-xomi + xli - G52)
              + deep.d5421 * torch.sin(xomi + x2li - G54)
              + deep.d5433 * torch.sin(-xomi + x2li - G54))
    xnddt_2 = (deep.d2201 * torch.cos(x2omi + xli - G22)
               + deep.d2211 * torch.cos(xli - G22)
               + deep.d3210 * torch.cos(xomi + xli - G32)
               + deep.d3222 * torch.cos(-xomi + xli - G32)
               + deep.d5220 * torch.cos(xomi + xli - G52)
               + deep.d5232 * torch.cos(-xomi + xli - G52)
               + 2.0 * (deep.d4410 * torch.cos(x2omi + x2li - G44)
                        + deep.d4422 * torch.cos(x2li - G44)
                        + deep.d5421 * torch.cos(xomi + x2li - G54)
                        + deep.d5433 * torch.cos(-xomi + x2li - G54)))
    half_day = deep.irez == 2
    xndt = torch.where(half_day, xndt_2, xndt_1)
    xnddt = torch.where(half_day, xnddt_2, xnddt_1)
    xldot = xni + deep.xfact
    return xndt, xldot, xnddt * xldot


def integrate_resonance(deep: DeepElements, els: Sgp4Elements, t,
                        carry: ResonanceCarry, derivs=_resonance_derivs,
                        max_steps: Optional[int] = None):
    """The resonance Euler-Maclaurin integration to ``t`` minutes,
    resumed from ``carry``, with the accelerations ``derivs`` (this
    module's f64 series, or the fast path's).

    A lane restarts from epoch where its carry is at epoch, lies on the
    other side of epoch, or lies beyond ``t``; then every resonant lane
    steps 720 minutes toward ``t`` until it is less than a step away, a
    Python loop over ``active.any()`` (one host sync a step), or exactly
    ``max_steps`` masked steps. Returns ``(nm_res, xl, carry)``: the
    resonance mean motion and longitude at ``t`` (meaningful on resonant
    lanes) and the new carry."""
    resonant = deep.irez != 0
    atime, xli, xni = carry
    restart = ((atime == 0.0) | (t * atime <= 0.0)
               | (torch.abs(t) < torch.abs(atime)))
    atime = torch.where(restart, 0.0, atime)
    xli = torch.where(restart, deep.xlamo, xli)
    xni = torch.where(restart, els.no_unkozai, xni)

    delt = torch.where(t > 0.0, torch.full_like(t, STEPP),
                       torch.full_like(t, -STEPP))

    def active_at(atime_):
        return resonant & (torch.abs(t - atime_) >= STEPP)

    def step(atime_, xli_, xni_):
        xndt, xldot, xnddt = derivs(deep, els, xli_, xni_, atime_)
        act = active_at(atime_)
        return (torch.where(act, atime_ + delt, atime_),
                torch.where(act, xli_ + xldot * delt + xndt * STEP2, xli_),
                torch.where(act, xni_ + xndt * delt + xnddt * STEP2, xni_))

    if max_steps is None:
        while bool(active_at(atime).any()):
            atime, xli, xni = step(atime, xli, xni)
    else:
        for _ in range(max_steps):
            atime, xli, xni = step(atime, xli, xni)

    # the derivatives at the final state
    xndt, xldot, xnddt = derivs(deep, els, xli, xni, atime)
    ft = t - atime
    nm_res = xni + xndt * ft + xnddt * ft * ft * 0.5
    xl = xli + xldot * ft + xndt * ft * ft * 0.5
    return nm_res, xl, ResonanceCarry(atime, xli, xni)


def dspace(deep: DeepElements, els: Sgp4Elements, t, tc, em, argpm, inclm,
           mm, nodem, nm, carry: ResonanceCarry,
           max_steps: Optional[int] = None):
    """Deep-space secular update and the resonance integration to ``t``
    minutes, resumed from ``carry`` (:func:`integrate_resonance`).
    Returns the updated ``(em, argpm, inclm, mm, nodem, nm)`` and the new
    carry."""
    theta = torch.fmod(els.gsto + tc * RPTIM, TWO_PI)
    em = em + deep.dedt * t
    inclm = inclm + deep.didt * t
    argpm = argpm + deep.domdt * t
    nodem = nodem + deep.dnodt * t
    mm = mm + deep.dmdt * t

    resonant = deep.irez != 0
    nm_res, xl, carry = integrate_resonance(deep, els, t, carry,
                                            max_steps=max_steps)
    mm_geo = xl - nodem - argpm + theta
    mm_half = xl - 2.0 * nodem + 2.0 * theta
    mm = torch.where(resonant, torch.where(deep.irez == 1, mm_geo, mm_half),
                     mm)
    nm = torch.where(resonant, nm_res, nm)
    return em, argpm, inclm, mm, nodem, nm, carry


def sdp4_propagate(els: Sgp4Elements, deep: DeepElements, tsince,
                   grav: GravityModel,
                   carry: Optional[ResonanceCarry] = None,
                   max_steps: Optional[int] = None):
    """Propagate a mixed near-earth / deep-space catalog to ``tsince``
    minutes from epoch, in f64.

    Near-earth lanes see zeroed deep coefficients (exact no-ops) and
    their higher-order drag through the isimp mask; deep lanes get
    :func:`dspace` and :func:`dpper` and their inclination-dependent
    coefficients per point. ``tsince`` broadcasts as in
    :func:`~.sgp4.sgp4_propagate`. Returns ``(r, v, error, carry)``."""
    t = torch.as_tensor(tsince, dtype=els.no_kozai.dtype,
                        device=els.no_kozai.device)
    if carry is None:
        shape = torch.broadcast_shapes(t.shape, deep.xlamo.shape)
        carry = ResonanceCarry(
            atime=torch.zeros(shape, dtype=t.dtype, device=t.device),
            xli=deep.xlamo.expand(shape), xni=els.no_unkozai.expand(shape))

    mm, argpm, nodem, tempa, tempe, templ = update_secular(els, t)
    nm = els.no_unkozai + torch.zeros_like(mm)
    em = els.ecco + torch.zeros_like(mm)
    inclm = els.inclo + torch.zeros_like(mm)
    error = els.error.to(torch.int32).expand(
        torch.broadcast_shapes(els.error.shape, t.shape))

    em_d, argpm_d, inclm_d, mm_d, nodem_d, nm_d, carry = dspace(
        deep, els, t, t, em, argpm, inclm, mm, nodem, nm, carry,
        max_steps=max_steps)
    is_deep = els.is_deep
    em = torch.where(is_deep, em_d, em)
    argpm = torch.where(is_deep, argpm_d, argpm)
    inclm = torch.where(is_deep, inclm_d, inclm)
    mm = torch.where(is_deep, mm_d, mm)
    nodem = torch.where(is_deep, nodem_d, nodem)
    nm = torch.where(is_deep, nm_d, nm)

    r, v, error = sdp4_finish(els, deep, grav, t, em, argpm, inclm, mm,
                              nodem, nm, tempa, tempe, templ, error, is_deep)
    return r, v, error, carry


def sdp4_propagate_scan(els: Sgp4Elements, deep: DeepElements, times,
                        grav: GravityModel,
                        carry: Optional[ResonanceCarry] = None):
    """Propagate over a time axis sorted in one direction, one step of
    ``times[0]``, ``times[1]``, ... after the other, each resuming the
    resonance integration from the previous one's carry: O(n_times)
    resonance steps in all instead of O(n_times * t / 720). Returns
    ``(r, v, error)`` stacked along a leading ``n_times`` axis."""
    times = torch.as_tensor(times, dtype=els.no_kozai.dtype,
                            device=els.no_kozai.device)
    if carry is None:
        carry = fresh_carry(deep, els.no_unkozai)
    rs, vs, errs = [], [], []
    for t in times:
        r, v, err, carry = sdp4_propagate(els, deep, t, grav, carry=carry)
        rs.append(r)
        vs.append(v)
        errs.append(err)
    return torch.stack(rs), torch.stack(vs), torch.stack(errs)
