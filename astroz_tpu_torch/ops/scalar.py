"""Scalar SGP4/SDP4: the single-point host engine and an independent oracle.

Counterpart of ``astroz_tpu/ops/scalar.py``, kept line for line with it
(pure Python, no torch): the engine behind single-point
``api.Satrec.sgp4`` calls where the native copy (``native/``) is not in
use, and the initializer whose records the native engine packs. A
scalar propagation is latency-bound: one device launch and its copy
back cost more than this transcription's tens of microseconds.

A deliberately boring, straight-line scalar transcription of the
published Vallado algorithm ("Revisiting Spacetrack Report #3", AIAA
2006-6753, the algorithm python-sgp4 implements). It shares no code with
``astroz_tpu_torch.ops`` (no masks, no vectorization, no split
precision), so agreement between the two catches the faults a
vectorized rebuild can introduce: masking mistakes, the deep/shallow
partition, the resonance carry and fast-path precision loss.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Tuple

TWOPI = 2.0 * math.pi
DEG2RAD = math.pi / 180.0


@dataclass
class GravConsts:
    mu: float
    radiusearthkm: float
    xke: float
    tumin: float
    j2: float
    j3: float
    j4: float
    j3oj2: float


def wgs72() -> GravConsts:
    mu = 398600.8
    radiusearthkm = 6378.135
    xke = 60.0 / math.sqrt(radiusearthkm ** 3 / mu)
    return GravConsts(mu, radiusearthkm, xke, 1.0 / xke,
                      0.001082616, -0.00000253881, -0.00000165597,
                      -0.00000253881 / 0.001082616)


def wgs84() -> GravConsts:
    mu = 398600.5
    radiusearthkm = 6378.137
    xke = 60.0 / math.sqrt(radiusearthkm ** 3 / mu)
    return GravConsts(mu, radiusearthkm, xke, 1.0 / xke,
                      0.00108262998905, -0.00000253215306, -0.00000161098761,
                      -0.00000253215306 / 0.00108262998905)


def gstime(jdut1: float) -> float:
    tut1 = (jdut1 - 2451545.0) / 36525.0
    temp = (-6.2e-6 * tut1 ** 3 + 0.093104 * tut1 ** 2
            + (876600.0 * 3600 + 8640184.812866) * tut1 + 67310.54841)
    temp = math.fmod(temp * DEG2RAD / 240.0, TWOPI)
    if temp < 0.0:
        temp += TWOPI
    return temp


@dataclass
class Sat:
    """Scalar satellite record — field soup, exactly like the C code."""
    # inputs
    whichconst: GravConsts = None
    epoch_jd: float = 0.0   # full JD of epoch
    bstar: float = 0.0
    ecco: float = 0.0
    argpo: float = 0.0
    inclo: float = 0.0
    mo: float = 0.0
    no_kozai: float = 0.0
    nodeo: float = 0.0
    # state
    error: int = 0
    method: str = "n"
    operationmode: str = "i"
    isimp: int = 0
    extra: dict = field(default_factory=dict)

    def __getattr__(self, name):
        try:
            return self.__dict__["extra"][name]
        except KeyError:
            raise AttributeError(name) from None

    def set(self, **kw):
        self.extra.update(kw)


def _dpper(sat: Sat, inclo: float, init: bool, ep, inclp, nodep, argpp, mp,
           t: float):
    """Lunar-solar periodics (Vallado dpper)."""
    zns, zes = 1.19459e-5, 0.01675
    znl, zel = 1.5835218e-4, 0.05490

    zm = sat.zmos + zns * t
    if init:
        zm = sat.zmos
    zf = zm + 2.0 * zes * math.sin(zm)
    sinzf = math.sin(zf)
    f2 = 0.5 * sinzf * sinzf - 0.25
    f3 = -0.5 * sinzf * math.cos(zf)
    ses = sat.se2 * f2 + sat.se3 * f3
    sis = sat.si2 * f2 + sat.si3 * f3
    sls = sat.sl2 * f2 + sat.sl3 * f3 + sat.sl4 * sinzf
    sghs = sat.sgh2 * f2 + sat.sgh3 * f3 + sat.sgh4 * sinzf
    shs = sat.sh2 * f2 + sat.sh3 * f3
    zm = sat.zmol + znl * t
    if init:
        zm = sat.zmol
    zf = zm + 2.0 * zel * math.sin(zm)
    sinzf = math.sin(zf)
    f2 = 0.5 * sinzf * sinzf - 0.25
    f3 = -0.5 * sinzf * math.cos(zf)
    sel = sat.ee2 * f2 + sat.e3 * f3
    sil = sat.xi2 * f2 + sat.xi3 * f3
    sll = sat.xl2 * f2 + sat.xl3 * f3 + sat.xl4 * sinzf
    sghl = sat.xgh2 * f2 + sat.xgh3 * f3 + sat.xgh4 * sinzf
    shll = sat.xh2 * f2 + sat.xh3 * f3
    pe = ses + sel
    pinc = sis + sil
    pl = sls + sll
    pgh = sghs + sghl
    ph = shs + shll

    if not init:
        pe -= sat.peo
        pinc -= sat.pinco
        pl -= sat.plo
        pgh -= sat.pgho
        ph -= sat.pho
        inclp += pinc
        ep += pe
        sinip = math.sin(inclp)
        cosip = math.cos(inclp)
        if inclp >= 0.2:
            ph /= sinip
            pgh -= cosip * ph
            argpp += pgh
            nodep += ph
            mp += pl
        else:
            # Lyddane modification
            sinop = math.sin(nodep)
            cosop = math.cos(nodep)
            alfdp = sinip * sinop
            betdp = sinip * cosop
            dalf = ph * cosop + pinc * cosip * sinop
            dbet = -ph * sinop + pinc * cosip * cosop
            alfdp += dalf
            betdp += dbet
            nodep = math.fmod(nodep, TWOPI)
            if nodep < 0.0 and sat.operationmode == "a":
                nodep += TWOPI
            xls = mp + argpp + cosip * nodep
            dls = pl + pgh - pinc * nodep * sinip
            xls += dls
            xnoh = nodep
            nodep = math.atan2(alfdp, betdp)
            if nodep < 0.0 and sat.operationmode == "a":
                nodep += TWOPI
            if abs(xnoh - nodep) > math.pi:
                if nodep < xnoh:
                    nodep += TWOPI
                else:
                    nodep -= TWOPI
            mp += pl
            argpp = xls - mp - cosip * nodep
    return ep, inclp, nodep, argpp, mp


def _dscom(sat: Sat, epoch: float, ep, argpp, tc, inclp, nodep, np_):
    """Deep-space common terms (Vallado dscom). epoch = JD - 2433281.5."""
    zes, zel = 0.01675, 0.05490
    c1ss, c1l = 2.9864797e-6, 4.7968065e-7
    zsinis, zcosis = 0.39785416, 0.91744867
    zcosgs, zsings = 0.1945905, -0.98088458

    nm = np_
    em = ep
    snodm = math.sin(nodep)
    cnodm = math.cos(nodep)
    sinomm = math.sin(argpp)
    cosomm = math.cos(argpp)
    sinim = math.sin(inclp)
    cosim = math.cos(inclp)
    emsq = em * em
    betasq = 1.0 - emsq
    rtemsq = math.sqrt(betasq)

    day = epoch + 18261.5 + tc / 1440.0
    xnodce = math.fmod(4.5236020 - 9.2422029e-4 * day, TWOPI)
    stem = math.sin(xnodce)
    ctem = math.cos(xnodce)
    zcosil = 0.91375164 - 0.03568096 * ctem
    zsinil = math.sqrt(1.0 - zcosil * zcosil)
    zsinhl = 0.089683511 * stem / zsinil
    zcoshl = math.sqrt(1.0 - zsinhl * zsinhl)
    gam = 5.8351514 + 0.0019443680 * day
    zx = 0.39785416 * stem / zsinil
    zy = zcoshl * ctem + 0.91744867 * zsinhl * stem
    zx = math.atan2(zx, zy)
    zx = gam + zx - xnodce
    zcosgl = math.cos(zx)
    zsingl = math.sin(zx)

    # second pass through the loop does the lunar terms
    zcosg, zsing, zcosi, zsini = zcosgs, zsings, zcosis, zsinis
    zcosh, zsinh = cnodm, snodm
    cc = c1ss
    xnoi = 1.0 / nm

    out = {}
    for lsflg in (1, 2):
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

        if lsflg == 1:
            out.update(ss1=s1, ss2=s2, ss3=s3, ss4=s4, ss5=s5, ss6=s6,
                       ss7=s7, sz1=z1, sz2=z2, sz3=z3, sz11=z11, sz12=z12,
                       sz13=z13, sz21=z21, sz22=z22, sz23=z23, sz31=z31,
                       sz32=z32, sz33=z33)
            zcosg, zsing = zcosgl, zsingl
            zcosi, zsini = zcosil, zsinil
            zcosh = zcoshl * cnodm + zsinhl * snodm
            zsinh = snodm * zcoshl - cnodm * zsinhl
            cc = c1l

    out.update(s1=s1, s2=s2, s3=s3, s4=s4, s5=s5, s6=s6, s7=s7,
               z1=z1, z2=z2, z3=z3, z11=z11, z12=z12, z13=z13,
               z21=z21, z22=z22, z23=z23, z31=z31, z32=z32, z33=z33)

    zmos = math.fmod(6.2565837 + 0.017201977 * day, TWOPI)
    zmol = math.fmod(4.7199672 + 0.22997150 * day - gam, TWOPI)
    out.update(zmos=zmos, zmol=zmol)

    out.update(
        se2=2.0 * out["ss1"] * out["ss6"],
        se3=2.0 * out["ss1"] * out["ss7"],
        si2=2.0 * out["ss2"] * out["sz12"],
        si3=2.0 * out["ss2"] * (out["sz13"] - out["sz11"]),
        sl2=-2.0 * out["ss3"] * out["sz2"],
        sl3=-2.0 * out["ss3"] * (out["sz3"] - out["sz1"]),
        sl4=-2.0 * out["ss3"] * (-21.0 - 9.0 * emsq) * zes,
        sgh2=2.0 * out["ss4"] * out["sz32"],
        sgh3=2.0 * out["ss4"] * (out["sz33"] - out["sz31"]),
        sgh4=-18.0 * out["ss4"] * zes,
        sh2=-2.0 * out["ss2"] * out["sz22"],
        sh3=-2.0 * out["ss2"] * (out["sz23"] - out["sz21"]),
        ee2=2.0 * s1 * s6,
        e3=2.0 * s1 * s7,
        xi2=2.0 * s2 * z12,
        xi3=2.0 * s2 * (z13 - z11),
        xl2=-2.0 * s3 * z2,
        xl3=-2.0 * s3 * (z3 - z1),
        xl4=-2.0 * s3 * (-21.0 - 9.0 * emsq) * zel,
        xgh2=2.0 * s4 * z32,
        xgh3=2.0 * s4 * (z33 - z31),
        xgh4=-18.0 * s4 * zel,
        xh2=-2.0 * s2 * z22,
        xh3=-2.0 * s2 * (z23 - z21),
        sinim=sinim, cosim=cosim, emsq=emsq, em=em, nm=nm,
        snodm=snodm, cnodm=cnodm, sinomm=sinomm, cosomm=cosomm,
        rtemsq=rtemsq, gam=gam, day=day)
    sat.set(**{k: v for k, v in out.items()})
    return out


def _dsinit(sat: Sat, tc: float, xpidot: float, d: dict, eccsq: float):
    """Deep-space secular rates + resonance init (Vallado dsinit)."""
    q22, q31, q33 = 1.7891679e-6, 2.1460748e-6, 2.2123015e-7
    root22, root44, root54 = 1.7891679e-6, 7.3636953e-9, 2.1765803e-9
    rptim = 4.37526908801129966e-3
    root32, root52 = 3.7393792e-7, 1.1428639e-7
    znl, zns = 1.5835218e-4, 1.19459e-5

    nm = sat.no_unkozai
    em = sat.ecco
    inclm = sat.inclo
    emsq = d["emsq"]
    sinim, cosim = d["sinim"], d["cosim"]

    irez = 0
    if 0.0034906585 < nm < 0.0052359877:
        irez = 1
    if 8.26e-3 <= nm <= 9.24e-3 and em >= 0.5:
        irez = 2

    ses = sat.ss1 * zns * sat.ss5
    sis = sat.ss2 * zns * (sat.sz11 + sat.sz13)
    sls = -zns * sat.ss3 * (sat.sz1 + sat.sz3 - 14.0 - 6.0 * emsq)
    sghs = sat.ss4 * zns * (sat.sz31 + sat.sz33 - 6.0)
    shs = -zns * sat.ss2 * (sat.sz21 + sat.sz23)
    if inclm < 5.2359877e-2 or inclm > math.pi - 5.2359877e-2:
        shs = 0.0
    if sinim != 0.0:
        shs /= sinim
    sgs = sghs - cosim * shs

    dedt = ses + sat.s1 * znl * sat.s5
    didt = sis + sat.s2 * znl * (sat.z11 + sat.z13)
    dmdt = sls - znl * sat.s3 * (sat.z1 + sat.z3 - 14.0 - 6.0 * emsq)
    sghl = sat.s4 * znl * (sat.z31 + sat.z33 - 6.0)
    shll = -znl * sat.s2 * (sat.z21 + sat.z23)
    if inclm < 5.2359877e-2 or inclm > math.pi - 5.2359877e-2:
        shll = 0.0
    domdt = sgs + sghl
    dnodt = shs
    if sinim != 0.0:
        domdt -= cosim / sinim * shll
        dnodt += shll / sinim

    theta = math.fmod(sat.gsto + tc * rptim, TWOPI)
    sat.set(irez=irez, dedt=dedt, didt=didt, dmdt=dmdt, domdt=domdt,
            dnodt=dnodt, del1=0.0, del2=0.0, del3=0.0,
            d2201=0.0, d2211=0.0, d3210=0.0, d3222=0.0, d4410=0.0,
            d4422=0.0, d5220=0.0, d5232=0.0, d5421=0.0, d5433=0.0,
            xlamo=0.0, xfact=0.0, xli=0.0, xni=0.0, atime=0.0)

    if irez != 0:
        aonv = (nm / sat.whichconst.xke) ** (2.0 / 3.0)
        if irez == 2:
            cosisq = cosim * cosim
            emo = em
            em = sat.ecco
            emsqo = emsq
            emsq = eccsq
            eoc = em * emsq
            g201 = -0.306 - (em - 0.64) * 0.440
            if em <= 0.65:
                g211 = 3.616 - 13.2470 * em + 16.2900 * emsq
                g310 = (-19.302 + 117.3900 * em - 228.4190 * emsq
                        + 156.5910 * eoc)
                g322 = (-18.9068 + 109.7927 * em - 214.6334 * emsq
                        + 146.5816 * eoc)
                g410 = (-41.122 + 242.6940 * em - 471.0940 * emsq
                        + 313.9530 * eoc)
                g422 = (-146.407 + 841.8800 * em - 1629.014 * emsq
                        + 1083.4350 * eoc)
                g520 = (-532.114 + 3017.977 * em - 5740.032 * emsq
                        + 3708.2760 * eoc)
            else:
                g211 = (-72.099 + 331.819 * em - 508.738 * emsq
                        + 266.724 * eoc)
                g310 = (-346.844 + 1582.851 * em - 2415.925 * emsq
                        + 1246.113 * eoc)
                g322 = (-342.585 + 1554.908 * em - 2366.899 * emsq
                        + 1215.972 * eoc)
                g410 = (-1052.797 + 4758.686 * em - 7193.992 * emsq
                        + 3651.957 * eoc)
                g422 = (-3581.690 + 16178.110 * em - 24462.770 * emsq
                        + 12422.520 * eoc)
                if em > 0.715:
                    g520 = (-5149.66 + 29936.92 * em - 54087.36 * emsq
                            + 31324.56 * eoc)
                else:
                    g520 = 1464.74 - 4664.75 * em + 3763.64 * emsq
            if em < 0.7:
                g533 = (-919.22770 + 4988.6100 * em - 9064.7700 * emsq
                        + 5542.21 * eoc)
                g521 = (-822.71072 + 4568.6173 * em - 8491.4146 * emsq
                        + 5337.524 * eoc)
                g532 = (-853.66600 + 4690.2500 * em - 8624.7700 * emsq
                        + 5341.4 * eoc)
            else:
                g533 = (-37995.780 + 161616.52 * em - 229838.20 * emsq
                        + 109377.94 * eoc)
                g521 = (-51752.104 + 218913.95 * em - 309468.16 * emsq
                        + 146349.42 * eoc)
                g532 = (-40023.880 + 170470.89 * em - 242699.48 * emsq
                        + 115605.82 * eoc)
            sini2 = sinim * sinim
            f220 = 0.75 * (1.0 + 2.0 * cosim + cosisq)
            f221 = 1.5 * sini2
            f321 = 1.875 * sinim * (1.0 - 2.0 * cosim - 3.0 * cosisq)
            f322 = -1.875 * sinim * (1.0 + 2.0 * cosim - 3.0 * cosisq)
            f441 = 35.0 * sini2 * f220
            f442 = 39.3750 * sini2 * sini2
            f522 = 9.84375 * sinim * (sini2 * (1.0 - 2.0 * cosim
                                               - 5.0 * cosisq)
                                      + 0.33333333 * (-2.0 + 4.0 * cosim
                                                      + 6.0 * cosisq))
            f523 = sinim * (4.92187512 * sini2 * (-2.0 - 4.0 * cosim
                                                  + 10.0 * cosisq)
                            + 6.56250012 * (1.0 + 2.0 * cosim
                                            - 3.0 * cosisq))
            f542 = 29.53125 * sinim * (2.0 - 8.0 * cosim
                                       + cosisq * (-12.0 + 8.0 * cosim
                                                   + 10.0 * cosisq))
            f543 = 29.53125 * sinim * (-2.0 - 8.0 * cosim
                                       + cosisq * (12.0 + 8.0 * cosim
                                                   - 10.0 * cosisq))
            xno2 = nm * nm
            ainv2 = aonv * aonv
            temp1 = 3.0 * xno2 * ainv2
            temp = temp1 * root22
            d2201 = temp * f220 * g201
            d2211 = temp * f221 * g211
            temp1 *= aonv
            temp = temp1 * root32
            d3210 = temp * f321 * g310
            d3222 = temp * f322 * g322
            temp1 *= aonv
            temp = 2.0 * temp1 * root44
            d4410 = temp * f441 * g410
            d4422 = temp * f442 * g422
            temp1 *= aonv
            temp = temp1 * root52
            d5220 = temp * f522 * g520
            d5232 = temp * f523 * g532
            temp = 2.0 * temp1 * root54
            d5421 = temp * f542 * g521
            d5433 = temp * f543 * g533
            xlamo = math.fmod(sat.mo + sat.nodeo + sat.nodeo
                              - theta - theta, TWOPI)
            xfact = (sat.mdot + sat.dmdt
                     + 2.0 * (sat.nodedot + sat.dnodt - rptim)
                     - sat.no_unkozai)
            em = emo
            emsq = emsqo
            sat.set(d2201=d2201, d2211=d2211, d3210=d3210, d3222=d3222,
                    d4410=d4410, d4422=d4422, d5220=d5220, d5232=d5232,
                    d5421=d5421, d5433=d5433, xlamo=xlamo, xfact=xfact)
        if irez == 1:
            g200 = 1.0 + emsq * (-2.5 + 0.8125 * emsq)
            g310 = 1.0 + 2.0 * emsq
            g300 = 1.0 + emsq * (-6.0 + 6.60937 * emsq)
            f220 = 0.75 * (1.0 + cosim) * (1.0 + cosim)
            f311 = (0.9375 * sinim * sinim * (1.0 + 3.0 * cosim)
                    - 0.75 * (1.0 + cosim))
            f330 = 1.0 + cosim
            f330 = 1.875 * f330 * f330 * f330
            del1 = 3.0 * nm * nm * aonv * aonv
            del2 = 2.0 * del1 * f220 * g200 * q22
            del3 = 3.0 * del1 * f330 * g300 * q33 * aonv
            del1 = del1 * f311 * g310 * q31 * aonv
            xlamo = math.fmod(sat.mo + sat.nodeo + sat.argpo - theta,
                              TWOPI)
            xfact = (sat.mdot + xpidot - rptim + sat.dmdt + sat.domdt
                     + sat.dnodt - sat.no_unkozai)
            sat.set(del1=del1, del2=del2, del3=del3, xlamo=xlamo,
                    xfact=xfact)
        sat.set(xli=sat.xlamo, xni=sat.no_unkozai, atime=0.0)


def _dspace(sat: Sat, t: float, atime: float, xli: float, xni: float,
            em, argpm, inclm, nodem, mm):
    """Resonance integration + deep secular (Vallado dspace). Returns
    (atime, xli, xni, em, argpm, inclm, nodem, mm, nm, dndt)."""
    fasx2, fasx4, fasx6 = 0.13130908, 2.8843198, 0.37448087
    g22, g32 = 5.7686396, 0.95240898
    g44, g52, g54 = 1.8014998, 1.0508330, 4.4108898
    rptim = 4.37526908801129966e-3
    stepp, stepn, step2 = 720.0, -720.0, 259200.0

    dndt = 0.0
    theta = math.fmod(sat.gsto + t * rptim, TWOPI)
    em += sat.dedt * t
    inclm += sat.didt * t
    argpm += sat.domdt * t
    nodem += sat.dnodt * t
    mm += sat.dmdt * t

    nm = sat.no_unkozai
    if sat.irez != 0:
        if (atime == 0.0 or t * atime <= 0.0 or abs(t) < abs(atime)):
            atime = 0.0
            xni = sat.no_unkozai
            xli = sat.xlamo
        delt = stepp if t > 0.0 else stepn

        iretn = 381
        while iretn == 381:
            if sat.irez != 2:
                xndt = (sat.del1 * math.sin(xli - fasx2)
                        + sat.del2 * math.sin(2.0 * (xli - fasx4))
                        + sat.del3 * math.sin(3.0 * (xli - fasx6)))
                xldot = xni + sat.xfact
                xnddt = (sat.del1 * math.cos(xli - fasx2)
                         + 2.0 * sat.del2 * math.cos(2.0 * (xli - fasx4))
                         + 3.0 * sat.del3 * math.cos(3.0 * (xli - fasx6)))
                xnddt *= xldot
            else:
                xomi = sat.argpo + sat.argpdot * atime
                x2omi = xomi + xomi
                x2li = xli + xli
                xndt = (sat.d2201 * math.sin(x2omi + xli - g22)
                        + sat.d2211 * math.sin(xli - g22)
                        + sat.d3210 * math.sin(xomi + xli - g32)
                        + sat.d3222 * math.sin(-xomi + xli - g32)
                        + sat.d4410 * math.sin(x2omi + x2li - g44)
                        + sat.d4422 * math.sin(x2li - g44)
                        + sat.d5220 * math.sin(xomi + xli - g52)
                        + sat.d5232 * math.sin(-xomi + xli - g52)
                        + sat.d5421 * math.sin(xomi + x2li - g54)
                        + sat.d5433 * math.sin(-xomi + x2li - g54))
                xldot = xni + sat.xfact
                xnddt = (sat.d2201 * math.cos(x2omi + xli - g22)
                         + sat.d2211 * math.cos(xli - g22)
                         + sat.d3210 * math.cos(xomi + xli - g32)
                         + sat.d3222 * math.cos(-xomi + xli - g32)
                         + sat.d5220 * math.cos(xomi + xli - g52)
                         + sat.d5232 * math.cos(-xomi + xli - g52)
                         + 2.0 * (sat.d4410 * math.cos(x2omi + x2li - g44)
                                  + sat.d4422 * math.cos(x2li - g44)
                                  + sat.d5421 * math.cos(xomi + x2li - g54)
                                  + sat.d5433 * math.cos(-xomi + x2li
                                                         - g54)))
                xnddt *= xldot

            if abs(t - atime) >= stepp:
                iretn = 381
            else:
                ft = t - atime
                iretn = 0
            if iretn == 381:
                xli += xldot * delt + xndt * step2
                xni += xndt * delt + xnddt * step2
                atime += delt

        nm = xni + xndt * ft + xnddt * ft * ft * 0.5
        xl = xli + xldot * ft + xndt * ft * ft * 0.5
        if sat.irez != 1:
            mm = xl - 2.0 * nodem + 2.0 * theta
            dndt = nm - sat.no_unkozai
        else:
            mm = xl - nodem - argpm + theta
            dndt = nm - sat.no_unkozai
        nm = sat.no_unkozai + dndt

    return atime, xli, xni, em, argpm, inclm, nodem, mm, nm, dndt


def sgp4init(grav: GravConsts, epoch_jd: float, bstar: float, ecco: float,
             argpo: float, inclo: float, mo: float, no_kozai: float,
             nodeo: float) -> Sat:
    """Initialize a scalar satellite record (Vallado sgp4init)."""
    sat = Sat(whichconst=grav, epoch_jd=epoch_jd, bstar=bstar, ecco=ecco,
              argpo=argpo, inclo=inclo, mo=mo, no_kozai=no_kozai,
              nodeo=nodeo)
    x2o3 = 2.0 / 3.0
    temp4 = 1.5e-12
    epoch = epoch_jd - 2433281.5

    # ---- initl ----
    eccsq = ecco * ecco
    omeosq = 1.0 - eccsq
    rteosq = math.sqrt(omeosq)
    cosio = math.cos(inclo)
    cosio2 = cosio * cosio
    ak = (grav.xke / no_kozai) ** x2o3
    d1 = 0.75 * grav.j2 * (3.0 * cosio2 - 1.0) / (rteosq * omeosq)
    del_ = d1 / (ak * ak)
    adel = ak * (1.0 - del_ * del_
                 - del_ * (1.0 / 3.0 + 134.0 * del_ * del_ / 81.0))
    del_ = d1 / (adel * adel)
    no_unkozai = no_kozai / (1.0 + del_)
    ao = (grav.xke / no_unkozai) ** x2o3
    sinio = math.sin(inclo)
    po = ao * omeosq
    con42 = 1.0 - 5.0 * cosio2
    con41 = -con42 - cosio2 - cosio2
    posq = po * po
    rp = ao * (1.0 - ecco)
    gsto = gstime(epoch_jd)

    sat.set(no_unkozai=no_unkozai, gsto=gsto, a=ao,
            alta=ao * (1.0 + ecco) - 1.0, altp=rp - 1.0)

    if omeosq >= 0.0 or no_unkozai >= 0.0:
        sat.isimp = 0
        if rp < 220.0 / grav.radiusearthkm + 1.0:
            sat.isimp = 1
        sfour = 78.0 / grav.radiusearthkm + 1.0
        qzms24 = ((120.0 - 78.0) / grav.radiusearthkm) ** 4
        perige = (rp - 1.0) * grav.radiusearthkm
        if perige < 156.0:
            sfour = perige - 78.0
            if perige < 98.0:
                sfour = 20.0
            qzms24 = ((120.0 - sfour) / grav.radiusearthkm) ** 4
            sfour = sfour / grav.radiusearthkm + 1.0
        pinvsq = 1.0 / posq

        tsi = 1.0 / (ao - sfour)
        eta = ao * ecco * tsi
        etasq = eta * eta
        eeta = ecco * eta
        psisq = abs(1.0 - etasq)
        coef = qzms24 * tsi ** 4
        coef1 = coef / psisq ** 3.5
        cc2 = coef1 * no_unkozai * (
            ao * (1.0 + 1.5 * etasq + eeta * (4.0 + etasq))
            + 0.375 * grav.j2 * tsi / psisq * con41
            * (8.0 + 3.0 * etasq * (8.0 + etasq)))
        cc1 = bstar * cc2
        cc3 = 0.0
        if ecco > 1.0e-4:
            cc3 = (-2.0 * coef * tsi * grav.j3oj2 * no_unkozai * sinio
                   / ecco)
        x1mth2 = 1.0 - cosio2
        cc4 = (2.0 * no_unkozai * coef1 * ao * omeosq
               * (eta * (2.0 + 0.5 * etasq)
                  + ecco * (0.5 + 2.0 * etasq)
                  - grav.j2 * tsi / (ao * psisq)
                  * (-3.0 * con41 * (1.0 - 2.0 * eeta
                                     + etasq * (1.5 - 0.5 * eeta))
                     + 0.75 * x1mth2
                     * (2.0 * etasq - eeta * (1.0 + etasq))
                     * math.cos(2.0 * argpo))))
        cc5 = (2.0 * coef1 * ao * omeosq
               * (1.0 + 2.75 * (etasq + eeta) + eeta * etasq))
        cosio4 = cosio2 * cosio2
        temp1 = 1.5 * grav.j2 * pinvsq * no_unkozai
        temp2 = 0.5 * temp1 * grav.j2 * pinvsq
        temp3 = -0.46875 * grav.j4 * pinvsq * pinvsq * no_unkozai
        mdot = (no_unkozai + 0.5 * temp1 * rteosq * con41
                + 0.0625 * temp2 * rteosq
                * (13.0 - 78.0 * cosio2 + 137.0 * cosio4))
        argpdot = (-0.5 * temp1 * con42
                   + 0.0625 * temp2
                   * (7.0 - 114.0 * cosio2 + 395.0 * cosio4)
                   + temp3 * (3.0 - 36.0 * cosio2 + 49.0 * cosio4))
        xhdot1 = -temp1 * cosio
        nodedot = (xhdot1 + (0.5 * temp2 * (4.0 - 19.0 * cosio2)
                             + 2.0 * temp3 * (3.0 - 7.0 * cosio2))
                   * cosio)
        xpidot = argpdot + nodedot
        omgcof = bstar * cc3 * math.cos(argpo)
        xmcof = 0.0
        if ecco > 1.0e-4:
            xmcof = -x2o3 * coef * bstar / eeta
        nodecf = 3.5 * omeosq * xhdot1 * cc1
        t2cof = 1.5 * cc1
        if abs(cosio + 1.0) > 1.5e-12:
            xlcof = (-0.25 * grav.j3oj2 * sinio * (3.0 + 5.0 * cosio)
                     / (1.0 + cosio))
        else:
            xlcof = (-0.25 * grav.j3oj2 * sinio * (3.0 + 5.0 * cosio)
                     / temp4)
        aycof = -0.5 * grav.j3oj2 * sinio
        delmotemp = 1.0 + eta * math.cos(mo)
        delmo = delmotemp ** 3
        sinmao = math.sin(mo)
        x7thm1 = 7.0 * cosio2 - 1.0

        sat.set(eta=eta, cc1=cc1, cc4=cc4, cc5=cc5, mdot=mdot,
                argpdot=argpdot, nodedot=nodedot, omgcof=omgcof,
                xmcof=xmcof, nodecf=nodecf, t2cof=t2cof, xlcof=xlcof,
                aycof=aycof, delmo=delmo, sinmao=sinmao, x7thm1=x7thm1,
                x1mth2=x1mth2, con41=con41, d2=0.0, d3=0.0, d4=0.0,
                t3cof=0.0, t4cof=0.0, t5cof=0.0,
                peo=0.0, pinco=0.0, plo=0.0, pgho=0.0, pho=0.0)

        if TWOPI / no_unkozai >= 225.0:
            sat.method = "d"
            sat.isimp = 1
            inclm = inclo
            d = _dscom(sat, epoch, ecco, argpo, 0.0, inclm, nodeo,
                       no_unkozai)
            _dpper(sat, inclo, True, ecco, inclo, nodeo, argpo, mo, 0.0)
            _dsinit(sat, 0.0, xpidot, d, eccsq)

        if sat.isimp != 1:
            cc1sq = cc1 * cc1
            d2 = 4.0 * ao * tsi * cc1sq
            temp = d2 * tsi * cc1 / 3.0
            d3 = (17.0 * ao + sfour) * temp
            d4 = 0.5 * temp * ao * tsi * (221.0 * ao + 31.0 * sfour) * cc1
            t3cof = d2 + 2.0 * cc1sq
            t4cof = 0.25 * (3.0 * d3 + cc1 * (12.0 * d2 + 10.0 * cc1sq))
            t5cof = 0.2 * (3.0 * d4 + 12.0 * cc1 * d3 + 6.0 * d2 * d2
                           + 15.0 * cc1sq * (2.0 * d2 + cc1sq))
            sat.set(d2=d2, d3=d3, d4=d4, t3cof=t3cof, t4cof=t4cof,
                    t5cof=t5cof)

    if sat.ecco >= 1.0 or sat.ecco < 0.0:
        sat.error = 1
    return sat


def sgp4(sat: Sat, tsince: float
         ) -> Tuple[int, Tuple[float, float, float],
                    Tuple[float, float, float]]:
    """Propagate (Vallado sgp4): tsince in minutes since epoch.
    Returns (error, r_km, v_km_s)."""
    grav = sat.whichconst
    x2o3 = 2.0 / 3.0
    temp4 = 1.5e-12
    vkmpersec = grav.radiusearthkm * grav.xke / 60.0
    sat.error = 0
    t = tsince

    xmdf = sat.mo + sat.mdot * t
    argpdf = sat.argpo + sat.argpdot * t
    nodedf = sat.nodeo + sat.nodedot * t
    argpm = argpdf
    mm = xmdf
    t2 = t * t
    nodem = nodedf + sat.nodecf * t2
    tempa = 1.0 - sat.cc1 * t
    tempe = sat.bstar * sat.cc4 * t
    templ = sat.t2cof * t2

    if sat.isimp != 1:
        delomg = sat.omgcof * t
        delmtemp = 1.0 + sat.eta * math.cos(xmdf)
        delm = sat.xmcof * (delmtemp ** 3 - sat.delmo)
        temp = delomg + delm
        mm = xmdf + temp
        argpm = argpdf - temp
        t3 = t2 * t
        t4 = t3 * t
        tempa = tempa - sat.d2 * t2 - sat.d3 * t3 - sat.d4 * t4
        tempe = tempe + sat.bstar * sat.cc5 * (math.sin(mm) - sat.sinmao)
        templ = templ + sat.t3cof * t3 + t4 * (sat.t4cof + t * sat.t5cof)

    nm = sat.no_unkozai
    em = sat.ecco
    inclm = sat.inclo
    if sat.method == "d":
        (atime, xli, xni, em, argpm, inclm, nodem, mm, nm, _dn) = _dspace(
            sat, t, 0.0, sat.xlamo, sat.no_unkozai, em, argpm, inclm,
            nodem, mm)

    if nm <= 0.0:
        sat.error = 2
        return 2, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)
    am = (grav.xke / nm) ** x2o3 * tempa * tempa
    nm = grav.xke / am ** 1.5
    em -= tempe
    if em >= 1.0 or em < -0.001:
        sat.error = 1
        return 1, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)
    if em < 1.0e-6:
        em = 1.0e-6
    mm += sat.no_unkozai * templ
    xlm = mm + argpm + nodem

    nodem = math.fmod(nodem, TWOPI)
    argpm = math.fmod(argpm, TWOPI)
    xlm = math.fmod(xlm, TWOPI)
    mm = math.fmod(xlm - argpm - nodem, TWOPI)

    ep = em
    xincp = inclm
    argpp = argpm
    nodep = nodem
    mp = mm
    sinip = math.sin(xincp)
    cosip = math.cos(xincp)
    aycof = sat.aycof
    xlcof = sat.xlcof
    con41 = sat.con41
    x1mth2 = sat.x1mth2
    x7thm1 = sat.x7thm1
    if sat.method == "d":
        ep, xincp, nodep, argpp, mp = _dpper(sat, sat.inclo, False, ep,
                                             xincp, nodep, argpp, mp, t)
        if xincp < 0.0:
            xincp = -xincp
            nodep += math.pi
            argpp -= math.pi
        if ep < 0.0 or ep > 1.0:
            sat.error = 3
            return 3, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)
        sinip = math.sin(xincp)
        cosip = math.cos(xincp)
        aycof = -0.5 * grav.j3oj2 * sinip
        if abs(cosip + 1.0) > 1.5e-12:
            xlcof = (-0.25 * grav.j3oj2 * sinip * (3.0 + 5.0 * cosip)
                     / (1.0 + cosip))
        else:
            xlcof = (-0.25 * grav.j3oj2 * sinip * (3.0 + 5.0 * cosip)
                     / temp4)

    axnl = ep * math.cos(argpp)
    temp = 1.0 / (am * (1.0 - ep * ep))
    aynl = ep * math.sin(argpp) + temp * aycof
    xl = mp + argpp + nodep + temp * xlcof * axnl

    u = math.fmod(xl - nodep, TWOPI)
    eo1 = u
    tem5 = 9999.9
    ktr = 1
    sineo1 = coseo1 = 0.0
    while abs(tem5) >= 1.0e-12 and ktr <= 10:
        sineo1 = math.sin(eo1)
        coseo1 = math.cos(eo1)
        tem5 = 1.0 - coseo1 * axnl - sineo1 * aynl
        tem5 = (u - aynl * coseo1 + axnl * sineo1 - eo1) / tem5
        if abs(tem5) >= 0.95:
            tem5 = 0.95 if tem5 > 0.0 else -0.95
        eo1 += tem5
        ktr += 1

    ecose = axnl * coseo1 + aynl * sineo1
    esine = axnl * sineo1 - aynl * coseo1
    el2 = axnl * axnl + aynl * aynl
    pl = am * (1.0 - el2)
    if pl < 0.0:
        sat.error = 4
        return 4, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)

    rl = am * (1.0 - ecose)
    rdotl = math.sqrt(am) * esine / rl
    rvdotl = math.sqrt(pl) / rl
    betal = math.sqrt(1.0 - el2)
    temp = esine / (1.0 + betal)
    sinu = am / rl * (sineo1 - aynl - axnl * temp)
    cosu = am / rl * (coseo1 - axnl + aynl * temp)
    su = math.atan2(sinu, cosu)
    sin2u = (cosu + cosu) * sinu
    cos2u = 1.0 - 2.0 * sinu * sinu
    temp = 1.0 / pl
    temp1 = 0.5 * grav.j2 * temp
    temp2 = temp1 * temp

    if sat.method == "d":
        cosisq = cosip * cosip
        con41 = 3.0 * cosisq - 1.0
        x1mth2 = 1.0 - cosisq
        x7thm1 = 7.0 * cosisq - 1.0

    mrt = (rl * (1.0 - 1.5 * temp2 * betal * con41)
           + 0.5 * temp1 * x1mth2 * cos2u)
    su -= 0.25 * temp2 * x7thm1 * sin2u
    xnode = nodep + 1.5 * temp2 * cosip * sin2u
    xinc = xincp + 1.5 * temp2 * cosip * sinip * cos2u
    mvt = rdotl - nm * temp1 * x1mth2 * sin2u / grav.xke
    rvdot = (rvdotl + nm * temp1 * (x1mth2 * cos2u + 1.5 * con41)
             / grav.xke)

    sinsu = math.sin(su)
    cossu = math.cos(su)
    snod = math.sin(xnode)
    cnod = math.cos(xnode)
    sini = math.sin(xinc)
    cosi = math.cos(xinc)
    xmx = -snod * cosi
    xmy = cnod * cosi
    ux = xmx * sinsu + cnod * cossu
    uy = xmy * sinsu + snod * cossu
    uz = sini * sinsu
    vx = xmx * cossu - cnod * sinsu
    vy = xmy * cossu - snod * sinsu
    vz = sini * cossu

    r = (mrt * ux * grav.radiusearthkm,
         mrt * uy * grav.radiusearthkm,
         mrt * uz * grav.radiusearthkm)
    v = ((mvt * ux + rvdot * vx) * vkmpersec,
         (mvt * uy + rvdot * vy) * vkmpersec,
         (mvt * uz + rvdot * vz) * vkmpersec)

    if mrt < 1.0:
        sat.error = 6
        return 6, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)
    return 0, r, v
