// Native scalar SGP4/SDP4 propagate — the single-point latency engine
// behind api.Satrec.sgp4 loops (reference: the compiled scalar loop
// path, README.md:84-86 at 2.5M props/s; src/Sgp4.zig:419-603 +
// src/Sdp4.zig:881-970).
//
// A C++ translation of this package's OWN scalar transcription of the
// published Vallado algorithm (astroz_tpu_torch/ops/scalar.py — AIAA
// 2006-6753): init stays in Python (one-time), the per-call hot path
// runs here on a pre-packed element vector. Parity with ops/scalar.py
// is exact-ULP-level and fuzz-tested in tests/test_torch_api.py.

#include <cmath>
#include <cstdint>
#include <cstring>

#include "scalar_fields.h"  // packed field-vector layout (enum F)

namespace {

constexpr double TWOPI = 6.283185307179586476925286766559;

// ---- fast trig (this box: glibc fmod 40-160 ns, sincos 37 ns; the
// hot path has ~5 fmods and ~8 sin/cos pairs, dominating the per-call
// cost). Cody-Waite 3-part constant reduction + fdlibm-grade minimax
// kernels (the classical public Sun coefficients) give ~1-2 ulp —
// orders of magnitude inside the 1e-9 km fuzz parity gate
// (tests/test_torch_api.py). Angle arguments here stay |x| < ~1e5 rad
// (tsince * mdot scale), so the quotient fits well inside the exact
// 33-bit-constant product range (k < 2^20). -------------------------

constexpr double INV_PIO2 = 6.36619772367581382433e-01;  // 2/pi
// pi/2 = P1 + P2 + P3 (P1, P2 carry 33 significant bits each)
constexpr double PIO2_1 = 1.57079632673412561417e+00;
constexpr double PIO2_2 = 6.07710050630396597660e-11;
constexpr double PIO2_3 = 2.02226624879595063154e-21;
// reduce_twopi must reduce by the DOUBLE constant TWOPI — not real
// 2*pi — to stay parity-equivalent with the oracle's fmod(x, TWOPI)
// (python-sgp4 semantics): the modulus difference delta ~ 4.4e-16
// grows as k*delta, i.e. ~1.3e-12 rad (5e-9 km) at 1-year horizons.
// Exact split: TP_HI (top 26 bits) + TP_LO == TWOPI bit-for-bit, so
// x - k*TP_HI - k*TP_LO reproduces fmod's remainder (verified
// bit-exact mod 2*pi over 1e5 random year-scale args).
constexpr double TP_HI = 6.283185243606567;
constexpr double TP_LO = 6.357301884918343e-08;
static_assert(TP_HI + TP_LO == TWOPI, "split must reproduce TWOPI");
constexpr double INV_TWOPI = 1.59154943091895335769e-01;  // 1/(2*pi)

constexpr double S1 = -1.66666666666666324348e-01;
constexpr double S2 = 8.33333333332248946124e-03;
constexpr double S3 = -1.98412698298579493134e-04;
constexpr double S4 = 2.75573137070700676789e-06;
constexpr double S5 = -2.50507602534068634195e-08;
constexpr double S6 = 1.58969099521155010221e-10;
constexpr double C1 = 4.16666666666666019037e-02;
constexpr double C2 = -1.38888888888741095749e-03;
constexpr double C3 = 2.48015872894767294178e-05;
constexpr double C4 = -2.75573143513906633035e-07;
constexpr double C5 = 2.08757232129817482790e-09;
constexpr double C6 = -1.13596475577881948265e-11;

// sin+cos in ~13 ns (vs 37 ns glibc sincos): quadrant reduction,
// shared z powers, branchless-ish quadrant swap.
// _nv ("no validation") variant: branch-free body for the vectorized
// lane loops — a libm fallback call inside an `omp simd` loop would
// block vectorization entirely, so the SIMD dispatcher instead gates
// whole arrays by horizon (see astroz_scalar_sgp4_array).
inline void fast_sincos_nv(double x, double* sx, double* cx) {
  const double kd = std::nearbyint(x * INV_PIO2);
  const long long k = (long long)kd;
  double r = x - kd * PIO2_1;
  r -= kd * PIO2_2;
  r -= kd * PIO2_3;
  const double z = r * r;
  const double ks =
      r + r * z * (S1 + z * (S2 + z * (S3 + z * (S4 + z * (S5 + z * S6)))));
  const double kc =
      1.0 - 0.5 * z +
      z * z * (C1 + z * (C2 + z * (C3 + z * (C4 + z * (C5 + z * C6)))));
  // branchless quadrant swap/negate (the quadrant is data-dependent
  // noise across calls — a switch would mispredict ~50% of the time,
  // ~15 cycles x 8 sincos per propagate): exact bit-level select and
  // sign-bit xor, no rounding introduced.
  uint64_t kb, cb;
  std::memcpy(&kb, &ks, 8);
  std::memcpy(&cb, &kc, 8);
  const uint64_t m = (uint64_t)0 - (uint64_t)(k & 1);  // all-ones if swap
  uint64_t sb = (kb & ~m) | (cb & m);
  uint64_t cbv = (cb & ~m) | (kb & m);
  sb ^= (uint64_t)(k & 2) << 62;        // sin negative in quadrants 2,3
  cbv ^= (uint64_t)((k + 1) & 2) << 62;  // cos negative in quadrants 1,2
  std::memcpy(sx, &sb, 8);
  std::memcpy(cx, &cbv, 8);
}

inline void fast_sincos(double x, double* sx, double* cx) {
  if (__builtin_expect(std::fabs(x) > 8.0e5, 0)) {
    // beyond k ~ 2^19 the 33-bit Cody-Waite products lose exactness;
    // decade-scale horizons (never hit by the library's own callers,
    // but reachable through user tsince) fall back to libm's exact
    // reduction
    ::sincos(x, sx, cx);
    return;
  }
  fast_sincos_nv(x, sx, cx);
}

inline double fast_sin(double x) {
  double s, c;
  fast_sincos(x, &s, &c);
  return s;
}

inline double fast_cos(double x) {
  double s, c;
  fast_sincos(x, &s, &c);
  return c;
}

// cbrt(x) for x > 0 in ~15 ns (vs 31 ns glibc): exponent/mantissa
// split, deg-2 guess of m^(-1/3) on [1,2) (max rel err 2.9e-3), three
// multiply-only Newton steps on t^(-3) = m (quadratic: 3e-16), one
// final divide-form polish on the full value (~0.5 ulp).
inline double fast_cbrt(double x) {
  uint64_t u;
  std::memcpy(&u, &x, 8);
  const int e = (int)(u >> 52) - 1023;
  const uint64_t mbits = (u & 0xFFFFFFFFFFFFFull) | 0x3FF0000000000000ull;
  double m;
  std::memcpy(&m, &mbits, 8);  // m in [1, 2)
  int q = e / 3, r = e - 3 * q;
  if (r < 0) { r += 3; q -= 1; }
  static const double corr[3] = {1.0, 1.2599210498948731648,
                                 1.5874010519681994748};  // 2^(r/3)
  double t = 1.38235576 + m * (-0.47730914 + m * 0.09201838);
  t = t * (4.0 - m * t * t * t) * (1.0 / 3.0);
  t = t * (4.0 - m * t * t * t) * (1.0 / 3.0);
  t = t * (4.0 - m * t * t * t) * (1.0 / 3.0);
  uint64_t pbits = (uint64_t)(q + 1023) << 52;  // exact 2^q
  double p2;
  std::memcpy(&p2, &pbits, 8);
  double y = m * t * t * corr[r] * p2;
  y -= (y * y * y - x) / (3.0 * y * y);
  return y;
}

// x mod 2*pi into [-pi, pi] (vs fmod's sign-of-x (-2pi, 2pi)): every
// consumer here is 2*pi-periodic (trig / Kepler's longitude), so the
// branch-cut difference is immaterial; the 3-part constant keeps the
// reduction exact-grade. ~6 ns vs 40-160 ns glibc fmod.
inline double reduce_twopi_nv(double x) {
  const double kd = std::nearbyint(x * INV_TWOPI);
  double r = x - kd * TP_HI;
  r -= kd * TP_LO;
  return r;
}

inline double reduce_twopi(double x) {
  if (__builtin_expect(std::fabs(x) > 8.0e5, 0)) {
    return std::fmod(x, TWOPI);  // see fast_sincos: exactness guard
  }
  return reduce_twopi_nv(x);
}

// dspace: resonance integration + deep secular (ops/scalar.py:511-596)
void dspace(const double* s, double t, double& em, double& argpm,
            double& inclm, double& nodem, double& mm, double& nm) {
  const double fasx2 = 0.13130908, fasx4 = 2.8843198, fasx6 = 0.37448087;
  const double g22 = 5.7686396, g32 = 0.95240898;
  const double g44 = 1.8014998, g52 = 1.0508330, g54 = 4.4108898;
  const double rptim = 4.37526908801129966e-3;
  const double stepp = 720.0, stepn = -720.0, step2 = 259200.0;

  const double theta = reduce_twopi(s[GSTO] + t * rptim);
  em += s[DEDT] * t;
  inclm += s[DIDT] * t;
  argpm += s[DOMDT] * t;
  nodem += s[DNODT] * t;
  mm += s[DMDT] * t;

  nm = s[NO_UNKOZAI];
  if (s[IREZ] != 0.0) {
    // fresh integration from epoch (atime = 0 restart semantics —
    // same as ops/scalar.py's stateless call with atime=0)
    double atime = 0.0;
    double xni = s[NO_UNKOZAI];
    double xli = s[XLAMO];
    const double delt = t > 0.0 ? stepp : stepn;

    double xndt = 0.0, xldot = 0.0, xnddt = 0.0, ft = 0.0;
    for (;;) {
      if (s[IREZ] != 2.0) {
        double s1_, c1_, s2_, c2_, s3_, c3_;
        fast_sincos(xli - fasx2, &s1_, &c1_);
        fast_sincos(2.0 * (xli - fasx4), &s2_, &c2_);
        fast_sincos(3.0 * (xli - fasx6), &s3_, &c3_);
        xndt = s[DEL1] * s1_ + s[DEL2] * s2_ + s[DEL3] * s3_;
        xldot = xni + s[XFACT];
        xnddt = s[DEL1] * c1_ + 2.0 * s[DEL2] * c2_ + 3.0 * s[DEL3] * c3_;
        xnddt *= xldot;
      } else {
        const double xomi = s[ARGPO] + s[ARGPDOT] * atime;
        const double x2omi = xomi + xomi;
        const double x2li = xli + xli;
        double sa, ca, sb, cb2, sc, cc, sd, cd, se, ce;
        double sf, cf, sg, cg, sh, ch, si_, ci, sj, cj;
        fast_sincos(x2omi + xli - g22, &sa, &ca);
        fast_sincos(xli - g22, &sb, &cb2);
        fast_sincos(xomi + xli - g32, &sc, &cc);
        fast_sincos(-xomi + xli - g32, &sd, &cd);
        fast_sincos(x2omi + x2li - g44, &se, &ce);
        fast_sincos(x2li - g44, &sf, &cf);
        fast_sincos(xomi + xli - g52, &sg, &cg);
        fast_sincos(-xomi + xli - g52, &sh, &ch);
        fast_sincos(xomi + x2li - g54, &si_, &ci);
        fast_sincos(-xomi + x2li - g54, &sj, &cj);
        xndt = s[D2201] * sa + s[D2211] * sb + s[D3210] * sc
             + s[D3222] * sd + s[D4410] * se + s[D4422] * sf
             + s[D5220] * sg + s[D5232] * sh + s[D5421] * si_
             + s[D5433] * sj;
        xldot = xni + s[XFACT];
        xnddt = s[D2201] * ca + s[D2211] * cb2 + s[D3210] * cc
              + s[D3222] * cd + s[D5220] * cg + s[D5232] * ch
              + 2.0 * (s[D4410] * ce + s[D4422] * cf
                       + s[D5421] * ci + s[D5433] * cj);
        xnddt *= xldot;
      }
      if (std::fabs(t - atime) >= stepp) {
        xli += xldot * delt + xndt * step2;
        xni += xndt * delt + xnddt * step2;
        atime += delt;
      } else {
        ft = t - atime;
        break;
      }
    }

    nm = xni + xndt * ft + xnddt * ft * ft * 0.5;
    const double xl = xli + xldot * ft + xndt * ft * ft * 0.5;
    double dndt;
    if (s[IREZ] != 1.0) {
      mm = xl - 2.0 * nodem + 2.0 * theta;
      dndt = nm - s[NO_UNKOZAI];
    } else {
      mm = xl - nodem - argpm + theta;
      dndt = nm - s[NO_UNKOZAI];
    }
    nm = s[NO_UNKOZAI] + dndt;
  }
}

// dpper: lunisolar periodics, non-init branch (ops/scalar.py:111-190)
void dpper(const double* s, double t, double& ep, double& inclp,
           double& nodep, double& argpp, double& mp) {
  const double zns = 1.19459e-5, zes = 0.01675;
  const double znl = 1.5835218e-4, zel = 0.05490;

  double zm = s[ZMOS] + zns * t;
  double zf = zm + 2.0 * zes * fast_sin(zm);
  double sinzf, coszf;
  fast_sincos(zf, &sinzf, &coszf);
  double f2 = 0.5 * sinzf * sinzf - 0.25;
  double f3 = -0.5 * sinzf * coszf;
  const double ses = s[SE2] * f2 + s[SE3] * f3;
  const double sis = s[SI2] * f2 + s[SI3] * f3;
  const double sls = s[SL2] * f2 + s[SL3] * f3 + s[SL4] * sinzf;
  const double sghs = s[SGH2] * f2 + s[SGH3] * f3 + s[SGH4] * sinzf;
  const double shs = s[SH2] * f2 + s[SH3] * f3;

  zm = s[ZMOL] + znl * t;
  zf = zm + 2.0 * zel * fast_sin(zm);
  fast_sincos(zf, &sinzf, &coszf);
  f2 = 0.5 * sinzf * sinzf - 0.25;
  f3 = -0.5 * sinzf * coszf;
  const double sel = s[EE2] * f2 + s[E3] * f3;
  const double sil = s[XI2] * f2 + s[XI3] * f3;
  const double sll = s[XL2] * f2 + s[XL3] * f3 + s[XL4] * sinzf;
  const double sghl = s[XGH2] * f2 + s[XGH3] * f3 + s[XGH4] * sinzf;
  const double shll = s[XH2] * f2 + s[XH3] * f3;

  double pe = ses + sel - s[PEO];
  double pinc = sis + sil - s[PINCO];
  double pl = sls + sll - s[PLO];
  double pgh = sghs + sghl - s[PGHO];
  double ph = shs + shll - s[PHO];

  inclp += pinc;
  ep += pe;
  double sinip, cosip;
  fast_sincos(inclp, &sinip, &cosip);
  if (inclp >= 0.2) {
    ph /= sinip;
    pgh -= cosip * ph;
    argpp += pgh;
    nodep += ph;
    mp += pl;
  } else {
    // Lyddane modification ('i' operation mode)
    double sinop, cosop;
    fast_sincos(nodep, &sinop, &cosop);
    double alfdp = sinip * sinop;
    double betdp = sinip * cosop;
    alfdp += ph * cosop + pinc * cosip * sinop;
    betdp += -ph * sinop + pinc * cosip * cosop;
    nodep = std::fmod(nodep, TWOPI);
    double xls = mp + argpp + cosip * nodep;
    xls += pl + pgh - pinc * nodep * sinip;
    const double xnoh = nodep;
    nodep = std::atan2(alfdp, betdp);
    if (std::fabs(xnoh - nodep) > M_PI) {
      if (nodep < xnoh)
        nodep += TWOPI;
      else
        nodep -= TWOPI;
    }
    mp += pl;
    argpp = xls - mp - cosip * nodep;
  }
}

}  // namespace

extern "C" {

// Propagate one satellite to tsince minutes past epoch. Writes
// out6 = [rx, ry, rz, vx, vy, vz] (km, km/s); returns the python-sgp4
// error code (0 = ok; errored output is zero-filled).
int astroz_scalar_sgp4(const double* s, double tsince, double* out6) {
  for (int i = 0; i < 6; ++i) out6[i] = 0.0;
  const double temp4 = 1.5e-12;
  const double vkmpersec = s[RADIUSEARTHKM] * s[XKE] / 60.0;
  const double inv_xke = 1.0 / s[XKE];
  const double t = tsince;

  const double xmdf = s[MO] + s[MDOT] * t;
  const double argpdf = s[ARGPO] + s[ARGPDOT] * t;
  const double nodedf = s[NODEO] + s[NODEDOT] * t;
  double argpm = argpdf;
  double mm = xmdf;
  const double t2 = t * t;
  double nodem = nodedf + s[NODECF] * t2;
  double tempa = 1.0 - s[CC1] * t;
  double tempe = s[BSTAR] * s[CC4] * t;
  double templ = s[T2COF] * t2;

  if (s[ISIMP] != 1.0) {
    const double delomg = s[OMGCOF] * t;
    const double delmtemp = 1.0 + s[ETA] * fast_cos(xmdf);
    const double delm =
        s[XMCOF] * (delmtemp * delmtemp * delmtemp - s[DELMO]);
    const double temp = delomg + delm;
    mm = xmdf + temp;
    argpm = argpdf - temp;
    const double t3 = t2 * t;
    const double t4 = t3 * t;
    tempa = tempa - s[D2] * t2 - s[D3] * t3 - s[D4] * t4;
    tempe = tempe + s[BSTAR] * s[CC5] * (fast_sin(mm) - s[SINMAO]);
    templ = templ + s[T3COF] * t3 + t4 * (s[T4COF] + t * s[T5COF]);
  }

  double nm = s[NO_UNKOZAI];
  double em = s[ECCO];
  double inclm = s[INCLO];
  if (s[DEEP] != 0.0)
    dspace(s, t, em, argpm, inclm, nodem, mm, nm);

  if (nm <= 0.0) return 2;
  // x^(2/3) = cbrt(x)^2 and x^1.5 = x*sqrt(x): each replaces a generic
  // ~100 ns pow call; differs from pow by <=2 ulp (parity gate 1e-9 km)
  const double cb = fast_cbrt(s[XKE] / nm);
  const double am = cb * cb * tempa * tempa;
  nm = s[XKE] / (am * std::sqrt(am));
  em -= tempe;
  if (em >= 1.0 || em < -0.001) return 1;
  if (em < 1.0e-6) em = 1.0e-6;
  mm += s[NO_UNKOZAI] * templ;
  double xlm = mm + argpm + nodem;

  // reduce_twopi's [-pi, pi] branch cut (vs fmod's sign-of-x) shifts
  // these by at most one 2*pi; for argpm/xlm/mm every downstream
  // consumer is 2*pi-periodic (trig, Kepler's longitude) or cancels
  // the shift (nodep in xl - nodep, Lyddane's xls - cosip*nodep
  // pair). nodem is the one exception: dpper's Lyddane branch
  // consumes nodep NON-periodically via the `- pinc * nodep * sinip`
  // term in xls (a 2*pi shift there moved GEO positions ~2 m), so
  // deep satellites keep fmod's exact branch cut.
  nodem = s[DEEP] != 0.0 ? std::fmod(nodem, TWOPI) : reduce_twopi(nodem);
  argpm = reduce_twopi(argpm);
  xlm = reduce_twopi(xlm);
  mm = reduce_twopi(xlm - argpm - nodem);

  double ep = em;
  double xincp = inclm;
  double argpp = argpm;
  double nodep = nodem;
  double mp = mm;
  double sinip, cosip;
  fast_sincos(xincp, &sinip, &cosip);
  double aycof = s[AYCOF];
  double xlcof = s[XLCOF];
  double con41 = s[CON41];
  double x1mth2 = s[X1MTH2];
  double x7thm1 = s[X7THM1];
  if (s[DEEP] != 0.0) {
    dpper(s, t, ep, xincp, nodep, argpp, mp);
    if (xincp < 0.0) {
      xincp = -xincp;
      nodep += M_PI;
      argpp -= M_PI;
    }
    if (ep < 0.0 || ep > 1.0) return 3;
    fast_sincos(xincp, &sinip, &cosip);
    aycof = -0.5 * s[J3OJ2] * sinip;
    if (std::fabs(cosip + 1.0) > 1.5e-12)
      xlcof = -0.25 * s[J3OJ2] * sinip * (3.0 + 5.0 * cosip)
              / (1.0 + cosip);
    else
      xlcof = -0.25 * s[J3OJ2] * sinip * (3.0 + 5.0 * cosip) / temp4;
  }

  double sargp, cargp;
  fast_sincos(argpp, &sargp, &cargp);
  const double axnl = ep * cargp;
  double temp = 1.0 / (am * (1.0 - ep * ep));
  const double aynl = ep * sargp + temp * aycof;
  const double xl = mp + argpp + nodep + temp * xlcof * axnl;

  const double u = reduce_twopi(xl - nodep);
  double eo1 = u;
  double tem5 = 9999.9;
  double sineo1 = 0.0, coseo1 = 0.0;
  for (int ktr = 1; std::fabs(tem5) >= 1.0e-12 && ktr <= 10; ++ktr) {
    fast_sincos(eo1, &sineo1, &coseo1);
    tem5 = 1.0 - coseo1 * axnl - sineo1 * aynl;
    tem5 = (u - aynl * coseo1 + axnl * sineo1 - eo1) / tem5;
    if (std::fabs(tem5) >= 0.95) tem5 = tem5 > 0.0 ? 0.95 : -0.95;
    eo1 += tem5;
  }

  const double ecose = axnl * coseo1 + aynl * sineo1;
  const double esine = axnl * sineo1 - aynl * coseo1;
  const double el2 = axnl * axnl + aynl * aynl;
  const double pl = am * (1.0 - el2);
  if (pl < 0.0) return 4;

  const double rl = am * (1.0 - ecose);
  const double rdotl = std::sqrt(am) * esine / rl;
  const double rvdotl = std::sqrt(pl) / rl;
  const double betal = std::sqrt(1.0 - el2);
  temp = esine / (1.0 + betal);
  const double sinu = am / rl * (sineo1 - aynl - axnl * temp);
  const double cosu = am / rl * (coseo1 - axnl + aynl * temp);
  const double sin2u = (cosu + cosu) * sinu;
  const double cos2u = 1.0 - 2.0 * sinu * sinu;
  temp = 1.0 / pl;
  const double temp1 = 0.5 * s[J2] * temp;
  const double temp2 = temp1 * temp;

  if (s[DEEP] != 0.0) {
    const double cosisq = cosip * cosip;
    con41 = 3.0 * cosisq - 1.0;
    x1mth2 = 1.0 - cosisq;
    x7thm1 = 7.0 * cosisq - 1.0;
  }

  const double mrt = rl * (1.0 - 1.5 * temp2 * betal * con41)
                     + 0.5 * temp1 * x1mth2 * cos2u;
  const double xnode = nodep + 1.5 * temp2 * cosip * sin2u;
  const double xinc = xincp + 1.5 * temp2 * cosip * sinip * cos2u;
  // * inv_xke (hoisted reciprocal) replaces two serial ~20-cycle
  // divides; x * (1/c) for these magnitudes differs from x / c by
  // <=1 ulp — inside the 1e-9 km parity gate
  const double mvt = rdotl - nm * temp1 * x1mth2 * sin2u * inv_xke;
  const double rvdot =
      rvdotl + nm * temp1 * (x1mth2 * cos2u + 1.5 * con41) * inv_xke;

  // su = atan2(sinu, cosu) - du: sinu/cosu ARE sin/cos of the true
  // argument of latitude (unit-norm to ~1e-15 by construction), so
  // sin/cos(su) follow from the angle-subtraction identity with a
  // tiny-angle series for du (|du| <= ~1e-3 rad; du^7 term ~1e-26) —
  // removing both the atan2 and one sincos (~40 ns/call). The
  // explicit renormalization keeps parity with the scale-invariant
  // atan2 formulation to <1 ulp.
  const double du = 0.25 * temp2 * x7thm1 * sin2u;
  const double du2 = du * du;
  const double sdu = du * (1.0 - du2 * (1.0 / 6.0) * (1.0 - du2 * 0.05));
  const double cdu = 1.0 - du2 * 0.5 * (1.0 - du2 * (1.0 / 12.0));
  const double rn = 1.0 / std::sqrt(sinu * sinu + cosu * cosu);
  const double sinsu = (sinu * cdu - cosu * sdu) * rn;
  const double cossu = (cosu * cdu + sinu * sdu) * rn;
  double snod, cnod, sini, cosi;
  fast_sincos(xnode, &snod, &cnod);
  fast_sincos(xinc, &sini, &cosi);
  const double xmx = -snod * cosi;
  const double xmy = cnod * cosi;
  const double ux = xmx * sinsu + cnod * cossu;
  const double uy = xmy * sinsu + snod * cossu;
  const double uz = sini * sinsu;
  const double vx = xmx * cossu - cnod * sinsu;
  const double vy = xmy * cossu - snod * sinsu;
  const double vz = sini * cossu;

  if (mrt < 1.0) return 6;
  out6[0] = mrt * ux * s[RADIUSEARTHKM];
  out6[1] = mrt * uy * s[RADIUSEARTHKM];
  out6[2] = mrt * uz * s[RADIUSEARTHKM];
  out6[3] = (mvt * ux + rvdot * vx) * vkmpersec;
  out6[4] = (mvt * uy + rvdot * vy) * vkmpersec;
  out6[5] = (mvt * uz + rvdot * vz) * vkmpersec;
  return 0;
}

}  // extern "C"

namespace {

// ---- 8-wide SIMD near-earth batch (the reference's 8-wide
// times-loop, Sgp4.zig:753, rebuilt masked-dense: every lane runs the
// full pipeline branchlessly and error lanes are zero-filled with
// first-error precedence — the exact design philosophy of the TPU
// kernels, auto-vectorized by GCC from stage-wise lane loops on this
// AVX-512 host). Satellite-uniform terms (cbrt spine, inclination
// trig, J-coefficients) are hoisted; per-lane work is 5 + <=10*kepler
// sincos polynomials and ~80 flops. Numerics are the same
// fast_sincos/reduce_twopi kernels as the scalar path; the masked
// Kepler update freezes converged lanes exactly where the scalar
// early-exit loop stops, so SIMD-vs-scalar parity is ~1 ulp (gated in
// tests/test_torch_api.py), not the reference's 1e-4 km SIMD drift. ----

constexpr int W = 8;

inline void fast_sincos_lane(double x, double* sx, double* cx) {
  fast_sincos_nv(x, sx, cx);  // branch-free: keeps lane loops vectorizable
}

// propagate W near-earth times; writes out[6*l + j] and err[l]
void sgp4_block_ne(const double* s, const double* t_in, double* out,
                   int* err) {
  const double vkmpersec = s[RADIUSEARTHKM] * s[XKE] / 60.0;
  const double inv_xke = 1.0 / s[XKE];
  const double isimp = s[ISIMP];
  // satellite-uniform spine (nm/em/incl have no per-time deep update)
  double sinip, cosip;
  fast_sincos(s[INCLO], &sinip, &cosip);

  double mmv[W], argpm[W], nodem[W], tempa[W], tempe[W], templ[W];
  double tv[W];
  for (int l = 0; l < W; ++l) {
    const double t = t_in[l];
    tv[l] = t;
    const double xmdf = s[MO] + s[MDOT] * t;
    const double argpdf = s[ARGPO] + s[ARGPDOT] * t;
    const double nodedf = s[NODEO] + s[NODEDOT] * t;
    const double t2 = t * t;
    nodem[l] = nodedf + s[NODECF] * t2;
    tempa[l] = 1.0 - s[CC1] * t;
    tempe[l] = s[BSTAR] * s[CC4] * t;
    templ[l] = s[T2COF] * t2;
    argpm[l] = argpdf;
    mmv[l] = xmdf;
  }
  if (isimp != 1.0) {
    for (int l = 0; l < W; ++l) {
      const double t = tv[l];
      const double xmdf = mmv[l];
      const double delomg = s[OMGCOF] * t;
      double sx, cx;
      fast_sincos_lane(xmdf, &sx, &cx);
      const double delmtemp = 1.0 + s[ETA] * cx;
      const double delm =
          s[XMCOF] * (delmtemp * delmtemp * delmtemp - s[DELMO]);
      const double temp = delomg + delm;
      mmv[l] = xmdf + temp;
      argpm[l] = argpm[l] - temp;
      const double t2 = t * t;
      const double t3 = t2 * t;
      const double t4 = t3 * t;
      tempa[l] = tempa[l] - s[D2] * t2 - s[D3] * t3 - s[D4] * t4;
      double smm, cmm;
      fast_sincos_lane(mmv[l], &smm, &cmm);
      tempe[l] = tempe[l] + s[BSTAR] * s[CC5] * (smm - s[SINMAO]);
      templ[l] = templ[l] + s[T3COF] * t3 + t4 * (s[T4COF] + t * s[T5COF]);
    }
  }

  const double nm0 = s[NO_UNKOZAI];
  if (nm0 <= 0.0) {
    for (int l = 0; l < W; ++l) {
      err[l] = 2;
      for (int j = 0; j < 6; ++j) out[6 * l + j] = 0.0;
    }
    return;
  }
  const double cb = fast_cbrt(s[XKE] / nm0);

  double am[W], nmv[W], emv[W], xlm[W], u[W];
  int ecode[W];
#pragma omp simd
  for (int l = 0; l < W; ++l) {
    am[l] = cb * cb * tempa[l] * tempa[l];
    nmv[l] = s[XKE] / (am[l] * std::sqrt(std::fabs(am[l])));
    double em = s[ECCO] - tempe[l];
    ecode[l] = (int)(em >= 1.0) | (int)(em < -0.001);
    em = em < 1.0e-6 ? 1.0e-6 : em;
    emv[l] = em;
    mmv[l] += s[NO_UNKOZAI] * templ[l];
    xlm[l] = mmv[l] + argpm[l] + nodem[l];
    nodem[l] = reduce_twopi_nv(nodem[l]);
    argpm[l] = reduce_twopi_nv(argpm[l]);
    xlm[l] = reduce_twopi_nv(xlm[l]);
    mmv[l] = reduce_twopi_nv(xlm[l] - argpm[l] - nodem[l]);
  }

  double axnl[W], aynl[W];
  for (int l = 0; l < W; ++l) {
    double sargp, cargp;
    fast_sincos_lane(argpm[l], &sargp, &cargp);
    axnl[l] = emv[l] * cargp;
    const double temp = 1.0 / (am[l] * (1.0 - emv[l] * emv[l]));
    aynl[l] = emv[l] * sargp + temp * s[AYCOF];
    const double xl =
        mmv[l] + argpm[l] + nodem[l] + temp * s[XLCOF] * axnl[l];
    u[l] = reduce_twopi_nv(xl - nodem[l]);
  }

  // masked Kepler: every lane follows the scalar while-loop exactly —
  // a lane stops updating at the same iteration the scalar loop would
  // exit, so converged values match the scalar engine bit-for-bit
  double eo1[W], tem5[W], sineo1[W], coseo1[W];
  for (int l = 0; l < W; ++l) {
    eo1[l] = u[l];
    tem5[l] = 9999.9;
    sineo1[l] = 0.0;
    coseo1[l] = 0.0;
  }
  for (int ktr = 1; ktr <= 10; ++ktr) {
    int any = 0;
    for (int l = 0; l < W; ++l) any |= (std::fabs(tem5[l]) >= 1.0e-12);
    if (!any) break;
#pragma omp simd
    for (int l = 0; l < W; ++l) {
      const bool act = std::fabs(tem5[l]) >= 1.0e-12;
      double sx, cx;
      fast_sincos_lane(eo1[l], &sx, &cx);
      double t5 = 1.0 - cx * axnl[l] - sx * aynl[l];
      t5 = (u[l] - aynl[l] * cx + axnl[l] * sx - eo1[l]) / t5;
      t5 = std::fabs(t5) >= 0.95 ? (t5 > 0.0 ? 0.95 : -0.95) : t5;
      sineo1[l] = act ? sx : sineo1[l];
      coseo1[l] = act ? cx : coseo1[l];
      eo1[l] = act ? eo1[l] + t5 : eo1[l];
      tem5[l] = act ? t5 : tem5[l];
    }
  }

#pragma omp simd
  for (int l = 0; l < W; ++l) {
    const double ecose = axnl[l] * coseo1[l] + aynl[l] * sineo1[l];
    const double esine = axnl[l] * sineo1[l] - aynl[l] * coseo1[l];
    const double el2 = axnl[l] * axnl[l] + aynl[l] * aynl[l];
    const double pl = am[l] * (1.0 - el2);
    int ec = ecode[l];
    ec |= ((int)(ec == 0) & (int)(pl < 0.0)) << 2;  // error 4

    const double pl_s = std::fabs(pl) + 1e-300;  // guard error lanes
    const double rl = am[l] * (1.0 - ecose);
    const double rdotl = std::sqrt(std::fabs(am[l])) * esine / rl;
    const double rvdotl = std::sqrt(pl_s) / rl;
    const double betal = std::sqrt(std::fabs(1.0 - el2));
    double temp = esine / (1.0 + betal);
    const double sinu = am[l] / rl * (sineo1[l] - aynl[l] - axnl[l] * temp);
    const double cosu = am[l] / rl * (coseo1[l] - axnl[l] + aynl[l] * temp);
    const double sin2u = (cosu + cosu) * sinu;
    const double cos2u = 1.0 - 2.0 * sinu * sinu;
    temp = 1.0 / pl_s;
    const double temp1 = 0.5 * s[J2] * temp;
    const double temp2 = temp1 * temp;

    const double mrt = rl * (1.0 - 1.5 * temp2 * betal * s[CON41])
                       + 0.5 * temp1 * s[X1MTH2] * cos2u;
    const double xnode = nodem[l] + 1.5 * temp2 * cosip * sin2u;
    const double xinc = s[INCLO] + 1.5 * temp2 * cosip * sinip * cos2u;
    const double mvt =
        rdotl - nmv[l] * temp1 * s[X1MTH2] * sin2u * inv_xke;
    const double rvdot = rvdotl + nmv[l] * temp1 *
        (s[X1MTH2] * cos2u + 1.5 * s[CON41]) * inv_xke;

    const double du = 0.25 * temp2 * s[X7THM1] * sin2u;
    const double du2 = du * du;
    const double sdu =
        du * (1.0 - du2 * (1.0 / 6.0) * (1.0 - du2 * 0.05));
    const double cdu = 1.0 - du2 * 0.5 * (1.0 - du2 * (1.0 / 12.0));
    const double rn =
        1.0 / std::sqrt(sinu * sinu + cosu * cosu + 1e-300);
    const double sinsu = (sinu * cdu - cosu * sdu) * rn;
    const double cossu = (cosu * cdu + sinu * sdu) * rn;
    double snod, cnod, sini, cosi;
    fast_sincos_lane(xnode, &snod, &cnod);
    fast_sincos_lane(xinc, &sini, &cosi);
    const double xmx = -snod * cosi;
    const double xmy = cnod * cosi;
    const double ux = xmx * sinsu + cnod * cossu;
    const double uy = xmy * sinsu + snod * cossu;
    const double uz = sini * sinsu;
    const double vx = xmx * cossu - cnod * sinsu;
    const double vy = xmy * cossu - snod * sinsu;
    const double vz = sini * cossu;

    ec |= ((int)(ec == 0) & (int)(mrt < 1.0)) * 6;  // error 6
    // SELECT, never multiply: an error lane's intermediates may have
    // overflowed to inf, and 0.0 * inf = NaN would leak where the
    // scalar path's early return writes exact zeros (the same rule as
    // the TPU kernels' masked-dense merges). Bit-level mask — the
    // vectorizer found "no vectype" for a bool-ternary formulation.
    const uint64_t keep = (uint64_t)0 - (uint64_t)(ec == 0);
    const double o0 = mrt * ux * s[RADIUSEARTHKM];
    const double o1 = mrt * uy * s[RADIUSEARTHKM];
    const double o2 = mrt * uz * s[RADIUSEARTHKM];
    const double o3 = (mvt * ux + rvdot * vx) * vkmpersec;
    const double o4 = (mvt * uy + rvdot * vy) * vkmpersec;
    const double o5 = (mvt * uz + rvdot * vz) * vkmpersec;
    uint64_t b0, b1, b2, b3, b4, b5;
    std::memcpy(&b0, &o0, 8); std::memcpy(&b1, &o1, 8);
    std::memcpy(&b2, &o2, 8); std::memcpy(&b3, &o3, 8);
    std::memcpy(&b4, &o4, 8); std::memcpy(&b5, &o5, 8);
    b0 &= keep; b1 &= keep; b2 &= keep;
    b3 &= keep; b4 &= keep; b5 &= keep;
    std::memcpy(&out[6 * l + 0], &b0, 8);
    std::memcpy(&out[6 * l + 1], &b1, 8);
    std::memcpy(&out[6 * l + 2], &b2, 8);
    std::memcpy(&out[6 * l + 3], &b3, 8);
    std::memcpy(&out[6 * l + 4], &b4, 8);
    std::memcpy(&out[6 * l + 5], &b5, 8);
    err[l] = ec;
  }
}

}  // namespace

extern "C" {

// Batch form over a tsince array — amortizes the call overhead for
// sgp4_tsince-style loops (one crossing per array, not per point).
// Near-earth satellites take the 8-wide SIMD block path; deep-space
// keeps the exact scalar loop (the resonance integration is
// data-dependent per time).
long long astroz_scalar_sgp4_array(const double* s, const double* tsince,
                                   long long n, double* out, int* err) {
  if (s[DEEP] != 0.0) {
    for (long long i = 0; i < n; ++i)
      err[i] = astroz_scalar_sgp4(s, tsince[i], out + 6 * i);
    return n;
  }
  // horizon gate: the SIMD block uses the branch-free (_nv) trig,
  // whose Cody-Waite reduction assumes angles < ~8e5 rad. |t| < 6e5
  // min (>1 year) keeps xmdf = MO + MDOT*t inside that for any
  // near-earth mean motion (MDOT < ~0.073 rad/min -> |xmdf| < ~4.5e4);
  // longer horizons take the scalar loop, whose guarded trig falls
  // back to libm's exact reduction per point.
  double tmax = 0.0;
  for (long long i = 0; i < n; ++i)
    tmax = std::fabs(tsince[i]) > tmax ? std::fabs(tsince[i]) : tmax;
  if (tmax > 6.0e5) {
    for (long long i = 0; i < n; ++i)
      err[i] = astroz_scalar_sgp4(s, tsince[i], out + 6 * i);
    return n;
  }
  long long i = 0;
  for (; i + W <= n; i += W)
    sgp4_block_ne(s, tsince + i, out + 6 * i, err + i);
  if (i < n) {  // masked tail block: pad with the last time
    double tpad[W];
    double opad[6 * W];
    int epad[W];
    for (int l = 0; l < W; ++l)
      tpad[l] = tsince[i + l < n ? i + l : n - 1];
    sgp4_block_ne(s, tpad, opad, epad);
    for (; i < n; ++i) {
      err[i] = epad[i % W];
      for (int j = 0; j < 6; ++j) out[6 * i + j] = opad[6 * (i % W) + j];
    }
  }
  return n;
}

// (n_sats, n_times) grid in ONE native crossing: vecs is the packed
// element matrix (n_sats x nf doubles, one pack_scalar_sat row per
// satellite), tsince is (n_sats x n_times) minutes-past-epoch, outputs
// are (n_sats x n_times x 6) / (n_sats x n_times). Each satellite runs
// the 8-wide near-earth SIMD batch (or the exact scalar deep loop) —
// the SatrecArray CPU sweep without per-satellite Python/ctypes
// overhead (reference: the batch-range loop, Constellation.zig:360-382).
long long astroz_sgp4_grid(const double* vecs, long long n_sats,
                           long long nf, const double* tsince,
                           long long n_times, double* out, int* err) {
  for (long long si = 0; si < n_sats; ++si)
    astroz_scalar_sgp4_array(vecs + si * nf, tsince + si * n_times,
                             n_times, out + si * n_times * 6,
                             err + si * n_times);
  return n_sats * n_times;
}

}  // extern "C"
