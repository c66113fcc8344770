// The C ABI of astroz_tpu_torch's native runtime, for callers outside
// Python: parse a TLE, init SGP4/SDP4 and propagate, plus the orbital
// and coordinate helpers. A copy of astroz_tpu/native/c_api.cpp with
// the same exported names and error-code values (astroz_c.h), built
// into the port's one native library (native/__init__.py).
// sgp4_init supports deep-space satellites (SDP4 init and propagate run
// natively), so the -10 code is never emitted.
//
// The init path is a C++ translation of the published Vallado AIAA
// 2006-6753 algorithm as ops/scalar.py writes it (sgp4init, _dscom,
// _dsinit), writing straight into the packed element vector consumed
// by scalar_sgp4.cpp (layout: scalar_fields.h). This file is compiled
// without FMA contraction, and each expression keeps ops/scalar.py's
// operations, so sgp4_init writes the vector that ops/scalar.py's
// sgp4init and native.pack_scalar_sat give, bit for bit, and
// sgp4_propagate equals Satrec.sgp4_tsince on the native core
// (tests/test_torch_c_api.py).

// Python rounds every operation: no a * b + c into one FMA here.
#pragma GCC optimize("fp-contract=off")

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "scalar_fields.h"

extern "C" {
// tle_parser.cpp (SoA columns, radians / rad-per-minute)
int astroz_parse_catalog(const char* text, long long text_len,
                         double* cols, long long* satnums,
                         long long stride, long long max_sats);
}

namespace {

constexpr double TWOPI = 6.283185307179586476925286766559;
constexpr double DEG2RAD = TWOPI / 360.0;
constexpr double RAD2DEG = 360.0 / TWOPI;
constexpr double XPDOTP = 1440.0 / TWOPI;  // rad/min -> rev/day

// Error codes — values match the reference ABI (c_api/error.zig).
enum Code {
  OK = 0,
  BAD_TLE_LENGTH = -1,
  BAD_CHECKSUM = -2,
  DEEP_SPACE_NOT_SUPPORTED = -10,  // never emitted: SDP4 is native here
  INVALID_ECCENTRICITY = -11,
  SATELLITE_DECAYED = -12,
  VALUE_ERROR = -20,
  ALLOC_FAILED = -100,
  NULL_POINTER = -101,
  NOT_INITIALIZED = -102,
  UNKNOWN = -999,
};

// tle_parser.cpp's Col enum (N_COLS = 12 in native/__init__.py)
enum Col {
  COL_EPOCH_JD = 0, COL_JDSATEPOCH, COL_JDSATEPOCHF, COL_NO_KOZAI,
  COL_ECCO, COL_INCLO, COL_NODEO, COL_ARGPO, COL_MO, COL_BSTAR,
  COL_NDOT, COL_NDDOT, N_TLE_COLS
};

struct TleRec {
  double cols[N_TLE_COLS];
  long long satnum;
};

struct Sgp4Rec {
  double s[N_FIELDS];  // packed element vector (scalar_fields.h)
};

// gstime — ops/scalar.py
double gstime(double jdut1) {
  const double tut1 = (jdut1 - 2451545.0) / 36525.0;
  double temp = -6.2e-6 * tut1 * tut1 * tut1 + 0.093104 * tut1 * tut1 +
                (876600.0 * 3600.0 + 8640184.812866) * tut1 + 67310.54841;
  temp = std::fmod(temp * DEG2RAD / 240.0, TWOPI);
  if (temp < 0.0) temp += TWOPI;
  return temp;
}

// Gravity models — ops/scalar.py. grav_model: 0 = WGS84
// (default), 1 = WGS72, matching the reference (c_api/sgp4.zig:19-21).
struct Grav {
  double mu, radiusearthkm, xke, j2, j3, j4, j3oj2;
};

Grav grav_consts(int grav_model) {
  if (grav_model == 1) {
    const double mu = 398600.8, re = 6378.135;
    const double xke = 60.0 / std::sqrt(re * re * re / mu);
    return {mu, re, xke, 0.001082616, -0.00000253881, -0.00000165597,
            -0.00000253881 / 0.001082616};
  }
  const double mu = 398600.5, re = 6378.137;
  const double xke = 60.0 / std::sqrt(re * re * re / mu);
  return {mu, re, xke, 0.00108262998905, -0.00000253215306,
          -0.00000161098761, -0.00000253215306 / 0.00108262998905};
}

// dscom + dsinit — deep-space init (ops/scalar.py: _dscom, _dsinit)
// writing the periodics/secular/resonance coefficients into s[].
void deep_init(double* s, double epoch, double xpidot, double eccsq) {
  const double ep = s[ECCO], argpp = s[ARGPO], inclp = s[INCLO];
  const double nodep = s[NODEO], np_ = s[NO_UNKOZAI];
  const double tc = 0.0;

  // ---- dscom ----
  const double zes = 0.01675, zel = 0.05490;
  const double c1ss = 2.9864797e-6, c1l = 4.7968065e-7;
  const double zsinis = 0.39785416, zcosis = 0.91744867;
  const double zcosgs = 0.1945905, zsings = -0.98088458;

  const double nm = np_;
  const double em = ep;
  const double snodm = std::sin(nodep), cnodm = std::cos(nodep);
  const double sinomm = std::sin(argpp), cosomm = std::cos(argpp);
  const double sinim = std::sin(inclp), cosim = std::cos(inclp);
  const double emsq = em * em;
  const double betasq = 1.0 - emsq;
  const double rtemsq = std::sqrt(betasq);

  const double day = epoch + 18261.5 + tc / 1440.0;
  const double xnodce = std::fmod(4.5236020 - 9.2422029e-4 * day, TWOPI);
  const double stem = std::sin(xnodce), ctem = std::cos(xnodce);
  const double zcosil = 0.91375164 - 0.03568096 * ctem;
  const double zsinil = std::sqrt(1.0 - zcosil * zcosil);
  const double zsinhl = 0.089683511 * stem / zsinil;
  const double zcoshl = std::sqrt(1.0 - zsinhl * zsinhl);
  const double gam = 5.8351514 + 0.0019443680 * day;
  double zx = 0.39785416 * stem / zsinil;
  const double zy = zcoshl * ctem + 0.91744867 * zsinhl * stem;
  zx = std::atan2(zx, zy);
  zx = gam + zx - xnodce;
  const double zcosgl = std::cos(zx), zsingl = std::sin(zx);

  double zcosg = zcosgs, zsing = zsings, zcosi = zcosis, zsini = zsinis;
  double zcosh = cnodm, zsinh = snodm;
  double cc = c1ss;
  const double xnoi = 1.0 / nm;

  // solar pass (lsflg=1) then lunar pass (lsflg=2)
  double ss1 = 0, ss2 = 0, ss3 = 0, ss4 = 0, ss5 = 0, ss6 = 0, ss7 = 0;
  double sz1 = 0, sz2 = 0, sz3 = 0, sz11 = 0, sz12 = 0, sz13 = 0;
  double sz21 = 0, sz22 = 0, sz23 = 0, sz31 = 0, sz32 = 0, sz33 = 0;
  double s1 = 0, s2 = 0, s3 = 0, s4 = 0, s5 = 0, s6 = 0, s7 = 0;
  double z1 = 0, z2 = 0, z3 = 0, z11 = 0, z12 = 0, z13 = 0;
  double z21 = 0, z22 = 0, z23 = 0, z31 = 0, z32 = 0, z33 = 0;

  for (int lsflg = 1; lsflg <= 2; ++lsflg) {
    const double a1 = zcosg * zcosh + zsing * zcosi * zsinh;
    const double a3 = -zsing * zcosh + zcosg * zcosi * zsinh;
    const double a7 = -zcosg * zsinh + zsing * zcosi * zcosh;
    const double a8 = zsing * zsini;
    const double a9 = zsing * zsinh + zcosg * zcosi * zcosh;
    const double a10 = zcosg * zsini;
    const double a2 = cosim * a7 + sinim * a8;
    const double a4 = cosim * a9 + sinim * a10;
    const double a5 = -sinim * a7 + cosim * a8;
    const double a6 = -sinim * a9 + cosim * a10;

    const double x1 = a1 * cosomm + a2 * sinomm;
    const double x2 = a3 * cosomm + a4 * sinomm;
    const double x3 = -a1 * sinomm + a2 * cosomm;
    const double x4 = -a3 * sinomm + a4 * cosomm;
    const double x5 = a5 * sinomm;
    const double x6 = a6 * sinomm;
    const double x7 = a5 * cosomm;
    const double x8 = a6 * cosomm;

    z31 = 12.0 * x1 * x1 - 3.0 * x3 * x3;
    z32 = 24.0 * x1 * x2 - 6.0 * x3 * x4;
    z33 = 12.0 * x2 * x2 - 3.0 * x4 * x4;
    z1 = 3.0 * (a1 * a1 + a2 * a2) + z31 * emsq;
    z2 = 6.0 * (a1 * a3 + a2 * a4) + z32 * emsq;
    z3 = 3.0 * (a3 * a3 + a4 * a4) + z33 * emsq;
    z11 = -6.0 * a1 * a5 + emsq * (-24.0 * x1 * x7 - 6.0 * x3 * x5);
    z12 = -6.0 * (a1 * a6 + a3 * a5) +
          emsq * (-24.0 * (x2 * x7 + x1 * x8) - 6.0 * (x3 * x6 + x4 * x5));
    z13 = -6.0 * a3 * a6 + emsq * (-24.0 * x2 * x8 - 6.0 * x4 * x6);
    z21 = 6.0 * a2 * a5 + emsq * (24.0 * x1 * x5 - 6.0 * x3 * x7);
    z22 = 6.0 * (a4 * a5 + a2 * a6) +
          emsq * (24.0 * (x2 * x5 + x1 * x6) - 6.0 * (x4 * x7 + x3 * x8));
    z23 = 6.0 * a4 * a6 + emsq * (24.0 * x2 * x6 - 6.0 * x4 * x8);
    z1 = z1 + z1 + betasq * z31;
    z2 = z2 + z2 + betasq * z32;
    z3 = z3 + z3 + betasq * z33;
    s3 = cc * xnoi;
    s2 = -0.5 * s3 / rtemsq;
    s4 = s3 * rtemsq;
    s1 = -15.0 * em * s4;
    s5 = x1 * x3 + x2 * x4;
    s6 = x2 * x3 + x1 * x4;
    s7 = x2 * x4 - x1 * x3;

    if (lsflg == 1) {
      ss1 = s1; ss2 = s2; ss3 = s3; ss4 = s4; ss5 = s5; ss6 = s6; ss7 = s7;
      sz1 = z1; sz2 = z2; sz3 = z3;
      sz11 = z11; sz12 = z12; sz13 = z13;
      sz21 = z21; sz22 = z22; sz23 = z23;
      sz31 = z31; sz32 = z32; sz33 = z33;
      zcosg = zcosgl; zsing = zsingl;
      zcosi = zcosil; zsini = zsinil;
      zcosh = zcoshl * cnodm + zsinhl * snodm;
      zsinh = snodm * zcoshl - cnodm * zsinhl;
      cc = c1l;
    }
  }

  s[ZMOS] = std::fmod(6.2565837 + 0.017201977 * day, TWOPI);
  s[ZMOL] = std::fmod(4.7199672 + 0.22997150 * day - gam, TWOPI);

  s[SE2] = 2.0 * ss1 * ss6;
  s[SE3] = 2.0 * ss1 * ss7;
  s[SI2] = 2.0 * ss2 * sz12;
  s[SI3] = 2.0 * ss2 * (sz13 - sz11);
  s[SL2] = -2.0 * ss3 * sz2;
  s[SL3] = -2.0 * ss3 * (sz3 - sz1);
  s[SL4] = -2.0 * ss3 * (-21.0 - 9.0 * emsq) * zes;
  s[SGH2] = 2.0 * ss4 * sz32;
  s[SGH3] = 2.0 * ss4 * (sz33 - sz31);
  s[SGH4] = -18.0 * ss4 * zes;
  s[SH2] = -2.0 * ss2 * sz22;
  s[SH3] = -2.0 * ss2 * (sz23 - sz21);
  s[EE2] = 2.0 * s1 * s6;
  s[E3] = 2.0 * s1 * s7;
  s[XI2] = 2.0 * s2 * z12;
  s[XI3] = 2.0 * s2 * (z13 - z11);
  s[XL2] = -2.0 * s3 * z2;
  s[XL3] = -2.0 * s3 * (z3 - z1);
  s[XL4] = -2.0 * s3 * (-21.0 - 9.0 * emsq) * zel;
  s[XGH2] = 2.0 * s4 * z32;
  s[XGH3] = 2.0 * s4 * (z33 - z31);
  s[XGH4] = -18.0 * s4 * zel;
  s[XH2] = -2.0 * s2 * z22;
  s[XH3] = -2.0 * s2 * (z23 - z21);

  // ---- dsinit ----
  const double q22 = 1.7891679e-6, q31 = 2.1460748e-6, q33 = 2.2123015e-7;
  const double root22 = 1.7891679e-6, root44 = 7.3636953e-9,
               root54 = 2.1765803e-9;
  const double rptim = 4.37526908801129966e-3;
  const double root32 = 3.7393792e-7, root52 = 1.1428639e-7;
  const double znl = 1.5835218e-4, zns = 1.19459e-5;

  const double inclm = s[INCLO];
  double em2 = s[ECCO];
  double emsq2 = emsq;

  int irez = 0;
  if (nm > 0.0034906585 && nm < 0.0052359877) irez = 1;
  if (nm >= 8.26e-3 && nm <= 9.24e-3 && em2 >= 0.5) irez = 2;

  const double ses = ss1 * zns * ss5;
  const double sis = ss2 * zns * (sz11 + sz13);
  const double sls = -zns * ss3 * (sz1 + sz3 - 14.0 - 6.0 * emsq);
  const double sghs = ss4 * zns * (sz31 + sz33 - 6.0);
  double shs = -zns * ss2 * (sz21 + sz23);
  if (inclm < 5.2359877e-2 || inclm > M_PI - 5.2359877e-2) shs = 0.0;
  if (sinim != 0.0) shs /= sinim;
  const double sgs = sghs - cosim * shs;

  double dedt = ses + s1 * znl * s5;
  double didt = sis + s2 * znl * (z11 + z13);
  double dmdt = sls - znl * s3 * (z1 + z3 - 14.0 - 6.0 * emsq);
  const double sghl = s4 * znl * (z31 + z33 - 6.0);
  double shll = -znl * s2 * (z21 + z23);
  if (inclm < 5.2359877e-2 || inclm > M_PI - 5.2359877e-2) shll = 0.0;
  double domdt = sgs + sghl;
  double dnodt = shs;
  if (sinim != 0.0) {
    domdt -= cosim / sinim * shll;
    dnodt += shll / sinim;
  }

  const double theta = std::fmod(s[GSTO] + tc * rptim, TWOPI);
  s[DEDT] = dedt; s[DIDT] = didt; s[DMDT] = dmdt;
  s[DOMDT] = domdt; s[DNODT] = dnodt;
  s[IREZ] = static_cast<double>(irez);

  if (irez != 0) {
    const double aonv = std::pow(nm / (s[XKE]), 2.0 / 3.0);
    if (irez == 2) {
      const double cosisq = cosim * cosim;
      em2 = s[ECCO];
      emsq2 = eccsq;
      const double eoc = em2 * emsq2;
      const double g201 = -0.306 - (em2 - 0.64) * 0.440;
      double g211, g310, g322, g410, g422, g520;
      if (em2 <= 0.65) {
        g211 = 3.616 - 13.2470 * em2 + 16.2900 * emsq2;
        g310 = -19.302 + 117.3900 * em2 - 228.4190 * emsq2 + 156.5910 * eoc;
        g322 = -18.9068 + 109.7927 * em2 - 214.6334 * emsq2 + 146.5816 * eoc;
        g410 = -41.122 + 242.6940 * em2 - 471.0940 * emsq2 + 313.9530 * eoc;
        g422 = -146.407 + 841.8800 * em2 - 1629.014 * emsq2 + 1083.4350 * eoc;
        g520 = -532.114 + 3017.977 * em2 - 5740.032 * emsq2 + 3708.2760 * eoc;
      } else {
        g211 = -72.099 + 331.819 * em2 - 508.738 * emsq2 + 266.724 * eoc;
        g310 = -346.844 + 1582.851 * em2 - 2415.925 * emsq2 + 1246.113 * eoc;
        g322 = -342.585 + 1554.908 * em2 - 2366.899 * emsq2 + 1215.972 * eoc;
        g410 = -1052.797 + 4758.686 * em2 - 7193.992 * emsq2 + 3651.957 * eoc;
        g422 = -3581.690 + 16178.110 * em2 - 24462.770 * emsq2 +
               12422.520 * eoc;
        if (em2 > 0.715)
          g520 = -5149.66 + 29936.92 * em2 - 54087.36 * emsq2 +
                 31324.56 * eoc;
        else
          g520 = 1464.74 - 4664.75 * em2 + 3763.64 * emsq2;
      }
      double g533, g521, g532;
      if (em2 < 0.7) {
        g533 = -919.22770 + 4988.6100 * em2 - 9064.7700 * emsq2 +
               5542.21 * eoc;
        g521 = -822.71072 + 4568.6173 * em2 - 8491.4146 * emsq2 +
               5337.524 * eoc;
        g532 = -853.66600 + 4690.2500 * em2 - 8624.7700 * emsq2 +
               5341.4 * eoc;
      } else {
        g533 = -37995.780 + 161616.52 * em2 - 229838.20 * emsq2 +
               109377.94 * eoc;
        g521 = -51752.104 + 218913.95 * em2 - 309468.16 * emsq2 +
               146349.42 * eoc;
        g532 = -40023.880 + 170470.89 * em2 - 242699.48 * emsq2 +
               115605.82 * eoc;
      }
      const double sini2 = sinim * sinim;
      const double f220 = 0.75 * (1.0 + 2.0 * cosim + cosisq);
      const double f221 = 1.5 * sini2;
      const double f321 =
          1.875 * sinim * (1.0 - 2.0 * cosim - 3.0 * cosisq);
      const double f322 =
          -1.875 * sinim * (1.0 + 2.0 * cosim - 3.0 * cosisq);
      const double f441 = 35.0 * sini2 * f220;
      const double f442 = 39.3750 * sini2 * sini2;
      const double f522 =
          9.84375 * sinim *
          (sini2 * (1.0 - 2.0 * cosim - 5.0 * cosisq) +
           0.33333333 * (-2.0 + 4.0 * cosim + 6.0 * cosisq));
      const double f523 =
          sinim * (4.92187512 * sini2 * (-2.0 - 4.0 * cosim + 10.0 * cosisq) +
                   6.56250012 * (1.0 + 2.0 * cosim - 3.0 * cosisq));
      const double f542 =
          29.53125 * sinim *
          (2.0 - 8.0 * cosim + cosisq * (-12.0 + 8.0 * cosim + 10.0 * cosisq));
      const double f543 =
          29.53125 * sinim *
          (-2.0 - 8.0 * cosim + cosisq * (12.0 + 8.0 * cosim - 10.0 * cosisq));
      const double xno2 = nm * nm;
      const double ainv2 = aonv * aonv;
      double temp1 = 3.0 * xno2 * ainv2;
      double temp = temp1 * root22;
      s[D2201] = temp * f220 * g201;
      s[D2211] = temp * f221 * g211;
      temp1 *= aonv;
      temp = temp1 * root32;
      s[D3210] = temp * f321 * g310;
      s[D3222] = temp * f322 * g322;
      temp1 *= aonv;
      temp = 2.0 * temp1 * root44;
      s[D4410] = temp * f441 * g410;
      s[D4422] = temp * f442 * g422;
      temp1 *= aonv;
      temp = temp1 * root52;
      s[D5220] = temp * f522 * g520;
      s[D5232] = temp * f523 * g532;
      temp = 2.0 * temp1 * root54;
      s[D5421] = temp * f542 * g521;
      s[D5433] = temp * f543 * g533;
      s[XLAMO] =
          std::fmod(s[MO] + s[NODEO] + s[NODEO] - theta - theta, TWOPI);
      s[XFACT] = s[MDOT] + s[DMDT] +
                 2.0 * (s[NODEDOT] + s[DNODT] - rptim) - s[NO_UNKOZAI];
    }
    if (irez == 1) {
      const double g200 = 1.0 + emsq2 * (-2.5 + 0.8125 * emsq2);
      const double g310 = 1.0 + 2.0 * emsq2;
      const double g300 = 1.0 + emsq2 * (-6.0 + 6.60937 * emsq2);
      const double f220 = 0.75 * (1.0 + cosim) * (1.0 + cosim);
      const double f311 =
          0.9375 * sinim * sinim * (1.0 + 3.0 * cosim) - 0.75 * (1.0 + cosim);
      double f330 = 1.0 + cosim;
      f330 = 1.875 * f330 * f330 * f330;
      double del1 = 3.0 * nm * nm * aonv * aonv;
      const double del2 = 2.0 * del1 * f220 * g200 * q22;
      const double del3 = 3.0 * del1 * f330 * g300 * q33 * aonv;
      del1 = del1 * f311 * g310 * q31 * aonv;
      s[DEL1] = del1; s[DEL2] = del2; s[DEL3] = del3;
      s[XLAMO] =
          std::fmod(s[MO] + s[NODEO] + s[ARGPO] - theta, TWOPI);
      s[XFACT] = s[MDOT] + xpidot - rptim + s[DMDT] + s[DOMDT] + s[DNODT] -
                 s[NO_UNKOZAI];
    }
  }
}

// sgp4init — ops/scalar.py. Fills the packed element vector.
// Returns a Code.
int sgp4_init_vec(double* s, const Grav& grav, double epoch_jd,
                  double bstar, double ecco, double argpo, double inclo,
                  double mo, double no_kozai, double nodeo) {
  std::memset(s, 0, sizeof(double) * N_FIELDS);
  if (ecco >= 1.0 || ecco < 0.0) return INVALID_ECCENTRICITY;
  if (no_kozai <= 0.0) return VALUE_ERROR;

  s[RADIUSEARTHKM] = grav.radiusearthkm;
  s[XKE] = grav.xke;
  s[J2] = grav.j2;
  s[J3OJ2] = grav.j3oj2;
  s[MO] = mo; s[ARGPO] = argpo; s[NODEO] = nodeo;
  s[BSTAR] = bstar; s[ECCO] = ecco; s[INCLO] = inclo;

  const double x2o3 = 2.0 / 3.0;
  const double temp4 = 1.5e-12;
  const double epoch = epoch_jd - 2433281.5;

  // ---- initl ----
  const double eccsq = ecco * ecco;
  const double omeosq = 1.0 - eccsq;
  const double rteosq = std::sqrt(omeosq);
  const double cosio = std::cos(inclo);
  const double cosio2 = cosio * cosio;
  const double ak = std::pow(grav.xke / no_kozai, x2o3);
  const double d1 =
      0.75 * grav.j2 * (3.0 * cosio2 - 1.0) / (rteosq * omeosq);
  double del_ = d1 / (ak * ak);
  const double adel =
      ak * (1.0 - del_ * del_ -
            del_ * (1.0 / 3.0 + 134.0 * del_ * del_ / 81.0));
  del_ = d1 / (adel * adel);
  const double no_unkozai = no_kozai / (1.0 + del_);
  const double ao = std::pow(grav.xke / no_unkozai, x2o3);
  const double sinio = std::sin(inclo);
  const double po = ao * omeosq;
  const double con42 = 1.0 - 5.0 * cosio2;
  const double con41 = -con42 - cosio2 - cosio2;
  const double posq = po * po;
  const double rp = ao * (1.0 - ecco);
  s[NO_UNKOZAI] = no_unkozai;
  s[GSTO] = gstime(epoch_jd);
  s[CON41] = con41;

  double isimp = 0.0;
  if (rp < 220.0 / grav.radiusearthkm + 1.0) isimp = 1.0;
  double sfour = 78.0 / grav.radiusearthkm + 1.0;
  double qzms24 = std::pow((120.0 - 78.0) / grav.radiusearthkm, 4.0);
  const double perige = (rp - 1.0) * grav.radiusearthkm;
  if (perige < 156.0) {
    sfour = perige - 78.0;
    if (perige < 98.0) sfour = 20.0;
    qzms24 = std::pow((120.0 - sfour) / grav.radiusearthkm, 4.0);
    sfour = sfour / grav.radiusearthkm + 1.0;
  }
  const double pinvsq = 1.0 / posq;

  const double tsi = 1.0 / (ao - sfour);
  const double eta = ao * ecco * tsi;
  const double etasq = eta * eta;
  const double eeta = ecco * eta;
  const double psisq = std::fabs(1.0 - etasq);
  const double coef = qzms24 * std::pow(tsi, 4.0);
  const double coef1 = coef / std::pow(psisq, 3.5);
  const double cc2 =
      coef1 * no_unkozai *
      (ao * (1.0 + 1.5 * etasq + eeta * (4.0 + etasq)) +
       0.375 * grav.j2 * tsi / psisq * con41 *
           (8.0 + 3.0 * etasq * (8.0 + etasq)));
  const double cc1 = bstar * cc2;
  double cc3 = 0.0;
  if (ecco > 1.0e-4)
    cc3 = -2.0 * coef * tsi * grav.j3oj2 * no_unkozai * sinio / ecco;
  const double x1mth2 = 1.0 - cosio2;
  const double cc4 =
      2.0 * no_unkozai * coef1 * ao * omeosq *
      (eta * (2.0 + 0.5 * etasq) + ecco * (0.5 + 2.0 * etasq) -
       grav.j2 * tsi / (ao * psisq) *
           (-3.0 * con41 * (1.0 - 2.0 * eeta + etasq * (1.5 - 0.5 * eeta)) +
            0.75 * x1mth2 * (2.0 * etasq - eeta * (1.0 + etasq)) *
                std::cos(2.0 * argpo)));
  const double cc5 = 2.0 * coef1 * ao * omeosq *
                     (1.0 + 2.75 * (etasq + eeta) + eeta * etasq);
  const double cosio4 = cosio2 * cosio2;
  const double temp1 = 1.5 * grav.j2 * pinvsq * no_unkozai;
  const double temp2 = 0.5 * temp1 * grav.j2 * pinvsq;
  const double temp3 = -0.46875 * grav.j4 * pinvsq * pinvsq * no_unkozai;
  const double mdot =
      no_unkozai + 0.5 * temp1 * rteosq * con41 +
      0.0625 * temp2 * rteosq * (13.0 - 78.0 * cosio2 + 137.0 * cosio4);
  const double argpdot =
      -0.5 * temp1 * con42 +
      0.0625 * temp2 * (7.0 - 114.0 * cosio2 + 395.0 * cosio4) +
      temp3 * (3.0 - 36.0 * cosio2 + 49.0 * cosio4);
  const double xhdot1 = -temp1 * cosio;
  const double nodedot =
      xhdot1 + (0.5 * temp2 * (4.0 - 19.0 * cosio2) +
                2.0 * temp3 * (3.0 - 7.0 * cosio2)) *
                   cosio;
  const double xpidot = argpdot + nodedot;
  const double omgcof = bstar * cc3 * std::cos(argpo);
  double xmcof = 0.0;
  if (ecco > 1.0e-4) xmcof = -x2o3 * coef * bstar / eeta;
  const double nodecf = 3.5 * omeosq * xhdot1 * cc1;
  const double t2cof = 1.5 * cc1;
  double xlcof;
  if (std::fabs(cosio + 1.0) > 1.5e-12)
    xlcof = -0.25 * grav.j3oj2 * sinio * (3.0 + 5.0 * cosio) / (1.0 + cosio);
  else
    xlcof = -0.25 * grav.j3oj2 * sinio * (3.0 + 5.0 * cosio) / temp4;
  const double aycof = -0.5 * grav.j3oj2 * sinio;
  const double delmotemp = 1.0 + eta * std::cos(mo);
  const double delmo = std::pow(delmotemp, 3.0);  // ops/scalar.py's ** 3
  const double sinmao = std::sin(mo);
  const double x7thm1 = 7.0 * cosio2 - 1.0;

  s[ETA] = eta; s[CC1] = cc1; s[CC4] = cc4; s[CC5] = cc5;
  s[MDOT] = mdot; s[ARGPDOT] = argpdot; s[NODEDOT] = nodedot;
  s[OMGCOF] = omgcof; s[XMCOF] = xmcof; s[NODECF] = nodecf;
  s[T2COF] = t2cof; s[XLCOF] = xlcof; s[AYCOF] = aycof;
  s[DELMO] = delmo; s[SINMAO] = sinmao; s[X7THM1] = x7thm1;
  s[X1MTH2] = x1mth2;

  if (TWOPI / no_unkozai >= 225.0) {
    s[DEEP] = 1.0;
    isimp = 1.0;
    deep_init(s, epoch, xpidot, eccsq);
  }

  if (isimp != 1.0) {
    const double cc1sq = cc1 * cc1;
    const double d2 = 4.0 * ao * tsi * cc1sq;
    const double temp = d2 * tsi * cc1 / 3.0;
    const double d3 = (17.0 * ao + sfour) * temp;
    const double d4 =
        0.5 * temp * ao * tsi * (221.0 * ao + 31.0 * sfour) * cc1;
    s[D2] = d2; s[D3] = d3; s[D4] = d4;
    s[T3COF] = d2 + 2.0 * cc1sq;
    s[T4COF] = 0.25 * (3.0 * d3 + cc1 * (12.0 * d2 + 10.0 * cc1sq));
    s[T5COF] = 0.2 * (3.0 * d4 + 12.0 * cc1 * d3 + 6.0 * d2 * d2 +
                      15.0 * cc1sq * (2.0 * d2 + cc1sq));
  }
  s[ISIMP] = isimp;
  return OK;
}

// Map scalar-engine (python-sgp4 convention) propagate errors to the
// reference ABI codes (error.zig): 1/3 = eccentricity out of range,
// 6 = decayed; 2/4 (mean motion / semilatus) have no reference slot.
int map_propagate_error(int e) {
  switch (e) {
    case 0: return OK;
    case 1: case 3: return INVALID_ECCENTRICITY;
    case 6: return SATELLITE_DECAYED;
    default: return UNKNOWN;
  }
}

}  // namespace

extern "C" {

// ---- library lifecycle (root.zig:13-23) ----

unsigned int astroz_version(void) {
  // (major << 16) | (minor << 8) | patch — pyproject.toml 0.1.0
  return (0u << 16) | (1u << 8) | 0u;
}

void astroz_init(void) {}    // malloc-backed: nothing to set up
void astroz_deinit(void) {}  // handles are freed individually

// ---- TLE (root.zig:25-44) ----

// Parse "line1\nline2" (an optional name line is tolerated). Returns
// OK and writes a heap handle, or BAD_TLE_LENGTH.
int tle_parse(const char* str, void** out) {
  if (!str || !out) return NULL_POINTER;
  TleRec* rec = static_cast<TleRec*>(std::malloc(sizeof(TleRec)));
  if (!rec) return ALLOC_FAILED;
  long long satnum = 0;
  const long long n = astroz_parse_catalog(
      str, static_cast<long long>(std::strlen(str)), rec->cols, &satnum,
      /*stride=*/1, /*max_sats=*/1);
  if (n != 1) {
    std::free(rec);
    return BAD_TLE_LENGTH;
  }
  rec->satnum = satnum;
  *out = rec;
  return OK;
}

void tle_free(void* h) { std::free(h); }

unsigned int tle_get_satellite_number(void* h) {
  return static_cast<unsigned int>(static_cast<TleRec*>(h)->satnum);
}

// epoch as J2000 seconds (reference Tle.zig:14 semantics)
double tle_get_epoch(void* h) {
  return (static_cast<TleRec*>(h)->cols[COL_EPOCH_JD] - 2451545.0) * 86400.0;
}

double tle_get_inclination(void* h) {  // degrees
  return static_cast<TleRec*>(h)->cols[COL_INCLO] * RAD2DEG;
}

double tle_get_eccentricity(void* h) {
  return static_cast<TleRec*>(h)->cols[COL_ECCO];
}

double tle_get_mean_motion(void* h) {  // rev/day
  return static_cast<TleRec*>(h)->cols[COL_NO_KOZAI] * XPDOTP;
}

// ---- SGP4/SDP4 (root.zig:47-57) ----

// gravity model: 0 = WGS84 (default), 1 = WGS72. Deep-space satellites
// are fully supported (native SDP4) — unlike the reference, which
// returns -10 here.
int sgp4_init(void* tle_h, int grav_model, void** out) {
  if (!tle_h || !out) return NULL_POINTER;
  const TleRec* t = static_cast<TleRec*>(tle_h);
  Sgp4Rec* rec = static_cast<Sgp4Rec*>(std::malloc(sizeof(Sgp4Rec)));
  if (!rec) return ALLOC_FAILED;
  const Grav grav = grav_consts(grav_model);
  const int code = sgp4_init_vec(
      rec->s, grav, t->cols[COL_EPOCH_JD], t->cols[COL_BSTAR],
      t->cols[COL_ECCO], t->cols[COL_ARGPO], t->cols[COL_INCLO],
      t->cols[COL_MO], t->cols[COL_NO_KOZAI], t->cols[COL_NODEO]);
  if (code != OK) {
    std::free(rec);
    return code;
  }
  *out = rec;
  return OK;
}

void sgp4_free(void* h) { std::free(h); }

// Propagate to tsince minutes past epoch; pos km, vel km/s (TEME).
int sgp4_propagate(void* h, double tsince, double* pos, double* vel) {
  if (!h || !pos || !vel) return NULL_POINTER;
  double out6[6];
  const int e = astroz_scalar_sgp4(static_cast<Sgp4Rec*>(h)->s, tsince, out6);
  pos[0] = out6[0]; pos[1] = out6[1]; pos[2] = out6[2];
  vel[0] = out6[3]; vel[1] = out6[4]; vel[2] = out6[5];
  return map_propagate_error(e);
}

// Batch propagation: results[i*6..] = [pos, vel] per time. Returns the
// first error encountered (remaining times still computed; errored
// rows are zero-filled), matching the reference's stop-on-error
// surface without losing the rest of the sweep.
int sgp4_propagate_batch(void* h, const double* times, double* results,
                         unsigned int count) {
  if (!h || !times || !results) return NULL_POINTER;
  const double* s = static_cast<Sgp4Rec*>(h)->s;
  // near-earth batches ride the 8-wide SIMD block path inside
  // astroz_scalar_sgp4_array (61 ns/point vs ~245 scalar); deep-space
  // and decade-horizon arrays fall back to the exact scalar loop there
  std::vector<int> errs(count);
  astroz_scalar_sgp4_array(s, times, (long long)count, results,
                           errs.data());
  int first = OK;
  for (unsigned int i = 0; i < count; ++i) {
    if (errs[i] != 0 && first == OK) first = map_propagate_error(errs[i]);
  }
  return first;
}

// ---- orbital mechanics (root.zig:60-70) ----

struct HohmannResult {
  double semi_major_axis;
  double delta_v1;
  double delta_v2;
  double total_delta_v;
  double transfer_time;
  double transfer_time_days;
};

int orbital_hohmann(double mu, double r1, double r2, HohmannResult* out) {
  if (!out) return NULL_POINTER;
  if (r1 <= 0.0 || r2 <= 0.0) return VALUE_ERROR;
  if (std::fabs(r1 - r2) < 1000.0) return VALUE_ERROR;
  const double a_t = 0.5 * (r1 + r2);
  const double v1 = std::sqrt(mu / r1);
  const double v2 = std::sqrt(mu / r2);
  const double v_p = std::sqrt(mu * (2.0 / r1 - 1.0 / a_t));
  const double v_a = std::sqrt(mu * (2.0 / r2 - 1.0 / a_t));
  const double dv1 = std::fabs(v_p - v1);
  const double dv2 = std::fabs(v2 - v_a);
  const double t = M_PI * std::sqrt(a_t * a_t * a_t / mu);
  out->semi_major_axis = a_t;
  out->delta_v1 = dv1;
  out->delta_v2 = dv2;
  out->total_delta_v = dv1 + dv2;
  out->transfer_time = t;
  out->transfer_time_days = t / 86400.0;
  return OK;
}

double orbital_velocity(double mu, double radius, double sma) {
  if (radius <= 0.0) return -1.0;
  return std::sqrt(mu * (2.0 / radius - 1.0 / sma));
}

double orbital_period(double mu, double sma) {
  if (sma <= 0.0) return -1.0;
  return TWOPI * std::sqrt(sma * sma * sma / mu);
}

double orbital_escape_velocity(double mu, double radius) {
  if (radius <= 0.0) return -1.0;
  return std::sqrt(2.0 * mu / radius);
}

// ---- coordinates (root.zig:73-79) ----

void coords_eci_to_ecef(const double* eci, double gmst, double* ecef) {
  const double sg = std::sin(gmst), cg = std::cos(gmst);
  ecef[0] = cg * eci[0] + sg * eci[1];
  ecef[1] = -sg * eci[0] + cg * eci[1];
  ecef[2] = eci[2];
}

// ECEF km -> [lat deg, lon deg, alt km], WGS-84 (frames.py:39-71
// fixed-iteration scheme; degrees to match the reference surface,
// coordinates.zig:10-12).
void coords_ecef_to_geodetic(const double* ecef, double* lla) {
  const double a = 6378.137;
  const double e2 = 6.69437999014e-3;
  const double x = ecef[0], y = ecef[1], z = ecef[2];
  const double lon = std::atan2(y, x);
  double p = std::sqrt(x * x + y * y);
  if (p <= 1e-12) p = 1e-12;
  double lat = std::atan2(z, p * (1.0 - e2));
  double n = a, alt = 0.0;
  for (int i = 0; i < 10; ++i) {
    const double sin_lat = std::sin(lat);
    n = a / std::sqrt(1.0 - e2 * sin_lat * sin_lat);
    alt = p / std::cos(lat) - n;
    lat = std::atan2(z, p * (1.0 - e2 * n / (n + alt)));
  }
  const double sin_lat = std::sin(lat);
  n = a / std::sqrt(1.0 - e2 * sin_lat * sin_lat);
  alt = p / std::cos(lat) - n;
  lla[0] = lat * RAD2DEG;
  lla[1] = lon * RAD2DEG;
  lla[2] = alt;
}

double coords_julian_to_gmst(double jd) { return gstime(jd); }

}  // extern "C"
