// Shared packed element-vector layout for the native scalar SGP4/SDP4
// engine. MUST match SCALAR_FIELDS in astroz_tpu_torch/native/__init__.py
// (packed by api.Satrec) — both consumers (scalar_sgp4.cpp, and
// scalar_ext.c via the double* ABI) agree on this layout.
#ifndef ASTROZ_SCALAR_FIELDS_H
#define ASTROZ_SCALAR_FIELDS_H

enum F {
  RADIUSEARTHKM, XKE, J2, J3OJ2,
  MO, MDOT, ARGPO, ARGPDOT, NODEO, NODEDOT, NODECF,
  CC1, BSTAR, CC4, T2COF, ISIMP, OMGCOF, ETA,
  XMCOF, DELMO, SINMAO, D2, D3, D4, CC5,
  T3COF, T4COF, T5COF, NO_UNKOZAI, ECCO, INCLO,
  DEEP, AYCOF, XLCOF, CON41, X1MTH2, X7THM1,
  GSTO, DEDT, DIDT, DOMDT, DNODT, DMDT, IREZ,
  XLAMO, DEL1, DEL2, DEL3, XFACT,
  D2201, D2211, D3210, D3222, D4410, D4422,
  D5220, D5232, D5421, D5433,
  ZMOS, ZMOL,
  SE2, SE3, SI2, SI3, SL2, SL3, SL4,
  SGH2, SGH3, SGH4, SH2, SH3,
  EE2, E3, XI2, XI3, XL2, XL3, XL4,
  XGH2, XGH3, XGH4, XH2, XH3,
  PEO, PINCO, PLO, PGHO, PHO,
  N_FIELDS
};

#ifdef __cplusplus
extern "C" {
#endif
// scalar_sgp4.cpp: propagate one satellite to tsince minutes past
// epoch over a packed element vector in the layout above. Writes
// out6 = [rx, ry, rz, vx, vy, vz] (km, km/s); returns the python-sgp4
// error code (0 = ok).
int astroz_scalar_sgp4(const double* s, double tsince, double* out6);
long long astroz_scalar_sgp4_array(const double* s, const double* tsince,
                                   long long n, double* out, int* err);
#ifdef __cplusplus
}
#endif

#endif  // ASTROZ_SCALAR_FIELDS_H
