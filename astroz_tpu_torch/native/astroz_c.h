/* astroz_tpu_torch C ABI — public header for non-Python consumers.
 *
 * Mirrors the reference's C API surface (src/c_api/root.zig:13-79)
 * with identical error-code values (src/c_api/error.zig). Implemented
 * in c_api.cpp and exported from the port's native library,
 * native/build/libastroz_torch_native_<hash>.so
 * (astroz_tpu_torch.native.library_path()).
 *
 * Usage:
 *   void *tle, *sat;
 *   tle_parse("1 25544U ...\n2 25544 ...", &tle);
 *   sgp4_init(tle, 0, &sat);            // 0 = WGS84, 1 = WGS72
 *   double pos[3], vel[3];
 *   sgp4_propagate(sat, 360.0, pos, vel); // t in minutes past epoch
 *   sgp4_free(sat); tle_free(tle);
 *
 * Unlike the reference, deep-space satellites are supported natively
 * (SDP4): ASTROZ_ERR_DEEP_SPACE_NOT_SUPPORTED is never returned.
 */
#ifndef ASTROZ_C_H
#define ASTROZ_C_H

#ifdef __cplusplus
extern "C" {
#endif

/* Error codes (values match the reference ABI). */
enum {
  ASTROZ_OK = 0,
  ASTROZ_ERR_BAD_TLE_LENGTH = -1,
  ASTROZ_ERR_BAD_CHECKSUM = -2,
  ASTROZ_ERR_DEEP_SPACE_NOT_SUPPORTED = -10, /* never emitted here */
  ASTROZ_ERR_INVALID_ECCENTRICITY = -11,
  ASTROZ_ERR_SATELLITE_DECAYED = -12,
  ASTROZ_ERR_VALUE_ERROR = -20,
  ASTROZ_ERR_ALLOC_FAILED = -100,
  ASTROZ_ERR_NULL_POINTER = -101,
  ASTROZ_ERR_NOT_INITIALIZED = -102,
  ASTROZ_ERR_UNKNOWN = -999
};

/* (major << 16) | (minor << 8) | patch */
unsigned int astroz_version(void);
void astroz_init(void);
void astroz_deinit(void);

/* TLE: parse "line1\nline2" (3LE name line tolerated). */
int tle_parse(const char* str, void** out);
void tle_free(void* handle);
unsigned int tle_get_satellite_number(void* handle);
double tle_get_epoch(void* handle);        /* J2000 seconds */
double tle_get_inclination(void* handle);  /* degrees */
double tle_get_eccentricity(void* handle);
double tle_get_mean_motion(void* handle);  /* rev/day */

/* SGP4/SDP4. grav_model: 0 = WGS84, 1 = WGS72. */
int sgp4_init(void* tle_handle, int grav_model, void** out);
void sgp4_free(void* handle);
/* tsince minutes past epoch; pos km, vel km/s (TEME). */
int sgp4_propagate(void* handle, double tsince, double* pos, double* vel);
/* results[i*6..i*6+5] = [px, py, pz, vx, vy, vz] per time. */
int sgp4_propagate_batch(void* handle, const double* times, double* results,
                         unsigned int count);

/* Orbital mechanics (km, km/s, s). */
typedef struct {
  double semi_major_axis;
  double delta_v1;
  double delta_v2;
  double total_delta_v;
  double transfer_time;
  double transfer_time_days;
} AstrozHohmannResult;

int orbital_hohmann(double mu, double r1, double r2,
                    AstrozHohmannResult* out);
double orbital_velocity(double mu, double radius, double sma);
double orbital_period(double mu, double sma);
double orbital_escape_velocity(double mu, double radius);

/* Coordinates. */
void coords_eci_to_ecef(const double* eci3, double gmst, double* ecef3);
/* ECEF km -> [lat deg, lon deg, alt km] (WGS-84). */
void coords_ecef_to_geodetic(const double* ecef3, double* lla3);
double coords_julian_to_gmst(double jd);

#ifdef __cplusplus
}
#endif

#endif /* ASTROZ_C_H */
