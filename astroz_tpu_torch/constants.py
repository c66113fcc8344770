"""Physical constants, SGP4 gravity models, and celestial body data.

Counterpart of ``astroz_tpu/constants.py``. Values come from the
published WGS-72/WGS-84 standards (Vallado, "Revisiting Spacetrack
Report #3", AIAA 2006-6753) and JPL planetary fact sheets.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

G = 6.6743e-11  # gravitational constant, m^3 kg^-1 s^-2
C_LIGHT = 299792458.0  # speed of light, m/s
PLANCK = 6.62607015e-34  # Planck constant, J s
AU_M = 1.49597871e11  # astronomical unit, m
AU_KM = 1.495978707e8  # astronomical unit, km

J2000_JD = 2451545.0  # Julian date of the J2000 epoch
JULIAN_DAYS_PER_CENTURY = 36525.0

TWO_PI = 2.0 * math.pi
DEG2RAD = math.pi / 180.0
RAD2DEG = 180.0 / math.pi

SECONDS_PER_MINUTE = 60.0
MINUTES_PER_HOUR = 60.0
HOURS_PER_DAY = 24.0
SECONDS_PER_HOUR = 3600.0
SECONDS_PER_DAY = 86400.0
MINUTES_PER_DAY = 1440.0

ARCMINUTES_PER_DEGREE = 60.0
ARCSECONDS_PER_DEGREE = 3600.0
DEGREES_PER_HOUR = 15.0  # right ascension, 360/24

# Solar radiation pressure at 1 AU, N/m^2
SOLAR_PRESSURE = 4.56e-6

# WGS-84 ellipsoid (for geodetic conversion)
WGS84_FLATTENING = 1.0 / 298.257223563
WGS84_ECC_SQ = 2.0 * WGS84_FLATTENING - WGS84_FLATTENING * WGS84_FLATTENING

#: Orbits with period above this need the SDP4 deep-space model.
SGP4_DEEP_SPACE_THRESHOLD_MINUTES = 225.0


@dataclass(frozen=True)
class GravityModel:
    """Earth gravity model constants used by SGP4/SDP4 (units: km, min)."""

    radius_earth_km: float
    mu: float  # km^3/s^2
    j2: float
    j3: float
    j4: float
    xke: float  # sqrt(mu) in units of (earth radii)^1.5 / min
    tumin: float  # minutes per time unit
    j3oj2: float


def _make_gravity(re_km: float, mu: float, j2: float, j3: float, j4: float,
                  xke: Optional[float] = None) -> GravityModel:
    if xke is None:
        xke = 60.0 / math.sqrt(re_km ** 3 / mu)
    return GravityModel(radius_earth_km=re_km, mu=mu, j2=j2, j3=j3, j4=j4,
                        xke=xke, tumin=1.0 / xke, j3oj2=j3 / j2)


#: WGS-72 (the python-sgp4 / spacetrack default)
WGS72 = _make_gravity(6378.135, 398600.8, 0.001082616, -0.00000253881,
                      -0.00000165597)

#: WGS-72 "old" — the historical xke constant from Spacetrack Report #3
WGS72OLD = _make_gravity(6378.135, 398600.79964, 0.001082616,
                         -0.00000253881, -0.00000165597, xke=0.0743669161)

#: WGS-84
WGS84 = _make_gravity(6378.137, 398600.5, 0.00108262998905,
                      -0.00000253215306, -0.00000161098761)


# ---------------------------------------------------------------------------
# Celestial bodies (JPL planetary fact sheet values)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CelestialBody:
    name: str
    mass: float  # kg
    mu: float  # km^3/s^2
    m_fraction_solar_system: float = 0.0
    m_radius: Optional[float] = None  # mean radius, km
    eq_radius: Optional[float] = None  # equatorial radius, km
    p_radius: Optional[float] = None  # polar radius, km
    semi_major_axis: float = 0.0  # heliocentric, km
    perihelion: float = 0.0  # km
    aphelion: float = 0.0  # km
    period: float = 0.0  # orbital period, days
    velocity: float = 0.0  # mean orbital velocity, km/s
    eccentricity: float = 0.0
    inclination: float = 0.0  # to ecliptic, degrees
    oblateness: Optional[float] = None
    j2: float = 0.0
    j3: float = 0.0
    j4: float = 0.0
    sea_level_density: float = 0.0  # kg/m^3
    scale_height: float = 0.0  # m
    rotation_rate: float = 0.0  # rad/s


SUN = CelestialBody(
    name="sun", mass=1.9885e30, mu=1.32712440018e11,
    m_fraction_solar_system=0.998657, eq_radius=695700.0,
    j2=2e-7, sea_level_density=1e-12, scale_height=50000.0,
    rotation_rate=2.865e-6,
)

MERCURY = CelestialBody(
    name="mercury", mass=3.3011e23, mu=2.2032e4,
    m_fraction_solar_system=1.65789e-7, m_radius=2439.4, eq_radius=2440.53,
    p_radius=2438.26, semi_major_axis=5.7909e7, perihelion=4.6001e7,
    aphelion=6.9818e7, period=87.969, velocity=47.36, eccentricity=0.20564,
    inclination=7.005, j2=6e-5, rotation_rate=1.24e-6,
)

VENUS = CelestialBody(
    name="venus", mass=4.8675e24, mu=3.24859e5,
    m_fraction_solar_system=2.44455e-6, m_radius=6051.8, eq_radius=6051.8,
    p_radius=6051.8, semi_major_axis=1.08209e8, perihelion=1.07477e8,
    aphelion=1.08939e8, period=224.701, velocity=35.02,
    eccentricity=0.00678, inclination=3.395, j2=4.458e-6,
    sea_level_density=65.0, scale_height=15900.0, rotation_rate=-2.99e-7,
)

EARTH = CelestialBody(
    name="earth", mass=5.97219e24, mu=3.986004418e5,
    m_fraction_solar_system=3.0034e-6, m_radius=6371.0084,
    eq_radius=6378.137, p_radius=6356.752, semi_major_axis=1.49598e8,
    perihelion=1.47095e8, aphelion=1.52100e8, period=365.256,
    velocity=29.78, eccentricity=0.0167, inclination=0.0,
    oblateness=0.003353, j2=1.08262668e-3, j3=-2.53215306e-6,
    j4=-1.61098761e-6, sea_level_density=1.225, scale_height=8500.0,
    rotation_rate=7.2921159e-5,
)

MOON = CelestialBody(
    name="moon", mass=7.342e22, mu=4.9028e3,
    m_fraction_solar_system=3.69396e-8, m_radius=1737.4, eq_radius=1738.1,
    p_radius=1736.0, semi_major_axis=3.844e5, perihelion=3.633e5,
    aphelion=4.055e5, period=27.322, velocity=1.022, eccentricity=0.0549,
    inclination=5.145, j2=2.027e-4, rotation_rate=2.6617e-6,
)

MARS = CelestialBody(
    name="mars", mass=6.4171e23, mu=4.282837e4,
    m_fraction_solar_system=3.22715e-7, m_radius=3389.5, eq_radius=3396.19,
    p_radius=3376.2, semi_major_axis=2.27956e8, perihelion=2.06650e8,
    aphelion=2.49261e8, period=686.980, velocity=24.07,
    eccentricity=0.0935, inclination=1.850, oblateness=0.00589,
    j2=1.96045e-3, sea_level_density=0.020, scale_height=11100.0,
    rotation_rate=7.088e-5,
)

JUPITER = CelestialBody(
    name="jupiter", mass=1.8982e27, mu=1.26686534e8,
    m_fraction_solar_system=9.54792e-4, m_radius=69911.0, eq_radius=71492.0,
    p_radius=66854.0, semi_major_axis=7.78479e8, perihelion=7.40595e8,
    aphelion=8.16363e8, period=4332.589, velocity=13.06,
    eccentricity=0.0487, inclination=1.303, oblateness=0.06487,
    j2=1.4736e-2, rotation_rate=1.7585e-4,
)

SATURN = CelestialBody(
    name="saturn", mass=5.6834e26, mu=3.7931187e7,
    m_fraction_solar_system=2.85886e-4, m_radius=58232.0, eq_radius=60268.0,
    p_radius=54364.0, semi_major_axis=1.43205e9, perihelion=1.35755e9,
    aphelion=1.50653e9, period=10759.22, velocity=9.68,
    eccentricity=0.0520, inclination=2.485, oblateness=0.09796,
    j2=1.6298e-2, rotation_rate=1.6379e-4,
)

URANUS = CelestialBody(
    name="uranus", mass=8.6810e25, mu=5.793939e6,
    m_fraction_solar_system=4.36624e-5, m_radius=25362.0, eq_radius=25559.0,
    p_radius=24973.0, semi_major_axis=2.86725e9, perihelion=2.73289e9,
    aphelion=3.00139e9, period=30685.4, velocity=6.80,
    eccentricity=0.0469, inclination=0.773, oblateness=0.02293,
    j2=3.34343e-3, rotation_rate=-1.012e-4,
)

NEPTUNE = CelestialBody(
    name="neptune", mass=1.02413e26, mu=6.836529e6,
    m_fraction_solar_system=5.15138e-5, m_radius=24622.0, eq_radius=24764.0,
    p_radius=24341.0, semi_major_axis=4.51495e9, perihelion=4.47105e9,
    aphelion=4.55886e9, period=60189.0, velocity=5.43,
    eccentricity=0.0097, inclination=1.770, oblateness=0.01708,
    j2=3.411e-3, rotation_rate=1.083e-4,
)

PLUTO = CelestialBody(
    name="pluto", mass=1.303e22, mu=8.71e2,
    m_fraction_solar_system=6.55352e-9, m_radius=1188.3, eq_radius=1188.3,
    p_radius=1188.3, semi_major_axis=5.90638e9, perihelion=4.43682e9,
    aphelion=7.37593e9, period=90560.0, velocity=4.67,
    eccentricity=0.2444, inclination=17.16, rotation_rate=-1.139e-5,
)

BODIES = {
    b.name: b
    for b in (SUN, MERCURY, VENUS, EARTH, MOON, MARS, JUPITER, SATURN,
              URANUS, NEPTUNE, PLUTO)
}
