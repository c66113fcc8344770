"""Equatorial coordinates: RA/Dec types and star precession.

Counterpart of ``astroz_tpu/equatorial.py`` (the reference's
``src/EquatorialCoordinateSystem.zig``: Declination / RightAscension in
d:m:s / h:m:s with angular conversions; precession from J2000 by the
M/N precession-constant method, the standard low-precision formulation
from Duffett-Smith / Meeus). Host-side Python.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

from .constants import (ARCSECONDS_PER_DEGREE, DEG2RAD, DEGREES_PER_HOUR,
                        J2000_JD, JULIAN_DAYS_PER_CENTURY, RAD2DEG)


@dataclass
class Declination:
    degrees: int
    arcminutes: int
    arcseconds: float

    def to_degrees(self) -> float:
        # any negative field carries the sign (|dec| < 1 deg has
        # degrees == 0, the classic sexagesimal negative-zero case)
        neg = (self.degrees < 0 or self.arcminutes < 0
               or self.arcseconds < 0)
        mag = (abs(self.degrees) + abs(self.arcminutes) / 60.0
               + abs(self.arcseconds) / 3600.0)
        return -mag if neg else mag

    def to_radians(self) -> float:
        return self.to_degrees() * DEG2RAD

    @classmethod
    def from_degrees(cls, deg: float) -> "Declination":
        d = abs(deg)
        whole = int(d)
        m = int((d - whole) * 60.0)
        s = ((d - whole) * 60.0 - m) * 60.0
        if deg < 0:
            # push the sign onto the leading nonzero field so
            # sub-degree south declinations survive the round trip
            if whole:
                whole = -whole
            elif m:
                m = -m
            else:
                s = -s
        return cls(degrees=whole, arcminutes=m, arcseconds=s)


@dataclass
class RightAscension:
    hours: int
    minutes: int
    seconds: float

    def to_degrees(self) -> float:
        return (self.hours + self.minutes / 60.0
                + self.seconds / 3600.0) * DEGREES_PER_HOUR

    def to_radians(self) -> float:
        return self.to_degrees() * DEG2RAD

    @classmethod
    def from_degrees(cls, deg: float) -> "RightAscension":
        h = (deg % 360.0) / DEGREES_PER_HOUR
        whole = int(h)
        m = int((h - whole) * 60.0)
        s = ((h - whole) * 60.0 - m) * 60.0
        return cls(hours=whole, minutes=m, seconds=s)


def precess(ra: RightAscension, dec: Declination,
            jd: float) -> Tuple[RightAscension, Declination]:
    """Precess J2000.0 coordinates to the epoch of ``jd`` using the
    M/N precession constants (EquatorialCoordinateSystem.zig:24-56):

        M = 3.07496 + 0.00186 T   [s/yr]  (RA)
        N = 20.0431 - 0.0085 T    [\"/yr] (Dec)
    """
    t_years = (jd - J2000_JD) / 365.25
    t_cent = (jd - J2000_JD) / JULIAN_DAYS_PER_CENTURY

    m_s = 3.07496 + 0.00186 * t_cent          # seconds of RA per year
    n_as = 20.0431 - 0.0085 * t_cent          # arcsec per year

    ra_deg = ra.to_degrees()
    dec_deg = dec.to_degrees()
    ra_rad = ra_deg * DEG2RAD
    dec_rad = dec_deg * DEG2RAD

    delta_ra_s = (m_s + n_as / 15.0 * math.sin(ra_rad)
                  * math.tan(dec_rad)) * t_years  # seconds of time
    delta_dec_as = n_as * math.cos(ra_rad) * t_years

    ra_new = ra_deg + delta_ra_s / 3600.0 * DEGREES_PER_HOUR
    dec_new = dec_deg + delta_dec_as / ARCSECONDS_PER_DEGREE
    return (RightAscension.from_degrees(ra_new % 360.0),
            Declination.from_degrees(dec_new))
