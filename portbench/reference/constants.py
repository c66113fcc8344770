"""Constants of the reference: WGS-72 as python-sgp4 uses it, and GMST."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

TWO_PI = 2.0 * math.pi
DEG2RAD = math.pi / 180.0
MINUTES_PER_DAY = 1440.0

#: orbits with a period of this many minutes or more take SDP4
SGP4_DEEP_SPACE_THRESHOLD_MINUTES = 225.0


@dataclass(frozen=True)
class GravityModel:
    """Earth gravity constants of SGP4 (km, minutes)."""

    radius_earth_km: float
    mu: float  # km^3/s^2
    j2: float
    j3: float
    j4: float
    xke: float  # sqrt(mu) in (earth radii)^1.5 / min
    j3oj2: float


def _gravity(re_km, mu, j2, j3, j4):
    return GravityModel(radius_earth_km=re_km, mu=mu, j2=j2, j3=j3, j4=j4,
                        xke=60.0 / math.sqrt(re_km ** 3 / mu), j3oj2=j3 / j2)


#: WGS-72, the python-sgp4 and Space-Track default
WGS72 = _gravity(6378.135, 398600.8, 0.001082616, -0.00000253881,
                 -0.00000165597)


def gstime(jdut1):
    """Greenwich mean sidereal time in radians (IAU-82 polynomial) of a
    numpy array or a torch tensor, in its dtype."""
    tut1 = (jdut1 - 2451545.0) / 36525.0
    temp = (-6.2e-6 * tut1 * tut1 * tut1
            + 0.093104 * tut1 * tut1
            + (876600.0 * 3600.0 + 8640184.812866) * tut1
            + 67310.54841)
    if isinstance(temp, torch.Tensor):
        temp = torch.remainder(temp * DEG2RAD / 240.0, TWO_PI)
        return torch.where(temp < 0.0, temp + TWO_PI, temp)
    temp = np.remainder(temp * DEG2RAD / 240.0, TWO_PI)
    return np.where(temp < 0.0, temp + TWO_PI, temp)
