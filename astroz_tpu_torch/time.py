"""Calendar, Julian-date and sidereal-time helpers.

Counterpart of ``astroz_tpu/time.py``. The calendar helpers are plain
Python floats (python-sgp4's ``jday``/``days2mdhms`` conventions, so
parsed epochs are bit-identical to the JAX package's); ``gstime`` takes
a numpy array or a torch tensor and computes in its dtype.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .constants import DEG2RAD, TWO_PI

_DAYS_IN_MONTH = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def is_leap_year(year: int) -> bool:
    return (year % 4 == 0 and year % 100 != 0) or (year % 400 == 0)


def doy_to_month_day(year: int, doy: int) -> Tuple[int, int]:
    """Day-of-year (1-based) -> (month, day)."""
    days = list(_DAYS_IN_MONTH)
    if is_leap_year(year):
        days[1] = 29
    month = 1
    remaining = doy
    for dim in days:
        if remaining <= dim:
            break
        remaining -= dim
        month += 1
    return month, remaining


def month_day_to_doy(year: int, month: int, day: int) -> int:
    days = list(_DAYS_IN_MONTH)
    if is_leap_year(year):
        days[1] = 29
    return sum(days[: month - 1]) + day


def jday(year: int, mon: int, day: int, hr: int, minute: int,
         sec: float) -> Tuple[float, float]:
    """Julian date split as (jd at the preceding midnight, day fraction),
    python-sgp4's ``jday`` convention."""
    jd = (367.0 * year
          - math.floor((7 * (year + math.floor((mon + 9) / 12.0))) * 0.25)
          + math.floor(275 * mon / 9.0)
          + day + 1721013.5)
    fr = (sec + minute * 60.0 + hr * 3600.0) / 86400.0
    return jd, fr


def days2mdhms(year: int, days: float
               ) -> Tuple[int, int, int, int, float]:
    """Fractional day-of-year -> (month, day, hour, minute, second)."""
    doy = int(days)
    fraction = days - doy
    month, day = doy_to_month_day(year, doy)
    temp = fraction * 24.0
    hr = int(temp)
    temp = (temp - hr) * 60.0
    minute = int(temp)
    sec = (temp - minute) * 60.0
    return month, day, hr, minute, sec


def tle_year(two_digit_year: int) -> int:
    """TLE 2-digit year with the 57-pivot century rule."""
    return two_digit_year + (1900 if two_digit_year >= 57 else 2000)


def epoch_to_jd(epochyr: int, epochdays: float) -> Tuple[float, float]:
    """TLE epoch (2-digit year, fractional DOY) -> (jd, fr) split."""
    year = tle_year(epochyr)
    mon, day, hr, minute, sec = days2mdhms(year, epochdays)
    return jday(year, mon, day, hr, minute, sec)


def jd_to_datetime_parts(jd: float) -> Tuple[int, int, int, int, int, float]:
    """Julian date -> (year, month, day, hour, minute, second)
    (Fliegel-Van Flandern inverse)."""
    jd05 = jd + 0.5
    z = math.floor(jd05)
    f = jd05 - z
    if z < 2299161:
        a = z
    else:
        alpha = math.floor((z - 1867216.25) / 36524.25)
        a = z + 1 + alpha - math.floor(alpha / 4)
    b = a + 1524
    c = math.floor((b - 122.1) / 365.25)
    d = math.floor(365.25 * c)
    e = math.floor((b - d) / 30.6001)
    day_frac = b - d - math.floor(30.6001 * e) + f
    day = int(day_frac)
    frac = day_frac - day
    month = int(e - 1 if e < 14 else e - 13)
    year = int(c - 4716 if month > 2 else c - 4715)
    hours = frac * 24.0
    hr = int(hours)
    minutes = (hours - hr) * 60.0
    minute = int(minutes)
    sec = (minutes - minute) * 60.0
    return year, month, day, hr, minute, sec


def iso8601_to_jd(s: str) -> Tuple[float, float]:
    """CCSDS/ISO-8601 epoch string (``YYYY-MM-DDTHH:MM:SS[.f][Z]`` or the
    day-of-year form ``YYYY-DDDTHH:MM:SS``) -> (jd, fr)."""
    s = s.strip().rstrip("Zz")
    date_part, _, time_part = s.partition("T")
    fields = date_part.split("-")
    if len(fields) == 3:
        year, mon, day = int(fields[0]), int(fields[1]), int(fields[2])
    elif len(fields) == 2:
        year = int(fields[0])
        mon, day = doy_to_month_day(year, int(fields[1]))
    else:
        raise ValueError(f"unparseable ISO-8601 date: {s!r}")
    hr = minute = 0
    sec = 0.0
    if time_part:
        tf = time_part.split(":")
        hr = int(tf[0])
        if len(tf) > 1:
            minute = int(tf[1])
        if len(tf) > 2:
            sec = float(tf[2])
    return jday(year, mon, day, hr, minute, sec)


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


def gstime_scalar(jdut1: float) -> float:
    """GMST in radians of one Julian date, in Python floats."""
    tut1 = (jdut1 - 2451545.0) / 36525.0
    temp = (-6.2e-6 * tut1 ** 3 + 0.093104 * tut1 ** 2
            + (876600.0 * 3600.0 + 8640184.812866) * tut1 + 67310.54841)
    temp = math.fmod(temp * DEG2RAD / 240.0, TWO_PI)
    if temp < 0.0:
        temp += TWO_PI
    return temp
