"""Two-line element text to f64 columns, by the standard fixed columns."""

from __future__ import annotations

import math

import numpy as np

from .constants import DEG2RAD, TWO_PI

_XPDOTP = 1440.0 / TWO_PI  # rev/day per rad/min
_DAYS_IN_MONTH = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _implied_decimal(field: str) -> float:
    """'-11606-4' -> -0.11606e-4; blank -> 0."""
    field = field.strip()
    if not field:
        return 0.0
    sign = -1.0 if field[0] == "-" else 1.0
    if field[0] in "+-":
        field = field[1:]
    mant, exp = field[:-2], int(field[-2:])
    return sign * float("0." + mant.strip()) * 10.0 ** exp


def _jday(year, mon, day, hr, minute, sec):
    jd = (367.0 * year
          - math.floor((7 * (year + math.floor((mon + 9) / 12.0))) * 0.25)
          + math.floor(275 * mon / 9.0) + day + 1721013.5)
    return jd, (sec + minute * 60.0 + hr * 3600.0) / 86400.0


def epoch_jd(epochyr: int, epochdays: float) -> float:
    """TLE epoch (two-digit year with the 57 pivot, fractional day of the
    year) -> Julian date, as python-sgp4 splits and sums it."""
    year = epochyr + (1900 if epochyr >= 57 else 2000)
    days = list(_DAYS_IN_MONTH)
    if (year % 4 == 0 and year % 100 != 0) or year % 400 == 0:
        days[1] = 29
    doy = int(epochdays)
    mon, day = 1, doy
    for dim in days:
        if day <= dim:
            break
        day -= dim
        mon += 1
    t = (epochdays - doy) * 24.0
    hr = int(t)
    t = (t - hr) * 60.0
    minute = int(t)
    jd, fr = _jday(year, mon, day, hr, minute, (t - minute) * 60.0)
    return jd + fr


def parse_catalog(text: str) -> dict:
    """Columns of every two-line record of ``text``: ``satnum`` (int64),
    ``epoch_jd``, ``no_kozai`` (rad/min), ``ecco``, ``inclo``, ``nodeo``,
    ``argpo``, ``mo`` (rad) and ``bstar``, f64 numpy arrays in the order
    of the text. A line pair that is not a TLE raises."""
    lines = [ln.rstrip() for ln in text.splitlines() if ln.strip()]
    if len(lines) % 2:
        raise ValueError("TLE text has an odd number of lines")
    rows = []
    for l1, l2 in zip(lines[0::2], lines[1::2]):
        if l1[0] != "1" or l2[0] != "2" or l1[2:7] != l2[2:7]:
            raise ValueError(f"not a TLE line pair: {l1!r} / {l2!r}")
        rows.append((
            int(l1[2:7]), epoch_jd(int(l1[18:20]), float(l1[20:32])),
            float(l2[52:63]) / _XPDOTP, float("0." + l2[26:33].strip()),
            float(l2[8:16]) * DEG2RAD, float(l2[17:25]) * DEG2RAD,
            float(l2[34:42]) * DEG2RAD, float(l2[43:51]) * DEG2RAD,
            _implied_decimal(l1[53:61])))
    names = ("satnum", "epoch_jd", "no_kozai", "ecco", "inclo", "nodeo",
             "argpo", "mo", "bstar")
    cols = list(zip(*rows)) if rows else [()] * len(names)
    out = {n: np.asarray(c, np.float64) for n, c in zip(names, cols)}
    out["satnum"] = out["satnum"].astype(np.int64)
    return out
