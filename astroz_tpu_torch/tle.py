"""TLE and OMM parsing into struct-of-arrays numpy columns.

Counterpart of ``astroz_tpu/tle.py``: fixed-column TLE lines, Alpha-5
satellite numbers, the assumed-decimal fields, 2- and 3-line catalog
text, and OMM (CCSDS 502.0-B-3) JSON, on the host. The result is a
:class:`TleArrays` of f64 numpy columns that the element init consumes.
Catalog text goes to columns through the C++ bulk parser
(``native/tle_parser.cpp``, :meth:`TleArrays.from_text`); the Python
parser here is its plain version and gives the same columns bit for
bit, and it parses what the bulk parser does not: names, OMM, one
record at a time.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import native
from .constants import DEG2RAD, TWO_PI
from .time import (epoch_to_jd, iso8601_to_jd, jd_to_datetime_parts,
                   month_day_to_doy, tle_year)


class TleError(ValueError):
    pass


# Alpha-5: first satnum character may be a letter (I and O skipped).
_ALPHA5 = {c: i + 10 for i, c in enumerate("ABCDEFGHJKLMNPQRSTUVWXYZ")}
_ALPHA5_REV = {v: k for k, v in _ALPHA5.items()}

_XPDOTP = 1440.0 / TWO_PI  # rev/day -> rad/min conversion divisor


def parse_satnum(field: str) -> int:
    field = field.strip()
    if not field:
        raise TleError("empty satellite number")
    c = field[0]
    if c.isalpha():
        try:
            hi = _ALPHA5[c.upper()]
        except KeyError:
            raise TleError(f"invalid Alpha-5 character {c!r}") from None
        return hi * 10000 + int(field[1:])
    return int(field)


def _parse_implied_decimal(field: str) -> float:
    """Decode assumed-decimal fields like '-11606-4' -> -0.11606e-4."""
    field = field.strip()
    if not field:
        return 0.0
    sign = 1.0
    idx = 0
    if field[0] in "+-":
        sign = -1.0 if field[0] == "-" else 1.0
        idx = 1
    exp = 0
    mantissa_str = field[idx:]
    for k in range(len(mantissa_str) - 1, -1, -1):
        if mantissa_str[k] in "+-":
            exp = int(mantissa_str[k:])
            mantissa_str = mantissa_str[:k]
            break
    if not mantissa_str.strip():
        return 0.0
    mantissa = float("0." + mantissa_str.strip())
    return sign * mantissa * (10.0 ** exp)


@dataclass
class Tle:
    """One parsed TLE record. Angles in radians, mean motion in rad/min."""

    satnum: int
    classification: str
    intldesg: str
    epochyr: int  # two-digit
    epochdays: float
    ndot: float  # rad/min^2
    nddot: float  # rad/min^3
    bstar: float
    ephtype: int
    elnum: int
    inclo: float
    nodeo: float
    ecco: float
    argpo: float
    mo: float
    no_kozai: float  # rad/min
    revnum: int
    jdsatepoch: float = 0.0
    jdsatepochF: float = 0.0
    name: Optional[str] = None
    line1: str = ""
    line2: str = ""

    @property
    def epoch_jd(self) -> float:
        return self.jdsatepoch + self.jdsatepochF

    @property
    def epoch_year(self) -> int:
        return tle_year(self.epochyr)


def format_satnum(satnum: int) -> str:
    """5-character satellite number field, Alpha-5 above 99999."""
    if satnum < 100000:
        return f"{satnum:5d}"
    hi, lo = divmod(satnum, 10000)
    try:
        return f"{_ALPHA5_REV[hi]}{lo:04d}"
    except KeyError:
        raise TleError(f"satnum {satnum} out of Alpha-5 range") from None


def checksum(line: str) -> int:
    """TLE modulo-10 checksum over the first 68 columns (digits count
    their value, '-' counts 1)."""
    s = 0
    for c in line[:68]:
        if c.isdigit():
            s += int(c)
        elif c == "-":
            s += 1
    return s % 10


def _format_implied_decimal(x: float) -> str:
    """Inverse of :func:`_parse_implied_decimal`: the 8-char
    ``sMMMMMsE`` field (e.g. -0.11606e-4 -> '-11606-4')."""
    if x == 0.0:
        return " 00000+0"
    sign = "-" if x < 0 else " "
    ax = abs(x)
    exp = int(np.floor(np.log10(ax))) + 1
    mant = int(round(ax / 10.0 ** exp * 1e5))
    if mant >= 100000:  # rounding bumped the exponent
        mant //= 10
        exp += 1
    if exp < -9 or mant == 0:
        # below the field's smallest magnitude: the standard zero field
        return " 00000+0"
    if exp > 9:
        raise TleError(f"value {x} not representable in a TLE field")
    return f"{sign}{mant:05d}{exp:+d}"


def format_lines(*, satnum: int, epoch_jd: float, ecco: float,
                 inclo_deg: float, nodeo_deg: float, argpo_deg: float,
                 mo_deg: float, no_rev_day: float, bstar: float = 0.0,
                 ndot_rev_day2: float = 0.0, nddot_rev_day3: float = 0.0,
                 classification: str = "U", intldesg: str = "",
                 elnum: int = 999, revnum: int = 0
                 ) -> Tuple[str, str]:
    """Format a TLE line pair. Angles in degrees, mean motion in rev/day,
    ndot as the printed half-value in rev/day^2. The output round-trips
    through :func:`parse_lines`."""
    y, mo_, d, hh, mm, ss = jd_to_datetime_parts(epoch_jd)
    doy = month_day_to_doy(y, mo_, d)
    frac = (hh * 3600.0 + mm * 60.0 + ss) / 86400.0
    epoch_field = f"{y % 100:02d}{doy + frac:012.8f}"

    nd = ndot_rev_day2
    # range-check after rounding: 0.999999996 formats as '1.00000000'
    nd_str = f"{abs(nd):.8f}"
    if nd_str[0] != "0":
        raise TleError("|ndot| must be < 1 rev/day^2 in TLE format")
    ndot_field = ("-" if nd < 0 else " ") + nd_str[1:]

    l1 = (f"1 {format_satnum(satnum)}{classification[:1] or 'U'} "
          f"{intldesg:<8.8s} {epoch_field} {ndot_field} "
          f"{_format_implied_decimal(nddot_rev_day3)} "
          f"{_format_implied_decimal(bstar)} 0 {elnum % 10000:4d}")
    l1 += str(checksum(l1))

    if not 0.0 <= ecco < 1.0:
        raise TleError(f"ecco {ecco} outside [0, 1)")
    ecc_str = f"{ecco:.7f}"
    if ecc_str[0] != "0":
        raise TleError(f"ecco {ecco} rounds to 1.0 at TLE precision")
    ecc_field = ecc_str[2:9]
    l2 = (f"2 {format_satnum(satnum)} {inclo_deg % 360.0:8.4f} "
          f"{nodeo_deg % 360.0:8.4f} {ecc_field} {argpo_deg % 360.0:8.4f} "
          f"{mo_deg % 360.0:8.4f} {no_rev_day:11.8f}{revnum % 100000:5d}")
    l2 += str(checksum(l2))
    if len(l1) != 69 or len(l2) != 69:
        raise TleError(
            f"internal: formatted lengths {len(l1)}/{len(l2)} != 69")
    return l1, l2


def parse_lines(line1: str, line2: str, name: Optional[str] = None) -> Tle:
    """Parse a TLE line pair using the standard fixed columns."""
    line1 = line1.rstrip("\r\n")
    line2 = line2.rstrip("\r\n")
    if len(line1) < 64 or line1[0] != "1":
        raise TleError(f"bad TLE line 1: {line1!r}")
    if len(line2) < 64 or line2[0] != "2":
        raise TleError(f"bad TLE line 2: {line2!r}")

    satnum = parse_satnum(line1[2:7])
    satnum2 = parse_satnum(line2[2:7])
    if satnum != satnum2:
        raise TleError(
            f"satnum mismatch between lines: {satnum} != {satnum2}")

    classification = line1[7] if len(line1) > 7 else "U"
    intldesg = line1[9:17].strip()
    epochyr = int(line1[18:20])
    epochdays = float(line1[20:32])
    ndot = float(line1[33:43]) / (_XPDOTP * 1440.0)
    nddot = _parse_implied_decimal(line1[44:52]) / (_XPDOTP * 1440.0 * 1440.0)
    bstar = _parse_implied_decimal(line1[53:61])
    ephtype = int(line1[62]) if line1[62].strip() else 0
    elnum = int(line1[64:68]) if line1[64:68].strip() else 0

    inclo = float(line2[8:16]) * DEG2RAD
    nodeo = float(line2[17:25]) * DEG2RAD
    ecco = float("0." + line2[26:33].strip())
    argpo = float(line2[34:42]) * DEG2RAD
    mo = float(line2[43:51]) * DEG2RAD
    no_kozai = float(line2[52:63]) / _XPDOTP
    revnum = int(line2[63:68]) if line2[63:68].strip() else 0

    jd, fr = epoch_to_jd(epochyr, epochdays)
    return Tle(
        satnum=satnum, classification=classification, intldesg=intldesg,
        epochyr=epochyr, epochdays=epochdays, ndot=ndot, nddot=nddot,
        bstar=bstar, ephtype=ephtype, elnum=elnum, inclo=inclo, nodeo=nodeo,
        ecco=ecco, argpo=argpo, mo=mo, no_kozai=no_kozai, revnum=revnum,
        jdsatepoch=jd, jdsatepochF=fr, name=name, line1=line1, line2=line2,
    )


def parse(text: str) -> Tle:
    """Parse a single TLE from free-form text (tolerates names/blank lines)."""
    tles = list(iter_tles(text))
    if not tles:
        raise TleError("no TLE found in text")
    return tles[0]


def iter_tles(text: str) -> Iterator[Tle]:
    """Stream TLEs out of 2-line or 3-line (named) catalog text.

    Tolerates CRLF, blank lines, leading whitespace and orphan lines; a
    record that fails to parse is skipped.
    """
    pending_name: Optional[str] = None
    pending_line1: Optional[str] = None
    for raw in text.splitlines():
        line = raw.rstrip("\r\n ").lstrip()
        if not line:
            continue
        if line.startswith("1 ") and len(line) >= 64:
            pending_line1 = raw.strip()
        elif line.startswith("2 ") and len(line) >= 64 and pending_line1:
            try:
                yield parse_lines(pending_line1, raw.strip(),
                                  name=pending_name)
            except (TleError, ValueError):
                pass
            pending_name = None
            pending_line1 = None
        elif line.startswith("2 ") and len(line) >= 64:
            # orphan line 2 (truncated record): skip it, never take it
            # as the next satellite's name
            pending_name = None
            pending_line1 = None
        else:
            pending_name = line[2:].strip() if line.startswith("0 ") else line
            pending_line1 = None


def tle_from_omm(record: dict) -> Tle:
    """Build a :class:`Tle` from one OMM JSON record."""
    jd, fr = iso8601_to_jd(str(record["EPOCH"]))
    year, mon, day, hr, minute, sec = jd_to_datetime_parts(jd + fr)
    doy = month_day_to_doy(year, mon, day)
    epochdays = (doy + hr / 24.0 + minute / 1440.0 + sec / 86400.0)

    mean_motion = float(record["MEAN_MOTION"])  # rev/day
    ndot = float(record.get("MEAN_MOTION_DOT", 0.0))
    nddot = float(record.get("MEAN_MOTION_DDOT", 0.0))
    satnum_raw = record.get("NORAD_CAT_ID", 0)
    try:
        satnum = int(satnum_raw)
    except (TypeError, ValueError):
        satnum = parse_satnum(str(satnum_raw))

    return Tle(
        satnum=satnum,
        classification=str(record.get("CLASSIFICATION_TYPE", "U")),
        intldesg=str(record.get("OBJECT_ID", "")).replace("-", "")[2:],
        epochyr=year % 100,
        epochdays=epochdays,
        ndot=ndot / (_XPDOTP * 1440.0),
        nddot=nddot / (_XPDOTP * 1440.0 * 1440.0),
        bstar=float(record.get("BSTAR", 0.0)),
        ephtype=int(record.get("EPHEMERIS_TYPE", 0)),
        elnum=int(record.get("ELEMENT_SET_NO", 0)),
        inclo=float(record["INCLINATION"]) * DEG2RAD,
        nodeo=float(record["RA_OF_ASC_NODE"]) * DEG2RAD,
        ecco=float(record["ECCENTRICITY"]),
        argpo=float(record["ARG_OF_PERICENTER"]) * DEG2RAD,
        mo=float(record["MEAN_ANOMALY"]) * DEG2RAD,
        no_kozai=mean_motion / _XPDOTP,
        revnum=int(record.get("REV_AT_EPOCH", 0)),
        jdsatepoch=jd,
        jdsatepochF=fr,
        name=record.get("OBJECT_NAME"),
    )


def parse_omm(text_or_obj: Union[str, dict, list]) -> List[Tle]:
    """Parse OMM JSON (single record or array) into TLE records."""
    obj = (json.loads(text_or_obj)
           if isinstance(text_or_obj, str) else text_or_obj)
    records = obj if isinstance(obj, list) else [obj]
    return [tle_from_omm(r) for r in records]


@dataclass
class TleArrays:
    """Struct-of-arrays view of a catalog: one f64 numpy column per
    element (``satnum`` is int64)."""

    satnum: np.ndarray
    epoch_jd: np.ndarray  # jdsatepoch + jdsatepochF
    jdsatepoch: np.ndarray
    jdsatepochF: np.ndarray
    no_kozai: np.ndarray  # rad/min
    ecco: np.ndarray
    inclo: np.ndarray
    nodeo: np.ndarray
    argpo: np.ndarray
    mo: np.ndarray
    bstar: np.ndarray
    ndot: np.ndarray
    nddot: np.ndarray

    def __len__(self) -> int:
        return int(self.satnum.shape[0])

    @classmethod
    def from_text(cls, text: str, allow_native: bool = True
                  ) -> "TleArrays":
        """Parse 2- or 3-line catalog text straight into columns.

        The C++ bulk parser (``native/tle_parser.cpp``) is the route; it
        is built at first use and raises ``RuntimeError`` when it does
        not build. ``allow_native=False`` runs the Python parser, its
        plain version: both give the same records and columns, bit for
        bit. Names are not kept either way."""
        if not allow_native:
            return cls.from_tles(list(iter_tles(text)))
        cols, satnums = native.parse_catalog(text)
        return cls(satnum=satnums, epoch_jd=cols[0], jdsatepoch=cols[1],
                   jdsatepochF=cols[2], no_kozai=cols[3], ecco=cols[4],
                   inclo=cols[5], nodeo=cols[6], argpo=cols[7], mo=cols[8],
                   bstar=cols[9], ndot=cols[10], nddot=cols[11])

    @classmethod
    def from_tles(cls, tles: Sequence[Tle]) -> "TleArrays":
        def col(attr, dtype=np.float64):
            return np.asarray([getattr(t, attr) for t in tles], dtype=dtype)

        return cls(
            satnum=col("satnum", np.int64),
            epoch_jd=col("epoch_jd"),
            jdsatepoch=col("jdsatepoch"),
            jdsatepochF=col("jdsatepochF"),
            no_kozai=col("no_kozai"),
            ecco=col("ecco"),
            inclo=col("inclo"),
            nodeo=col("nodeo"),
            argpo=col("argpo"),
            mo=col("mo"),
            bstar=col("bstar"),
            ndot=col("ndot"),
            nddot=col("nddot"),
        )
