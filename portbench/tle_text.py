"""The benchmark's own two-line element formatter: catalog generators
write their TLE text with it, never with the program's."""

from __future__ import annotations

import datetime

#: JD of 2000-01-01 00:00 UTC
_JD_2000 = 2451544.5


def _checksum(line: str) -> str:
    return str(sum(int(c) if c.isdigit() else c == "-"
                   for c in line[:68]) % 10)


def _implied_decimal(x: float) -> str:
    """The 8-character ``sMMMMMsE`` field: -0.11606e-4 -> '-11606-4'."""
    if x == 0.0:
        return " 00000+0"
    mant, exp = f"{abs(x):.4e}".split("e")
    digits = mant.replace(".", "")
    return f"{'-' if x < 0 else ' '}{digits}{int(exp) + 1:+d}"


def epoch_field(epoch_jd: float) -> str:
    """'YYDDD.DDDDDDDD' of a Julian date."""
    t = (datetime.datetime(2000, 1, 1)
         + datetime.timedelta(days=epoch_jd - _JD_2000))
    doy = t.timetuple().tm_yday
    frac = (t.hour * 3600 + t.minute * 60 + t.second
            + t.microsecond * 1e-6) / 86400.0
    return f"{t.year % 100:02d}{doy + frac:012.8f}"


def lines(satnum: int, epoch: str, ecco: float, inclo_deg: float,
          nodeo_deg: float, argpo_deg: float, mo_deg: float,
          rev_day: float, bstar: float) -> str:
    """One TLE line pair, checksums included; ``epoch`` from
    :func:`epoch_field`."""
    l1 = (f"1 {satnum:05d}U 24001A   {epoch}  .00000000  00000+0 "
          f"{_implied_decimal(bstar)} 0  999")
    l2 = (f"2 {satnum:05d} {inclo_deg % 360.0:8.4f} {nodeo_deg % 360.0:8.4f} "
          f"{f'{ecco:.7f}'[2:]} {argpo_deg % 360.0:8.4f} "
          f"{mo_deg % 360.0:8.4f} {rev_day:11.8f}    0")
    return f"{l1}{_checksum(l1)}\n{l2}{_checksum(l2)}"


def catalog(epoch_jd: float, ecco, inclo, nodeo, argpo, mo, rev_day,
            bstar, first_satnum: int = 10000) -> str:
    """TLE text of arrays of elements (degrees, rev/day), one epoch."""
    epoch = epoch_field(epoch_jd)
    return "\n".join(
        lines(first_satnum + k, epoch, float(ecco[k]), float(inclo[k]),
              float(nodeo[k]), float(argpo[k]), float(mo[k]),
              float(rev_day[k]), float(bstar[k]))
        for k in range(len(ecco)))
