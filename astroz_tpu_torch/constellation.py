"""High-level constellation API: load, propagate, screen.

Counterpart of ``astroz_tpu/constellation.py:61-218``: source loading
(file path, raw TLE/3LE/OMM text, or a CelesTrak group / NORAD id / URL
through ``fetch``), the :class:`Constellation` class and the one-call
:func:`propagate` and :func:`screen`.
"""

from __future__ import annotations

import datetime as _dt
import os
from typing import Callable, Optional, Sequence, Union

import numpy as np

from .constants import WGS72, GravityModel
from .ops.sgp4 import Sgp4Elements
from .propagation import SatCatalog, build_catalog, catalog_from_elements
from .propagation import propagate as _propagate_catalog
from .screening import screen_all, screen_target
from .time import jday
from .tle import Tle

CELESTRAK_GROUP_URL = ("https://celestrak.org/NORAD/elements/gp.php"
                       "?GROUP={group}&FORMAT=tle")
CELESTRAK_CATNR_URL = ("https://celestrak.org/NORAD/elements/gp.php"
                       "?CATNR={catnr}&FORMAT=tle")

#: CelesTrak group aliases
GROUP_ALIASES = {
    "all": "active", "active": "active", "stations": "stations",
    "starlink": "starlink", "oneweb": "oneweb", "gps": "gps-ops",
    "galileo": "galileo", "glonass": "glo-ops", "geo": "geo",
    "weather": "weather", "science": "science", "debris": "cosmos-1408-debris",
}


def _default_fetch(url: str) -> str:
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.read().decode("utf-8", errors="replace")
    except Exception as exc:  # network dependent
        raise ConnectionError(
            f"could not fetch {url!r} (no network egress?): {exc}"
        ) from exc


def load_tle_text(source: str, *,
                  fetch: Optional[Callable[[str], str]] = None) -> str:
    """Resolve a source spec to raw TLE/OMM text:

    * an existing file path -> its contents
    * ``http(s)://...`` -> fetched
    * ``group:<name>`` or a known group alias -> CelesTrak group
    * ``norad:<id>`` or an integer string -> CelesTrak by catalog number
    * anything else (TLE/3LE lines, OMM JSON) -> passed through
    """
    fetch = fetch or _default_fetch
    if os.path.exists(source):
        with open(source, "r") as f:
            return f.read()
    s = source.strip()
    if s.startswith(("http://", "https://")):
        return fetch(s)
    if s.startswith("group:"):
        return fetch(CELESTRAK_GROUP_URL.format(group=s[6:]))
    if s.startswith("norad:"):
        return fetch(CELESTRAK_CATNR_URL.format(catnr=int(s[6:])))
    if s.lower() in GROUP_ALIASES:
        return fetch(CELESTRAK_GROUP_URL.format(
            group=GROUP_ALIASES[s.lower()]))
    if s.isdigit():
        return fetch(CELESTRAK_CATNR_URL.format(catnr=int(s)))
    return source


def _times_to_jd(times, start_time=None) -> np.ndarray:
    """Times spec -> f64 JD array: JD floats, datetimes, or minute
    offsets from ``start_time`` (a datetime or a JD)."""
    if start_time is not None:
        if isinstance(start_time, _dt.datetime):
            jd0, fr0 = jday(start_time.year, start_time.month,
                            start_time.day, start_time.hour,
                            start_time.minute,
                            start_time.second + start_time.microsecond
                            * 1e-6)
            base = jd0 + fr0
        else:
            base = float(start_time)
        return base + np.asarray(times, np.float64) / 1440.0
    times = np.atleast_1d(np.asarray(times))
    if times.dtype == object or isinstance(times.flat[0], _dt.datetime):
        out = []
        for t in times.ravel():
            jd0, fr0 = jday(t.year, t.month, t.day, t.hour, t.minute,
                            t.second + t.microsecond * 1e-6)
            out.append(jd0 + fr0)
        return np.asarray(out)
    return times.astype(np.float64)


class Constellation:
    """A loaded and initialized catalog on one device."""

    def __init__(self, source: Union[str, Sequence[Tle], SatCatalog],
                 grav: GravityModel = WGS72,
                 fetch: Optional[Callable[[str], str]] = None, *,
                 device="cuda"):
        if isinstance(source, SatCatalog):
            self.catalog = source
        else:
            if isinstance(source, str):
                source = load_tle_text(source, fetch=fetch)
            self.catalog = build_catalog(source, grav=grav, device=device)

    def __len__(self) -> int:
        return len(self.catalog)

    @property
    def num_satellites(self) -> int:
        return len(self.catalog)

    @property
    def num_deep_space(self) -> int:
        return self.catalog.n_deep

    @property
    def satnums(self) -> np.ndarray:
        return self.catalog.satnum

    @property
    def names(self):
        return self.catalog.names

    @property
    def epochs_jd(self) -> np.ndarray:
        return self.catalog.epochs_jd

    def select(self, norad_ids: Sequence[int]) -> "Constellation":
        """Subset by NORAD catalog number, on the same device."""
        ids = set(int(i) for i in norad_ids)
        mask = np.asarray([int(s) in ids for s in self.catalog.satnum])
        if not mask.any():
            raise ValueError("no matching NORAD ids in catalog")
        idx = np.nonzero(mask)[0]
        els = Sgp4Elements(*(x[idx] for x in self.catalog.host))
        names = (tuple(np.asarray(self.catalog.names, object)[idx])
                 if self.catalog.names else None)
        return Constellation(catalog_from_elements(
            els, self.catalog.grav, satnum=self.catalog.satnum[idx],
            names=names, device=self.catalog.device))

    def propagate(self, times, start_time=None, *, output: str = "teme",
                  velocities: bool = True, layout: str = "time_major",
                  method: str = "fast"):
        """Propagate to the given epochs; see
        :func:`astroz_tpu_torch.propagation.propagate` for outputs."""
        jd = _times_to_jd(times, start_time)
        return _propagate_catalog(self.catalog, jd, output=output,
                                  velocities=velocities, layout=layout,
                                  method=method)

    def screen(self, times, start_time=None, *,
               threshold_km: float = 5.0, target=None, method="fast",
               **kwargs):
        """Conjunction screen over the given epochs: one target against
        the catalog when ``target`` is given
        (:func:`~astroz_tpu_torch.screening.screen_target`, with the
        threshold mask), else every pair
        (:func:`~astroz_tpu_torch.screening.screen_all`, which takes
        ``kwargs``)."""
        jd = _times_to_jd(times, start_time)
        if target is not None:
            return screen_target(self.catalog, target, jd,
                                 threshold_km=threshold_km, method=method)
        return screen_all(self.catalog, jd, threshold_km=threshold_km,
                          method=method, **kwargs)


def propagate(source, times, start_time=None, *, output: str = "teme",
              velocities: bool = True, norad_id: Optional[int] = None,
              grav: GravityModel = WGS72, method: str = "fast",
              fetch: Optional[Callable[[str], str]] = None,
              device="cuda"):
    """One call: load ``source``, optionally select one satellite, and
    propagate to ``times``; returns ``(r, v, error)`` shaped
    (n_times, n_sats, 3)."""
    con = Constellation(source, grav=grav, fetch=fetch, device=device)
    if norad_id is not None:
        con = con.select([norad_id])
    return con.propagate(times, start_time, output=output,
                         velocities=velocities, method=method)


def screen(source, times, start_time=None, *, threshold_km: float = 5.0,
           target=None, grav: GravityModel = WGS72,
           fetch: Optional[Callable[[str], str]] = None, device="cuda",
           **kwargs):
    """One call: load ``source`` on ``device`` and screen it
    (:meth:`Constellation.screen`)."""
    con = Constellation(source, grav=grav, fetch=fetch, device=device)
    return con.screen(times, start_time, threshold_km=threshold_km,
                      target=target, **kwargs)
