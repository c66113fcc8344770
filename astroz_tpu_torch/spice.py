"""SPICE ephemeris access (optional — requires ``spiceypy``).

Counterpart of ``astroz_tpu/spice.py`` (the reference's ``src/Spice.zig``:
kernel management with the standard NAIF kernel list, time conversions,
spkpos/spkezr, frames, body name <-> ID, sun/moon helpers). Without
``spiceypy`` installed, every entry point raises
:class:`SpiceNotEnabled`, the analogue of the reference's disabled build
returning ``error.NotEnabled``. The pure-math jd <-> et conversions work
regardless. Host-side Python.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

try:  # optional dependency
    import spiceypy as _spice
    HAVE_SPICE = True
except ImportError:  # pragma: no cover - environment dependent
    _spice = None
    HAVE_SPICE = False

#: JD of the J2000 epoch (TDB) and seconds per day — for pure-math
#: jd <-> et (ephemeris seconds past J2000) like Spice.zig:220-227
_J2000_JD = 2451545.0
_SPD = 86400.0

#: standard NAIF kernel set (Spice.zig:117-125); fetch with
#: :func:`fetch_kernels` on a machine with network access
DEFAULT_KERNELS = (
    "naif0012.tls",       # leapseconds
    "de440s.bsp",         # planetary ephemeris
    "pck00011.tpc",       # planetary constants
    "gm_de440.tpc",       # gravitational parameters
)

#: NAIF download paths for the standard set (build.zig:252-275)
_NAIF_BASE = "https://naif.jpl.nasa.gov/pub/naif/generic_kernels/"
_KERNEL_PATHS = {
    "naif0012.tls": "lsk/naif0012.tls",
    "de440s.bsp": "spk/planets/de440s.bsp",
    "pck00011.tpc": "pck/pck00011.tpc",
    "gm_de440.tpc": "pck/gm_de440.tpc",
}


class SpiceNotEnabled(RuntimeError):
    """spiceypy is not installed (reference: error.NotEnabled)."""


def _require():
    if not HAVE_SPICE:
        raise SpiceNotEnabled(
            "spiceypy is not installed; install it to enable SPICE "
            "ephemeris access")


# ---------------------------------------------------------------------------
# Pure-math time conversions (always available, Spice.zig:220-227)
# ---------------------------------------------------------------------------


def jd_to_et(jd: float) -> float:
    """Julian date (TDB) -> ephemeris seconds past J2000."""
    return (jd - _J2000_JD) * _SPD


def et_to_jd(et: float) -> float:
    return et / _SPD + _J2000_JD


# ---------------------------------------------------------------------------
# Kernel management (Spice.zig:128-183)
# ---------------------------------------------------------------------------


def load_kernel(path: str) -> None:
    _require()
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    _spice.furnsh(path)


def load_default_kernels(directory: str) -> List[str]:
    """Load whichever of the standard kernel set exists in
    ``directory``; returns the loaded paths."""
    _require()
    loaded = []
    for name in DEFAULT_KERNELS:
        p = os.path.join(directory, name)
        if os.path.exists(p):
            _spice.furnsh(p)
            loaded.append(p)
    return loaded


def fetch_kernels(directory: str = "data/kernels",
                  kernels: Optional[List[str]] = None,
                  timeout: float = 120.0) -> List[str]:
    """Download the standard NAIF kernel set into ``directory``
    (reference: the ``zig build fetch-kernels`` step,
    build.zig:252-275). Existing files are kept; returns the paths
    that are present after the call. Needs network access — raises
    ``URLError``/``OSError`` offline, leaving whatever was already
    fetched in place."""
    import urllib.request

    os.makedirs(directory, exist_ok=True)
    present = []
    for name in kernels if kernels is not None else DEFAULT_KERNELS:
        dest = os.path.join(directory, name)
        if not os.path.exists(dest):
            url = _NAIF_BASE + _KERNEL_PATHS.get(name, name)
            tmp = dest + ".part"
            with urllib.request.urlopen(url, timeout=timeout) as resp, \
                    open(tmp, "wb") as out:
                while True:
                    chunk = resp.read(1 << 20)
                    if not chunk:
                        break
                    out.write(chunk)
            os.replace(tmp, dest)
        present.append(dest)
    return present


def unload_all() -> None:
    _require()
    _spice.kclear()


# ---------------------------------------------------------------------------
# Time (Spice.zig:187-201)
# ---------------------------------------------------------------------------


def utc_to_et(utc: str) -> float:
    _require()
    return float(_spice.str2et(utc))


# ---------------------------------------------------------------------------
# Ephemeris (Spice.zig:230-319)
# ---------------------------------------------------------------------------


@dataclass
class State:
    position_km: np.ndarray
    velocity_kms: np.ndarray
    light_time_s: float


def get_position(target: str, et: float, frame: str = "J2000",
                 abcorr: str = "NONE",
                 observer: str = "EARTH") -> Tuple[np.ndarray, float]:
    _require()
    pos, lt = _spice.spkpos(target, et, frame, abcorr, observer)
    return np.asarray(pos), float(lt)


def get_state(target: str, et: float, frame: str = "J2000",
              abcorr: str = "NONE", observer: str = "EARTH") -> State:
    _require()
    st, lt = _spice.spkezr(target, et, frame, abcorr, observer)
    st = np.asarray(st)
    return State(position_km=st[:3], velocity_kms=st[3:],
                 light_time_s=float(lt))


def get_position_by_id(target_id: int, et: float, frame: str = "J2000",
                       observer_id: int = 399):
    _require()
    return get_position(str(target_id), et, frame, "NONE",
                        str(observer_id))


def frame_rotation(from_frame: str, to_frame: str, et: float) -> np.ndarray:
    _require()
    return np.asarray(_spice.pxform(from_frame, to_frame, et))


def body_name_to_id(name: str) -> Optional[int]:
    _require()
    code, found = _spice.bodn2c(name)
    return int(code) if found else None


def body_id_to_name(code: int) -> Optional[str]:
    _require()
    name, found = _spice.bodc2n(code)
    return str(name) if found else None


def get_sun_position(et: float, frame: str = "J2000") -> np.ndarray:
    return get_position("SUN", et, frame)[0]


def get_moon_position(et: float, frame: str = "J2000") -> np.ndarray:
    return get_position("MOON", et, frame)[0]
