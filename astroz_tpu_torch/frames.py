"""Coordinate frames: TEME <-> ECEF rotation and ECEF <-> geodetic.

Counterpart of ``astroz_tpu/frames.py`` in plain torch. Functions run on
their tensors' device and dtype; a GMST or Julian date given as a float
or numpy array follows the position tensor, and the geodetic inputs of
:func:`geodetic_to_ecef`, when none is a tensor, go to ``device``.
"""

from __future__ import annotations

import torch

from .calculations import _tensors
from .constants import RAD2DEG, WGS84, WGS84_ECC_SQ
from .time import gstime


def teme_to_ecef(r_teme: torch.Tensor, gmst: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) TEME vectors into ECEF by the GMST z-rotation;
    ``gmst`` broadcasts against ``r_teme[..., 0]``."""
    sin_g = torch.sin(gmst)
    cos_g = torch.cos(gmst)
    x, y, z = r_teme[..., 0], r_teme[..., 1], r_teme[..., 2]
    return torch.stack([cos_g * x + sin_g * y, -sin_g * x + cos_g * y, z],
                       dim=-1)


def ecef_to_teme(r_ecef: torch.Tensor, gmst) -> torch.Tensor:
    return teme_to_ecef(r_ecef, -_like(gmst, r_ecef))


def teme_to_ecef_at_jd(r_teme: torch.Tensor, jd_ut1) -> torch.Tensor:
    return teme_to_ecef(r_teme, _like(gstime(jd_ut1), r_teme))


def _like(x, r):
    """``x`` as a tensor on ``r``'s device and dtype."""
    return torch.as_tensor(x, dtype=r.dtype, device=r.device)


def ecef_to_geodetic_xyz(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                         iters: int = 10):
    """ECEF component planes (km) -> ``(lat rad, lon rad, alt km)`` on
    WGS-84, by a fixed-trip latitude iteration."""
    # a 0-dim tensor, not a python float: ``float / tensor`` is a
    # reciprocal times the float in torch, two roundings, not a divide
    a = torch.tensor(WGS84.radius_earth_km, dtype=x.dtype, device=x.device)
    e2 = WGS84_ECC_SQ
    lon = torch.atan2(y, x)
    p = torch.sqrt(x * x + y * y)
    p_safe = torch.where(p > 1e-12, p, torch.full_like(p, 1e-12))
    lat = torch.atan2(z, p_safe * (1.0 - e2))
    for _ in range(iters):
        sin_lat = torch.sin(lat)
        n = a / torch.sqrt(1.0 - e2 * sin_lat * sin_lat)
        alt = p_safe / torch.cos(lat) - n
        lat = torch.atan2(z, p_safe * (1.0 - e2 * n / (n + alt)))
    sin_lat = torch.sin(lat)
    n = a / torch.sqrt(1.0 - e2 * sin_lat * sin_lat)
    alt = p_safe / torch.cos(lat) - n
    return lat, lon, alt


def ecef_to_geodetic(r_ecef: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """ECEF (..., 3) km -> stacked (..., 3) ``(lat rad, lon rad, alt
    km)`` on WGS-84 (:func:`ecef_to_geodetic_xyz`)."""
    lat, lon, alt = ecef_to_geodetic_xyz(r_ecef[..., 0], r_ecef[..., 1],
                                         r_ecef[..., 2], iters)
    return torch.stack([lat, lon, alt], dim=-1)


def ecef_to_geodetic_deg(r_ecef: torch.Tensor) -> torch.Tensor:
    """Same as :func:`ecef_to_geodetic` but lat/lon in degrees."""
    g = ecef_to_geodetic(r_ecef)
    return torch.stack(
        [g[..., 0] * RAD2DEG, g[..., 1] * RAD2DEG, g[..., 2]], dim=-1)


def geodetic_to_ecef(lat, lon, alt_km, *, device="cuda") -> torch.Tensor:
    """Geodetic (rad, rad, km) -> ECEF (..., 3) km on WGS-84."""
    lat, lon, alt_km = _tensors(lat, lon, alt_km, device=device)
    a = torch.tensor(WGS84.radius_earth_km, dtype=lat.dtype,
                     device=lat.device)
    e2 = WGS84_ECC_SQ
    sin_lat = torch.sin(lat)
    n = a / torch.sqrt(1.0 - e2 * sin_lat * sin_lat)
    x = (n + alt_km) * torch.cos(lat) * torch.cos(lon)
    y = (n + alt_km) * torch.cos(lat) * torch.sin(lon)
    z = (n * (1.0 - e2) + alt_km) * sin_lat
    return torch.stack([x, y, z], dim=-1)
