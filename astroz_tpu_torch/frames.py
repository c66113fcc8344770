"""Coordinate frames: TEME -> ECEF rotation and ECEF -> geodetic.

Counterpart of ``astroz_tpu/frames.py:18-75`` in plain torch.
"""

from __future__ import annotations

import torch

from .constants import WGS84, WGS84_ECC_SQ


def teme_to_ecef(r_teme: torch.Tensor, gmst: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) TEME vectors into ECEF by the GMST z-rotation;
    ``gmst`` broadcasts against ``r_teme[..., 0]``."""
    sin_g = torch.sin(gmst)
    cos_g = torch.cos(gmst)
    x, y, z = r_teme[..., 0], r_teme[..., 1], r_teme[..., 2]
    return torch.stack([cos_g * x + sin_g * y, -sin_g * x + cos_g * y, z],
                       dim=-1)


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
