"""Interplanetary mission planning.

Counterpart of ``astroz_tpu/mission.py`` (the reference's
``src/Mission.zig``: parameter validation, analytic Hohmann transfer
sampling, planetary positions, synodic-period planning). Planets move on
circular-coplanar orbits (the reference's model); positions come from
the JPL fact-sheet semi-major axes in :mod:`astroz_tpu_torch.constants`.
Host-side numpy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional

import numpy as np

from .constants import BODIES, SUN, CelestialBody

MU_SUN = SUN.mu


class PointKind(Enum):
    TRAJECTORY = "trajectory"
    WAYPOINT = "waypoint"
    PLANET = "planet"


@dataclass
class TrajectoryPoint:
    time_days: float
    position_km: np.ndarray  # heliocentric ecliptic
    kind: PointKind = PointKind.TRAJECTORY
    label: str = ""


@dataclass
class MissionParameters:
    """Validated inputs (Mission.zig:33-59)."""

    origin: str = "earth"
    destination: str = "mars"
    departure_time_days: float = 0.0
    samples: int = 100

    def __post_init__(self):
        for name in (self.origin, self.destination):
            if name not in BODIES or name == "sun":
                raise ValueError(f"unknown planet {name!r}")
        if self.origin == self.destination:
            raise ValueError("origin and destination must differ")
        if self.samples < 2:
            raise ValueError("need at least 2 samples")


@dataclass
class MissionPlan:
    origin: str
    destination: str
    departure_dv_kms: float
    arrival_dv_kms: float
    total_dv_kms: float
    transfer_time_days: float
    synodic_period_days: float
    phase_angle_rad: float
    trajectory: List[TrajectoryPoint] = field(default_factory=list)


def planet_angular_rate(body: CelestialBody) -> float:
    """rad/day on the circular approximation."""
    return 2.0 * np.pi / body.period


def planet_position(body: CelestialBody, t_days: float,
                    phase0: float = 0.0) -> np.ndarray:
    """Heliocentric position at time t on a circular coplanar orbit
    (Mission.zig:225-268 simplified to the reference's circular
    model)."""
    ang = phase0 + planet_angular_rate(body) * t_days
    r = body.semi_major_axis
    return np.array([r * np.cos(ang), r * np.sin(ang), 0.0])


def synodic_period_days(origin: CelestialBody,
                        dest: CelestialBody) -> float:
    """1/|1/T1 - 1/T2| (Mission.zig:272-302)."""
    return 1.0 / abs(1.0 / origin.period - 1.0 / dest.period)


def plan_mission(params: MissionParameters) -> MissionPlan:
    """Hohmann transfer between circular heliocentric orbits with the
    required departure phase angle (Mission.zig planMission)."""
    origin = BODIES[params.origin]
    dest = BODIES[params.destination]
    r1 = origin.semi_major_axis
    r2 = dest.semi_major_axis
    a_t = 0.5 * (r1 + r2)

    v1 = np.sqrt(MU_SUN / r1)
    v2 = np.sqrt(MU_SUN / r2)
    v_dep = np.sqrt(MU_SUN * (2.0 / r1 - 1.0 / a_t))
    v_arr = np.sqrt(MU_SUN * (2.0 / r2 - 1.0 / a_t))
    dv_dep = abs(v_dep - v1)
    dv_arr = abs(v2 - v_arr)
    tof_s = np.pi * np.sqrt(a_t ** 3 / MU_SUN)
    tof_days = tof_s / 86400.0

    # required phase angle: destination must lead (or lag) so that it
    # arrives at the transfer apoapsis when the spacecraft does
    phase = np.pi - planet_angular_rate(dest) * tof_days

    plan = MissionPlan(
        origin=params.origin, destination=params.destination,
        departure_dv_kms=dv_dep, arrival_dv_kms=dv_arr,
        total_dv_kms=dv_dep + dv_arr, transfer_time_days=tof_days,
        synodic_period_days=synodic_period_days(origin, dest),
        phase_angle_rad=phase)
    plan.trajectory = propagate_transfer(params, plan)
    return plan


def propagate_transfer(params: MissionParameters,
                       plan: MissionPlan) -> List[TrajectoryPoint]:
    """Sample the analytic transfer ellipse + planet motions into
    labeled trajectory points (Mission.zig:138-223)."""
    origin = BODIES[params.origin]
    dest = BODIES[params.destination]
    r1 = origin.semi_major_axis
    r2 = dest.semi_major_axis
    a_t = 0.5 * (r1 + r2)
    e_t = abs(r2 - r1) / (r2 + r1)
    outward = r2 > r1
    tof = plan.transfer_time_days

    pts: List[TrajectoryPoint] = []
    t0 = params.departure_time_days
    pts.append(TrajectoryPoint(t0, planet_position(origin, t0),
                               PointKind.WAYPOINT, "departure"))
    # Destination phase: the transfer ellipse arrives at ang0 + pi
    # (ang0 = origin angle at departure), so anchor the destination's
    # angular motion to coincide with the spacecraft there at t0 + tof —
    # works for any departure_time_days, not just t0 = 0.
    dep_pos = planet_position(origin, t0)
    ang0_dep = np.arctan2(dep_pos[1], dep_pos[0])
    dest_phase0 = ang0_dep + np.pi - planet_angular_rate(dest) * (t0 + tof)
    for k in range(params.samples):
        frac = k / (params.samples - 1)
        t = t0 + frac * tof
        # Kepler from mean anomaly along the transfer ellipse: outward
        # legs run periapsis -> apoapsis (M: 0 -> pi), inward legs run
        # apoapsis -> periapsis (M: pi -> 2pi) so positions stay in
        # time order
        m = np.pi * frac if outward else np.pi * (1.0 + frac)
        big_e = m
        for _ in range(30):
            big_e -= (big_e - e_t * np.sin(big_e) - m) / \
                (1.0 - e_t * np.cos(big_e))
        nu = 2.0 * np.arctan2(np.sqrt(1 + e_t) * np.sin(big_e / 2),
                              np.sqrt(1 - e_t) * np.cos(big_e / 2))
        r = a_t * (1.0 - e_t * np.cos(big_e))
        # align the departure point: periapsis for outward transfers,
        # apoapsis (nu = pi) for inward ones
        ang0 = np.arctan2(planet_position(origin, t0)[1],
                          planet_position(origin, t0)[0])
        ang = ang0 + nu if outward else ang0 + (nu - np.pi)
        pts.append(TrajectoryPoint(
            t, np.array([r * np.cos(ang), r * np.sin(ang), 0.0]),
            PointKind.TRAJECTORY))
        pts.append(TrajectoryPoint(t, planet_position(dest, t,
                                                      dest_phase0),
                                   PointKind.PLANET, params.destination))
    pts.append(TrajectoryPoint(t0 + tof,
                               planet_position(dest, t0 + tof,
                                               dest_phase0),
                               PointKind.WAYPOINT, "arrival"))
    return pts
