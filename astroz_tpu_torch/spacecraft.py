"""Spacecraft: numerical propagation with impulsive maneuvers + attitude.

Counterpart of ``astroz_tpu/spacecraft.py``: size presets, a TLE seed,
TwoBody+J2+Drag RK4 propagation with scheduled impulses, phase-change
and plane-change delta-v, the abnormal-orbit guard, and TRIAD + RK4
attitude. The spacecraft keeps its state as numpy, as the JAX package
does; the integration and the attitude math run on ``device`` (the card
unless the caller asks for the CPU), and each inter-impulse segment
comes back to the host once for the guard.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .calculations import (elements_to_state, propagate_attitude,
                           rotmat_to_quaternion, state_to_elements,
                           tle_to_elements, triad)
from .constants import EARTH
from .propagators import Composite, Drag, J2, TwoBody
from .propagators.driver import propagate_fixed
from .tle import Tle

__all__ = ["Impulse", "ImpulseKind", "MU", "SatelliteSize", "Spacecraft",
           "phase_change_dv", "plane_change_dv"]

log = logging.getLogger(__name__)

MU = EARTH.mu


class SatelliteSize(Enum):
    """Size presets: (drag coefficient Cd, cross-section m^2)."""

    CUBE = (2.2, 0.05)
    MINI = (2.2, 1.0)
    MEDIUM = (2.2, 5.0)
    LARGE = (2.2, 20.0)

    @property
    def drag_coefficient(self) -> float:
        return self.value[0]

    @property
    def cross_section(self) -> float:
        return self.value[1]


class ImpulseKind(Enum):
    ABSOLUTE = "absolute"      # dv vector given in inertial frame
    PROGRADE = "prograde"      # scalar dv along velocity
    PHASE = "phase"            # phase-shift maneuver (two-burn)
    PLANE_CHANGE = "plane_change"  # inclination/raan change


@dataclass
class Impulse:
    """A scheduled maneuver."""

    time: float  # seconds from propagation start
    kind: ImpulseKind = ImpulseKind.ABSOLUTE
    delta_v: Optional[Sequence[float]] = None  # km/s (ABSOLUTE)
    magnitude: float = 0.0  # km/s (PROGRADE)
    phase_change: float = 0.0  # radians (PHASE)
    delta_inclination: float = 0.0  # radians (PLANE_CHANGE)
    delta_raan: float = 0.0  # radians (PLANE_CHANGE)


def phase_change_dv(a_km: float, phase_rad: float,
                    mu: float = MU) -> Tuple[float, float]:
    """Two-burn phasing: dv per burn and the phasing-orbit period. The
    spacecraft enters a phasing orbit whose period differs so that after
    one rev the anomaly shifts by ``phase_rad``."""
    t_orig = 2.0 * np.pi * np.sqrt(a_km ** 3 / mu)
    t_phase = t_orig * (1.0 - phase_rad / (2.0 * np.pi))
    a_phase = (mu * (t_phase / (2.0 * np.pi)) ** 2) ** (1.0 / 3.0)
    v_orig = np.sqrt(mu / a_km)
    v_phase = np.sqrt(mu * (2.0 / a_km - 1.0 / a_phase))
    return abs(v_phase - v_orig), t_phase


def plane_change_dv(v_kms: float, delta_i: float, delta_raan: float,
                    incl: float) -> float:
    """Combined plane-change dv magnitude: theta = angle between the
    initial and final orbit planes."""
    cos_theta = (np.cos(incl) * np.cos(incl + delta_i)
                 + np.sin(incl) * np.sin(incl + delta_i)
                 * np.cos(delta_raan))
    theta = np.arccos(np.clip(cos_theta, -1.0, 1.0))
    return 2.0 * v_kms * np.sin(theta / 2.0)


@dataclass
class Spacecraft:
    """A spacecraft with mass/size, force model, impulses, attitude;
    ``device`` runs its integration and attitude math."""

    name: str = "sc"
    mass_kg: float = 100.0
    size: SatelliteSize = SatelliteSize.MINI
    state: Optional[np.ndarray] = None  # [r km, v km/s]
    quaternion: np.ndarray = field(
        default_factory=lambda: np.array([1.0, 0.0, 0.0, 0.0]))
    angular_velocity: np.ndarray = field(
        default_factory=lambda: np.zeros(3))
    inertia_diag: np.ndarray = field(
        default_factory=lambda: np.array([1.0, 1.0, 1.0]))
    device: str = "cuda"
    orbiting_object = EARTH

    @classmethod
    def from_tle(cls, tle: Tle, **kwargs) -> "Spacecraft":
        """Seed the state from TLE mean elements via a direct Kepler
        conversion."""
        sc = cls(**kwargs)
        r, v = elements_to_state(tle_to_elements(tle, device=sc.device))
        sc.state = np.concatenate([r.cpu().numpy(), v.cpu().numpy()])
        return sc

    def _forces(self):
        return Composite([
            TwoBody(self.orbiting_object.mu),
            J2(self.orbiting_object.mu, self.orbiting_object.j2,
               self.orbiting_object.eq_radius),
            Drag(cd=self.size.drag_coefficient,
                 area_m2=self.size.cross_section, mass_kg=self.mass_kg),
        ])

    def _apply_impulse(self, state: np.ndarray, imp: Impulse) -> np.ndarray:
        r, v = state[:3], state[3:]
        if imp.kind is ImpulseKind.ABSOLUTE:
            v = v + np.asarray(imp.delta_v, np.float64)
        elif imp.kind is ImpulseKind.PROGRADE:
            v = v + imp.magnitude * v / np.linalg.norm(v)
        elif imp.kind is ImpulseKind.PHASE:
            a = float(state_to_elements(r, v, device=self.device)
                      .semi_major_axis)
            dv, _ = phase_change_dv(a, imp.phase_change,
                                    self.orbiting_object.mu)
            v = v + dv * v / np.linalg.norm(v)
        elif imp.kind is ImpulseKind.PLANE_CHANGE:
            el = state_to_elements(r, v, device=self.device)
            dv_mag = plane_change_dv(np.linalg.norm(v),
                                     imp.delta_inclination, imp.delta_raan,
                                     float(el.inclination))
            # burn normal to the orbit plane (direction of plane change)
            h = np.cross(r, v)
            n_hat = h / np.linalg.norm(h)
            sign = 1.0 if (imp.delta_inclination + imp.delta_raan) >= 0 \
                else -1.0
            v = v + sign * dv_mag * n_hat
        return np.concatenate([r, v])

    def propagate(self, t0: float, days: float, h: float,
                  impulses: Sequence[Impulse] = ()
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """RK4 propagation with impulses applied at their scheduled
        times: one :func:`propagate_fixed` per inter-impulse segment,
        read back to the host once for the abnormal-orbit guard (energy
        > 0, NaN, or r > 100,000 km), which cuts the trajectory before
        the first bad sample and stops. Returns (times, states) as
        numpy."""
        if self.state is None:
            raise ValueError("spacecraft has no initial state")
        forces = self._forces()
        t_end = t0 + days * 86400.0
        events = sorted([i for i in impulses if t0 <= i.time <= t_end],
                        key=lambda i: i.time)
        times_all: List[np.ndarray] = []
        states_all: List[np.ndarray] = []
        state = np.asarray(self.state, np.float64)
        t = t0
        for imp in events + [None]:
            seg_end = t_end if imp is None else imp.time
            if seg_end > t:
                ts, ss = propagate_fixed(forces, state, t, seg_end - t, h,
                                         device=self.device)
                ss = ss.cpu().numpy()
                rn = np.linalg.norm(ss[:, :3], axis=-1)
                vn = np.linalg.norm(ss[:, 3:], axis=-1)
                energy = 0.5 * vn * vn - self.orbiting_object.mu / rn
                bad = (~np.isfinite(ss).all(axis=-1) | (energy > 0.0)
                       | (rn > 100000.0))
                bad[0] = False  # keep at least the initial sample
                if bad.any():
                    cut = int(np.argmax(bad))
                    log.warning("%s: abnormal orbit detected, stopping",
                                self.name)
                    times_all.append(ts[:cut])
                    states_all.append(ss[:cut])
                    state = ss[max(cut - 1, 0)]
                    break
                times_all.append(ts)
                states_all.append(ss)
                state = ss[-1]
                t = float(ts[-1])
            if imp is not None:
                state = self._apply_impulse(state, imp)
        self.state = state
        times = np.concatenate(times_all)
        states = np.concatenate(states_all)
        return times, states

    # ---- attitude ---------------------------------------------------------

    def update_attitude(self, v1_body, v2_body, v1_ref, v2_ref) -> None:
        """TRIAD determination -> stored quaternion."""
        m = triad(v1_body, v2_body, v1_ref, v2_ref, device=self.device)
        self.quaternion = rotmat_to_quaternion(m).cpu().numpy()

    def propagate_attitude(self, dt: float, duration: float,
                           torque=(0.0, 0.0, 0.0)) -> None:
        n = max(1, int(round(duration / dt)))
        q, w = propagate_attitude(self.quaternion, self.angular_velocity,
                                  self.inertia_diag, torque, dt, n,
                                  device=self.device)
        self.quaternion = q.cpu().numpy()
        self.angular_velocity = w.cpu().numpy()
