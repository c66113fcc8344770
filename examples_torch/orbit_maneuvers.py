"""Orbit propagation with impulse / plane-change maneuvers
(reference: examples/orbit_maneuvers.zig; the PyTorch port of
examples/orbit_maneuvers.py).

Run: ``python examples_torch/orbit_maneuvers.py`` (on the card).
"""

import numpy as np

from astroz_tpu_torch.spacecraft import (Impulse, ImpulseKind,
                                         SatelliteSize, Spacecraft)
from astroz_tpu_torch.tle import parse_lines

L1 = "1 55909U 23035B   24187.51050877  .00023579  00000+0  16099-2 0  9998"
L2 = "2 55909  43.9978 311.8012 0011446 278.6226  81.3336 15.05761711 71371"
MU = 398600.4418


def main(device="cuda", small=False):
    tle = parse_lines(L1, L2)
    # small: a fifth of each span, with the burns scheduled within it
    scale = 0.2 if small else 1.0

    def craft():
        return Spacecraft.from_tle(tle, mass_kg=300.0,
                                   size=SatelliteSize.CUBE, device=device)

    # 1: basic propagation, no maneuvers
    times, states = craft().propagate(0.0, days=0.2 * scale, h=10.0)
    print(f"basic propagation: {len(times)} states, "
          f"|r| = {np.linalg.norm(states[-1, :3]):.1f} km")

    # 2: scheduled absolute-dv impulses
    impulses = [
        Impulse(time=3600.0 * scale, delta_v=[0.02, 0.01, 0.005]),
        Impulse(time=7200.0 * scale, delta_v=[-0.01, 0.02, -0.005]),
    ]
    times, states = craft().propagate(0.0, days=0.2 * scale, h=10.0,
                                      impulses=impulses)
    print(f"after 2 impulses:  |r| = "
          f"{np.linalg.norm(states[-1, :3]):.1f} km")

    # 3: prograde burn (orbit raise)
    burn = [Impulse(time=1800.0 * scale, kind=ImpulseKind.PROGRADE,
                    magnitude=0.1)]
    times, states = craft().propagate(0.0, days=0.2 * scale, h=10.0,
                                      impulses=burn)
    r = np.linalg.norm(states[-1, :3])
    v = np.linalg.norm(states[-1, 3:])
    a = -MU / (2 * (v * v / 2 - MU / r))
    print(f"after +100 m/s prograde: semi-major axis = {a:.1f} km")

    # 4: combined plane change (inclination + RAAN)
    pc = [Impulse(time=1800.0 * scale, kind=ImpulseKind.PLANE_CHANGE,
                  delta_inclination=np.deg2rad(0.5),
                  delta_raan=np.deg2rad(0.2))]
    times, states = craft().propagate(0.0, days=0.1 * scale, h=10.0,
                                      impulses=pc)
    print(f"plane change applied: {len(times)} states, final |r| = "
          f"{np.linalg.norm(states[-1, :3]):.1f} km")


if __name__ == "__main__":
    main()
