"""TRIAD attitude determination + torque-free propagation
(reference: Spacecraft attitude demo, calculations.zig:283-305,429-462;
the PyTorch port of examples/attitude_determination.py).

Run: ``python examples_torch/attitude_determination.py`` (on the card).
"""

import numpy as np

from astroz_tpu_torch.constants import EARTH
from astroz_tpu_torch.spacecraft import SatelliteSize, Spacecraft


def main(device="cuda", small=False):
    r0 = EARTH.eq_radius + 550.0
    vc = np.sqrt(EARTH.mu / r0)
    sc = Spacecraft(state=np.array([r0, 0, 0, 0, vc, 0]),
                    size=SatelliteSize.CUBE,
                    inertia_diag=np.array([0.02, 0.03, 0.05]), device=device)

    # two reference vectors (sun + magnetic field) seen in body frame
    sun_ref = np.array([1.0, 0.0, 0.0])
    mag_ref = np.array([0.0, 0.6, 0.8])
    # body measurements: spacecraft rotated 30 deg about z
    th = np.deg2rad(30)
    rz = np.array([[np.cos(th), np.sin(th), 0],
                   [-np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    sc.update_attitude(rz @ sun_ref, rz @ mag_ref, sun_ref, mag_ref)
    print("determined quaternion:", np.round(sc.quaternion, 4))

    sc.angular_velocity = np.array([0.0, 0.0, 0.05])
    # small: 6 s of 0.1 s steps in place of 60 s
    duration = 6.0 if small else 60.0
    sc.propagate_attitude(dt=0.1, duration=duration)
    print(f"after {duration:.0f} s tumble:   ", np.round(sc.quaternion, 4))


if __name__ == "__main__":
    main()
