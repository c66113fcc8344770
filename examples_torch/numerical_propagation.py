"""Numerical propagation with force models + a maneuver (the PyTorch
port of examples/numerical_propagation.py).

Run: ``python examples_torch/numerical_propagation.py`` (on the card).
"""

import numpy as np
import torch

from astroz_tpu_torch.constants import EARTH
from astroz_tpu_torch.propagators import propagate_numerical
from astroz_tpu_torch.spacecraft import Impulse, ImpulseKind, Spacecraft


def main(device="cuda", small=False):
    r0 = EARTH.eq_radius + 500.0
    vc = np.sqrt(EARTH.mu / r0)
    state = np.array([r0, 0, 0, 0, vc, 0])

    # small: a tenth of the orbit and of the burn's day
    scale = 0.1 if small else 1.0
    times, states = propagate_numerical(state, 0.0, 5400.0 * scale, 60.0,
                                        j2=EARTH.j2, drag_cd=2.2,
                                        device=device)
    print(f"DP87: {len(times)} samples, final |r| = "
          f"{float(torch.linalg.norm(states[-1, :3])):.1f} km")

    sc = Spacecraft(state=state, device=device)
    sc.propagate(0.0, 0.1 * scale, 30.0, impulses=[
        Impulse(time=2700.0 * scale, kind=ImpulseKind.PROGRADE,
                magnitude=0.05)])
    print(f"after prograde burn: |r| = "
          f"{np.linalg.norm(sc.state[:3]):.1f} km")


if __name__ == "__main__":
    main()
