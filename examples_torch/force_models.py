"""Composable force models + the adaptive DP8(7) integrator
(reference: examples/maneuver_planning.zig — TwoBody / J2 / Composite
through ForceModel.wrap + DormandPrince87; the PyTorch port of
examples/force_models.py). The models are plain callables on tensors;
the adaptive integrator steers one trajectory at a time on the host
from one error-norm read a substep, so the altitude sweep runs its
trajectories one after the other.

Run: ``python examples_torch/force_models.py`` (on the card).
"""

import numpy as np
import torch

from astroz_tpu_torch.constants import EARTH, WGS84
from astroz_tpu_torch.propagators import (J2, Composite, TwoBody,
                                          dp87_adaptive, make_deriv)


def main(device="cuda", small=False):
    mu = EARTH.mu
    r_eq = WGS84.radius_earth_km

    # circular orbit at 400 km, 51.6 deg inclination
    a = r_eq + 400.0
    v_circ = np.sqrt(mu / a)
    inc = np.radians(51.6)
    state0 = np.array([a, 0.0, 0.0,
                       0.0, v_circ * np.cos(inc), v_circ * np.sin(inc)])
    # small: one orbit-long hour and two sweep lanes in place of a day
    # and eight
    one_day = 3600.0 if small else 86400.0
    span, short = ("1 h", "1 h") if small else ("1 day", "1 d")

    # two-body only
    two_body = TwoBody(mu)
    s_2b, _, n_2b = dp87_adaptive(make_deriv(two_body), state0, 0.0,
                                  one_day, rtol=1e-10, atol=1e-12,
                                  device=device)

    # composite: two-body + J2
    composite = Composite([TwoBody(mu), J2(mu, WGS84.j2, r_eq)])
    s_j2, _, n_j2 = dp87_adaptive(make_deriv(composite), state0, 0.0,
                                  one_day, rtol=1e-10, atol=1e-12,
                                  device=device)

    r_2b = float(torch.linalg.norm(s_2b[:3]))
    r_j2 = float(torch.linalg.norm(s_j2[:3]))
    drift = float(torch.linalg.norm(s_2b[:3] - s_j2[:3]))
    print(f"two-body after {span}: |r| = {r_2b:.3f} km "
          f"({int(n_2b)} adaptive steps)")
    print(f"with J2 after {span}:  |r| = {r_j2:.3f} km "
          f"({int(n_j2)} adaptive steps)")
    print(f"J2-induced position drift: {drift:.1f} km")

    # the same integrator over a small altitude sweep of initial states
    alts = np.linspace(300.0, 800.0, 2 if small else 8)
    r0s = r_eq + alts
    v0s = np.sqrt(mu / r0s)
    states = np.stack([r0s, np.zeros_like(r0s), np.zeros_like(r0s),
                       np.zeros_like(r0s), v0s * np.cos(inc),
                       v0s * np.sin(inc)], axis=-1)
    deriv = make_deriv(composite)
    finals = [dp87_adaptive(deriv, s, 0.0, one_day, rtol=1e-9, atol=1e-11,
                            device=device)[0] for s in states]
    radii = [float(torch.linalg.norm(f[:3])) for f in finals]
    for alt, r in zip(alts, radii):
        print(f"  h0 = {alt:5.0f} km -> |r|({short}) = {r:8.1f} km")


if __name__ == "__main__":
    main()
