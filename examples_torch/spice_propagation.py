"""Numerical propagation with SPICE-supplied Sun/Moon positions,
falling back to fixed geometry when spiceypy or the kernels are absent
(reference: examples/spice_propagation.zig; the PyTorch port of
examples/spice_propagation.py).

Run: ``python examples_torch/spice_propagation.py`` (on the card).
"""

import numpy as np
import torch

from astroz_tpu_torch import spice
from astroz_tpu_torch.constants import AU_KM, EARTH, MOON, SUN, WGS84
from astroz_tpu_torch.propagators import (J2, Composite,
                                          SolarRadiationPressure, ThirdBody,
                                          TwoBody, propagate_fixed)


def main(device="cuda", small=False):
    # --- ephemeris source ---------------------------------------------------
    epoch_jd = 2460483.0  # 2024-06-21
    et = spice.jd_to_et(epoch_jd)

    sun_pos = np.array([AU_KM, 0.0, 0.0])
    moon_pos = np.array([384400.0, 0.0, 0.0])
    try:
        spice.load_default_kernels("data/kernels")
        sun_pos = spice.get_sun_position(et)
        moon_pos = spice.get_moon_position(et)
        print("SPICE ephemeris loaded")
    except (spice.SpiceNotEnabled, Exception) as exc:  # noqa: BLE001
        print(f"SPICE unavailable ({type(exc).__name__}) — fixed Sun/Moon "
              f"positions.\nFor real ephemeris: astroz_tpu_torch.spice."
              f"fetch_kernels() on a networked machine, pip install "
              f"spiceypy")

    # --- ISS-like orbit: 420 km, 51.6 deg -----------------------------------
    r0 = WGS84.radius_earth_km + 420.0
    v0 = np.sqrt(EARTH.mu / r0)
    inc = np.deg2rad(51.6)
    state0 = np.array([r0, 0, 0, 0, v0 * np.cos(inc), v0 * np.sin(inc)])

    forces = Composite([
        TwoBody(EARTH.mu),
        J2(EARTH.mu, WGS84.j2, WGS84.radius_earth_km),
        SolarRadiationPressure(cr=1.5, area_m2=20.0, mass_kg=1000.0,
                               sun_pos_fn=lambda t: sun_pos),
        ThirdBody(SUN.mu, lambda t: sun_pos),
        ThirdBody(MOON.mu, lambda t: moon_pos),
    ])

    # small: a tenth of the orbit
    duration = 540.0 if small else 5400.0
    times, states = propagate_fixed(forces, state0, 0.0, duration=duration,
                                    dt=60.0, device=device)
    rn = torch.linalg.norm(states[:, :3], dim=-1)
    print(f"propagated {len(times)} steps over one orbit")
    print(f"radius range: {float(rn.min()):.1f} - {float(rn.max()):.1f} km")
    drift = float(torch.linalg.norm(states[-1, :3] - states[0, :3]))
    print(f"position after ~1 orbit vs start: {drift:.1f} km")


if __name__ == "__main__":
    main()
