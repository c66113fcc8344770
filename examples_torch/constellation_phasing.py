"""Constellation phasing via J2-induced RAAN drift + sun-synchronous
orbit design (reference: examples/constellation_phasing.zig; the
PyTorch port of examples/constellation_phasing.py). Host arithmetic
only: ``device`` is not used.

Run: ``python examples_torch/constellation_phasing.py``.
"""

import math

from astroz_tpu_torch.constants import EARTH, SECONDS_PER_DAY, WGS84
from astroz_tpu_torch.spacecraft import phase_change_dv

MU = EARTH.mu
R_EQ = WGS84.radius_earth_km
J2 = WGS84.j2
DEG = math.pi / 180.0


def raan_drift_deg_day(alt_km: float, incl_rad: float) -> float:
    """Secular RAAN rate from the J2 zonal term (deg/day)."""
    a = R_EQ + alt_km
    n = math.sqrt(MU / a**3)  # rad/s
    rate = -1.5 * J2 * (R_EQ / a) ** 2 * n * math.cos(incl_rad)
    return rate / DEG * SECONDS_PER_DAY


def main(device="cuda", small=False):
    # --- Sun-synchronous orbit design -------------------------------------
    print("=== Sun-Synchronous Orbit Design ===")
    target = 360.0 / 365.25  # deg/day
    print(f"target RAAN drift: +{target:.4f} deg/day\n")
    print(f"{'alt (km)':>10} | {'inc (deg)':>10} | {'drift (deg/day)':>16}")
    for alt in (400, 500, 600, 700, 800, 900):
        a = R_EQ + alt
        n = math.sqrt(MU / a**3)
        denom = -1.5 * J2 * (R_EQ / a) ** 2 * n
        cos_i = target * DEG / SECONDS_PER_DAY / denom
        if abs(cos_i) <= 1.0:
            inc = math.degrees(math.acos(cos_i))
            print(f"{alt:>10.0f} | {inc:>10.2f} |"
                  f" {raan_drift_deg_day(alt, math.acos(cos_i)):>16.4f}")
        else:
            print(f"{alt:>10.0f} | {'N/A':>10} | {'N/A':>16}")

    # --- Plane separation by differential drift ---------------------------
    print("\n=== Constellation Deployment via Differential Drift ===")
    op_alt, park_alt, inc = 550.0, 520.0, 53.0 * DEG
    d_op = raan_drift_deg_day(op_alt, inc)
    d_park = raan_drift_deg_day(park_alt, inc)
    diff = abs(d_park - d_op)
    print(f"operational ({op_alt:.0f} km): {d_op:+.4f} deg/day")
    print(f"parking     ({park_alt:.0f} km): {d_park:+.4f} deg/day")
    print(f"differential drift: {diff:.4f} deg/day\n")
    print(f"{'plane':>6} | {'RAAN (deg)':>10} | {'drift wait (days)':>18}")
    for plane in range(6):
        raan = plane * 60.0
        print(f"{plane:>6} | {raan:>10.0f} | {raan / diff:>18.0f}")

    # --- In-plane phasing -------------------------------------------------
    print("\n=== In-Plane Phasing (phase-change dv) ===")
    a = R_EQ + op_alt
    for slots in (4, 8, 12):
        dv, t_transfer = phase_change_dv(a, 2 * math.pi / slots, mu=MU)
        print(f"{slots:>3} slots: shift {360 // slots:>3} deg costs"
              f" {dv * 1000:7.2f} m/s over {t_transfer / 3600:5.2f} h")


if __name__ == "__main__":
    main()
