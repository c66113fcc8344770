"""Interplanetary mission planning + transfer analysis
(reference: examples mission/orbital-mechanics demos; the PyTorch port
of examples/mission_planning.py). The Hohmann budget runs on ``device``;
the mission plan and the bi-elliptic transfer on the host.

Run: ``python examples_torch/mission_planning.py`` (on the card).
"""

import math

from astroz_tpu_torch.mission import MissionParameters, plan_mission
from astroz_tpu_torch.orbital_mechanics import (bi_elliptic_transfer,
                                                hohmann_transfer)


def main(device="cuda", small=False):
    plan = plan_mission(MissionParameters(origin="earth",
                                          destination="mars"))
    print(f"Earth -> Mars Hohmann: {plan.total_dv_kms:.2f} km/s, "
          f"{plan.transfer_time_days:.0f} days")
    print(f"synodic period {plan.synodic_period_days:.0f} days, departure "
          f"phase angle {math.degrees(plan.phase_angle_rad):.1f} deg")

    leo_geo = hohmann_transfer(6678.0, 42164.0, device=device)
    print(f"LEO -> GEO: dv1={leo_geo.delta_v1:.3f} "
          f"dv2={leo_geo.delta_v2:.3f} km/s in "
          f"{leo_geo.transfer_time/3600:.2f} h")

    bi = bi_elliptic_transfer(7000.0, 140000.0, 420000.0)
    print(f"bi-elliptic 7000->140000 km: {bi.total_delta_v:.3f} km/s")


if __name__ == "__main__":
    main()
