"""Precess a star's J2000 coordinates to a later epoch
(reference: examples/precess_star.zig — same star, same date; the
PyTorch port of examples/precess_star.py). Host arithmetic only:
``device`` is not used.

Run: ``python examples_torch/precess_star.py``.
"""

from astroz_tpu_torch.equatorial import Declination, RightAscension, precess
from astroz_tpu_torch.time import jday


def main(device="cuda", small=False):
    # Altair-like star: RA 19h 52m 02s, Dec +40 deg 10' 10" (J2000.0)
    ra = RightAscension(19, 52, 2.0)
    dec = Declination(40, 10, 10.0)

    jd, fr = jday(2005, 7, 30, 0, 0, 0.0)
    ra2, dec2 = precess(ra, dec, jd + fr)

    print(f"J2000.0:            RA {ra}  Dec {dec}")
    print(f"precessed to {2005}-07-30: RA {ra2}  Dec {dec2}")
    print(f"  RA  {ra.to_degrees():.5f} -> {ra2.to_degrees():.5f} deg")
    print(f"  Dec {dec.to_degrees():.5f} -> {dec2.to_degrees():.5f} deg")


if __name__ == "__main__":
    main()
