"""Drop-in python-sgp4 migration: change the import, keep the code
(reference: astroz.api, api.py:86-359; the PyTorch port of
examples/python_sgp4_migration.py). python-sgp4 has no device argument,
so the port's ``twoline2rv`` takes one as a keyword (the card by
default).

Run: ``python examples_torch/python_sgp4_migration.py`` (on the card).
"""

import numpy as np

# from sgp4.api import Satrec, SatrecArray, jday   # before
from astroz_tpu_torch.api import Satrec, SatrecArray, jday  # after

L1 = "1 25544U 98067A   24001.50000000  .00016717  00000-0  10270-3 0  9993"
L2 = "2 25544  51.6400 200.0000 0001234  90.0000 270.0000 15.50000000000017"


def main(device="cuda", small=False):
    sat = Satrec.twoline2rv(L1, L2, device=device)
    jd, fr = jday(2024, 1, 1, 12, 0, 0)
    e, r, v = sat.sgp4(jd, fr)
    print(f"error={e}  r=({r[0]:.3f}, {r[1]:.3f}, {r[2]:.3f}) km")

    arr = SatrecArray([sat])
    jds = np.full(4, jd)
    frs = fr + np.arange(4) / 24.0
    e, r, v = arr.sgp4(jds, frs)
    print("batch shapes:", e.shape, r.shape, v.shape)
    print("altitudes:", np.round(np.linalg.norm(r[0], axis=-1) - 6378.137, 1))


if __name__ == "__main__":
    main()
