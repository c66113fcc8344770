"""Propagate a catalog and print ground tracks (reference: the Cesium
demo pipeline, examples/README.md; the PyTorch port of
examples/propagate_catalog.py).

Run: ``python examples_torch/propagate_catalog.py`` (on the card).
"""

import numpy as np

from astroz_tpu_torch import Constellation

TLE = """ISS (ZARYA)
1 25544U 98067A   24001.50000000  .00016717  00000-0  10270-3 0  9993
2 25544  51.6400 200.0000 0001234  90.0000 270.0000 15.50000000000017
GOES-16
1 41866U 16071A   24001.50000000 -.00000200  00000+0  00000+0 0  9997
2 41866   0.0400 280.0000 0000900  90.0000 270.0000  1.00271000 26000"""


def main(device="cuda", small=False):
    con = Constellation(TLE, device=device)
    print(f"{con.num_satellites} satellites ({con.num_deep_space} "
          f"deep-space)")

    minutes = np.arange(0.0, 120.0, 10.0)
    geo, _, err = con.propagate(minutes, start_time=con.epochs_jd[0],
                                output="geodetic", velocities=False)
    geo = geo.cpu().numpy()
    for k, name in enumerate(con.names):
        lat, lon = np.degrees(geo[0, k, 0]), np.degrees(geo[0, k, 1])
        alt = geo[0, k, 2]
        print(f"{name}: lat {lat:7.2f}  lon {lon:8.2f}  alt {alt:9.1f} km")


if __name__ == "__main__":
    main()
