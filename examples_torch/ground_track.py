"""TLE -> ECEF -> geodetic ground track (reference: examples/wcs.zig —
WorldCoordinateSystem.fromTle; the PyTorch port of
examples/ground_track.py: the whole track is one propagate with the
frame rotation in it).

Run: ``python examples_torch/ground_track.py`` (on the card).
"""

import numpy as np

from astroz_tpu_torch import build_catalog, propagate

TLE = """1 55909U 23035B   24187.51050877  .00023579  00000+0  16099-2 0  9998
2 55909  43.9978 311.8012 0011446 278.6226  81.3336 15.05761711 71371"""


def main(device="cuda", small=False):
    cat = build_catalog(TLE, device=device)
    epoch = float(cat.epochs_jd[0])

    # one orbit sampled every 2 minutes, geodetic output in degrees
    times = epoch + np.arange(0.0, 96.0, 2.0) / 1440.0
    geo, vel, err = propagate(cat, times, output="geodetic_deg")
    geo = geo.cpu().numpy()[:, 0]
    assert not err.any()

    print(f"ground track for NORAD {cat.satnum[0]} (one orbit):")
    print(f"{'t+min':>6} {'lat deg':>9} {'lon deg':>10} {'alt km':>8}")
    for k, (lat, lon, alt) in enumerate(geo):
        print(f"{2 * k:6d} {lat:9.3f} {lon:10.3f} {alt:8.1f}")

    # same state in ECEF for comparison (reference logs the raw WCS struct)
    ecef, _, _ = propagate(cat, times[:1], output="ecef")
    x, y, z = ecef.cpu().numpy()[0, 0]
    print(f"\nECEF at epoch: x={x:.3f} y={y:.3f} z={z:.3f} km")


if __name__ == "__main__":
    main()
