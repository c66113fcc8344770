"""All-vs-all conjunction screening over a small shell (the PyTorch port
of examples/conjunction_screen.py; the port's screen takes no ``block=``:
its coarse pass is the K4 kernel at every size).

Run: ``python examples_torch/conjunction_screen.py`` (on the card).
"""

import numpy as np

from astroz_tpu_torch import build_catalog, screen_all


def main(device="cuda", small=False):
    rng = np.random.default_rng(1)
    lines = []
    for k in range(64):
        raan, mo = rng.uniform(0, 360), rng.uniform(0, 360)
        lines.append(f"1 {20000+k:05d}U 98067A   24001.50000000  .00000000"
                     f"  00000-0  00000+0 0  9990")
        lines.append(f"2 {20000+k:05d}  53.0000 {raan:8.4f} 0001000  "
                     f"90.0000 {mo:8.4f} 15.20000000000010")
    cat = build_catalog("\n".join(lines), device=device)
    times = cat.epochs_jd[0] + np.linspace(0, 0.25, 120)
    i, j, dmin, tmin = screen_all(cat, times, threshold_km=100.0)
    print(f"{len(i)} pairs within 100 km:")
    for a, b, d in list(zip(i, j, dmin))[:10]:
        print(f"  {cat.satnum[a]} - {cat.satnum[b]}: {d:.2f} km")


if __name__ == "__main__":
    main()
