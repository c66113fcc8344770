"""Write-time output layouts and the velocities=False fast path (the
PyTorch port of examples/output_layouts.py).

The reference lets callers pick time-/satellite-major at write time and
propagate into caller-provided buffers (Constellation.zig:46-51,
satrec.zig:896-988); here the same control is the ``layout=`` /
``velocities=`` arguments of :func:`astroz_tpu_torch.propagate`, and the
``planes`` layout is the kernels' own output buffers.

Run: ``python examples_torch/output_layouts.py`` (on the card).
"""

import numpy as np
import torch

from astroz_tpu_torch import build_catalog, propagate

TLE = """1 25544U 98067A   24001.50000000  .00016717  00000-0  10270-3 0  9993
2 25544  51.6400 200.0000 0001234  90.0000 270.0000 15.50000000000017
1 28626U 05004A   24186.00000000 -.00000098  00000+0  00000+0 0  9998
2 28626   0.0163 279.8379 0003069  20.3251 343.1766  1.00270142 70992"""


def main(device="cuda", small=False):
    cat = build_catalog(TLE, device=device)
    jd = cat.epochs_jd[0] + np.linspace(0.0, 1.0, 25)

    # classic time-major: (n_times, n_sats, 3)
    r, v, err = propagate(cat, jd)
    print("time_major:", tuple(r.shape))

    # satellite-major: (n_sats, n_times, 3)
    r_s, v_s, _ = propagate(cat, jd, layout="sat_major")
    print("sat_major: ", tuple(r_s.shape))

    # planes: (3, n_times, n_sats) component planes, the kernels' own
    # buffers; fastest option for consumers that process per component
    r_p, v_p, _ = propagate(cat, jd, layout="planes")
    print("planes:    ", tuple(r_p.shape))
    assert torch.allclose(r_p.permute(1, 2, 0), r)

    # velocities=False runs kernels that never compute the velocity terms
    # (the reference's +30% fast path, astroz api.py:23)
    r_n, v_n, _ = propagate(cat, jd, velocities=False)
    assert v_n is None
    assert torch.equal(r_n, r)
    print("velocities=False: v is", v_n, "- positions bit-identical")


if __name__ == "__main__":
    main()
