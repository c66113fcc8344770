"""Share of the roofline of the fast path's kernels (K1, K2, K3, the HEO
escape, TABLES) over the traced sweeps: the bound of the work the sweeps
need (``roofline.fast_sweep_s``: every point's outputs written once,
SGP4's operations on near-earth points, SDP4's on deep ones) over the
device time of those kernels."""

from portbench import roofline

KERNELS = (r"sgp4_shallow_kernel|sgp4_deep_kernel|sgp4_f64_escape_kernel|"
           r"resonance_tables_kernel")


def read(run):
    tr = run.trace
    t = run.cell.traffic
    if tr is None or t["kind"] != "propagate" or t["method"] != "fast":
        return None
    busy = sum(b - a for _, a, b in tr.kernels(KERNELS)) * 1e-6
    if busy <= 0.0:
        return None
    n = t["epochs"] * tr.requests
    bound = roofline.fast_sweep_s(run.summary["near"] * n,
                                  run.summary["deep"] * n, t["velocities"])
    return 100.0 * bound / busy
