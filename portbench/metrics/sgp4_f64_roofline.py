"""Share of the roofline of the f64 kernel (``csrc/sgp4_f64.cu``'s row
walk) over the traced sweeps: ``roofline.f64_sweep_s`` of the points over
the kernel's device time."""

from portbench import roofline

KERNELS = r"sgp4_f64_walk_kernel"


def read(run):
    tr = run.trace
    t = run.cell.traffic
    if tr is None or t["kind"] != "propagate" or t["method"] != "f64":
        return None
    busy = sum(b - a for _, a, b in tr.kernels(KERNELS)) * 1e-6
    if busy <= 0.0:
        return None
    points = run.props * tr.requests
    return 100.0 * roofline.f64_sweep_s(points, t["velocities"]) / busy
