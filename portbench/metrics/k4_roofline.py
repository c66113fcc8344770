"""Share of the roofline of the screen kernel (K4, ``csrc/
screen_coarse.cu``) over the traced screens: ``roofline.screen_s`` (every
pair i < j at every epoch) over the kernel's device time."""

from portbench import roofline

KERNELS = r"screen_coarse_kernel"


def read(run):
    tr = run.trace
    t = run.cell.traffic
    if tr is None or t["kind"] != "screen_all":
        return None
    busy = sum(b - a for _, a, b in tr.kernels(KERNELS)) * 1e-6
    if busy <= 0.0:
        return None
    n = run.summary["near"] + run.summary["deep"]
    return 100.0 * roofline.screen_s(n, t["epochs"]) * tr.requests / busy
