"""Share of the roofline of the output epilogue (``csrc/finalize.cu``)
over the traced sweeps: ``roofline.finalize_s`` (the planes read once,
the caller's layout written once) over the kernel's device time. None
where the epilogue launched nothing (TEME in the sweep's own layout)."""

from portbench import roofline

KERNELS = r"\b(flat_kernel|tile_kernel)<"


def read(run):
    tr = run.trace
    t = run.cell.traffic
    if tr is None or t["kind"] != "propagate":
        return None
    busy = sum(b - a for _, a, b in tr.kernels(KERNELS)) * 1e-6
    if busy <= 0.0:
        return None
    points = run.props * tr.requests
    bound = roofline.finalize_s(points, 4 if t["method"] == "fast" else 8,
                                t["velocities"], t["layout"], t["output"])
    return 100.0 * bound / busy
