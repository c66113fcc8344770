"""Kernel launches a sweep: the kernels in the traced span's device
trace, over the sweeps in it."""


def read(run):
    tr = run.trace
    if tr is None or run.cell.traffic["kind"] != "propagate":
        return None
    kernels = tr.kernels()
    if not kernels:
        return None
    return len(kernels) / tr.requests
