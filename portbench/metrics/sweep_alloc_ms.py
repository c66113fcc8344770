"""Host time a sweep spent allocating its outputs (ms): the program's
``astroz.alloc`` spans (the kernels' and the epilogue's new output
tensors) summed over the traced span, over its sweeps. None where the
program recorded no ``astroz.propagate`` span (a program without
spans)."""

ROOT = "astroz.propagate"
ALLOC = "astroz.alloc"


def read(run):
    tr = run.trace
    if tr is None or run.cell.traffic["kind"] != "propagate" \
            or not any(name == ROOT for name, _, _ in tr.host):
        return None
    spent = sum(b - a for name, a, b in tr.host if name == ALLOC)
    return spent * 1e-3 / tr.requests
