"""Host time of the program a sweep outside its waits (ms): each
``astroz.propagate`` span less the ``astroz.wait.*`` spans inside it,
summed over the traced span, over its sweeps: ``propagate``'s own
Python, the output allocation and the kernel launches. None where the
program recorded no ``astroz.propagate`` span (a program without
spans)."""

ROOT = "astroz.propagate"
WAIT = "astroz.wait."


def read(run):
    tr = run.trace
    if tr is None or run.cell.traffic["kind"] != "propagate":
        return None
    roots = [(a, b) for name, a, b in tr.host if name == ROOT]
    if not roots:
        return None
    waits = [(a, b) for name, a, b in tr.host if name.startswith(WAIT)]
    own = sum(b - a for a, b in roots) - sum(
        b - a for a, b in waits
        if any(r0 <= a and b <= r1 for r0, r1 in roots))
    return own * 1e-3 / tr.requests
