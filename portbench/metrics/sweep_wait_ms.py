"""Host time a sweep spent waiting on the card (ms): the program's
``astroz.wait.*`` spans summed over the traced span, over its sweeps.
How long the client is held back from sending ahead. None where the
program recorded no ``astroz.propagate`` span (a program without
spans)."""

ROOT = "astroz.propagate"
WAIT = "astroz.wait."


def read(run):
    tr = run.trace
    if tr is None or run.cell.traffic["kind"] != "propagate" \
            or not any(name == ROOT for name, _, _ in tr.host):
        return None
    waited = sum(b - a for name, a, b in tr.host if name.startswith(WAIT))
    return waited * 1e-3 / tr.requests
