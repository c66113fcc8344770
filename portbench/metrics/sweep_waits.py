"""Host waits on the card a sweep, as the program names them: its
``astroz.wait.*`` spans (each one call that blocks the host until the
card has finished its queued work: a numpy-to-card copy of epochs in
``propagate``) over the sweeps in the traced span. The program's own
count of what ``sweep_syncs`` counts from the CUDA runtime calls. None
where the program recorded no ``astroz.propagate`` span (a program
without spans)."""

ROOT = "astroz.propagate"
WAIT = "astroz.wait."


def read(run):
    tr = run.trace
    if tr is None or run.cell.traffic["kind"] != "propagate" \
            or not any(name == ROOT for name, _, _ in tr.host):
        return None
    return sum(name.startswith(WAIT) for name, _, _ in tr.host) \
        / tr.requests
