"""Idle share of the card over the traced span of sweeps that falls
while the host is inside the program: 100 * (the part of the card's idle
stretches that lies inside ``astroz.propagate`` spans) / span. The card
idle that the program's host path causes; ``device_idle_pct.sweep`` less
this is the idle of the client and of the profiler. None where the
program recorded no ``astroz.propagate`` span (a program without
spans)."""

ROOT = "astroz.propagate"


def read(run):
    tr = run.trace
    if tr is None or run.cell.traffic["kind"] != "propagate" \
            or not tr.device:
        return None
    roots = [(a, b) for name, a, b in tr.host if name == ROOT]
    if not roots:
        return None
    inside = sum(max(0.0, min(b, r1) - max(a, r0))
                 for a, b in tr.gaps() for r0, r1 in roots)
    return 100.0 * inside * 1e-6 / tr.window_s
