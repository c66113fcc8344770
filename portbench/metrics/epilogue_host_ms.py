"""Host time of the output epilogue a sweep (ms): the program's
``astroz.finalize`` spans (``ops.cuda_finalize.finalize``: the GMST row,
the output allocation and the epilogue kernel's launch) less the
``astroz.wait.*`` spans inside them, summed over the traced span, over
its sweeps. None where the program recorded no ``astroz.finalize`` span
(a program without the span, or an epilogue that is the identity and
launches nothing)."""

SPAN = "astroz.finalize"
WAIT = "astroz.wait."


def read(run):
    tr = run.trace
    if tr is None or run.cell.traffic["kind"] != "propagate":
        return None
    spans = [(a, b) for name, a, b in tr.host if name == SPAN]
    if not spans:
        return None
    waits = [(a, b) for name, a, b in tr.host if name.startswith(WAIT)]
    own = sum(b - a for a, b in spans) - sum(
        b - a for a, b in waits
        if any(s0 <= a and b <= s1 for s0, s1 in spans))
    return own * 1e-3 / tr.requests
