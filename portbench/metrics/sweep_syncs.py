"""Host waits on the card a sweep: the CUDA runtime calls that block the
host until the stream (or device) has finished, stream and device
synchronizes and synchronous copies, over the sweeps in the traced span.
Only calls inside a request's own span (``portbench.request``, around the
program's entry) count: the harness's waits, on each sweep's event and
on the card at the span's end, fall outside it. None where the trace
recorded no runtime call at all."""

import re

from portbench.trace import REQUEST

BLOCKING = re.compile(r"^cuda(StreamSynchronize|DeviceSynchronize|Memcpy"
                      r"(2D|3D)?(FromSymbol|ToSymbol)?)$")


def read(run):
    tr = run.trace
    if tr is None or run.cell.traffic["kind"] != "propagate" \
            or not tr.runtime:
        return None
    spans = tr.spans.get(REQUEST, [])
    waits = sum(bool(BLOCKING.match(name))
                and any(a <= t0 <= b for a, b in spans)
                for name, t0, _ in tr.runtime)
    return waits / tr.requests
