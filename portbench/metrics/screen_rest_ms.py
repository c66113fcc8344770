"""The screen's glue a screen: the benchmark's span around each
``screen_all`` call less the device time, inside that span, of the
screen kernel (K4) and of the sweep kernels that propagate the
positions: parking, the count fetch, sort, refine, copies to numpy and
the host's own time, averaged over the traced screens."""

from portbench.trace import REQUEST

#: the screen kernel and the fast path's sweep kernels
KERNELS = (r"screen_coarse_kernel|sgp4_shallow_kernel|sgp4_deep_kernel|"
           r"sgp4_f64_escape_kernel|resonance_tables_kernel")


def read(run):
    tr = run.trace
    if tr is None or run.cell.traffic["kind"] != "screen_all":
        return None
    spans = tr.spans.get(REQUEST, [])
    kernels = tr.kernels(KERNELS)
    if not spans or not kernels:
        return None
    rest = 0.0
    for a, b in spans:
        inside = sum(min(k1, b) - max(k0, a) for _, k0, k1 in kernels
                     if k1 > a and k0 < b)
        rest += (b - a) - inside
    return rest / len(spans) * 1e-3
