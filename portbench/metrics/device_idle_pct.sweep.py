"""Idle share of the card over the traced span of sweeps: 100 * (1 -
busy / span), busy the union of kernels, copies and fills."""


def read(run):
    tr = run.trace
    if tr is None or run.cell.traffic["kind"] != "propagate" \
            or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
