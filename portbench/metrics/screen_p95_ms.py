"""95th percentile of every screen's time in the window, from the call to
its numpy pair list (``statistics.quantiles``, exclusive method). Host
clock."""

import statistics


def read(run):
    if run.cell.traffic["kind"] != "screen_all":
        return None
    times = [(r.end - r.start) * 1e3 for r in run.window.requests]
    if len(times) < 20:
        return None
    return statistics.quantiles(times, n=20)[18]
