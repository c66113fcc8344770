"""What decides ``correct``: for each request kind of ``loop.KINDS`` a
module of the same name whose ``readings(...)`` compares one timed
request's outputs with the reference and returns the numbers that
``limits/<cell>.json`` bounds."""

import numpy as np


def worse(a, b):
    """The larger of two readings; NaN where either is NaN."""
    return float("nan") if np.isnan(a) or np.isnan(b) else max(a, b)


def worst(readings_list) -> dict:
    """The larger of each number over several requests."""
    out = {}
    for rd in readings_list:
        for k, x in rd.items():
            out[k] = worse(out.get(k, x), x)
    return out
