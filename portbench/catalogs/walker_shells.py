"""Near-circular Walker shells of a megaconstellation.

Each shell of the configuration is ``planes`` planes of ``per_plane``
satellites at one altitude and inclination: RAANs evenly spaced, the
satellites of a plane evenly spaced in argument of latitude, plane p's
shifted by ``phasing * p * 360 / (planes * per_plane)`` degrees (Walker
delta). The seed draws small jitters of the phase, the eccentricity and
B*; the number of satellites and their orbits do not change with it."""

from __future__ import annotations

import math

import numpy as np

from .. import tle_text


def rev_per_day(alt_km: float, mu: float, re_km: float) -> float:
    a = re_km + alt_km
    return math.sqrt(mu / a ** 3) * 86400.0 / (2.0 * math.pi)


def text(config: dict, seed: int) -> str:
    rng = np.random.default_rng(seed)
    jit = config["jitter"]
    cols = {k: [] for k in ("inclo", "nodeo", "mo", "rev_day")}
    for sh in config["shells"]:
        planes, per = sh["planes"], sh["per_plane"]
        p = np.repeat(np.arange(planes), per)
        k = np.tile(np.arange(per), planes)
        cols["inclo"].append(np.full(planes * per, sh["inclination_deg"]))
        cols["nodeo"].append(360.0 * p / planes)
        cols["mo"].append(360.0 * k / per
                          + sh["phasing"] * p * 360.0 / (planes * per))
        cols["rev_day"].append(np.full(planes * per, rev_per_day(
            sh["altitude_km"], config["mu_km3_s2"], config["re_km"])))
    c = {k: np.concatenate(v) for k, v in cols.items()}
    n = len(c["inclo"])
    lo, hi = jit["phase_deg"]
    return tle_text.catalog(
        config["epoch_jd"], rng.uniform(*jit["ecco"], n), c["inclo"],
        c["nodeo"], np.zeros(n), c["mo"] + rng.uniform(lo, hi, n),
        c["rev_day"], rng.uniform(*jit["bstar"], n))
