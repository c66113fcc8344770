"""A mixed LEO / GEO / GPS-HEO catalog (the upstream benchmark's draw).

The regimes, their shares and their element ranges come from the
configuration. Every seed gives the same number of lanes of each regime,
and HEO eccentricities one draw in each of as many equal bins, so that a
seed changes the catalog and not the amount of work: which lanes are
deep, resonant or recomputed in f64 varies, how many does not."""

from __future__ import annotations

import numpy as np

from .. import tle_text


def _uniform(rng, lohi, n):
    return rng.uniform(lohi[0], lohi[1], n)


def _stratified(rng, lohi, n):
    """One uniform draw in each of ``n`` equal bins of ``lohi``, shuffled."""
    u = (rng.permutation(n) + rng.uniform(0.0, 1.0, n)) / max(n, 1)
    return lohi[0] + (lohi[1] - lohi[0]) * u


def counts(config: dict) -> dict:
    """Lanes of each regime: the shares of ``n_sats``, rounded, the first
    regime taking the rest."""
    n = config["n_sats"]
    regimes = config["regimes"]
    out = {name: int(round(r["share"] * n)) for name, r in regimes.items()}
    first = next(iter(regimes))
    out[first] = n - sum(v for k, v in out.items() if k != first)
    return out


def text(config: dict, seed: int) -> str:
    rng = np.random.default_rng(seed)
    n = config["n_sats"]
    kinds = counts(config)
    parts = {k: [] for k in ("ecco", "inclo", "rev_day")}
    for name, r in config["regimes"].items():
        m = kinds[name]
        if "rev_day_normal" in r:
            mu, sd = r["rev_day_normal"]
            rev = rng.normal(mu, sd, m)
        else:
            rev = _uniform(rng, r["rev_day"], m)
        draw = _stratified if r.get("ecco_stratified") else _uniform
        parts["rev_day"].append(rev)
        parts["ecco"].append(draw(rng, r["ecco"], m))
        parts["inclo"].append(_uniform(rng, r["inclo_deg"], m))
    order = rng.permutation(n)
    cols = {k: np.concatenate(v)[order] for k, v in parts.items()}
    return tle_text.catalog(
        config["epoch_jd"], cols["ecco"], cols["inclo"],
        rng.uniform(0.0, 360.0, n), rng.uniform(0.0, 360.0, n),
        rng.uniform(0.0, 360.0, n), cols["rev_day"],
        _uniform(rng, config["bstar"], n))
