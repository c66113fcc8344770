"""A screen's pair list against the reference's all-vs-all search.

One number, ``gap_km``: the widest of, for each pair the program reports,
its distance's gap from the reference's minimum for that pair, how much
farther the reference puts the pair at the program's epoch than at its
minimum, and how far beyond the threshold the reference puts it; and for
each pair the reference finds below the threshold that the program
misses, how far below the threshold it lies. A pair dropped, added,
moved in time or mismeasured widens it."""

from __future__ import annotations

import numpy as np
import torch

from ..reference import catalog as ref
from . import worse
from ..reference.pairs import close_pairs, pair_distances


def reference_positions(ref_cat, jd, fr, dtype, device):
    r, _, err = ref.propagate(ref_cat, jd, fr, dtype=dtype, device=device)
    return r, err == 0


def readings(pairs, ref_cat, traffic, jd, fr, device) -> dict:
    """``pairs``: (i, j, d_km, t_index) numpy arrays as ``screen_all``
    returns them."""
    thr = float(traffic["threshold_km"])
    ii, jj, dd, tt = (np.asarray(x) for x in pairs)
    r, ok = reference_positions(ref_cat, jd, fr, torch.float64, device)
    gap = 0.0
    for a in range(0, len(ii), 4096):
        i = torch.as_tensor(ii[a:a + 4096], device=device)
        j = torch.as_tensor(jj[a:a + 4096], device=device)
        t = torch.as_tensor(tt[a:a + 4096], device=device)
        d = torch.as_tensor(dd[a:a + 4096], device=device,
                            dtype=torch.float64)
        dist = pair_distances(r, ok, i, j)
        dmin = dist.min(dim=0).values
        valid = (t >= 0) & (t < dist.shape[0])
        d_at = torch.where(valid, dist[t.clamp(0, dist.shape[0] - 1),
                                       torch.arange(len(t), device=device)],
                           torch.inf)
        parts = torch.stack([(d - dmin).abs(), d_at - dmin,
                             (dmin - thr).clamp(min=0.0)])
        gap = worse(gap, float(parts.max()) if not bool(
            torch.isnan(parts).any()) else float("nan"))
    found = set(zip(ii.tolist(), jj.tolist()))
    ref_pairs = close_pairs(r, ok, thr)
    below = {k: dm for k, (dm, _) in ref_pairs.items() if dm < thr}
    for key, dm in below.items():
        if key not in found:
            gap = worse(gap, thr - dm)
    return {"gap_km": gap, "pairs": len(ii), "reference_pairs": len(below)}


def judge(req_out, ref_cat, traffic, jd, fr, device) -> dict:
    return readings(req_out, ref_cat, traffic, jd, fr, device)


def control(ref_cat, traffic, jd, fr, device) -> tuple:
    """The reference in float32 put in the program's place: its own pair
    search on float32 positions, as (i, j, d, t) arrays."""
    r, ok = reference_positions(ref_cat, jd, fr, torch.float32, device)
    found = close_pairs(r, ok, float(traffic["threshold_km"]))
    keys = sorted(found)
    return (np.asarray([k[0] for k in keys], np.int64),
            np.asarray([k[1] for k in keys], np.int64),
            np.asarray([found[k][0] for k in keys], np.float64),
            np.asarray([found[k][1] for k in keys], np.int64))
