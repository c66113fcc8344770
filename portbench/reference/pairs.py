"""All-vs-all close pairs by a plain sweep along x.

At each epoch the points are sorted by x; a pair closer than ``thr`` is
closer than ``thr`` in x, so it lies within the run of sorted neighbours
whose x differs by less than ``thr``. The search compares every point
with its o-th neighbour for o = 1, 2, ... until no neighbour at offset o
is within ``thr`` in x at any epoch: every pair within ``thr`` is found,
by direct differences in the positions' dtype."""

from __future__ import annotations

import torch


def close_pairs(r, ok, thr_km: float, rows: int = 240):
    """Every pair ``i < j`` whose distance at some epoch where both are
    ``ok`` is at most ``thr_km``: ``{(i, j): (d_min, t_of_d_min)}`` over
    (T, N, 3) positions ``r`` and (T, N) bool ``ok``."""
    best = {}
    n_t = r.shape[0]
    for t0 in range(0, n_t, rows):
        rb, okb = r[t0:t0 + rows], ok[t0:t0 + rows]
        x = torch.where(okb, rb[..., 0], torch.inf)
        order = torch.argsort(x, dim=1)
        xs = torch.gather(x, 1, order)
        o = 1
        while o < xs.shape[1]:
            near = (xs[:, o:] - xs[:, :-o]) <= thr_km
            if not bool(near.any()):
                break
            tt, kk = torch.nonzero(near, as_tuple=True)
            a, b = order[tt, kk], order[tt, kk + o]
            d = torch.linalg.vector_norm(rb[tt, a] - rb[tt, b], dim=-1)
            hit = d <= thr_km
            for ti, ai, bi, di in zip((tt[hit] + t0).tolist(),
                                      a[hit].tolist(), b[hit].tolist(),
                                      d[hit].tolist()):
                key = (min(ai, bi), max(ai, bi))
                if key not in best or di < best[key][0]:
                    best[key] = (di, ti)
            o += 1
    return best


def pair_distances(r, ok, i, j):
    """(T, P) distances of the pairs ``(i[p], j[p])`` (int64 tensors),
    +inf at the epochs where either is not ``ok``."""
    d = torch.linalg.vector_norm(r[:, i] - r[:, j], dim=-1)
    return torch.where(ok[:, i] & ok[:, j], d, torch.inf)
