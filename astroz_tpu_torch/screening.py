"""Conjunction screening: single-target and all-vs-all.

Counterpart of ``astroz_tpu/screening.py``:

* :func:`screen_target`: the minimum distance of every catalog satellite
  to one target over the epochs, a plain torch reduction on the
  catalog's device.
* :func:`screen_all`: every pair closer than a threshold. The positions
  come from ``propagate(..., velocities=False, layout="planes")``; the
  coarse pass is kernel K4 (``ops/cuda_screen.py``), the exact
  min-over-time squared distance of every pair j > i in column chunks
  (+inf at and below the diagonal); the threshold and the compaction run
  on the device, and the host receives only the candidate indices; the
  refine (plain torch on the device) recovers each survivor's distance
  and epoch.

Failed lanes park at distinct far points, so they never screen as close
to each other or to anything else.

Not ported: the JAX package's XLA Gram-expansion coarse pass and its
guard band (its non-Pallas fallback: K4 serves every size on the card),
with the ``block=``, ``engine=`` and ``_interpret=`` keywords that select
it, and the device-mesh passes (``mesh=``, ``screen_all_ring``; ROADMAP
queue 1, item 13). :func:`screen_all` raises ``TypeError`` on those
keywords, as on any unknown one.
"""

from __future__ import annotations

import warnings
from typing import Iterable, Optional, Tuple, Union

import numpy as np
import torch

from .ops.cuda_screen import coarse_min_all
from .ops.fastmath import sqrt_rn
from .propagation import SatCatalog, build_catalog, propagate
from .tle import Tle

#: coarse-stage park coordinate of failed lanes, km: far from everything
_PAD_POS = 1.0e7


def _positions_planes_f32(cat: SatCatalog, jd, fr=None,
                          method: str = "fast",
                          park_offset: float = 0.0) -> torch.Tensor:
    """(3, n_times, n_sats) f32 TEME position planes on the catalog's
    device. Failed lanes park at per-satellite distinct points 1e6 km
    apart (a shared point would make two failed satellites a 0-km
    conjunction); ``park_offset`` keeps the park points of different
    catalogs apart too."""
    r, _, err = propagate(cat, jd, fr, velocities=False, method=method,
                          layout="planes")
    park = (_PAD_POS + park_offset
            + 1.0e6 * torch.arange(r.shape[2], dtype=torch.float32,
                                   device=r.device))
    return torch.where((err != 0)[None], park[None, None, :],
                       r.to(torch.float32))


# ---------------------------------------------------------------------------
# Single-target screening
# ---------------------------------------------------------------------------


def screen_target(cat: SatCatalog, target: Union[str, Tle, SatCatalog],
                  jd, fr=None, *, threshold_km: Optional[float] = None,
                  method: str = "fast"):
    """Minimum distance of every catalog satellite to one target.

    ``target`` is TLE text, a :class:`~astroz_tpu_torch.tle.Tle` or a
    one-satellite catalog. Returns ``(min_dist_km, t_index)`` tensors of
    shape (n_sats,) on the catalog's device (f32 and int64), plus a
    boolean mask ``min_dist_km < threshold_km`` when that is given.
    """
    if isinstance(target, SatCatalog):
        tcat = target
    else:
        tcat = build_catalog([target] if isinstance(target, Tle) else target,
                             grav=cat.grav, device=cat.device)
    if len(tcat) != 1:
        raise ValueError(
            f"screen_target expects exactly one target satellite, got "
            f"{len(tcat)}; use screen_all for set-vs-set screening")
    r_all = _positions_planes_f32(cat, jd, fr, method)       # (3, T, N)
    # the target's park points are offset, so that a failed target and a
    # failed catalog satellite never coincide
    r_tgt = _positions_planes_f32(tcat, jd, fr, method,
                                  park_offset=-5.0e5)        # (3, T, 1)
    dx, dy, dz = r_all - r_tgt
    min_d, t_idx = sqrt_rn(dx * dx + dy * dy + dz * dz).min(dim=0)
    if threshold_km is not None:
        return min_d, t_idx, min_d < threshold_km
    return min_d, t_idx


# ---------------------------------------------------------------------------
# All-vs-all screening
# ---------------------------------------------------------------------------


def _refine_pairs_planes(r_planes, ii, jj):
    """Exact min-over-time distances and their first epoch index for the
    pairs ``(ii[p], jj[p])`` on (3, T, N) planes, by direct difference."""
    dx, dy, dz = r_planes[:, :, ii] - r_planes[:, :, jj]    # (T, P) each
    return sqrt_rn(dx * dx + dy * dy + dz * dz).min(dim=0)


def _compact_mask(mask) -> Tuple[np.ndarray, np.ndarray]:
    """(row, col) int64 host indices of the True entries of a boolean
    matrix, compacted on its device: the host receives the indices,
    never the matrix."""
    ii, jj = torch.nonzero(mask, as_tuple=True)
    return ii.cpu().numpy(), jj.cpu().numpy()


def _chunk_candidates(dmin, j0: int, thr2: float):
    """Candidate pairs ``(i, j)`` of one coarse column chunk: squared
    distance at most ``thr2`` (the chunk is +inf at and below the
    diagonal, so only pairs ``j > i`` pass), as int64 host arrays. One
    count fetch; a chunk without candidates compacts nothing."""
    mask = dmin <= thr2
    if int(mask.sum()) == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    ii, jj = _compact_mask(mask)
    return ii, jj + j0


def _refine(r_planes, ci: np.ndarray, cj: np.ndarray):
    """Refine candidate pairs on the planes' device, in chunks that keep
    the (3, T, P) gathers bounded: (min distance f32, epoch index int64)
    host arrays."""
    n_times = r_planes.shape[1]
    chunk_cap = max(1 << 12, (1 << 26) // max(n_times, 1))
    dmin = np.empty(ci.size, np.float32)
    tmin = np.empty(ci.size, np.int64)
    for c0 in range(0, ci.size, chunk_cap):
        c1 = min(c0 + chunk_cap, ci.size)
        d, t = _refine_pairs_planes(
            r_planes, torch.as_tensor(ci[c0:c1], device=r_planes.device),
            torch.as_tensor(cj[c0:c1], device=r_planes.device))
        dmin[c0:c1] = d.cpu().numpy()
        tmin[c0:c1] = t.cpu().numpy()
    return dmin, tmin


def _screen_planes(r_planes, chunks: Iterable, threshold_km: float,
                   max_pairs: int):
    """The screen after propagation: coarse column chunks ``(j0, dmin)``
    of ``r_planes`` -> candidates -> refine -> pairs below the
    threshold, as :func:`screen_all` returns them."""
    # a relative 1e-6 cushion, so that a boundary pair never flips
    # between the coarse d^2 compare and the refine's sqrt-then-compare
    thr2 = float(np.float32((threshold_km * (1.0 + 1.0e-6)) ** 2))
    found = [_chunk_candidates(dmin, j0, thr2) for j0, dmin in chunks]
    ci = np.concatenate([f[0] for f in found] + [np.empty(0, np.int64)])
    cj = np.concatenate([f[1] for f in found] + [np.empty(0, np.int64)])
    if ci.size > max_pairs:
        warnings.warn(
            f"screen_all: coarse candidate set ({ci.size}) exceeds "
            f"max_pairs ({max_pairs}); candidates are truncated BEFORE "
            "the exact refine, so real conjunctions may be dropped — "
            "raise max_pairs or lower threshold_km", stacklevel=3)
        ci, cj = ci[:max_pairs], cj[:max_pairs]
    if ci.size == 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, np.float64), np.empty(0, np.int64))
    dmin, tmin = _refine(r_planes, ci, cj)
    hit = dmin < threshold_km
    ci, cj = ci[hit], cj[hit]
    d_out = dmin[hit].astype(np.float64)
    t_out = tmin[hit]
    order = np.lexsort((cj, ci))  # deterministic (i, j) order
    return ci[order], cj[order], d_out[order], t_out[order]


def screen_all(cat: SatCatalog, jd, fr=None, *, threshold_km: float = 5.0,
               method: str = "fast", max_pairs: int = 10_000_000):
    """All-vs-all conjunction screen over the given epochs.

    Returns ``(i, j, min_dist_km, t_index)`` numpy arrays (int64, int64,
    float64, int64) of every pair with minimum separation below
    ``threshold_km``, ``i < j``, sorted by ``(i, j)``. Candidates beyond
    ``max_pairs`` are dropped before the refine, with a warning.
    """
    r_planes = _positions_planes_f32(cat, jd, fr, method)
    return _screen_planes(r_planes, coarse_min_all(r_planes), threshold_km,
                          max_pairs)
