"""Conjunction screening: single-target and all-vs-all.

Counterpart of ``astroz_tpu/screening.py``:

* :func:`screen_target`: the minimum distance of every catalog satellite
  to one target over the epochs, a plain torch reduction on the
  catalog's device.
* :func:`screen_all`: every pair closer than a threshold. The positions
  come from ``propagate(..., velocities=False, layout="planes")``; the
  coarse pass is kernel K4 in candidate mode
  (``ops/cuda_screen.coarse_candidates``): the exact min-over-time
  squared distance of every pair j > i, thresholded inside the kernel,
  so that the device writes only the candidate pairs and the host
  receives only their indices; the refine (plain torch on the device)
  recovers each survivor's distance and epoch.

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
from typing import Callable, Optional, Union

import numpy as np
import torch

from .ops import cuda_screen
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


def _refine(r_planes, ii, jj):
    """Refine candidate pairs (int64 tensors on the planes' device) in
    chunks that keep the (3, T, P) gathers bounded: (min distance f32,
    epoch index int64) tensors on that device."""
    n_times = r_planes.shape[1]
    chunk_cap = max(1 << 12, (1 << 26) // max(n_times, 1))
    parts = [_refine_pairs_planes(r_planes, ii[c0:c0 + chunk_cap],
                                  jj[c0:c0 + chunk_cap])
             for c0 in range(0, len(ii), chunk_cap)]
    return torch.cat([d for d, _ in parts]), torch.cat([t for _, t in parts])


def _screen_planes(r_planes, threshold_km: float, max_pairs: int,
                   coarse: Optional[Callable] = None):
    """The screen after propagation: coarse candidates of ``r_planes``
    (``coarse(r_planes, thr2)``, K4's candidate mode unless given; (i, j)
    tensors sorted by (i, j)) -> refine on the device -> pairs below the
    threshold, as :func:`screen_all` returns them. The host receives the
    candidate count and then the refined candidates, in two copies."""
    # a relative 1e-6 cushion, so that a boundary pair never flips
    # between the coarse d^2 compare and the refine's sqrt-then-compare
    thr2 = float(np.float32((threshold_km * (1.0 + 1.0e-6)) ** 2))
    ii, jj = (coarse or cuda_screen.coarse_candidates)(r_planes, thr2)
    if len(ii) > max_pairs:
        warnings.warn(
            f"screen_all: coarse candidate set ({len(ii)}) exceeds "
            f"max_pairs ({max_pairs}); candidates are truncated BEFORE "
            "the exact refine, so real conjunctions may be dropped — "
            "raise max_pairs or lower threshold_km", stacklevel=3)
        ii, jj = ii[:max_pairs], jj[:max_pairs]
    if len(ii) == 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, np.float64), np.empty(0, np.int64))
    dmin, tmin = _refine(r_planes, ii, jj)
    ci, cj, t = torch.stack([ii, jj, tmin]).cpu().numpy()
    d = dmin.cpu().numpy()
    hit = d < threshold_km
    return ci[hit], cj[hit], d[hit].astype(np.float64), t[hit]


def screen_all(cat: SatCatalog, jd, fr=None, *, threshold_km: float = 5.0,
               method: str = "fast", max_pairs: int = 10_000_000):
    """All-vs-all conjunction screen over the given epochs.

    Returns ``(i, j, min_dist_km, t_index)`` numpy arrays (int64, int64,
    float64, int64) of every pair with minimum separation below
    ``threshold_km``, ``i < j``, sorted by ``(i, j)``. Candidates beyond
    ``max_pairs`` are dropped before the refine, with a warning.
    """
    r_planes = _positions_planes_f32(cat, jd, fr, method)
    return _screen_planes(r_planes, threshold_km, max_pairs)
