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
  recovers each survivor's distance and epoch. With ``mesh=`` of more
  than one device the coarse pass is split along time, one slice a
  device, and the slices' pairs are merged.
* :func:`screen_all_ring`: the same screen with the satellite axis
  sharded over a mesh: each device propagates its block of satellites,
  the blocks pass around a ring of the devices, and each device runs K4
  on its own rows against the visiting columns (K4's triangle at the
  first step, its rectangle mode after), so that no device holds more
  than two blocks of positions; the refine gathers only the candidates'
  columns.

Failed lanes park at distinct far points, so they never screen as close
to each other or to anything else.

Not ported: the JAX package's XLA Gram-expansion coarse passes and their
guard band (its non-Pallas fallbacks, single-device and on a mesh: K4's
direct difference serves every size on the card and gives the same pairs
after the refine), with the ``block=``, ``engine=`` and ``_interpret=``
keywords that select them. :func:`screen_all` raises ``TypeError`` on
those keywords, as on any unknown one.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional, Union

import numpy as np
import torch

from .ops import cuda_screen
from .ops.fastmath import sqrt_rn
from .parallel.mesh import (Mesh, _sharded_f64, make_mesh,
                            stage_sharded_fast)
from .profiling import span
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
    return _parked(r, err != 0, 0, park_offset)


def _parked(r, bad, first_col: int, park_offset: float = 0.0):
    """(3, T, N) planes ``r`` as f32, with the lanes where ``bad`` (T, N)
    holds parked at ``_PAD_POS + park_offset + 1e6 * column``, the
    columns numbered from ``first_col``."""
    park = (_PAD_POS + park_offset
            + 1.0e6 * torch.arange(first_col, first_col + r.shape[2],
                                   dtype=torch.float32, device=r.device))
    return torch.where(bad[None], park[None, None, :], r.to(torch.float32))


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


def _thr2(threshold_km: float) -> float:
    """The coarse passes' f32 threshold on d^2: a relative 1e-6 cushion,
    so that a boundary pair never flips between the coarse d^2 compare
    and the refine's sqrt-then-compare."""
    return float(np.float32((threshold_km * (1.0 + 1.0e-6)) ** 2))


def _no_pairs():
    return (np.empty(0, np.int64), np.empty(0, np.int64),
            np.empty(0, np.float64), np.empty(0, np.int64))


def _cap(ii, jj, max_pairs: int, who: str, stacklevel: int):
    """The first ``max_pairs`` candidates (in (i, j) order), with a
    warning (at the caller ``stacklevel`` frames up) where more were
    found."""
    if len(ii) > max_pairs:
        warnings.warn(
            f"{who}: coarse candidate set ({len(ii)}) exceeds "
            f"max_pairs ({max_pairs}); candidates are truncated BEFORE "
            "the exact refine, so real conjunctions may be dropped — "
            "raise max_pairs or lower threshold_km", stacklevel=stacklevel)
        ii, jj = ii[:max_pairs], jj[:max_pairs]
    return ii, jj


def _screen_planes(r_planes, threshold_km: float, max_pairs: int,
                   coarse: Optional[Callable] = None):
    """The screen after propagation: coarse candidates of ``r_planes``
    (``coarse(r_planes, thr2)``, K4's candidate mode unless given; (i, j)
    tensors sorted by (i, j)) -> refine on the device -> pairs below the
    threshold, as :func:`screen_all` returns them. The host receives the
    candidate count and then the refined candidates, in two copies."""
    ii, jj = (coarse or cuda_screen.coarse_candidates)(
        r_planes, _thr2(threshold_km))
    ii, jj = _cap(ii, jj, max_pairs, "screen_all", 4)
    if len(ii) == 0:
        return _no_pairs()
    dmin, tmin = _refine(r_planes, ii, jj)
    with span("astroz.wait.pairs"):
        ci, cj, t = torch.stack([ii, jj, tmin]).cpu().numpy()
    with span("astroz.wait.pairs"):
        d = dmin.cpu().numpy()
    hit = d < threshold_km
    return ci[hit], cj[hit], d[hit].astype(np.float64), t[hit]


def _coarse_time_sharded(devices):
    """A coarse pass (``coarse(r_planes, thr2)``) that splits the epochs
    into one slice a device of ``devices`` and runs K4's candidate mode on
    each slice there. A pair's minimum over all epochs is at most thr2
    exactly when its minimum over some slice is, so the sorted union of
    the slices' pairs is the single-device pass's pairs: the reference's
    ``pmin`` merge of its time shards. A NaN at an epoch keeps a pair out
    of the single-device pass; a slice without that epoch can pass it,
    and the refine, whose minimum over all epochs is then NaN, drops it,
    so the screen's output is the same."""
    def coarse(r_planes, thr2):
        n = r_planes.shape[2]
        keys = [torch.empty(0, dtype=torch.int64, device=r_planes.device)]
        for dev, part in zip(devices, r_planes.tensor_split(len(devices),
                                                            dim=1)):
            if part.shape[1]:
                ii, jj = cuda_screen.coarse_candidates(
                    part.to(dev, non_blocking=True).contiguous(), thr2)
                keys.append((ii * n + jj).to(r_planes.device))
        key = torch.unique(torch.cat(keys))
        return key // n, key % n

    return coarse


def screen_all(cat: SatCatalog, jd, fr=None, *, threshold_km: float = 5.0,
               method: str = "fast", max_pairs: int = 10_000_000,
               mesh: Optional[Mesh] = None):
    """All-vs-all conjunction screen over the given epochs.

    Returns ``(i, j, min_dist_km, t_index)`` numpy arrays (int64, int64,
    float64, int64) of every pair with minimum separation below
    ``threshold_km``, ``i < j``, sorted by ``(i, j)``. Candidates beyond
    ``max_pairs`` are dropped before the refine, with a warning.

    With a ``mesh`` (:func:`~astroz_tpu_torch.parallel.make_mesh`) of more
    than one device, the coarse pass splits the epochs over its devices
    (time-sharded) and merges their pairs; propagation and refine run on
    the catalog's device. The result is that of the screen without a
    mesh.
    """
    with span("astroz.screen_all"):
        r_planes = _positions_planes_f32(cat, jd, fr, method)
        coarse = None
        if mesh is not None and mesh.devices.size > 1:
            coarse = _coarse_time_sharded(list(mesh.devices.flat))
        return _screen_planes(r_planes, threshold_km, max_pairs, coarse=coarse)


# ---------------------------------------------------------------------------
# Ring-pass all-vs-all screening over a mesh
# ---------------------------------------------------------------------------


def _ring_planes(cat: SatCatalog, jd, fr, mesh: Mesh, method: str):
    """Each device's (3, T, B) f32 position planes of its block of B
    satellites (the catalog padded to a multiple of the devices), computed
    on that device and never gathered. Failed and pad lanes park at
    distinct far points numbered by their global column."""
    n = len(cat)
    if method == "fast":
        fn, args, _ = stage_sharded_fast(cat, jd, fr, mesh=mesh,
                                         velocities=False, layout="planes")
        outs = [(r, err) for r, _, err in fn(*args)]
    elif method == "f64":
        outs, _ = _sharded_f64(cat, jd, fr, mesh, "teme", False)
        outs = [(r.permute(2, 0, 1), err) for r, _, err in outs]
    else:
        raise ValueError("method must be 'fast' or 'f64'")
    planes = []
    for k, (r, err) in enumerate(outs):
        b = r.shape[2]
        col = torch.arange(k * b, (k + 1) * b, device=r.device)
        planes.append(_parked(r, (err != 0) | (col >= n)[None], k * b)
                      .contiguous())
    return planes


def screen_all_ring(cat: SatCatalog, jd, fr=None, *,
                    threshold_km: float = 5.0, mesh: Mesh,
                    method: str = "fast", max_pairs: int = 10_000_000):
    """All-vs-all conjunction screen with the satellite axis sharded over
    a mesh's devices (all of them, as one ring).

    Each device propagates its block of B = ceil(N / D) satellites
    (:func:`~astroz_tpu_torch.parallel.stage_sharded_fast`, or the f64
    path) and keeps its (3, T, B) positions. At ring step k = 0 .. D - 1
    device ``me`` holds the block of device ``(me - k) % D`` (moved one
    device along the ring at each step) and runs K4 on its own rows
    against it: the pairs j > i of its own block at k = 0, K4's rectangle
    mode after. Pairs keep ``i < j < N``, are sorted by (i, j), and the
    first ``max_pairs`` go to the refine, which runs in chunks round-robin
    over the devices on the candidates' columns only.

    Returns ``(i, j, min_dist_km, t_index)`` numpy arrays like
    :func:`screen_all`, and the same pairs.
    """
    with span("astroz.screen_all"):
        devs = list(mesh.devices.flat)
        n_dev, n = len(devs), len(cat)
        planes = _ring_planes(cat, jd, fr, make_mesh(devs), method)
        block = planes[0].shape[2]
        thr2 = _thr2(threshold_km)
        keys = [np.empty(0, np.int64)]
        visiting = planes
        for k in range(n_dev):
            if k:
                visiting = [visiting[(me - 1) % n_dev].to(devs[me],
                                                          non_blocking=True)
                            for me in range(n_dev)]
            for me in range(n_dev):
                if k == 0:
                    ii, jj = cuda_screen.coarse_candidates(planes[me], thr2)
                else:
                    ii, jj = cuda_screen.coarse_candidates_rect(
                        planes[me], visiting[me], thr2)
                ci = ii + me * block
                cj = jj + ((me - k) % n_dev) * block
                keep = (ci < cj) & (cj < n)
                with span("astroz.wait.pairs"):
                    keys.append((ci[keep] * n + cj[keep]).cpu().numpy())
        key = np.sort(np.concatenate(keys))
        ci, cj = _cap(key // n, key % n, max_pairs, "screen_all_ring", 3)
        if len(ci) == 0:
            return _no_pairs()

        n_times = planes[0].shape[1]
        chunk_cap = max(1 << 12, (1 << 26) // max(n_times, 1))
        pending = []
        for c_idx, c0 in enumerate(range(0, len(ci), chunk_cap)):
            c1 = min(c0 + chunk_cap, len(ci))
            cols, inv = np.unique(np.concatenate([ci[c0:c1], cj[c0:c1]]),
                                  return_inverse=True)
            dev = devs[c_idx % n_dev]
            owner = cols // block
            r_sub = torch.cat([
                planes[s][:, :, torch.as_tensor(cols[owner == s] % block,
                                                device=planes[s].device)]
                .to(dev, non_blocking=True) for s in np.unique(owner)], dim=2)
            inv = torch.as_tensor(inv, device=dev)
            d, t = _refine_pairs_planes(r_sub, inv[:c1 - c0], inv[c1 - c0:])
            pending.append((d, t))
        with span("astroz.wait.pairs"):
            d = torch.cat([x.cpu() for x, _ in pending]).numpy()
        with span("astroz.wait.pairs"):
            t = torch.cat([x.cpu() for _, x in pending]).numpy()
        hit = d < threshold_km
        return ci[hit], cj[hit], d[hit].astype(np.float64), t[hit]
