"""The CUDA coarse screening kernel K4, its two modes, and their plain
versions.

K4 replaces the TPU kernel ``astroz_tpu/ops/pallas_screen.py:_kernel``
(wrappers ``_coarse_chunk`` and ``coarse_min_all``). For the (3, T, N) f32
TEME position planes of a catalog it takes, for every pair ``j > i``, the
minimum over time of the squared direct-difference distance, computed as
the card's fused multiply-adds ``fma(dz, dz, fma(dx, dx, dy*dy))`` (the
contraction XLA:CPU gives the TPU kernel's ``dx*dx + dy*dy + dz*dz``),
with a min that keeps NaN. Its modes share one kernel body
(``csrc/screen_coarse.cu``, whose source note says what bounds it on
Hopper and what the design does about that):

* matrix mode, :func:`coarse_min_chunk` / :func:`coarse_min_all`: the
  (N, width) f32 matrix of one column chunk ``[j0, j0 + width)``, +inf at
  or below the diagonal, so a chunk is thresholded with no triangle mask;
  the TPU kernel's function and chunk rule;
* candidate mode, :func:`coarse_candidates`: only the pairs whose minimum
  is at most a threshold, as (i, j) index tensors sorted by (i, j); the
  matrix is never written. This is what ``screening.screen_all`` runs.
* rectangle mode, :func:`coarse_candidates_rect`: the candidate pairs of
  one block of satellites (rows) against another (columns), every pair,
  as (row, column) index tensors sorted by (row, column): a tile of
  ``screening.screen_all_ring``.

On a CUDA tensor each wrapper launches the kernel or raises, and adds one
to :data:`LAUNCHES` per launch. On a CPU tensor it runs its plain torch
version (:func:`coarse_min_chunk_reference`,
:func:`coarse_candidates_reference`,
:func:`coarse_candidates_rect_reference`), which gives the kernel's
bits.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _build

#: kernel launches so far in this process, by mode; each launch adds one
LAUNCHES = {"screen_coarse": 0, "screen_candidates": 0,
            "screen_candidates_rect": 0}

#: default room for candidates of :func:`coarse_candidates` (8 MiB of
#: int32 pairs); a screen with more launches once more with room for all
CANDIDATE_CAP = 1 << 20

#: bytes the plain matrix version holds at its peak for each entry of the
#: (rows, columns) block it computes, beside its output: the block's
#: running minimum, the f32 differences and products of one epoch and the
#: f64 temporaries of :func:`fma_f32` (``chip_smoke.py`` phase 5 holds the
#: measured peak to it)
PLAIN_BYTES_PER_ENTRY = 96

#: the plain matrix version's working set beside its output, in bytes, by
#: device: it computes its columns in blocks that fit. On the CPU small
#: blocks keep the temporaries in the caches and in the allocator's reuse;
#: on the card large ones keep the launches few
PLAIN_WORK_BYTES = {"cpu": 1 << 26, "cuda": 1 << 30}


def _check_planes(r_planes):
    if (r_planes.dim() != 3 or r_planes.shape[0] != 3
            or r_planes.dtype != torch.float32):
        raise ValueError("r_planes: expected (3, T, N) float32, got "
                         f"{r_planes.dtype} {tuple(r_planes.shape)}")
    if not r_planes.is_contiguous():
        raise ValueError("r_planes must be contiguous")
    return r_planes.shape[1], r_planes.shape[2]


def _check_chunk(r_planes, j0: int, width: int):
    n_times, n_sats = _check_planes(r_planes)
    if not (0 <= j0 and 0 <= width and j0 + width <= n_sats):
        raise ValueError(f"columns [{j0}, {j0 + width}) outside the "
                         f"{n_sats} satellites")
    return n_times, n_sats


def _device(r_planes, what: str):
    dev = r_planes.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {dev}")
    return dev


def fma_f32(a, b, c):
    """``fma(a, b, c)`` of f32 tensors, rounded once to f32 as the card's
    FFMA rounds it, in plain torch.

    The product of two f32 values is exact in f64. The f64 sum is rounded
    to odd: a TwoSum gives its error, and an inexact sum whose last bit is
    even moves one ulp toward the exact value. Rounding to odd in 53 bits
    and then to nearest in 24 bits gives the correctly rounded result
    (Boldo and Melquiond, 2008), where a plain f64 sum cast to f32 can
    round twice the wrong way."""
    p = a.to(torch.float64, copy=True).mul_(b)
    s = p + c
    t = s - p
    # (p - (s - t)) + (c - t), in place over p and t: s + err == p + c
    err = p.sub_(s - t).add_(t.neg_().add_(c))
    del t
    # err is NaN where the sum is infinite or NaN: no move there
    move = (err.abs() > 0) & ((s.view(torch.int64) & 1) == 0)
    return torch.where(move, torch.nextafter(s, err.mul_(math.inf)),
                       s).float()


def _block_min(rows, cols):
    """min over time of ``fma(dz, dz, fma(dx, dx, dy*dy))`` of every
    satellite of the (3, T, R) planes ``rows`` against every one of the
    (3, T, C) planes ``cols``, (R, C) f32."""
    x, y, z = rows
    xc, yc, zc = cols
    d = torch.full((rows.shape[2], cols.shape[2]), math.inf,
                   dtype=torch.float32, device=rows.device)
    for t in range(rows.shape[1]):
        dx = x[t, :, None] - xc[t, None, :]
        dy = y[t, :, None] - yc[t, None, :]
        dz = z[t, :, None] - zc[t, None, :]
        torch.minimum(d, fma_f32(dz, dz, fma_f32(dx, dx, dy.mul_(dy))),
                      out=d)
    return d


def coarse_min_chunk_reference(r_planes, j0: int, width: int, *,
                               work_bytes: Optional[int] = None):
    """Plain torch version of K4's matrix mode, on any device: the same
    arguments and returns as :func:`coarse_min_chunk`, bit for bit.

    The columns go in blocks whose temporaries
    (:data:`PLAIN_BYTES_PER_ENTRY` an entry) stay under ``work_bytes``
    (by default the device's :data:`PLAIN_WORK_BYTES`; at least one
    column). A block takes one pass per epoch over the rows that hold a
    pair ``j > i`` (those below its last column); the other rows are
    +inf."""
    _, n_sats = _check_chunk(r_planes, j0, width)
    dev = r_planes.device
    if work_bytes is None:
        work_bytes = PLAIN_WORK_BYTES.get(dev.type, PLAIN_WORK_BYTES["cuda"])
    dmin = torch.full((n_sats, width), math.inf, dtype=torch.float32,
                      device=dev)
    step = max(1, work_bytes // (PLAIN_BYTES_PER_ENTRY
                                 * max(1, min(n_sats, j0 + width - 1))))
    for c0 in range(0, width, step):
        c1 = min(width, c0 + step)
        n_rows = max(0, min(n_sats, j0 + c1 - 1))
        dmin[:n_rows, c0:c1] = _block_min(r_planes[:, :, :n_rows],
                                          r_planes[:, :, j0 + c0:j0 + c1])
    rows = torch.arange(n_sats, device=dev)[:, None]
    cols_j = torch.arange(j0, j0 + width, device=dev)[None, :]
    return dmin.masked_fill_(cols_j <= rows, math.inf)


def coarse_min_chunk(r_planes, j0: int, width: int):
    """K4, matrix mode: min-over-time squared distances of every satellite
    against the columns ``j0 .. j0 + width - 1``.

    Args:
      r_planes: (3, T, N) f32 TEME position planes, km, contiguous (failed
        lanes already parked by the caller).
      j0, width: the column chunk, ``0 <= j0`` and ``j0 + width <= N``.

    Returns (N, width) f32: entry ``[i, c]`` is
    ``min_t fma(dz, dz, fma(dx, dx, dy*dy))`` for the pair ``(i, j0 + c)``
    where ``j0 + c > i`` (NaN if a position of the pair is NaN) and +inf
    where ``j0 + c <= i``.
    """
    n_times, n_sats = _check_chunk(r_planes, j0, width)
    dev = _device(r_planes, "coarse_min_chunk")
    if dev.type == "cpu":
        return coarse_min_chunk_reference(r_planes, j0, width)
    out = torch.empty((n_sats, width), dtype=torch.float32, device=dev)
    if n_sats == 0 or width == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.astroz_screen_coarse(
            r_planes.data_ptr(), n_times, n_sats, j0, width, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"screen_coarse kernel launch failed: cudaError "
                           f"{rc}")
    LAUNCHES["screen_coarse"] += 1
    return out


def _chunk_width(n_sats: int, max_bytes: int) -> int:
    """Columns of one (N, width) f32 chunk under ``max_bytes`` (at least
    one)."""
    return max(1, min(n_sats, max_bytes // (4 * max(n_sats, 1))))


def coarse_min_all(r_planes, *, max_bytes: int = 2 << 30):
    """Yield ``(j0, dmin)`` column chunks of the all-vs-all coarse pass.

    r_planes: (3, T, N) f32 position planes (failed lanes already parked
    by the caller). Each ``dmin`` is :func:`coarse_min_chunk` over the
    chunk's columns, (N, width) f32, with the width chosen so that one
    output buffer stays under ``max_bytes`` (at least one column).
    """
    n_sats = r_planes.shape[2]
    width = _chunk_width(n_sats, max_bytes)
    for j0 in range(0, n_sats, width):
        yield j0, coarse_min_chunk(r_planes, j0, min(width, n_sats - j0))


def _sorted_pairs(ii, jj, n_sats: int):
    """(i, j) int64 tensors sorted by the key ``i * N + j``."""
    key = torch.sort(ii.long() * n_sats + jj.long()).values
    return key // n_sats, key % n_sats


def coarse_candidates_reference(r_planes, thr2: float, *,
                                max_bytes: int = 1 << 28):
    """Plain torch version of K4's candidate mode, on any device: the
    pairs of :func:`coarse_min_chunk_reference` whose entry is at most
    ``thr2`` (NaN never is), over column chunks whose f32 output stays
    under ``max_bytes``, as (i, j) int64 tensors sorted by (i, j). Its
    peak beside the planes is one chunk, its mask and the matrix
    version's working set (:data:`PLAIN_WORK_BYTES`)."""
    _, n_sats = _check_planes(r_planes)
    width = _chunk_width(n_sats, max_bytes)
    found_i, found_j = [], []
    for j0 in range(0, n_sats, width):
        dmin = coarse_min_chunk_reference(r_planes, j0,
                                          min(width, n_sats - j0))
        ii, jj = torch.nonzero(dmin <= thr2, as_tuple=True)
        found_i.append(ii)
        found_j.append(jj + j0)
        del dmin
    empty = torch.empty(0, dtype=torch.int64, device=r_planes.device)
    return _sorted_pairs(torch.cat(found_i + [empty]),
                         torch.cat(found_j + [empty]), n_sats)


def _launch_candidates(r_planes, thr2: float, cap: int, count):
    """One candidate-mode launch into a new (cap, 2) int32 buffer; the
    kernel adds every hit to ``count``, even past ``cap``."""
    n_times, n_sats = r_planes.shape[1], r_planes.shape[2]
    dev = r_planes.device
    pairs = torch.empty((max(cap, 1), 2), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.astroz_screen_candidates(
            r_planes.data_ptr(), n_times, n_sats, ctypes.c_float(thr2), cap,
            pairs.data_ptr(), count.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"screen_candidates kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES["screen_candidates"] += 1
    return pairs


def coarse_candidates(r_planes, thr2: float, *, cap: int = CANDIDATE_CAP):
    """K4, candidate mode: every pair ``j > i`` whose min-over-time squared
    distance (as :func:`coarse_min_chunk` computes it) is at most
    ``thr2``; a NaN minimum never passes.

    Args:
      r_planes: (3, T, N) f32 TEME position planes, km, contiguous (failed
        lanes already parked by the caller).
      thr2: the threshold on the squared distance, km^2 (an f32 value).
      cap: room for candidates in the first launch. One count fetch
        follows it; if the count is larger, the kernel runs once more with
        room for all of them.

    Returns (i, j) int64 tensors on the planes' device, sorted by (i, j).
    """
    n_times, n_sats = _check_planes(r_planes)
    dev = _device(r_planes, "coarse_candidates")
    if dev.type == "cpu":
        return coarse_candidates_reference(r_planes, thr2)
    empty = torch.empty(0, dtype=torch.int64, device=dev)
    if n_sats == 0:
        return empty, empty
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    pairs = _launch_candidates(r_planes, thr2, cap, count)
    hits = int(count.item())
    if hits > cap:
        count.zero_()
        pairs = _launch_candidates(r_planes, thr2, hits, count)
    pairs = pairs[:hits]
    return _sorted_pairs(pairs[:, 0], pairs[:, 1], n_sats)


def _check_rect(rows, cols):
    n_times, _ = _check_planes(rows)
    if _check_planes(cols)[0] != n_times or cols.device != rows.device:
        raise ValueError(f"rows and cols must hold the same epochs on one "
                         f"device, got {tuple(rows.shape)} on {rows.device} "
                         f"and {tuple(cols.shape)} on {cols.device}")
    return n_times, rows.shape[2], cols.shape[2]


def coarse_candidates_rect_reference(rows, cols, thr2: float, *,
                                     work_bytes: Optional[int] = None):
    """Plain torch version of K4's rectangle mode, on any device: the same
    arguments and returns as :func:`coarse_candidates_rect`, pair for
    pair. The columns go in blocks whose temporaries
    (:data:`PLAIN_BYTES_PER_ENTRY` an entry) stay under ``work_bytes`` (by
    default the device's :data:`PLAIN_WORK_BYTES`)."""
    _, n_rows, n_cols = _check_rect(rows, cols)
    if work_bytes is None:
        work_bytes = PLAIN_WORK_BYTES.get(rows.device.type,
                                          PLAIN_WORK_BYTES["cuda"])
    step = max(1, work_bytes // (PLAIN_BYTES_PER_ENTRY * max(1, n_rows)))
    found_i, found_j = [], []
    for c0 in range(0, n_cols, step):
        dmin = _block_min(rows, cols[:, :, c0:c0 + step])
        ii, jj = torch.nonzero(dmin <= thr2, as_tuple=True)
        found_i.append(ii)
        found_j.append(jj + c0)
    empty = torch.empty(0, dtype=torch.int64, device=rows.device)
    return _sorted_pairs(torch.cat(found_i + [empty]),
                         torch.cat(found_j + [empty]), n_cols)


def _launch_rect(rows, cols, thr2: float, cap: int, count):
    """One rectangle-mode launch into a new (cap, 2) int32 buffer; the
    kernel adds every hit to ``count``, even past ``cap``."""
    dev = rows.device
    pairs = torch.empty((max(cap, 1), 2), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.astroz_screen_candidates_rect(
            rows.data_ptr(), rows.shape[1], rows.shape[2], cols.data_ptr(),
            cols.shape[2], ctypes.c_float(thr2), cap, pairs.data_ptr(),
            count.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"screen_candidates_rect kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES["screen_candidates_rect"] += 1
    return pairs


def coarse_candidates_rect(rows, cols, thr2: float, *,
                           cap: int = CANDIDATE_CAP):
    """K4, rectangle mode: every pair of a satellite of ``rows`` and a
    satellite of ``cols`` whose min-over-time squared distance (the
    chain of :func:`coarse_min_chunk`, row minus column) is at most
    ``thr2``; a NaN minimum never passes. No pair is left out for its
    order: the two blocks are different satellites.

    Args:
      rows, cols: (3, T, R) and (3, T, C) f32 TEME position planes, km,
        contiguous, of the same epochs on one device (failed lanes already
        parked by the caller).
      thr2: the threshold on the squared distance, km^2 (an f32 value).
      cap: room for candidates in the first launch; one count fetch
        follows it, and a second launch with room for all where the count
        is larger.

    Returns (i, j) int64 tensors on the planes' device, i a row index and
    j a column index, sorted by (i, j).
    """
    _, n_rows, n_cols = _check_rect(rows, cols)
    dev = _device(rows, "coarse_candidates_rect")
    if dev.type == "cpu":
        return coarse_candidates_rect_reference(rows, cols, thr2)
    empty = torch.empty(0, dtype=torch.int64, device=dev)
    if n_rows == 0 or n_cols == 0:
        return empty, empty
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    pairs = _launch_rect(rows, cols, thr2, cap, count)
    hits = int(count.item())
    if hits > cap:
        count.zero_()
        pairs = _launch_rect(rows, cols, thr2, hits, count)
    pairs = pairs[:hits]
    return _sorted_pairs(pairs[:, 0], pairs[:, 1], n_cols)
