"""The CUDA coarse screening kernel K4 and its plain version.

K4, :func:`coarse_min_chunk`, replaces the TPU kernel
``astroz_tpu/ops/pallas_screen.py:_kernel`` (wrappers ``_coarse_chunk``
and ``coarse_min_all``): for the (3, T, N) f32 TEME position planes of a
catalog and one column chunk ``[j0, j0 + width)``, the (N, width) f32
matrix whose entry ``[i, j - j0]`` is, for every pair with ``j > i``, the
minimum over time of the squared direct-difference distance
``(dx*dx + dy*dy) + dz*dz``, and +inf at or below the diagonal, so the
chunk is thresholded with no triangle mask. The kernel is
``csrc/screen_coarse.cu``;
its source note says what bounds it on Hopper and what the design does
about that.

On a CUDA tensor the wrapper launches the kernel or raises, and adds one
to :data:`LAUNCHES`. On a CPU tensor it runs
:func:`coarse_min_chunk_reference`, the same function in plain torch.
"""

from __future__ import annotations

import torch

from .. import _build

#: kernel launches so far in this process; each launch adds one
LAUNCHES = {"screen_coarse": 0}


def _check_chunk(r_planes, j0: int, width: int):
    if (r_planes.dim() != 3 or r_planes.shape[0] != 3
            or r_planes.dtype != torch.float32):
        raise ValueError("r_planes: expected (3, T, N) float32, got "
                         f"{r_planes.dtype} {tuple(r_planes.shape)}")
    if not r_planes.is_contiguous():
        raise ValueError("r_planes must be contiguous")
    n_times, n_sats = r_planes.shape[1], r_planes.shape[2]
    if not (0 <= j0 and 0 <= width and j0 + width <= n_sats):
        raise ValueError(f"columns [{j0}, {j0 + width}) outside the "
                         f"{n_sats} satellites")
    return n_times, n_sats


def coarse_min_chunk_reference(r_planes, j0: int, width: int):
    """Plain torch version of K4, on any device: the same arguments and
    returns as :func:`coarse_min_chunk`. One (N, width) pass per epoch."""
    n_times, n_sats = _check_chunk(r_planes, j0, width)
    x, y, z = r_planes
    cols = slice(j0, j0 + width)
    dmin = torch.full((n_sats, width), float("inf"), dtype=torch.float32,
                      device=r_planes.device)
    for t in range(n_times):
        dx = x[t, :, None] - x[t, None, cols]
        dy = y[t, :, None] - y[t, None, cols]
        dz = z[t, :, None] - z[t, None, cols]
        dmin = torch.minimum(dmin, dx * dx + dy * dy + dz * dz)
    rows = torch.arange(n_sats, device=r_planes.device)[:, None]
    cols_j = torch.arange(j0, j0 + width, device=r_planes.device)[None, :]
    return dmin.masked_fill_(cols_j <= rows, float("inf"))


def coarse_min_chunk(r_planes, j0: int, width: int):
    """K4: min-over-time squared distances of every satellite against the
    columns ``j0 .. j0 + width - 1``.

    Args:
      r_planes: (3, T, N) f32 TEME position planes, km, contiguous (failed
        lanes already parked by the caller).
      j0, width: the column chunk, ``0 <= j0`` and ``j0 + width <= N``.

    Returns (N, width) f32: entry ``[i, c]`` is
    ``min_t (dx*dx + dy*dy) + dz*dz`` for the pair ``(i, j0 + c)`` where
    ``j0 + c > i`` (NaN if a position of the pair is NaN) and +inf where
    ``j0 + c <= i``.
    """
    n_times, n_sats = _check_chunk(r_planes, j0, width)
    dev = r_planes.device
    if dev.type == "cpu":
        return coarse_min_chunk_reference(r_planes, j0, width)
    if dev.type != "cuda":
        raise ValueError(f"coarse_min_chunk: no kernel for device {dev}")
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


def coarse_min_all(r_planes, *, max_bytes: int = 2 << 30):
    """Yield ``(j0, dmin)`` column chunks of the all-vs-all coarse pass.

    r_planes: (3, T, N) f32 position planes (failed lanes already parked
    by the caller). Each ``dmin`` is :func:`coarse_min_chunk` over the
    chunk's columns, (N, width) f32, with the width chosen so that one
    output buffer stays under ``max_bytes`` (at least one column).
    """
    n_sats = r_planes.shape[2]
    width = max(1, min(n_sats, max_bytes // (4 * max(n_sats, 1))))
    for j0 in range(0, n_sats, width):
        yield j0, coarse_min_chunk(r_planes, j0, min(width, n_sats - j0))
