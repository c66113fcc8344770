"""Device meshes and sharded catalog propagation.

Counterpart of ``astroz_tpu/parallel/mesh.py``. The JAX package shards
the satellite axis (and optionally the time axis) of the dense (n_times,
n_sats) grid over a ``jax.sharding.Mesh`` and runs one ``shard_map``
program a device. Here one process holds a :class:`Mesh`, a ``(time,
sat)`` grid of ``torch.device``s: every shard's catalog rows and time
slice live on its device, its propagate runs there (the kernels launch
on that device's stream, so the shards' work goes out without waiting on
each other), and the outputs are gathered onto the mesh's first device.
Every point is propagated on its own, so no shard needs another's data.

Padding follows the reference: the catalog is padded to a multiple of
the sat axis by repeating the last satellite (Constellation.zig:146) and
the epochs to a multiple of the time axis by repeating the last epoch;
the outputs are trimmed back.

A shard is a :class:`~astroz_tpu_torch.propagation.SatCatalog` of
contiguous rows of the padded catalog. It keeps the whole catalog's
constants, so that each of its points gets the bits of the single-device
sweep: the earliest epoch that the time factors are taken from
(``epoch_min_jd``), the Newton trips of the kernels (``kepler_iters``,
``deep_kepler_iters``) and the resonance tables' depth, which the whole
catalog's deep epochs set. The fast sweep applies the HEO escape on
every shard, which the JAX package's sharded fast path skips.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.cuda_finalize import finalize
from ..ops.sdp4 import DeepElements
from ..ops.sgp4 import Sgp4Elements
from ..propagation import (LAYOUTS, OUTPUT_MODES, SatCatalog, _fast_planes,
                           _propagate_f64, _stage_epochs, _t_time,
                           resonance_steps)


class Mesh:
    """A ``(time, sat)`` grid of torch devices.

    ``devices`` is a numpy object array of shape ``(time, sat)``;
    ``shape`` is ``{"time": t, "sat": s}``, as ``jax.sharding.Mesh``
    gives them. A device may appear more than once."""

    axis_names = ("time", "sat")

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"mesh devices must be a (time, sat) grid, got "
                             f"shape {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return (f"Mesh(time={self.devices.shape[0]}, "
                f"sat={self.devices.shape[1]}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def make_mesh(devices: Optional[Sequence] = None,
              sat_parallel: Optional[int] = None,
              time_parallel: int = 1) -> Mesh:
    """Build a ``(time, sat)`` mesh over the given devices, or over every
    visible CUDA device.

    By default all devices go to the ``"sat"`` axis: propagation is
    independent over satellites. Set ``time_parallel > 1`` to split long
    time grids too. ``devices`` may repeat a device (for example
    ``[torch.device("cpu")] * 8``, or ``[torch.device("cuda", 0)] * 4``
    on one card): each entry is then one shard on that device, the
    counterpart of the JAX package's virtual host devices. With
    ``devices=None`` and no CUDA device this raises; a CPU mesh is only
    made from CPU devices the caller passes.
    """
    if devices is None:
        n_cuda = torch.cuda.device_count()
        if n_cuda == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices= (for "
                "example [torch.device('cpu')] * 8) for a mesh on other "
                "devices")
        devices = [torch.device("cuda", i) for i in range(n_cuda)]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if sat_parallel is None:
        if n % time_parallel != 0:
            raise ValueError(
                f"time_parallel ({time_parallel}) must divide the device "
                f"count ({n}); got {n} devices — pass sat_parallel "
                f"explicitly or pick time_parallel from the divisors of "
                f"{n}")
        sat_parallel = n // time_parallel
    if sat_parallel < 1 or time_parallel < 1:
        raise ValueError(
            f"mesh axes must be >= 1 (got sat_parallel={sat_parallel}, "
            f"time_parallel={time_parallel} over {n} devices)")
    if sat_parallel * time_parallel != n:
        raise ValueError(
            f"sat_parallel ({sat_parallel}) x time_parallel "
            f"({time_parallel}) must equal device count ({n}); pick "
            f"factors of {n} or let sat_parallel default")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(time_parallel, sat_parallel))


def _pad_count(n: int, multiple: int) -> int:
    return (-n) % multiple


def _catalog_rows(cat: SatCatalog, rows: np.ndarray, device) -> SatCatalog:
    """The catalog of ``cat``'s rows ``rows`` (indices, which may repeat)
    on ``device``, with ``cat``'s per-catalog constants (module
    docstring)."""
    def take(x):
        x = np.asarray(x)
        return x if x.ndim == 0 else x[rows]

    deep = (None if cat.deep_host is None
            else DeepElements(*(take(x) for x in cat.deep_host)))
    sub = SatCatalog(Sgp4Elements(*(take(x) for x in cat.host)), cat.grav,
                     np.asarray(cat.satnum)[rows], deep=deep, device=device)
    # cached properties of the whole catalog, set before the sub-catalog
    # computes its own from its rows
    sub.epoch_min_jd = cat.epoch_min_jd
    sub.kepler_iters = cat.kepler_iters
    sub.deep_kepler_iters = cat.deep_kepler_iters
    return sub


def _padded_rows(n: int, multiple: int) -> np.ndarray:
    return np.minimum(np.arange(n + _pad_count(n, multiple)), n - 1)


def pad_catalog(cat: SatCatalog, multiple: int) -> Tuple[SatCatalog, int]:
    """Pad the catalog to a multiple of ``multiple`` satellites by
    repeating the last satellite (reference: Constellation.zig:146).

    Returns ``(padded_catalog, n_real)``; the padded catalog lies on the
    catalog's device and has no names."""
    n = len(cat)
    if _pad_count(n, multiple) == 0:
        return cat, n
    return _catalog_rows(cat, _padded_rows(n, multiple), cat.device), n


class ShardedCatalog(NamedTuple):
    """A catalog split over a mesh's sat axis."""

    shards: np.ndarray  # (time, sat) object array: the sat shard's
    #                     catalog on that mesh device
    block: int  # satellites a shard (the padded catalog's rows / sat size)


def shard_catalog(cat: SatCatalog, mesh: Mesh
                  ) -> Tuple[ShardedCatalog, int]:
    """Pad to the sat axis' size and give every mesh device the catalog
    of its sat shard's contiguous rows (one catalog a shard and device,
    shared where a device repeats). Returns ``(sharded, n_real)``."""
    n_sat = mesh.shape["sat"]
    rows = _padded_rows(len(cat), n_sat)
    block = len(rows) // n_sat
    made = {}
    shards = np.empty(mesh.devices.shape, dtype=object)
    for (ti, si), dev in np.ndenumerate(mesh.devices):
        key = (si, str(dev))
        if key not in made:
            made[key] = _catalog_rows(
                cat, rows[si * block:(si + 1) * block], dev)
        shards[ti, si] = made[key]
    return ShardedCatalog(shards, block), len(cat)


def _times(jd, fr, multiple: int):
    """Host f64 ``(jd, fr)`` as :func:`~astroz_tpu_torch.propagation.propagate`
    reads them, padded to a multiple of ``multiple`` by repeating the last
    epoch, and the number of real epochs."""
    jd_h = np.atleast_1d(np.asarray(jd, np.float64))
    fr_h = (np.zeros_like(jd_h) if fr is None
            else np.atleast_1d(np.asarray(fr, np.float64)))
    jd_h, fr_h = np.broadcast_arrays(jd_h, fr_h)
    idx = _padded_rows(len(jd_h), multiple)
    return jd_h[idx], fr_h[idx], len(jd_h)


def _check(output: str, layout: str):
    if output not in OUTPUT_MODES:
        raise ValueError(f"output must be one of {OUTPUT_MODES}")
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}")


#: (time axis, sat axis) of r and v, then of the error codes, by layout
_AXES = {"time_major": ((0, 1), (0, 1)), "sat_major": ((1, 0), (1, 0)),
         "planes": ((1, 2), (0, 1))}


def _gather(outs: List[tuple], mesh: Mesh, layout: str, n_times: int,
            n_real: int):
    """Join the per-shard ``(r, v, err)`` (row-major over the mesh) onto
    the mesh's first device and trim the padding."""
    dev = mesh.devices.flat[0]
    n_t, n_s = mesh.devices.shape

    def join(k, t_ax, s_ax):
        if outs[0][k] is None:
            return None
        rows = [torch.cat([outs[ti * n_s + si][k].to(dev, non_blocking=True)
                           for si in range(n_s)], dim=s_ax)
                for ti in range(n_t)]
        x = torch.cat(rows, dim=t_ax)
        return x.narrow(t_ax, 0, n_times).narrow(s_ax, 0, n_real).contiguous()

    (rt, rs), (et, es) = _AXES[layout]
    return join(0, rt, rs), join(1, rt, rs), join(2, et, es)


def _sharded_f64(cat: SatCatalog, jd, fr, mesh: Mesh, output: str,
                 velocities: bool):
    """The f64 propagate of every (time, sat) shard on its device,
    time-major ``(r, v, err)`` per shard (row-major over the mesh), not
    gathered; and ``(n_times, n_real)``."""
    jd_p, fr_p, n_times = _times(jd, fr, mesh.shape["time"])
    scat, n_real = shard_catalog(cat, mesh)
    t_block = len(jd_p) // mesh.shape["time"]
    outs = []
    for (ti, _), sub in np.ndenumerate(scat.shards):
        sl = slice(ti * t_block, (ti + 1) * t_block)
        outs.append(_propagate_f64(sub, jd_p[sl], fr_p[sl], output,
                                   velocities, "time_major", False))
    return outs, (n_times, n_real)


def propagate_sharded(cat: SatCatalog, jd, fr=None, *, mesh: Mesh,
                      output: str = "teme", velocities: bool = True):
    """The f64 propagate with the satellite axis sharded over the mesh.

    The time axis is sharded too when the mesh has ``time > 1`` (the
    epochs are padded by repeating the last one). Each (time, sat) shard
    runs :func:`~astroz_tpu_torch.propagation.propagate`'s f64 path on its
    device. Returns ``(r, v, error)`` shaped ``(n_times, n_sats, 3)`` (v
    None without velocities), gathered onto the mesh's first device.
    """
    _check(output, "time_major")
    outs, (n_times, n_real) = _sharded_f64(cat, jd, fr, mesh, output,
                                           velocities)
    return _gather(outs, mesh, "time_major", n_times, n_real)


class _FastShard(NamedTuple):
    """What one (time, sat) shard's sweep reads, on its device."""

    cat: SatCatalog
    t_time: torch.Tensor  # (T_shard,) f64 minutes from epoch_min_jd
    jd_sum: torch.Tensor  # (T_shard, 1) f64 Julian dates


def stage_sharded_fast(cat: SatCatalog, jd, fr=None, *, mesh: Mesh,
                       output: str = "teme", velocities: bool = True,
                       engine: Optional[str] = None,
                       layout: str = "time_major"
                       ) -> Tuple[Callable, tuple, Tuple[int, int]]:
    """Stage the sharded fast propagate and return ``(fn, args, (n_times,
    n_real))``: ``fn(*args)`` runs one sweep, each (time, sat) shard
    through the fast path's kernels on its device (K1 on a shard without
    deep lanes; K2, the HEO escape and K3 on one with them), and returns
    the per-shard ``(r, v, err)`` in ``layout`` (row-major over the mesh),
    not gathered. Everything a sweep reads is made here once: the shards'
    catalogs and kernel staging, their resonance tables, the time factors
    on each device.

    ``engine`` is taken for the reference's signature: None or
    ``"cuda"`` (the port's kernels; on CPU devices their plain versions).
    """
    if engine not in (None, "cuda"):
        raise ValueError(f"engine must be None or 'cuda' (the port has only "
                         f"its own kernels), got {engine!r}")
    _check(output, layout)
    want_vel = bool(velocities)
    jd_p, fr_p, n_times = _times(jd, fr, mesh.shape["time"])
    scat, n_real = shard_catalog(cat, mesh)
    steps = (resonance_steps(jd_p + fr_p, cat.deep_epochs_jd)
             if cat.has_deep else 0)
    if steps:
        # each lane's resonance integration is its own: a shard takes its
        # deep lanes' columns of the whole catalog's tables (integrated
        # once, as a single-device sweep integrates them)
        tables = cat.resonance_tables(steps)
        slot = np.full(len(cat), -1)
        slot[cat.deep_idx] = np.arange(cat.n_deep)
        rows = _padded_rows(len(cat), mesh.shape["sat"])
    t_block = len(jd_p) // mesh.shape["time"]
    shards = []
    for (ti, si), sub in np.ndenumerate(scat.shards):
        sl = slice(ti * t_block, (ti + 1) * t_block)
        if sub.has_deep and steps not in sub._tables:
            cols = slot[rows[si * scat.block + sub.deep_idx]]
            sub._tables[steps] = tables[:, :, torch.as_tensor(
                cols, device=tables.device)].to(sub.device)
        sub.fast_staging  # staged here, once
        (t_time, jd_sum), _ = _stage_epochs(
            sub.device, [_t_time(cat.epoch_min_jd, jd_p[sl], fr_p[sl]),
                         jd_p[sl] + fr_p[sl]])
        shards.append(_FastShard(sub, t_time, jd_sum[:, None]))

    def sweep(*shards: _FastShard):
        return [finalize(*_fast_planes(s.cat, s.t_time, steps, want_vel),
                         s.jd_sum, source="planes", output=output,
                         layout=layout, velocities=want_vel)
                for s in shards]

    return sweep, tuple(shards), (n_times, n_real)


def propagate_sharded_fast(cat: SatCatalog, jd, fr=None, *, mesh: Mesh,
                           output: str = "teme", velocities: bool = True,
                           engine: Optional[str] = None,
                           layout: str = "time_major"):
    """The fast propagate sharded over the mesh: :func:`stage_sharded_fast`,
    one sweep, and the shards gathered onto the mesh's first device and
    trimmed. Returns ``(r, v, error)`` as
    :func:`~astroz_tpu_torch.propagation.propagate` does for ``layout``
    (f32; v None without velocities). Every shard applies the HEO
    escape, so each point equals the single-device
    ``propagate(method="fast")``'s."""
    fn, args, (n_times, n_real) = stage_sharded_fast(
        cat, jd, fr, mesh=mesh, output=output, velocities=velocities,
        engine=engine, layout=layout)
    return _gather(fn(*args), mesh, layout, n_times, n_real)
