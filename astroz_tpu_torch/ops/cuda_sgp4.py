"""The CUDA propagation kernels K1, K2, K3, K5 and K6, the f64 spine
kernel that feeds K6, and their plain versions.

* K1, :func:`propagate_fast_sep`, replaces the TPU kernel
  ``astroz_tpu/ops/pallas_sgp4.py:_kernel_fused_sep`` (wrapper
  ``propagate_fast_pallas_sep``): near-earth satellites.
* K2, :func:`propagate_deep_sep`, replaces ``_kernel_deep`` (wrapper
  ``propagate_deep_pallas``): the deep-space subset of a catalog.
* K3, :func:`propagate_fast_sep_merge`, replaces
  ``_kernel_fused_sep_merge`` (wrapper ``propagate_fast_pallas_sep_merge``):
  K1 over a mixed catalog, its deep columns taken from K2's planes.
* K5, :func:`propagate_fast_dense` and over elements
  :func:`propagate_fast_fused`, replaces ``_kernel_fused`` (wrapper
  ``propagate_fast_pallas_fused``): K1 on a dense tsince grid.
* K6, :func:`propagate_fast_spine_grids` and over elements
  :func:`propagate_fast_grids`, replaces ``_kernel`` (wrapper
  ``propagate_fast_pallas``): K1's tail on the six f32 grids of the f64
  spine (``ops/fast.py:spine_f64``), which the spine kernel
  (:func:`spine_f64_grids`, over elements :func:`spine_grids`) writes.

K1-K3 propagate over the separable grid ``tsince[t, n] = t_time[t] -
t_sat[n]`` minutes, K5 and K6 over a dense one. The planes-level
functions return the grouped planes ``r (3, T, N)`` f32, ``v (3, T, N)``
f32 (``None`` with ``want_vel=False``) and ``err (T, N)`` i32; the
element-level ones ``r``, ``v`` (T, N, 3) and ``err`` (T, N), as the JAX
wrappers do (K5 and K6 write that layout themselves). The element-level
ones stage their elements once per element set (:func:`_staged`). The
kernels are ``csrc/sgp4_shallow.cu`` (K1, K3, K5, K6, the spine kernel)
and ``csrc/sgp4_deep.cu`` (K2); their source notes say what bounds them
on Hopper and what the design does about that; :func:`launch_grid` gives
the grid K5, K6 and K2 launch.

On a CUDA tensor a wrapper launches its kernel or raises, and adds one
to its entry of :data:`LAUNCHES`. On a CPU tensor it runs its
``*_reference`` function, the same function in plain torch
(``ops/fast.py``).
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..constants import GravityModel
from .fast import (DEEP_FIELD_NAMES, DEEP_SPINE_FIELD_NAMES,
                   RESONANCE_TABLE_NAMES, SPINE_FIELD_NAMES,
                   TAIL_FIELD_NAMES, deep_spine_f64, deep_tail_f32,
                   shallow_staging, shallow_tail_f32, spine_f64)

#: Newton trip counts K1 and K3 are built for (SatCatalog.kepler_iters)
KEPLER_ITERS = (3, 4, 5, 8)
#: Newton trip counts K2 is built for (SatCatalog.deep_kepler_iters)
DEEP_KEPLER_ITERS = (6, 8)

#: kernel launches so far in this process, by kernel; each launch adds
#: one to its kernel's entry
LAUNCHES = {"sgp4_shallow": 0, "sgp4_deep": 0, "sgp4_shallow_merge": 0,
            "sgp4_shallow_dense": 0, "sgp4_shallow_grids": 0,
            "sgp4_spine_grids": 0}

F32 = torch.float32
F64 = torch.float64
I32 = torch.int32


def _check(device, expected):
    """Raise unless every ``(tensor, shape, dtype, name)`` has its shape
    and dtype, lies on ``device`` and is contiguous."""
    for x, shape, dtype, name in expected:
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, t_time on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_sep(t_time, t_sat, spine, tail, flags):
    n_times, n_sats = t_time.shape[0], t_sat.shape[0]
    _check(t_time.device, (
        (t_time, (n_times,), F64, "t_time"),
        (t_sat, (n_sats,), F64, "t_sat"),
        (spine, (len(SPINE_FIELD_NAMES), n_sats), F64, "spine"),
        (tail, (len(TAIL_FIELD_NAMES), n_sats), F32, "tail"),
        (flags, (2, n_sats), I32, "flags")))
    return n_times, n_sats


def _device_of(t_time, name):
    dev = t_time.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev


def _launch_device(x, kepler_iters, name):
    """The device of ``x``; on CUDA, ``kepler_iters`` must be one the
    near-earth kernels are built for."""
    dev = _device_of(x, name)
    if dev.type == "cuda" and kepler_iters not in KEPLER_ITERS:
        raise ValueError(f"kepler_iters must be one of {KEPLER_ITERS}, "
                         f"got {kepler_iters}")
    return dev


def _outputs(dev, n_times, n, want_vel, time_major=False):
    shape = (n_times, n, 3) if time_major else (3, n_times, n)
    r = torch.empty(shape, dtype=F32, device=dev)
    v = torch.empty_like(r) if want_vel else None
    err = torch.empty((n_times, n), dtype=I32, device=dev)
    return r, v, err


def _ptr(x):
    return None if x is None else x.data_ptr()


def _raise_on(rc, kernel):
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")
    LAUNCHES[kernel] += 1


def _f32(x: float) -> float:
    return float(np.float32(x))


def _grav_args(grav: GravityModel):
    """(j2, radius, km/s per earth radius per minute) as the f32 values
    the kernels take."""
    return (_f32(grav.j2), _f32(grav.radius_earth_km),
            _f32(grav.radius_earth_km * grav.xke / 60.0))


# ---------------------------------------------------------------------------
# K1: near-earth satellites
# ---------------------------------------------------------------------------


def _planes(out, want_vel):
    """(r3, v3 | None, err) from a tail's component tuple."""
    r3 = torch.stack(out[0:3])
    v3 = torch.stack(out[3:6]) if want_vel else None
    return r3, v3, out[-1]


def _tail_reference(grids, tail, flags, grav, kepler_iters, want_vel):
    """The shallow tail in plain torch on the spine's six grids."""
    fields = dict(zip(TAIL_FIELD_NAMES, tail))
    fields["not_simp"] = flags[0] == 0
    fields["error0"] = flags[1]
    return _planes(shallow_tail_f32(grav, kepler_iters, *grids,
                                    want_vel=want_vel, **fields), want_vel)


def _spine_grids(tsince, spine):
    return spine_f64(tsince, **dict(zip(SPINE_FIELD_NAMES, spine)))


def propagate_fast_sep_reference(t_time, t_sat, spine, tail, flags, *,
                                 grav: GravityModel, kepler_iters: int,
                                 want_vel: bool = True):
    """Plain torch version of K1, on any device: the same arguments and
    returns as :func:`propagate_fast_sep`."""
    _check_sep(t_time, t_sat, spine, tail, flags)
    return _tail_reference(
        _spine_grids(t_time[:, None] - t_sat[None, :], spine), tail, flags,
        grav, kepler_iters, want_vel)


def propagate_fast_sep(t_time, t_sat, spine, tail, flags, *,
                       grav: GravityModel, kepler_iters: int,
                       want_vel: bool = True):
    """K1: propagate near-earth satellites over ``t_time[t] - t_sat[s]``.

    Args:
      t_time: (T,) f64 minutes, on the same base as ``t_sat``.
      t_sat: (S,) f64 satellite epochs in minutes.
      spine: (12, S) f64 rows ``ops.fast.SPINE_FIELD_NAMES``.
      tail: (21, S) f32 rows ``ops.fast.TAIL_FIELD_NAMES``.
      flags: (2, S) i32 rows ``[isimp, init error]``.
      grav: the gravity model the elements were initialized with.
      kepler_iters: Newton trips, one of :data:`KEPLER_ITERS` on CUDA.
      want_vel: compute and return velocities.

    Returns ``(r, v, err)``: r and v (3, T, S) f32 TEME km and km/s, v
    None without velocities, err (T, S) i32 python-sgp4 codes; failed
    points are zero-filled.
    """
    n_times, n_sats = _check_sep(t_time, t_sat, spine, tail, flags)
    dev = _launch_device(t_time, kepler_iters, "propagate_fast_sep")
    if dev.type == "cpu":
        return propagate_fast_sep_reference(
            t_time, t_sat, spine, tail, flags, grav=grav,
            kepler_iters=kepler_iters, want_vel=want_vel)
    r, v, err = _outputs(dev, n_times, n_sats, want_vel)
    if n_times == 0 or n_sats == 0:
        return r, v, err
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.astroz_sgp4_shallow(
            t_time.data_ptr(), t_sat.data_ptr(), spine.data_ptr(),
            tail.data_ptr(), flags.data_ptr(), n_times, n_sats,
            kepler_iters, int(want_vel), *_grav_args(grav), r.data_ptr(),
            _ptr(v), err.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "sgp4_shallow")
    return r, v, err


# ---------------------------------------------------------------------------
# K2: the deep-space subset
# ---------------------------------------------------------------------------


def _check_deep(t_time, t_sat, spine, tail, flags, tables):
    n_times, n_deep = t_time.shape[0], t_sat.shape[0]
    if tables.dim() != 3 or tables.shape[1] < 2 or tables.shape[1] % 2:
        raise ValueError("tables: expected (5, 2 * (steps + 1), D), got "
                         f"{tuple(tables.shape)}")
    _check(t_time.device, (
        (t_time, (n_times,), F64, "t_time"),
        (t_sat, (n_deep,), F64, "t_sat"),
        (spine, (len(DEEP_SPINE_FIELD_NAMES), n_deep), F64, "spine"),
        (tail, (len(DEEP_FIELD_NAMES), n_deep), F32, "tail"),
        (flags, (2, n_deep), I32, "flags"),
        (tables, (len(RESONANCE_TABLE_NAMES), tables.shape[1], n_deep), F64,
         "tables")))
    return n_times, n_deep, tables.shape[1] // 2 - 1


def propagate_deep_sep_reference(t_time, t_sat, spine, tail, flags, tables,
                                 *, grav: GravityModel, kepler_iters: int,
                                 want_vel: bool = True):
    """Plain torch version of K2, on any device: the same arguments and
    returns as :func:`propagate_deep_sep`."""
    _check_deep(t_time, t_sat, spine, tail, flags, tables)
    tsince = t_time[:, None] - t_sat[None, :]
    fields = dict(zip(DEEP_FIELD_NAMES, tail))
    fields["error0"] = flags[1]
    return _planes(deep_tail_f32(
        grav, kepler_iters,
        *deep_spine_f64(tsince, tables, irez=flags[0],
                        **dict(zip(DEEP_SPINE_FIELD_NAMES, spine))),
        want_vel=want_vel, **fields), want_vel)


def propagate_deep_sep(t_time, t_sat, spine, tail, flags, tables, *,
                       grav: GravityModel, kepler_iters: int,
                       want_vel: bool = True):
    """K2: propagate deep-space satellites over ``t_time[t] - t_sat[d]``.

    Args:
      t_time: (T,) f64 minutes, on the same base as ``t_sat``.
      t_sat: (D,) f64 epochs of the deep satellites in minutes.
      spine: (13, D) f64 rows ``ops.fast.DEEP_SPINE_FIELD_NAMES``.
      tail: (33, D) f32 rows ``ops.fast.DEEP_FIELD_NAMES``.
      flags: (2, D) i32 rows ``[irez, init error]``.
      tables: (5, 2 * (steps + 1), D) f64 resonance tables
        (``ops.fast.resonance_tables``).
      grav: the gravity model the elements were initialized with.
      kepler_iters: Newton trips, one of :data:`DEEP_KEPLER_ITERS` on
        CUDA.
      want_vel: compute and return velocities.

    Returns ``(r, v, err)`` as :func:`propagate_fast_sep` does, over the
    D deep satellites.
    """
    n_times, n_deep, n_steps = _check_deep(t_time, t_sat, spine, tail,
                                           flags, tables)
    dev = _device_of(t_time, "propagate_deep_sep")
    if dev.type == "cpu":
        return propagate_deep_sep_reference(
            t_time, t_sat, spine, tail, flags, tables, grav=grav,
            kepler_iters=kepler_iters, want_vel=want_vel)
    if kepler_iters not in DEEP_KEPLER_ITERS:
        raise ValueError(f"kepler_iters must be one of {DEEP_KEPLER_ITERS}, "
                         f"got {kepler_iters}")
    r, v, err = _outputs(dev, n_times, n_deep, want_vel)
    if n_times == 0 or n_deep == 0:
        return r, v, err
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.astroz_sgp4_deep(
            t_time.data_ptr(), t_sat.data_ptr(), spine.data_ptr(),
            tail.data_ptr(), flags.data_ptr(), tables.data_ptr(), n_times,
            n_deep, n_steps, kepler_iters, int(want_vel), *_grav_args(grav),
            _f32(grav.xke), _f32(grav.j3oj2), r.data_ptr(), _ptr(v),
            err.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "sgp4_deep")
    return r, v, err


# ---------------------------------------------------------------------------
# K3: K1 with the deep columns merged in from K2's planes
# ---------------------------------------------------------------------------


def _check_merge(t_time, t_sat, spine, tail, flags, deep_slot, dr, dv, de,
                 want_vel):
    n_times, n_sats = _check_sep(t_time, t_sat, spine, tail, flags)
    n_deep = de.shape[-1] if de.dim() == 2 else -1
    if n_deep < 1:
        raise ValueError(f"de: expected (T, D) with D >= 1, got "
                         f"{tuple(de.shape)}")
    expected = [(deep_slot, (n_sats,), I32, "deep_slot"),
                (dr, (3, n_times, n_deep), F32, "dr"),
                (de, (n_times, n_deep), I32, "de")]
    if want_vel:
        if dv is None:
            raise ValueError("dv: the deep velocity planes are needed with "
                             "want_vel=True")
        expected.append((dv, (3, n_times, n_deep), F32, "dv"))
    _check(t_time.device, expected)
    return n_times, n_sats, n_deep


def propagate_fast_sep_merge_reference(t_time, t_sat, spine, tail, flags,
                                       deep_slot, dr, dv, de, *,
                                       grav: GravityModel,
                                       kepler_iters: int,
                                       want_vel: bool = True):
    """Plain torch version of K3, on any device: K1's plain version, then
    a select of the deep columns from the deep planes. The same
    arguments and returns as :func:`propagate_fast_sep_merge`."""
    _check_merge(t_time, t_sat, spine, tail, flags, deep_slot, dr, dv, de,
                 want_vel)
    r3, v3, err = propagate_fast_sep_reference(
        t_time, t_sat, spine, tail, flags, grav=grav,
        kepler_iters=kepler_iters, want_vel=want_vel)
    deep_col = deep_slot >= 0
    slot = deep_slot.clamp(min=0).long()
    r3 = torch.where(deep_col, dr[:, :, slot], r3)
    v3 = torch.where(deep_col, dv[:, :, slot], v3) if want_vel else None
    return r3, v3, torch.where(deep_col, de[:, slot], err)


class MergeMaps(NamedTuple):
    """K3's column maps of one ``deep_slot`` tensor, which they keep:
    K3 takes them only with that very tensor."""
    slot: torch.Tensor  # (S,) i32 deep_slot they were made from
    near_cols: torch.Tensor  # (S - D,) i32 near-earth columns, in order
    deep_cols: torch.Tensor  # (D,) i32 column of each deep slot


def merge_maps(deep_slot, n_deep) -> MergeMaps:
    """K3's column maps from a ``deep_slot`` map. Raises unless each of
    the ``n_deep`` slots is taken by exactly one column (this reads the
    map on the host)."""
    deep = deep_slot >= 0
    cols = torch.nonzero(deep).flatten()
    slots = deep_slot[cols].long()
    if not torch.equal(torch.sort(slots).values,
                       torch.arange(n_deep, device=slots.device)):
        raise ValueError(f"deep_slot must give each of the {n_deep} deep "
                         "slots exactly one column")
    deep_cols = torch.empty(n_deep, dtype=I32, device=deep_slot.device)
    deep_cols[slots] = cols.to(I32)
    return MergeMaps(deep_slot, torch.nonzero(~deep).flatten().to(I32),
                     deep_cols)


def propagate_fast_sep_merge(t_time, t_sat, spine, tail, flags, deep_slot,
                             dr, dv, de, *, grav: GravityModel,
                             kepler_iters: int, want_vel: bool = True,
                             maps: MergeMaps | None = None):
    """K3: K1 over a mixed catalog, whose deep columns are copied from
    K2's planes instead of propagated.

    Args:
      t_time, t_sat, spine, tail, flags, grav, kepler_iters, want_vel:
        as :func:`propagate_fast_sep`, over all S satellites.
      deep_slot: (S,) i32, -1 on near-earth columns, else the column's
        index in the deep subset.
      dr, dv, de: K2's planes over the D >= 1 deep satellites: (3, T, D)
        f32, (3, T, D) f32 (may be None without velocities), (T, D) i32.
      maps: the kernel's column maps, :func:`merge_maps` of this
        ``deep_slot`` tensor (a catalog keeps them in its staging); made
        here, with one read on the host, when not given. Maps of any
        other tensor raise.

    Returns ``(r, v, err)`` as :func:`propagate_fast_sep`.
    """
    n_times, n_sats, n_deep = _check_merge(t_time, t_sat, spine, tail,
                                           flags, deep_slot, dr, dv, de,
                                           want_vel)
    dev = _launch_device(t_time, kepler_iters, "propagate_fast_sep_merge")
    if maps is not None and maps.slot is not deep_slot:
        raise ValueError("maps: made from another deep_slot tensor; pass "
                         "merge_maps(deep_slot, D) or none")
    if dev.type == "cpu":
        return propagate_fast_sep_merge_reference(
            t_time, t_sat, spine, tail, flags, deep_slot, dr, dv, de,
            grav=grav, kepler_iters=kepler_iters, want_vel=want_vel)
    if maps is None:
        maps = merge_maps(deep_slot, n_deep)
    _, near_cols, deep_cols = maps
    n_near = n_sats - n_deep
    _check(dev, ((near_cols, (n_near,), I32, "near_cols"),
                 (deep_cols, (n_deep,), I32, "deep_cols")))
    r, v, err = _outputs(dev, n_times, n_sats, want_vel)
    if n_times == 0:
        return r, v, err
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.astroz_sgp4_shallow_merge(
            t_time.data_ptr(), t_sat.data_ptr(), spine.data_ptr(),
            tail.data_ptr(), flags.data_ptr(), n_times, n_sats,
            kepler_iters, int(want_vel), *_grav_args(grav),
            near_cols.data_ptr(), n_near, deep_cols.data_ptr(),
            dr.data_ptr(), _ptr(dv) if want_vel else None, de.data_ptr(),
            n_deep, r.data_ptr(), _ptr(v), err.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "sgp4_shallow_merge")
    return r, v, err


# ---------------------------------------------------------------------------
# K5: K1 on a dense tsince grid
# ---------------------------------------------------------------------------


def _check_tail(device, tail, flags, n_sats):
    _check(device, ((tail, (len(TAIL_FIELD_NAMES), n_sats), F32, "tail"),
                    (flags, (2, n_sats), I32, "flags")))


def _check_tsince(tsince, spine):
    if tsince.dim() != 2:
        raise ValueError(f"tsince: expected (T, S) or (T, 1), got "
                         f"{tuple(tsince.shape)}")
    n_times, n_sats = tsince.shape[0], spine.shape[-1]
    if tsince.shape[1] not in (1, n_sats):
        raise ValueError(f"tsince: expected ({n_times}, {n_sats}) or "
                         f"({n_times}, 1), got {tuple(tsince.shape)}")
    _check(tsince.device, (
        (tsince, tuple(tsince.shape), F64, "tsince"),
        (spine, (len(SPINE_FIELD_NAMES), n_sats), F64, "spine")))
    return n_times, n_sats


def _check_dense(tsince, spine, tail, flags):
    n_times, n_sats = _check_tsince(tsince, spine)
    _check_tail(tsince.device, tail, flags, n_sats)
    return n_times, n_sats


def propagate_fast_dense_reference(tsince, spine, tail, flags, *,
                                   grav: GravityModel, kepler_iters: int,
                                   want_vel: bool = True):
    """Plain torch version of K5, on any device: the same arguments and
    returns as :func:`propagate_fast_dense`."""
    _check_dense(tsince, spine, tail, flags)
    return _tail_reference(_spine_grids(tsince, spine), tail, flags, grav,
                           kepler_iters, want_vel)


def _time_major(r3, v3, err):
    """The JAX wrappers' (T, S, 3) layout from the (3, T, S) planes."""
    r = r3.permute(1, 2, 0).contiguous()
    v = None if v3 is None else v3.permute(1, 2, 0).contiguous()
    return r, v, err


def _dense(tsince, spine, tail, flags, grav, kepler_iters, want_vel,
           time_major):
    """K5 (or its plain version on a CPU tensor) into the (3, T, S)
    planes, or with ``time_major`` into (T, S, 3) r and v."""
    n_times, n_sats = _check_dense(tsince, spine, tail, flags)
    dev = _launch_device(tsince, kepler_iters, "propagate_fast_dense")
    if dev.type == "cpu":
        out = propagate_fast_dense_reference(
            tsince, spine, tail, flags, grav=grav, kepler_iters=kepler_iters,
            want_vel=want_vel)
        return _time_major(*out) if time_major else out
    r, v, err = _outputs(dev, n_times, n_sats, want_vel, time_major)
    if n_times == 0 or n_sats == 0:
        return r, v, err
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.astroz_sgp4_shallow_dense(
            tsince.data_ptr(), int(tsince.shape[1] == n_sats),
            spine.data_ptr(), tail.data_ptr(), flags.data_ptr(), n_times,
            n_sats, kepler_iters, int(want_vel), int(time_major),
            *_grav_args(grav), r.data_ptr(), _ptr(v), err.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "sgp4_shallow_dense")
    return r, v, err


def propagate_fast_dense(tsince, spine, tail, flags, *, grav: GravityModel,
                         kepler_iters: int, want_vel: bool = True):
    """K5: propagate near-earth satellites to a dense grid of minutes
    since each one's epoch.

    Args:
      tsince: (T, S) f64, or a (T, 1) column that every satellite shares
        (the kernel reads it with a satellite stride of 0).
      spine, tail, flags, grav, kepler_iters, want_vel: as
        :func:`propagate_fast_sep` (``ops.fast.shallow_staging``).

    Returns ``(r, v, err)`` as :func:`propagate_fast_sep`.
    """
    return _dense(tsince, spine, tail, flags, grav, kepler_iters, want_vel,
                  time_major=False)


def _tsince_for(els, tsince):
    return torch.as_tensor(tsince, dtype=F64, device=els.no_kozai.device)


#: the one element set :func:`_staged` keeps: ``((weak reference, version
#: counter) of each element tensor, their shallow_staging)``, or None
_STAGED = None


def _staged(els):
    """``shallow_staging(els)``, staged once per element set.

    The kept staging is returned while each element tensor is the same
    live object as when it was staged, at the same address, and its
    version counter (``Tensor._version``, which an expanded view shares
    with its base) has not moved. That counter sees only writes made
    through torch, so
    elements whose memory torch did not allocate (``torch.from_numpy``,
    ``torch.as_tensor`` of a numpy array, DLPack), which can be written
    behind its back, are staged afresh on every call and never kept. The
    entry holds weak references, so it keeps no element tensor alive,
    and it is replaced whole, so threads that share it never read half of
    one entry and half of another."""
    global _STAGED
    entry = _STAGED
    if entry is not None and len(entry[0]) == len(els) and all(
            ref() is x and key == (x._version, x.data_ptr())
            for (ref, key), x in zip(entry[0], els)):
        return entry[1]
    staging = shallow_staging(els)
    if all(x.untyped_storage().resizable() for x in els):
        _STAGED = (tuple((weakref.ref(x), (x._version, x.data_ptr()))
                         for x in els), staging)
    return staging


def propagate_fast_fused_reference(els, tsince, grav: GravityModel,
                                   kepler_iters: int = 5,
                                   want_vel: bool = True):
    """Plain torch version of :func:`propagate_fast_fused`, on any
    device (``ops.fast.spine_f64`` + ``shallow_tail_f32``)."""
    return _time_major(*propagate_fast_dense_reference(
        _tsince_for(els, tsince), *shallow_staging(els), grav=grav,
        kepler_iters=kepler_iters, want_vel=want_vel))


def propagate_fast_fused(els, tsince, grav: GravityModel,
                         kepler_iters: int = 5, want_vel: bool = True):
    """Near-earth propagate of elements (``Sgp4Elements`` of tensors,
    broadcast satellites too) to a dense ``tsince`` grid through K5,
    which writes the time-major layout; the elements are staged once per
    element set (:func:`_staged`).

    ``tsince``: (T, S) or (T, 1) f64 minutes since each epoch. Returns
    ``(r, v, err)``: r and v (T, S, 3) f32 TEME km and km/s, contiguous
    (v None with ``want_vel=False``), err (T, S) i32 python-sgp4 codes."""
    return _dense(_tsince_for(els, tsince), *_staged(els), grav,
                  kepler_iters, want_vel, time_major=True)


def launch_grid(kernel, n_times, n_sats, *, kepler_iters, want_vel=True):
    """The persistent grid that K5 (``kernel="sgp4_shallow_dense"``), K6
    (``"sgp4_shallow_grids"``) or K2 (``"sgp4_deep"``) launches on the
    current CUDA device at ``n_times`` x ``n_sats``: ``{"per_sm": blocks
    an SM (the instantiation's occupancy), "sms": the card's SMs,
    "blocks": blocks launched, "waves": blocks / (per_sm * sms)}``."""
    fn = {"sgp4_shallow_dense": "astroz_sgp4_shallow_dense_grid",
          "sgp4_shallow_grids": "astroz_sgp4_shallow_grids_grid",
          "sgp4_deep": "astroz_sgp4_deep_grid"}[kernel]
    grid = (ctypes.c_int * 3)()
    rc = getattr(_build.library(), fn)(n_times, n_sats, kepler_iters,
                                       int(want_vel), ctypes.addressof(grid))
    if rc != 0:
        raise RuntimeError(f"{kernel} grid query failed: cudaError {rc}")
    per_sm, sms, blocks = grid
    return {"per_sm": per_sm, "sms": sms, "blocks": blocks,
            "waves": blocks / (per_sm * sms)}


# ---------------------------------------------------------------------------
# The spine kernel and K6: the tail on the f64 spine's six grids
# ---------------------------------------------------------------------------


def spine_f64_grids_reference(tsince, spine):
    """Plain torch version of the spine kernel, on any device: the same
    arguments and returns as :func:`spine_f64_grids`."""
    shape = _check_tsince(tsince, spine)
    return tuple(g.expand(shape).contiguous()
                 for g in _spine_grids(tsince, spine))


def spine_f64_grids(tsince, spine):
    """The spine kernel: ``ops.fast.spine_f64`` as K6 reads it.

    Args:
      tsince: (T, S) f64 minutes since each epoch, or a (T, 1) column
        that every satellite shares (read with a satellite stride of 0).
      spine: (12, S) f64 rows ``ops.fast.SPINE_FIELD_NAMES``.

    Returns the six contiguous (T, S) f32 grids t32, u_base, mm, argp32,
    node32, xmdf32.
    """
    n_times, n_sats = _check_tsince(tsince, spine)
    dev = _device_of(tsince, "spine_f64_grids")
    if dev.type == "cpu":
        return spine_f64_grids_reference(tsince, spine)
    grids = torch.empty((6, n_times, n_sats), dtype=F32,
                        device=dev).unbind(0)
    if n_times == 0 or n_sats == 0:
        return grids
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.astroz_sgp4_spine_grids(
            tsince.data_ptr(), int(tsince.shape[1] == n_sats),
            spine.data_ptr(), n_times, n_sats,
            *(g.data_ptr() for g in grids),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "sgp4_spine_grids")
    return grids


def _check_grids(grids, tail, flags):
    if len(grids) != 6 or grids[0].dim() != 2:
        raise ValueError("grids: expected six (T, S) f32 tensors "
                         "(t32, u_base, mm, argp32, node32, xmdf32)")
    shape = tuple(grids[0].shape)
    _check(grids[0].device, [(g, shape, F32, f"grids[{k}]")
                             for k, g in enumerate(grids)])
    _check_tail(grids[0].device, tail, flags, shape[1])
    return shape


def propagate_fast_spine_grids_reference(grids, tail, flags, *,
                                         grav: GravityModel,
                                         kepler_iters: int,
                                         want_vel: bool = True):
    """Plain torch version of K6, on any device: the same arguments and
    returns as :func:`propagate_fast_spine_grids`."""
    _check_grids(grids, tail, flags)
    return _tail_reference(grids, tail, flags, grav, kepler_iters, want_vel)


def _grids_tail(grids, tail, flags, grav, kepler_iters, want_vel,
                time_major):
    """K6 (or its plain version on a CPU tensor) into the (3, T, S)
    planes, or with ``time_major`` into (T, S, 3) r and v."""
    n_times, n_sats = _check_grids(grids, tail, flags)
    dev = _launch_device(grids[0], kepler_iters,
                         "propagate_fast_spine_grids")
    if dev.type == "cpu":
        out = propagate_fast_spine_grids_reference(
            grids, tail, flags, grav=grav, kepler_iters=kepler_iters,
            want_vel=want_vel)
        return _time_major(*out) if time_major else out
    r, v, err = _outputs(dev, n_times, n_sats, want_vel, time_major)
    if n_times == 0 or n_sats == 0:
        return r, v, err
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.astroz_sgp4_shallow_grids(
            *(g.data_ptr() for g in grids), tail.data_ptr(),
            flags.data_ptr(), n_times, n_sats, kepler_iters, int(want_vel),
            int(time_major), *_grav_args(grav), r.data_ptr(), _ptr(v),
            err.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "sgp4_shallow_grids")
    return r, v, err


def propagate_fast_spine_grids(grids, tail, flags, *, grav: GravityModel,
                               kepler_iters: int, want_vel: bool = True):
    """K6: the near-earth tail on the f64 spine's grids.

    Args:
      grids: the six (T, S) f32 tensors ``ops.fast.spine_f64`` returns,
        t32, u_base, mm, argp32, node32, xmdf32, each contiguous.
      tail, flags, grav, kepler_iters, want_vel: as
        :func:`propagate_fast_sep`.

    Returns ``(r, v, err)`` as :func:`propagate_fast_sep`.
    """
    return _grids_tail(grids, tail, flags, grav, kepler_iters, want_vel,
                       time_major=False)


def spine_grids(els, tsince):
    """The f64 spine of ``els`` at ``tsince`` ((T, S) or (T, 1) f64) as
    K6 reads it (:func:`spine_f64_grids`), and the staging's tail and
    flags."""
    spine, tail, flags = _staged(els)
    return spine_f64_grids(_tsince_for(els, tsince), spine), tail, flags


def propagate_fast_grids_reference(els, tsince, grav: GravityModel,
                                   kepler_iters: int = 5,
                                   want_vel: bool = True):
    """Plain torch version of :func:`propagate_fast_grids`, on any
    device: the plain spine, then K6's plain version."""
    spine, tail, flags = shallow_staging(els)
    grids = spine_f64_grids_reference(_tsince_for(els, tsince), spine)
    return _time_major(*propagate_fast_spine_grids_reference(
        grids, tail, flags, grav=grav, kepler_iters=kepler_iters,
        want_vel=want_vel))


def propagate_fast_grids(els, tsince, grav: GravityModel,
                         kepler_iters: int = 5, want_vel: bool = True):
    """:func:`propagate_fast_fused`'s function in two kernels: the spine
    kernel writes the f64 spine's grids (:func:`spine_grids`) and K6 runs
    the tail on them into the time-major layout. The same arguments and
    returns."""
    return _grids_tail(*spine_grids(els, tsince), grav, kepler_iters,
                       want_vel, time_major=True)
