"""The CUDA propagation kernels K1, K2, K3, K5 and K6, the f64 spine
kernel that feeds K6, the f64 kernel, and their plain versions.

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
* TABLES, :func:`resonance_tables` (``csrc/sgp4_deep.cu``; not a TPU
  kernel: the ``lax.scan`` of ``astroz_tpu/ops/fast.py:138``), builds the
  resonance tables K2, the HEO escape and the mixed tail of
  :func:`propagate_fast` (the unified dense entry point) read, one thread
  a (deep lane, direction).
* The f64 kernel (``csrc/sgp4_f64.cu``; not a TPU kernel: the f64
  programs the JAX package jits around its Pallas kernels) computes
  ``ops/sgp4.py:sgp4_propagate`` / ``ops/sdp4.py:sdp4_propagate`` at
  independent points (:func:`sgp4_f64_dense` on a tsince grid,
  :func:`sgp4_f64_dense_epochs` on a sweep's jd and fr rows) and the HEO
  escape's ``ops/fast.py:sdp4_propagate_tables`` into K2's planes
  (:func:`sgp4_f64_escape`), on the elements packed by
  :func:`f64_staging`. ``ops/sdp4.py:sdp4_propagate_scan``
  (:func:`sgp4_f64_scan`) is DENSE on a sweep's rows on the card.

K1-K3 propagate over the separable grid ``tsince[t, n] = t_time[t] -
t_sat[n]`` minutes and return the grouped planes ``r (3, T, N)`` f32,
``v (3, T, N)`` f32 (``None`` with ``want_vel=False``) and ``err (T, N)``
i32. K5 and K6 propagate over a dense grid and write ``r``, ``v`` (T, N,
3) and ``err`` (T, N), the layout of the JAX wrappers, themselves; their
element-level callers stage the elements once per element set
(:func:`_staged`). The
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
import math
import weakref
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..constants import MINUTES_PER_DAY, GravityModel
from ..profiling import span
from .fast import (DEEP_FIELD_NAMES, DEEP_SPINE_FIELD_NAMES,
                   RESONANCE_TABLE_NAMES, SPINE_FIELD_NAMES,
                   TAIL_FIELD_NAMES, deep_spine_f64, deep_tail_f32,
                   propagate_fast_mixed, resonance_tables_reference,
                   sdp4_propagate_tables, shallow_staging, shallow_tail_f32,
                   spine_f64)
from .sdp4 import (FASX2, FASX4, FASX6, G22, G32, G44, G52, G54,
                   DeepElements, sdp4_propagate, sdp4_propagate_scan)
from .sgp4 import Sgp4Elements, sgp4_propagate

#: Newton trip counts K1 and K3 are built for (SatCatalog.kepler_iters)
KEPLER_ITERS = (3, 4, 5, 8)
#: Newton trip counts K2 is built for (SatCatalog.deep_kepler_iters)
DEEP_KEPLER_ITERS = (6, 8)

#: kernel launches so far in this process, by kernel; each launch adds
#: one to its kernel's entry (a DENSE launch on a sweep's epochs,
#: :func:`sgp4_f64_dense_epochs` and :func:`sgp4_f64_scan`, to
#: ``"sgp4_f64_dense"`` and to ``"sgp4_f64_dense_epochs"``)
LAUNCHES = {"sgp4_shallow": 0, "sgp4_deep": 0, "sgp4_shallow_merge": 0,
            "sgp4_shallow_dense": 0, "sgp4_shallow_grids": 0,
            "sgp4_spine_grids": 0, "sgp4_f64_dense": 0,
            "sgp4_f64_dense_epochs": 0, "sgp4_f64_escape": 0,
            "resonance_tables": 0}

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


def _outputs(dev, n_times, n, want_vel):
    """K1's, K2's or K3's new (3, T, S) f32 planes r and v (v None
    without velocities) and its (T, S) codes; one ``astroz.alloc`` span
    under a profiler."""
    with span("astroz.alloc"):
        r = torch.empty((3, n_times, n), dtype=F32, device=dev)
        v = torch.empty_like(r) if want_vel else None
        err = torch.empty((n_times, n), dtype=I32, device=dev)
    return r, v, err


def _outputs_rows(dev, shape, want_vel, dtype):
    """A kernel's new time-major ``shape + (3,)`` r and v of ``dtype``
    (v None without velocities) and its ``shape`` codes: K5's and K6's
    f32, the f64 kernel's f64; one ``astroz.alloc`` span under a
    profiler."""
    with span("astroz.alloc"):
        r = torch.empty(tuple(shape) + (3,), dtype=dtype, device=dev)
        v = torch.empty_like(r) if want_vel else None
        err = torch.empty(shape, dtype=I32, device=dev)
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
        (:func:`resonance_tables`).
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
# TABLES: the resonance tables of a deep subset
# ---------------------------------------------------------------------------

#: rows of the matrix TABLES reads: ``DeepElements`` and ``Sgp4Elements``
#: fields (``irez`` as f64), in kernel order (csrc/sgp4_deep.cu
#: ResonanceField)
RESONANCE_FIELD_NAMES = ("xlamo", "no_unkozai", "argpo", "argpdot", "xfact",
                         "del1", "del2", "del3", "d2201", "d2211", "d3210",
                         "d3222", "d4410", "d4422", "d5220", "d5232",
                         "d5421", "d5433", "irez")
#: the phase constants of ``fast._resonance_derivs_fast``'s shifts, in
#: kernel order (csrc/sgp4_deep.cu Shift)
RESONANCE_SHIFTS = (FASX2, 2.0 * FASX4, 3.0 * FASX6, G22, G32, G44, G52, G54)


def _resonance_fields(deep, els) -> torch.Tensor:
    """The (19, D) f64 matrix of :data:`RESONANCE_FIELD_NAMES`."""
    return torch.stack([
        (getattr(els, n) if n in Sgp4Elements._fields
         else getattr(deep, n)).to(F64) for n in RESONANCE_FIELD_NAMES])


def resonance_tables(deep, els, n_steps: int) -> torch.Tensor:
    """TABLES: the resonance tables of ``ops/fast.py:
    resonance_tables_reference`` (the same arguments and result: ``(5, 2 *
    (n_steps + 1), D)`` f64, forward steps first), one thread a (lane,
    direction) walking its ``n_steps + 1`` steps.

    ``deep`` and ``els`` hold the lanes' DeepElements and Sgp4Elements as
    (D,) tensors on one device; the phase constants' sines and cosines go
    to the kernel as the host computes them, rounded to f32
    (:data:`RESONANCE_SHIFTS`), as the plain version's python floats are.
    """
    xlamo = deep.xlamo
    dev = _device_of(xlamo, "resonance_tables")
    if dev.type == "cpu":
        return resonance_tables_reference(deep, els, n_steps)
    if xlamo.dim() != 1 or n_steps < 0:
        raise ValueError(f"resonance_tables: expected (D,) lanes and "
                         f"n_steps >= 0, got {tuple(xlamo.shape)}, {n_steps}")
    n_deep = xlamo.shape[0]
    fields = _resonance_fields(deep, els)
    _check(dev, ((fields, (len(RESONANCE_FIELD_NAMES), n_deep), F64,
                  "fields"),))
    tables = torch.empty((len(RESONANCE_TABLE_NAMES), 2 * (n_steps + 1),
                          n_deep), dtype=F64, device=dev)
    if n_deep == 0:
        return tables
    shifts = np.array([[math.sin(c) for c in RESONANCE_SHIFTS],
                       [math.cos(c) for c in RESONANCE_SHIFTS]], np.float32)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.astroz_resonance_tables(
            fields.data_ptr(), n_deep, n_steps,
            shifts.ctypes.data_as(ctypes.c_void_p), tables.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "resonance_tables")
    return tables


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


def _time_major(r3, v3, err):
    """The JAX wrappers' (T, S, 3) layout from the (3, T, S) planes."""
    r = r3.permute(1, 2, 0).contiguous()
    v = None if v3 is None else v3.permute(1, 2, 0).contiguous()
    return r, v, err


def propagate_fast_dense_reference(tsince, spine, tail, flags, *,
                                   grav: GravityModel, kepler_iters: int,
                                   want_vel: bool = True):
    """Plain torch version of K5, on any device: the same arguments and
    returns as :func:`propagate_fast_dense`."""
    _check_dense(tsince, spine, tail, flags)
    return _time_major(*_tail_reference(_spine_grids(tsince, spine), tail,
                                        flags, grav, kepler_iters, want_vel))


def propagate_fast_dense(tsince, spine, tail, flags, *, grav: GravityModel,
                         kepler_iters: int, want_vel: bool = True):
    """K5: propagate near-earth satellites to a dense grid of minutes
    since each one's epoch.

    Args:
      tsince: (T, S) f64, or a (T, 1) column that every satellite shares
        (the kernel reads it with a satellite stride of 0).
      spine, tail, flags, grav, kepler_iters, want_vel: as
        :func:`propagate_fast_sep` (``ops.fast.shallow_staging``).

    Returns ``(r, v, err)``: r and v (T, S, 3) f32 TEME km and km/s,
    contiguous (v None with ``want_vel=False``), err (T, S) i32
    python-sgp4 codes. On a CPU tensor the plain version runs.
    """
    n_times, n_sats = _check_dense(tsince, spine, tail, flags)
    dev = _launch_device(tsince, kepler_iters, "propagate_fast_dense")
    if dev.type == "cpu":
        return propagate_fast_dense_reference(
            tsince, spine, tail, flags, grav=grav, kepler_iters=kepler_iters,
            want_vel=want_vel)
    r, v, err = _outputs_rows(dev, (n_times, n_sats), want_vel, F32)
    if n_times == 0 or n_sats == 0:
        return r, v, err
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.astroz_sgp4_shallow_dense(
            tsince.data_ptr(), int(tsince.shape[1] == n_sats),
            spine.data_ptr(), tail.data_ptr(), flags.data_ptr(), n_times,
            n_sats, kepler_iters, int(want_vel), *_grav_args(grav),
            r.data_ptr(), _ptr(v), err.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "sgp4_shallow_dense")
    return r, v, err


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
    return propagate_fast_dense_reference(
        _tsince_for(els, tsince), *shallow_staging(els), grav=grav,
        kepler_iters=kepler_iters, want_vel=want_vel)


def propagate_fast_fused(els, tsince, grav: GravityModel,
                         kepler_iters: int = 5, want_vel: bool = True):
    """Near-earth propagate of elements (``Sgp4Elements`` of tensors,
    broadcast satellites too) to a dense ``tsince`` grid through K5
    (:func:`propagate_fast_dense`); the elements are staged once per
    element set (:func:`_staged`).

    ``tsince``: (T, S) or (T, 1) f64 minutes since each epoch. Returns
    ``(r, v, err)`` as :func:`propagate_fast_dense`."""
    return propagate_fast_dense(_tsince_for(els, tsince), *_staged(els),
                                grav=grav, kepler_iters=kepler_iters,
                                want_vel=want_vel)


def propagate_fast(els, deep, tsince, grav: GravityModel, carry=None,
                   kepler_iters: int = 8, resonance_steps=None):
    """Split-precision propagate of a catalog to ``tsince`` minutes from
    each epoch (f64, broadcasting against the ``(n_sats,)`` elements): the
    JAX package's unified dense entry point (``astroz_tpu/ops/fast.py:644``).

    Returns ``(r, v, error)``: f32 TEME km and km/s stacked ``(..., 3)``,
    int32 python-sgp4 codes. With ``deep`` None (a near-earth catalog)
    this is :func:`propagate_fast_fused` (K5). Otherwise the plain mixed
    tail ``ops/fast.py:propagate_fast_mixed`` runs over every lane, its
    resonance read from :func:`resonance_tables` (TABLES,
    ``resonance_steps`` deep, 64 by default) or, with a
    :class:`~.sdp4.ResonanceCarry`, stepped from ``carry`` per point."""
    if deep is not None:
        tables = None
        if carry is None:
            tables = resonance_tables(deep, els, resonance_steps or 64)
        return propagate_fast_mixed(els, deep, tsince, grav, tables=tables,
                                    carry=carry, kepler_iters=kepler_iters)
    t = torch.as_tensor(tsince, dtype=els.no_kozai.dtype,
                        device=els.no_kozai.device)
    n_sats = els.no_kozai.shape[0]
    shape = torch.broadcast_shapes(t.shape, (n_sats,))
    if t.dim() != 2 or t.shape[1] not in (1, n_sats):
        t = t.expand(shape).reshape(-1, n_sats)
    r, v, err = propagate_fast_fused(els, t.contiguous(), grav,
                                     kepler_iters=kepler_iters)
    return (r.reshape(shape + (3,)), v.reshape(shape + (3,)),
            err.reshape(shape))


def launch_grid(kernel, n_times, n_sats, *, kepler_iters=None,
                want_vel=True, sdp4=False):
    """The persistent grid that K5 (``kernel="sgp4_shallow_dense"``), K6
    (``"sgp4_shallow_grids"``), K2 (``"sgp4_deep"``) or the f64 kernel's
    row walk (``"sgp4_f64_dense"``, in SDP4 mode with ``sdp4``; ``n_sats``
    the output columns) launches on the current CUDA
    device at ``n_times`` x ``n_sats``: ``{"per_sm": blocks an SM (the
    instantiation's occupancy), "sms": the card's SMs, "blocks": blocks
    launched, "waves": blocks / (per_sm * sms)}``."""
    fn = {"sgp4_shallow_dense": "astroz_sgp4_shallow_dense_grid",
          "sgp4_shallow_grids": "astroz_sgp4_shallow_grids_grid",
          "sgp4_deep": "astroz_sgp4_deep_grid",
          "sgp4_f64_dense": "astroz_sgp4_f64_grid"}[kernel]
    mode = int(sdp4) if kernel == "sgp4_f64_dense" else kepler_iters
    grid = (ctypes.c_int * 3)()
    rc = getattr(_build.library(), fn)(n_times, n_sats, mode,
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
    return _time_major(*_tail_reference(grids, tail, flags, grav,
                                        kepler_iters, want_vel))


def propagate_fast_spine_grids(grids, tail, flags, *, grav: GravityModel,
                               kepler_iters: int, want_vel: bool = True):
    """K6: the near-earth tail on the f64 spine's grids.

    Args:
      grids: the six (T, S) f32 tensors ``ops.fast.spine_f64`` returns,
        t32, u_base, mm, argp32, node32, xmdf32, each contiguous.
      tail, flags, grav, kepler_iters, want_vel: as
        :func:`propagate_fast_sep`.

    Returns ``(r, v, err)`` as :func:`propagate_fast_dense`.
    """
    n_times, n_sats = _check_grids(grids, tail, flags)
    dev = _launch_device(grids[0], kepler_iters,
                         "propagate_fast_spine_grids")
    if dev.type == "cpu":
        return propagate_fast_spine_grids_reference(
            grids, tail, flags, grav=grav, kepler_iters=kepler_iters,
            want_vel=want_vel)
    r, v, err = _outputs_rows(dev, (n_times, n_sats), want_vel, F32)
    if n_times == 0 or n_sats == 0:
        return r, v, err
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.astroz_sgp4_shallow_grids(
            *(g.data_ptr() for g in grids), tail.data_ptr(),
            flags.data_ptr(), n_times, n_sats, kepler_iters, int(want_vel),
            *_grav_args(grav), r.data_ptr(), _ptr(v), err.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "sgp4_shallow_grids")
    return r, v, err


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
    return propagate_fast_spine_grids_reference(
        grids, tail, flags, grav=grav, kepler_iters=kepler_iters,
        want_vel=want_vel)


def propagate_fast_grids(els, tsince, grav: GravityModel,
                         kepler_iters: int = 5, want_vel: bool = True):
    """:func:`propagate_fast_fused`'s function in two kernels: the spine
    kernel writes the f64 spine's grids (:func:`spine_grids`) and K6 runs
    the tail on them (:func:`propagate_fast_spine_grids`). The same
    arguments and returns."""
    return propagate_fast_spine_grids(*spine_grids(els, tsince), grav=grav,
                                      kepler_iters=kepler_iters,
                                      want_vel=want_vel)


# ---------------------------------------------------------------------------
# The f64 kernel: SGP4/SDP4 in f64 at independent points
# ---------------------------------------------------------------------------

#: the f64 rows of :func:`f64_staging`: the float fields of
#: ``Sgp4Elements``, then those of ``DeepElements``, in the order of
#: ``csrc/sgp4_f64.cu``'s ``enum Field``
SGP4_F64_FIELD_NAMES = tuple(n for n in Sgp4Elements._fields
                             if n not in ("isimp", "is_deep", "error"))
DEEP_F64_FIELD_NAMES = tuple(n for n in DeepElements._fields if n != "irez")
F64_FIELD_NAMES = SGP4_F64_FIELD_NAMES + DEEP_F64_FIELD_NAMES
#: the i32 rows of :func:`f64_staging` (``enum Flag``): the masks and
#: codes of each lane, then the slot order (:func:`f64_slot_lanes`)
F64_FLAG_NAMES = ("isimp", "is_deep", "irez", "error", "slot_lane")
#: the lunisolar periodics take the Lyddane branch below this inclination
#: (rad; ops/sdp4.py dpper, ops/fast.py _dpper_core)
LYDDANE_INCL = 0.2


class F64Staging(NamedTuple):
    """A catalog's elements as the f64 kernel reads them."""

    fields: torch.Tensor  # (F, S) f64 rows F64_FIELD_NAMES (37, or 83 with
    #                       the deep rows)
    flags: torch.Tensor  # (5, S) i32 rows F64_FLAG_NAMES


def f64_slot_lanes(is_deep, irez, inclo):
    """The f64 kernel's slot order: the lane that each slot computes,
    (S,) i32. Near-earth lanes first, then the deep lanes grouped by
    regime as K2's slots are (``propagation.deep_slots``: inclination at
    or above :data:`LYDDANE_INCL`, then below; resonance irez 0, 1, 2),
    in catalog order within a group, so that the 32 neighbouring slots of
    a warp seldom take both sides of the kernel's deep, Lyddane or
    resonance branches. The identity on a near-earth catalog. Each lane
    is propagated on its own, so the order moves no output bit."""
    key = torch.where(is_deep, 1 + 3 * (inclo < LYDDANE_INCL).to(I32)
                      + irez.to(I32), 0)
    return torch.sort(key, stable=True).indices.to(I32)


def f64_staging(els, deep=None) -> F64Staging:
    """Pack ``Sgp4Elements`` (and ``DeepElements``, where given) of
    tensors on one device, each field (S,) or broadcast to it, into the
    f64 kernel's matrices: every float field copied as it is, the masks
    and codes as i32 (``irez`` 0 without ``deep``), and the slot order
    (:func:`f64_slot_lanes`) as the last row of the flags.
    :func:`f64_unstage` gives the same elements back bit for bit."""
    shape = torch.broadcast_shapes(*(x.shape for x in els))
    rows = [getattr(els, n) for n in SGP4_F64_FIELD_NAMES]
    if deep is not None:
        rows += [getattr(deep, n) for n in DEEP_F64_FIELD_NAMES]
    dev = els.no_kozai.device
    irez = (torch.zeros(shape, dtype=I32, device=dev) if deep is None
            else deep.irez)
    flags = [x.to(I32).expand(shape)
             for x in (els.isimp, els.is_deep, irez, els.error)]
    flags.append(f64_slot_lanes(flags[1] != 0, flags[2],
                                els.inclo.expand(shape)))
    return F64Staging(
        torch.stack([x.to(F64).expand(shape) for x in rows]).contiguous(),
        torch.stack(flags).contiguous())


def f64_unstage(fields, flags):
    """``(Sgp4Elements, DeepElements or None)`` of :func:`f64_staging`'s
    matrices: views of their rows (bool masks, i32 codes and ``irez``);
    the deep elements where the matrix holds their rows. The slot order
    is not an element and is left out."""
    if fields.shape[0] not in (len(SGP4_F64_FIELD_NAMES),
                               len(F64_FIELD_NAMES)):
        raise ValueError(f"fields: expected {len(SGP4_F64_FIELD_NAMES)} or "
                         f"{len(F64_FIELD_NAMES)} rows, got "
                         f"{fields.shape[0]}")
    rows = dict(zip(F64_FIELD_NAMES, fields))
    rows.update(isimp=flags[0] != 0, is_deep=flags[1] != 0, error=flags[3])
    els = Sgp4Elements(*(rows[n] for n in Sgp4Elements._fields))
    deep = None
    if fields.shape[0] == len(F64_FIELD_NAMES):
        rows["irez"] = flags[2]
        deep = DeepElements(*(rows[n] for n in DeepElements._fields))
    return els, deep


def _f64_consts(grav: GravityModel):
    """The gravity model's numbers as the plain f64 functions form them
    in Python: xke, 1 / xke (``x / grav.xke`` multiplies by it on CUDA),
    0.5 j2, the earth radius, km/s per earth radius per minute, -0.5
    j3oj2 and -0.25 j3oj2."""
    return (grav.xke, 1.0 / grav.xke, 0.5 * grav.j2, grav.radius_earth_km,
            grav.radius_earth_km * grav.xke / 60.0, -0.5 * grav.j3oj2,
            -0.25 * grav.j3oj2)


def _check_f64(device, fields, flags, sdp4):
    n_lanes = fields.shape[-1] if fields.dim() == 2 else -1
    rows = len(F64_FIELD_NAMES) if sdp4 else fields.shape[0]
    if n_lanes < 1 or rows not in (len(SGP4_F64_FIELD_NAMES),
                                   len(F64_FIELD_NAMES)):
        raise ValueError(
            f"fields: expected ({len(F64_FIELD_NAMES)}, S) f64"
            + ("" if sdp4 else f" or ({len(SGP4_F64_FIELD_NAMES)}, S)")
            + f", got {tuple(fields.shape)}")
    _check(device, ((fields, (rows, n_lanes), F64, "fields"),
                    (flags, (len(F64_FLAG_NAMES), n_lanes), I32, "flags")))
    return n_lanes


def _launch_f64(name, fn, *args):
    rc = getattr(_build.library(), fn)(*args)
    _raise_on(rc, name)


def sgp4_f64_dense_reference(tsince, fields, flags, *, grav: GravityModel,
                             sdp4: bool, want_vel: bool = True):
    """Plain torch version of :func:`sgp4_f64_dense`, on any device:
    ``ops.sgp4.sgp4_propagate``, or with ``sdp4``
    ``ops.sdp4.sdp4_propagate``, of the unstaged elements."""
    _check_f64(tsince.device, fields, flags, sdp4)
    els, deep = f64_unstage(fields, flags)
    if sdp4:
        r, v, err, _ = sdp4_propagate(els, deep, tsince, grav)
    else:
        r, v, err = sgp4_propagate(els, tsince, grav)
    return r, v if want_vel else None, err


def _grid_2d(tsince, n_lanes):
    """``tsince`` as a (T, C) f64 grid and the (T, N) grid of the output,
    whose shape is ``broadcast_shapes(tsince.shape, (S,))``: C is S or 1,
    or S is 1 (one lane against any grid)."""
    out_shape = torch.broadcast_shapes(tsince.shape, (n_lanes,))
    t2 = tsince.reshape(1, -1) if tsince.dim() < 2 \
        else tsince.reshape(-1, tsince.shape[-1])
    return t2.contiguous(), out_shape, out_shape[-1] if out_shape else 1


def sgp4_f64_dense(tsince, fields, flags, *, grav: GravityModel,
                   sdp4: bool, want_vel: bool = True):
    """The f64 kernel's DENSE mode: SGP4/SDP4 in f64 at every point, one
    launch of the kernel's row walk over the lanes in slot order.

    Args:
      tsince: f64 minutes since each epoch, broadcasting against the S
        lanes as ``ops.sgp4.sgp4_propagate``'s ``tsince`` does: (T, S),
        (T, 1), (S,), a scalar, or any grid against one lane (S = 1, the
        API's time-as-lanes fold).
      fields, flags: :func:`f64_staging` of the elements (the deep rows
        included where ``sdp4``); the kernel walks the lanes in the
        flags' slot order.
      grav: the gravity model the elements were initialized with.
      sdp4: ``ops.sdp4.sdp4_propagate``'s semantics on every lane (a
        catalog with deep lanes), else ``ops.sgp4.sgp4_propagate``'s.
      want_vel: compute and return velocities.

    Returns ``(r, v, err)``: r and v stacked ``(..., 3)`` f64 TEME km and
    km/s (v None without velocities), err i32 python-sgp4 codes; failed
    points zero-filled. On a CPU tensor the plain version runs.
    """
    n_lanes = _check_f64(tsince.device, fields, flags, sdp4)
    dev = _device_of(tsince, "sgp4_f64_dense")
    if tsince.dtype != F64:
        raise ValueError(f"tsince: expected {F64}, got {tsince.dtype}")
    if dev.type == "cpu":
        return sgp4_f64_dense_reference(tsince, fields, flags, grav=grav,
                                        sdp4=sdp4, want_vel=want_vel)
    t2, out_shape, n_out = _grid_2d(tsince, n_lanes)
    n_times, n_cols = t2.shape
    if n_cols not in (1, n_out) or n_lanes not in (1, n_out):
        raise ValueError(f"tsince: {tuple(tsince.shape)} against {n_lanes} "
                         "lanes")
    r, v, err = _outputs_rows(dev, out_shape, want_vel, F64)
    if r.numel():
        with torch.cuda.device(dev):
            _launch_f64(
                "sgp4_f64_dense", "astroz_sgp4_f64_dense", t2.data_ptr(),
                n_cols, int(n_cols > 1), fields.data_ptr(), flags.data_ptr(),
                n_lanes, int(n_lanes > 1), n_times, n_out, int(sdp4),
                int(want_vel), *_f64_consts(grav), r.data_ptr(), _ptr(v),
                err.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return r, v, err


def _check_rows(jd, fr):
    if (jd.dtype != F64 or fr.dtype != F64 or jd.dim() != 1
            or fr.shape != jd.shape or fr.device != jd.device):
        raise ValueError("jd, fr: expected two (T,) f64 rows of one length "
                         f"on one device, got {jd.dtype} {tuple(jd.shape)} "
                         f"on {jd.device} and {fr.dtype} {tuple(fr.shape)} "
                         f"on {fr.device}")


def epoch_tsince(jd, fr, epoch_jd):
    """Minutes since each lane's epoch at a sweep's epochs: the (T, S)
    f64 grid ``((jd[t] - epoch_jd[s]) + fr[t]) * 1440`` of the (T,) rows
    ``jd``, ``fr`` (the python-sgp4 split) and the (S,) ``epoch_jd``. The
    subtraction runs at the magnitude of epoch differences (days), not of
    a JD. :func:`sgp4_f64_dense_epochs` forms each point so in the kernel,
    with these ops' roundings in this order."""
    return ((jd[:, None] - epoch_jd[None, :]) + fr[:, None]) \
        * MINUTES_PER_DAY


def sgp4_f64_dense_epochs(jd, fr, fields, flags, *, grav: GravityModel,
                          sdp4: bool, want_vel: bool = True):
    """The f64 kernel's DENSE mode on a sweep's epochs: every lane at the
    epochs ``jd + fr``, each point's minutes since its lane's epoch formed
    in the kernel's row walk from the rows, as :func:`epoch_tsince` forms
    the grid, so no (T, S) grid is written or read. The outputs are
    :func:`sgp4_f64_dense`'s on :func:`epoch_tsince`'s grid bit for bit.
    One launch, counted under ``"sgp4_f64_dense"`` and
    ``"sgp4_f64_dense_epochs"`` in :data:`LAUNCHES`.

    Args:
      jd, fr: (T,) f64 rows of one length, on the elements' device.
      fields, flags, grav, sdp4, want_vel: as :func:`sgp4_f64_dense`.

    Returns ``(r, v, err)``: (T, S, 3) f64, (T, S, 3) f64 or None, (T, S)
    i32. On a CPU tensor the plain version runs on
    :func:`epoch_tsince`'s grid.
    """
    n_lanes = _check_f64(jd.device, fields, flags, sdp4)
    dev = _device_of(jd, "sgp4_f64_dense_epochs")
    _check_rows(jd, fr)
    if dev.type == "cpu":
        epoch_jd = fields[F64_FIELD_NAMES.index("epoch_jd")]
        return sgp4_f64_dense_reference(epoch_tsince(jd, fr, epoch_jd),
                                        fields, flags, grav=grav, sdp4=sdp4,
                                        want_vel=want_vel)
    jd, fr = jd.contiguous(), fr.contiguous()
    n_times = jd.shape[0]
    r, v, err = _outputs_rows(dev, (n_times, n_lanes), want_vel, F64)
    if n_times:
        with torch.cuda.device(dev):
            _launch_f64(
                "sgp4_f64_dense", "astroz_sgp4_f64_dense_epochs",
                jd.data_ptr(), fr.data_ptr(), fields.data_ptr(),
                flags.data_ptr(), n_lanes, n_times, int(sdp4), int(want_vel),
                *_f64_consts(grav), r.data_ptr(), _ptr(v), err.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        LAUNCHES["sgp4_f64_dense_epochs"] += 1
    return r, v, err


def sgp4_f64_scan_reference(jd, fr, fields, flags, *, grav: GravityModel,
                            want_vel: bool = True):
    """Plain torch version of :func:`sgp4_f64_scan`, on any device:
    ``ops.sdp4.sdp4_propagate_scan`` of the unstaged elements on
    :func:`epoch_tsince`'s grid."""
    _check_f64(jd.device, fields, flags, True)
    _check_rows(jd, fr)
    els, deep = f64_unstage(fields, flags)
    r, v, err = sdp4_propagate_scan(
        els, deep, epoch_tsince(jd, fr, els.epoch_jd), grav)
    return r, v if want_vel else None, err


def sgp4_f64_scan(jd, fr, fields, flags, *, grav: GravityModel,
                  want_vel: bool = True):
    """``ops.sdp4.sdp4_propagate_scan`` at a sweep's epochs (sorted in one
    direction), on :func:`epoch_tsince`'s minutes since each lane's epoch.

    On the card this is one launch of DENSE in SDP4 mode on the rows
    (:func:`sgp4_f64_dense_epochs`), whose row walk carries the resonance
    along each thread's run of rows; as every row of the plain scan is
    ``sdp4_propagate`` at that row alone, it gives the plain scan's bits
    (``tests/test_torch_cuda.py``). On a CPU tensor the plain scan runs
    (:func:`sgp4_f64_scan_reference`): there torch's kernels round by
    tensor shape, and the plain dense differs from it in the last bits.

    Args:
      jd, fr: (T,) f64 rows of one length, on the elements' device.
      fields, flags: :func:`f64_staging` with the deep rows.
      grav, want_vel: as :func:`sgp4_f64_dense`.

    Returns ``(r, v, err)``: (T, S, 3) f64, (T, S, 3) f64 or None, (T, S)
    i32.
    """
    if _device_of(jd, "sgp4_f64_scan").type == "cpu":
        return sgp4_f64_scan_reference(jd, fr, fields, flags, grav=grav,
                                       want_vel=want_vel)
    return sgp4_f64_dense_epochs(jd, fr, fields, flags, grav=grav,
                                 sdp4=True, want_vel=want_vel)


def _check_escape(t_time, t_sat, fields, flags, idx, tables, d_r3, d_v3,
                  d_err, want_vel):
    n_esc = _check_f64(t_time.device, fields, flags, True)
    n_times = t_time.shape[0]
    if tables.dim() != 3 or tables.shape[1] < 2 or tables.shape[1] % 2:
        raise ValueError("tables: expected (5, 2 * (steps + 1), D), got "
                         f"{tuple(tables.shape)}")
    n_deep = tables.shape[2]
    expected = [(t_time, (n_times,), F64, "t_time"),
                (t_sat, (n_esc,), F64, "t_sat"),
                (idx, (n_esc,), I32, "idx"),
                (tables, (len(RESONANCE_TABLE_NAMES), tables.shape[1], n_deep),
                 F64, "tables"),
                (d_r3, (3, n_times, n_deep), F32, "d_r3"),
                (d_err, (n_times, n_deep), I32, "d_err")]
    if want_vel:
        if d_v3 is None:
            raise ValueError("d_v3: the deep velocity planes are needed "
                             "with want_vel=True")
        expected.append((d_v3, (3, n_times, n_deep), F32, "d_v3"))
    _check(t_time.device, expected)
    return n_times, n_esc, n_deep, tables.shape[1] // 2 - 1


def sgp4_f64_escape_reference(t_time, t_sat, fields, flags, idx, tables,
                              d_r3, d_v3, d_err, *, grav: GravityModel,
                              want_vel: bool = True):
    """Plain torch version of :func:`sgp4_f64_escape`, on any device:
    ``ops.fast.sdp4_propagate_tables`` of the unstaged escape lanes on
    their columns of ``tables``, cast to the planes' dtype and written
    into their columns ``idx``."""
    _check_escape(t_time, t_sat, fields, flags, idx, tables, d_r3, d_v3,
                  d_err, want_vel)
    els, deep = f64_unstage(fields, flags)
    cols = idx.long()
    ts = t_time[:, None] - t_sat[None, :]
    xr, xv, xe = sdp4_propagate_tables(els, deep, ts, grav,
                                       tables[:, :, cols])
    d_r3[:, :, cols] = xr.permute(2, 0, 1).to(d_r3.dtype)
    if want_vel:
        d_v3[:, :, cols] = xv.permute(2, 0, 1).to(d_v3.dtype)
    d_err[:, cols] = xe.to(d_err.dtype)


def sgp4_f64_escape(t_time, t_sat, fields, flags, idx, tables, d_r3, d_v3,
                    d_err, *, grav: GravityModel, want_vel: bool = True):
    """The f64 kernel's ESCAPE mode: the HEO escape lanes of a deep
    subset recomputed in full f64 (``ops.fast.sdp4_propagate_tables``)
    over ``t_time[t] - t_sat[x]``, cast to f32 and written in place into
    kernel K2's planes at the lanes' columns.

    Args:
      t_time: (T,) f64 minutes, on the same base as ``t_sat``.
      t_sat: (X,) f64 epochs of the escape lanes in minutes.
      fields, flags: :func:`f64_staging` of the escape lanes, deep rows
        included.
      idx: (X,) i32 column of each escape lane in the deep subset.
      tables: (5, 2 * (steps + 1), D) f64 resonance tables of the whole
        deep subset (:func:`resonance_tables`), read at ``idx``.
      d_r3, d_v3, d_err: K2's (3, T, D) f32 planes (d_v3 None without
        velocities) and (T, D) i32 codes, written in place.
      grav, want_vel: as :func:`sgp4_f64_dense`.
    """
    n_times, n_esc, n_deep, n_steps = _check_escape(
        t_time, t_sat, fields, flags, idx, tables, d_r3, d_v3, d_err,
        want_vel)
    dev = _device_of(t_time, "sgp4_f64_escape")
    if dev.type == "cpu":
        return sgp4_f64_escape_reference(
            t_time, t_sat, fields, flags, idx, tables, d_r3, d_v3, d_err,
            grav=grav, want_vel=want_vel)
    if n_times == 0:
        return None
    with torch.cuda.device(dev):
        _launch_f64(
            "sgp4_f64_escape", "astroz_sgp4_f64_escape", t_time.data_ptr(),
            t_sat.data_ptr(), fields.data_ptr(), flags.data_ptr(),
            idx.data_ptr(), tables.data_ptr(), n_times, n_esc, n_deep,
            n_steps, int(want_vel), *_f64_consts(grav), d_r3.data_ptr(),
            _ptr(d_v3) if want_vel else None, d_err.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    return None
