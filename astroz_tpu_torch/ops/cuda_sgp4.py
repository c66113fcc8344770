"""The CUDA propagation kernels K1, K2 and K3 and their plain versions.

* K1, :func:`propagate_fast_sep`, replaces the TPU kernel
  ``astroz_tpu/ops/pallas_sgp4.py:_kernel_fused_sep`` (wrapper
  ``propagate_fast_pallas_sep``): near-earth satellites.
* K2, :func:`propagate_deep_sep`, replaces ``_kernel_deep`` (wrapper
  ``propagate_deep_pallas``): the deep-space subset of a catalog.
* K3, :func:`propagate_fast_sep_merge`, replaces
  ``_kernel_fused_sep_merge`` (wrapper ``propagate_fast_pallas_sep_merge``):
  K1 over a mixed catalog, its deep columns taken from K2's planes.

Each propagates over the separable grid ``tsince[t, n] = t_time[t] -
t_sat[n]`` minutes and returns the grouped planes ``r (3, T, N)`` f32,
``v (3, T, N)`` f32 (``None`` with ``want_vel=False``) and ``err (T, N)``
i32. The kernels are ``csrc/sgp4_shallow.cu`` (K1, K3) and
``csrc/sgp4_deep.cu`` (K2); their source notes say what bounds them on
Hopper and what the design does about that.

On a CUDA tensor a wrapper launches its kernel or raises, and adds one
to its entry of :data:`LAUNCHES`. On a CPU tensor it runs its
``*_reference`` function, the same function in plain torch
(``ops/fast.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..constants import GravityModel
from .fast import (DEEP_FIELD_NAMES, DEEP_SPINE_FIELD_NAMES,
                   RESONANCE_TABLE_NAMES, SPINE_FIELD_NAMES,
                   TAIL_FIELD_NAMES, deep_spine_f64, deep_tail_f32,
                   shallow_tail_f32, spine_f64)

#: Newton trip counts K1 and K3 are built for (SatCatalog.kepler_iters)
KEPLER_ITERS = (3, 4, 5, 8)
#: Newton trip counts K2 is built for (SatCatalog.deep_kepler_iters)
DEEP_KEPLER_ITERS = (6, 8)

#: kernel launches so far in this process, by kernel; each launch adds
#: one to its kernel's entry
LAUNCHES = {"sgp4_shallow": 0, "sgp4_deep": 0, "sgp4_shallow_merge": 0}

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


def _outputs(dev, n_times, n, want_vel):
    r = torch.empty((3, n_times, n), dtype=F32, device=dev)
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


def propagate_fast_sep_reference(t_time, t_sat, spine, tail, flags, *,
                                 grav: GravityModel, kepler_iters: int,
                                 want_vel: bool = True):
    """Plain torch version of K1, on any device: the same arguments and
    returns as :func:`propagate_fast_sep`."""
    _check_sep(t_time, t_sat, spine, tail, flags)
    tsince = t_time[:, None] - t_sat[None, :]
    fields = dict(zip(TAIL_FIELD_NAMES, tail))
    fields["not_simp"] = flags[0] == 0
    fields["error0"] = flags[1]
    out = shallow_tail_f32(grav, kepler_iters,
                           *spine_f64(tsince,
                                      **dict(zip(SPINE_FIELD_NAMES, spine))),
                           want_vel=want_vel, **fields)
    r3 = torch.stack(out[0:3])
    v3 = torch.stack(out[3:6]) if want_vel else None
    return r3, v3, out[-1]


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
    dev = _device_of(t_time, "propagate_fast_sep")
    if dev.type == "cpu":
        return propagate_fast_sep_reference(
            t_time, t_sat, spine, tail, flags, grav=grav,
            kepler_iters=kepler_iters, want_vel=want_vel)
    if kepler_iters not in KEPLER_ITERS:
        raise ValueError(f"kepler_iters must be one of {KEPLER_ITERS}, "
                         f"got {kepler_iters}")
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
    out = deep_tail_f32(
        grav, kepler_iters,
        *deep_spine_f64(tsince, tables, irez=flags[0],
                        **dict(zip(DEEP_SPINE_FIELD_NAMES, spine))),
        want_vel=want_vel, **fields)
    r3 = torch.stack(out[0:3])
    v3 = torch.stack(out[3:6]) if want_vel else None
    return r3, v3, out[-1]


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


def propagate_fast_sep_merge(t_time, t_sat, spine, tail, flags, deep_slot,
                             dr, dv, de, *, grav: GravityModel,
                             kepler_iters: int, want_vel: bool = True):
    """K3: K1 over a mixed catalog, whose deep columns are copied from
    K2's planes instead of propagated.

    Args:
      t_time, t_sat, spine, tail, flags, grav, kepler_iters, want_vel:
        as :func:`propagate_fast_sep`, over all S satellites.
      deep_slot: (S,) i32, -1 on near-earth columns, else the column's
        index in the deep subset.
      dr, dv, de: K2's planes over the D >= 1 deep satellites: (3, T, D)
        f32, (3, T, D) f32 (may be None without velocities), (T, D) i32.

    Returns ``(r, v, err)`` as :func:`propagate_fast_sep`.
    """
    n_times, n_sats, n_deep = _check_merge(t_time, t_sat, spine, tail,
                                           flags, deep_slot, dr, dv, de,
                                           want_vel)
    dev = _device_of(t_time, "propagate_fast_sep_merge")
    if dev.type == "cpu":
        return propagate_fast_sep_merge_reference(
            t_time, t_sat, spine, tail, flags, deep_slot, dr, dv, de,
            grav=grav, kepler_iters=kepler_iters, want_vel=want_vel)
    if kepler_iters not in KEPLER_ITERS:
        raise ValueError(f"kepler_iters must be one of {KEPLER_ITERS}, "
                         f"got {kepler_iters}")
    r, v, err = _outputs(dev, n_times, n_sats, want_vel)
    if n_times == 0:
        return r, v, err
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.astroz_sgp4_shallow_merge(
            t_time.data_ptr(), t_sat.data_ptr(), spine.data_ptr(),
            tail.data_ptr(), flags.data_ptr(), n_times, n_sats,
            kepler_iters, int(want_vel), *_grav_args(grav),
            deep_slot.data_ptr(), dr.data_ptr(),
            _ptr(dv) if want_vel else None, de.data_ptr(), n_deep,
            r.data_ptr(), _ptr(v), err.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "sgp4_shallow_merge")
    return r, v, err
