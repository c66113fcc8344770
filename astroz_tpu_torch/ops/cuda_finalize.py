"""The output epilogue of a catalog sweep: the epilogue kernel and its
plain version.

Not a TPU kernel. The JAX package traces its epilogue into the jitted
sweeps, where XLA fuses it with the layout change: the GMST rotation to
ECEF, the geodetic conversion, the ``time_major`` / ``sat_major`` /
``planes`` layouts and the satellite mask (``astroz_tpu/propagation.py:773``
``_finalize_planes`` on the fast path's (3, T, S) planes, ``:752``
``_finalize`` on the f64 path's time-major (T, S, 3) outputs).
:func:`finalize_reference` is that epilogue in plain torch;
:func:`finalize` launches the epilogue kernel (``csrc/finalize.cu``),
which reads the sweep's outputs once and writes the caller's frame and
layout once. On a CUDA tensor :func:`finalize` launches the kernel or
raises, and adds one to its entry of :data:`LAUNCHES`, except in the
identity cases (``teme`` in the sweep's own layout, no mask), where it
returns the sweep's tensors and launches nothing; on a CPU tensor it runs
:func:`finalize_reference`.
"""

from __future__ import annotations

import torch

from .. import _build
from ..constants import RAD2DEG, WGS84, WGS84_ECC_SQ
from ..frames import ecef_to_geodetic, ecef_to_geodetic_xyz, teme_to_ecef
from ..time import gstime
from .cuda_sgp4 import _ptr

#: output frame names
OUTPUT_MODES = ("teme", "ecef", "geodetic", "geodetic_deg")
#: ``time_major`` -> (T, S, 3), ``sat_major`` -> (S, T, 3), ``planes`` ->
#: (3, T, S), the fast path's kernels' own layout
LAYOUTS = ("time_major", "sat_major", "planes")
#: what a sweep hands the epilogue: the fast path's (3, T, S) planes, or
#: the f64 path's (T, S, 3) time-major outputs
SOURCES = ("planes", "time_major")

#: kernel launches so far in this process, by the kernel's type; each
#: launch adds one to its entry
LAUNCHES = {"finalize_f32": 0, "finalize_f64": 0}

_KERNELS = {torch.float32: "finalize_f32", torch.float64: "finalize_f64"}


def _finalize_planes(r3, v3, err, jd_sum, output: str, want_vel: bool,
                     layout: str):
    """Frame conversion and layout assembly on the kernel's (3, T, S)
    planes; ``jd_sum`` is (T, 1) f64. GMST is computed in f64 and cast
    to the planes' dtype."""
    if output != "teme":
        x, y, z = r3[0], r3[1], r3[2]
        gmst = gstime(jd_sum).to(x.dtype)
        sg, cg = torch.sin(gmst), torch.cos(gmst)
        x, y = cg * x + sg * y, -sg * x + cg * y
        if want_vel:
            vx, vy, vz = v3[0], v3[1], v3[2]
            v3 = torch.stack([cg * vx + sg * vy, -sg * vx + cg * vy, vz])
        if output in ("geodetic", "geodetic_deg"):
            lat, lon, alt = ecef_to_geodetic_xyz(x, y, z)
            if output == "geodetic_deg":
                lat, lon = lat * RAD2DEG, lon * RAD2DEG
            x, y, z = lat, lon, alt
        r3 = torch.stack([x, y, z])
    if layout == "planes":
        return r3, v3 if want_vel else None, err
    if layout == "sat_major":
        r = r3.permute(2, 1, 0).contiguous()
        v = v3.permute(2, 1, 0).contiguous() if want_vel else None
        return r, v, err.T.contiguous()
    r = r3.permute(1, 2, 0).contiguous()
    v = v3.permute(1, 2, 0).contiguous() if want_vel else None
    return r, v, err


def _finalize(r, v, err, jd_sum, output: str, want_vel: bool):
    """Frame conversion of the f64 path's time-major stacked ``(T, S, 3)``
    outputs; ``jd_sum`` is (T, 1) f64."""
    if output != "teme":
        gmst = gstime(jd_sum).to(r.dtype)
        r = teme_to_ecef(r, gmst)
        if want_vel:
            v = teme_to_ecef(v, gmst)
        if output in ("geodetic", "geodetic_deg"):
            r = ecef_to_geodetic(r)
            if output == "geodetic_deg":
                r = torch.stack([r[..., 0] * RAD2DEG, r[..., 1] * RAD2DEG,
                                 r[..., 2]], dim=-1)
    return r, v if want_vel else None, err


def finalize_reference(r, v, err, jd_sum, *, source: str, output: str,
                       layout: str, velocities: bool, mask=None):
    """The epilogue in plain torch, on any device: the same arguments and
    returns as :func:`finalize`."""
    _check_names(source, output, layout)
    if source == "planes":
        r, v, err = _finalize_planes(r, v, err, jd_sum, output, velocities,
                                     layout)
    else:
        r, v, err = _finalize(r, v, err, jd_sum, output, velocities)
        # time-major stacked outputs; the other layouts are relaid here
        if layout == "sat_major":
            r = r.transpose(0, 1).contiguous()
            v = None if v is None else v.transpose(0, 1).contiguous()
            err = err.T.contiguous()
        elif layout == "planes":
            r = r.permute(2, 0, 1).contiguous()
            v = None if v is None else v.permute(2, 0, 1).contiguous()
    if mask is not None:
        # the satellite axis is axis 1 of err for time_major/planes and
        # axis 0 for sat_major
        me = mask[:, None] if layout == "sat_major" else mask[None, :]
        mr = mask[None, None, :] if layout == "planes" else me[..., None]
        r = torch.where(mr, r, 0.0)
        if v is not None:
            v = torch.where(mr, v, 0.0)
        err = torch.where(me, err, -1)
    return r, v, err


def _check_names(source, output, layout):
    if source not in SOURCES:
        raise ValueError(f"source must be one of {SOURCES}")
    if output not in OUTPUT_MODES:
        raise ValueError(f"output must be one of {OUTPUT_MODES}")
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}")


def is_identity(source: str, output: str, layout: str, mask) -> bool:
    """Whether the epilogue returns the sweep's own tensors: TEME in the
    sweep's layout, no mask."""
    own = "planes" if source == "planes" else "time_major"
    return output == "teme" and layout == own and mask is None


def _check(r, v, err, jd_sum, source, mask):
    """Raise unless the sweep's outputs have the shapes, types, device and
    contiguity the kernel takes; returns ``(n_times, n_sats)``."""
    if err.dim() != 2 or err.dtype != torch.int32:
        raise ValueError(f"err: expected int32 (T, S), got {err.dtype} "
                         f"{tuple(err.shape)}")
    n_times, n_sats = err.shape
    shape = ((3, n_times, n_sats) if source == "planes"
             else (n_times, n_sats, 3))
    if r.dtype not in _KERNELS:
        raise ValueError(f"r: no epilogue kernel for {r.dtype}")
    expected = [(r, shape, r.dtype, "r"), (err, (n_times, n_sats),
                                          torch.int32, "err"),
                (jd_sum, (n_times, 1), torch.float64, "jd_sum")]
    if v is not None:
        expected.append((v, shape, r.dtype, "v"))
    if mask is not None:
        expected.append((mask, (n_sats,), torch.bool, "mask"))
    for x, want, dtype, name in expected:
        if tuple(x.shape) != want or x.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {want}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != err.device:
            raise ValueError(f"{name} is on {x.device}, err on {err.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n_times, n_sats


def finalize(r, v, err, jd_sum, *, source: str, output: str, layout: str,
             velocities: bool, mask=None):
    """The epilogue kernel: a sweep's outputs in the caller's frame and
    layout, masked satellites zero-filled with code -1.

    Args:
      r, v: the sweep's positions and velocities (v None without
        velocities): (3, T, S) planes with ``source="planes"`` (the fast
        path, f32), (T, S, 3) with ``source="time_major"`` (the f64 path).
      err: (T, S) int32 codes.
      jd_sum: (T, 1) f64 Julian dates of the rows (GMST's argument).
      output: one of :data:`OUTPUT_MODES`; geodetic puts lat, lon (rad or
        deg) and alt (km) in place of x, y, z, and v stays ECEF.
      layout: one of :data:`LAYOUTS`.
      velocities: with False, v is None in and out.
      mask: optional (S,) bool tensor; False lanes come back zero-filled
        with code -1.

    Returns ``(r, v, err)``: the sweep's own tensors in the identity cases
    (:func:`is_identity`), fresh ones otherwise (err only where the layout
    or the mask changes it).
    """
    _check_names(source, output, layout)
    dev = err.device
    if dev.type == "cpu":
        return finalize_reference(r, v, err, jd_sum, source=source,
                                  output=output, layout=layout,
                                  velocities=velocities, mask=mask)
    if dev.type != "cuda":
        raise ValueError(f"finalize: no kernel for device {dev}")
    if not velocities:
        v = None
    elif v is None:
        raise ValueError("finalize: velocities=True without v")
    n_times, n_sats = _check(r, v, err, jd_sum, source, mask)
    if is_identity(source, output, layout, mask):
        return r, v, err
    out_shape = {"time_major": (n_times, n_sats, 3),
                 "sat_major": (n_sats, n_times, 3),
                 "planes": (3, n_times, n_sats)}[layout]
    r_out = torch.empty(out_shape, dtype=r.dtype, device=dev)
    v_out = None if v is None else torch.empty_like(r_out)
    err_out = None
    if layout == "sat_major":
        err_out = torch.empty((n_sats, n_times), dtype=torch.int32,
                              device=dev)
    elif mask is not None:
        err_out = torch.empty_like(err)
    if n_times == 0 or n_sats == 0:
        return r_out, v_out, err if err_out is None else err_out
    sg = cg = None
    if output != "teme":
        # the (T,) rows of the plain version's sin and cos of GMST
        gmst = gstime(jd_sum).to(r.dtype)
        sg, cg = torch.sin(gmst).reshape(-1), torch.cos(gmst).reshape(-1)
    kernel = _KERNELS[r.dtype]
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = getattr(lib, "astroz_" + kernel)(
            r.data_ptr(), _ptr(v), err.data_ptr(), _ptr(sg), _ptr(cg),
            _ptr(mask), n_times, n_sats, SOURCES.index(source),
            LAYOUTS.index(layout), OUTPUT_MODES.index(output),
            r_out.data_ptr(), _ptr(v_out), _ptr(err_out),
            WGS84.radius_earth_km, WGS84_ECC_SQ, RAD2DEG,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")
    LAUNCHES[kernel] += 1
    return r_out, v_out, err if err_out is None else err_out
