"""The output epilogue and the resonance tables against astroz_tpu, and
their wrappers on the CPU.

The epilogue (``ops/cuda_finalize.py``): seeded numpy sweep outputs of
37 times x 101 satellites, with a failed lane (zero-filled from row 20 on,
code 6, as the kernels write it), a masked lane and points on the pole
axis (x = y = 0), go through the JAX package's ``_finalize_planes`` (the
fast path's f32 (3, T, S) planes) and ``_finalize`` plus its layout code
(the f64 path's (T, S, 3)), then its satellite mask, and through
``finalize_reference``, for every output x layout x velocities x mask.
Tolerances: the f32 path those of ``tests/test_torch_propagation.py``
(``_assert_r_close``: 5e-3 km and 5e-6 km/s, geodetic angles 1e-6 rad,
altitude 0.02 km: the two libraries' f32 sin, cos and atan2 differ by an
ulp here and there, and ``alt = p / cos(lat) - N`` turns an ulp of
cos(lat) at a high latitude into metres: 7.8 m at 82.8 deg here). Those
were set for near-earth catalogs, so the radii are LEO's (6,600-8,300
km, ``chip_smoke.LEO_BAND_KM``); at 22,600 km the same ulp is 21 m. The
f64 path those of ``tests/test_torch_f64.py``
(``_assert_output_close``: 2e-7 km TEME, 6e-6 km and 1e-9 km/s after the
rotation, geodetic angles 1e-9 rad); error codes identical. The wrapper's
CPU route equals ``finalize_reference`` bit for bit, returns the sweep's
own tensors in the identity cases and counts no launch.

The resonance tables (``ops/cuda_sgp4.py:resonance_tables``, the TABLES
kernel): the wrapper's CPU route equals ``resonance_tables_reference`` bit
for bit; ``tests/test_torch_deep.py::test_resonance_tables_match_jax``
holds those to JAX. The kernels' enums are the wrappers' names in order,
and ``propagate``, the mesh sweep and ``ops.propagate_fast`` reach both
wrappers on the main path. ``tests/test_torch_cuda.py`` holds both kernels
to their plain versions bit for bit on the card.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astroz_tpu import propagation as jprop
import astroz_tpu_torch as P
from astroz_tpu_torch.ops import cuda_finalize, cuda_sgp4, fast
from astroz_tpu_torch.ops.cuda_finalize import (LAYOUTS, OUTPUT_MODES,
                                                finalize, finalize_reference)
from astroz_tpu_torch.ops.sdp4 import DeepElements
from astroz_tpu_torch.ops.sgp4 import Sgp4Elements

from test_torch_cuda import synthetic_deep_text, synthetic_leo_text
from test_torch_f64 import FIXED_VEL_TOL_KMS, _assert_output_close
from test_torch_f64 import VEL_TOL_KMS as F64_VEL_TOL_KMS
from test_torch_propagation import VEL_TOL_KMS, _assert_r_close

torch.set_num_threads(1)

CSRC = Path(cuda_sgp4.__file__).resolve().parents[1] / "csrc"
N_TIMES, N_SATS = 37, 101
#: a lane that fails at row 20 (zero-filled, code 6) and a masked lane
FAILED, MASKED = 7, 42
#: (row, lane) points on the pole axis: x = y = 0, z north and south
POLES = ((5, 11), (9, 12))
JD_SUM = (2460310.5 + np.linspace(-1.0, 2.0, N_TIMES))[:, None]


@pytest.fixture(scope="module")
def sweep():
    """Time-major (T, S, 3) f64 r, v (directions uniform on the sphere,
    LEO radii), (T, S) codes and the (S,) mask."""
    rng = np.random.default_rng(17)
    u = rng.normal(size=(N_TIMES, N_SATS, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    r = u * rng.uniform(6600.0, 8300.0, (N_TIMES, N_SATS, 1))
    v = rng.normal(size=(N_TIMES, N_SATS, 3)) * 4.0
    err = np.zeros((N_TIMES, N_SATS), np.int32)
    r[20:, FAILED] = v[20:, FAILED] = 0.0
    err[20:, FAILED] = 6
    for (t, s), z in zip(POLES, (7000.0, -6800.0)):
        r[t, s] = (0.0, 0.0, z)
    mask = np.ones(N_SATS, bool)
    mask[MASKED] = False
    return r, v, err, mask


def _inputs(sweep, source):
    """The sweep's outputs as the fast path (f32 planes) or the f64 path
    (f64 time-major) hands them to the epilogue."""
    r, v, err, mask = sweep
    if source == "planes":
        r, v = (np.ascontiguousarray(x.transpose(2, 0, 1), np.float32)
                for x in (r, v))
    return r, v, err, mask


def _jax_epilogue(r, v, err, output, velocities, layout, mask, source):
    """The JAX package's epilogue: its _finalize_planes, or its _finalize
    and the f64 path's layouts, then propagate's satellite mask."""
    r, v, err = jnp.asarray(r), jnp.asarray(v), jnp.asarray(err)
    jd_sum = jnp.asarray(JD_SUM)
    if source == "planes":
        r, v, err = jprop._finalize_planes(r, v, err, jd_sum, output,
                                           velocities, layout)
    else:
        r, v, err = jprop._finalize(r, v, err, jd_sum, output, velocities)
        if layout == "sat_major":
            r = jnp.swapaxes(r, 0, 1)
            v = None if v is None else jnp.swapaxes(v, 0, 1)
            err = jnp.swapaxes(err, 0, 1)
        elif layout == "planes":
            r = jnp.moveaxis(r, -1, 0)
            v = None if v is None else jnp.moveaxis(v, -1, 0)
    if mask is not None:
        m = jnp.asarray(mask, bool)
        me = m[:, None] if layout == "sat_major" else m[None, :]
        mr = m[None, None, :] if layout == "planes" else me[..., None]
        r = jnp.where(mr, r, 0.0)
        v = None if v is None else jnp.where(mr, v, 0.0)
        err = jnp.where(me, err, -1)
    return r, v, err


def _torch_args(r, v, err, velocities, mask, masked):
    return ((torch.from_numpy(r), torch.from_numpy(v) if velocities else None,
             torch.from_numpy(err), torch.from_numpy(JD_SUM)),
            torch.from_numpy(mask) if masked else None)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("velocities", [True, False])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("output", OUTPUT_MODES)
@pytest.mark.parametrize("source", ["planes", "time_major"])
def test_finalize_reference_matches_jax(sweep, source, output, layout,
                                        velocities, masked):
    r, v, err, mask = _inputs(sweep, source)
    args, m = _torch_args(r, v, err, velocities, mask, masked)
    kw = dict(source=source, output=output, layout=layout,
              velocities=velocities)
    rp, vp, ep = finalize_reference(*args, mask=m, **kw)
    rj, vj, ej = _jax_epilogue(r, v, err, output, velocities, layout,
                               mask if masked else None, source)
    assert tuple(rp.shape) == tuple(rj.shape) and rp.dtype == args[0].dtype
    assert rp.is_contiguous() and ep.is_contiguous()
    np.testing.assert_array_equal(np.asarray(ej), ep.numpy())
    if source == "planes":
        _assert_r_close(rj, rp, output, layout)
        vel_tol = VEL_TOL_KMS
    else:
        _assert_output_close(rj, rp, output, layout)
        vel_tol = F64_VEL_TOL_KMS if output == "teme" else FIXED_VEL_TOL_KMS
    assert (vp is None) == (vj is None) == (not velocities)
    if velocities:
        assert np.abs(np.asarray(vj) - vp.numpy()).max() <= vel_tol
    # the masked lane's outputs are zeros with code -1, the failed lane
    # keeps its code (on the pole axis the latitude iteration divides by
    # n + alt ~ 0 and may end anywhere: both packages end alike there)
    sat_axis = 0 if layout == "sat_major" else 1
    e = ep.numpy()
    if masked:
        assert (np.take(e, MASKED, sat_axis) == -1).all()
        assert not np.take(rp.numpy(), MASKED,
                           -1 if layout == "planes" else sat_axis).any()
    assert (np.take(e, FAILED, sat_axis)[20:] == 6).all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("velocities", [True, False])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("output", OUTPUT_MODES)
@pytest.mark.parametrize("source", ["planes", "time_major"])
def test_finalize_on_cpu_is_the_plain_version(sweep, source, output, layout,
                                              velocities, masked):
    """On CPU tensors the wrapper is finalize_reference bit for bit and
    launches nothing; the identity cases return the sweep's tensors."""
    r, v, err, mask = _inputs(sweep, source)
    args, m = _torch_args(r, v, err, velocities, mask, masked)
    kw = dict(source=source, output=output, layout=layout,
              velocities=velocities, mask=m)
    before = dict(cuda_finalize.LAUNCHES)
    got = finalize(*args, **kw)
    want = finalize_reference(*args, **kw)
    assert cuda_finalize.LAUNCHES == before
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
    if cuda_finalize.is_identity(source, output, layout, m):
        assert got[0] is args[0] and got[2] is args[2]
        assert got[1] is (args[1] if velocities else None)


def test_finalize_checks_its_arguments(sweep):
    r, v, err, _ = _inputs(sweep, "planes")
    args = (torch.from_numpy(r), torch.from_numpy(v), torch.from_numpy(err),
            torch.from_numpy(JD_SUM))
    kw = dict(source="planes", output="ecef", layout="planes",
              velocities=True)
    with pytest.raises(ValueError, match="source"):
        finalize(*args, **{**kw, "source": "sat_major"})
    with pytest.raises(ValueError, match="output"):
        finalize(*args, **{**kw, "output": "lla"})
    with pytest.raises(ValueError, match="layout"):
        finalize(*args, **{**kw, "layout": "rows"})
    meta = [x.to("meta") for x in args]
    with pytest.raises(ValueError, match="no kernel for device"):
        finalize(*meta, **kw)


def test_kernel_enums_are_the_wrappers_names():
    """``csrc/finalize.cu`` numbers sources, layouts and frames as
    ``ops/cuda_finalize.py`` orders them, and ``csrc/sgp4_deep.cu``'s
    TABLES reads the rows of RESONANCE_FIELD_NAMES and the shifts of
    RESONANCE_SHIFTS in order."""
    src = (CSRC / "finalize.cu").read_text()

    def enum(text, name, prefix=""):
        body = re.search(rf"enum {name} \{{(.*?)\}}", text, re.S).group(1)
        return [n.split("=")[0].strip().lower().removeprefix(prefix)
                for n in body.split(",") if n.strip()]

    assert enum(src, "Source") == ["from_planes", "from_time_major"]
    assert [n.removeprefix("from_") for n in enum(src, "Source")] \
        == list(cuda_finalize.SOURCES)
    assert enum(src, "Layout") == list(LAYOUTS)
    assert enum(src, "Frame") == list(OUTPUT_MODES)
    deep = (CSRC / "sgp4_deep.cu").read_text()
    fields = enum(deep, "ResonanceField", "rf_")
    assert fields == list(cuda_sgp4.RESONANCE_FIELD_NAMES) \
        + ["n_resonance_fields"]
    shifts = enum(deep, "Shift", "sh_")
    assert shifts == ["fasx2", "fasx4", "fasx6", "g22", "g32", "g44", "g52",
                      "g54", "n_shifts"]
    from astroz_tpu_torch.ops import sdp4
    assert cuda_sgp4.RESONANCE_SHIFTS == (
        sdp4.FASX2, 2.0 * sdp4.FASX4, 3.0 * sdp4.FASX6, sdp4.G22, sdp4.G32,
        sdp4.G44, sdp4.G52, sdp4.G54)


@pytest.fixture(scope="module")
def mixed():
    return P.build_catalog(synthetic_leo_text(16) + "\n"
                           + synthetic_deep_text(12), device="cpu")


def test_resonance_fields_are_the_named_elements(mixed):
    fields = cuda_sgp4._resonance_fields(mixed.deep_sub, mixed.els_deep)
    assert fields.dtype == torch.float64
    assert fields.shape == (len(cuda_sgp4.RESONANCE_FIELD_NAMES),
                            mixed.n_deep)
    for row, name in zip(fields, cuda_sgp4.RESONANCE_FIELD_NAMES):
        src = (mixed.els_deep if name in Sgp4Elements._fields
               else mixed.deep_sub)
        assert name in Sgp4Elements._fields + DeepElements._fields
        assert torch.equal(row, getattr(src, name).to(torch.float64)), name


@pytest.mark.parametrize("steps", [4, 8])
def test_resonance_tables_on_cpu_are_the_plain_version(mixed, steps):
    before = dict(cuda_sgp4.LAUNCHES)
    got = cuda_sgp4.resonance_tables(mixed.deep_sub, mixed.els_deep, steps)
    assert cuda_sgp4.LAUNCHES == before
    want = fast.resonance_tables_reference(mixed.deep_sub, mixed.els_deep,
                                           steps)
    assert got.shape == (5, 2 * (steps + 1), mixed.n_deep)
    assert torch.equal(got, want)
    assert torch.equal(mixed.resonance_tables(steps), want)


def test_main_path_runs_the_epilogue_and_tables_wrappers(mixed, monkeypatch):
    """propagate reaches the epilogue's wrapper once a call (the fast path
    with the planes, the f64 path time-major, the mask passed in) and the
    tables' wrapper once per catalog and depth; so do the mesh's fast
    sweep and the mixed ``ops.propagate_fast``."""
    from astroz_tpu_torch.parallel import make_mesh, mesh as pmesh
    from astroz_tpu_torch.parallel import propagate_sharded_fast

    seen, depths = [], []
    real_fin, real_tab = finalize, cuda_sgp4.resonance_tables

    def fin(*args, **kw):
        seen.append((kw["source"], kw["output"], kw["layout"],
                     kw["mask"] is not None if "mask" in kw else False))
        return real_fin(*args, **kw)

    def tab(deep, els, steps):
        depths.append(steps)
        return real_tab(deep, els, steps)

    monkeypatch.setattr(P.propagation, "finalize", fin)
    monkeypatch.setattr(pmesh, "finalize", fin)
    monkeypatch.setattr(P.propagation, "resonance_tables", tab)
    monkeypatch.setattr(cuda_sgp4, "resonance_tables", tab)
    cat = P.build_catalog(synthetic_leo_text(16) + "\n"
                          + synthetic_deep_text(12), device="cpu")
    jd = cat.epoch_min_jd + np.linspace(0.0, 1.0, 5)
    mask = np.arange(len(cat)) % 3 != 0
    P.propagate(cat, jd, method="fast", layout="planes")
    P.propagate(cat, jd, method="fast", output="ecef",
                satellite_mask=mask)
    P.propagate(cat, jd, method="f64", layout="sat_major")
    assert seen == [("planes", "teme", "planes", False),
                    ("planes", "ecef", "time_major", True),
                    ("time_major", "teme", "sat_major", False)]
    assert len(depths) == 1
    seen.clear()
    propagate_sharded_fast(cat, jd, mesh=make_mesh(["cpu"] * 2),
                           output="geodetic", layout="sat_major")
    assert seen == [("planes", "geodetic", "sat_major", False)] * 2
    assert len(depths) == 1  # the shards take the catalog's tables
    P.ops.propagate_fast(cat.els, cat.deep,
                         torch.zeros((3, 1), dtype=torch.float64), cat.grav,
                         resonance_steps=4)
    assert depths[1:] == [4]
