"""Multi-device propagation and screening in astroz_tpu_torch
(``parallel``, ``screen_all(mesh=)``, ``screen_all_ring``) against the
port's single-device paths and against astroz_tpu on the same inputs.

Every port mesh is ``[torch.device("cpu")] * 8``: one process drives
eight shards on the CPU, the counterpart of the JAX package's eight
virtual host devices (``tests/conftest.py``), on which the JAX side runs.

Tolerances, each with its reason:

* Sharded fast sweep against the port's single-device fast sweep: bit
  for bit (r, v and codes; every layout, without velocities, ECEF). Each
  shard gets the whole catalog's constants, its deep lanes' columns of
  the whole catalog's resonance tables and the HEO escape, so each point
  is computed as in the single-device sweep.
* Sharded f64 against the port's single-device f64: 1e-9 km and 1e-12
  km/s (measured 3.6e-12 km): torch's vectorized f64 sin and cos on the
  CPU round some last bits by a lane's position in its vector, which a
  shard's width moves (on the card each point runs the same code, and
  ``chip_smoke.py`` phase 11b holds it bit for bit). Codes equal.
* Sharded f64 against JAX's ``propagate_sharded``: the f64 parity gate of
  ``tests/test_torch_f64.py`` (2e-7 km, 3e-10 km/s TEME; 6e-6 km ECEF),
  codes equal.
* Sharded fast against JAX's ``propagate_sharded_fast(engine="xla")``:
  0.05 km (``tests/test_parallel.py``'s gate) and 5e-5 km/s, codes equal,
  on the lanes JAX computes as its single-device path does: it skips the
  HEO escape when sharded, so the escape lanes are left out; its drag
  term is fed the cosine (``jax_drag_fixed``, ROADMAP §3).
* Screens: the pairs and epochs of the mesh screens equal the port's
  ``screen_all`` (distances bit for bit: the same planes, the same
  refine) and JAX's ``screen_all_ring`` (distances within the shell gate
  of ``tests/test_torch_screening.py``, 0.01 km; on the mixed catalog
  the f64 method, 1e-3 km).
"""

import numpy as np
import pytest
import torch

import astroz_tpu as J
import astroz_tpu.parallel.mesh as jmesh
from astroz_tpu.parallel import make_mesh as j_make_mesh
from astroz_tpu.parallel import pad_catalog as j_pad_catalog
from astroz_tpu.parallel import propagate_sharded as j_propagate_sharded
from astroz_tpu.parallel import (propagate_sharded_fast as
                                 j_propagate_sharded_fast)
from astroz_tpu.screening import screen_all_ring as j_screen_all_ring

import astroz_tpu_torch as P
from astroz_tpu_torch.ops import cuda_screen
from astroz_tpu_torch.parallel import (make_mesh, pad_catalog,
                                       propagate_sharded,
                                       propagate_sharded_fast, shard_catalog,
                                       stage_sharded_fast)
from astroz_tpu_torch.screening import screen_all_ring

import test_escape
from test_propagation import MIXED_TEXT
from test_screening import synthetic_leo_text
from test_sgp4 import TRAJ_L1, TRAJ_L2
from test_torch_fast import jax_drag_fixed  # noqa: F401  (fixture)
from test_torch_screening import _fma_f32, _planes

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
#: the mixed catalog with spread epochs and half-day escape lanes (45
#: lanes, not a multiple of 8), and minutes from its earliest epoch
ESCAPE_TEXT = "\n".join([test_escape.MIXED_TEXT] * 9)
T_MIN = np.linspace(-250.0, 2000.0, 7)  # 7 epochs: the time axis pads

F64_POS_KM, F64_VEL_KMS, F64_ECEF_KM = 2e-7, 3e-10, 6e-6
FAST_POS_KM, FAST_VEL_KMS = 0.05, 5e-5
SHELL_D_TOL_KM = 0.01
MIXED_F64_D_TOL_KM = 1e-3
GEODETIC_RTOL = 4e-6


@pytest.fixture(scope="module")
def escape_cats():
    pcat = P.build_catalog(ESCAPE_TEXT, device="cpu")
    jcat = J.build_catalog(ESCAPE_TEXT)
    jd = pcat.epoch_min_jd + T_MIN / 1440.0
    return pcat, jcat, jd


@pytest.fixture(scope="module")
def shell():
    text = synthetic_leo_text(96)
    pcat = P.build_catalog(text, device="cpu")
    times = pcat.epochs_jd[0] + np.linspace(0.0, 0.25, 90)
    return pcat, times


def _np(x):
    return None if x is None else np.asarray(x, np.float64)


# ---------------------------------------------------------------------------
# make_mesh, pad_catalog, shard_catalog
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{"time_parallel": 3},
                                {"sat_parallel": 0},
                                {"sat_parallel": 3, "time_parallel": 2}])
def test_make_mesh_errors_match_jax(kw):
    with pytest.raises(ValueError) as jerr:
        j_make_mesh(**kw)
    with pytest.raises(ValueError) as perr:
        make_mesh(CPU8, **kw)
    assert str(perr.value) == str(jerr.value)


def test_make_mesh_shape_and_no_card(monkeypatch):
    mesh = make_mesh(CPU8, time_parallel=2)
    jmesh_ = j_make_mesh(time_parallel=2)
    assert mesh.shape == dict(jmesh_.shape)
    assert mesh.axis_names == tuple(jmesh_.axis_names)
    assert mesh.devices.shape == (2, 4) and mesh.devices.size == 8
    assert all(d == torch.device("cpu") for d in mesh.devices.reshape(-1))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_pad_catalog_matches_jax():
    pcat = P.build_catalog(MIXED_TEXT, device="cpu")
    jcat = J.build_catalog(MIXED_TEXT)
    padded, n_real = pad_catalog(pcat, 8)
    jpadded, j_real = j_pad_catalog(jcat, 8)
    assert n_real == j_real == 5
    assert len(padded) == len(jpadded) == 8
    assert padded.satnum[-1] == pcat.satnum[-1]
    np.testing.assert_array_equal(padded.satnum, jpadded.satnum)
    for f, a, b in zip(padded.host._fields, padded.host, jpadded.els):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f)
    assert pad_catalog(padded, 8)[0] is padded


def test_shard_catalog_keeps_the_catalogs_constants(escape_cats):
    pcat = escape_cats[0]
    scat, n_real = shard_catalog(pcat, make_mesh(CPU8, time_parallel=2))
    assert n_real == 45 and scat.block == 12 and scat.shards.shape == (2, 4)
    # one catalog a shard and device: a repeated device shares it
    assert scat.shards[0, 1] is scat.shards[1, 1]
    rows = []
    for sub in scat.shards[0]:
        assert sub.epoch_min_jd == pcat.epoch_min_jd
        assert sub.kepler_iters == pcat.kepler_iters
        assert sub.deep_kepler_iters == pcat.deep_kepler_iters
        rows.append(sub.satnum)
    np.testing.assert_array_equal(
        np.concatenate(rows), np.r_[pcat.satnum, [pcat.satnum[-1]] * 3])
    # the escape lanes lie in more than one shard
    assert sum(s.heo_escape is not None for s in scat.shards[0]) > 1


# ---------------------------------------------------------------------------
# Sharded propagation
# ---------------------------------------------------------------------------


def _assert_same(got, want):
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)


@pytest.mark.parametrize("time_parallel", [1, 2])
@pytest.mark.parametrize("which", ["escape", "shell"])
def test_sharded_fast_equals_single_device(escape_cats, shell, which,
                                           time_parallel):
    if which == "escape":
        cat, jd = escape_cats[0], escape_cats[2]
    else:
        cat, jd = shell[0], shell[1][:7]
    mesh = make_mesh(CPU8, time_parallel=time_parallel)
    for layout in ("time_major", "sat_major", "planes"):
        got = propagate_sharded_fast(cat, jd, mesh=mesh, layout=layout)
        want = P.propagate(cat, jd, method="fast", layout=layout)
        _assert_same(got, want)
    for kw in ({"velocities": False}, {"output": "ecef"}):
        got = propagate_sharded_fast(cat, jd, mesh=mesh, **kw)
        _assert_same(got, P.propagate(cat, jd, method="fast", **kw))
    # geodetic: torch's vectorized f32 atan2 and sqrt on the CPU round by
    # a lane's position in its vector (measured 1.2e-6 relative)
    got = propagate_sharded_fast(cat, jd, mesh=mesh, output="geodetic",
                                 layout="planes")
    want = P.propagate(cat, jd, method="fast", output="geodetic",
                       layout="planes")
    _assert_same(got[1:], want[1:])
    torch.testing.assert_close(got[0], want[0], rtol=GEODETIC_RTOL, atol=0)


def test_stage_sharded_fast_returns_unjoined_shards(escape_cats):
    pcat, _, jd = escape_cats
    mesh = make_mesh(CPU8, time_parallel=2)
    fn, args, (n_times, n_real) = stage_sharded_fast(pcat, jd, mesh=mesh,
                                                     layout="planes")
    assert (n_times, n_real) == (7, 45) and len(args) == 8
    outs = fn(*args)
    assert [tuple(r.shape) for r, _, _ in outs] == [(3, 4, 12)] * 8
    again = fn(*args)
    assert all(torch.equal(a[0], b[0]) for a, b in zip(outs, again))
    with pytest.raises(ValueError, match="engine"):
        stage_sharded_fast(pcat, jd, mesh=mesh, engine="xla")


@pytest.mark.parametrize("time_parallel", [1, 2])
def test_sharded_f64_matches_jax(escape_cats, time_parallel):
    pcat, jcat, jd = escape_cats
    mesh = make_mesh(CPU8, time_parallel=time_parallel)
    r, v, e = propagate_sharded(pcat, jd, mesh=mesh)
    rj, vj, ej = j_propagate_sharded(
        jcat, jd, mesh=j_make_mesh(time_parallel=time_parallel))
    assert r.dtype == torch.float64 and tuple(r.shape) == (7, 45, 3)
    np.testing.assert_array_equal(e.numpy(), np.asarray(ej))
    np.testing.assert_allclose(r.numpy(), _np(rj), rtol=0, atol=F64_POS_KM)
    np.testing.assert_allclose(v.numpy(), _np(vj), rtol=0, atol=F64_VEL_KMS)
    r1, v1, e1 = P.propagate(pcat, jd, method="f64")
    assert torch.equal(e, e1)
    np.testing.assert_allclose(r.numpy(), r1.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(v.numpy(), v1.numpy(), rtol=0, atol=1e-12)


def test_sharded_f64_ecef_matches_jax(escape_cats):
    pcat, jcat, jd = escape_cats
    r, v, e = propagate_sharded(pcat, jd, mesh=make_mesh(CPU8),
                                output="ecef", velocities=False)
    rj, _, ej = j_propagate_sharded(jcat, jd, mesh=j_make_mesh(),
                                    output="ecef")
    assert v is None
    np.testing.assert_array_equal(e.numpy(), np.asarray(ej))
    np.testing.assert_allclose(r.numpy(), _np(rj), rtol=0, atol=F64_ECEF_KM)


@pytest.fixture
def jax_sharded_fixed(jax_drag_fixed):
    """``jax_drag_fixed``, with the cached sharded JAX programs dropped
    while the patch holds and after it."""
    jmesh._sharded_fast_fn.cache_clear()
    yield
    jmesh._sharded_fast_fn.cache_clear()


@pytest.mark.parametrize("time_parallel", [1, 2])
def test_sharded_fast_matches_jax(escape_cats, jax_sharded_fixed,
                                  time_parallel):
    pcat, jcat, jd = escape_cats
    r, v, e = propagate_sharded_fast(
        pcat, jd, mesh=make_mesh(CPU8, time_parallel=time_parallel))
    rj, vj, ej = j_propagate_sharded_fast(
        jcat, jd, mesh=j_make_mesh(time_parallel=time_parallel),
        engine="xla")
    esc = pcat.deep_idx[pcat.heo_escape.idx.numpy()]
    keep = np.setdiff1d(np.arange(len(pcat)), esc)
    assert len(esc) == 9 and len(keep) == 36
    np.testing.assert_array_equal(e.numpy()[:, keep], np.asarray(ej)[:, keep])
    np.testing.assert_allclose(r.numpy()[:, keep], _np(rj)[:, keep], rtol=0,
                               atol=FAST_POS_KM)
    np.testing.assert_allclose(v.numpy()[:, keep], _np(vj)[:, keep], rtol=0,
                               atol=FAST_VEL_KMS)


# ---------------------------------------------------------------------------
# Screens on a mesh
# ---------------------------------------------------------------------------


def _assert_same_screen(got, want, d_tol):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=d_tol)
    assert [x.dtype for x in got] == [np.int64, np.int64, np.float64,
                                      np.int64]


def test_time_sharded_screen_equals_screen_all(shell, monkeypatch):
    pcat, times = shell
    want = P.screen_all(pcat, times, threshold_km=50.0)
    assert len(want[0]) > 0
    slices = []
    real = cuda_screen.coarse_candidates

    def spy(r_planes, thr2, **kw):
        slices.append(r_planes.shape[1])
        return real(r_planes, thr2, **kw)

    monkeypatch.setattr(cuda_screen, "coarse_candidates", spy)
    got = P.screen_all(pcat, times, threshold_km=50.0,
                       mesh=make_mesh(CPU8, time_parallel=2))
    _assert_same_screen(got, want, 0.0)
    assert slices == [12, 12] + [11] * 6
    got = P.Constellation(pcat).screen(times, threshold_km=50.0,
                                       mesh=make_mesh(CPU8))
    _assert_same_screen(got, want, 0.0)


@pytest.mark.parametrize("n", [1024, 100])
def test_ring_screen_matches_jax_and_screen_all(n):
    text = synthetic_leo_text(n)
    pcat = P.build_catalog(text, device="cpu")
    jcat = J.build_catalog(text)
    times = jcat.epochs_jd[0] + np.linspace(0.0, 0.25, 24)
    got = screen_all_ring(pcat, times, threshold_km=50.0,
                          mesh=make_mesh(CPU8))
    assert len(got[0]) > 0
    _assert_same_screen(got, P.screen_all(pcat, times, threshold_km=50.0),
                        0.0)
    _assert_same_screen(got, j_screen_all_ring(
        jcat, times, threshold_km=50.0, mesh=j_make_mesh()), SHELL_D_TOL_KM)


def test_ring_screen_mixed_catalog():
    pcat = P.build_catalog(MIXED_TEXT, device="cpu")
    jcat = J.build_catalog(MIXED_TEXT)
    times = jcat.epochs_jd[0] + np.linspace(0.0, 0.5, 24)
    mesh = make_mesh(CPU8)
    got = screen_all_ring(pcat, times, threshold_km=20000.0, mesh=mesh)
    assert len(got[0]) == 5
    _assert_same_screen(got, P.screen_all(pcat, times, threshold_km=20000.0),
                        0.0)
    got = screen_all_ring(pcat, times, threshold_km=20000.0, mesh=mesh,
                          method="f64")
    _assert_same_screen(got, j_screen_all_ring(
        jcat, times, threshold_km=20000.0, mesh=j_make_mesh(),
        method="f64"), MIXED_F64_D_TOL_KM)


def test_ring_failed_satellites_in_two_shards():
    """Two decayed satellites in different shards park at distinct far
    points, numbered by their global columns, and make no pair."""
    def decay(k, raan):
        return (f"1 9000{k}U 98067A   24001.50000000  .00016717  00000-0"
                f"  99999+2 0  999{k}",
                f"2 9000{k}  51.6400 {raan:8.4f} 0001234  90.0000 270.0000"
                f" 15.5000000000001{k}")
    lines = [*decay(1, 200.0), TRAJ_L1, TRAJ_L2, *decay(2, 210.0)]
    lines += synthetic_leo_text(7).splitlines()
    pcat = P.build_catalog("\n".join(lines), device="cpu")
    times = pcat.epochs_jd[0] + 2.0 + np.linspace(0.0, 0.1, 10)
    err = P.propagate(pcat, times, method="fast")[2]
    assert bool((err[:, 0] != 0).all() and (err[:, 2] != 0).all())
    got = screen_all_ring(pcat, times, threshold_km=5000.0,
                          mesh=make_mesh(CPU8))
    pairs = set(zip(got[0].tolist(), got[1].tolist()))
    assert len(pcat) == 10 and len(pairs) > 0
    assert not {p for p in pairs if {0, 2} & set(p)}
    _assert_same_screen(got, P.screen_all(pcat, times, threshold_km=5000.0),
                        0.0)


def test_ring_max_pairs_keeps_the_first_in_ij_order():
    pcat = P.build_catalog(synthetic_leo_text(100), device="cpu")
    times = pcat.epochs_jd[0] + np.linspace(0.0, 0.25, 24)
    full = screen_all_ring(pcat, times, threshold_km=300.0,
                           mesh=make_mesh(CPU8))
    assert len(full[0]) > 8
    with pytest.warns(UserWarning, match="screen_all_ring.*max_pairs"):
        got = screen_all_ring(pcat, times, threshold_km=300.0,
                              mesh=make_mesh(CPU8), max_pairs=8)
    with pytest.warns(UserWarning, match="screen_all.*max_pairs"):
        want = P.screen_all(pcat, times, threshold_km=300.0, max_pairs=8)
    _assert_same_screen(got, want, 0.0)
    _assert_same_screen(got, tuple(x[:len(got[0])] for x in full), 0.0)


# ---------------------------------------------------------------------------
# K4's rectangle mode, plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split,n,n_times", [(77, 300, 19), (130, 259, 33)])
def test_rect_plain_version(split, n, n_times):
    """On ragged blocks with NaN entries: the rectangle mode's pairs equal
    the triangle's pairs that cross the split, and the brute-force
    threshold of numpy's FMA emulation."""
    planes = _planes(n, n_times)
    planes[:, 3, 5] = np.nan
    planes[1, 7, split + 4] = np.nan
    r = torch.from_numpy(planes)
    rows, cols = r[:, :, :split].contiguous(), r[:, :, split:].contiguous()
    thr2 = float(np.float32(400.0 ** 2))
    ii, jj = cuda_screen.coarse_candidates_rect(rows, cols, thr2)
    assert len(ii) > 0 and ii.dtype == torch.int64
    key = ii * (n - split) + jj
    assert bool((key[1:] > key[:-1]).all())
    ti, tj = cuda_screen.coarse_candidates(r, thr2)
    cross = (ti < split) & (tj >= split)
    assert torch.equal(ii, ti[cross]) and torch.equal(jj + split, tj[cross])
    x, y, z = (planes[q][:, :split, None] - planes[q][:, None, split:]
               for q in range(3))
    d2 = _fma_f32(z, z, _fma_f32(x, x, y * y))
    with np.errstate(invalid="ignore"):
        nan = np.isnan(d2).any(axis=0)
        bi, bj = np.nonzero((d2.min(axis=0) <= np.float32(thr2)) & ~nan)
    np.testing.assert_array_equal(ii.numpy(), bi)
    np.testing.assert_array_equal(jj.numpy(), bj)
    assert not {5} & set(ii.tolist())


def test_rect_rejects_mismatched_blocks():
    a = torch.zeros(3, 4, 5)
    with pytest.raises(ValueError, match="same epochs"):
        cuda_screen.coarse_candidates_rect(a, torch.zeros(3, 5, 5), 1.0)
    e0, e1 = cuda_screen.coarse_candidates_rect(a, torch.zeros(3, 4, 0), 1.0)
    assert len(e0) == len(e1) == 0

