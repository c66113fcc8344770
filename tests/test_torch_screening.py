"""Conjunction screening in astroz_tpu_torch against astroz_tpu on the
same inputs: the coarse kernel K4's plain version against the TPU kernel
in interpret mode, the refine, ``screen_all`` and ``screen_target``, and
the ``Constellation`` entry points.

Tolerances, each with its reason and the value measured on these inputs:

* Coarse pass, on the same numpy planes: bit for bit on the strict upper
  triangle (measured 0 ulps). XLA:CPU contracts the TPU kernel's
  ``dx*dx + dy*dy + dz*dz`` into ``fma(dz, dz, fma(dx, dx, dy*dy))``, and
  the CUDA kernel computes that chain with explicit FMAs; the port's
  plain version emulates each FMA by rounding to odd in f64 and is held
  bit for bit to an independent numpy emulation, including an input
  where a plain f64 sum rounded to f32 gives the wrong bit.
* Refine, on the same planes: 1 ulp of the distance (measured 1), the
  square root of the same contraction; epoch indices identical.
* ``screen_all`` / ``screen_target`` end to end: the positions come from
  each package's own fast path, 2.0e-3 km apart at most on the LEO shell
  (bstar 0, so the JAX drag-term fault does not enter there), so
  distances get 0.01 km (measured 5.1e-4 km for ``screen_all``, 2.9e-3
  km for ``screen_target``, whose target carries drag); pair sets and
  epoch indices are identical. On the mixed catalog, under
  ``jax_fixed``: 0.05 km, the port's mixed-catalog gate
  (``test_torch_mixed.py``).
"""

import os
import sys

import numpy as np
import pytest
import torch

import astroz_tpu as J
from astroz_tpu.ops import pallas_screen
from astroz_tpu import screening as jscr
import astroz_tpu_torch as P
from astroz_tpu_torch import screening as pscr
from astroz_tpu_torch.ops import cuda_screen
from astroz_tpu_torch.tle import parse_lines

from test_propagation import MIXED_TEXT
from test_screening import brute_force_pairs, synthetic_leo_text
from test_sgp4 import TRAJ_L1, TRAJ_L2
from test_torch_fast import jax_drag_fixed  # noqa: F401  (fixture)
from test_torch_mixed import jax_fixed  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

COARSE_ULPS = 0
SHELL_D_TOL_KM = 0.01
MIXED_D_TOL_KM = 0.05


@pytest.fixture(scope="module")
def shell():
    text = synthetic_leo_text(96)
    jcat = J.build_catalog(text)
    pcat = P.build_catalog(text, device="cpu")
    times = jcat.epochs_jd[0] + np.linspace(0.0, 0.25, 90)
    return text, jcat, pcat, times


def _planes(n, n_times):
    """JAX's parked f32 position planes of an n-satellite shell."""
    cat = J.build_catalog(synthetic_leo_text(n, seed=5))
    t = float(cat.epochs_jd[0]) + np.linspace(0.0, 0.25, n_times)
    return np.array(jscr._positions_planes_f32(cat, t))


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float((np.abs(a.astype(np.float64) - b)
                  / np.spacing(np.maximum(a, b))).max())


def _fma_f32(a, b, c):
    """numpy: ``fma(a, b, c)`` of f32 arrays, rounded once to f32: the
    exact f64 product, the f64 sum rounded to odd (a TwoSum error term;
    an inexact sum with an even last bit steps one ulp toward the exact
    value), then rounded to nearest f32."""
    p = np.asarray(a, np.float64) * b
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    with np.errstate(invalid="ignore"):
        step = (np.abs(err) > 0) & (s.view(np.int64) & 1 == 0)
        toward = np.nextafter(s, np.copysign(np.inf, err))
    return np.where(step, toward, s).astype(np.float32)


def _coarse_numpy(r):
    """K4's matrix in numpy: min over time of
    ``fma(dz, dz, fma(dx, dx, dy*dy))``, +inf at and below the
    diagonal."""
    x, y, z = r
    n = r.shape[2]
    expect = np.full((n, n), np.inf, np.float32)
    for t in range(r.shape[1]):
        dx, dy, dz = (c[t][:, None] - c[t][None, :] for c in (x, y, z))
        expect = np.minimum(expect, _fma_f32(dz, dz, _fma_f32(dx, dx,
                                                              dy * dy)))
    expect[np.tril_indices(n)] = np.inf
    return expect


def _assemble(chunks, n):
    out = np.full((n, n), np.nan, np.float32)
    for j0, dmin in chunks:
        out[:, j0:j0 + dmin.shape[1]] = dmin.numpy()
    return out


@pytest.mark.parametrize("n,n_times", [(96, 90), (600, 24)])
def test_coarse_matches_jax_interpret(n, n_times):
    r = _planes(n, n_times)
    ((_, jfull),) = pallas_screen.coarse_min_all(r, interpret=True)
    ((j0, full),) = cuda_screen.coarse_min_all(torch.as_tensor(r))
    assert j0 == 0 and tuple(full.shape) == (n, n)
    iu = np.triu_indices(n, k=1)
    got = full.numpy()[iu]
    assert _ulps(np.asarray(jfull)[:n, :n][iu], got) <= COARSE_ULPS
    # bit for bit the FMA chain in numpy, +inf at and below the diagonal
    np.testing.assert_array_equal(full.numpy(), _coarse_numpy(r))


def test_coarse_fma_at_the_double_rounding_corner():
    """dx = 4097 km and dy = 2^-15 km: dx*dx + dy*dy = 16785409 + 2^-30 is
    just above the midpoint of the f32 neighbours 16785408 and 16785410.
    The f64 sum rounds to the midpoint and then, cast to f32, to the even
    16785408; one FMA gives 16785410. Pair (0, 1) meets the corner in the
    inner FMA, pair (1, 2) in the outer one (dz = 4097); the plain version,
    the numpy emulation and the TPU kernel in interpret mode agree."""
    r = np.zeros((3, 2, 3), np.float32)
    r[:, 0, 0] = (4097.0, 2.0**-15, 0.0)
    r[:, 0, 2] = (2.0**-15, 0.0, 4097.0)
    r[:, 1] = 1.0e4 * np.arange(3)          # far apart at the second epoch
    assert np.float32(4097.0**2 + 2.0**-30) == 16785408.0   # plain f64
    ((_, full),) = cuda_screen.coarse_min_all(torch.as_tensor(r))
    assert full[0, 1].item() == full[1, 2].item() == 16785410.0
    np.testing.assert_array_equal(full.numpy(), _coarse_numpy(r))
    ((_, jfull),) = pallas_screen.coarse_min_all(r, interpret=True)
    iu = np.triu_indices(3, k=1)
    np.testing.assert_array_equal(np.asarray(jfull)[:3, :3][iu],
                                  full.numpy()[iu])


def _nan_planes(n, n_times):
    """Planes with a NaN position on satellite 40 at the fourth epoch."""
    r = torch.as_tensor(_planes(n, n_times))
    r[1, 3, 40] = float("nan")
    return r


@pytest.mark.parametrize("n,n_times", [(96, 90), (600, 24)])
def test_candidates_equal_the_thresholded_matrix(n, n_times):
    """K4's candidate mode gives the (i, j) of the matrix entries at most
    thr2, in (i, j) order, with no pair of the NaN satellite; with
    ``cap=1`` (the kernel's overflow path) and in the plain version's
    column chunks the same."""
    r = _nan_planes(n, n_times)
    ((_, dmin),) = cuda_screen.coarse_min_all(r)
    upper = dmin[torch.isfinite(dmin)]
    thr2 = float(np.float32(np.quantile(upper.numpy(), 0.02)))
    ii, jj = cuda_screen.coarse_candidates(r, thr2)
    assert ii.dtype == jj.dtype == torch.int64 and len(ii) > 10
    expect = torch.nonzero(dmin <= thr2)        # row-major: (i, j) order
    assert torch.equal(ii, expect[:, 0]) and torch.equal(jj, expect[:, 1])
    assert ((ii != 40) & (jj != 40)).all() and (ii < jj).all()
    key = ii * n + jj
    assert (key[1:] > key[:-1]).all()
    for got in (cuda_screen.coarse_candidates(r, thr2, cap=1),
                cuda_screen.coarse_candidates_reference(
                    r, thr2, max_bytes=4 * n * 37)):
        assert torch.equal(got[0], ii) and torch.equal(got[1], jj)
    none = cuda_screen.coarse_candidates(r, -1.0)
    assert none[0].numel() == none[1].numel() == 0


@pytest.mark.parametrize("n,n_times", [(96, 90), (600, 24)])
def test_coarse_chunked_matches_single_shot(n, n_times):
    """Ragged column chunks under a small ``max_bytes`` give the
    single-shot result entry for entry; each buffer stays under
    ``max_bytes``."""
    r = torch.as_tensor(_planes(n, n_times))
    ((_, full),) = cuda_screen.coarse_min_all(r)
    max_bytes = 4 * n * 37
    chunks = list(cuda_screen.coarse_min_all(r, max_bytes=max_bytes))
    assert len(chunks) == -(-n // 37) > 1
    assert all(d.numel() * 4 <= max_bytes for _, d in chunks)
    np.testing.assert_array_equal(_assemble(chunks, n), full.numpy())


@pytest.mark.parametrize("n,n_times", [(96, 90), (600, 24)])
def test_plain_column_blocks_match_single_shot(n, n_times):
    """The plain matrix version under a small ``work_bytes`` computes its
    chunk in ragged blocks of columns (37 here, each with only the rows
    above its last column) and gives the same bits, NaN and +inf
    included."""
    r = _nan_planes(n, n_times)
    ((_, full),) = cuda_screen.coarse_min_all(r)
    work = cuda_screen.PLAIN_BYTES_PER_ENTRY * n * 37
    for j0, width in ((0, n), (n // 3, n - n // 3 - 5)):
        blocks = cuda_screen.coarse_min_chunk_reference(r, j0, width,
                                                        work_bytes=work)
        np.testing.assert_array_equal(blocks.numpy(),
                                      full[:, j0:j0 + width].numpy())


def test_coarse_keeps_nan_and_checks_arguments():
    r = torch.as_tensor(_planes(96, 12))
    r[1, 5, 40] = float("nan")
    ((_, dmin),) = cuda_screen.coarse_min_all(r)
    assert torch.isnan(dmin[:40, 40]).all() and torch.isnan(dmin[40, 41:]).all()
    assert not torch.isnan(dmin[:40, 41:]).any()
    assert torch.isposinf(dmin[40, :41]).all()
    il = torch.tril_indices(96, 96)
    assert torch.isposinf(dmin[il[0], il[1]]).all()
    with pytest.raises(ValueError, match="outside"):
        cuda_screen.coarse_min_chunk(r, 90, 10)
    with pytest.raises(ValueError, match="float32"):
        cuda_screen.coarse_min_chunk(r.double(), 0, 10)


def test_refine_matches_jax():
    r = _planes(96, 90)
    rng = np.random.default_rng(3)
    ii = rng.integers(0, 96, 700)
    jj = rng.integers(0, 96, 700)
    jd, jt = jscr._refine_pairs_planes(r, ii, jj, 1024)
    pd, pt = pscr._refine_pairs_planes(torch.as_tensor(r),
                                       torch.as_tensor(ii),
                                       torch.as_tensor(jj))
    assert pd.dtype == torch.float32
    assert _ulps(jd, pd.numpy()) <= 1
    np.testing.assert_array_equal(np.asarray(jt), pt.numpy())


def _assert_same_screen(got, ref, d_tol):
    gi, gj, gd, gt = got
    ri, rj, rd, rt = ref
    assert [x.dtype for x in got] == [np.int64, np.int64, np.float64,
                                      np.int64]
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_array_equal(gj, rj)
    np.testing.assert_array_equal(gt, rt)
    assert np.abs(gd - rd).max(initial=0.0) <= d_tol


def test_screen_all_matches_jax_and_brute_force(shell):
    _, jcat, pcat, times = shell
    got = P.screen_all(pcat, times, threshold_km=50.0)
    ref = J.screen_all(jcat, times, threshold_km=50.0)
    assert len(got[0]) > 0
    _assert_same_screen(got, ref, SHELL_D_TOL_KM)
    assert (got[0] < got[1]).all() and (got[2] < 50.0).all()
    bi, bj, bd = brute_force_pairs(jcat, times, 50.0)
    np.testing.assert_array_equal(got[0], bi)
    np.testing.assert_array_equal(got[1], bj)
    assert np.abs(got[2] - bd).max() < 0.05  # f32 refine vs f64 brute


def test_screen_all_mixed_catalog_matches_jax(jax_fixed):
    jcat = J.build_catalog(MIXED_TEXT)
    pcat = P.build_catalog(MIXED_TEXT, device="cpu")
    t = float(jcat.epochs_jd[0]) + np.linspace(0.0, 0.1, 24)
    got = P.screen_all(pcat, t, threshold_km=1.0e5)
    ref = J.screen_all(jcat, t, threshold_km=1.0e5)
    assert len(got[0]) == 10  # every pair of the 5 satellites
    _assert_same_screen(got, ref, MIXED_D_TOL_KM)


def test_failed_satellites_do_not_screen_each_other():
    """Two decayed satellites park at distinct far points and never
    screen as a 0-km conjunction."""
    decay1 = ("1 90001U 98067A   24001.50000000  .00016717  00000-0"
              "  99999+2 0  9991")
    decay2 = ("1 90002U 98067A   24001.50000000  .00016717  00000-0"
              "  99999+2 0  9992")
    l2a = ("2 90001  51.6400 200.0000 0001234  90.0000 270.0000"
           " 15.50000000000017")
    l2b = ("2 90002  51.6400 210.0000 0001234  90.0000 270.0000"
           " 15.50000000000019")
    text = "\n".join([decay1, l2a, decay2, l2b, TRAJ_L1, TRAJ_L2])
    pcat = P.build_catalog(text, device="cpu")
    jcat = J.build_catalog(text)
    times = pcat.epochs_jd[0] + 2.0 + np.linspace(0, 0.1, 10)
    _, _, err = P.propagate(pcat, times, method="fast")
    assert (err[:, :2] != 0).all()
    got = P.screen_all(pcat, times, threshold_km=5000.0)
    assert (0, 1) not in set(zip(got[0].tolist(), got[1].tolist()))
    _assert_same_screen(got, J.screen_all(jcat, times, threshold_km=5000.0,
                                          block=8), SHELL_D_TOL_KM)


def test_decayed_satellite_does_not_change_the_healthy_pairs():
    """A failed (parked) satellite in the catalog leaves the healthy
    pairs as they are, under a tight ``max_pairs``."""
    text = synthetic_leo_text(48)
    l1 = ("1 99999U 24001A   24001.50000000  .00000000  00000-0"
          "  99999+0 0  9996")
    l2 = ("2 99999  51.6000 100.0000 0012000  90.0000 270.0000 "
          "16.49000000000016")
    cat_mixed = P.build_catalog(text + "\n" + l1 + "\n" + l2, device="cpu")
    cat_clean = P.build_catalog(text, device="cpu")
    jd = 2460311.0 + np.linspace(0.0, 0.1, 24)
    _, _, err = P.propagate(cat_mixed, jd, method="fast")
    assert (err[:, -1] != 0).any()
    im, jm, dm, tm = P.screen_all(cat_mixed, jd, threshold_km=25.0,
                                  max_pairs=200)
    clean = P.screen_all(cat_clean, jd, threshold_km=25.0, max_pairs=200)
    keep = (im < 48) & (jm < 48)
    assert len(clean[0]) > 0
    _assert_same_screen((im[keep], jm[keep], dm[keep], tm[keep]), clean, 0.0)
    _assert_same_screen(clean, J.screen_all(J.build_catalog(text), jd,
                                            threshold_km=25.0),
                        SHELL_D_TOL_KM)


def test_screen_all_empty_when_threshold_tiny(shell):
    pcat, times = shell[2:]
    got = P.screen_all(pcat, times, threshold_km=1e-6)
    assert all(len(x) == 0 for x in got)
    assert [x.dtype for x in got] == [np.int64, np.int64, np.float64,
                                      np.int64]


def test_max_pairs_truncates_with_a_warning(shell):
    """The truncation keeps the first ``max_pairs`` candidates in (i, j)
    order: the cut screen is the full screen's pairs among them."""
    pcat, times = shell[2:]
    full = P.screen_all(pcat, times, threshold_km=50.0)
    with pytest.warns(UserWarning, match="max_pairs"):
        cut = P.screen_all(pcat, times, threshold_km=50.0, max_pairs=2)
    assert len(full[0]) > 2 and len(cut[0]) <= 2
    thr2 = float(np.float32((50.0 * (1.0 + 1.0e-6)) ** 2))
    ci, cj = cuda_screen.coarse_candidates(
        pscr._positions_planes_f32(pcat, times), thr2)
    first = set(zip(ci[:2].tolist(), cj[:2].tolist()))
    keep = np.array([(i, j) in first for i, j in zip(full[0], full[1])])
    _assert_same_screen(cut, tuple(x[keep] for x in full), 0.0)


def test_screen_target_matches_jax(shell):
    text, jcat, pcat, times = shell
    ref = jscr.screen_target(jcat, J.tle.parse_lines(TRAJ_L1, TRAJ_L2),
                             times, threshold_km=100.0)
    got = P.screen_target(pcat, parse_lines(TRAJ_L1, TRAJ_L2), times,
                          threshold_km=100.0)
    min_d, t_idx, mask = got
    assert min_d.dtype == torch.float32 and t_idx.dtype == torch.int64
    assert all(x.device.type == "cpu" and x.shape == (96,) for x in got)
    assert float(min_d.min()) < 1000.0
    assert np.abs(min_d.numpy() - np.asarray(ref[0])).max() <= SHELL_D_TOL_KM
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(ref[1]))
    assert torch.equal(mask, min_d < 100.0)
    # a target given as text, without the threshold
    d2, t2 = P.screen_target(pcat, TRAJ_L1 + "\n" + TRAJ_L2, times)
    assert torch.equal(d2, min_d) and torch.equal(t2, t_idx)
    with pytest.raises(ValueError, match="exactly one target"):
        P.screen_target(pcat, text, times)


def test_constellation_screen(shell):
    text, jcat, pcat, times = shell
    epoch = float(jcat.epochs_jd[0])
    minutes = (times - epoch) * 1440.0
    con = P.Constellation(text, device="cpu")
    got = con.screen(minutes, start_time=epoch, threshold_km=50.0)
    _assert_same_screen(got, J.Constellation(text).screen(
        minutes, start_time=epoch, threshold_km=50.0), SHELL_D_TOL_KM)
    one = P.screen(text, minutes, epoch, threshold_km=50.0, device="cpu")
    _assert_same_screen(one, got, 0.0)
    tle = parse_lines(TRAJ_L1, TRAJ_L2)
    d, t, m = con.screen(minutes, start_time=epoch, threshold_km=100.0,
                         target=tle)
    d1, t1, m1 = P.screen(text, minutes, epoch, threshold_km=100.0,
                          target=tle, device="cpu")
    d0, t0, m0 = P.screen_target(pcat, tle, times, threshold_km=100.0)
    for x, y in ((d, d0), (t, t0), (m, m0), (d1, d0), (t1, t0), (m1, m0)):
        assert torch.equal(x, y)


def test_unported_keywords_raise(shell):
    text, _, pcat, times = shell
    for kw in ({"block": 64}, {"mesh": None}, {"engine": "xla"}):
        with pytest.raises(TypeError):
            P.screen_all(pcat, times, threshold_km=50.0, **kw)
        with pytest.raises(TypeError):
            P.Constellation(pcat).screen(times, threshold_km=50.0, **kw)


def test_screen_all_runs_the_kernel_wrapper(shell, monkeypatch):
    """screen_all reaches K4's candidate wrapper once, with the cushioned
    f32 threshold, and never the matrix wrapper."""
    pcat, times = shell[2:]
    calls = []
    real = cuda_screen.coarse_candidates

    def spy(r_planes, thr2, **kw):
        calls.append((tuple(r_planes.shape), thr2))
        return real(r_planes, thr2, **kw)

    def matrix(*args, **kw):
        raise AssertionError("screen_all ran the matrix mode")

    monkeypatch.setattr(cuda_screen, "coarse_candidates", spy)
    monkeypatch.setattr(cuda_screen, "coarse_min_chunk", matrix)
    P.screen_all(pcat, times, threshold_km=50.0)
    assert calls == [((3, 90, 96),
                      float(np.float32((50.0 * (1.0 + 1.0e-6)) ** 2)))]


def test_screening_shell_text_matches_bench(monkeypatch):
    """``chip_smoke.screening_shell_text`` is the text
    ``benchmarks/bench_screening.py`` builds, draw for draw."""
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    try:
        import bench_screening
        import chip_smoke
    finally:
        sys.path.remove(REPO)
        sys.path.remove(os.path.join(REPO, "benchmarks"))

    class Captured(Exception):
        pass

    def capture(text, *args, **kw):
        raise Captured(text)

    monkeypatch.setattr(J, "build_catalog", capture)
    monkeypatch.setattr(sys, "argv", ["bench_screening.py", "300", "10"])
    monkeypatch.setattr(sys, "path", list(sys.path))
    with pytest.raises(Captured) as text:
        bench_screening.main()
    assert chip_smoke.screening_shell_text(300) == text.value.args[0]
    cat = P.build_catalog(chip_smoke.screening_shell_text(300), device="cpu")
    assert len(cat) == 300 and not cat.has_deep
    assert (cat.epochs_jd == 2460311.0).all()
