"""Kernels K1 to K6 (K4 in its three modes) and the spine kernel on the
card against their plain torch versions, a small all-vs-all screen on
the card against the same call on the CPU, and the multi-device paths on
a mesh of the card repeated against the single-device ones (marked
``cuda``; skips where ``torch.cuda.is_available()`` is False); and, on
the CPU, that no wrapper counts a launch there.

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

``synthetic_leo_text`` and ``synthetic_deep_text`` are shared with the
other ``test_torch_*`` files.
"""

import numpy as np
import pytest
import torch

from astroz_tpu_torch import build_catalog, propagate, screen_all
from astroz_tpu_torch.ops import cuda_screen, cuda_sgp4, propagate_fast
from astroz_tpu_torch.screening import _positions_planes_f32
from astroz_tpu_torch.tle import format_lines

torch.set_num_threads(1)


def synthetic_leo_text(n: int = 64, seed: int = 7,
                       decaying: bool = True) -> str:
    """3-line text of ``n`` random near-earth satellites (rev/day 12-16,
    e up to 0.02, epochs spread over +-2 days around JD 2460310.5), of
    which the first is a low-perigee lane on simplified drag and, with
    ``decaying``, the second decays (error 6, then error 1) from the
    earliest epoch, JD 2460308.5."""
    rng = np.random.default_rng(seed)
    rev = rng.uniform(12.0, 16.0, n)
    ecc = rng.uniform(1e-4, 0.02, n)
    inc = rng.uniform(17.0, 103.0, n)
    ang = rng.uniform(0.0, 360.0, (3, n))
    bstar = rng.uniform(-1e-4, 1e-3, n)
    epoch = 2460310.5 + rng.uniform(-2.0, 2.0, n)
    rev[0], ecc[0] = 16.2, 0.012          # perigee < 220 km: isimp
    if decaying:
        rev[1], ecc[1], bstar[1] = 16.0, 5e-4, 0.5
        epoch[1] = 2460308.5
    lines = []
    for k in range(n):
        l1, l2 = format_lines(
            satnum=40000 + k, epoch_jd=float(epoch[k]), ecco=float(ecc[k]),
            inclo_deg=float(inc[k]), nodeo_deg=float(ang[0, k]),
            argpo_deg=float(ang[1, k]), mo_deg=float(ang[2, k]),
            no_rev_day=float(rev[k]), bstar=float(bstar[k]))
        lines += [f"SYN-{k}", l1, l2]
    return "\n".join(lines)


def synthetic_deep_text(n: int = 48, seed: int = 11,
                        failing: bool = True) -> str:
    """3-line text of ``n`` random deep-space satellites, epochs spread
    over +-2 days around JD 2460310.5: GEO lanes (rev/day ~1.0027,
    e < 5e-4, i < 5.7 deg: geosynchronous resonance and the Lyddane
    branch), 12-hour lanes (rev/day 1.9-2.1, e 0.01-0.74, i 17-103 deg:
    half-day resonant where e >= 0.5) and Molniya-class lanes (rev/day
    ~2.006, e 0.70-0.74, i 63.4 deg: the HEO escape above e = 0.7). With
    ``failing``, the first lane's perigee lies below the surface (rev/day
    6.3, e 0.75: error 6 near perigee) and the second carries bstar 5
    (error 1)."""
    rng = np.random.default_rng(seed)
    kind = rng.choice(3, size=n, p=[0.4, 0.4, 0.2])
    rev = np.where(kind == 0, rng.normal(1.0027, 1e-4, n),
                   np.where(kind == 1, rng.uniform(1.9, 2.1, n),
                            rng.uniform(2.005, 2.007, n)))
    ecc = np.where(kind == 0, rng.uniform(1e-4, 5e-4, n),
                   np.where(kind == 1, rng.uniform(0.01, 0.74, n),
                            rng.uniform(0.70, 0.74, n)))
    inc = np.where(kind == 0, rng.uniform(0.0, 5.7, n),
                   np.where(kind == 1, rng.uniform(17.0, 103.0, n), 63.4))
    ang = rng.uniform(0.0, 360.0, (3, n))
    bstar = rng.uniform(-1e-4, 1e-3, n)
    epoch = 2460310.5 + rng.uniform(-2.0, 2.0, n)
    if failing:
        rev[:2], ecc[:2], bstar[:2] = (6.3, 6.0), (0.75, 0.5), (0.01, 5.0)
    lines = []
    for k in range(n):
        l1, l2 = format_lines(
            satnum=50000 + k, epoch_jd=float(epoch[k]), ecco=float(ecc[k]),
            inclo_deg=float(inc[k]), nodeo_deg=float(ang[0, k]),
            argpo_deg=float(ang[1, k]), mo_deg=float(ang[2, k]),
            no_rev_day=float(rev[k]), bstar=float(bstar[k]))
        lines += [f"DEEP-{k}", l1, l2]
    return "\n".join(lines)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [3, 4, 5, 8])
def test_kernel_matches_twin_on_cuda(cuda_device, iters):
    """Positions, velocities and error codes bit-equal to the plain
    version, and the kernel's positions bit-equal with and without
    velocities, over -250 .. +2000 minutes from the earliest epoch
    (ragged shapes: 64 satellites x 9 times)."""
    cat = build_catalog(synthetic_leo_text(), device=cuda_device)
    st = cat.fast_staging
    t = torch.linspace(-250.0, 2000.0, 9, dtype=torch.float64,
                       device=cuda_device)
    args = (t, st.t_sat, st.spine, st.tail, st.flags)
    before = cuda_sgp4.LAUNCHES["sgp4_shallow"]
    r, v, e = cuda_sgp4.propagate_fast_sep(*args, grav=cat.grav,
                                           kepler_iters=iters)
    r0, v0, e0 = cuda_sgp4.propagate_fast_sep(*args, grav=cat.grav,
                                              kepler_iters=iters,
                                              want_vel=False)
    torch.cuda.synchronize()
    assert cuda_sgp4.LAUNCHES["sgp4_shallow"] == before + 2 and v0 is None
    rr, vr, er = cuda_sgp4.propagate_fast_sep_reference(
        *args, grav=cat.grav, kepler_iters=iters)
    assert torch.equal(e, er) and torch.equal(e0, er)
    assert set(torch.unique(e).tolist()) == {0, 1, 6}
    assert torch.equal(r, rr) and torch.equal(v, vr)
    assert torch.equal(r, r0)


@pytest.mark.cuda
def test_kernel_matches_twin_over_a_year_on_cuda(cuda_device):
    """K1 over -1 .. +1 year (41 epochs; the spine's reduction mod 2pi at
    quotients up to ~2^13) bit-equal to its plain version."""
    cat = build_catalog(synthetic_leo_text(), device=cuda_device)
    st = cat.fast_staging
    t = torch.linspace(-525600.0, 525600.0, 41, dtype=torch.float64,
                       device=cuda_device)
    args = (t, st.t_sat, st.spine, st.tail, st.flags)
    kw = dict(grav=cat.grav, kepler_iters=cat.kepler_iters)
    got = cuda_sgp4.propagate_fast_sep(*args, **kw)
    ref = cuda_sgp4.propagate_fast_sep_reference(*args, **kw)
    assert (got[2] == 0).any()
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def _mixed_catalog(device):
    return build_catalog(synthetic_leo_text() + "\n"
                         + synthetic_deep_text(), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [6, 8])
def test_deep_kernel_matches_twin_on_cuda(cuda_device, iters):
    """K2 against its plain version over -1 .. +1 day around the deep
    epochs: positions, velocities and error codes bit-equal, positions
    bit-equal with and without velocities."""
    cat = _mixed_catalog(cuda_device)
    ds = cat.fast_staging.deep
    t = (torch.linspace(-1440.0, 1440.0, 13, dtype=torch.float64,
                        device=cuda_device) + 2880.0)
    args = (t, ds.t_sat, ds.spine, ds.tail, ds.flags,
            cat.resonance_tables(8))
    before = cuda_sgp4.LAUNCHES["sgp4_deep"]
    r, v, e = cuda_sgp4.propagate_deep_sep(*args, grav=cat.grav,
                                           kepler_iters=iters)
    r0, v0, e0 = cuda_sgp4.propagate_deep_sep(*args, grav=cat.grav,
                                              kepler_iters=iters,
                                              want_vel=False)
    torch.cuda.synchronize()
    assert cuda_sgp4.LAUNCHES["sgp4_deep"] == before + 2 and v0 is None
    rr, vr, er = cuda_sgp4.propagate_deep_sep_reference(
        *args, grav=cat.grav, kepler_iters=iters)
    assert torch.equal(e, er) and torch.equal(e0, er)
    assert 0 in set(torch.unique(e).tolist()) and (e != 0).any()
    assert torch.equal(r, rr) and torch.equal(v, vr)
    assert torch.equal(r, r0)


@pytest.mark.cuda
@pytest.mark.parametrize("want_vel", [True, False])
def test_merge_kernel_matches_twin_on_cuda(cuda_device, want_vel):
    """K3 against its plain version, bit for bit: the deep columns equal
    K2's planes (NaN planted in their shallow fields does not leak), the
    rest K1's plain version; the catalog's column maps and maps derived
    from ``deep_slot`` give the same planes, in one launch each."""
    cat = _mixed_catalog(cuda_device)
    st, ds = cat.fast_staging, cat.fast_staging.deep
    t = torch.linspace(-250.0, 2000.0, 9, dtype=torch.float64,
                       device=cuda_device)
    dr, dv, de = cuda_sgp4.propagate_deep_sep(
        t, ds.t_sat, ds.spine, ds.tail, ds.flags, cat.resonance_tables(8),
        grav=cat.grav, kepler_iters=cat.deep_kepler_iters,
        want_vel=want_vel)
    cols = torch.as_tensor(cat.deep_idx, device=cuda_device)
    # NaN in the deep columns' shallow fields must not leak: a select
    tail = st.tail.clone()
    tail[:, cols] = float("nan")
    args = (t, st.t_sat, st.spine, tail, st.flags, ds.slot, dr, dv, de)
    kw = dict(grav=cat.grav, kepler_iters=cat.kepler_iters,
              want_vel=want_vel)
    before = cuda_sgp4.LAUNCHES["sgp4_shallow_merge"]
    r, v, e = cuda_sgp4.propagate_fast_sep_merge(
        *args, **kw, maps=ds.maps)
    derived = cuda_sgp4.propagate_fast_sep_merge(*args, **kw)
    torch.cuda.synchronize()
    assert cuda_sgp4.LAUNCHES["sgp4_shallow_merge"] == before + 2
    rr, vr, er = cuda_sgp4.propagate_fast_sep_merge_reference(*args, **kw)
    assert torch.isfinite(r).all() and torch.equal(e, er)
    assert v is None or torch.isfinite(v).all()
    assert torch.equal(r[:, :, cols], dr) and torch.equal(e[:, cols], de)
    assert torch.equal(r, rr)
    assert all(a is b is None or torch.equal(a, b)
               for a, b in zip(derived, (r, v, e)))
    if want_vel:
        assert torch.equal(v[:, :, cols], dv)
        assert torch.equal(v, vr)
    else:
        assert v is None and vr is None


def _same_or_both_nan(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _coarse_planes(device):
    """A ragged 333-satellite x 100-epoch shell with a parked (failed)
    lane and one NaN position (satellite 50, epoch 7)."""
    cat = build_catalog(synthetic_leo_text(333), device=device)
    jd = cat.epoch_min_jd + np.linspace(0.0, 2.0, 100)
    r = _positions_planes_f32(cat, jd)
    assert (r > 5.0e6).any()  # the decaying lane is parked
    r[1, 7, 50] = float("nan")
    return r


@pytest.mark.cuda
def test_coarse_kernel_matches_twin_on_cuda(cuda_device):
    """K4's matrix mode against its plain version (the FMA chain, emulated
    by rounding to odd) on the ragged shell of ``_coarse_planes``:
    bit-equal entry for entry (NaN where NaN, +inf at and below the
    diagonal), single-shot and in ragged column chunks."""
    r = _coarse_planes(cuda_device)
    n = r.shape[2]
    before = cuda_screen.LAUNCHES["screen_coarse"]
    ((_, full),) = cuda_screen.coarse_min_all(r)
    chunks = list(cuda_screen.coarse_min_all(r, max_bytes=4 * n * 37))
    torch.cuda.synchronize()
    assert cuda_screen.LAUNCHES["screen_coarse"] == before + 1 + len(chunks)
    plain = cuda_screen.coarse_min_chunk_reference(r, 0, n)
    assert torch.isnan(plain).any()
    il = torch.tril_indices(n, n, device=cuda_device)
    assert torch.isposinf(full[il[0], il[1]]).all()
    assert _same_or_both_nan(full, plain)
    for j0, dmin in chunks:
        ref = cuda_screen.coarse_min_chunk_reference(r, j0, dmin.shape[1])
        assert _same_or_both_nan(dmin, ref)
    assert len(chunks) == -(-n // 37)
    assert _same_or_both_nan(torch.cat([d for _, d in chunks], dim=1), full)


@pytest.mark.cuda
def test_candidate_kernel_matches_twin_on_cuda(cuda_device):
    """K4's candidate mode against its plain version on the ragged shell
    of ``_coarse_planes``: the same (i, j) pairs in (i, j) order, none of
    the NaN satellite; with ``cap=1`` the overflow path launches twice and
    gives the same pairs."""
    r = _coarse_planes(cuda_device)
    n = r.shape[2]
    plain = cuda_screen.coarse_min_chunk_reference(r, 0, n)
    finite = plain[torch.isfinite(plain)]
    thr2 = float(np.float32(torch.quantile(finite[:1 << 20].double(),
                                           0.01).item()))
    ref = cuda_screen.coarse_candidates_reference(r, thr2)
    assert len(ref[0]) > 100
    assert ((ref[0] != 50) & (ref[1] != 50)).all()
    before = cuda_screen.LAUNCHES["screen_candidates"]
    got = cuda_screen.coarse_candidates(r, thr2)
    torch.cuda.synchronize()
    assert cuda_screen.LAUNCHES["screen_candidates"] == before + 1
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    over = cuda_screen.coarse_candidates(r, thr2, cap=1)
    torch.cuda.synchronize()
    assert cuda_screen.LAUNCHES["screen_candidates"] == before + 3
    assert torch.equal(over[0], ref[0]) and torch.equal(over[1], ref[1])


@pytest.mark.cuda
def test_rect_kernel_matches_twin_on_cuda(cuda_device):
    """K4's rectangle mode against its plain version on ragged blocks of
    the shell of ``_coarse_planes`` (rows 0..120 with the NaN satellite,
    columns 121..332): the same (row, column) pairs in order, none of the
    NaN satellite, also through the overflow path (two launches)."""
    r = _coarse_planes(cuda_device)
    rows, cols = r[:, :, :121].contiguous(), r[:, :, 121:].contiguous()
    thr2 = float(np.float32(1500.0 ** 2))
    ref = cuda_screen.coarse_candidates_rect_reference(rows, cols, thr2)
    assert len(ref[0]) > 10 and (ref[0] != 50).all()
    before = cuda_screen.LAUNCHES["screen_candidates_rect"]
    got = cuda_screen.coarse_candidates_rect(rows, cols, thr2)
    over = cuda_screen.coarse_candidates_rect(rows, cols, thr2, cap=1)
    torch.cuda.synchronize()
    assert cuda_screen.LAUNCHES["screen_candidates_rect"] == before + 3
    for pairs in (got, over):
        assert torch.equal(pairs[0], ref[0]) and torch.equal(pairs[1], ref[1])


@pytest.mark.cuda
def test_mesh_paths_on_cuda_equal_single_device(cuda_device):
    """On a mesh of the card repeated four times: the sharded fast sweep
    of a mixed catalog equals ``propagate(method="fast")`` bit for bit,
    and the time-sharded and ring screens give ``screen_all``'s pairs."""
    from astroz_tpu_torch.parallel import make_mesh, propagate_sharded_fast
    from astroz_tpu_torch.screening import screen_all_ring

    mesh = make_mesh([cuda_device] * 4)
    cat = build_catalog(synthetic_leo_text(150) + "\n"
                        + synthetic_deep_text(30), device=cuda_device)
    jd = cat.epoch_min_jd + np.linspace(-0.2, 1.0, 37)
    for layout in ("time_major", "planes"):
        got = propagate_sharded_fast(cat, jd, mesh=mesh, layout=layout)
        want = propagate(cat, jd, method="fast", layout=layout)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    shell = build_catalog(synthetic_leo_text(200), device=cuda_device)
    jd = 2460310.5 + np.linspace(0.0, 0.5, 145)
    want = screen_all(shell, jd, threshold_km=300.0)
    assert len(want[0]) > 0
    for got in (screen_all(shell, jd, threshold_km=300.0, mesh=mesh),
                screen_all_ring(shell, jd, threshold_km=300.0, mesh=mesh)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_screen_all_on_cuda_matches_cpu(cuda_device):
    """A small all-vs-all screen on the card gives the pairs and epochs of
    the same call on the CPU, distances within K1's 1e-3 km bound, through
    K1 and K4's candidate mode once each (the matrix mode never)."""
    text = synthetic_leo_text(200)
    jd = 2460310.5 + np.linspace(0.0, 0.5, 145)
    cpu = screen_all(build_catalog(text, device="cpu"), jd,
                     threshold_km=300.0)
    cat = build_catalog(text, device=cuda_device)
    k1 = cuda_sgp4.LAUNCHES["sgp4_shallow"]
    k4 = dict(cuda_screen.LAUNCHES)
    got = screen_all(cat, jd, threshold_km=300.0)
    assert cuda_sgp4.LAUNCHES["sgp4_shallow"] == k1 + 1
    assert cuda_screen.LAUNCHES == {**k4, "screen_candidates":
                                    k4["screen_candidates"] + 1}
    assert len(cpu[0]) > 0
    for a, b in zip(got[:2] + got[3:], cpu[:2] + cpu[3:]):
        np.testing.assert_array_equal(a, b)
    assert np.abs(got[2] - cpu[2]).max() <= 1e-3


def _dense_grid(cat, device):
    """A (37, S) grid of mixed sign: -1 .. +1 day around the earliest
    epoch minus each epoch, jittered by up to 30 minutes."""
    base = torch.linspace(-1440.0, 1440.0, 37, dtype=torch.float64,
                          device=device)[:, None]
    gen = torch.Generator().manual_seed(5)
    jitter = (torch.rand((37, len(cat)), generator=gen,
                         dtype=torch.float64) - 0.5) * 60.0
    return base - cat.fast_staging.t_sat[None, :] + jitter.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [3, 8])
def test_dense_kernels_match_twins_on_cuda(cuda_device, iters):
    """K5 on a dense grid and on a (T, 1) column, and K6 on the spine
    kernel's grids, against their plain versions: positions, velocities
    and error codes bit-equal; positions bit-equal with and without
    velocities; K6 equals K5 bit for bit."""
    cat = build_catalog(synthetic_leo_text(), device=cuda_device)
    st = cat.fast_staging
    kw = dict(grav=cat.grav, kepler_iters=iters)
    for t in (_dense_grid(cat, cuda_device),
              torch.linspace(-250.0, 2000.0, 9, dtype=torch.float64,
                             device=cuda_device)[:, None].contiguous()):
        before = dict(cuda_sgp4.LAUNCHES)
        r, v, e = cuda_sgp4.propagate_fast_dense(t, st.spine, st.tail,
                                                 st.flags, **kw)
        r0, v0, _ = cuda_sgp4.propagate_fast_dense(t, st.spine, st.tail,
                                                   st.flags, want_vel=False,
                                                   **kw)
        grids, tail, flags = cuda_sgp4.spine_grids(cat.els, t)
        g = cuda_sgp4.propagate_fast_spine_grids(grids, tail, flags, **kw)
        torch.cuda.synchronize()
        assert cuda_sgp4.LAUNCHES["sgp4_shallow_dense"] == \
            before["sgp4_shallow_dense"] + 2
        assert cuda_sgp4.LAUNCHES["sgp4_shallow_grids"] == \
            before["sgp4_shallow_grids"] + 1
        assert cuda_sgp4.LAUNCHES["sgp4_spine_grids"] == \
            before["sgp4_spine_grids"] + 1
        rr, vr, er = cuda_sgp4.propagate_fast_dense_reference(
            t, st.spine, st.tail, st.flags, **kw)
        assert torch.equal(e, er) and v0 is None
        assert 1 in set(torch.unique(e).tolist())
        assert torch.equal(r, rr) and torch.equal(v, vr)
        assert torch.equal(r, r0)
        assert all(torch.equal(a, b) for a, b in zip(g, (r, v, e)))


@pytest.mark.cuda
def test_dense_kernel_equals_k1_on_cuda(cuda_device):
    """K5 on tsince = t_time - t_sat gives K1's planes bit for bit, and
    ``ops.propagate_fast(deep=None)`` launches K5 once."""
    cat = build_catalog(synthetic_leo_text(), device=cuda_device)
    st = cat.fast_staging
    t_time = torch.linspace(-250.0, 2000.0, 9, dtype=torch.float64,
                            device=cuda_device)
    kw = dict(grav=cat.grav, kepler_iters=cat.kepler_iters)
    k1 = cuda_sgp4.propagate_fast_sep(t_time, st.t_sat, st.spine, st.tail,
                                      st.flags, **kw)
    tsince = (t_time[:, None] - st.t_sat[None, :]).contiguous()
    k5 = cuda_sgp4.propagate_fast_dense(tsince, st.spine, st.tail, st.flags,
                                        **kw)
    assert all(torch.equal(a, b) for a, b in zip(k1, k5))
    before = cuda_sgp4.LAUNCHES["sgp4_shallow_dense"]
    r, v, e = propagate_fast(cat.els, None, tsince, cat.grav,
                             kepler_iters=cat.kepler_iters)
    torch.cuda.synchronize()
    assert cuda_sgp4.LAUNCHES["sgp4_shallow_dense"] == before + 1
    assert torch.equal(r, k5[0].permute(1, 2, 0))


def test_merge_maps_from_deep_slot():
    """K3's column maps derived from ``deep_slot`` equal the ones a
    catalog stages, and a map that leaves a deep slot without a column
    (or gives one two) raises."""
    cat = _mixed_catalog("cpu")
    ds = cat.fast_staging.deep
    assert ds.maps.slot is ds.slot
    slot, near_cols, deep_cols = cuda_sgp4.merge_maps(ds.slot, cat.n_deep)
    assert slot is ds.slot
    assert near_cols.dtype == deep_cols.dtype == torch.int32
    assert torch.equal(near_cols, ds.maps.near_cols)
    assert torch.equal(deep_cols, ds.maps.deep_cols)
    assert torch.equal(deep_cols.long(),
                       torch.as_tensor(cat.deep_idx, dtype=torch.long))
    assert len(near_cols) + len(deep_cols) == len(cat)
    bad = ds.slot.clone()
    bad[cat.deep_idx[0]] = 1 if cat.n_deep > 1 else -1
    with pytest.raises(ValueError, match="exactly one column"):
        cuda_sgp4.merge_maps(bad, cat.n_deep)


def test_merge_maps_of_another_deep_slot_raise():
    """K3 takes column maps only with the ``deep_slot`` tensor they were
    made from: maps of an equal copy, or of another catalog's map, raise
    before anything runs."""
    cat = _mixed_catalog("cpu")
    st, ds = cat.fast_staging, cat.fast_staging.deep
    t = torch.linspace(0.0, 90.0, 4, dtype=torch.float64)
    dr = torch.zeros((3, len(t), cat.n_deep))
    de = torch.zeros((len(t), cat.n_deep), dtype=torch.int32)
    args = (t, st.t_sat, st.spine, st.tail, st.flags, ds.slot, dr, dr, de)
    kw = dict(grav=cat.grav, kepler_iters=cat.kepler_iters)
    r, _, e = cuda_sgp4.propagate_fast_sep_merge(*args, **kw, maps=ds.maps)
    assert torch.equal(e[:, cat.deep_idx], de)
    copy = cuda_sgp4.merge_maps(ds.slot.clone(), cat.n_deep)
    shifted = ds.slot.roll(1)
    for maps in (copy, cuda_sgp4.merge_maps(shifted, cat.n_deep)):
        with pytest.raises(ValueError, match="another deep_slot"):
            cuda_sgp4.propagate_fast_sep_merge(*args, **kw, maps=maps)


def test_cpu_runs_no_kernel():
    """On CPU tensors every wrapper runs its plain version and counts no
    launch, and the f64 path launches nothing."""
    before = dict(cuda_sgp4.LAUNCHES), dict(cuda_screen.LAUNCHES)
    cat = build_catalog(synthetic_leo_text(16) + "\n"
                        + synthetic_deep_text(6), device="cpu")
    st = cat.fast_staging
    near = build_catalog(synthetic_leo_text(16), device="cpu")
    t = torch.linspace(-100.0, 100.0, 5, dtype=torch.float64)
    kw = dict(grav=cat.grav, kepler_iters=3)
    cuda_sgp4.propagate_fast_sep(t, st.t_sat, st.spine, st.tail, st.flags,
                                 **kw)
    cuda_sgp4.propagate_fast_fused(cat.els, t[:, None].contiguous(),
                                   cat.grav, kepler_iters=3)
    cuda_sgp4.propagate_fast_grids(cat.els, t[:, None].contiguous(),
                                   cat.grav, kepler_iters=3)
    cuda_sgp4.spine_f64_grids(t[:, None].contiguous(), st.spine)
    propagate_fast(near.els, None, t[:, None], near.grav)
    jd = cat.epoch_min_jd + np.linspace(0.0, 0.5, 4)
    for method in ("fast", "f64"):
        propagate(cat, jd, method=method)
    screen_all(near, jd, threshold_km=50.0)
    from astroz_tpu_torch.parallel import make_mesh
    from astroz_tpu_torch.screening import screen_all_ring
    screen_all_ring(near, jd, threshold_km=50.0, mesh=make_mesh(["cpu"] * 2))
    assert (dict(cuda_sgp4.LAUNCHES), dict(cuda_screen.LAUNCHES)) == before


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [3, 8])
def test_dense_time_major_matches_planes_on_cuda(cuda_device, iters):
    """K5's time-major store (``propagate_fast_fused``) gives the (T, S,
    3) layout of its planes bit for bit, contiguous, with and without
    velocities, on a dense grid and on a (T, 1) column."""
    cat = build_catalog(synthetic_leo_text(), device=cuda_device)
    st = cat.fast_staging
    kw = dict(grav=cat.grav, kepler_iters=iters)
    for t in (_dense_grid(cat, cuda_device),
              torch.linspace(-250.0, 2000.0, 9, dtype=torch.float64,
                             device=cuda_device)[:, None].contiguous()):
        planes = cuda_sgp4.propagate_fast_dense(t, st.spine, st.tail,
                                                st.flags, **kw)
        before = cuda_sgp4.LAUNCHES["sgp4_shallow_dense"]
        r, v, e = cuda_sgp4.propagate_fast_fused(cat.els, t, cat.grav,
                                                 kepler_iters=iters)
        r0, v0, e0 = cuda_sgp4.propagate_fast_fused(
            cat.els, t, cat.grav, kepler_iters=iters, want_vel=False)
        torch.cuda.synchronize()
        assert cuda_sgp4.LAUNCHES["sgp4_shallow_dense"] == before + 2
        ref = cuda_sgp4._time_major(*planes)
        assert r.is_contiguous() and v.is_contiguous() and v0 is None
        assert torch.equal(r, ref[0]) and torch.equal(v, ref[1])
        assert torch.equal(e, ref[2]) and torch.equal(e0, ref[2])
        assert torch.equal(r0, ref[0])


@pytest.mark.cuda
def test_persistent_kernels_match_twins_in_a_partial_wave_on_cuda(
        cuda_device):
    """K5 and K2 at ragged shapes small enough that their persistent grid
    is a part of one wave: bit-equal to their plain versions."""
    cat = _mixed_catalog(cuda_device)
    near = build_catalog(synthetic_leo_text(45), device=cuda_device)
    st = near.fast_staging
    gen = torch.Generator().manual_seed(9)
    t = ((torch.rand((7, 45), generator=gen, dtype=torch.float64) - 0.5)
         * 2880.0).to(cuda_device)
    kw = dict(grav=near.grav, kepler_iters=near.kepler_iters)
    grid = cuda_sgp4.launch_grid("sgp4_shallow_dense", 7, 45,
                                 kepler_iters=near.kepler_iters)
    assert grid["waves"] < 1.0 and grid["blocks"] >= 1
    got = cuda_sgp4.propagate_fast_dense(t, st.spine, st.tail, st.flags,
                                         **kw)
    ref = cuda_sgp4.propagate_fast_dense_reference(t, st.spine, st.tail,
                                                   st.flags, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    ds = cat.fast_staging.deep
    t_time = torch.linspace(0.0, 2880.0, 5, dtype=torch.float64,
                            device=cuda_device)
    dargs = (t_time, ds.t_sat, ds.spine, ds.tail, ds.flags,
             cat.resonance_tables(8))
    dkw = dict(grav=cat.grav, kepler_iters=cat.deep_kepler_iters)
    grid = cuda_sgp4.launch_grid("sgp4_deep", 5, cat.n_deep,
                                 kepler_iters=cat.deep_kepler_iters)
    assert grid["waves"] < 1.0 and grid["blocks"] >= 1
    got = cuda_sgp4.propagate_deep_sep(*dargs, **dkw)
    ref = cuda_sgp4.propagate_deep_sep_reference(*dargs, **dkw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def _spine_times(cat, device, form):
    """-1 .. +1 year: a (41, S) grid of minutes since each epoch, or a
    (41, 1) column (the reduction mod 2pi at quotients up to ~2^13)."""
    base = torch.linspace(-525600.0, 525600.0, 41, dtype=torch.float64,
                          device=device)[:, None]
    if form == "column":
        return base.contiguous()
    return (base - cat.fast_staging.t_sat[None, :]).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["dense", "column"])
def test_spine_kernel_matches_twin_on_cuda(cuda_device, form):
    """The spine kernel against its plain version over -1 .. +1 year, on
    a (T, S) tsince and on a (T, 1) column: the six grids bit-equal,
    contiguous (T, S) f32, one launch."""
    cat = build_catalog(synthetic_leo_text(), device=cuda_device)
    spine = cat.fast_staging.spine
    t = _spine_times(cat, cuda_device, form)
    before = cuda_sgp4.LAUNCHES["sgp4_spine_grids"]
    got = cuda_sgp4.spine_f64_grids(t, spine)
    torch.cuda.synchronize()
    assert cuda_sgp4.LAUNCHES["sgp4_spine_grids"] == before + 1
    ref = cuda_sgp4.spine_f64_grids_reference(t, spine)
    assert all(g.shape == (41, len(cat)) and g.dtype == torch.float32
               and g.is_contiguous() for g in got)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [3, 8])
def test_grids_kernel_stores_match_twin_on_cuda(cuda_device, iters):
    """K6 in both stores, the (3, T, S) planes and the time-major (T, S,
    3) r and v, against its plain version on the ragged shapes of
    ``test_dense_kernels_match_twins_on_cuda`` and on a 7 x 45 grid that
    is part of one wave: bit-equal, with and without velocities."""
    cat = build_catalog(synthetic_leo_text(), device=cuda_device)
    near = build_catalog(synthetic_leo_text(45), device=cuda_device)
    gen = torch.Generator().manual_seed(9)
    small = ((torch.rand((7, 45), generator=gen, dtype=torch.float64) - 0.5)
             * 2880.0).to(cuda_device)
    grid = cuda_sgp4.launch_grid("sgp4_shallow_grids", 7, 45,
                                 kepler_iters=iters)
    assert grid["waves"] < 1.0 and grid["blocks"] >= 1
    for c, t in ((cat, _dense_grid(cat, cuda_device)),
                 (cat, torch.linspace(-250.0, 2000.0, 9, dtype=torch.float64,
                                      device=cuda_device)[:, None]),
                 (near, small)):
        grids, tail, flags = cuda_sgp4.spine_grids(c.els, t)
        for want_vel in (True, False):
            kw = dict(grav=c.grav, kepler_iters=iters, want_vel=want_vel)
            before = cuda_sgp4.LAUNCHES["sgp4_shallow_grids"]
            planes = cuda_sgp4.propagate_fast_spine_grids(grids, tail, flags,
                                                          **kw)
            tm = cuda_sgp4._grids_tail(grids, tail, flags, c.grav, iters,
                                       want_vel, time_major=True)
            torch.cuda.synchronize()
            assert cuda_sgp4.LAUNCHES["sgp4_shallow_grids"] == before + 2
            ref = cuda_sgp4.propagate_fast_spine_grids_reference(
                grids, tail, flags, **kw)
            assert all(a is b is None or torch.equal(a, b)
                       for a, b in zip(planes, ref))
            ref_tm = cuda_sgp4._time_major(*ref)
            assert tm[0].is_contiguous() and tm[0].shape == ref_tm[0].shape
            assert all(a is b is None or torch.equal(a, b)
                       for a, b in zip(tm, ref_tm))


@pytest.mark.cuda
@pytest.mark.parametrize("want_vel", [True, False])
def test_grids_path_equals_fused_on_cuda(cuda_device, want_vel):
    """``propagate_fast_grids`` (the spine kernel, then K6 into the
    time-major layout) equals ``propagate_fast_fused`` (K5) and its own
    plain version bit for bit, on a dense grid and on a (T, 1) column;
    each call launches the spine kernel once and K6 once, and nothing
    else."""
    cat = build_catalog(synthetic_leo_text(), device=cuda_device)
    kw = dict(kepler_iters=cat.kepler_iters, want_vel=want_vel)
    for t in (_dense_grid(cat, cuda_device),
              torch.linspace(-250.0, 2000.0, 9, dtype=torch.float64,
                             device=cuda_device)[:, None]):
        fused = cuda_sgp4.propagate_fast_fused(cat.els, t, cat.grav, **kw)
        before = dict(cuda_sgp4.LAUNCHES)
        got = cuda_sgp4.propagate_fast_grids(cat.els, t, cat.grav, **kw)
        again = cuda_sgp4.propagate_fast_grids(cat.els, t, cat.grav, **kw)
        torch.cuda.synchronize()
        moved = {k: n - before[k] for k, n in cuda_sgp4.LAUNCHES.items()
                 if n != before[k]}
        assert moved == {"sgp4_spine_grids": 2, "sgp4_shallow_grids": 2}
        plain = cuda_sgp4.propagate_fast_grids_reference(cat.els, t,
                                                         cat.grav, **kw)
        for out in (got, again):
            assert out[0].is_contiguous()
            assert all(a is b is None or torch.equal(a, b)
                       for a, b in zip(out, fused))
            assert all(a is b is None or torch.equal(a, b)
                       for a, b in zip(out, plain))


def _tle_pairs(text):
    """The (line 1, line 2) pairs of 2- or 3-line TLE text."""
    lines = [ln for ln in text.splitlines() if ln[:2] in ("1 ", "2 ")]
    return list(zip(lines[0::2], lines[1::2]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["near", "mixed"])
def test_satrec_array_equals_propagate_on_cuda(cuda_device, kind):
    """``SatrecArray.sgp4`` of CUDA satrecs is ``propagate(fast,
    sat_major)`` cast to f64, bit for bit, with one launch of K1 (a
    near-earth array) or of K2 and K3 (a mixed one) a call;
    ``sgp4_into`` writes the same into the caller's buffers."""
    from astroz_tpu_torch.api import Satrec, SatrecArray
    text = synthetic_leo_text()
    if kind == "mixed":
        text += "\n" + synthetic_deep_text()
    arr = SatrecArray([Satrec.twoline2rv(l1, l2, device=cuda_device)
                       for l1, l2 in _tle_pairs(text)])
    cat = build_catalog(text, device=cuda_device)
    jd = np.full(9, 2460310.5)
    fr = np.linspace(-0.2, 1.4, 9)
    before = dict(cuda_sgp4.LAUNCHES)
    e, r, v = arr.sgp4(jd, fr)
    torch.cuda.synchronize()
    moved = {k: n - before[k] for k, n in cuda_sgp4.LAUNCHES.items()
             if n != before[k]}
    assert moved == ({"sgp4_shallow": 1} if kind == "near" else
                     {"sgp4_deep": 1, "sgp4_shallow_merge": 1})
    rw, vw, ew = propagate(cat, jd, fr, method="fast", layout="sat_major")
    assert r.dtype == v.dtype == np.float64 and r.shape == (len(cat), 9, 3)
    np.testing.assert_array_equal(e, ew.cpu().numpy())
    np.testing.assert_array_equal(r, rw.double().cpu().numpy())
    np.testing.assert_array_equal(v, vw.double().cpu().numpy())
    assert (e == 0).any() and (e != 0).any()
    r_out, v_out = np.empty_like(r), np.empty_like(v)
    e_out = np.empty_like(e)
    arr.sgp4_into(jd, fr, r_out, v_out, e_out)
    np.testing.assert_array_equal(r_out, r)
    np.testing.assert_array_equal(v_out, v)
    np.testing.assert_array_equal(e_out, e)


@pytest.mark.cuda
def test_init_entry_points_on_cuda(cuda_device):
    """``ops.sgp4_init`` / ``ops.sdp4_init`` put arrays on the card by
    default, equal to the host init; tensors elsewhere raise."""
    from astroz_tpu_torch.constants import WGS72
    from astroz_tpu_torch.ops import sdp4_init, sgp4_init
    from astroz_tpu_torch.ops.sdp4 import sdp4_init_np
    from astroz_tpu_torch.ops.sgp4 import sgp4_init_np
    from astroz_tpu_torch.tle import TleArrays, iter_tles
    text = synthetic_leo_text(8) + "\n" + synthetic_deep_text()
    a = TleArrays.from_tles(list(iter_tles(text)))
    kw = dict(no_kozai=a.no_kozai, ecco=a.ecco, inclo=a.inclo,
              nodeo=a.nodeo, argpo=a.argpo, mo=a.mo, bstar=a.bstar,
              epoch_jd=a.epoch_jd)
    els = sgp4_init(WGS72, **kw)
    deep = sdp4_init(WGS72, els)
    want = sgp4_init_np(WGS72, **kw)
    want_deep = sdp4_init_np(WGS72, want)
    for got, ref in ((els, want), (deep, want_deep)):
        for x, y in zip(got, ref):
            assert x.device.type == "cuda"
            np.testing.assert_array_equal(x.cpu().numpy(), np.asarray(y))
    with pytest.raises(ValueError, match="cpu"):
        sgp4_init(WGS72, **{k: torch.as_tensor(v) for k, v in kw.items()})
    on_card = sgp4_init(WGS72, **{k: torch.as_tensor(v, device=cuda_device)
                                  for k, v in kw.items()})
    assert all(torch.equal(x, y) for x, y in zip(on_card, els))


@pytest.mark.cuda
def test_time_as_lanes_on_cuda(cuda_device, monkeypatch):
    """``Satrec.sgp4_array`` from ``_LANES_MIN_TIMES`` times on (here
    4,096) runs the f64 propagators on the card, within 2e-6 km of the
    native small path
    (``tests/test_api.py``'s gate and TLE: its epoch JD, 2460311.0, is
    exact in f64; the time-as-lanes path, as the JAX package's, measures
    minutes from the f64 epoch JD, whose rounding elsewhere moves a LEO
    point by up to ~1.5e-4 km)."""
    from astroz_tpu_torch import api
    from astroz_tpu_torch.api import Satrec
    monkeypatch.setattr(api, "_LANES_MIN_TIMES", {False: 4096, True: 4096})
    traj = ("1 25544U 98067A   24001.50000000  .00016717  00000-0  10270-3 0"
            "  9993",
            "2 25544  51.6400 200.0000 0001234  90.0000 270.0000 "
            "15.50000000000017")
    sat = Satrec.twoline2rv(*traj, device=cuda_device)
    n = 5000
    jd = np.full(n, sat.jdsatepoch)
    fr = sat.jdsatepochF + np.linspace(0.0, 1.0, n)
    e, r, v = sat.sgp4_array(jd, fr)
    assert sat._cat is not None and sat._cat.device.type == "cuda"
    assert r.shape == (n, 3) and np.all(e == 0)
    e2, r2, v2 = sat.sgp4_array(jd[::100], fr[::100])
    np.testing.assert_allclose(r[::100], r2, rtol=0, atol=2e-6)


@pytest.mark.cuda
def test_propagate_fn_vmap_on_cuda(cuda_device):
    """``create_sgp4_propagator``'s function on the card: under
    ``torch.func.vmap`` it equals the loop, near-earth and deep with
    ``max_steps``."""
    from astroz_tpu_torch.api import create_sgp4_propagator
    for text, kw in ((synthetic_leo_text(3, decaying=False), {}),
                     (synthetic_deep_text(3, failing=False),
                      {"max_steps": 5})):
        l1, l2 = _tle_pairs(text)[-1]
        params, fn = create_sgp4_propagator(l1, l2, device=cuda_device)
        t = torch.linspace(-2000.0, 3000.0, 6, dtype=torch.float64,
                           device=cuda_device)
        r, v = torch.func.vmap(lambda x: fn(params, x, **kw))(t)
        assert r.device.type == "cuda"
        for k in range(len(t)):
            rk, vk = fn(params, t[k])
            assert torch.equal(r[k], rk) and torch.equal(v[k], vk)


def _circular_lanes(n, seed=0):
    """``n`` states around a 550 km circular orbit: 1 km and 1 m/s of
    numpy noise."""
    from astroz_tpu_torch.constants import EARTH
    r = EARTH.eq_radius + 550.0
    vc = np.sqrt(EARTH.mu / r)
    base = np.array([r, 0.0, 0.0, 0.0, vc * np.cos(0.9), vc * np.sin(0.9)])
    noise = np.random.default_rng(seed).normal(
        0.0, [1.0, 1.0, 1.0, 1e-3, 1e-3, 1e-3], (n, 6))
    return base + noise


@pytest.mark.cuda
def test_propagate_fixed_on_cuda_matches_cpu(cuda_device):
    """RK4 ``propagate_fixed`` of TwoBody + J2 + Drag over one orbit at
    30 s on the card against the same call on the CPU: 1e-6 km; the
    card's loop reads nothing back to the host."""
    from astroz_tpu_torch.propagators import (Composite, Drag, J2, TwoBody,
                                              propagate_fixed)
    accel = Composite([TwoBody(), J2(), Drag()])
    lanes = _circular_lanes(256)
    state = torch.as_tensor(lanes, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t, card = propagate_fixed(accel, state, 0.0, 5400.0, 30.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    t_host, host = propagate_fixed(accel, lanes, 0.0, 5400.0, 30.0,
                                   device="cpu")
    assert card.device.type == "cuda" and card.dtype == torch.float64
    assert card.shape == (181, 256, 6)
    np.testing.assert_array_equal(t, t_host)
    assert float((card.cpu() - host)[..., :3].abs().max()) <= 1e-6


@pytest.mark.cuda
def test_dp87_adaptive_on_cuda_matches_cpu(cuda_device):
    """One adaptive DP8(7) call of TwoBody + J2 over 3 h on the card
    against the CPU: the same substep count, 1e-6 km."""
    from astroz_tpu_torch.propagators import (Composite, J2, TwoBody,
                                              dp87_adaptive, make_deriv)
    deriv = make_deriv(Composite([TwoBody(), J2()]))
    state = _circular_lanes(1)[0]
    card, h, n = dp87_adaptive(deriv, state, 0.0, 10800.0, rtol=1e-10)
    host, h_host, n_host = dp87_adaptive(deriv, state, 0.0, 10800.0,
                                         rtol=1e-10, device="cpu")
    assert card.device.type == "cuda" and card.dtype == torch.float64
    assert n == n_host > 10
    assert float((card.cpu() - host)[:3].abs().max()) <= 1e-6
