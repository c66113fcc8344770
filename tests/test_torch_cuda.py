"""Kernels K1 to K6 on the card against their plain torch versions, and a
small all-vs-all screen on the card against the same call on the CPU
(marked ``cuda``; skips where ``torch.cuda.is_available()`` is False);
and, on the CPU, that no wrapper counts a launch there.

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
    """Error codes identical, positions within 1e-3 km, velocities
    within 1e-6 km/s, and the kernel's positions bit-equal with and
    without velocities, over -250 .. +2000 minutes from the earliest
    epoch (ragged shapes: 64 satellites x 9 times)."""
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
    assert (r - rr).abs().max().item() <= 1e-3
    assert (v - vr).abs().max().item() <= 1e-6
    assert torch.equal(r, r0)


def _mixed_catalog(device):
    return build_catalog(synthetic_leo_text() + "\n"
                         + synthetic_deep_text(), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [6, 8])
def test_deep_kernel_matches_twin_on_cuda(cuda_device, iters):
    """K2 against its plain version over -1 .. +1 day around the deep
    epochs: error codes identical, positions within 1e-3 km, velocities
    within 1e-6 km/s, positions bit-equal with and without velocities."""
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
    assert (r - rr).abs().max().item() <= 1e-3
    assert (v - vr).abs().max().item() <= 1e-6
    assert torch.equal(r, r0)


@pytest.mark.cuda
@pytest.mark.parametrize("want_vel", [True, False])
def test_merge_kernel_matches_twin_on_cuda(cuda_device, want_vel):
    """K3 against its plain version: the deep columns equal K2's planes
    bit for bit (NaN planted in their shallow fields does not leak), the
    rest K1's plain version within 1e-3 km."""
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
    r, v, e = cuda_sgp4.propagate_fast_sep_merge(*args, **kw)
    torch.cuda.synchronize()
    assert cuda_sgp4.LAUNCHES["sgp4_shallow_merge"] == before + 1
    rr, vr, er = cuda_sgp4.propagate_fast_sep_merge_reference(*args, **kw)
    assert torch.isfinite(r).all() and torch.equal(e, er)
    assert v is None or torch.isfinite(v).all()
    assert torch.equal(r[:, :, cols], dr) and torch.equal(e[:, cols], de)
    assert (r - rr).abs().max().item() <= 1e-3
    if want_vel:
        assert torch.equal(v[:, :, cols], dv)
        assert (v - vr).abs().max().item() <= 1e-6
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
    """K5 on a dense grid and on a (T, 1) column, and K6 on the port's
    spine grids, against their plain versions: error codes identical,
    positions within 1e-3 km, velocities within 1e-6 km/s; positions
    bit-equal with and without velocities; K6 equals K5 bit for bit."""
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
        rr, vr, er = cuda_sgp4.propagate_fast_dense_reference(
            t, st.spine, st.tail, st.flags, **kw)
        assert torch.equal(e, er) and v0 is None
        assert 1 in set(torch.unique(e).tolist())
        assert (r - rr).abs().max().item() <= 1e-3
        assert (v - vr).abs().max().item() <= 1e-6
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
    propagate_fast(near.els, None, t[:, None], near.grav)
    jd = cat.epoch_min_jd + np.linspace(0.0, 0.5, 4)
    for method in ("fast", "f64"):
        propagate(cat, jd, method=method)
    screen_all(near, jd, threshold_km=50.0)
    assert (dict(cuda_sgp4.LAUNCHES), dict(cuda_screen.LAUNCHES)) == before
