"""Kernels K1 to K6 (K4 in its three modes), the spine kernel, the f64
kernel (its DENSE and ESCAPE modes, and the scan on DENSE), the epilogue
kernel and TABLES on the card against their plain torch versions, a
small all-vs-all screen on the card against the same call on the CPU,
and the multi-device paths on a mesh of the card repeated against the
single-device ones (marked ``cuda``; skips where
``torch.cuda.is_available()`` is False); and, on the CPU, that no
wrapper counts a launch there.

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

``synthetic_leo_text``, ``synthetic_deep_text``, ``geodetic_early_exit``
(the epilogue kernel's end of the latitude iteration in torch),
``GEODETIC_PLANTS`` and ``_same_bits`` are shared with the other
``test_torch_*`` files.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from astroz_tpu_torch import build_catalog, propagate, screen_all
from astroz_tpu_torch.ops import (cuda_finalize, cuda_screen, cuda_sgp4,
                                  fast, propagate_fast, sdp4_propagate_scan)
from astroz_tpu_torch.screening import _positions_planes_f32
from astroz_tpu_torch.tle import format_lines

torch.set_num_threads(1)


def synthetic_leo_text(n: int = 64, seed: int = 7,
                       decaying: bool = True,
                       spread_days: float = 2.0) -> str:
    """3-line text of ``n`` random near-earth satellites (rev/day 12-16,
    e up to 0.02, epochs spread over +-``spread_days`` around JD
    2460310.5), of
    which the first is a low-perigee lane on simplified drag and, with
    ``decaying``, the second decays (error 6, then error 1) from the
    earliest epoch, JD 2460308.5."""
    rng = np.random.default_rng(seed)
    rev = rng.uniform(12.0, 16.0, n)
    ecc = rng.uniform(1e-4, 0.02, n)
    inc = rng.uniform(17.0, 103.0, n)
    ang = rng.uniform(0.0, 360.0, (3, n))
    bstar = rng.uniform(-1e-4, 1e-3, n)
    epoch = 2460310.5 + rng.uniform(-spread_days, spread_days, n)
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
                        failing: bool = True,
                        spread_days: float = 2.0) -> str:
    """3-line text of ``n`` random deep-space satellites, epochs spread
    over +-``spread_days`` around JD 2460310.5: GEO lanes (rev/day ~1.0027,
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
    epoch = 2460310.5 + rng.uniform(-spread_days, spread_days, n)
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


def _f64_grid(cat, device, form):
    """Minutes since epoch of both signs across several 720-minute steps:
    a (T, 1) column, a dense (T, S) grid, or a (T, 7) grid for one lane."""
    col = torch.linspace(-3100.0, 3700.0, 11, dtype=torch.float64)[:, None]
    gen = torch.Generator().manual_seed(3)
    width = {"column": 1, "dense": len(cat), "fold": 7}[form]
    jitter = torch.rand((11, width), generator=gen, dtype=torch.float64)
    grid = col if form == "column" else col + (jitter - 0.5) * 1800.0
    return grid.to(device)


def _outputs_equal(got, ref):
    return all(a is b is None or _same_or_both_nan(a, b)
               for a, b in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["column", "dense", "fold"])
@pytest.mark.parametrize("kind", ["mixed", "near"])
def test_f64_dense_matches_plain_on_cuda(cuda_device, kind, form):
    """The f64 kernel's DENSE mode against its plain version
    (``sdp4_propagate`` on a catalog with deep lanes, ``sgp4_propagate``
    on a near-earth one): positions, velocities and error codes bit-equal,
    positions and codes bit-equal without velocities, one launch a call;
    ``fold`` is one lane against a grid, as the API's time as lanes."""
    cat = (_mixed_catalog(cuda_device) if kind == "mixed"
           else build_catalog(synthetic_leo_text(), device=cuda_device))
    if form == "fold":
        cat = build_catalog("\n".join(
            (synthetic_deep_text(3) if kind == "mixed"
             else synthetic_leo_text(3)).splitlines()[6:9]),
            device=cuda_device)
    st = cat.f64_staging
    t = _f64_grid(cat, cuda_device, form)
    kw = dict(grav=cat.grav, sdp4=cat.deep is not None)
    before = cuda_sgp4.LAUNCHES["sgp4_f64_dense"]
    got = cuda_sgp4.sgp4_f64_dense(t, *st, **kw)
    r0, v0, e0 = cuda_sgp4.sgp4_f64_dense(t, *st, **kw, want_vel=False)
    torch.cuda.synchronize()
    assert cuda_sgp4.LAUNCHES["sgp4_f64_dense"] == before + 2
    ref = cuda_sgp4.sgp4_f64_dense_reference(t, *st, **kw)
    assert tuple(got[0].shape) == tuple(ref[0].shape) and v0 is None
    assert _outputs_equal(got, ref)
    assert torch.equal(e0, ref[2]) and _same_or_both_nan(r0, ref[0])
    if form != "fold":
        assert (got[2] != 0).any() and (got[2] == 0).any()


def _epoch_case(device, case):
    """A catalog and a sweep's (T,) jd and fr rows on the card: ``spread``
    the mixed catalog with epochs over +-7 days x 301 epochs (not a
    multiple of 32) over -3 .. +4 days, whole days in jd; ``near`` a
    near-earth catalog x the same; ``one`` the mixed catalog at T = 1;
    ``lane`` a one-lane catalog (a GEO lane, SDP4) x the same 301."""
    if case in ("spread", "one"):
        text = (synthetic_leo_text(spread_days=7.0) + "\n"
                + synthetic_deep_text(spread_days=7.0))
    elif case == "near":
        text = synthetic_leo_text(spread_days=7.0)
    else:
        text = "\n".join(synthetic_deep_text(3).splitlines()[6:9])
    x = np.linspace(-3.0, 4.0, 301)
    if case == "one":
        x = x[150:151]
    jd = torch.as_tensor(2460310.5 + np.floor(x), device=device)
    fr = torch.as_tensor(x - np.floor(x), device=device)
    return build_catalog(text, device=device), jd, fr


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["spread", "near", "one", "lane"])
def test_f64_dense_epochs_matches_grid_on_cuda(cuda_device, case):
    """DENSE on a sweep's jd and fr rows gives, bit for bit, DENSE's
    outputs on the tsince grid that torch forms on the card from the same
    rows (and its plain version's), with and without velocities; one
    launch a call, counted under both counters."""
    cat, jd, fr = _epoch_case(cuda_device, case)
    st = cat.f64_staging
    kw = dict(grav=cat.grav, sdp4=cat.deep is not None)
    tsince = ((jd[:, None] - cat.els.epoch_jd[None, :]) + fr[:, None]) \
        * 1440.0
    before = dict(cuda_sgp4.LAUNCHES)
    got = cuda_sgp4.sgp4_f64_dense_epochs(jd, fr, *st, **kw)
    r0, v0, e0 = cuda_sgp4.sgp4_f64_dense_epochs(jd, fr, *st, **kw,
                                                 want_vel=False)
    torch.cuda.synchronize()
    moved = {k: n - before[k] for k, n in cuda_sgp4.LAUNCHES.items()
             if n != before[k]}
    assert moved == {"sgp4_f64_dense": 2, "sgp4_f64_dense_epochs": 2}
    grid = cuda_sgp4.sgp4_f64_dense(tsince, *st, **kw)
    ref = cuda_sgp4.sgp4_f64_dense_reference(tsince, *st, **kw)
    assert tuple(got[0].shape) == (len(jd), len(cat), 3) and v0 is None
    assert _outputs_equal(got, grid) and _outputs_equal(got, ref)
    assert torch.equal(e0, grid[2]) and _same_or_both_nan(r0, grid[0])


def sweep_kernel_names():
    """The card's kernels, by name, under ``torch.profiler`` in an f64
    TEME time-major sweep of ``_epoch_case``'s spread mixed catalog (the
    second sweep: the first builds and stages); copies left out."""
    from torch.profiler import ProfilerActivity, profile

    cat, jd, fr = _epoch_case(torch.device("cuda"), "spread")
    jd_h, fr_h = jd.cpu().numpy(), fr.cpu().numpy()
    propagate(cat, jd_h, fr_h)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        propagate(cat, jd_h, fr_h)
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]


@pytest.mark.cuda
def test_f64_sweep_is_one_kernel_on_cuda(cuda_device):
    """Under ``torch.profiler``, an f64 TEME time-major sweep runs one
    kernel on the card, DENSE's row walk, and no torch elementwise kernel
    (the tsince grid is formed inside it). The profiler runs in a child
    process: on the H100 a session that recorded the card's kernels here
    left the later sessions of this process (``test_torch_staging.py``'s)
    without the card's events."""
    here = Path(__file__).resolve().parent
    code = ("import json, sys; sys.path[:0] = sys.argv[1:]; "
            "import test_torch_cuda as t; "
            "print(json.dumps(t.sweep_kernel_names()))")
    child = subprocess.run([sys.executable, "-c", code, str(here.parent),
                            str(here)], capture_output=True, text=True,
                           timeout=600)
    assert child.returncode == 0, child.stderr[-4000:]
    kernels = json.loads(child.stdout.strip().splitlines()[-1])
    assert len(kernels) == 1 and "sgp4_f64_walk_kernel" in kernels[0], \
        kernels


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["forward", "backward"])
def test_f64_scan_matches_plain_on_cuda(cuda_device, order):
    """``propagate(scan_times=True)`` on the mixed catalog, its epochs
    sorted either way across the lanes' epochs, against the plain
    ``sdp4_propagate_scan`` run on the card on ``epoch_tsince``'s grid
    and against ``propagate(scan_times=False)``: bit for bit, with and
    without velocities; one launch of DENSE on the jd and fr rows a
    call."""
    cat = _mixed_catalog(cuda_device)
    x = np.linspace(-2.5, 3.0, 37)
    if order == "backward":
        x = x[::-1].copy()
    jd, fr = 2460310.5 + np.floor(x), x - np.floor(x)
    before = dict(cuda_sgp4.LAUNCHES)
    got = propagate(cat, jd, fr, scan_times=True)
    r0, v0, e0 = propagate(cat, jd, fr, scan_times=True, velocities=False)
    torch.cuda.synchronize()
    moved = {k: n - before[k] for k, n in cuda_sgp4.LAUNCHES.items()
             if n != before[k]}
    assert moved == {"sgp4_f64_dense": 2, "sgp4_f64_dense_epochs": 2}
    t = cuda_sgp4.epoch_tsince(
        *(torch.as_tensor(a, device=cuda_device) for a in (jd, fr)),
        cat.els.epoch_jd)
    ref = sdp4_propagate_scan(cat.els, cat.deep, t, cat.grav)
    assert _outputs_equal(got, ref) and v0 is None
    assert torch.equal(e0, ref[2]) and _same_or_both_nan(r0, ref[0])
    assert _outputs_equal(got, propagate(cat, jd, fr))


def _walk_grid(cat, device, case):
    """Minutes since epoch that the f64 row walk cuts into runs: ``long``
    10,007 rows (a prime, so no run length divides it) from -5,000 to
    +5,000 minutes with a jitter a lane, so that the runs near the middle
    cross epoch; ``backward`` the same rows in descending order; ``one``
    a single row."""
    gen = torch.Generator().manual_seed(5)
    rows = torch.linspace(-5000.0, 5000.0, 10007, dtype=torch.float64)
    jitter = (torch.rand((1, len(cat)), generator=gen, dtype=torch.float64)
              - 0.5) * 600.0
    grid = {"long": rows[:, None], "backward": rows.flip(0)[:, None],
            "one": torch.tensor([[-1234.5]], dtype=torch.float64)}[case]
    return (grid + jitter).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["long", "backward", "one"])
def test_f64_walk_runs_match_plain_on_cuda(cuda_device, case):
    """The f64 kernel's row walk on the mixed catalog where each warp takes
    several rows (runs that do not divide T and cross epoch mid-run, rows
    descending) and at T = 1: DENSE bit-equal to its plain version (r, v,
    codes) and, on the 1,000 rows across epoch in the middle, to the
    plain scan (``sdp4_propagate_scan`` on the card) over them: a scan
    started at any row equals the rest of the whole one
    (``tests/test_torch_f64_kernel.py``), and DENSE gives the scan its
    rows."""
    cat = _mixed_catalog(cuda_device)
    t = _walk_grid(cat, cuda_device, case)
    st = cat.f64_staging
    grid = cuda_sgp4.launch_grid("sgp4_f64_dense", *t.shape, sdp4=True)
    assert case == "one" or (
        -(-len(cat) // 32) * t.shape[0] > 4 * grid["blocks"])
    dense = cuda_sgp4.sgp4_f64_dense(t, *st, grav=cat.grav, sdp4=True)
    torch.cuda.synchronize()
    ref = cuda_sgp4.sgp4_f64_dense_reference(t, *st, grav=cat.grav,
                                             sdp4=True)
    assert _outputs_equal(dense, ref)
    mid = slice(max(t.shape[0] // 2 - 500, 0), t.shape[0] // 2 + 500)
    scan = sdp4_propagate_scan(cat.els, cat.deep, t[mid], cat.grav)
    assert _outputs_equal([x[mid] for x in dense], scan)
    assert (dense[2] == 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("want_vel", [True, False])
def test_f64_escape_matches_plain_on_cuda(cuda_device, want_vel):
    """The f64 kernel's ESCAPE mode writes into K2's planes what its plain
    version writes, bit for bit, and leaves the other columns as K2 wrote
    them, in one launch."""
    from astroz_tpu_torch.propagation import resonance_steps

    cat = _mixed_catalog(cuda_device)
    esc = cat.heo_escape
    assert esc is not None
    ds = cat.fast_staging.deep
    jd = cat.epoch_min_jd + np.linspace(-2.5, 3.0, 13)
    steps = resonance_steps(jd, cat.deep_epochs_jd)
    tables = cat.resonance_tables(steps)
    t = torch.as_tensor((jd - cat.epoch_min_jd) * 1440.0, device=cuda_device)
    planes = cuda_sgp4.propagate_deep_sep(
        t, ds.t_sat, ds.spine, ds.tail, ds.flags, tables, grav=cat.grav,
        kepler_iters=cat.deep_kepler_iters, want_vel=want_vel)
    k2 = [None if x is None else x.clone() for x in planes]
    ref = [None if x is None else x.clone() for x in planes]
    args = (t, esc.t_sat, *esc.staged, esc.idx, tables)
    kw = dict(grav=cat.grav, want_vel=want_vel)
    before = cuda_sgp4.LAUNCHES["sgp4_f64_escape"]
    cuda_sgp4.sgp4_f64_escape(*args, *planes, **kw)
    torch.cuda.synchronize()
    assert cuda_sgp4.LAUNCHES["sgp4_f64_escape"] == before + 1
    cuda_sgp4.sgp4_f64_escape_reference(*args, *ref, **kw)
    assert _outputs_equal(planes, ref)
    other = torch.ones(cat.n_deep, dtype=torch.bool, device=cuda_device)
    other[esc.idx] = False
    assert torch.equal(planes[0][:, :, other], k2[0][:, :, other])
    assert not torch.equal(planes[0][:, :, esc.idx], k2[0][:, :, esc.idx])


@pytest.mark.cuda
def test_f64_paths_launch_the_kernel_once_on_cuda(cuda_device, monkeypatch):
    """On a catalog with escape lanes a fast propagate launches K2, the
    escape and K3 once each (and TABLES, the catalog's first sweep);
    ``propagate(method="f64")`` with and without
    ``scan_times``, ``propagate_tsince`` and ``Satrec.sgp4_array``'s time
    as lanes launch the f64 kernel once each and never integrate the
    resonance on the host; ``propagate(method="f64")``, with and without
    ``scan_times``, hands it the jd and fr rows
    (``"sgp4_f64_dense_epochs"``)."""
    from astroz_tpu_torch import api, propagate_tsince
    from astroz_tpu_torch.ops import sdp4

    def no_host_loop(*args, **kwargs):
        raise AssertionError("integrate_resonance ran")

    monkeypatch.setattr(sdp4, "integrate_resonance", no_host_loop)
    cat = _mixed_catalog(cuda_device)
    assert cat.heo_escape is not None
    jd = cat.epoch_min_jd + np.linspace(0.0, 1.0, 5)
    calls = {
        "fast": (lambda: propagate(cat, jd, method="fast"),
                 {"sgp4_deep": 1, "sgp4_f64_escape": 1,
                  "sgp4_shallow_merge": 1, "resonance_tables": 1}),
        "f64": (lambda: propagate(cat, jd),
                {"sgp4_f64_dense": 1, "sgp4_f64_dense_epochs": 1}),
        "scan": (lambda: propagate(cat, jd, scan_times=True),
                 {"sgp4_f64_dense": 1, "sgp4_f64_dense_epochs": 1}),
        "tsince": (lambda: propagate_tsince(cat, torch.zeros(
            (3, 1), dtype=torch.float64, device=cuda_device)),
            {"sgp4_f64_dense": 1})}
    monkeypatch.setattr(api, "_LANES_MIN_TIMES", {False: 600, True: 600})
    lines = synthetic_deep_text(3).splitlines()
    sat = api.Satrec.twoline2rv(lines[7], lines[8], device=cuda_device)
    jd1 = np.full(700, sat.jdsatepoch)
    calls["lanes"] = (lambda: sat.sgp4_array(jd1, np.linspace(0, 3, 700)),
                      {"sgp4_f64_dense": 1})
    for name, (call, expected) in calls.items():
        before = dict(cuda_sgp4.LAUNCHES)
        call()
        torch.cuda.synchronize()
        moved = {k: n - before[k] for k, n in cuda_sgp4.LAUNCHES.items()
                 if n != before[k]}
        assert moved == expected, name


def geodetic_early_exit(x, y, z, trips=10):
    """``frames.ecef_to_geodetic_xyz`` as the epilogue kernel runs it, in
    plain torch: the latitude iteration of each point stops where lat
    repeats its bit pattern (the next lat is this one: this one ends it;
    the next lat is the one before: the two alternate, and the one the
    ``trips``-th trip would end on ends it), else after ``trips`` trips.
    Every trip runs on the whole tensors, as the plain version's do, so
    that each point's ops are the plain version's on any host. Returns
    ``(lat, lon, alt, stop, cycle)``: ``stop`` the trips taken (next lats
    computed) at each point, ``cycle`` where a two-value cycle ended it."""
    from astroz_tpu_torch.constants import WGS84, WGS84_ECC_SQ

    a = torch.tensor(WGS84.radius_earth_km, dtype=x.dtype, device=x.device)
    e2 = WGS84_ECC_SQ
    ity = torch.int32 if x.dtype == torch.float32 else torch.int64
    lon = torch.atan2(y, x)
    p = torch.sqrt(x * x + y * y)
    p_safe = torch.where(p > 1e-12, p, torch.full_like(p, 1e-12))
    lat = torch.atan2(z, p_safe * (1.0 - e2))
    prev, alt_prev = lat, torch.zeros_like(lat)
    out_lat, out_alt = torch.zeros_like(lat), torch.zeros_like(lat)
    live = torch.ones(lat.shape, dtype=torch.bool, device=x.device)
    stop = torch.full(lat.shape, trips, dtype=torch.int64, device=x.device)
    cycle = torch.zeros_like(live)
    for i in range(trips + 1):
        sin_lat = torch.sin(lat)
        n = a / torch.sqrt(1.0 - e2 * sin_lat * sin_lat)
        alt = p_safe / torch.cos(lat) - n
        if i == trips:
            out_lat = torch.where(live, lat, out_lat)
            out_alt = torch.where(live, alt, out_alt)
            break
        nxt = torch.atan2(z, p_safe * (1.0 - e2 * n / (n + alt)))
        fixed = live & (nxt.view(ity) == lat.view(ity))
        two = live & ~fixed & (nxt.view(ity) == prev.view(ity))
        # the trips left after this one: even ends on nxt (= prev)
        on_next = two if (trips - i - 1) % 2 == 0 else torch.zeros_like(two)
        ends = fixed | two
        out_lat = torch.where(on_next, nxt, torch.where(ends, lat, out_lat))
        out_alt = torch.where(on_next, alt_prev,
                              torch.where(ends, alt, out_alt))
        stop = torch.where(ends, i + 1, stop)
        cycle |= two
        live &= ~ends
        prev, alt_prev, lat = lat, alt, nxt
    return out_lat, lon, out_alt, stop, cycle


def _same_bits(a, b):
    """Equal bit for bit (a signed zero too), NaN where NaN."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    if a.dtype != b.dtype or not torch.equal(nan, torch.isnan(b)):
        return False
    ity = torch.int32 if a.dtype == torch.float32 else torch.int64
    return torch.equal(a.view(ity)[~nan], b.view(ity)[~nan])


#: (row, lane) -> TEME point (km) planted in _sweep_outputs: both poles,
#: the equator with z = +0.0 and -0.0, p under the 1e-12 clamp, GEO and
#: a Molniya apogee (46,000 km at 63.4 deg)
GEODETIC_PLANTS = {
    (5, 11): (0.0, 0.0, 7000.0), (9, 12): (0.0, 0.0, -6800.0),
    (6, 13): (7000.0, 100.0, 0.0), (6, 14): (-6900.0, 50.0, -0.0),
    (7, 15): (1e-13, -1e-13, 6800.0), (7, 16): (1e-13, 1e-13, -7100.0),
    (8, 17): (42164.0 * math.cos(1.0), 42164.0 * math.sin(1.0), 12.0),
    (8, 18): (46000.0 * math.cos(math.radians(63.4)) * math.cos(2.0),
              46000.0 * math.cos(math.radians(63.4)) * math.sin(2.0),
              46000.0 * math.sin(math.radians(63.4)))}


def cycle_points(source, device, jd, n=20000, seed=5):
    """TEME points (k, 3) (numpy f64 for the f64 path, f32 values for the
    fast path) whose ECEF images at Julian date ``jd``, as the plain
    epilogue rotates them on ``device``, end the latitude iteration in a
    two-value cycle there (:func:`geodetic_early_exit`): found among
    ``n`` seeded points at 6,600-42,300 km."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(1, n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    r = u * rng.uniform(6600.0, 42300.0, (1, n, 1))
    if source == "planes":
        r = r.astype(np.float32)
    planes = source == "planes"
    rt = torch.as_tensor(np.ascontiguousarray(
        r.transpose(2, 0, 1)) if planes else r, device=device)
    err = torch.zeros((1, n), dtype=torch.int32, device=device)
    jd_sum = torch.tensor([[jd]], dtype=torch.float64, device=device)
    ecef = cuda_finalize.finalize_reference(
        rt, None, err, jd_sum, source=source, output="ecef",
        layout="planes", velocities=False)[0]
    cycle = geodetic_early_exit(*ecef)[4].reshape(-1).cpu().numpy()
    return r[0, cycle].astype(np.float64)


def _sweep_outputs(source, device, n_times, n_sats=203):
    """Seeded sweep outputs as a sweep hands them to the epilogue (f32
    planes, or f64 time-major), ragged against the kernel's sat_major
    tiles: a lane failing from row 20 (zero-filled, code 6), the points of
    GEODETIC_PLANTS, a NaN, up to 16 points of row 10 that end the
    latitude iteration in a two-value cycle on the card (lanes 100-115),
    jd_sum and a mask of every third lane."""
    rng = np.random.default_rng(23)
    u = rng.normal(size=(n_times, n_sats, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    r = u * rng.uniform(6600.0, 42200.0, (n_times, n_sats, 1))
    v = rng.normal(size=(n_times, n_sats, 3)) * 4.0
    err = np.zeros((n_times, n_sats), np.int32)
    r[20:, 7] = v[20:, 7] = 0.0
    err[20:, 7] = 6
    for (t, s), point in GEODETIC_PLANTS.items():
        r[t, s] = point
    r[3, 40, 1] = float("nan")
    jd_sum = (2460310.5 + np.linspace(-1.0, 2.0, n_times))[:, None]
    cycles = cycle_points(source, device, float(jd_sum[10, 0]))[:16]
    assert len(cycles), "no two-value-cycle point found"
    r[10, 100:100 + len(cycles)] = cycles
    if source == "planes":
        r, v = (np.ascontiguousarray(x.transpose(2, 0, 1), np.float32)
                for x in (r, v))
    mask = np.arange(n_sats) % 3 != 0
    return ([torch.as_tensor(x, device=device) for x in (r, v, err, jd_sum)],
            torch.as_tensor(mask, device=device))


def _finalize_vs_plain(r, v, err, jd_sum, mask, source, output, layout):
    """The epilogue kernel against its plain version, bit for bit (NaN
    where NaN), with and without velocities and the mask: one launch a
    call, none in the identity cases (the sweep's own tensors back)."""
    name = "finalize_f32" if source == "planes" else "finalize_f64"
    for velocities in (True, False):
        for m in (None, mask):
            kw = dict(source=source, output=output, layout=layout,
                      velocities=velocities, mask=m)
            before = cuda_finalize.LAUNCHES[name]
            got = cuda_finalize.finalize(r, v, err, jd_sum, **kw)
            torch.cuda.synchronize()
            identity = cuda_finalize.is_identity(source, output, layout, m)
            assert cuda_finalize.LAUNCHES[name] == before + (not identity)
            want = cuda_finalize.finalize_reference(r, v, err, jd_sum, **kw)
            assert (got[1] is None) == (want[1] is None) == (not velocities)
            for a, b in zip(got, want):
                if b is not None:
                    assert a.shape == b.shape and a.dtype == b.dtype
                    assert _same_bits(a, b), (velocities, m is None)
            if identity:
                assert got[0] is r and got[2] is err


@pytest.mark.cuda
@pytest.mark.parametrize("n_times", [45, 44])
@pytest.mark.parametrize("source", cuda_finalize.SOURCES)
@pytest.mark.parametrize("output", cuda_finalize.OUTPUT_MODES)
@pytest.mark.parametrize("layout", cuda_finalize.LAYOUTS)
def test_finalize_kernel_matches_plain_on_cuda(cuda_device, source, output,
                                               layout, n_times):
    """The epilogue kernel against its plain version (:func:`_finalize_vs_
    plain`) on :func:`_sweep_outputs`, whose planted points reach the
    latitude iteration's early ends, its two-value cycles, both poles,
    signed zeros and the clamp of p. 44 x 203 points (a multiple of 4) take
    the flat walk in whole 16-byte vectors; 45 x 203 end in a partial
    vector, and their planes after the first start off a vector; in
    sat_major, odd n_sats and n_times put odd lanes' runs and rows off
    16 bytes."""
    (r, v, err, jd_sum), mask = _sweep_outputs(source, cuda_device, n_times)
    _finalize_vs_plain(r, v, err, jd_sum, mask, source, output, layout)


@pytest.mark.cuda
@pytest.mark.parametrize("source", cuda_finalize.SOURCES)
@pytest.mark.parametrize("output", cuda_finalize.OUTPUT_MODES)
def test_finalize_tile_walk_matches_plain_on_cuda(cuda_device, source,
                                                  output):
    """sat_major on a sweep of odd n_times and n_sats whose items (whole
    tiles, or fields of tiles) outnumber the persistent grid's blocks and
    are no multiple of them (with and without velocities), so that blocks
    walk different numbers of items and the ring of stages wraps: bit for
    bit against the plain version."""
    dtype = torch.float32 if source == "planes" else torch.float64
    n_times, n_sats = 333, 2001
    while True:
        grids = [cuda_finalize.launch_grid(dtype, n_times, n_sats,
                                           velocities=vel)
                 for vel in (True, False)]
        if all(g["items"] > g["blocks"] and g["items"] % g["blocks"]
               for g in grids):
            break
        n_sats += 2
    (r, v, err, jd_sum), mask = _sweep_outputs(source, cuda_device, n_times,
                                               n_sats)
    _finalize_vs_plain(r, v, err, jd_sum, mask, source, output, "sat_major")


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [4, 8, 64])
def test_resonance_tables_kernel_matches_plain_on_cuda(cuda_device, steps):
    """TABLES against its plain version, bit for bit, on the deep subset
    of a mixed catalog (irez 0, 1 and 2) and on every lane of it (the
    near-earth lanes' coefficients zero), one launch a call."""
    cat = _mixed_catalog(cuda_device)
    assert set(cat.deep_host.irez[cat.deep_idx]) == {0, 1, 2}
    for deep, els in ((cat.deep_sub, cat.els_deep), (cat.deep, cat.els)):
        before = cuda_sgp4.LAUNCHES["resonance_tables"]
        got = cuda_sgp4.resonance_tables(deep, els, steps)
        torch.cuda.synchronize()
        assert cuda_sgp4.LAUNCHES["resonance_tables"] == before + 1
        want = fast.resonance_tables_reference(deep, els, steps)
        assert got.shape == want.shape and torch.equal(got, want)


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
    """K5 on tsince = t_time - t_sat gives K1's planes bit for bit in
    its time-major layout, and ``ops.propagate_fast(deep=None)`` launches
    K5 once."""
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
    assert torch.equal(k5[0], k1[0].permute(1, 2, 0))
    assert torch.equal(k5[1], k1[1].permute(1, 2, 0))
    assert torch.equal(k5[2], k1[2])
    before = cuda_sgp4.LAUNCHES["sgp4_shallow_dense"]
    r, v, e = propagate_fast(cat.els, None, tsince, cat.grav,
                             kepler_iters=cat.kepler_iters)
    torch.cuda.synchronize()
    assert cuda_sgp4.LAUNCHES["sgp4_shallow_dense"] == before + 1
    assert torch.equal(r, k5[0])


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
    launch, the f64 path's and the epilogue's too."""
    before = (dict(cuda_sgp4.LAUNCHES), dict(cuda_screen.LAUNCHES),
              dict(cuda_finalize.LAUNCHES))
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
        propagate(cat, jd, method=method, output="geodetic",
                  layout="sat_major")
    screen_all(near, jd, threshold_km=50.0)
    from astroz_tpu_torch.parallel import make_mesh
    from astroz_tpu_torch.screening import screen_all_ring
    screen_all_ring(near, jd, threshold_km=50.0, mesh=make_mesh(["cpu"] * 2))
    assert (dict(cuda_sgp4.LAUNCHES), dict(cuda_screen.LAUNCHES),
            dict(cuda_finalize.LAUNCHES)) == before


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [3, 8])
def test_dense_time_major_matches_planes_on_cuda(cuda_device, iters):
    """K5's time-major store, through ``propagate_fast_fused`` and
    ``propagate_fast_dense``, gives the (T, S, 3) layout of its plain
    version's planes bit for bit, contiguous, with and without
    velocities, on a dense grid and on a (T, 1) column."""
    cat = build_catalog(synthetic_leo_text(), device=cuda_device)
    st = cat.fast_staging
    kw = dict(grav=cat.grav, kepler_iters=iters)
    for t in (_dense_grid(cat, cuda_device),
              torch.linspace(-250.0, 2000.0, 9, dtype=torch.float64,
                             device=cuda_device)[:, None].contiguous()):
        dense = cuda_sgp4.propagate_fast_dense(t, st.spine, st.tail,
                                               st.flags, **kw)
        before = cuda_sgp4.LAUNCHES["sgp4_shallow_dense"]
        r, v, e = cuda_sgp4.propagate_fast_fused(cat.els, t, cat.grav,
                                                 kepler_iters=iters)
        r0, v0, e0 = cuda_sgp4.propagate_fast_fused(
            cat.els, t, cat.grav, kepler_iters=iters, want_vel=False)
        torch.cuda.synchronize()
        assert cuda_sgp4.LAUNCHES["sgp4_shallow_dense"] == before + 2
        ref = cuda_sgp4.propagate_fast_dense_reference(t, st.spine, st.tail,
                                                       st.flags, **kw)
        assert all(torch.equal(a, b) for a, b in zip(dense, ref))
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
    """K6's store, the time-major (T, S, 3) r and v, against its plain
    version on the ragged shapes of
    ``test_dense_kernels_match_twins_on_cuda`` and on a 7 x 45 grid that
    is part of one wave: bit-equal, contiguous, with and without
    velocities, one launch a call."""
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
            got = cuda_sgp4.propagate_fast_spine_grids(grids, tail, flags,
                                                       **kw)
            torch.cuda.synchronize()
            assert cuda_sgp4.LAUNCHES["sgp4_shallow_grids"] == before + 1
            ref = cuda_sgp4.propagate_fast_spine_grids_reference(
                grids, tail, flags, **kw)
            assert got[0].is_contiguous()
            assert got[0].shape == grids[0].shape + (3,)
            assert all(a is b is None or torch.equal(a, b)
                       for a, b in zip(got, ref))


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
    near-earth array) or of K2, the f64 kernel's escape and K3 (a mixed
    one with escape lanes, and TABLES at its first call) a call;
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
    assert cat.heo_escape is not None or kind == "near"
    assert moved == ({"sgp4_shallow": 1} if kind == "near" else
                     {"sgp4_deep": 1, "sgp4_f64_escape": 1,
                      "sgp4_shallow_merge": 1, "resonance_tables": 1})
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


def _integrate_models():
    from astroz_tpu_torch.propagators import (Composite, Drag, ImprovedDrag,
                                              J2, J3, J4,
                                              SolarRadiationPressure,
                                              TwoBody)
    return {
        "TwoBody": TwoBody(),
        "TwoBody+J2": Composite([TwoBody(), J2()]),
        "TwoBody+J2+Drag": Composite([TwoBody(), J2(), Drag()]),
        "every kind": Composite([TwoBody(), J2(), J3(), J4(),
                                 ImprovedDrag(f107=220.0),
                                 SolarRadiationPressure()]),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["TwoBody", "TwoBody+J2+Drag",
                                   "every kind"])
@pytest.mark.parametrize("method,substeps", [("rk4", 1), ("rk4", 2),
                                             ("dp87", 1)])
def test_integrate_fixed_matches_plain_on_cuda(cuda_device, model, method,
                                               substeps):
    """The integrator kernel's FIXED mode against its plain version on
    the card, bit for bit, over 300 ragged lanes (some in the Earth's
    shadow for SRP, some below 500 km for the layered drag), one launch a
    call; ``propagate_fixed`` launches it once."""
    from astroz_tpu_torch.ops import cuda_integrate
    from astroz_tpu_torch.propagators import propagate_fixed
    from astroz_tpu_torch.propagators.driver import fixed_reference
    accel = _integrate_models()[model]
    lanes = _circular_lanes(300, seed=3)
    lanes[:20, :3] *= -1.0                  # anti-sunward
    lanes[20:40, :3] *= 6700.0 / 6928.137   # ~320 km
    state = torch.as_tensor(lanes, device=cuda_device)
    before = dict(cuda_integrate.LAUNCHES)
    got = cuda_integrate.fixed(accel, state, 10.0, 12, 60.0 / substeps,
                               method=method, substeps=substeps)
    assert cuda_integrate.LAUNCHES["integrate_fixed"] == \
        before["integrate_fixed"] + 1
    want = fixed_reference(accel, state, 10.0, 12, 60.0 / substeps,
                           method=method, substeps=substeps)
    assert cuda_integrate.LAUNCHES == {**before, "integrate_fixed":
                                       before["integrate_fixed"] + 1}
    assert got.shape == (13, 300, 6) and torch.equal(got, want)
    _, via = propagate_fixed(accel, state.reshape(3, 100, 6), 10.0, 720.0,
                             60.0, method=method, substeps=substeps)
    assert via.shape == (13, 3, 100, 6)
    assert torch.equal(via.reshape(13, 300, 6), got)
    assert cuda_integrate.LAUNCHES["integrate_fixed"] == \
        before["integrate_fixed"] + 2


#: the one-thread modes' models: one of each signature the kernel is
#: compiled for (TwoBody, TwoBody + J2, TwoBody + J2 + Drag) and one of
#: none (every kind, through the run-time dispatch)
SIGNATURE_MODELS = ["TwoBody", "TwoBody+J2", "TwoBody+J2+Drag", "every kind"]


@pytest.mark.cuda
@pytest.mark.parametrize("model", SIGNATURE_MODELS)
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_integrate_adaptive_matches_plain_on_cuda(cuda_device, sign, model):
    """``dp87_adaptive`` on the card (TRAJECTORY for one outer step)
    against its plain version on the card, one launch a call, for a model
    of each signature. Where every outer step is one clamped substep (60
    s outer steps of a LEO orbit, h carried as ``DormandPrince87`` carries
    it) the two are bit-equal with equal substep counts. One substep from
    32 states: the state bit-equal, the next h within a few ulps (the
    kernel's err^(-1/8) is the device's pow, the plain loop's the
    host's). A call with rejected steps (h0 = 3600 s over 1 h): the same
    count, 1e-8 km. The substep cap stops both at the same count."""
    from astroz_tpu_torch.ops import cuda_integrate
    from astroz_tpu_torch.propagators import dp87_adaptive, make_deriv
    from astroz_tpu_torch.propagators.integrators import adaptive_reference
    deriv = make_deriv(_integrate_models()[model])
    lanes = torch.as_tensor(_circular_lanes(32, seed=4), device=cuda_device)
    kw = dict(rtol=1e-10, atol=1e-12, h_min=1e-3, h_max=3600.0,
              max_substeps=10000)
    y_k = y_p = lanes[0]
    h_k = h_p = None
    for k in range(60):
        t0, t1 = 60.0 * k * sign, 60.0 * (k + 1) * sign
        n0 = cuda_integrate.LAUNCHES["integrate_adaptive"]
        y_k, h_kn, n_k = dp87_adaptive(deriv, y_k, t0, t1, rtol=1e-10,
                                       h0=h_k)
        assert cuda_integrate.LAUNCHES["integrate_adaptive"] == n0 + 1
        h = (h_p if h_p is not None else 60.0) * sign
        y_p, h_pn, n_p = adaptive_reference(deriv, y_p, t0, t1, h, **kw)
        assert n_k == n_p == 1 and y_k.shape == (6,)
        assert torch.equal(y_k, y_p)
        h_k, h_p = abs(h_kn), abs(h_pn)
    for y in lanes:
        one = {**kw, "max_substeps": 1}
        got = cuda_integrate.adaptive(deriv, y, 0.0, 600.0 * sign,
                                      600.0 * sign, **one)
        want = adaptive_reference(deriv, y, 0.0, 600.0 * sign,
                                  600.0 * sign, **one)
        assert torch.equal(got[0], want[0]) and got[2] == want[2] == 1
        assert abs(got[1] - want[1]) <= 1e-14 * abs(want[1])
    got = cuda_integrate.adaptive(deriv, lanes[1], 0.0, 3600.0 * sign,
                                  3600.0 * sign, **kw)
    want = adaptive_reference(deriv, lanes[1], 0.0, 3600.0 * sign,
                              3600.0 * sign, **kw)
    assert got[2] == want[2] > 5
    assert float((got[0] - want[0])[:3].abs().max()) <= 1e-8
    capped = dp87_adaptive(deriv, lanes[2], 0.0, 3600.0 * sign,
                           rtol=1e-10, h0=7.0, max_substeps=3)
    plain = adaptive_reference(deriv, lanes[2], 0.0, 3600.0 * sign,
                               7.0 * sign, **{**kw, "max_substeps": 3})
    assert capped[2] == plain[2] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [(), (5,), "zeros"])
def test_integrate_attitude_matches_plain_on_cuda(cuda_device, batch):
    """ATTITUDE against its plain version on the card, bit for bit, with
    a torque, one body and a batch of five; ``propagate_attitude``
    launches it once. "zeros": a body at rest in the identity attitude
    with no torque, then one spinning about one axis (quotients of zero,
    the divides' fallback), and one of tiny inertia."""
    from astroz_tpu_torch.calculations import (attitude_reference,
                                               propagate_attitude)
    from astroz_tpu_torch.ops import cuda_integrate
    rng = np.random.default_rng(6)
    if batch == "zeros":
        batch = (3,)
        q = np.array([[1.0, 0.0, 0.0, 0.0]] * 3)
        w = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.2], [0.01, 0.02, 0.0]])
        inertia = np.array([[10.0, 12.0, 20.0], [10.0, 12.0, 20.0],
                            [1e-130, 2e-130, 3e-130]])
        torque = np.zeros((3, 3))
    else:
        q = rng.normal(size=(*batch, 4))
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        w = rng.normal(0.0, 0.05, (*batch, 3))
        inertia = np.array([10.0, 12.0, 20.0])
        torque = np.array([1e-3, 0.0, -2e-3])
    dev = cuda_device
    args = [torch.as_tensor(x, device=dev) for x in (q, w, inertia, torque)]
    n0 = cuda_integrate.LAUNCHES["integrate_attitude"]
    got = propagate_attitude(*args, 0.01, 700)
    assert cuda_integrate.LAUNCHES["integrate_attitude"] == n0 + 1
    want = attitude_reference(*args, 0.01, 700)
    assert got[0].shape == (*batch, 4) and got[1].shape == (*batch, 3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _steps_on_card(integ, state, t0, dt, n):
    """``Propagator(integ).propagate``'s loop of ``step`` calls (one launch
    and one read an outer step): states, each outer step's substeps and
    ``h_current`` after it."""
    times = t0 + dt * np.arange(n)
    states, subs, hs = [state], [], []
    for k in range(1, n):
        before = integ.n_substeps
        state = integ.step(state, float(times[k - 1]), dt)
        subs.append(integ.n_substeps - before)
        hs.append(integ.h_current)
        states.append(state)
    return torch.stack(states), subs, hs


@pytest.mark.cuda
@pytest.mark.parametrize("model", SIGNATURE_MODELS)
@pytest.mark.parametrize("dt,n,h_carried", [(60.0, 61, None),
                                            (600.0, 13, None),
                                            (-300.0, 13, 150.0)])
def test_integrate_trajectory_equals_per_step_launches_on_cuda(
        cuda_device, dt, n, h_carried, model):
    """TRAJECTORY (``Propagator.propagate`` over a ``DormandPrince87`` on
    the card: one launch, one read) against the loop of launches, one an
    outer step, that ``step`` makes, bit for bit, for a model of each
    signature: every state, each outer step's substeps and |h| after it,
    ``h_current`` and ``n_substeps``; forward with one substep an outer
    step and several, backward from a carried |h|. Against the plain
    trajectory where each outer step is one substep (60 s): the same
    counts, states within 1e-8 km, |h| within 1e-13 relative. Not where
    outer steps take several substeps: the kernel's err^(-1/8) is the
    device's pow, the plain loop's the host's, so where h binds and is
    carried their counts and states part (1.2e-8 km and a count apart
    over nine 600 s steps on the H100)."""
    from astroz_tpu_torch.ops import cuda_integrate
    from astroz_tpu_torch.propagators import DormandPrince87, Propagator
    from astroz_tpu_torch.propagators.integrators import (
        adaptive_trajectory_reference)
    accel = _integrate_models()[model]
    state = torch.as_tensor(_circular_lanes(1, seed=5)[0],
                            device=cuda_device)

    def integ():
        out = DormandPrince87(accel, rtol=1e-10)
        out.h_current = h_carried
        return out

    steps = integ()
    want, subs, hs = _steps_on_card(steps, state, 30.0, dt, n)
    one = integ()
    before = dict(cuda_integrate.LAUNCHES)
    times, got = Propagator(one).propagate(state, 30.0, dt * (n - 1), dt)
    assert cuda_integrate.LAUNCHES == {
        **before, "integrate_trajectory": before["integrate_trajectory"] + 1}
    assert len(times) == n and torch.equal(got, want)
    assert (one.h_current, one.n_substeps) == (steps.h_current,
                                               steps.n_substeps)
    states, g_subs, g_hs, info = cuda_integrate.trajectory(
        one.deriv, state, 30.0, dt, n, rtol=1e-10, atol=1e-12,
        h_carried=h_carried, h_min=1e-3, h_max=3600.0, max_substeps=10000)
    assert torch.equal(states, want)
    assert g_subs.tolist() == subs and g_hs.tolist() == hs
    assert info.tolist() == [n - 1, steps.h_current, steps.n_substeps,
                             math.copysign(steps.h_current, dt)]
    if dt == 60.0:
        p_states, p_subs, p_hs, _ = adaptive_trajectory_reference(
            one.deriv, state, 30.0, dt, n, rtol=1e-10, atol=1e-12,
            h_carried=h_carried)
        assert p_subs.tolist() == subs
        assert float((p_states - want)[:, :3].abs().max()) <= 1e-8
        rel = ((p_hs - g_hs).abs() / p_hs.abs()).max()
        assert float(rel) <= 1e-13


@pytest.mark.cuda
def test_integrate_trajectory_substep_cap_on_cuda(cuda_device, monkeypatch):
    """With a cap of 3 substeps and a carried |h| the one-launch
    ``Propagator.propagate`` raises the cap's ``RuntimeError`` at the
    outer step where the loop of ``step`` calls does, and leaves
    ``h_current`` and ``n_substeps`` as that loop does."""
    from astroz_tpu_torch.propagators import (Composite, DormandPrince87, J2,
                                              Propagator, TwoBody)
    import astroz_tpu_torch.propagators.integrators as integrators
    accel = Composite([TwoBody(), J2()])
    state = torch.as_tensor(_circular_lanes(1, seed=5)[0],
                            device=cuda_device)

    def warmed():
        integ = DormandPrince87(accel, rtol=1e-10)
        _, s = Propagator(integ).propagate(state, 0.0, 600.0, 60.0)
        return integ, s[-1]

    loop, start = warmed()
    one, _ = warmed()
    monkeypatch.setattr(integrators, "MAX_SUBSTEPS", 3)
    with pytest.raises(RuntimeError, match="substep cap"):
        _steps_on_card(loop, start, 600.0, 300.0, 13)
    with pytest.raises(RuntimeError, match="substep cap"):
        Propagator(one).propagate(start, 600.0, 3600.0, 300.0)
    assert (one.h_current, one.n_substeps) == (loop.h_current,
                                               loop.n_substeps)
    assert one.n_substeps > 10


@pytest.mark.cuda
def test_integrate_divide_probe_on_cuda(cuda_device):
    """The integrator kernel's divides through a reciprocal (y = RN(1/b)
    and two corrections where a and b lie in its window, ``__ddiv_rn``
    elsewhere) and its reciprocals (``__drcp_rn``) against ``__ddiv_rn``,
    bit for bit: 10^7 random pairs (random significands, signs, exponents
    over +-60), 10^6 with a / b just below a power of two, and the edges
    (zeros of both signs, subnormals, inf, NaN, the window's bounds
    2^-400 and 2^401, quotients that under- or overflow)."""
    from astroz_tpu_torch.ops import cuda_integrate
    gen = torch.Generator(device=cuda_device).manual_seed(16)

    def randoms(n, lo, hi):
        m = 1.0 + torch.rand(n, generator=gen, device=cuda_device,
                             dtype=torch.float64)
        e = torch.randint(lo, hi + 1, (n,), generator=gen,
                          device=cuda_device)
        sign = torch.randint(0, 2, (n,), generator=gen,
                             device=cuda_device) * 2 - 1
        return torch.ldexp(m, e) * sign

    def same(x, y):
        return torch.equal(x.view(torch.int64), y.view(torch.int64))

    a, b = randoms(10 ** 7, -60, 60), randoms(10 ** 7, -60, 60)
    near_b = 1.5 + 0.5 * torch.rand(10 ** 6, generator=gen,
                                    device=cuda_device, dtype=torch.float64)
    d = torch.ldexp(torch.ones_like(near_b), torch.randint(
        -52, -7, (10 ** 6,), generator=gen, device=cuda_device))
    edges = torch.tensor([0.0, -0.0, 5e-324, -5e-324, 2.2e-308, 1e-310,
                          float("inf"), -float("inf"), float("nan"),
                          2.0 ** -400, 2.0 ** -401, 2.0 ** 400, 2.0 ** 401,
                          1e300, -1e300, 1e-300, 3.0, -7.5, 1.0],
                         dtype=torch.float64, device=cuda_device)
    ea, eb = torch.meshgrid(edges, edges, indexing="ij")
    for x, y in ((a, b), (near_b * (1.0 - d), near_b),
                 (ea.reshape(-1), eb.reshape(-1))):
        got, want, rcp, rcp_want = cuda_integrate.divide_probe(x, y)
        assert same(got, want) and same(rcp, rcp_want)
        assert same(want, x / y)  # torch's CUDA divide: __ddiv_rn too


@pytest.mark.cuda
def test_models_past_max_terms_run_plain_on_cuda(cuda_device):
    """A Composite of MAX_TERMS + 1 terms runs the plain loop on a CUDA
    tensor, launches nothing and equals the plain versions; one of
    MAX_TERMS terms launches FIXED and ``dp87_adaptive``'s TRAJECTORY
    once each, bit-equal to the plain loops over one clamped substep."""
    from astroz_tpu_torch.ops import cuda_integrate
    from astroz_tpu_torch.propagators import (Composite, Drag, J2, TwoBody,
                                              dp87_adaptive, make_deriv,
                                              propagate_fixed)
    from astroz_tpu_torch.propagators.driver import fixed_reference
    from astroz_tpu_torch.propagators.integrators import adaptive_reference

    members = [TwoBody(), J2()] + [Drag()] * (cuda_integrate.MAX_TERMS - 1)
    state = torch.as_tensor(_circular_lanes(8), device=cuda_device)
    kw = dict(rtol=1e-10, atol=1e-12, h_min=1e-3, h_max=3600.0,
              max_substeps=10000)
    for model, n in ((Composite(members), 0), (Composite(members[:-1]), 1)):
        before = dict(cuda_integrate.LAUNCHES)
        _, got = propagate_fixed(model, state, 0.0, 120.0, 30.0)
        deriv = make_deriv(model)
        y, h, steps = dp87_adaptive(deriv, state[0], 0.0, 60.0, h0=60.0)
        assert cuda_integrate.LAUNCHES["integrate_fixed"] == \
            before["integrate_fixed"] + n
        assert cuda_integrate.LAUNCHES["integrate_adaptive"] == \
            before["integrate_adaptive"] + n
        assert torch.equal(got, fixed_reference(model, state, 0.0, 4, 30.0))
        y_p, h_p, steps_p = adaptive_reference(deriv, state[0], 0.0, 60.0,
                                               60.0, **kw)
        assert torch.equal(y, y_p) and steps == steps_p == 1
        assert abs(h - h_p) <= 1e-13 * abs(h_p)


@pytest.mark.cuda
def test_models_without_terms_launch_nothing_on_cuda(cuda_device):
    """A model of a python function of t (ThirdBody, SRP with a
    ``sun_pos_fn``, a lambda) runs the plain loop on a CUDA tensor and
    launches no kernel; so does a batched ``dp87_adaptive``."""
    from astroz_tpu_torch.ops import cuda_integrate
    from astroz_tpu_torch.propagators import (Composite,
                                              SolarRadiationPressure,
                                              ThirdBody, TwoBody,
                                              dp87_adaptive, make_deriv,
                                              propagate_fixed)

    def moon(t):
        return torch.tensor([384400.0, 1000.0, -2000.0],
                            dtype=torch.float64, device=cuda_device)

    state = torch.as_tensor(_circular_lanes(8), device=cuda_device)
    before = dict(cuda_integrate.LAUNCHES)
    for accel in (Composite([TwoBody(), ThirdBody(4902.800066, moon)]),
                  SolarRadiationPressure(sun_pos_fn=moon),
                  lambda r, v, t: -r):
        _, s = propagate_fixed(accel, state, 0.0, 120.0, 60.0)
        assert s.device.type == "cuda" and s.shape == (3, 8, 6)
        dp87_adaptive(make_deriv(accel), state[0], 0.0, 1.0)
    dp87_adaptive(make_deriv(TwoBody()), state[:2], 0.0, 60.0)
    assert cuda_integrate.LAUNCHES == before
