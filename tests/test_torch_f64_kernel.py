"""The f64 kernel's staging, wrappers and routing on the CPU.

The f64 kernel (``astroz_tpu_torch/csrc/sgp4_f64.cu``) computes the plain
f64 functions at independent points in two modes: DENSE
(``ops/sgp4.py:sgp4_propagate`` / ``ops/sdp4.py:sdp4_propagate``) and
ESCAPE (``ops/fast.py:sdp4_propagate_tables`` into kernel K2's planes);
on the card ``ops/sdp4.py:sdp4_propagate_scan`` (``scan_times=True``) is
DENSE on a sweep's jd and fr rows. Here, where no card runs it:

* the staged (F, S) f64 and (5, S) i32 matrices unpack to the elements
  they were packed from, the JAX package's carried across, bit for bit,
  and their rows are the kernel's ``enum Field``; the last flag row, the
  slot order, groups the lanes by regime;
* the identity DENSE's row walk, and the scan on it, rests on: every row
  of the plain ``sdp4_propagate_scan`` is ``sdp4_propagate`` at that row
  alone, bit for bit, and a scan started at any row equals the rest of
  the whole scan; a Python model of the walk computes every point once,
  each thread's run along consecutive rows of one lane from a fresh
  carry;
* on CPU tensors each wrapper equals its plain function bit for bit and
  counts no launch;
* DENSE, also on the scan's rows, and ``propagate(method="f64")``
  stay within the JAX f64 path's gates of ``tests/test_torch_f64.py``
  (2e-7 km and 3e-10 km/s TEME, 6e-6 km ECEF);
* the escape's routing leaves K2's planes as the plain recompute on the
  gathered escape tables did.

The catalog is small and ragged: near-earth lanes (one on simplified
drag, one decaying), the golden deep TLEs (GEO on the Lyddane branch,
GPS, Molniya) and synthetic deep lanes (geosynchronous and half-day
resonant, HEO escape lanes, one below the surface, one with a huge
bstar), epochs spread over +-2 days, times of both signs over several
720-minute steps. ``tests/test_torch_cuda.py`` holds each mode to its
plain version bit for bit on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import astroz_tpu as J
from astroz_tpu import tle as jtle
from astroz_tpu.constants import WGS72 as J_WGS72
from astroz_tpu.ops import sdp4 as jsdp4
from astroz_tpu.ops import sgp4 as jsgp4

import astroz_tpu_torch as P
from astroz_tpu_torch import api
from astroz_tpu_torch.constants import WGS72
from astroz_tpu_torch.convert import deep_elements_from_numpy, \
    elements_from_numpy
from astroz_tpu_torch.ops import cuda_sgp4, sdp4_propagate, sgp4_propagate
from astroz_tpu_torch.ops.cuda_sgp4 import (F64_FIELD_NAMES,
                                            SGP4_F64_FIELD_NAMES,
                                            f64_staging, f64_unstage)
from astroz_tpu_torch.ops.fast import sdp4_propagate_tables
from astroz_tpu_torch.ops.sdp4 import sdp4_propagate_scan
from astroz_tpu_torch.propagation import (_apply_escape, deep_slots,
                                          resonance_steps)

from test_escape import MIXED_TEXT
from test_torch_cuda import synthetic_deep_text, synthetic_leo_text

torch.set_num_threads(1)

#: tests/test_torch_f64.py's gates against the JAX f64 path
POS_TOL_KM = 2e-7
VEL_TOL_KMS = 3e-10
FIXED_POS_TOL_KM = 6e-6
FIXED_VEL_TOL_KMS = 1e-9

MIXED = "\n".join([synthetic_leo_text(13, seed=5), MIXED_TEXT,
                   synthetic_deep_text(19, seed=3)])
NEAR = synthetic_leo_text(21, seed=9)
#: minutes since epoch of both signs across several 720-minute steps
T_COL = np.linspace(-3100.0, 3700.0, 11)[:, None]


def _jax_catalog(text):
    return J.build_catalog(jtle.TleArrays.from_text(text,
                                                    allow_native=False))


@pytest.fixture(scope="module")
def mixed():
    return _jax_catalog(MIXED), P.build_catalog(MIXED, device="cpu")


@pytest.fixture(scope="module")
def near():
    return _jax_catalog(NEAR), P.build_catalog(NEAR, device="cpu")


def _dense_times(n_sats, seed=0):
    rng = np.random.default_rng(seed)
    return T_COL + rng.uniform(-900.0, 900.0, (len(T_COL), n_sats))


def _equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and torch.equal(a, b)


def test_mixed_catalog_covers_the_regimes(mixed):
    """The catalog has what the kernel branches on: simplified and full
    drag, deep lanes on both sides of the Lyddane branch, irez 1 and 2,
    escape lanes, and init or propagation failures over the grid."""
    pcat = mixed[1]
    irez = np.asarray(pcat.deep_host.irez)
    assert pcat.host.isimp.any() and (~pcat.host.isimp).any()
    assert (irez == 1).any() and (irez == 2).any()
    deep_incl = pcat.host.inclo[pcat.is_deep]
    assert (deep_incl < 0.2).any() and (deep_incl >= 0.2).any()
    assert pcat.heo_escape is not None
    _, _, err = P.propagate_tsince(pcat, torch.from_numpy(
        _dense_times(len(pcat))))
    assert set(err.unique().tolist()) > {0}


def test_kernel_field_rows_are_the_staged_rows():
    """``csrc/sgp4_f64.cu``'s ``enum Field`` lists F64_FIELD_NAMES in
    order (the kernel reads row k as field k)."""
    src = (Path(cuda_sgp4.__file__).resolve().parents[1] / "csrc"
           / "sgp4_f64.cu").read_text()
    body = re.search(r"enum Field \{(.*?)N_FIELDS", src, re.S).group(1)
    names = [n.strip().lower() for n in body.split(",") if n.strip()]
    assert names == list(F64_FIELD_NAMES)
    assert len(SGP4_F64_FIELD_NAMES) == 37 and len(F64_FIELD_NAMES) == 83
    flags = re.search(r"enum Flag \{(.*?)N_FLAGS", src, re.S).group(1)
    assert [n.strip().lower() for n in flags.split(",") if n.strip()] \
        == list(cuda_sgp4.F64_FLAG_NAMES)


@pytest.mark.parametrize("kind", ["mixed", "near"])
def test_staging_unpacks_to_the_jax_elements_bit_for_bit(kind, mixed, near):
    """The JAX package's elements, carried across by ``convert``, staged
    and unstaged: every field equal bit for bit, dtypes kept (bool masks,
    i32 codes and irez)."""
    jcat = {"mixed": mixed, "near": near}[kind][0]
    els = elements_from_numpy(jcat.els, "cpu")
    deep = (None if jcat.deep is None
            else deep_elements_from_numpy(jcat.deep, "cpu"))
    st = f64_staging(els, deep)
    assert st.fields.dtype == torch.float64 and st.flags.dtype == torch.int32
    assert tuple(st.fields.shape) == (
        len(F64_FIELD_NAMES if deep is not None else SGP4_F64_FIELD_NAMES),
        len(els.no_kozai))
    els2, deep2 = f64_unstage(*st)
    assert (deep2 is None) == (deep is None)
    for name, x in zip(els._fields, els2):
        ref = np.asarray(getattr(jcat.els, name))
        assert x.numpy().dtype == ref.dtype, name
        assert np.array_equal(x.numpy(), ref), name
    if deep is not None:
        for name, x in zip(deep._fields, deep2):
            ref = np.asarray(getattr(jcat.deep, name))
            assert x.numpy().dtype == ref.dtype, name
            assert np.array_equal(x.numpy(), ref), name
    else:
        assert not st.flags[2].any()


@pytest.mark.parametrize("kind", ["mixed", "near"])
def test_slot_order_groups_lanes_by_regime(kind, mixed, near):
    """The staging's last flag row is a permutation of the lanes:
    near-earth lanes first in catalog order, then the deep lanes in K2's
    slot order (``propagation.deep_slots``: grouped by Lyddane branch and
    irez, catalog order within a group); the identity on a near-earth
    catalog."""
    pcat = {"mixed": mixed, "near": near}[kind][1]
    order = pcat.f64_staging.flags[4].numpy()
    n = len(pcat)
    assert pcat.f64_staging.flags.dtype == torch.int32
    assert sorted(order) == list(range(n))
    near_lanes = np.nonzero(~pcat.is_deep)[0]
    assert np.array_equal(order[:len(near_lanes)], near_lanes)
    if pcat.deep is None:
        assert np.array_equal(order, np.arange(n))
        return
    deep = order[len(near_lanes):]
    assert np.array_equal(deep, deep_slots(pcat.host, pcat.deep_host))
    irez = np.asarray(pcat.deep_host.irez)[deep]
    key = (pcat.host.inclo[deep] < cuda_sgp4.LYDDANE_INCL) * 3 + irez
    assert np.all(np.diff(key) >= 0) and len(set(key)) >= 3
    for k in set(key):
        assert np.all(np.diff(deep[key == k]) > 0)
    # the unstaged elements do not depend on the order
    els, _ = f64_unstage(*pcat.f64_staging)
    assert torch.equal(els.no_kozai, pcat.els.no_kozai)


def test_staging_broadcasts_one_satellite():
    """Elements broadcast to many lanes (bench_single_sat's fold) stage as
    that many equal columns."""
    cat = P.build_catalog(NEAR, device="cpu")
    one = type(cat.els)(*(x[:1].expand(64) for x in cat.els))
    st = f64_staging(one)
    assert tuple(st.fields.shape) == (37, 64)
    assert torch.equal(st.fields, st.fields[:, :1].expand(-1, 64))


@pytest.mark.parametrize("want_vel", [True, False])
@pytest.mark.parametrize("form", ["column", "dense", "lanes", "scalar"])
@pytest.mark.parametrize("kind", ["mixed", "near"])
def test_dense_wrapper_equals_plain_on_cpu(kind, form, want_vel, mixed,
                                           near):
    """DENSE on CPU tensors is the plain function, bit for bit, on every
    tsince form its callers pass, and counts no launch."""
    pcat = {"mixed": mixed, "near": near}[kind][1]
    n = len(pcat)
    t = torch.from_numpy({"column": T_COL, "dense": _dense_times(n),
                          "lanes": _dense_times(n)[3],
                          "scalar": np.array(-1234.5)}[form])
    sdp4 = pcat.deep is not None
    before = dict(cuda_sgp4.LAUNCHES)
    out = cuda_sgp4.sgp4_f64_dense(t, *pcat.f64_staging, grav=pcat.grav,
                                   sdp4=sdp4, want_vel=want_vel)
    plain = (sdp4_propagate(pcat.els, pcat.deep, t, pcat.grav)[:3] if sdp4
             else sgp4_propagate(pcat.els, t, pcat.grav))
    assert dict(cuda_sgp4.LAUNCHES) == before
    assert _equal(out[0], plain[0]) and _equal(out[2], plain[2])
    assert _equal(out[1], plain[1] if want_vel else None)


#: a sweep's epochs as the python-sgp4 split, whole days in jd and the
#: rest in fr, over -3.2 .. +4.1 days from the catalogs' middle epoch;
#: fr is not a multiple of jd's ulp, so jd + fr would round
EPOCH_DAYS = np.linspace(-3.2, 4.1, 11)


def _epoch_rows(form):
    """(T,) f64 jd and fr rows: ``rows`` the split of EPOCH_DAYS, ``jd`` a
    scalar jd broadcast against fr rows (stride 0), ``fr`` the other way
    round, ``one`` a single epoch."""
    days = np.floor(EPOCH_DAYS)
    jd, fr = 2460310.5 + days, EPOCH_DAYS - days
    jd, fr = {"rows": (jd, fr), "jd": (np.array(2460311.0), EPOCH_DAYS - 0.5),
              "fr": (jd, np.array(0.3)), "one": (jd[3:4], fr[3:4])}[form]
    n = max(np.size(jd), np.size(fr))
    return tuple(torch.from_numpy(np.asarray(a, np.float64)).expand(n)
                 for a in (jd, fr))


def _grid_plain(pcat, jd, fr):
    """The plain function on the tsince grid that ``_propagate_f64``
    formed in torch before DENSE took the jd and fr rows."""
    tsince = ((jd[:, None] - pcat.els.epoch_jd[None, :]) + fr[:, None]) \
        * 1440.0
    if pcat.deep is not None:
        return sdp4_propagate(pcat.els, pcat.deep, tsince, pcat.grav)[:3]
    return sgp4_propagate(pcat.els, tsince, pcat.grav)


@pytest.mark.parametrize("want_vel", [True, False])
@pytest.mark.parametrize("form", ["rows", "jd", "fr", "one"])
@pytest.mark.parametrize("kind", ["mixed", "near"])
def test_dense_epochs_wrapper_equals_plain_on_cpu(kind, form, want_vel,
                                                  mixed, near):
    """DENSE on a sweep's jd and fr rows, on CPU tensors, is the plain
    function on the tsince grid formed in torch, bit for bit, with rows
    that broadcast from a scalar too, and counts no launch."""
    pcat = {"mixed": mixed, "near": near}[kind][1]
    jd, fr = _epoch_rows(form)
    before = dict(cuda_sgp4.LAUNCHES)
    out = cuda_sgp4.sgp4_f64_dense_epochs(
        jd, fr, *pcat.f64_staging, grav=pcat.grav,
        sdp4=pcat.deep is not None, want_vel=want_vel)
    plain = _grid_plain(pcat, jd, fr)
    assert dict(cuda_sgp4.LAUNCHES) == before
    assert tuple(out[0].shape) == (len(jd), len(pcat), 3)
    assert _equal(out[0], plain[0]) and _equal(out[2], plain[2])
    assert _equal(out[1], plain[1] if want_vel else None)


@pytest.mark.parametrize("scalar", ["jd", "fr"])
@pytest.mark.parametrize("kind", ["mixed", "near"])
def test_propagate_f64_equals_plain_on_the_epoch_grid(kind, scalar, mixed,
                                                      near):
    """``propagate(method="f64")`` with jd or fr a python scalar gives the
    plain function's bits on the grid formed from the broadcast rows."""
    pcat = {"mixed": mixed, "near": near}[kind][1]
    jd, fr = _epoch_rows(scalar)
    args = (float(jd[0]), fr.numpy()) if scalar == "jd" else (
        jd.numpy(), float(fr[0]))
    out = P.propagate(pcat, *args, method="f64")
    assert all(_equal(a, b) for a, b in zip(out, _grid_plain(pcat, jd, fr)))


@pytest.mark.parametrize("case", ["lengths", "f32", "grid", "device"])
def test_dense_epochs_raises_on_rows_it_does_not_take(case, mixed):
    """Rows of unequal length, not f64, not one-dimensional or on another
    device than the elements raise on any device."""
    pcat = mixed[1]
    jd, fr = _epoch_rows("rows")
    jd, fr = {"lengths": (jd, fr[1:]), "f32": (jd, fr.float()),
              "grid": (jd[:, None], fr[:, None]),
              "device": (jd, fr.to("meta"))}[case]
    with pytest.raises(ValueError, match="jd, fr"):
        cuda_sgp4.sgp4_f64_dense_epochs(jd, fr, *pcat.f64_staging,
                                        grav=pcat.grav, sdp4=True)


@pytest.mark.parametrize("order", ["forward", "backward"])
def test_scan_wrapper_equals_plain_on_cpu(order, mixed):
    """The scan on a sweep's jd and fr rows, on CPU tensors, through its
    wrapper and through ``propagate(scan_times=True)``, is
    ``sdp4_propagate_scan`` on ``epoch_tsince``'s grid bit for bit, on
    epochs sorted either way across the lanes' epochs, and counts no
    launch."""
    pcat = mixed[1]
    jd, fr = _epoch_rows("rows")
    if order == "backward":
        jd, fr = jd.flip(0), fr.flip(0)
    t = cuda_sgp4.epoch_tsince(jd, fr, pcat.els.epoch_jd)
    before = dict(cuda_sgp4.LAUNCHES)
    out = cuda_sgp4.sgp4_f64_scan(jd, fr, *pcat.f64_staging, grav=pcat.grav)
    via = P.propagate(pcat, jd.numpy(), fr.numpy(), method="f64",
                      scan_times=True)
    plain = sdp4_propagate_scan(pcat.els, pcat.deep, t, pcat.grav)
    assert dict(cuda_sgp4.LAUNCHES) == before
    assert all(_equal(a, b) for a, b in zip(out, plain))
    assert all(_equal(a, b) for a, b in zip(via, plain))
    r0, v0, e0 = cuda_sgp4.sgp4_f64_scan(jd, fr, *pcat.f64_staging,
                                         grav=pcat.grav, want_vel=False)
    assert v0 is None and _equal(r0, out[0]) and _equal(e0, out[2])


#: rows of the identity's grids: ascending, descending and in random order
#: over -9,000 .. +9,700 minutes, across epoch and several 720-minute steps
IDENTITY_ROWS = np.linspace(-9000.0, 9700.0, 40)


def _identity_times(order, n_sats):
    rng = np.random.default_rng(4)
    rows = {"ascending": IDENTITY_ROWS, "descending": IDENTITY_ROWS[::-1],
            "random": rng.permutation(IDENTITY_ROWS)}[order]
    # each lane shifted by its own offset: every column ordered alike
    return torch.from_numpy(rows[:, None] + rng.uniform(-400.0, 400.0,
                                                        (1, n_sats)))


@pytest.mark.parametrize("order", ["ascending", "descending", "random"])
def test_scan_rows_are_sdp4_propagate_alone(order, mixed):
    """The identity the f64 kernel's row walk rests on, on the ragged
    mixed catalog (irez 1 and 2, epochs of both signs): every row of the
    plain ``sdp4_propagate_scan`` equals ``sdp4_propagate`` at that row's
    times alone (a fresh carry, stepped from epoch), bit for bit (r, v,
    codes), and a scan started at a later row, with a fresh carry, equals
    the rest of the whole scan. So a thread may resume the resonance from
    the row before, or start afresh, and give the same bits."""
    pcat = mixed[1]
    irez = np.asarray(pcat.deep_host.irez)
    assert (irez == 1).any() and (irez == 2).any()
    t = _identity_times(order, len(pcat))
    scan = sdp4_propagate_scan(pcat.els, pcat.deep, t, pcat.grav)
    for k in range(len(t)):
        alone = sdp4_propagate(pcat.els, pcat.deep, t[k], pcat.grav)
        assert all(_equal(a[k], b) for a, b in zip(scan, alone[:3])), k
    for k0 in (1, 17, len(t) - 1):
        rest = sdp4_propagate_scan(pcat.els, pcat.deep, t[k0:], pcat.grav)
        assert all(_equal(a[k0:], b) for a, b in zip(scan, rest)), k0


# ---------------------------------------------------------------------------
# The row walk of DENSE (csrc/sgp4_f64.cu sgp4_f64_walk_kernel)
# ---------------------------------------------------------------------------

WARP, BLOCK = 32, 128


def _f64_walk(n_times, n_out, blocks, slot_lane, lane_step, heavy, weight=4):
    """Every point the row walk's threads compute on a grid of ``blocks``
    blocks, thread by thread, as ``(row, output column, lane, fresh)``:
    the points (warp column, row) column after column, a row of the
    columns from ``heavy`` on weighing ``weight`` units and of the others
    one, cut into ``warp_run``'s balanced runs of units, each warp
    walking the points whose units start in its run; thread slot s of a
    column computes output column ``slot_lane[s]`` (lane step 1) or s of
    lane 0 (lane step 0), the lane staged and the carry fresh where the
    run enters a column."""
    n_cols = -(-n_out // WARP)
    light = heavy * n_times
    units = light + (n_cols - heavy) * n_times * weight
    n_warps = blocks * (BLOCK // WARP)
    q, rem = divmod(units, n_warps)
    threads = []
    for warp in range(n_warps):
        first, count = warp * q + min(warp, rem), q + (warp < rem)
        if count == 0:
            continue
        end = first + count
        p = (first if first <= light
             else light + -(-(first - light) // weight))
        for lane_id in range(WARP):
            pos = p if p <= light else light + (p - light) * weight
            col, ti = divmod(p, n_times)
            slot = col * WARP + lane_id
            loaded, visits = -1, []
            while pos < end:
                fresh = False
                if col != loaded:
                    if slot < n_out:
                        n = int(slot_lane[slot]) if lane_step else slot
                        fresh = True
                    loaded = col
                if slot < n_out:
                    visits.append((ti, n, n * lane_step, fresh))
                pos += 1 if col < heavy else weight
                ti += 1
                if ti == n_times:
                    ti, col, slot = 0, col + 1, slot + WARP
            if visits:
                threads.append(visits)
    return threads


@pytest.mark.parametrize("blocks", [1, 3, 1000])
@pytest.mark.parametrize("heavy", ["none", "half"])
@pytest.mark.parametrize("lane_step", [1, 0])
@pytest.mark.parametrize("shape", [(37, 100), (1, 33), (5, 1), (0, 10),
                                   (10, 0), (13, 1000), (1440, 70)])
def test_row_walk_visits_every_point_once(shape, lane_step, heavy, blocks):
    """The row walk computes every (row, column) point of ragged T and N
    exactly once, for any block count, with no column weighed as deep or
    the later half of them, on a permuted slot order (lane step 1) or
    against one lane (lane step 0); a thread's points are runs of
    consecutive rows of one lane, each starting with a fresh carry, so
    the carry it resumes is always the row before's; the host's grid,
    sized as if every column were deep, fits the card at 4 to 6 blocks an
    SM."""
    n_times, n_out = shape
    n_cols = -(-n_out // WARP)
    first_heavy = n_cols if heavy == "none" else n_cols // 2
    slot_lane = np.random.default_rng(n_out).permutation(n_out)
    threads = _f64_walk(n_times, n_out, blocks, slot_lane, lane_step,
                        first_heavy)
    points = sorted((t, n) for visits in threads for t, n, _, _ in visits)
    assert points == [(t, n) for t in range(n_times) for n in range(n_out)]
    for visits in threads:
        assert visits[0][3]
        for (t0, n0, l0, _), (t1, n1, l1, fresh) in zip(visits, visits[1:]):
            assert fresh or (t1 == t0 + 1 and n1 == n0 and l1 == l0)
        assert all(lane == (n if lane_step else 0)
                   for _, n, lane, _ in visits)
    units = n_cols * n_times * 4
    for per_sm in (4, 5, 6):
        b = min(-(-units // (BLOCK // WARP)), per_sm * 132)
        assert units == 0 or (b - 1) * (BLOCK // WARP) < units


def _k2_planes(pcat, jd):
    """K2's plain planes over ``jd`` and what the escape reads."""
    ds = pcat.fast_staging.deep
    t_time = torch.as_tensor((jd - pcat.epoch_min_jd) * 1440.0)
    steps = resonance_steps(jd, pcat.deep_epochs_jd)
    planes = cuda_sgp4.propagate_deep_sep(
        t_time, ds.t_sat, ds.spine, ds.tail, ds.flags,
        pcat.resonance_tables(steps), grav=WGS72,
        kepler_iters=pcat.deep_kepler_iters)
    return t_time, steps, planes


@pytest.mark.parametrize("want_vel", [True, False])
def test_escape_routing_leaves_k2_planes_as_before(want_vel, mixed):
    """The escape through the f64 kernel's wrapper (the whole tables read
    through the lanes' columns) leaves K2's planes as the plain recompute
    on the gathered escape tables wrote them, bit for bit, every other
    column untouched, and counts no launch on the CPU."""
    pcat = mixed[1]
    esc = pcat.heo_escape
    jd = pcat.epoch_min_jd + np.linspace(-2.5, 3.0, 13)
    t_time, steps, (dr, dv, de) = _k2_planes(pcat, jd)
    ts = t_time[:, None] - esc.t_sat[None, :]
    xr, xv, xe = sdp4_propagate_tables(*f64_unstage(*esc.staged), ts, WGS72,
                                       pcat.escape_tables(steps))
    want_r, want_v, want_e = dr.clone(), dv.clone(), de.clone()
    want_r[:, :, esc.idx] = xr.permute(2, 0, 1).to(torch.float32)
    want_v[:, :, esc.idx] = xv.permute(2, 0, 1).to(torch.float32)
    want_e[:, esc.idx] = xe
    before = dict(cuda_sgp4.LAUNCHES)
    _apply_escape(esc, pcat.resonance_tables(steps), t_time, WGS72,
                  want_vel, dr, dv if want_vel else None, de)
    assert dict(cuda_sgp4.LAUNCHES) == before
    assert torch.equal(dr, want_r) and torch.equal(de, want_e)
    if want_vel:
        assert torch.equal(dv, want_v)
    assert esc.idx.dtype == torch.int32


#: the decaying near-earth lane runs away after its decay with error code
#: 0 (python-sgp4's semantics: |r| up to ~1e13 km over these grids), where
#: the two libraries' last bits of sin and cos grow to ~1e-8 of |r|; such
#: points must run away in both packages, and the gates in km hold on the
#: others
RUNAWAY_KM = 1e5


def _assert_close(out_j, out_p, pos_tol=POS_TOL_KM, vel_tol=VEL_TOL_KMS):
    rj, vj, ej = (np.asarray(x) for x in out_j[:3])
    rp, vp, ep = (x.numpy() for x in out_p[:3])
    np.testing.assert_array_equal(ej, ep)
    far = np.linalg.norm(rj, axis=-1) > RUNAWAY_KM
    np.testing.assert_array_equal(far,
                                  np.linalg.norm(rp, axis=-1) > RUNAWAY_KM)
    dr = np.abs(rj - rp).max(axis=-1)[~far].max()
    dv = np.abs(vj - vp).max(axis=-1)[~far].max()
    print(f"f64 kernel route vs JAX: max|dr| {dr:.3e} km, max|dv| "
          f"{dv:.3e} km/s ({far.sum()} runaway points)")
    assert dr <= pos_tol and dv <= vel_tol


@pytest.mark.parametrize("form", ["column", "dense"])
@pytest.mark.parametrize("kind", ["mixed", "near"])
def test_dense_within_jax_f64_gates(kind, form, mixed, near):
    """DENSE against the JAX package's f64 propagators."""
    jcat, pcat = {"mixed": mixed, "near": near}[kind]
    t = T_COL if form == "column" else _dense_times(len(pcat), seed=2)
    if pcat.deep is not None:
        out_j = jsdp4.sdp4_propagate(jcat.els, jcat.deep, t, J_WGS72)
    else:
        out_j = jsgp4.sgp4_propagate(jcat.els, t, J_WGS72)
    out_p = cuda_sgp4.sgp4_f64_dense(torch.from_numpy(t), *pcat.f64_staging,
                                     grav=pcat.grav,
                                     sdp4=pcat.deep is not None)
    assert set(out_p[2].unique().tolist()) > {0}
    _assert_close(out_j, out_p)


@pytest.mark.parametrize("order", ["forward", "backward"])
def test_scan_within_jax_f64_gates(order, mixed):
    """DENSE in SDP4 mode, which the card's scan runs, on the JAX
    package's scan's rows sorted either way, within the gates of that
    scan: every point computed alone stays as close to the scan as the
    scan computed in order."""
    jcat, pcat = mixed
    times = np.linspace(-3100.0, 3700.0, 9)
    if order == "backward":
        times = times[::-1].copy()
    out_j = jsdp4.sdp4_propagate_scan(jcat.els, jcat.deep, times, J_WGS72)
    out_p = cuda_sgp4.sgp4_f64_dense(torch.from_numpy(times[:, None]),
                                     *pcat.f64_staging, grav=pcat.grav,
                                     sdp4=True)
    _assert_close(out_j, out_p)


@pytest.mark.parametrize("scan_times", [False, True])
@pytest.mark.parametrize("output", ["teme", "ecef"])
def test_propagate_f64_within_jax_f64_gates(output, scan_times, mixed):
    """``propagate(method="f64")`` through the new routing, planes, against
    the JAX package's f64 propagate."""
    jcat, pcat = mixed
    jd = np.full(7, 2460311.0)
    fr = np.linspace(-2.0, 2.5, 7)
    kw = dict(method="f64", output=output, layout="planes",
              scan_times=scan_times)
    rj, vj, ej = J.propagate(jcat, jd, fr, **kw)
    rp, vp, ep = P.propagate(pcat, jd, fr, **kw)
    # (3, T, S) planes to (T, S, 3)
    out_j = [np.moveaxis(np.asarray(x), 0, -1) for x in (rj, vj)] + [ej]
    out_p = [x.permute(1, 2, 0) for x in (rp, vp)] + [ep]
    if output == "teme":
        _assert_close(out_j, out_p)
    else:
        _assert_close(out_j, out_p, FIXED_POS_TOL_KM, FIXED_VEL_TOL_KMS)


def test_propagate_tsince_and_the_lanes_path_route_through_dense(
        mixed, monkeypatch):
    """``propagate_tsince`` and ``Satrec.sgp4_array``'s time-as-lanes path
    give the plain functions' bits on the CPU: a mixed catalog takes SDP4,
    a near-earth satrec SGP4."""
    pcat = mixed[1]
    t = torch.from_numpy(T_COL)
    a = P.propagate_tsince(pcat, t)
    b = sdp4_propagate(pcat.els, pcat.deep, t, pcat.grav)
    assert all(_equal(x, y) for x, y in zip(a, b[:3]))

    lines = NEAR.splitlines()
    sat = api.Satrec.twoline2rv(lines[4], lines[5], device="cpu")
    monkeypatch.setattr(api.Satrec, "_on_accel", lambda self: True)
    monkeypatch.setattr(api, "_LANES_MIN_TIMES", {False: 1000, True: 1000})
    n = 1500
    jd = np.full(n, sat.jdsatepoch)
    fr = sat.jdsatepochF + np.linspace(-1.0, 1.0, n)
    e, r, v = sat.sgp4_array(jd, fr)
    cat = sat._catalog()
    tsince = torch.as_tensor(((jd - float(cat.host.epoch_jd[0])) + fr)
                             * 1440.0)
    rp, vp, ep = sgp4_propagate(cat.els, tsince[:, None], cat.grav)
    assert np.array_equal(e, ep[:, 0].numpy())
    assert np.array_equal(r, rp[:, 0].numpy())
    assert np.array_equal(v, vp[:, 0].numpy())


def test_wrappers_raise_on_what_the_kernel_does_not_take(mixed, near):
    """Shapes and dtypes the kernel cannot read raise on any device."""
    pcat, ncat = mixed[1], near[1]
    st, nst = pcat.f64_staging, ncat.f64_staging
    t = torch.from_numpy(T_COL)
    kw = dict(grav=WGS72)
    with pytest.raises(ValueError, match="fields"):
        cuda_sgp4.sgp4_f64_dense(t, *nst, sdp4=True, **kw)
    with pytest.raises(ValueError, match="flags"):
        cuda_sgp4.sgp4_f64_dense(t, st.fields, st.flags[:3], sdp4=True, **kw)
    with pytest.raises(ValueError, match="tsince"):
        cuda_sgp4.sgp4_f64_dense(t.float(), *st, sdp4=True, **kw)
    jd, fr = _epoch_rows("rows")
    with pytest.raises(ValueError, match="jd, fr"):
        cuda_sgp4.sgp4_f64_scan(jd[:, None], fr[:, None], *st, **kw)
    with pytest.raises(ValueError, match="fields"):
        cuda_sgp4.sgp4_f64_scan(jd, fr, *nst, **kw)
    esc = pcat.heo_escape
    jd = pcat.epoch_min_jd + np.linspace(0.0, 1.0, 3)
    t_time, steps, (dr, dv, de) = _k2_planes(pcat, jd)
    tables = pcat.resonance_tables(steps)
    args = (t_time, esc.t_sat, *esc.staged, esc.idx, tables)
    with pytest.raises(ValueError, match="d_v3"):
        cuda_sgp4.sgp4_f64_escape(*args, dr, None, de, **kw)
    with pytest.raises(ValueError, match="idx"):
        cuda_sgp4.sgp4_f64_escape(*args[:4], esc.idx.long(), tables, dr, dv,
                                  de, **kw)
    with pytest.raises(ValueError, match="d_r3"):
        cuda_sgp4.sgp4_f64_escape(*args, dr[:, :, :1], dv, de, **kw)
