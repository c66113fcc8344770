"""The dense-tsince paths against astroz_tpu: kernels K5 and K6 (plain
versions and CPU wrappers), the unified ``ops.propagate_fast`` and
the single-satellite time grid of ``benchmarks/bench_single_sat.py``.

The JAX fast tail takes sin(xmdf) in its drag term where SGP4 takes the
cosine; the port takes the cosine (ROADMAP queue 3). The near-earth JAX
paths run under ``jax_drag_fixed`` (``test_torch_fast.py``); the JAX mixed
branch spells the term inline (``astroz_tpu/ops/fast.py:768``), so
:func:`_jax_propagate_fast_fixed` runs a copy of ``propagate_fast`` with
that one line's sine and cosine swapped.

* K5's and K6's plain versions against the JAX ``spine_f64`` +
  ``shallow_tail_f32`` under jit: positions within 5e-3 km, velocities
  within 5e-6 km/s, error codes identical (``test_torch_fast.py``'s
  bounds). ``propagate_fast_grids`` (the spine kernel, then K6) on CPU
  tensors equals ``propagate_fast_fused``'s plain version bit for bit.
* The CPU wrappers against the TPU kernels in interpret mode: within
  0.05 km (the JAX package's Pallas-vs-XLA gate), error codes identical;
  the TPU's K5 runs a double-f32 spine.
* ``propagate_fast``, near-earth and mixed (table and carry forms),
  against JAX ``propagate_fast`` on ``test_escape.py``'s MIXED_TEXT over
  +-1 day: 0.05 km.
* The single-satellite path (``chip_smoke.single_sat_chunks``): K5's
  wrapper against JAX ``propagate_fast`` chunk by chunk, the port's
  ``sgp4_propagate`` against JAX's within 1e-5 km, and fast against f64
  within the JAX package's 30 m gate over a day.

The CUDA kernels themselves are held against these plain versions on
the card by ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import inspect
import os
import sys
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astroz_tpu import tle as jtle
from astroz_tpu import build_catalog as j_build_catalog
from astroz_tpu.constants import WGS72 as J_WGS72
from astroz_tpu.ops import fast as jfast
from astroz_tpu.ops import pallas_sgp4
from astroz_tpu.ops import sdp4 as jsdp4
from astroz_tpu.ops import sgp4 as jsgp4

from astroz_tpu_torch import build_catalog
from astroz_tpu_torch.constants import WGS72
from astroz_tpu_torch.convert import carry_from_numpy
from astroz_tpu_torch.ops import cuda_sgp4, propagate_fast, sgp4_propagate
from astroz_tpu_torch.ops.fast import (SPINE_FIELD_NAMES, shallow_staging,
                                       spine_f64)
from astroz_tpu_torch.ops.sdp4 import fresh_carry

from test_escape import MIXED_TEXT
from test_torch_fast import _jax_tail, jax_drag_fixed  # noqa: F401
from test_torch_init import LEO_TEXT

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

POS_TOL_KM = 5e-3
VEL_TOL_KMS = 5e-6
PALLAS_TOL_KM = 0.05


@pytest.fixture(scope="module")
def cats():
    return j_build_catalog(LEO_TEXT), build_catalog(LEO_TEXT, device="cpu")


def _grids(pcat):
    """A dense (16, S) grid of mixed sign (minutes from the earliest
    epoch, -250 .. +2000, minus each epoch, jittered) and a (16, 1)
    column of minutes since every epoch."""
    t_sat = pcat.fast_staging.t_sat.numpy()
    base = np.linspace(-250.0, 2000.0, 16)[:, None]
    jitter = np.random.default_rng(3).uniform(-30.0, 30.0,
                                              (16, len(t_sat)))
    return {"dense": base - t_sat[None, :] + jitter, "column": base}


def _components(out):
    """(r, v | None, err) as numpy from a JAX tail's component tuple."""
    r = np.stack([np.asarray(c) for c in out[:3]], axis=-1)
    v = (np.stack([np.asarray(c) for c in out[3:6]], axis=-1)
         if len(out) == 7 else None)
    return r, v, np.asarray(out[-1])


def _assert_near(ref, got, pos_tol, vel_tol, want_vel, cols=slice(None)):
    """Error codes identical; positions and velocities of the columns
    ``cols`` within the tolerances."""
    r, v, e = ref
    rp, vp, ep = got
    np.testing.assert_array_equal(np.asarray(e), ep.numpy())
    assert np.abs(np.asarray(r) - rp.numpy())[:, cols].max() <= pos_tol
    if want_vel:
        assert np.abs(np.asarray(v) - vp.numpy())[:, cols].max() <= vel_tol
    else:
        assert vp is None


@pytest.mark.parametrize("grid", ["dense", "column"])
@pytest.mark.parametrize("iters", [3, 8])
@pytest.mark.parametrize("want_vel", [True, False])
def test_plain_versions_match_jax_spine_and_tail(cats, jax_drag_fixed, grid,
                                                 iters, want_vel):
    """K5's plain version, and K6's on the port's spine grids, against
    the JAX spine + tail; K5's and K6's plain versions are bit-equal, and
    their positions bit-equal with and without velocities."""
    jcat, pcat = cats
    t = _grids(pcat)[grid]
    ref = _components(_jax_tail(jcat.els, jnp.asarray(t), iters, want_vel))
    k5 = cuda_sgp4.propagate_fast_fused_reference(
        pcat.els, torch.from_numpy(t), WGS72, kepler_iters=iters,
        want_vel=want_vel)
    assert set(k5[2].numpy().ravel().tolist()) >= {0, 1}
    _assert_near(ref, k5, POS_TOL_KM, VEL_TOL_KMS, want_vel)
    grids, tail, flags = cuda_sgp4.spine_grids(pcat.els, torch.from_numpy(t))
    assert all(g.shape == (16, len(pcat)) and g.is_contiguous()
               for g in grids)
    r, v, e = cuda_sgp4.propagate_fast_spine_grids_reference(
        grids, tail, flags, grav=WGS72, kepler_iters=iters,
        want_vel=want_vel)
    assert torch.equal(r, k5[0]) and torch.equal(e, k5[2])
    assert v is None if not want_vel else torch.equal(v, k5[1])
    if not want_vel:
        with_v = cuda_sgp4.propagate_fast_fused_reference(
            pcat.els, torch.from_numpy(t), WGS72, kepler_iters=iters)
        assert torch.equal(with_v[0], k5[0])


def test_dense_plain_version_equals_k1s_on_a_separable_grid(cats):
    """K5's plain version on tsince = t_time - t_sat gives K1's plain
    version's planes bit for bit in its time-major layout; a (T, 1)
    column gives its (T, S) broadcast's."""
    pcat = cats[1]
    st = pcat.fast_staging
    t_time = torch.linspace(-250.0, 2000.0, 9, dtype=torch.float64)
    kw = dict(grav=WGS72, kepler_iters=3)
    k1 = cuda_sgp4.propagate_fast_sep_reference(t_time, st.t_sat, st.spine,
                                                st.tail, st.flags, **kw)
    tsince = (t_time[:, None] - st.t_sat[None, :]).contiguous()
    k5 = cuda_sgp4.propagate_fast_dense_reference(tsince, st.spine, st.tail,
                                                  st.flags, **kw)
    assert torch.equal(k5[0], k1[0].permute(1, 2, 0))
    assert torch.equal(k5[1], k1[1].permute(1, 2, 0))
    assert torch.equal(k5[2], k1[2])
    col = t_time[:, None].contiguous()
    wide = col.expand(-1, len(pcat)).contiguous()
    a = cuda_sgp4.propagate_fast_dense(col, st.spine, st.tail, st.flags,
                                       **kw)
    b = cuda_sgp4.propagate_fast_dense(wide, st.spine, st.tail, st.flags,
                                       **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_staging_of_elements_is_the_catalogs(cats):
    """``shallow_staging`` of the catalog's elements is its
    ``fast_staging``, and of one satellite broadcast to 128 lanes, that
    satellite's columns repeated."""
    pcat = cats[1]
    st = pcat.fast_staging
    spine, tail, flags = shallow_staging(pcat.els)
    assert torch.equal(spine, st.spine) and torch.equal(tail, st.tail)
    assert torch.equal(flags, st.flags)
    one = type(pcat.els)(*(x[:1].expand(128) for x in pcat.els))
    s1, t1, f1 = shallow_staging(one)
    assert s1.is_contiguous() and s1.shape == (12, 128)
    assert torch.equal(s1, st.spine[:, :1].expand(-1, 128))
    assert torch.equal(t1, st.tail[:, :1].expand(-1, 128))
    assert torch.equal(f1, st.flags[:, :1].expand(-1, 128))


@pytest.mark.parametrize("want_vel", [True, False])
@pytest.mark.parametrize("grid", ["dense", "column"])
def test_cpu_wrappers_match_pallas_interpret(cats, jax_drag_fixed, grid,
                                             want_vel):
    """K5's and K6's wrappers on CPU tensors against
    ``propagate_fast_pallas_fused`` and ``propagate_fast_pallas`` in
    interpret mode; the CPU runs no kernel. The decaying lane (SYN-1,
    bstar 0.5) is held to its error codes only: in its last revolutions
    its drag turns the TPU kernel's double-f32 spine's ~1e-7 rad into
    kilometres (20 km on one point of the dense grid, 0.02 km at most on
    the other lanes)."""
    jcat, pcat = cats
    t = _grids(pcat)[grid]
    cols = np.array([name != "SYN-1" for name in pcat.names])
    before = dict(cuda_sgp4.LAUNCHES)
    for jfn, pfn in ((pallas_sgp4.propagate_fast_pallas_fused,
                      cuda_sgp4.propagate_fast_fused),
                     (pallas_sgp4.propagate_fast_pallas,
                      cuda_sgp4.propagate_fast_grids)):
        ref = jfn(jcat.els, jnp.asarray(t), J_WGS72, kepler_iters=5,
                  time_block=8, sat_block=128, interpret=True,
                  want_vel=want_vel)
        got = pfn(pcat.els, torch.from_numpy(t), WGS72, kepler_iters=5,
                  want_vel=want_vel)
        assert tuple(got[0].shape) == (16, len(pcat), 3)
        _assert_near(ref, got, PALLAS_TOL_KM, 5e-5, want_vel, cols)
    assert cuda_sgp4.LAUNCHES == before


@pytest.mark.parametrize("grid", ["dense", "column"])
def test_spine_grids_plain_version(cats, grid):
    """The spine kernel's wrapper on CPU tensors runs its plain version:
    six contiguous (T, S) f32 grids, ``ops.fast.spine_f64`` broadcast to
    (T, S), and a (T, 1) column gives its (T, S) broadcast's grids."""
    pcat = cats[1]
    st = pcat.fast_staging
    t = torch.from_numpy(_grids(pcat)[grid])
    before = dict(cuda_sgp4.LAUNCHES)
    grids = cuda_sgp4.spine_f64_grids(t, st.spine)
    assert cuda_sgp4.LAUNCHES == before
    shape = (16, len(pcat))
    assert all(g.shape == shape and g.dtype == torch.float32
               and g.is_contiguous() for g in grids)
    plain = spine_f64(t, **dict(zip(SPINE_FIELD_NAMES, st.spine)))
    assert all(torch.equal(g, p.expand(shape)) for g, p in zip(grids, plain))
    wide = cuda_sgp4.spine_f64_grids(t.expand(shape).contiguous(), st.spine)
    assert all(torch.equal(a, b) for a, b in zip(grids, wide))


@pytest.mark.parametrize("want_vel", [True, False])
@pytest.mark.parametrize("iters", [3, 8])
@pytest.mark.parametrize("grid", ["dense", "column"])
def test_grids_path_equals_fused_plain_version(cats, grid, iters, want_vel):
    """``propagate_fast_grids`` on CPU tensors (the spine kernel's and
    K6's plain versions, K6 into the time-major layout) equals
    ``propagate_fast_fused_reference`` bit for bit, contiguous, and
    counts no launch."""
    pcat = cats[1]
    t = torch.from_numpy(_grids(pcat)[grid])
    kw = dict(kepler_iters=iters, want_vel=want_vel)
    before = dict(cuda_sgp4.LAUNCHES)
    got = cuda_sgp4.propagate_fast_grids(pcat.els, t, WGS72, **kw)
    ref = cuda_sgp4.propagate_fast_fused_reference(pcat.els, t, WGS72, **kw)
    assert cuda_sgp4.LAUNCHES == before
    assert tuple(got[0].shape) == (16, len(pcat), 3)
    assert got[0].is_contiguous() and (got[1] is None) == (not want_vel)
    assert _equal(got, ref)
    assert _equal(cuda_sgp4.propagate_fast_grids_reference(pcat.els, t, WGS72,
                                                           **kw), ref)


def test_wrappers_reject_bad_inputs(cats):
    st = cats[1].fast_staging
    kw = dict(grav=WGS72, kepler_iters=3)
    t = torch.zeros((4, len(cats[1])), dtype=torch.float64)
    with pytest.raises(ValueError, match="tsince"):
        cuda_sgp4.propagate_fast_dense(t[:, :3], st.spine, st.tail,
                                       st.flags, **kw)
    with pytest.raises(ValueError, match="tsince"):
        cuda_sgp4.propagate_fast_dense(t.float(), st.spine, st.tail,
                                       st.flags, **kw)
    with pytest.raises(ValueError, match="tsince"):
        cuda_sgp4.propagate_fast_dense(t[0], st.spine, st.tail, st.flags,
                                       **kw)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_sgp4.propagate_fast_dense(t.T.contiguous().T, st.spine,
                                       st.tail, st.flags, **kw)
    with pytest.raises(ValueError, match="tsince"):
        cuda_sgp4.spine_f64_grids(t[:, :3], st.spine)
    with pytest.raises(ValueError, match="spine"):
        cuda_sgp4.spine_f64_grids(t, st.spine.float())
    grids = [torch.zeros(t.shape) for _ in range(6)]
    with pytest.raises(ValueError, match="grids"):
        cuda_sgp4.propagate_fast_spine_grids(grids[:5], st.tail, st.flags,
                                             **kw)
    grids[2] = grids[2].double()
    with pytest.raises(ValueError, match=r"grids\[2\]"):
        cuda_sgp4.propagate_fast_spine_grids(grids, st.tail, st.flags, **kw)
    with pytest.raises(ValueError, match="device"):
        cuda_sgp4.propagate_fast_dense(t.to("meta"), st.spine.to("meta"),
                                       st.tail.to("meta"),
                                       st.flags.to("meta"), **kw)


# ---------------------------------------------------------------------------
# ops.propagate_fast against the JAX package's
# ---------------------------------------------------------------------------


def _jax_propagate_fast_fixed():
    """A copy of the JAX ``propagate_fast`` whose mixed branch takes
    cos(xmdf) in its drag term (its sincos returns (sin, cos); the line
    unpacks them the other way round). Near-earth catalogs go through
    ``shallow_tail_f32``, which ``jax_drag_fixed`` corrects."""
    src = inspect.getsource(jfast.propagate_fast)
    wrong = "cos_xmdf, _unused = sincos(xmdf32)"
    assert src.count(wrong) == 1
    ns = dict(vars(jfast))
    exec(compile(src.replace(wrong, "_unused, cos_xmdf = sincos(xmdf32)"),
                 jfast.__file__, "exec"), ns)
    return ns["propagate_fast"]


@pytest.fixture(scope="module")
def mixed():
    text = "\n".join([MIXED_TEXT] * 3)
    jcat = j_build_catalog(jtle.TleArrays.from_text(text,
                                                    allow_native=False))
    return jcat, build_catalog(text, device="cpu")


def _mixed_grid(pcat):
    return (np.linspace(-1440.0, 1440.0, 13)[:, None]
            + np.random.default_rng(8).uniform(-20.0, 20.0, (13, len(pcat))))


@pytest.mark.parametrize("form", ["tables", "carry"])
def test_propagate_fast_mixed_matches_jax(mixed, form):
    jcat, pcat = mixed
    t = _mixed_grid(pcat)
    kw = {}
    pkw = {}
    if form == "tables":
        kw = pkw = dict(resonance_steps=4)
    else:
        n = len(pcat)
        # a carry 1,440 minutes out: the points at or below it restart
        _, _, _, c = jsdp4.sdp4_propagate(jcat.els, jcat.deep,
                                          np.full(n, 1440.0), J_WGS72)
        kw, pkw = dict(carry=c), dict(carry=carry_from_numpy(c, "cpu"))
    fn = jax.jit(lambda els, deep, tt: _jax_propagate_fast_fixed()(
        els, deep, tt, J_WGS72, kepler_iters=8, **kw))
    rj, vj, ej = fn(jcat.els, jcat.deep, jnp.asarray(t))
    rp, vp, ep = propagate_fast(pcat.els, pcat.deep, torch.from_numpy(t),
                                WGS72, kepler_iters=8, **pkw)
    assert rp.dtype == torch.float32 and tuple(rp.shape) == (13, len(pcat),
                                                             3)
    np.testing.assert_array_equal(np.asarray(ej), ep.numpy())
    assert (ep == 0).float().mean().item() > 0.9
    assert np.abs(np.asarray(rj) - rp.numpy()).max() <= PALLAS_TOL_KM
    assert np.abs(np.asarray(vj) - vp.numpy()).max() <= 5e-5


def test_propagate_fast_carry_equals_tables(mixed):
    """The masked 720-minute loop from a fresh carry and the table rows
    integrate the same recurrence: equal error codes, positions within
    the f32 tail's rounding."""
    _, pcat = mixed
    t = torch.from_numpy(_mixed_grid(pcat))
    a = propagate_fast(pcat.els, pcat.deep, t, WGS72, resonance_steps=4)
    b = propagate_fast(pcat.els, pcat.deep, t, WGS72,
                       carry=fresh_carry(pcat.deep, pcat.els.no_unkozai))
    assert torch.equal(a[2], b[2])
    assert (a[0] - b[0]).abs().max().item() <= 1e-3


@pytest.mark.parametrize("shape", ["column", "dense", "flat"])
def test_propagate_fast_near_earth_matches_jax(cats, jax_drag_fixed, shape):
    """``deep=None`` goes through K5's wrapper (its plain version here),
    for a (T, 1), a (T, S) and an (S,) tsince."""
    jcat, pcat = cats
    g = _grids(pcat)
    t = {"column": g["column"], "dense": g["dense"],
         "flat": g["dense"][5]}[shape]
    fn = jax.jit(lambda els, tt: jfast.propagate_fast(els, None, tt, J_WGS72,
                                                      kepler_iters=5))
    rj, vj, ej = fn(jcat.els, jnp.asarray(t))
    before = dict(cuda_sgp4.LAUNCHES)
    rp, vp, ep = propagate_fast(pcat.els, None, torch.from_numpy(t), WGS72,
                                kepler_iters=5)
    assert cuda_sgp4.LAUNCHES == before
    assert tuple(rp.shape) == tuple(rj.shape)
    _assert_near((rj, vj, ej), (rp, vp, ep), POS_TOL_KM, VEL_TOL_KMS, True)


# ---------------------------------------------------------------------------
# The single-satellite time grid (bench_single_sat.py, time as lanes)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as mod
    finally:
        sys.path.remove(REPO)
    return mod


def test_single_sat_grid_is_the_benchs(chip_smoke):
    """``single_sat_chunks`` makes bench_single_sat's chunks: the padded
    point count, the chunk size and the values."""
    step = 60.0
    chunks = list(chip_smoke.single_sat_chunks(3000, step, lanes=128,
                                               max_chunk=1024, device="cpu"))
    assert [tuple(c.shape) for c in chunks] == [(8, 128)] * 3
    flat = torch.cat([c.reshape(-1) for c in chunks]).numpy()
    np.testing.assert_array_equal(flat, np.arange(3072) * (step / 60.0))
    year = chip_smoke.single_sat_chunks(31536000, 1.0, device="cpu")
    sizes = [c.shape[0] for c in year]
    assert len(sizes) == 8 and sum(sizes) == 30797 and sizes[0] == 4096


def test_single_sat_path_matches_jax(chip_smoke, jax_drag_fixed):
    """The ISS at 128 lanes over 3,000 one-minute points in 1,024-point
    chunks: K5's wrapper against JAX ``propagate_fast`` and the port's
    ``sgp4_propagate`` against JAX's, chunk by chunk; fast vs f64 within
    the JAX package's 30 m over the first day."""
    text = chip_smoke.GOLDEN_L1 + "\n" + chip_smoke.GOLDEN_L2
    jcat = j_build_catalog(text)
    pcat = build_catalog(text, device="cpu")
    els = chip_smoke.single_sat_elements(pcat, 128)
    jels = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (128,) + x.shape[1:])
        if getattr(x, "ndim", 0) else x, jcat.els)
    run_fast = jax.jit(lambda tt: jfast.propagate_fast(jels, None, tt,
                                                       J_WGS72,
                                                       kepler_iters=5))
    run_f64 = jax.jit(lambda tt: jsgp4.sgp4_propagate(jels, tt, J_WGS72))
    worst_day = 0.0
    for k, t in enumerate(chip_smoke.single_sat_chunks(
            3000, 60.0, lanes=128, max_chunk=1024, device="cpu")):
        fast = cuda_sgp4.propagate_fast_fused(els, t, WGS72, kepler_iters=5)
        f64 = sgp4_propagate(els, t, WGS72)
        tj = jnp.asarray(t.numpy())
        _assert_near(run_fast(tj), fast, POS_TOL_KM, VEL_TOL_KMS, True)
        rj, vj, ej = run_f64(tj)
        np.testing.assert_array_equal(np.asarray(ej), f64[2].numpy())
        assert np.abs(np.asarray(rj) - f64[0].numpy()).max() <= 1e-5
        assert (fast[2] == 0).all() and torch.equal(fast[2], f64[2])
        day = t <= 1440.0
        d = (fast[0].double() - f64[0]).norm(dim=-1)[day]
        if d.numel():
            worst_day = max(worst_day, d.max().item())
        if k == 0:
            assert fast[0].shape == (8, 128, 3)
            sp = spine_f64(t, **{n: getattr(els, n) for n in
                                 ("mo", "mdot", "argpo", "argpdot", "nodeo",
                                  "nodedot", "nodecf", "no_unkozai", "t2cof",
                                  "t3cof", "t4cof", "t5cof")})
            assert sp[0].shape == (8, 128)
    assert 0.0 < worst_day < 0.03


# ---------------------------------------------------------------------------
# The element-level wrappers stage each element set once
# ---------------------------------------------------------------------------


def _equal(a, b):
    return all(x is y is None or torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("form", ["catalog", "broadcast"])
def test_staging_is_kept_per_element_set(cats, monkeypatch, form):
    """``propagate_fast_fused`` (and ``spine_grids``) stage an element set
    once: the same tensors give the kept staging; an in-place edit of one
    field (through the base of an expanded view too) or other elements
    stage afresh, and the outputs after a miss equal a fresh plain call's
    bit for bit."""
    pcat = cats[1]
    calls = []
    real = cuda_sgp4.shallow_staging
    monkeypatch.setattr(cuda_sgp4, "shallow_staging",
                        lambda els: calls.append(1) or real(els))
    monkeypatch.setattr(cuda_sgp4, "_STAGED", None)
    base = type(pcat.els)(*(x.clone() for x in pcat.els))
    els = (base if form == "catalog"
           else type(base)(*(x[2:3].expand(16) for x in base)))
    t = torch.from_numpy(_grids(pcat)["column"])

    def fused():
        before = len(calls)
        out = cuda_sgp4.propagate_fast_fused(els, t, WGS72, kepler_iters=5)
        return out, len(calls) - before

    def fresh():
        return cuda_sgp4.propagate_fast_fused_reference(els, t, WGS72,
                                                        kepler_iters=5)

    first, staged = fused()
    again, staged_again = fused()
    before = len(calls)
    cuda_sgp4.spine_grids(els, t)
    assert (staged, staged_again, len(calls) - before) == (1, 0, 0)
    assert _equal(first, again) and _equal(first, fresh())
    base.bstar.mul_(2.0)  # one field, in place
    edited, staged = fused()
    assert staged == 1 and _equal(edited, fresh())
    assert not torch.equal(edited[0], first[0])
    els = type(els)(*(x.clone() for x in els))  # other elements
    other, staged = fused()
    assert staged == 1 and _equal(other, fresh()) and _equal(other, edited)


def test_staging_of_numpy_backed_elements_is_never_kept(cats, monkeypatch):
    """Elements whose memory numpy owns can be written without torch's
    version counter moving: each call stages them afresh, so an edit made
    through numpy shows in the next call's outputs, as in a fresh plain
    call's, bit for bit."""
    pcat = cats[1]
    calls = []
    real = cuda_sgp4.shallow_staging
    monkeypatch.setattr(cuda_sgp4, "shallow_staging",
                        lambda els: calls.append(1) or real(els))
    monkeypatch.setattr(cuda_sgp4, "_STAGED", None)
    arrays = [x.numpy().copy() for x in pcat.els]
    els = type(pcat.els)(*(torch.from_numpy(a) for a in arrays))
    t = torch.from_numpy(_grids(pcat)["column"])
    first = cuda_sgp4.propagate_fast_fused(els, t, WGS72, kepler_iters=5)
    arrays[pcat.els._fields.index("bstar")] *= 2.0  # behind torch's back
    edited = cuda_sgp4.propagate_fast_fused(els, t, WGS72, kepler_iters=5)
    assert len(calls) == 2 and cuda_sgp4._STAGED is None
    assert _equal(edited, cuda_sgp4.propagate_fast_fused_reference(
        els, t, WGS72, kepler_iters=5))
    assert not torch.equal(edited[0], first[0])


def test_staging_keeps_no_elements_alive(cats, monkeypatch):
    """The kept entry refers to its elements weakly: once the caller drops
    them they are freed, and new elements stage afresh."""
    pcat = cats[1]
    monkeypatch.setattr(cuda_sgp4, "_STAGED", None)
    els = type(pcat.els)(*(x.clone() for x in pcat.els))
    t = torch.from_numpy(_grids(pcat)["column"])
    kept = cuda_sgp4.propagate_fast_fused(els, t, WGS72, kepler_iters=5)
    refs = [weakref.ref(x) for x in els]
    assert cuda_sgp4._STAGED is not None
    del els
    assert all(ref() is None for ref in refs)
    other = type(pcat.els)(*(x.clone() for x in pcat.els))
    assert _equal(kept, cuda_sgp4.propagate_fast_fused(other, t, WGS72,
                                                       kepler_iters=5))
    assert all(ref() is x
               for (ref, _), x in zip(cuda_sgp4._STAGED[0], other))


# ---------------------------------------------------------------------------
# The persistent grid's walk (csrc/sgp4_common.cuh: warp_run), in Python
# ---------------------------------------------------------------------------

WARP, BLOCK = 32, 128


def _grid_blocks(units, per_sm, sms):
    """``persistent_grid``'s block count."""
    warps = BLOCK // WARP
    return min(-(-units // warps), per_sm * sms)


def _walk(n_times, n_sats, blocks, sat_stride):
    """Every (t, s) point that K5's threads (and K2's) compute on a grid
    of ``blocks`` blocks, with the tsince index each point reads, as the
    kernels walk their warps' runs of (warp column, time row) units:
    ``warp_run``'s split, the column reload, the next unit's tsince
    loaded ahead. Returns the visits and the warps' column reloads."""
    units = -(-n_sats // WARP) * n_times
    n_warps = blocks * (BLOCK // WARP)
    q, rem = divmod(units, n_warps)
    row_stride = n_sats if sat_stride else 1
    visits, reloads = [], []

    def index(ti, s):
        return ti * row_stride + s * sat_stride

    for warp in range(n_warps):
        first, count = warp * q + min(warp, rem), q + (warp < rem)
        if count == 0:
            continue
        loads = 0
        for lane in range(WARP):
            col, ti = divmod(first, n_times)
            s = col * WARP + lane
            loaded = -1
            t_next = index(ti, s) if s < n_sats else None
            for k in range(count, 0, -1):
                if col != loaded:
                    loads += lane == 0
                    loaded = col
                t_row, t_sat, t = ti, s, t_next
                ti += 1
                if ti == n_times:
                    ti, col, s = 0, col + 1, s + WARP
                if k > 1 and s < n_sats:
                    t_next = index(ti, s)
                if t_sat < n_sats:
                    visits.append((t_row, t_sat, t))
        reloads.append(loads)
    return visits, reloads


@pytest.mark.parametrize("blocks", [1, 2, 3, 7, 64, 1000])
@pytest.mark.parametrize("sat_stride", [1, 0])
@pytest.mark.parametrize("shape", [(37, 100), (1, 33), (5, 1), (0, 10),
                                   (10, 0), (64, 64), (13, 1000)])
def test_persistent_walk_visits_every_point_once(shape, sat_stride, blocks):
    """The walk of K5 and K2 computes every (t, s) point of ragged T and
    S exactly once, reading its own tsince (of a (T, S) grid, or of a
    (T, 1) column with a satellite stride of 0), for any block count; a
    warp reloads its fields at most twice when there is a warp for every
    column; the host's grid gives every warp a unit and fits the card."""
    n_times, n_sats = shape
    visits, reloads = _walk(n_times, n_sats, blocks, sat_stride)
    row_stride = n_sats if sat_stride else 1
    assert sorted((t, s) for t, s, _ in visits) == [
        (t, s) for t in range(n_times) for s in range(n_sats)]
    assert all(i == t * row_stride + s * sat_stride for t, s, i in visits)
    columns = -(-n_sats // WARP)
    if blocks * (BLOCK // WARP) >= columns:
        assert max(reloads, default=0) <= 2
    units = columns * n_times
    b = _grid_blocks(units, per_sm=5, sms=132)
    assert b <= 5 * 132 and (units == 0 or (b - 1) * (BLOCK // WARP) < units)


def _k6_walk(n_times, n_sats, blocks):
    """Every point K6's threads compute on a grid of ``blocks`` blocks, as
    (t, s, grid index read ahead, planes store index, time-major store
    index of r's first component): K5's walk on (T, S) grids, which K6
    always reads with a satellite stride of 1."""
    visits, reloads = _walk(n_times, n_sats, blocks, sat_stride=1)
    return [(t, s, i, t * n_sats + s, 3 * (t * n_sats + s))
            for t, s, i in visits], reloads


@pytest.mark.parametrize("blocks", [1, 3, 7, 1000])
@pytest.mark.parametrize("shape", [(37, 100), (1, 33), (1, 1), (3, 31),
                                   (0, 10), (10, 0), (64, 64), (13, 1000),
                                   (4096, 33)])
def test_k6_walk_visits_every_point_once(shape, blocks):
    """K6's walk of the six (T, S) grids, ragged T and S, S not a multiple
    of 32, T = 1, T or S = 0: every point once, each reading its own grid
    values ahead and writing its own slot of the (3, T, S) planes and of
    the time-major (T, S, 3) r, v, and no other; a warp reloads its tail
    fields at most twice when there is a warp for every column; the
    host's grid fits the card at any of the block counts an SM that
    K6's launch bounds were timed at (6, 8, 10)."""
    n_times, n_sats = shape
    visits, reloads = _k6_walk(n_times, n_sats, blocks)
    points = [(t, s) for t in range(n_times) for s in range(n_sats)]
    assert sorted((t, s) for t, s, *_ in visits) == points
    assert all(i == plane == t * n_sats + s
               for t, s, i, plane, _ in visits)
    assert sorted(tm // 3 for *_, tm in visits) == list(range(len(points)))
    assert all(tm % 3 == 0 and tm + 2 < 3 * len(points)
               for *_, tm in visits)
    columns = -(-n_sats // WARP)
    if blocks * (BLOCK // WARP) >= columns:
        assert max(reloads, default=0) <= 2
    units = columns * n_times
    for per_sm in (6, 8, 10):
        b = _grid_blocks(units, per_sm=per_sm, sms=132)
        assert b <= per_sm * 132
        assert units == 0 or (b - 1) * (BLOCK // WARP) < units
