"""The deep-space pieces of the port against astroz_tpu: SDP4 init, the
resonance tables, kernel K2's plain version and wrapper, the fast math
K2 inlines, and the f64 escape.

Tolerances, each with the value measured on these inputs:

* SDP4 init: every field bit-equal (both run the same numpy formulas).
* Resonance tables, relative to each table's largest value: the f64
  integrator state (xli, xni, xldot) 1e-10, measured 7.3e-13; the
  derivatives the f32 sine series gives (xndt, xnddt) 1e-6, measured
  1.6e-7, about an f32 ulp (XLA fuses the series).
* K2's plain version (``deep_spine_f64`` + ``deep_tail_f32`` in torch) vs
  the JAX package's, jitted on XLA:CPU: positions 0.05 km, velocities
  5e-5 km/s, the JAX package's own Pallas-vs-XLA gate (one f32 ulp is
  3.9 m at GEO radius); measured 0.022 km and 1.6e-5 km/s. XLA fuses,
  contracts and spells 1/sqrt as its rsqrt.
* The K2 wrapper on CPU tensors vs the TPU kernel
  ``propagate_deep_pallas`` in interpret mode: the same bounds; measured
  0.023 km and 1.6e-5 km/s.
* fast_atan2 and pow23 run op by op in both packages: at most 1 ulp
  (measured 0).
* The f64 escape ``sdp4_propagate_tables`` vs the JAX one: 1e-5 km and
  1e-8 km/s, measured 1.1e-6 km and 7.2e-10 km/s: f64 throughout, but
  its resonance tables carry the ulp-level differences of the f32 sine
  series above into the integrated mean motion.

Error codes are identical everywhere. The CUDA kernel itself is held
against the plain version on the card by ``test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import astroz_tpu.constants as jconst
from astroz_tpu import build_catalog as j_build_catalog
from astroz_tpu import tle as jtle
from astroz_tpu.constants import WGS72 as J_WGS72
from astroz_tpu.ops import fast as jfast
from astroz_tpu.ops import fastmath as jfm
from astroz_tpu.ops import pallas_sgp4
from astroz_tpu.ops.sdp4 import sdp4_init_np as j_sdp4_init_np
from astroz_tpu.ops.sgp4 import sgp4_init_np as j_sgp4_init_np

import astroz_tpu_torch.constants as pconst
from astroz_tpu_torch import build_catalog
from astroz_tpu_torch.constants import WGS72
from astroz_tpu_torch.convert import (deep_elements_from_numpy,
                                      elements_from_numpy)
from astroz_tpu_torch.ops import cuda_sgp4
from astroz_tpu_torch.ops import fast as pfast
from astroz_tpu_torch.ops import fastmath as pfm
from astroz_tpu_torch.ops.sdp4 import DeepElements
from astroz_tpu_torch.ops.sdp4 import sdp4_init_np as p_sdp4_init_np
from astroz_tpu_torch.ops.sgp4 import sgp4_init_np as p_sgp4_init_np
from astroz_tpu_torch.propagation import resonance_steps

from test_torch_cuda import synthetic_deep_text, synthetic_leo_text
from test_torch_fastmath import _ulps
from test_torch_init import DEEP_TEXT, LEO_TEXT, _assert_bit_equal

torch.set_num_threads(1)

#: 16 near-earth and 48 deep lanes, deep epochs spread over +-2 days
TEXT = "\n".join([synthetic_leo_text(16, seed=3, decaying=False),
                  synthetic_deep_text()])
#: minutes from the earliest epoch: backward and forward of every deep
#: epoch
T_MIN = np.linspace(-1440.0, 7200.0, 9)

POS_TOL_KM = 0.05
VEL_TOL_KMS = 5e-5


@pytest.fixture(scope="module")
def cats():
    jcat = j_build_catalog(jtle.TleArrays.from_text(TEXT,
                                                    allow_native=False))
    pcat = build_catalog(TEXT, device="cpu")
    steps = resonance_steps(pcat.epoch_min_jd + T_MIN / 1440.0,
                            pcat.deep_epochs_jd)
    return jcat, pcat, steps


def _j_tsince(jcat):
    return jnp.asarray(T_MIN)[:, None] - jcat.fast_staging[1][None, :]


def _slots(jcat, pcat):
    """For each of the port's deep slots (``deep_idx``, grouped by regime
    for kernel K2: ``propagation.deep_slots``) its position in the JAX
    package's deep subset (the deep columns in catalog order)."""
    return np.searchsorted(np.asarray(jcat.deep_idx), pcat.deep_idx)


def _twin(pcat, steps, iters, want_vel):
    ds = pcat.fast_staging.deep
    return cuda_sgp4.propagate_deep_sep_reference(
        torch.from_numpy(T_MIN), ds.t_sat, ds.spine, ds.tail, ds.flags,
        pcat.resonance_tables(steps), grav=WGS72, kepler_iters=iters,
        want_vel=want_vel)


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def _jax_deep(els, deep, tsince, steps, iters, want_vel):
    tables = jfast.build_resonance_tables(deep, els, n_steps=steps)
    spine = jfast.deep_spine_f64(els, deep, tsince, steps, None, tables)
    return jfast.deep_tail_f32(J_WGS72, iters, *spine, want_vel=want_vel,
                               **jfast.deep_f32_fields(els, deep))


@pytest.mark.parametrize("grav", ["WGS72", "WGS84", "WGS72OLD"])
def test_sdp4_init_np_matches_jax(grav):
    """Every DeepElements field bit-equal, on near-earth lanes (all
    zero), GPS, GEO (irez 1), Molniya (irez 2) and the synthetic deep
    lanes."""
    a = jtle.TleArrays.from_text(
        "\n".join([LEO_TEXT, DEEP_TEXT, synthetic_deep_text()]),
        allow_native=False)
    kw = {f: np.asarray(getattr(a, f)) for f in
          ("no_kozai", "ecco", "inclo", "nodeo", "argpo", "mo", "bstar",
           "epoch_jd")}
    jels = j_sgp4_init_np(getattr(jconst, grav), **kw)
    pels = p_sgp4_init_np(getattr(pconst, grav), **kw)
    j = j_sdp4_init_np(getattr(jconst, grav), jels)
    p = p_sdp4_init_np(getattr(pconst, grav), pels)
    assert DeepElements._fields == type(j)._fields
    for f in DeepElements._fields:
        _assert_bit_equal(getattr(j, f), getattr(p, f), f)
    assert set(np.asarray(p.irez).tolist()) == {0, 1, 2}


def test_deep_staging_matches_jax(cats):
    """The partition, the deep epochs and the deep subset's coefficients
    carried across from the JAX catalog are the port's own, bit for
    bit."""
    jcat, pcat, _ = cats
    pos = _slots(jcat, pcat)
    np.testing.assert_array_equal(np.asarray(jcat.deep_idx),
                                  np.sort(pcat.deep_idx))
    np.testing.assert_array_equal(np.asarray(jcat.deep_idx)[pos],
                                  pcat.deep_idx)
    np.testing.assert_array_equal(np.asarray(jcat.fast_staging[1])[pos],
                                  pcat.fast_staging.deep.t_sat.numpy())
    deep = deep_elements_from_numpy(jcat.deep_sub, "cpu")
    els = elements_from_numpy(jcat.els_deep, "cpu")
    for a, b in zip(deep + els, pcat.deep_sub + pcat.els_deep):
        assert a.dtype == b.dtype and torch.equal(a[pos], b)
    assert pcat.deep_kepler_iters == jcat.deep_kepler_iters == 6


def test_resonance_tables_match_jax(cats):
    jcat, pcat, steps = cats
    tj = jfast.build_resonance_tables(jcat.deep_sub, jcat.els_deep,
                                      n_steps=steps)
    tp = pcat.resonance_tables(steps)
    assert tp.shape == (5, 2 * (steps + 1), pcat.n_deep)
    rtol = dict(xli=1e-10, xni=1e-10, xldot=1e-10, xndt=1e-6, xnddt=1e-6)
    pos = _slots(jcat, pcat)
    for name, a, b in zip(pfast.RESONANCE_TABLE_NAMES, tj, tp):
        a = np.asarray(a)[..., pos]
        scale = np.abs(a).max()
        assert np.abs(a - b.numpy()).max() <= rtol[name] * scale, name


@pytest.mark.parametrize("iters", [6, 8])
@pytest.mark.parametrize("want_vel", [True, False])
def test_twin_matches_jax_spine_and_tail(cats, iters, want_vel):
    jcat, pcat, steps = cats
    out = _jax_deep(jcat.els_deep, jcat.deep_sub, _j_tsince(jcat), steps,
                    iters, want_vel)
    r3, v3, err = _twin(pcat, steps, iters, want_vel)
    pos = _slots(jcat, pcat)
    np.testing.assert_array_equal(np.asarray(out[-1])[:, pos], err.numpy())
    assert set(err.numpy().ravel().tolist()) == {0, 1, 6}
    rj = np.stack([np.asarray(c) for c in out[:3]])[..., pos]
    assert np.abs(rj - r3.numpy()).max() <= POS_TOL_KM
    if want_vel:
        vj = np.stack([np.asarray(c) for c in out[3:6]])[..., pos]
        assert np.abs(vj - v3.numpy()).max() <= VEL_TOL_KMS
    else:
        assert v3 is None
        r_vel, _, _ = _twin(pcat, steps, iters, True)
        np.testing.assert_array_equal(r3.numpy(), r_vel.numpy())


@pytest.mark.parametrize("want_vel", [True, False])
def test_wrapper_cpu_matches_pallas_interpret(cats, want_vel):
    jcat, pcat, steps = cats
    outs = pallas_sgp4.propagate_deep_pallas(
        jcat.els_deep, jcat.deep_sub, _j_tsince(jcat), J_WGS72,
        kepler_iters=6, resonance_steps=steps, interpret=True,
        planes=True, want_vel=want_vel)
    ds = pcat.fast_staging.deep
    before = dict(cuda_sgp4.LAUNCHES)
    r3, v3, err = cuda_sgp4.propagate_deep_sep(
        torch.from_numpy(T_MIN), ds.t_sat, ds.spine, ds.tail, ds.flags,
        pcat.resonance_tables(steps), grav=WGS72, kepler_iters=6,
        want_vel=want_vel)
    assert cuda_sgp4.LAUNCHES == before  # the CPU runs no kernel
    assert r3.shape == (3, len(T_MIN), pcat.n_deep)
    pos = _slots(jcat, pcat)
    np.testing.assert_array_equal(np.asarray(outs[-1])[:, pos], err.numpy())
    assert (np.abs(np.asarray(outs[0])[..., pos] - r3.numpy()).max()
            <= POS_TOL_KM)
    if want_vel:
        assert (np.abs(np.asarray(outs[1])[..., pos] - v3.numpy()).max()
                <= VEL_TOL_KMS)
    else:
        assert v3 is None and len(outs) == 2


def test_fast_atan2_and_pow23_match_jax():
    rng = np.random.default_rng(4)
    y = rng.normal(0.0, 1.0, 100000).astype(np.float32)
    x = rng.normal(0.0, 1.0, 100000).astype(np.float32)
    y[:4], x[:4] = (0.0, 1.0, -1.0, 0.0), (0.0, 0.0, -1.0, -2.0)
    aj = jfm.fast_atan2(jnp.asarray(y), jnp.asarray(x))
    ap = pfm.fast_atan2(torch.from_numpy(y), torch.from_numpy(x))
    assert _ulps(aj, ap.numpy()).max() <= 1.0
    assert np.abs(ap.numpy() - np.arctan2(y, x)).max() < 1e-6
    z = np.exp(rng.uniform(-10.0, 20.0, 100000)).astype(np.float32)
    pj = jfm.pow23(jnp.asarray(z))
    pp = pfm.pow23(torch.from_numpy(z))
    assert _ulps(pj, pp.numpy()).max() <= 1.0
    np.testing.assert_allclose(pp.numpy(), z.astype(np.float64) ** (2 / 3),
                               rtol=1e-6)


def test_sdp4_propagate_tables_matches_jax(cats):
    """The f64 escape on the escape lanes (irez 2, e > 0.7) over the
    grid, against the JAX package's."""
    jcat, pcat, steps = cats
    esc = pcat.heo_escape
    jesc = jcat.heo_escape
    # the same lanes, in the same (catalog) order
    np.testing.assert_array_equal(np.asarray(jcat.deep_idx)[jesc[4]],
                                  pcat.deep_idx[esc.idx.numpy()])
    ts = torch.from_numpy(T_MIN)[:, None] - esc.t_sat[None, :]
    rj, vj, ej = jfast.sdp4_propagate_tables(
        jesc[0], jesc[1], jnp.asarray(ts.numpy()), J_WGS72,
        resonance_steps=steps, tables=jcat.escape_tables(steps))
    rp, vp, ep = pfast.sdp4_propagate_tables(
        esc.els, esc.deep, ts, WGS72, pcat.escape_tables(steps))
    np.testing.assert_array_equal(np.asarray(ej), ep.numpy())
    assert np.abs(np.asarray(rj) - rp.numpy()).max() <= 1e-5
    assert np.abs(np.asarray(vj) - vp.numpy()).max() <= 1e-8


def test_deep_wrapper_rejects_bad_inputs(cats):
    pcat, steps = cats[1], cats[2]
    ds = pcat.fast_staging.deep
    t = torch.from_numpy(T_MIN)
    tables = pcat.resonance_tables(steps)
    kw = dict(grav=WGS72, kepler_iters=6)
    with pytest.raises(ValueError, match="tail"):
        cuda_sgp4.propagate_deep_sep(t, ds.t_sat, ds.spine, ds.tail[:32],
                                     ds.flags, tables, **kw)
    with pytest.raises(ValueError, match="tables"):
        cuda_sgp4.propagate_deep_sep(t, ds.t_sat, ds.spine, ds.tail,
                                     ds.flags, tables[:, 1:], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_sgp4.propagate_deep_sep(t, ds.t_sat, ds.spine,
                                     ds.tail.T.contiguous().T, ds.flags,
                                     tables, **kw)
    with pytest.raises(ValueError, match="device"):
        cuda_sgp4.propagate_deep_sep(
            *(x.to("meta") for x in (t, ds.t_sat, ds.spine, ds.tail,
                                     ds.flags, tables)), **kw)
