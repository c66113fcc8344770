"""Kernel K1's plain version and wrapper against astroz_tpu.

The JAX fast tail (``astroz_tpu.ops.fast.shallow_tail_f32``, shared by
its XLA path and its Pallas kernels) takes sin(xmdf) in the drag term
where SGP4 takes cos(xmdf); the port takes the cosine (ROADMAP queue 3).
The ``jax_drag_fixed`` fixture holds the port against the JAX fast path
with that one term corrected, so that the rest is held to f32 rounding.

* The plain version (``spine_f64`` + ``shallow_tail_f32`` in torch) vs
  the JAX package's ``spine_f64`` + ``shallow_tail_f32`` under jit on
  XLA:CPU, on the same elements: positions within 5e-3 km, velocities
  within 5e-6 km/s, error codes identical. Measured on this catalog:
  at most 1.5e-3 km and 1.9e-6 km/s (a few f32 ulps; XLA fuses and
  contracts, and spells 1/sqrt as its rsqrt).
* The wrapper on CPU tensors vs the TPU kernel
  ``propagate_fast_pallas_sep`` in interpret mode: within 0.05 km (the
  JAX package's own Pallas-vs-XLA gate), error codes identical.
  Measured: 7.7e-3 km and 7.6e-6 km/s (the TPU kernel runs a
  double-f32 spine and rsqrt-squared reciprocals).

The CUDA kernel itself is held against the plain version on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import astroz_tpu.propagation as jprop
from astroz_tpu import build_catalog as j_build_catalog
from astroz_tpu.constants import WGS72 as J_WGS72
from astroz_tpu.ops import fast as jfast
from astroz_tpu.ops import pallas_sgp4

from astroz_tpu_torch import build_catalog
from astroz_tpu_torch.constants import WGS72
from astroz_tpu_torch.ops import cuda_sgp4

from test_torch_init import LEO_TEXT

torch.set_num_threads(1)

#: minutes from the earliest epoch (the decaying lane's): backward and
#: forward of the other epochs
T_MIN = np.linspace(-250.0, 2000.0, 9)


@pytest.fixture(scope="module")
def cats():
    return j_build_catalog(LEO_TEXT), build_catalog(LEO_TEXT, device="cpu")


def _twin(cat, want_vel, iters=None):
    st = cat.fast_staging
    return cuda_sgp4.propagate_fast_sep_reference(
        torch.from_numpy(T_MIN).to(cat.device), st.t_sat, st.spine,
        st.tail, st.flags, grav=cat.grav,
        kepler_iters=iters or cat.kepler_iters, want_vel=want_vel)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_tail(els, tsince, iters, want_vel):
    spine = jfast.spine_f64(els, tsince)
    return jfast.shallow_tail_f32(J_WGS72, iters, *spine, want_vel=want_vel,
                                  **jfast._shallow_f32_fields(els))


@pytest.fixture
def jax_drag_fixed(monkeypatch):
    """The JAX fast tail with cos(xmdf) in its drag term. xmdf enters
    that tail only there, so feeding it pi/2 - xmdf turns its sine into
    the cosine (to an f32 ulp). The jitted JAX entry points that trace
    the tail are re-traced under the patch and after it."""
    orig = jfast.shallow_tail_f32

    def fixed(grav, iters, t32, u_base, mm, argp32, node32, xmdf32, **kw):
        return orig(grav, iters, t32, u_base, mm, argp32, node32,
                    jnp.float32(np.pi / 2) - xmdf32, **kw)

    jitted = (jprop._propagate_fast_shallow,
              pallas_sgp4.propagate_fast_pallas_sep,
              pallas_sgp4.propagate_fast_pallas_fused,
              pallas_sgp4.propagate_fast_pallas, _jax_tail)
    for f in jitted:
        f.clear_cache()
    monkeypatch.setattr(jfast, "shallow_tail_f32", fixed)
    monkeypatch.setattr(pallas_sgp4, "shallow_tail_f32", fixed)
    yield
    for f in jitted:
        f.clear_cache()


def test_staging_matches_jax(cats):
    jcat, pcat = cats
    np.testing.assert_array_equal(np.asarray(jcat.fast_staging[0]),
                                  pcat.fast_staging.t_sat.numpy())
    assert pcat.kepler_iters == jcat.kepler_iters == 3


@pytest.mark.parametrize("iters", [3, 8])
@pytest.mark.parametrize("want_vel", [True, False])
def test_twin_matches_jax_spine_and_tail(cats, jax_drag_fixed, iters,
                                        want_vel):
    jcat, pcat = cats
    tsince = jnp.asarray(T_MIN)[:, None] - jcat.fast_staging[0][None, :]
    out = _jax_tail(jcat.els, tsince, iters, want_vel)
    r3, v3, err = _twin(pcat, want_vel, iters)
    np.testing.assert_array_equal(np.asarray(out[-1]), err.numpy())
    assert set(err.numpy().ravel().tolist()) == {0, 1, 6}
    rj = np.stack([np.asarray(c) for c in out[:3]])
    assert np.abs(rj - r3.numpy()).max() <= 5e-3
    if want_vel:
        vj = np.stack([np.asarray(c) for c in out[3:6]])
        assert np.abs(vj - v3.numpy()).max() <= 5e-6
    else:
        assert v3 is None
        r_vel, _, _ = _twin(pcat, True, iters)
        np.testing.assert_array_equal(r3.numpy(), r_vel.numpy())


@pytest.mark.parametrize("want_vel", [True, False])
def test_wrapper_cpu_matches_pallas_interpret(cats, jax_drag_fixed,
                                              want_vel):
    jcat, pcat = cats
    outs = pallas_sgp4.propagate_fast_pallas_sep(
        jcat.els, jnp.asarray(T_MIN), jcat.fast_staging[0], J_WGS72,
        kepler_iters=jcat.kepler_iters, sat_block=128, interpret=True,
        planes=True, want_vel=want_vel)
    st = pcat.fast_staging
    before = cuda_sgp4.LAUNCHES
    r3, v3, err = cuda_sgp4.propagate_fast_sep(
        torch.from_numpy(T_MIN), st.t_sat, st.spine, st.tail, st.flags,
        grav=WGS72, kepler_iters=pcat.kepler_iters, want_vel=want_vel)
    assert cuda_sgp4.LAUNCHES == before  # the CPU runs no kernel
    assert r3.shape == (3, len(T_MIN), len(pcat))
    np.testing.assert_array_equal(np.asarray(outs[-1]), err.numpy())
    assert np.abs(np.asarray(outs[0]) - r3.numpy()).max() <= 0.05
    if want_vel:
        assert np.abs(np.asarray(outs[1]) - v3.numpy()).max() <= 5e-5
    else:
        assert v3 is None and len(outs) == 2


def test_wrapper_rejects_bad_inputs(cats):
    st = cats[1].fast_staging
    t = torch.from_numpy(T_MIN)
    kw = dict(grav=WGS72, kepler_iters=3)
    with pytest.raises(ValueError, match="t_time"):
        cuda_sgp4.propagate_fast_sep(t.float(), st.t_sat, st.spine,
                                     st.tail, st.flags, **kw)
    with pytest.raises(ValueError, match="tail"):
        cuda_sgp4.propagate_fast_sep(t, st.t_sat, st.spine, st.tail[:20],
                                     st.flags, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_sgp4.propagate_fast_sep(t, st.t_sat, st.spine,
                                     st.tail.T.contiguous().T, st.flags,
                                     **kw)
    with pytest.raises(ValueError, match="device"):
        cuda_sgp4.propagate_fast_sep(t.to("meta"), st.t_sat.to("meta"),
                                     st.spine.to("meta"),
                                     st.tail.to("meta"),
                                     st.flags.to("meta"), **kw)
