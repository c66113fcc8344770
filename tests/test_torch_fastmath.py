"""astroz_tpu_torch.ops.fastmath and the f32 Kepler solve against
astroz_tpu.ops.fastmath / ops.fast on the same f32 inputs.

sincos and angle_add are chains of single f32 operations in both
packages. JAX runs here op by op (not jitted: a fused XLA program may
contract a multiply-add that torch rounds twice), and the two must agree
to at most 1 f32 ulp.

Then the kernels' f64 fmod (``csrc/sgp4_common.cuh``: ``fmod_exact``,
the reduction mod 2pi ``fmod_two_pi`` and ``rem_two_pi``, and K2's
resonance row, fmod by 720 minutes), modelled here in Python with an
exact FMA, against ``torch.fmod`` / ``torch.remainder``, which the plain
versions take: bit for bit, the sign of zero included."""

import math
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astroz_tpu.ops import fast as jfast
from astroz_tpu.ops import fastmath as jfm

from astroz_tpu_torch.ops import fast as pfast
from astroz_tpu_torch.ops import fastmath as pfm

torch.set_num_threads(1)


def _ulps(a, b):
    """|a - b| in units of the f32 spacing at max(|a|, |b|)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    scale = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return (np.abs(a.astype(np.float64) - b.astype(np.float64))
            / scale.astype(np.float64))


def _angles(n, lo, hi, seed):
    x = np.random.default_rng(seed).uniform(lo, hi, n).astype(np.float32)
    # exact quadrant ties (round half to even) and their neighbours
    ties = (np.arange(-64, 65) + 0.5) * np.float32(np.pi / 2)
    return np.concatenate(
        [x, ties.astype(np.float32),
         np.nextafter(ties.astype(np.float32), np.float32(np.inf)),
         np.asarray([0.0, -0.0, 1e-30, -1e-30], np.float32)])


def test_sincos_matches_jax():
    x = _angles(200000, -1e3, 1e3, 0)
    sj, cj = jfm.sincos(jnp.asarray(x))
    sp, cp = pfm.sincos(torch.from_numpy(x))
    assert _ulps(sj, sp.numpy()).max() <= 1.0
    assert _ulps(cj, cp.numpy()).max() <= 1.0


def test_angle_add_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(-np.pi, np.pi, 100000)
    sa, ca = np.sin(a).astype(np.float32), np.cos(a).astype(np.float32)
    d = rng.uniform(-0.1, 0.1, 100000).astype(np.float32)
    sj, cj = jfm.angle_add(jnp.asarray(sa), jnp.asarray(ca), jnp.asarray(d))
    sp, cp = pfm.angle_add(*map(torch.from_numpy, (sa, ca, d)))
    assert _ulps(sj, sp.numpy()).max() <= 1.0
    assert _ulps(cj, cp.numpy()).max() <= 1.0


@pytest.mark.parametrize("iters", [3, 4, 5, 8])
def test_solve_kepler_fast_matches_jax(iters):
    """Wrapped Kepler argument and Newton solve over e in [0, 0.35]:
    sin/cos of the eccentric longitude bit-equal to JAX run op by op."""
    rng = np.random.default_rng(2)
    e = rng.uniform(0.0, 0.35, 50000)
    w = rng.uniform(0.0, 2 * np.pi, 50000)
    u = rng.uniform(-2.0, 4 * np.pi + 2.0, 50000).astype(np.float32)
    axnl = (e * np.cos(w)).astype(np.float32)
    aynl = (e * np.sin(w) + 2e-3).astype(np.float32)

    def jrun(u_, a, b):
        return jfast.solve_kepler_fast(jfast._wrap_two_pi_f32(u_), a, b,
                                       iters)

    _, sj, cj = jrun(*map(jnp.asarray, (u, axnl, aynl)))
    _, sp, cp = pfast.solve_kepler_fast(
        pfast._wrap_two_pi_f32(torch.from_numpy(u)),
        torch.from_numpy(axnl), torch.from_numpy(aynl), iters)
    np.testing.assert_array_equal(np.asarray(sj), sp.numpy())
    np.testing.assert_array_equal(np.asarray(cj), cp.numpy())


TWO_PI = 2.0 * 3.141592653589793
INV_TWO_PI = 1.0 / TWO_PI


def _fma(a, b, c):
    """a * b + c rounded once (Python's float of a Fraction rounds to
    nearest, ties to even). An exact zero is +0, as on the card."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _kernel_fmod_exact(x, d, inv_d):
    """sgp4_common.cuh:fmod_exact, operation for operation."""
    a = abs(x)
    if not a < 2.0 ** 52:  # CUDA's fmod: NaN for inf and NaN
        with np.errstate(invalid="ignore"):
            return float(np.fmod(x, d))
    k = float(math.trunc(a * inv_d))
    r = _fma(-k, d, a)
    k += -1.0 if r < 0.0 else (1.0 if r >= d else 0.0)
    return math.copysign(_fma(-k, d, a), x)


def _kernel_fmod_two_pi(x):
    """sgp4_common.cuh:fmod_two_pi."""
    return _kernel_fmod_exact(x, TWO_PI, INV_TWO_PI)


def _kernel_rem_two_pi(x):
    """sgp4_common.cuh:rem_two_pi."""
    r = _kernel_fmod_two_pi(x)
    return r + TWO_PI if r < 0.0 else r


def _adversarial_angles():
    """Multiples of 2pi as f64 and their neighbours 1 and 2 ulps away, a
    few below 2pi, both signs; uniform values to 1e5 rad; the angles of
    a year of one-second steps (the spine's rates up to 0.07 rad/min);
    quotients near 2^20, 2^40 and past 2^52; +-0."""
    rng = np.random.default_rng(3)
    k = np.concatenate([np.arange(0, 3000), rng.integers(3000, 1 << 20, 400),
                        rng.integers(1 << 38, 1 << 40, 100)]).astype(float)
    mult = k * TWO_PI
    up1 = np.nextafter(mult, np.inf)
    dn1 = np.nextafter(mult, -np.inf)
    near = np.concatenate([mult, up1, dn1, np.nextafter(up1, np.inf),
                           np.nextafter(dn1, -np.inf), mult + 5e-13,
                           mult - 5e-13, mult + 1e-16 * k, mult - 1e-16 * k])
    year_min = np.arange(0.0, 525600.0, 60.0) + rng.uniform(0, 1, 8760)
    year = np.concatenate([year_min * r for r in (0.0011, 0.0438, 0.0691)])
    x = np.concatenate([near, rng.uniform(-1e5, 1e5, 4000), year,
                        [0.0, TWO_PI, 2.0 ** 52 + 1.0, 1e17, 3e300]])
    return np.concatenate([x, -x])


def test_kernel_reduction_equals_torch_bit_for_bit():
    x = _adversarial_angles()
    assert (x == 0).sum() >= 2 and np.signbit(x[x == 0]).any()
    xt = torch.from_numpy(x)
    want_fmod = torch.fmod(xt, TWO_PI).numpy()
    want_rem = torch.remainder(xt, TWO_PI).numpy()
    got_fmod = np.array([_kernel_fmod_two_pi(v) for v in x.tolist()])
    got_rem = np.array([_kernel_rem_two_pi(v) for v in x.tolist()])
    # bit patterns: -0 and +0 differ
    np.testing.assert_array_equal(got_fmod.view(np.int64),
                                  want_fmod.view(np.int64))
    np.testing.assert_array_equal(got_rem.view(np.int64),
                                  want_rem.view(np.int64))
    assert np.signbit(got_rem[(x == 0) & np.signbit(x)]).all()
    # exact multiples land on a zero of the dividend's sign (fmod) and
    # stay -0 below zero (remainder adds nothing to a zero)
    neg_mult = -(np.arange(1.0, 3000.0) * TWO_PI)
    got = np.array([_kernel_rem_two_pi(v) for v in neg_mult.tolist()])
    np.testing.assert_array_equal(
        got.view(np.int64),
        torch.remainder(torch.from_numpy(neg_mult), TWO_PI).numpy().view(
            np.int64))


def test_kernel_reduction_of_non_finite_is_nan():
    for v in (math.inf, -math.inf, math.nan):
        assert math.isnan(_kernel_rem_two_pi(v))
        x = torch.tensor(v, dtype=torch.float64)
        assert torch.isnan(torch.remainder(x, TWO_PI))


def test_kernel_fmod_by_step_equals_torch_bit_for_bit():
    """K2's resonance row, ``fmod_exact(|t|, 720, 1 / 720)``: multiples of
    720 minutes and their 1- and 2-ulp neighbours, spread times over
    +-10 years, quotients near 2^20, 2^40 and past 2^52, against
    ``torch.fmod`` bit for bit."""
    step = 720.0
    rng = np.random.default_rng(5)
    k = np.concatenate([np.arange(0, 3000), rng.integers(3000, 1 << 20, 400),
                        rng.integers(1 << 38, 1 << 40, 100)]).astype(float)
    mult = k * step
    up1, dn1 = np.nextafter(mult, np.inf), np.nextafter(mult, -np.inf)
    x = np.abs(np.concatenate([
        mult, up1, dn1, np.nextafter(up1, np.inf), np.nextafter(dn1, -np.inf),
        rng.uniform(0.0, 5256000.0, 4000), [0.0, 2.0 ** 52 + 1.0, 1e17]]))
    want = torch.fmod(torch.from_numpy(x), step).numpy()
    got = np.array([_kernel_fmod_exact(v, step, 1.0 / step)
                    for v in x.tolist()])
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
