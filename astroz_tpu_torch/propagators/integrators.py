"""Integrators: fixed-step RK4 and adaptive Dormand-Prince 8(7).

Counterpart of ``astroz_tpu/propagators/integrators.py`` in plain torch.
The tableau is the published Prince & Dormand (1981) RK8(7)-13M pair.
State is a 6-vector (r km, v km/s) with arbitrary leading batch axes;
``deriv(state, t)`` builds the [v, a] derivative from a force model.

The adaptive driver keeps the JAX package's control law: mixed
rtol/atol error norm, safety 0.9, step clamp [1e-3 s, 3600 s], growth
cap 5x, shrink floor 0.1x. JAX runs it as a ``lax.while_loop`` on the
device. Here, on a CUDA trajectory whose model the integrator kernel
computes (``forces.kernel_route``), one launch of the kernel's TRAJECTORY
mode runs the whole loop as its one outer step and the host reads (h,
steps) back once a call; ``Propagator.propagate`` over a
:class:`DormandPrince87` runs all its outer steps in one launch of it. Otherwise (the CPU, a
model of a python function of t, a batched state) the loop runs on the
host (:func:`adaptive_reference`), the state stays on its device, and
each substep reads one number back, its error norm: the host then
decides acceptance and the next step in f64 Python floats.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..calculations import _tensors
from ..config import DEFAULT_DTYPE
from ..ops import cuda_integrate
from .forces import kernel_route, kernel_terms

__all__ = ["Deriv", "DormandPrince87", "Rk4", "Sgp4Integrator",
           "adaptive_reference", "adaptive_trajectory_reference",
           "dp87_adaptive", "dp87_step", "make_deriv", "rk4_step"]

Deriv = Callable[[torch.Tensor, float], torch.Tensor]


def make_deriv(accel) -> Deriv:
    """[r, v] -> [v, a] derivative from a force model ``accel(r,v,t)``;
    it carries the model's ``terms`` (``forces.kernel_terms``), so that
    :func:`dp87_adaptive` can run it in the integrator kernel."""

    def deriv(state, t):
        r, v = state[..., :3], state[..., 3:]
        return torch.cat([v, accel(r, v, t)], dim=-1)

    deriv.terms = kernel_terms(accel)
    return deriv


# ---------------------------------------------------------------------------
# RK4
# ---------------------------------------------------------------------------


def rk4_step(deriv: Deriv, state, t, h):
    k1 = deriv(state, t)
    k2 = deriv(state + 0.5 * h * k1, t + 0.5 * h)
    k3 = deriv(state + 0.5 * h * k2, t + 0.5 * h)
    k4 = deriv(state + h * k3, t + h)
    return state + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


# ---------------------------------------------------------------------------
# Dormand-Prince 8(7) — RK8(7)-13M tableau
# ---------------------------------------------------------------------------

_C = (0.0, 1 / 18, 1 / 12, 1 / 8, 5 / 16, 3 / 8, 59 / 400, 93 / 200,
      5490023248 / 9719169821, 13 / 20, 1201146811 / 1299019798, 1.0, 1.0)

_A = (
    (),
    (1 / 18,),
    (1 / 48, 1 / 16),
    (1 / 32, 0, 3 / 32),
    (5 / 16, 0, -75 / 64, 75 / 64),
    (3 / 80, 0, 0, 3 / 16, 3 / 20),
    (29443841 / 614563906, 0, 0, 77736538 / 692538347,
     -28693883 / 1125000000, 23124283 / 1800000000),
    (16016141 / 946692911, 0, 0, 61564180 / 158732637,
     22789713 / 633445777, 545815736 / 2771057229,
     -180193667 / 1043307555),
    (39632708 / 573591083, 0, 0, -433636366 / 683701615,
     -421739975 / 2616292301, 100302831 / 723423059,
     790204164 / 839813087, 800635310 / 3783071287),
    (246121993 / 1340847787, 0, 0, -37695042795 / 15268766246,
     -309121744 / 1061227803, -12992083 / 490766935,
     6005943493 / 2108947869, 393006217 / 1396673457,
     123872331 / 1001029789),
    (-1028468189 / 846180014, 0, 0, 8478235783 / 508512852,
     1311729495 / 1432422823, -10304129995 / 1701304382,
     -48777925059 / 3047939560, 15336726248 / 1032824649,
     -45442868181 / 3398467696, 3065993473 / 597172653),
    (185892177 / 718116043, 0, 0, -3185094517 / 667107341,
     -477755414 / 1098053517, -703635378 / 230739211,
     5731566787 / 1027545527, 5232866602 / 850066563,
     -4093664535 / 808688257, 3962137247 / 1805957418,
     65686358 / 487910083),
    (403863854 / 491063109, 0, 0, -5068492393 / 434740067,
     -411421997 / 543043805, 652783627 / 914296604,
     11173962825 / 925320556, -13158990841 / 6184727034,
     3936647629 / 1978049680, -160528059 / 685178525,
     248638103 / 1413531060, 0),
)

#: 8th-order weights
_B8 = (14005451 / 335480064, 0, 0, 0, 0, -59238493 / 1068277825,
       181606767 / 758867731, 561292985 / 797845732,
       -1041891430 / 1371343529, 760417239 / 1151165299,
       118820643 / 751138087, -528747749 / 2220607170, 1 / 4)

#: 7th-order (embedded) weights
_B7 = (13451932 / 455176623, 0, 0, 0, 0, -808719846 / 976000145,
       1757004468 / 5645159321, 656045339 / 265891186,
       -3867574721 / 1518517206, 465885868 / 322736535,
       53011238 / 667516719, 2 / 45, 0)


def dp87_step(deriv: Deriv, state, t, h):
    """One 13-stage step. Returns (state8, error_estimate)."""
    ks = []
    for i in range(13):
        si = state
        for j, aij in enumerate(_A[i]):
            if aij != 0:
                si = si + (h * aij) * ks[j]
        ks.append(deriv(si, t + _C[i] * h))
    y8 = state
    y7 = state
    for bi, bhi, k in zip(_B8, _B7, ks):
        if bi != 0:
            y8 = y8 + (h * bi) * k
        if bhi != 0:
            y7 = y7 + (h * bhi) * k
    return y8, y8 - y7


#: ``dp87_adaptive``'s defaults, which ``DormandPrince87`` keeps: the
#: step's limits (s) and the substep cap
H_MIN = 1e-3
H_MAX = 3600.0
MAX_SUBSTEPS = 10000


def _direction(t0: float, t1: float) -> float:
    return float((t1 > t0) - (t1 < t0))


def _first_h(t0: float, t1: float, h0, h_max: float) -> float:
    """``dp87_adaptive``'s starting step: ``h0`` (a magnitude) or, with
    none, min(|t1 - t0|, h_max), signed by the direction of time."""
    direction = _direction(t0, t1)
    sign = direction if direction else 1.0
    if h0 is not None:
        return float(h0) * sign
    return (min(abs(t1 - t0), h_max) if direction else h_max) * sign


def adaptive_reference(deriv, state, t0: float, t1: float, h: float, *,
                       rtol: float, atol: float, h_min: float, h_max: float,
                       max_substeps: int):
    """The plain adaptive DP8(7) loop from ``t0`` to ``t1`` (floats),
    starting with the signed step ``h``: the loop runs on the host and
    reads one number a substep, its error norm. Returns (state, h, steps)
    with ``h`` a float and ``steps`` an int."""
    direction = _direction(t0, t1)
    t, steps = t0, 0
    while (t - t1) * direction < 0 and steps < max_substeps:
        # clamp h to not overshoot t1
        hs = t1 - t if (t + h - t1) * direction > 0 else h
        y8, err = dp87_step(deriv, state, t, hs)
        scale = atol + rtol * torch.maximum(torch.abs(state), torch.abs(y8))
        err_norm = float(torch.max(torch.abs(err) / scale))
        factor = min(max(0.9 * max(err_norm, 1e-16) ** (-1.0 / 8.0), 0.1),
                     5.0)
        h = min(max(abs(hs * factor), h_min), h_max) * direction
        if err_norm <= 1.0:
            state, t = y8, t + hs
        steps += 1
    return state, h, steps


def dp87_adaptive(deriv: Deriv, state, t0, t1, *, rtol: float = 1e-10,
                  atol: float = 1e-12, h0: Optional[float] = None,
                  h_min: float = H_MIN, h_max: float = H_MAX,
                  max_substeps: int = MAX_SUBSTEPS, device="cuda"):
    """Integrate from ``t0`` to ``t1`` with the JAX package's step
    control: err_norm = max(|err| / (atol + rtol*max(|y|, |y8|)));
    accept if <= 1; h *= clip(0.9 * err^(-1/8), 0.1, 5), then clip |h|
    to [h_min, h_max]; a step that would overshoot ``t1`` ends on it.

    Scalar trajectory only (the error norm is the max over the whole
    state): batched runs take the fixed-step path. On a CUDA state of one
    trajectory (6 values) whose ``deriv`` carries kernel terms
    (:func:`make_deriv` of a model the kernel computes), one launch of
    the integrator kernel's TRAJECTORY mode for one outer step runs the
    loop and one read brings (h, steps) back; otherwise :func:`adaptive_reference` reads
    one number a substep (the error norm). The kernel takes err^(-1/8)
    from the device's pow, the plain loop from the host's: their step
    sizes may part in the last bits. Returns (state, h_final, n_steps)
    with ``h_final`` a float and ``n_steps`` an int."""
    (state,) = _tensors(state, device=device, dtype=DEFAULT_DTYPE)
    t0, t1 = float(t0), float(t1)
    h = _first_h(t0, t1, h0, h_max)
    kw = dict(rtol=rtol, atol=atol, h_min=h_min, h_max=h_max,
              max_substeps=max_substeps)
    if state.numel() == 6 and kernel_route(state, deriv):
        return cuda_integrate.adaptive(deriv, state, t0, t1, h, **kw)
    return adaptive_reference(deriv, state, t0, t1, h, **kw)


def adaptive_trajectory_reference(deriv, state, t0: float, dt: float,
                                  n: int, *, rtol: float, atol: float,
                                  h_carried: Optional[float] = None,
                                  h_min: float = H_MIN, h_max: float = H_MAX,
                                  max_substeps: int = MAX_SUBSTEPS):
    """The plain version of the integrator kernel's TRAJECTORY mode:
    ``Propagator.propagate``'s ``n - 1`` outer steps of ``dt`` from ``t0``
    over a ``DormandPrince87`` whose |h| is ``h_carried`` (``None`` for
    none), each outer step :func:`adaptive_reference` from ``t0 + dt *
    (k - 1)`` (numpy's arange, as the driver forms it) to that plus
    ``dt``, |h| carried from one to the next. It stops after the first
    outer step that takes ``max_substeps`` (where ``DormandPrince87.step``
    raises). Returns what the kernel writes: (states (n, *state.shape),
    the stop's row where the cap left it and NaN rows past it, substeps
    (n - 1,) i64, |h| after each outer step (n - 1,) f64, info [outer
    steps completed, |h| carried out (NaN for none), substeps in all, the
    signed h after the last outer step run (NaN for none)] (4,) f64), on
    ``state``'s device."""
    n_outer = max(int(n) - 1, 0)
    times = t0 + dt * np.arange(n_outer + 1)
    states = torch.full((n_outer + 1, *state.shape), float("nan"),
                        dtype=state.dtype, device=state.device)
    states[0] = state
    subs, hs = [0] * n_outer, [float("nan")] * n_outer
    done, total, h_abs, h_last = 0, 0, h_carried, float("nan")
    for k in range(1, n_outer + 1):
        ta = float(times[k - 1])
        tb = ta + dt
        h = _first_h(ta, tb, h_abs, h_max)
        state, h_next, steps = adaptive_reference(
            deriv, state, ta, tb, h, rtol=rtol, atol=atol, h_min=h_min,
            h_max=h_max, max_substeps=max_substeps)
        total += steps
        subs[k - 1], hs[k - 1], h_last = steps, abs(h_next), h_next
        states[k] = state
        if steps >= max_substeps:
            break
        h_abs, done = abs(h_next), k
    info = [done, float("nan") if h_abs is None else h_abs, total, h_last]
    dev = state.device
    return (states, torch.tensor(subs, dtype=torch.int64, device=dev),
            torch.tensor(hs, dtype=torch.float64, device=dev),
            torch.tensor(info, dtype=torch.float64, device=dev))


# ---------------------------------------------------------------------------
# Class-style wrappers
# ---------------------------------------------------------------------------


class Rk4:
    """Fixed-step RK4 integrator. A numpy or float state goes to
    ``device``; a tensor stays on its own."""

    def __init__(self, accel, *, device="cuda"):
        self.deriv = make_deriv(accel)
        self.device = device

    def step(self, state, t, h):
        (state,) = _tensors(state, device=self.device)
        return rk4_step(self.deriv, state, t, h)


class DormandPrince87:
    """Adaptive 8(7) integrator whose step size persists across calls
    (``h_current``). ``n_substeps`` counts the substeps it has taken."""

    def __init__(self, accel, rtol: float = 1e-10, atol: float = 1e-12, *,
                 device="cuda"):
        self.deriv = make_deriv(accel)
        self.rtol = rtol
        self.atol = atol
        self.device = device
        self.h_current: Optional[float] = None
        self.n_substeps = 0

    @staticmethod
    def _check_converged(n_sub: int):
        if n_sub >= MAX_SUBSTEPS:
            # the loop exited on the substep cap, not on reaching t+h:
            # the returned state is NOT at the requested epoch
            raise RuntimeError(
                "DormandPrince87: step did not converge within the "
                "substep cap (tolerances too tight for f64, or h_min "
                "too large) — state has not reached t + h")

    def step(self, state, t, h):
        """Advance exactly h seconds (internally sub-stepping)."""
        out, h_next, n_sub = dp87_adaptive(
            self.deriv, state, t, t + h, rtol=self.rtol, atol=self.atol,
            h0=self.h_current, max_substeps=MAX_SUBSTEPS,
            device=self.device)
        self.n_substeps += n_sub
        self._check_converged(n_sub)
        self.h_current = abs(h_next)
        return out

    def takes_trajectory(self, state) -> bool:
        """Whether ``Propagator.propagate`` runs its outer steps from
        ``state`` in one launch (:meth:`trajectory`): one trajectory of 6
        values on the integrator kernel's route."""
        return state.numel() == 6 and kernel_route(state, self.deriv)

    def trajectory(self, state, t0: float, dt: float, n: int):
        """``Propagator.propagate``'s outer loop, ``n - 1`` calls of
        :meth:`step` of ``dt`` from ``t0``, in one launch of the
        integrator kernel's TRAJECTORY mode and one read: the same states,
        ``h_current`` and ``n_substeps`` as those calls, and the same
        ``RuntimeError`` at the same outer step. Returns the (n, 6)
        states."""
        states, _, _, info = cuda_integrate.trajectory(
            self.deriv, state, float(t0), float(dt), n, rtol=self.rtol,
            atol=self.atol, h_carried=self.h_current, h_min=H_MIN,
            h_max=H_MAX, max_substeps=MAX_SUBSTEPS)
        done, h_out, total, _ = info.tolist()
        self.n_substeps += int(total)
        if h_out == h_out:
            self.h_current = h_out
        if int(done) < n - 1:
            self._check_converged(MAX_SUBSTEPS)
        return states


class Sgp4Integrator:
    """SGP4 through the same step interface: 'integration' is analytic
    propagation of ``satrec`` (an :class:`~astroz_tpu_torch.api.Satrec`)
    to the requested epoch on the host engine; the state input is
    ignored. The step returns an f64 tensor on the satrec's device."""

    def __init__(self, satrec):
        self._sat = satrec
        self.device = satrec._device

    def step(self, state, t, h):
        t_min = (t + h) / 60.0
        e, r, v = self._sat.sgp4_tsince(t_min)
        return _tensors(list(r) + list(v), device=self.device)[0]
