"""Integrators: fixed-step RK4 and adaptive Dormand-Prince 8(7).

Counterpart of ``astroz_tpu/propagators/integrators.py`` in plain torch.
The tableau is the published Prince & Dormand (1981) RK8(7)-13M pair.
State is a 6-vector (r km, v km/s) with arbitrary leading batch axes;
``deriv(state, t)`` builds the [v, a] derivative from a force model.

The adaptive driver keeps the JAX package's control law: mixed
rtol/atol error norm, safety 0.9, step clamp [1e-3 s, 3600 s], growth
cap 5x, shrink floor 0.1x. JAX runs it as a ``lax.while_loop`` on the
device. Here, on a CUDA trajectory whose model the integrator kernel
computes (``forces.kernel_terms``), one launch of the kernel's ADAPTIVE
mode runs the whole loop and the host reads (h, steps) back once a call;
otherwise (the CPU, a model of a python function of t, a batched state)
the loop runs on the host, the state stays on its device, and each
substep reads one number back, its error norm: the host then decides
acceptance and the next step in f64 Python floats.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..calculations import _tensors
from ..config import DEFAULT_DTYPE
from ..ops import cuda_integrate
from .forces import kernel_terms

__all__ = ["Deriv", "DormandPrince87", "Rk4", "Sgp4Integrator",
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


def dp87_adaptive(deriv: Deriv, state, t0, t1, *, rtol: float = 1e-10,
                  atol: float = 1e-12, h0: Optional[float] = None,
                  h_min: float = 1e-3, h_max: float = 3600.0,
                  max_substeps: int = 10000, device="cuda"):
    """Integrate from ``t0`` to ``t1`` with the JAX package's step
    control: err_norm = max(|err| / (atol + rtol*max(|y|, |y8|)));
    accept if <= 1; h *= clip(0.9 * err^(-1/8), 0.1, 5), then clip |h|
    to [h_min, h_max]; a step that would overshoot ``t1`` ends on it.

    Scalar trajectory only (the error norm is the max over the whole
    state): batched runs take the fixed-step path. On a CUDA state of one
    trajectory (6 values) whose ``deriv`` carries kernel terms
    (:func:`make_deriv` of a model the kernel computes), one launch of
    the integrator kernel's ADAPTIVE mode runs the loop and one read
    brings (h, steps) back; otherwise the plain loop reads one number a
    substep (the error norm). The kernel takes err^(-1/8) from the
    device's pow, the plain loop from the host's: their step sizes may
    part in the last bits. Returns (state, h_final, n_steps) with
    ``h_final`` a float and ``n_steps`` an int."""
    (state,) = _tensors(state, device=device, dtype=DEFAULT_DTYPE)
    t0, t1 = float(t0), float(t1)
    direction = float((t1 > t0) - (t1 < t0))
    sign = direction if direction else 1.0
    h = (min(abs(t1 - t0), h_max) if direction else h_max) * sign
    if h0 is not None:
        h = float(h0) * sign
    kw = dict(rtol=rtol, atol=atol, h_min=h_min, h_max=h_max,
              max_substeps=max_substeps)
    if kernel_terms(deriv) is None or state.numel() != 6:
        return cuda_integrate.adaptive_reference(deriv, state, t0, t1, h,
                                                 **kw)
    return cuda_integrate.adaptive(deriv, state, t0, t1, h, **kw)


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

    def step(self, state, t, h):
        """Advance exactly h seconds (internally sub-stepping)."""
        out, h_next, n_sub = dp87_adaptive(
            self.deriv, state, t, t + h, rtol=self.rtol, atol=self.atol,
            h0=self.h_current, device=self.device)
        self.n_substeps += n_sub
        if n_sub >= 10000:
            # the loop exited on the substep cap, not on reaching t+h:
            # the returned state is NOT at the requested epoch
            raise RuntimeError(
                "DormandPrince87: step did not converge within the "
                "substep cap (tolerances too tight for f64, or h_min "
                "too large) — state has not reached t + h")
        self.h_current = abs(h_next)
        return out


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
