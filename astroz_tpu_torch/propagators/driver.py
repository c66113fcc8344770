"""Trajectory driver + the ``propagate_numerical`` API.

Counterpart of ``astroz_tpu/propagators/driver.py``: build a
TwoBody[+J2][+Drag] composite, integrate with DP87 (default) or RK4,
return (times, states).

Two execution styles:
* :func:`propagate_fixed` — fixed steps, batched over arbitrary leading
  axes (the Monte-Carlo path), as JAX's ``lax.scan``: on the card one
  launch of the integrator kernel's FIXED mode for a model it computes
  (``forces.kernel_terms``), else a Python loop of device ops that
  writes each sample into one preallocated ``(n, ..., 6)`` tensor; no
  host read either way.
* :meth:`Propagator.propagate` — fixed outer sampling steps with an
  adaptive DP87 (or fixed) inner integrator, one trajectory: over a
  ``DormandPrince87`` on the card, every outer step in one launch of the
  integrator kernel's TRAJECTORY mode and one read; otherwise a Python
  loop of the integrator's ``step``.

The route is chosen once, by ``forces.kernel_route``: the kernel for a
CUDA state and a model it computes, else the plain loop.

States come back as f64 tensors on the device they ran on; sample times
as a numpy array (the host knows them).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..calculations import _tensors
from ..config import DEFAULT_DTYPE
from ..constants import EARTH
from ..ops import cuda_integrate
from .forces import Composite, Drag, J2, TwoBody, kernel_route
from .integrators import DormandPrince87, dp87_step, make_deriv, rk4_step

__all__ = ["Propagator", "fixed_reference", "propagate_fixed",
           "propagate_numerical"]


def fixed_reference(accel, state, t0: float, n_steps: int, h: float, *,
                    method: str = "rk4", substeps: int = 1):
    """The plain fixed-step loop: ``n_steps`` samples of ``substeps`` RK4
    (or fixed DP8(7)) steps of ``h`` from ``state`` (..., 6) at ``t0``;
    returns (n_steps + 1, ..., 6), the first sample ``state``. No host
    read."""
    deriv = make_deriv(accel)
    step_fn = rk4_step if method == "rk4" else \
        (lambda d, s, t, h: dp87_step(d, s, t, h)[0])
    states = torch.empty((n_steps + 1, *state.shape), dtype=state.dtype,
                         device=state.device)
    states[0] = state
    t = float(t0)
    for k in range(n_steps):
        for _ in range(substeps):
            state = step_fn(deriv, state, t, h)
            t = t + h
        states[k + 1] = state
    return states


def propagate_fixed(accel, state0, t0: float, duration: float, dt: float,
                    *, method: str = "rk4", substeps: int = 1,
                    device="cuda"):
    """Fixed-step trajectory.

    ``state0``: (..., 6) [r km, v km/s] with arbitrary batch axes, a
    tensor (which runs on its own device, cast to f64) or numpy / floats
    (sent to ``device``). Returns (times (n,) numpy, states (n, ..., 6)
    f64 tensor) including the initial state, n = floor(duration/dt) + 1;
    each sample is ``substeps`` integrator steps of dt/substeps.

    On a CUDA state whose model the integrator kernel computes (TwoBody,
    J2-J4, Drag, ImprovedDrag, SRP with its fixed sun, and Composites of
    them) the whole loop is one kernel launch, bit-equal to the plain
    loop on the card; a model that calls a python function of t
    (ThirdBody, SRP with a ``sun_pos_fn``, any other callable) runs the
    plain loop of torch ops, as every model does on the CPU."""
    if method not in ("rk4", "dp87"):
        raise ValueError(f"method must be 'rk4' or 'dp87', got "
                         f"{method!r}")
    n_steps = int(np.floor(duration / dt))
    h = dt / substeps
    (state,) = _tensors(state0, device=device, dtype=DEFAULT_DTYPE)
    run = cuda_integrate.fixed if kernel_route(state, accel) \
        else fixed_reference
    states = run(accel, state, t0, n_steps, h, method=method,
                 substeps=substeps)
    times = t0 + dt * np.arange(n_steps + 1)
    return times, states


class Propagator:
    """Fixed outer sampling steps, adaptive (or fixed) inner
    integration. A numpy or float initial state goes to the
    integrator's ``device``. Over a ``DormandPrince87`` whose model the
    integrator kernel computes, a CUDA trajectory of 6 values runs every
    outer step in one launch (``DormandPrince87.trajectory``): the states,
    ``h_current``, ``n_substeps`` and the ``RuntimeError`` of the substep
    cap are those of the loop of ``step`` calls that every other case
    runs."""

    def __init__(self, integrator):
        self.integrator = integrator

    def propagate(self, initial_state, t0: float, duration: float,
                  dt: float) -> Tuple[np.ndarray, torch.Tensor]:
        n = int(np.floor(duration / dt)) + 1
        times = t0 + dt * np.arange(n)
        integ = self.integrator
        (state,) = _tensors(initial_state, device=integ.device,
                            dtype=DEFAULT_DTYPE)
        if isinstance(integ, DormandPrince87) and \
                integ.takes_trajectory(state):
            return times, integ.trajectory(state, t0, dt, n)
        states = torch.empty((n, *state.shape), dtype=state.dtype,
                             device=state.device)
        states[0] = state
        for k in range(1, n):
            state = integ.step(state, float(times[k - 1]), dt)
            states[k] = state
        return times, states

    def propagate_to(self, initial_state, t0: float, t1: float,
                     dt: float) -> torch.Tensor:
        _, states = self.propagate(initial_state, t0, t1 - t0, dt)
        return states[-1]


def propagate_numerical(state0, t0: float, duration: float, dt: float,
                        mu: Optional[float] = None, *,
                        j2: Optional[float] = None,
                        r_eq: Optional[float] = None,
                        drag_cd: Optional[float] = None,
                        drag_area: float = 4.0, drag_mass: float = 1000.0,
                        integrator: str = "dp87", rtol: float = 1e-10,
                        atol: float = 1e-12, device="cuda"):
    """state6 + TwoBody[+J2][+Drag], DP87 or RK4; returns (times (n,)
    numpy, states (n, 6) f64 tensor)."""
    models = [TwoBody(mu if mu is not None else EARTH.mu)]
    if j2 is not None:
        models.append(J2(mu if mu is not None else EARTH.mu, j2,
                         r_eq if r_eq is not None else EARTH.eq_radius))
    if drag_cd is not None:
        models.append(Drag(cd=drag_cd, area_m2=drag_area,
                           mass_kg=drag_mass))
    accel = Composite(models)

    if integrator == "rk4":
        return propagate_fixed(accel, state0, t0, duration, dt,
                               method="rk4", device=device)
    if integrator != "dp87":
        raise ValueError(f"unknown integrator {integrator!r}")

    prop = Propagator(DormandPrince87(accel, rtol=rtol, atol=atol,
                                      device=device))
    return prop.propagate(state0, t0, duration, dt)
