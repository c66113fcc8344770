"""Numerical propagation: force models, integrators, trajectory driver.

Counterpart of ``astroz_tpu/propagators``: a force model is
``accel(r, v, t) -> a`` on tensors, an integrator advances
``(state, t) -> state``, and the driver samples a trajectory. Batched
Monte-Carlo propagation (:func:`propagate_fixed` over many lanes) is the
reason this stack runs on an accelerator: on the card one launch of the
integrator kernel (``ops/cuda_integrate.py``) runs the whole ensemble
through every step, for a model whose ``kernel_terms`` it computes.
"""

from .driver import Propagator, propagate_fixed, propagate_numerical
from .forces import (Composite, Drag, ImprovedDrag, J2, J3, J4,
                     SolarRadiationPressure, ThirdBody, TwoBody,
                     earth_default_forces, kernel_terms)
from .integrators import (DormandPrince87, Rk4, Sgp4Integrator,
                          dp87_adaptive, dp87_step, make_deriv, rk4_step)

__all__ = [
    "TwoBody", "J2", "J3", "J4", "Drag", "ImprovedDrag",
    "SolarRadiationPressure", "ThirdBody", "Composite",
    "earth_default_forces", "kernel_terms", "Rk4", "DormandPrince87",
    "Sgp4Integrator",
    "rk4_step", "dp87_step", "dp87_adaptive", "make_deriv",
    "Propagator", "propagate_fixed",
    "propagate_numerical",
]
