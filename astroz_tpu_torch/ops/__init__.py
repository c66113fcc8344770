"""Element init, the fast f32 math, the f64 propagators, the scalar host
engine, and the CUDA kernels with their plain torch versions."""

from . import fastmath
from .cuda_sgp4 import propagate_fast
from .fast import solve_kepler_fast
from .sdp4 import (DeepElements, ResonanceCarry, fresh_carry, sdp4_init,
                   sdp4_propagate, sdp4_propagate_scan)
from .sgp4 import (Sgp4Elements, kepler_and_posvel, sgp4_init,
                   sgp4_propagate, solve_kepler, update_secular)

__all__ = ["DeepElements", "ResonanceCarry", "Sgp4Elements", "fastmath",
           "fresh_carry", "kepler_and_posvel", "propagate_fast",
           "sdp4_init", "sdp4_propagate", "sdp4_propagate_scan",
           "sgp4_init", "sgp4_propagate", "solve_kepler",
           "solve_kepler_fast", "update_secular"]
