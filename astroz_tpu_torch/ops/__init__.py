"""Element init, the fast f32 math, the f64 propagators, and the CUDA
kernels with their plain torch versions."""

from .fast import propagate_fast
from .sdp4 import (DeepElements, ResonanceCarry, fresh_carry,
                   sdp4_propagate, sdp4_propagate_scan)
from .sgp4 import Sgp4Elements, sgp4_propagate

__all__ = ["DeepElements", "ResonanceCarry", "Sgp4Elements", "fresh_carry",
           "propagate_fast", "sdp4_propagate", "sdp4_propagate_scan",
           "sgp4_propagate"]
