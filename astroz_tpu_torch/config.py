"""Global configuration for astroz_tpu_torch.

Counterpart of ``astroz_tpu/config.py``. SGP4/SDP4 need double precision
to hold the <100 m accuracy budget against python-sgp4, so the element
init and the f64 path compute in ``torch.float64``; the fast kernels
take their f32 tails on top of it. JAX has to switch x64 on at import;
torch needs no switch, so this module only names the dtype.
"""

from __future__ import annotations

import torch

#: Default floating dtype for element sets and the f64 path.
DEFAULT_DTYPE = torch.float64


def default_dtype() -> torch.dtype:
    return DEFAULT_DTYPE
