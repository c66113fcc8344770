"""astroz_tpu_torch — the PyTorch/CUDA port of astroz_tpu.

Ported so far: near-earth and mixed near-earth / deep-space catalogs
from TLE/OMM text through SGP4/SDP4 init to ``propagate`` (the fast and
the f64 methods, ``scan_times``, ``propagate_tsince``), the dense-tsince
entry points of ``ops`` (``propagate_fast``, ``sgp4_init``,
``sdp4_init``, ``sgp4_propagate``, ``sdp4_propagate``,
``sdp4_propagate_scan``), conjunction screening (``screen_all``,
``screen_target``), and the python-sgp4 drop-in API (``api``:
``Satrec``, ``SatrecArray``, ``create_sgp4_propagator``) with its host
scalar engines (``ops/scalar.py`` and the native copy in ``native/``),
with every kernel written for the NVIDIA H100 (``csrc/``). The rest of
the JAX package is not here yet (see ROADMAP.md). The package imports
torch and numpy, never JAX.
"""

__version__ = "0.1.0"

from . import api  # noqa: E402
from .constellation import Constellation, screen  # noqa: E402
from .propagation import (SatCatalog, build_catalog,  # noqa: E402
                          catalog_from_elements, propagate,
                          propagate_tsince)
from .screening import screen_all, screen_target  # noqa: E402

__all__ = ["Constellation", "api", "SatCatalog", "build_catalog",
           "catalog_from_elements", "propagate", "propagate_tsince",
           "screen", "screen_all",
           "screen_target", "__version__"]
