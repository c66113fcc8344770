"""astroz_tpu_torch — the PyTorch/CUDA port of astroz_tpu.

Ported so far: the ``method="fast"`` path of near-earth and mixed
near-earth / deep-space catalogs, from TLE/OMM text through SGP4/SDP4
init to ``propagate``, and conjunction screening on it (``screen_all``,
``screen_target``), with their kernels written for the NVIDIA H100
(``csrc/``). The f64 path and the rest of the JAX package raise
``NotImplementedError`` or are not here yet (see ROADMAP.md). The
package imports torch and numpy, never JAX.
"""

__version__ = "0.1.0"

from .constellation import Constellation, screen  # noqa: E402
from .propagation import (SatCatalog, build_catalog,  # noqa: E402
                          catalog_from_elements, propagate)
from .screening import screen_all, screen_target  # noqa: E402

__all__ = ["Constellation", "SatCatalog", "build_catalog",
           "catalog_from_elements", "propagate", "screen", "screen_all",
           "screen_target", "__version__"]
