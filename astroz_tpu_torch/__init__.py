"""astroz_tpu_torch — the PyTorch/CUDA port of astroz_tpu.

Ported so far: near-earth and mixed near-earth / deep-space catalogs
from TLE/OMM text through SGP4/SDP4 init to ``propagate`` (the fast and
the f64 methods, ``scan_times``, which takes the f64 method's own launch
on the card, ``propagate_tsince``), the dense-tsince
entry points of ``ops`` (``propagate_fast``, ``sgp4_init``,
``sdp4_init``, ``sgp4_propagate``, ``sdp4_propagate``,
``sdp4_propagate_scan``), conjunction screening (``screen_all``,
``screen_target``), and the python-sgp4 drop-in API (``api``:
``Satrec``, ``SatrecArray``, ``create_sgp4_propagator``) with its host
scalar engines (``ops/scalar.py``), with every kernel written for the
NVIDIA H100 (``csrc/``). The native runtime (``native/``: the bulk TLE
parser on ``build_catalog``'s path, the telemetry frame scanner, the
scalar engine and the C ABI), telemetry ingestion (``io``), and the
host-side domain modules (``constants``, ``equatorial``, ``spice``,
``fits``, ``mission``, ``config``, ``profiling``) are here too, and so is
the numerical stack: ``calculations`` (Kepler, element <-> state,
transfers, TRIAD, quaternions, attitude), ``orbital_mechanics``,
``propagators`` (force models, RK4 and DP8(7), ``propagate_fixed``,
``Propagator``, ``propagate_numerical``), ``spacecraft`` and
``montecarlo``, on the card by default (no TPU kernel lies on that path;
the integrators run in the integrator kernel, ``csrc/integrate_f64.cu``,
for the force models it computes), and multi-device: ``parallel`` (a mesh of devices
driven from one process, sharded propagation) with the mesh screens
``screen_all(mesh=)`` and ``screen_all_ring``. The package
imports torch and numpy, never JAX.
"""

__version__ = "0.1.0"

from . import api  # noqa: E402
from . import calculations  # noqa: E402
from . import config  # noqa: E402
from . import constants  # noqa: E402
from . import equatorial  # noqa: E402
from . import fits  # noqa: E402
from . import io  # noqa: E402
from . import mission  # noqa: E402
from . import montecarlo  # noqa: E402
from . import native  # noqa: E402
from . import orbital_mechanics  # noqa: E402
from . import parallel  # noqa: E402
from . import profiling  # noqa: E402
from . import propagators  # noqa: E402
from . import spacecraft  # noqa: E402
from . import spice  # noqa: E402
from .constellation import Constellation, screen  # noqa: E402
from .propagation import (SatCatalog, build_catalog,  # noqa: E402
                          catalog_from_elements, propagate,
                          propagate_tsince)
from .screening import (screen_all, screen_all_ring,  # noqa: E402
                        screen_target)

__all__ = ["Constellation", "api", "calculations", "config", "constants",
           "equatorial", "fits", "io", "mission", "montecarlo", "native",
           "orbital_mechanics", "parallel", "profiling", "propagators",
           "spacecraft", "spice",
           "SatCatalog", "build_catalog", "catalog_from_elements",
           "propagate", "propagate_tsince", "screen", "screen_all",
           "screen_all_ring", "screen_target", "__version__"]
