"""Carry initialized SGP4/SDP4 elements across from numpy.

:func:`elements_from_numpy` takes any object with the
:class:`~astroz_tpu_torch.ops.sgp4.Sgp4Elements` field attributes (the
JAX package's ``Sgp4Elements`` among them), or a dict of them, whose
values numpy can read, and returns this package's elements as tensors on
one device, the card unless the caller asks for another: the same inputs
for both packages. :func:`deep_elements_from_numpy` does the same for
:class:`~astroz_tpu_torch.ops.sdp4.DeepElements`, and
:func:`carry_from_numpy` for the resonance integrator's
:class:`~astroz_tpu_torch.ops.sdp4.ResonanceCarry`.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .ops.sdp4 import DeepElements, ResonanceCarry
from .ops.sgp4 import Sgp4Elements


def _tensors(cls, obj, device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to carry the values to the CPU")

    def get(name):
        return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)

    return cls(*(torch.from_numpy(np.array(get(name))).to(device)
                 for name in cls._fields))


def elements_from_numpy(obj, device="cuda") -> Sgp4Elements:
    """Elements of ``obj`` (attributes or mapping keys named like the
    :class:`Sgp4Elements` fields) as tensors on ``device``; dtypes are
    kept (f64 coefficients, bool masks, int32 error codes)."""
    return _tensors(Sgp4Elements, obj, device)


def deep_elements_from_numpy(obj, device="cuda") -> DeepElements:
    """Deep-space coefficients of ``obj`` (attributes or mapping keys
    named like the :class:`DeepElements` fields) as tensors on
    ``device``; dtypes are kept (f64 coefficients, int32 ``irez``)."""
    return _tensors(DeepElements, obj, device)


def carry_from_numpy(obj, device="cuda") -> ResonanceCarry:
    """A resonance carry of ``obj`` (attributes or mapping keys
    ``atime``, ``xli``, ``xni``, the JAX package's ``ResonanceCarry``
    among them) as f64 tensors on ``device``."""
    return _tensors(ResonanceCarry, obj, device)
