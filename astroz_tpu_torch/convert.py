"""Carry initialized SGP4/SDP4 elements across from numpy.

:func:`elements_from_numpy` takes any object with the
:class:`~astroz_tpu_torch.ops.sgp4.Sgp4Elements` field attributes (the
JAX package's ``Sgp4Elements`` among them), or a dict of them, whose
values numpy can read, and returns this package's elements as tensors on
one device: the same inputs for both packages.
:func:`deep_elements_from_numpy` does the same for
:class:`~astroz_tpu_torch.ops.sdp4.DeepElements`.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .ops.sdp4 import DeepElements
from .ops.sgp4 import Sgp4Elements


def _tensors(cls, obj, device):
    def get(name):
        return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)

    return cls(*(torch.from_numpy(np.array(get(name))).to(device)
                 for name in cls._fields))


def elements_from_numpy(obj, device="cpu") -> Sgp4Elements:
    """Elements of ``obj`` (attributes or mapping keys named like the
    :class:`Sgp4Elements` fields) as tensors on ``device``; dtypes are
    kept (f64 coefficients, bool masks, int32 error codes)."""
    return _tensors(Sgp4Elements, obj, device)


def deep_elements_from_numpy(obj, device="cpu") -> DeepElements:
    """Deep-space coefficients of ``obj`` (attributes or mapping keys
    named like the :class:`DeepElements` fields) as tensors on
    ``device``; dtypes are kept (f64 coefficients, int32 ``irez``)."""
    return _tensors(DeepElements, obj, device)
