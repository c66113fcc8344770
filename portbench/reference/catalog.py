"""A catalog in the reference: parsed, initialized, split by regime."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .constants import MINUTES_PER_DAY, WGS72, GravityModel, gstime
from .sdp4 import DeepElements, sdp4_init_np, sdp4_propagate
from .sgp4 import Sgp4Elements, sgp4_init_np, sgp4_propagate
from .tle import parse_catalog

#: above this eccentricity a half-day resonant lane is a high-eccentricity
#: (Molniya-class) lane: counted apart in the catalog's summary
HEO_ECC = 0.7


class Catalog(NamedTuple):
    """Elements of every lane (numpy f64), the deep lanes' columns and
    their SDP4 coefficients."""

    els: Sgp4Elements
    deep_idx: np.ndarray  # columns that take SDP4
    deep: Optional[DeepElements]  # of the deep lanes only, in deep_idx order
    grav: GravityModel

    @property
    def n_sats(self) -> int:
        return int(self.els.no_kozai.shape[0])

    def summary(self) -> dict:
        """Lanes by regime: near-earth, deep, resonant (geosynchronous and
        half-day) and half-day lanes above HEO_ECC."""
        irez = (np.zeros(0, np.int32) if self.deep is None
                else np.asarray(self.deep.irez))
        ecc = self.els.ecco[self.deep_idx]
        return {"near": self.n_sats - len(self.deep_idx),
                "deep": len(self.deep_idx),
                "geosynchronous": int((irez == 1).sum()),
                "half_day": int((irez == 2).sum()),
                "half_day_heo": int(((irez == 2) & (ecc > HEO_ECC)).sum())}


def build(text: str, grav: GravityModel = WGS72) -> Catalog:
    cols = parse_catalog(text)
    els = sgp4_init_np(grav, no_kozai=cols["no_kozai"], ecco=cols["ecco"],
                       inclo=cols["inclo"], nodeo=cols["nodeo"],
                       argpo=cols["argpo"], mo=cols["mo"],
                       bstar=cols["bstar"], epoch_jd=cols["epoch_jd"])
    deep_idx = np.nonzero(els.is_deep)[0]
    deep = None
    if deep_idx.size:
        sub = Sgp4Elements(*(np.asarray(x)[deep_idx] for x in els))
        deep = sdp4_init_np(grav, sub)
    return Catalog(els, deep_idx, deep, grav)


def _tensors(tree, dtype, device):
    """Float fields in ``dtype``, flags and codes as they are."""
    return type(tree)(*(
        torch.as_tensor(x, device=device,
                        dtype=dtype if np.asarray(x).dtype == np.float64
                        else None) for x in tree))


def propagate(cat: Catalog, jd, fr, *, dtype=torch.float64, device="cuda"):
    """TEME r (km), v (km/s), each (T, S, 3) in ``dtype``, and the (T, S)
    int32 python-sgp4 codes at the epochs ``jd + fr`` (numpy f64, (T,)):
    SGP4 on the near-earth lanes, SDP4 on the deep ones. ``dtype`` is the
    precision of the propagation; the minutes since each epoch are formed
    in f64 and rounded to it."""
    tsince = ((np.asarray(jd)[:, None] - cat.els.epoch_jd[None, :])
              + np.asarray(fr)[:, None]) * MINUTES_PER_DAY
    t = torch.as_tensor(tsince, device=device).to(dtype)
    n_t, n = t.shape
    r = torch.zeros((n_t, n, 3), dtype=dtype, device=device)
    v = torch.zeros_like(r)
    err = torch.zeros((n_t, n), dtype=torch.int32, device=device)
    near = np.setdiff1d(np.arange(n), cat.deep_idx)
    for cols, deep in ((near, None), (cat.deep_idx, cat.deep)):
        if not cols.size:
            continue
        idx = torch.as_tensor(cols, device=device)
        els = _tensors(Sgp4Elements(*(np.asarray(x)[cols] for x in cat.els)),
                       dtype, device)
        if deep is None:
            rr, vv, ee = sgp4_propagate(els, t[:, idx], cat.grav)
        else:
            rr, vv, ee, _ = sdp4_propagate(
                els, _tensors(deep, dtype, device), t[:, idx], cat.grav)
        r[:, idx], v[:, idx], err[:, idx] = rr, vv, ee.to(torch.int32)
    return r, v, err


def to_ecef(r, v, jd, fr):
    """Rotate (T, S, 3) TEME r and v about z by GMST of ``jd + fr``
    (numpy f64, (T,)), in their dtype."""
    gmst = torch.as_tensor(gstime(np.asarray(jd) + np.asarray(fr)),
                           device=r.device).to(r.dtype)[:, None]
    sg, cg = torch.sin(gmst), torch.cos(gmst)

    def rot(x):
        return torch.stack([cg * x[..., 0] + sg * x[..., 1],
                            -sg * x[..., 0] + cg * x[..., 1], x[..., 2]], -1)

    return rot(r), rot(v)
