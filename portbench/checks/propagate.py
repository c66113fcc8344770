"""A sweep against the reference: every point of it.

The numbers, each the widest over the sweep's points where the program
and the reference both report code 0:

* ``near_km``: position gap on near-earth lanes (km);
* ``deep_km``: position gap on deep-space lanes, resonant and
  high-eccentricity ones included (km; absent without deep lanes);
* ``vel_mps``: velocity gap on every lane (m/s);
* ``codes``: points whose python-sgp4 code differs from the reference's.
"""

from __future__ import annotations

import torch

from ..reference import catalog as ref
from . import worse

FRAMES = ("teme", "ecef")


def time_major(r, layout: str):
    """(T, S, 3) view of a sweep's r or v in ``layout``."""
    if r is None:
        return None
    if layout == "planes":
        return r.permute(1, 2, 0)
    if layout == "sat_major":
        return r.transpose(0, 1)
    return r


def codes_time_major(err, layout: str):
    return err.T if layout == "sat_major" else err


def reference_sweep(ref_cat, traffic, jd, fr, dtype, device):
    """The reference's outputs at ``jd + fr`` in the mix's frame:
    (T, S, 3) r, v and (T, S) codes."""
    r, v, err = ref.propagate(ref_cat, jd, fr, dtype=dtype, device=device)
    if traffic["output"] == "ecef":
        r, v = ref.to_ecef(r, v, jd, fr)
    return r, v, err


def readings(r, v, err, ref_cat, traffic, jd, fr, device) -> dict:
    """The numbers of one sweep given as (T, S, 3) r, v (v None without
    velocities) and (T, S) codes, against the f64 reference, in blocks of
    time rows."""
    if traffic["output"] not in FRAMES:
        raise NotImplementedError(f"no check for output {traffic['output']}")
    n_t, n = err.shape
    deep = torch.zeros(n, dtype=torch.bool, device=device)
    deep[torch.as_tensor(ref_cat.deep_idx, device=device)] = True
    out = {"near_km": 0.0, "deep_km": 0.0, "vel_mps": 0.0, "codes": 0}
    rows = max(1, (1 << 24) // max(n, 1))
    for a in range(0, n_t, rows):
        b = min(a + rows, n_t)
        rr, vr, er = reference_sweep(ref_cat, traffic, jd[a:b], fr[a:b],
                                     torch.float64, device)
        e = err[a:b].to(er.device)
        ok = (e == 0) & (er == 0)
        dr = torch.linalg.vector_norm(r[a:b].to(rr) - rr, dim=-1)
        dr = torch.where(ok, dr, 0.0)
        out["near_km"] = worse(out["near_km"], _max(dr[:, ~deep]))
        out["deep_km"] = worse(out["deep_km"], _max(dr[:, deep]))
        if v is not None:
            dv = torch.linalg.vector_norm(v[a:b].to(vr) - vr, dim=-1)
            out["vel_mps"] = worse(out["vel_mps"],
                                   _max(torch.where(ok, dv, 0.0)) * 1e3)
        out["codes"] += int((e != er).sum())
    if not ref_cat.deep_idx.size:
        del out["deep_km"]
    if v is None:
        del out["vel_mps"]
    return out


def _max(x) -> float:
    """The largest entry, NaN if any is NaN, 0 when empty."""
    if not x.numel():
        return 0.0
    if bool(torch.isnan(x).any()):
        return float("nan")
    return float(x.max())


def judge(req_out, ref_cat, traffic, jd, fr, device) -> dict:
    """The numbers of a timed sweep's outputs ``(r, v, err)``, in the
    mix's layout."""
    r, v, err = req_out
    layout = traffic["layout"]
    return readings(time_major(r, layout), time_major(v, layout),
                    codes_time_major(err, layout), ref_cat, traffic, jd, fr,
                    device)


def control(ref_cat, traffic, jd, fr, device) -> tuple:
    """The reference in float32, put in the program's place: its sweep in
    the mix's frame, as (T, S, 3) r, v and (T, S) codes."""
    return reference_sweep(ref_cat, traffic, jd, fr, torch.float32, device)
