"""python-sgp4 drop-in compatible API on the PyTorch port.

Counterpart of ``astroz_tpu/api.py``: a user of ``sgp4.api`` switches
imports and keeps their code. python-sgp4 has no device argument, so
``Satrec.twoline2rv``, ``Satrec.sgp4init`` and
:func:`create_sgp4_propagator` take a keyword-only ``device`` (``"cuda"``
by default; a ``"cuda"`` request without CUDA raises), and a
:class:`SatrecArray` takes its satrecs' device.

* A :class:`Satrec` keeps its initialized elements on the host (f64
  numpy) and builds a catalog on its device only when a call needs one.
  Single-point ``sgp4`` / ``sgp4_tsince`` calls run on the host engines:
  the native core, else the native ctypes engine, else
  ``ops/scalar.py``. One scalar propagation costs less than a device
  launch and its copy back.
* ``Satrec.sgp4_array`` on a CUDA satrec over ``_LANES_MIN_TIMES``
  times or more folds the times into (rows, 512) lanes of the f64
  propagators on the card; otherwise it runs the native array engine.
* ``SatrecArray.sgp4`` on a CUDA array is one ``propagate(...,
  method="fast", layout="sat_major")`` per gravity model: kernel K1 on a
  near-earth array, K2, the HEO escape and K3 on a mixed one. On
  ``device="cpu"`` it takes the native grid first.

Outputs are numpy f64 arrays and Python floats on the host, as
python-sgp4 returns them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch._C import _functorch

from . import native
from . import tle as _tle
from .constants import (WGS72 as _WGS72_CONST, WGS72OLD as _WGS72OLD_CONST,
                        WGS84 as _WGS84_CONST, GravityModel,
                        MINUTES_PER_DAY)
from .ops import scalar
from .ops.sdp4 import sdp4_propagate
from .ops.sgp4 import Sgp4Elements, sgp4_init_np, sgp4_propagate
from .propagation import (SatCatalog, _device, build_catalog,
                          catalog_from_elements, elements_from_arrays,
                          propagate)
from .time import days2mdhms, jday  # noqa: F401  (re-exported)

#: gravity model selectors (python-sgp4 numbering: WGS72OLD=0, WGS72=1,
#: WGS84=2 — both these enums and GravityModel instances are accepted)
WGS72OLD = 0
WGS72 = 1
WGS84 = 2

_GRAV_BY_ENUM = {WGS72OLD: _WGS72OLD_CONST, WGS72: _WGS72_CONST,
                 WGS84: _WGS84_CONST}

#: parity with python-sgp4's "accelerated" C extension flag
accelerated = True

#: Satrec.sgp4_array on a CUDA satrec takes the card's time-as-lanes
#: path from this many times on, keyed on is_deep_space: where it
#: overtook the native array engine on an H100 (chip_smoke.py
#: lanes_crossover, PERF.md §5): on the ISS from ~57k or ~215k points
#: as the host's CPU varied, so the middle of that range; on GEO ~24k
_LANES_MIN_TIMES = {False: 131072, True: 32768}
#: the time-as-lanes fold: (rows, _LANES) minutes since epoch
_LANES = 512


def _resolve_grav(whichconst) -> GravityModel:
    if isinstance(whichconst, GravityModel):
        return whichconst
    try:
        return _GRAV_BY_ENUM[int(whichconst)]
    except (KeyError, TypeError, ValueError):
        raise ValueError(f"unknown gravity model {whichconst!r}") from None


def _host_f64(x: torch.Tensor, out: Optional[np.ndarray] = None
              ) -> np.ndarray:
    """``x`` as a numpy f64 array on the host, written into ``out``
    where given. A CUDA tensor crosses the bus once in its own dtype,
    into page-locked memory (torch's caching host allocator keeps the
    block for the next call), and is cast on the host: a copy into
    pageable memory runs at a fraction of the bus's rate, and a cast on
    the card would double the bytes that cross (PERF.md §5, phase 8)."""
    if out is None:
        out = np.empty(tuple(x.shape), np.float64)
    if x.is_cuda:
        staged = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        staged.copy_(x)
        x = staged
    torch.from_numpy(out).copy_(x)
    return out


class Satrec:
    """Single-satellite record, python-sgp4 compatible."""

    def __init__(self):
        self._host: Optional[Sgp4Elements] = None  # (1,) f64 numpy fields
        self._grav: Optional[GravityModel] = None
        self._satnum = 0
        self._device: Optional[torch.device] = None
        self._cat: Optional[SatCatalog] = None  # on _device, built lazily
        self._tle: Optional[_tle.Tle] = None
        self._scalar = None
        self._scalar_native = None
        self._core = None
        self._init_err = 0
        self.error = 0
        self.t = 0.0

    # ``t``/``error`` live on the native SatCore once it exists (the
    # all-C call path writes them there); properties keep the
    # python-sgp4 attribute contract either way.
    @property
    def t(self) -> float:
        return self._core.t if self._core is not None else self._t

    @t.setter
    def t(self, value: float):
        if self._core is not None:
            self._core.t = value
        else:
            self._t = value

    @property
    def error(self) -> int:
        return self._core.error if self._core is not None else self._error

    @error.setter
    def error(self, value: int):
        if self._core is not None:
            self._core.error = value
        else:
            self._error = value

    # ---- construction ----------------------------------------------------

    @classmethod
    def twoline2rv(cls, line1: str, line2: str, whichconst=WGS72, *,
                   device="cuda") -> "Satrec":
        self = cls()
        self._device = _device(device)
        grav = _resolve_grav(whichconst)
        self._tle = _tle.parse_lines(line1, line2)
        arrays = _tle.TleArrays.from_tles([self._tle])
        self._set_elements(elements_from_arrays(arrays, grav), grav,
                           int(arrays.satnum[0]))
        return self

    def sgp4init(self, whichconst, opsmode: str, satnum: int, epoch: float,
                 bstar: float, ndot: float, nddot: float, ecco: float,
                 argpo: float, inclo: float, mo: float, no_kozai: float,
                 nodeo: float, *, device="cuda") -> "Satrec":
        """python-sgp4 compatible element-wise init. ``epoch`` is days
        since 1949 December 31 00:00 UT (python-sgp4 convention);
        ``no_kozai`` in rad/min.

        Like python-sgp4 (and unlike a constructor), this is an
        *in-place instance method*: ``sat = Satrec(); sat.sgp4init(...)``
        initializes ``sat`` itself. It also returns ``self`` so the
        one-liner ``Satrec().sgp4init(...)`` works.
        """
        self._device = _device(device)
        grav = _resolve_grav(whichconst)
        epoch_jd = epoch + 2433281.5
        els = sgp4_init_np(grav, no_kozai=np.asarray([no_kozai]),
                           ecco=np.asarray([ecco]), inclo=np.asarray([inclo]),
                           nodeo=np.asarray([nodeo]),
                           argpo=np.asarray([argpo]), mo=np.asarray([mo]),
                           bstar=np.asarray([bstar]),
                           epoch_jd=np.asarray([epoch_jd]))
        # drop any TLE from a previous twoline2rv: jdsatepoch and the
        # TLE-derived properties prefer _tle, so a stale one would make
        # every later sgp4(jd, fr) compute tsince against the OLD epoch
        self._tle = None
        self._reset_scalar()
        self._set_elements(els, grav, int(satnum))
        return self

    def _set_elements(self, host: Sgp4Elements, grav: GravityModel,
                      satnum: int):
        self._host, self._grav, self._satnum = host, grav, satnum
        self._cat = None
        self._init_err = self.error = int(host.error[0])

    def _reset_scalar(self):
        """Drop the lazily-bound scalar engines after an in-place
        re-init: the native SatCore owns a COPY of the element vector
        and shadows ``sgp4``/``sgp4_tsince`` as instance attributes, so
        a ``sgp4init`` after a propagate call would otherwise keep
        answering with the old elements."""
        self._scalar = None
        self._scalar_native = None
        if self._core is not None:
            self._t, self._error = self._core.t, self._core.error
            self._core = None
        self.__dict__.pop("sgp4", None)
        self.__dict__.pop("sgp4_tsince", None)

    def _catalog(self) -> SatCatalog:
        """The one-satellite catalog on the satrec's device, built at
        first use (the time-as-lanes path) and kept."""
        if self._cat is None:
            self._cat = catalog_from_elements(
                self._host, self._grav,
                satnum=np.asarray([self._satnum], np.int64),
                device=self._device)
        return self._cat

    # ---- propagation ------------------------------------------------------

    def _scalar_record(self):
        """Lazily-built scalar record for single-point calls, and the
        native engines over it: the SatCore where the CPython extension
        built (the whole call in C; it then shadows ``sgp4`` and
        ``sgp4_tsince`` as instance attributes, and ``t``/``error``
        move into it), and the ctypes engine in any case."""
        if self._scalar is None:
            g = self._grav
            gc = scalar.GravConsts(g.mu, g.radius_earth_km, g.xke,
                                   g.tumin, g.j2, g.j3, g.j4, g.j3oj2)
            h = self._host
            self._scalar = scalar.sgp4init(
                gc, float(h.epoch_jd[0]), float(h.bstar[0]),
                float(h.ecco[0]), float(h.argpo[0]), float(h.inclo[0]),
                float(h.mo[0]), float(h.no_kozai[0]), float(h.nodeo[0]))
            self._scalar_native = native.scalar_engine(self._scalar)
            core = native.sat_core(self._scalar, self.jdsatepoch,
                                   self.jdsatepochF)
            if core is not None:
                core.t, core.error = self._t, self._error
                self._core = core
                self.sgp4 = core.sgp4
                self.sgp4_tsince = core.sgp4_tsince
        return self._scalar

    def _on_accel(self) -> bool:
        return self._device.type == "cuda"

    def sgp4(self, jd: float, fr: float
             ) -> Tuple[int, Tuple[float, float, float],
                        Tuple[float, float, float]]:
        """Propagate to jd+fr. Returns (error, r_teme_km, v_teme_km_s)."""
        self.t = ((jd - self.jdsatepoch) + (fr - self.jdsatepochF)) \
            * MINUTES_PER_DAY
        init_err = self._init_err
        if init_err:
            # init-time failure: match the batch path's zero-fill
            self.error = init_err
            return init_err, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)
        rec = self._scalar_record()
        if self._scalar_native is not None:
            e, r, v = self._scalar_native.sgp4(self.t)
        else:
            e, r, v = scalar.sgp4(rec, self.t)
        self.error = e
        return e, r, v

    def sgp4_tsince(self, tsince: float):
        """Propagate to minutes since epoch (python-sgp4 parity)."""
        jd = self.jdsatepoch
        fr = self.jdsatepochF + tsince / MINUTES_PER_DAY
        return self.sgp4(jd, fr)

    def _sgp4_lanes(self, jd: np.ndarray, fr: np.ndarray):
        """Time as lanes: the times fill (rows, _LANES) lanes of one
        satellite's f64 propagate on its device."""
        n = len(jd)
        cat = self._catalog()
        pad = (-n) % _LANES
        tsince = ((np.asarray(jd, np.float64)
                   - float(self._host.epoch_jd[0]))
                  + np.asarray(fr, np.float64)) * MINUTES_PER_DAY
        tsince = np.concatenate(
            [tsince, np.full(pad, tsince[-1])]).reshape(-1, _LANES)
        t = torch.as_tensor(tsince, device=cat.device)
        if cat.has_deep:
            r, v, err, _ = sdp4_propagate(cat.els, cat.deep, t, cat.grav)
        else:
            r, v, err = sgp4_propagate(cat.els, t, cat.grav)
        return (err.reshape(-1)[:n].cpu().numpy(),
                _host_f64(r.reshape(-1, 3)[:n]),
                _host_f64(v.reshape(-1, 3)[:n]))

    def _sgp4_many(self, jd: np.ndarray, fr: np.ndarray):
        if (self._on_accel()
                and len(jd) >= _LANES_MIN_TIMES[self.is_deep_space]):
            return self._sgp4_lanes(jd, fr)
        if not self._init_err:
            self._scalar_record()
            if self._scalar_native is not None:
                # the native array engine (8-wide SIMD on near-earth
                # lanes) beats a device round trip for small arrays
                tsince = ((jd - self.jdsatepoch)
                          + (fr - self.jdsatepochF)) * MINUTES_PER_DAY
                return self._scalar_native.sgp4_array(tsince)
        r, v, err = propagate(self._catalog(), jd, fr)
        return (err[:, 0].cpu().numpy(), _host_f64(r[:, 0]),
                _host_f64(v[:, 0]))

    def sgp4_array(self, jd: np.ndarray, fr: np.ndarray):
        """Vectorized over times: returns (e, r, v) with shapes
        (n,), (n, 3), (n, 3)."""
        return self._sgp4_many(np.asarray(jd, np.float64),
                               np.asarray(fr, np.float64))

    # ---- properties (python-sgp4 names) -----------------------------------

    def _f(self, field) -> float:
        return float(getattr(self._host, field)[0])

    @property
    def satnum(self) -> int:
        return self._satnum

    @property
    def jdsatepoch(self) -> float:
        return self._tle.jdsatepoch if self._tle else float(
            np.floor(self._f("epoch_jd") - 0.5) + 0.5)

    @property
    def jdsatepochF(self) -> float:
        return (self._tle.jdsatepochF if self._tle
                else self._f("epoch_jd") - self.jdsatepoch)

    @property
    def epochyr(self) -> int:
        return self._tle.epochyr if self._tle else 0

    @property
    def epochdays(self) -> float:
        return self._tle.epochdays if self._tle else 0.0

    @property
    def classification(self) -> str:
        return self._tle.classification if self._tle else "U"

    @property
    def intldesg(self) -> str:
        return self._tle.intldesg if self._tle else ""

    @property
    def elnum(self) -> int:
        return self._tle.elnum if self._tle else 0

    @property
    def revnum(self) -> int:
        return self._tle.revnum if self._tle else 0

    @property
    def ephtype(self) -> int:
        return self._tle.ephtype if self._tle else 0

    @property
    def ndot(self) -> float:
        return self._tle.ndot if self._tle else 0.0

    @property
    def nddot(self) -> float:
        return self._tle.nddot if self._tle else 0.0

    @property
    def is_deep_space(self) -> bool:
        return bool(self._host.is_deep[0])

    # orbital elements + derived (all from the initialized element set)
    no_kozai = property(lambda self: self._f("no_kozai"))
    no_unkozai = property(lambda self: self._f("no_unkozai"))
    ecco = property(lambda self: self._f("ecco"))
    inclo = property(lambda self: self._f("inclo"))
    nodeo = property(lambda self: self._f("nodeo"))
    argpo = property(lambda self: self._f("argpo"))
    mo = property(lambda self: self._f("mo"))
    bstar = property(lambda self: self._f("bstar"))
    a = property(lambda self: self._f("a"))
    alta = property(lambda self: self._f("alta"))
    altp = property(lambda self: self._f("altp"))
    gsto = property(lambda self: self._f("gsto"))
    mdot = property(lambda self: self._f("mdot"))
    argpdot = property(lambda self: self._f("argpdot"))
    nodedot = property(lambda self: self._f("nodedot"))

    #: python-sgp4 compat: mean motion in rad/min (alias)
    @property
    def no(self) -> float:
        return self.no_kozai

    #: operation mode — always the modern 'i'mproved mode
    operationmode = "i"
    method = property(lambda self: "d" if self.is_deep_space else "n")


def _concat(trees):
    """Field-wise concatenation of host element sets."""
    return type(trees[0])(*(np.concatenate(xs) for xs in zip(*trees)))


class SatrecArray:
    """Batch of satellites, python-sgp4 compatible.

    ``sgp4(jd, fr)`` returns (e, r, v) shaped (n_sats, n_times, ...). The
    array lives on its satrecs' device: one catalog there, built from
    the TLEs, or from the satrecs' host elements concatenated (element-
    wise inits, mixed gravity models), with one catalog a gravity model
    where the models differ.
    """

    def __init__(self, satrecs: Sequence[Satrec], method: str = "fast"):
        if not satrecs:
            raise ValueError("empty SatrecArray")
        self._satrecs = list(satrecs)
        self._method = method
        devices = {s._device for s in satrecs}
        if len(devices) > 1:
            raise ValueError(f"satrecs on several devices: {devices}")
        self._device = devices.pop()
        grav = satrecs[0]._grav
        same_grav = all(s._grav == grav for s in satrecs)
        tles = [s._tle for s in satrecs]
        self._cat: Optional[SatCatalog] = None
        self._grav_groups = None
        self._native_grid = None
        if same_grav and all(t is not None for t in tles):
            self._cat = build_catalog(tles, grav=grav, device=self._device)
        elif same_grav:
            self._cat = self._catalog_of(range(len(satrecs)), grav)
        else:
            # mixed gravity models: each satellite keeps its init-time
            # constants (python-sgp4's per-satrec whichconst), and the
            # propagation consumes the model too (xke/j2/... in the
            # secular and short-period terms), so the device path runs
            # one propagate per distinct model over (rows, catalog)
            groups = {}
            for i, s in enumerate(satrecs):
                groups.setdefault(s._grav, []).append(i)
            self._grav_groups = [(np.asarray(idx, np.int64),
                                  self._catalog_of(idx, g))
                                 for g, idx in groups.items()]

    def _catalog_of(self, rows, grav) -> SatCatalog:
        sats = [self._satrecs[i] for i in rows]
        return catalog_from_elements(
            _concat([s._host for s in sats]), grav,
            satnum=np.asarray([s._satnum for s in sats], np.int64),
            device=self._device)

    def __len__(self) -> int:
        return len(self._satrecs)

    @property
    def catalog(self) -> SatCatalog:
        """The whole array as one catalog (under the first satrec's
        gravity model where the models differ)."""
        if self._cat is None:
            self._cat = self._catalog_of(range(len(self)),
                                         self._satrecs[0]._grav)
        return self._cat

    def sgp4(self, jd: np.ndarray, fr: np.ndarray,
             velocities: bool = True):
        """Returns (e, r, v) with shapes (n_sats, n_times),
        (n_sats, n_times, 3), (n_sats, n_times, 3); ``v`` is left out
        with ``velocities=False``."""
        jd = np.asarray(jd, np.float64)
        fr = np.asarray(fr, np.float64)
        if self._device.type == "cpu":
            # the native grid (8-wide SIMD per satellite, threads over
            # satellite ranges), each satrec under its own gravity model
            out = self._sgp4_native(jd, fr)
            if out is not None:
                e, r, v = out
                return (e, r, v) if velocities else (e, r)
        out = self._sgp4_device(jd, fr, velocities)
        return out if velocities else out[:2]

    def _sgp4_device(self, jd, fr, velocities, r_out=None, v_out=None):
        """The catalog path: one ``propagate`` a gravity model, its
        outputs copied to the host (into ``r_out`` / ``v_out`` where
        given)."""
        kw = dict(velocities=velocities, layout="sat_major",
                  method=self._method)
        if self._grav_groups is None:
            r, v, err = propagate(self._cat, jd, fr, **kw)
            return (err.cpu().numpy(), _host_f64(r, r_out),
                    _host_f64(v, v_out) if velocities else None)
        n_t = np.broadcast_arrays(np.atleast_1d(jd), np.atleast_1d(fr))[0] \
            .shape[0]
        e = np.zeros((len(self), n_t), np.int32)
        r = np.zeros((len(self), n_t, 3)) if r_out is None else r_out
        v = None
        if velocities:
            v = np.zeros((len(self), n_t, 3)) if v_out is None else v_out
        for idx, g_cat in self._grav_groups:
            rg, vg, eg = propagate(g_cat, jd, fr, **kw)
            e[idx] = eg.cpu().numpy()
            r[idx] = _host_f64(rg)
            if velocities:
                v[idx] = _host_f64(vg)
        return e, r, v

    def _sgp4_native(self, jd: np.ndarray, fr: np.ndarray):
        """All-native (n_sats, n_times) sweep through each satrec's
        packed element vector: one native crossing a thread over
        satellite ranges (``native.sgp4_grid``)."""
        n_t = jd.shape[0]
        n_s = len(self._satrecs)
        if self._native_grid is None:
            # pack every healthy satellite's element vector once
            ok, vec_rows, eps, epfs = [], [], [], []
            for i, s in enumerate(self._satrecs):
                if s._init_err:
                    continue
                s._scalar_record()
                ok.append(i)
                vec_rows.append(s._scalar_native._vec)
                eps.append(s.jdsatepoch)
                epfs.append(s.jdsatepochF)
            self._native_grid = (
                np.asarray(ok, np.int64),
                np.asarray(vec_rows, np.float64) if vec_rows
                else np.zeros((0, len(native.SCALAR_FIELDS))),
                np.asarray(eps), np.asarray(epfs))
        ok, vecs, eps, epfs = self._native_grid
        init_err = np.asarray([s._init_err for s in self._satrecs],
                              np.int32)
        if len(ok) == 0:
            e = np.repeat(init_err[:, None], n_t, axis=1)
            z = np.zeros((n_s, n_t, 3), np.float64)
            return e, z, z.copy()
        tsince = ((jd[None, :] - eps[:, None])
                  + (fr[None, :] - epfs[:, None])) * MINUTES_PER_DAY
        out = native.sgp4_grid(vecs, tsince)
        if len(ok) == n_s:
            # every satellite healthy (the common case): r/v are views
            # into the native buffer, no scatter copies
            return out
        eo, ro, vo = out
        # failed inits: their error code and zero-filled outputs, as the
        # catalog path gives them
        e = np.repeat(init_err[:, None], n_t, axis=1)
        r = np.zeros((n_s, n_t, 3), np.float64)
        v = np.zeros((n_s, n_t, 3), np.float64)
        e[ok], r[ok], v[ok] = eo, ro, vo
        return e, r, v

    def sgp4_into(self, jd: np.ndarray, fr: np.ndarray,
                  r_out: np.ndarray, v_out: Optional[np.ndarray] = None,
                  e_out: Optional[np.ndarray] = None) -> None:
        """Propagate into caller-provided numpy buffers: ``r_out`` /
        ``v_out`` ``(n_sats, n_times, 3)`` float64, ``e_out``
        ``(n_sats, n_times)``. On the card the results are copied
        straight into them (no f64 array in between); the engine is the
        one :meth:`sgp4` takes."""
        jd = np.asarray(jd, np.float64)
        fr = np.asarray(fr, np.float64)
        velocities = v_out is not None
        if self._device.type == "cpu":
            out = self.sgp4(jd, fr, velocities=velocities)
            err = out[0]
            np.copyto(r_out, out[1])
            if velocities:
                np.copyto(v_out, out[2])
        else:
            err, _, _ = self._sgp4_device(jd, fr, velocities, r_out, v_out)
        if e_out is not None:
            np.copyto(e_out, err)


# ---------------------------------------------------------------------------
# astrojax-compatible functional surface
# ---------------------------------------------------------------------------


def _resonance_steps_under_transform(t) -> int:
    """``ceil(max |t| / 720)`` of the values under a tensor's
    ``torch.func`` wrappers (every batch of ``vmap``, the primal of
    ``grad`` / ``jacrev``): the resonance steps that bring every point
    within a step of its time."""
    while _functorch.is_functorch_wrapped_tensor(t):
        t = _functorch.get_unwrapped(t)
    return int(math.ceil(float(t.abs().max()) / 720.0)) if t.numel() else 0


def create_sgp4_propagator(line1: str, line2: str, gravity=WGS72, *,
                           device="cuda"):
    """astrojax-style functional API: returns ``(params, propagate_fn)``
    where ``propagate_fn(params, tsince_min, *, max_steps=None)`` maps
    minutes since epoch (any shape) to ``(r_km, v_km_s)`` stacked on the
    trailing axis, f64 tensors on the params' device.

    ``propagate_fn`` is a plain torch function that runs under
    ``torch.func.vmap``, ``jacrev`` and ``grad``. A deep-space TLE's
    resonance integration loops on the host until every lane is within a
    step of its time, which no ``torch.func`` transform can trace: inside
    one, with ``max_steps`` None, the function reads the tensor under the
    transforms' wrappers and runs ``ceil(max |tsince| / 720)`` masked
    steps, which give the loop's bits. ``max_steps`` (at least that
    count) sets the steps outright.
    """
    grav = _resolve_grav(gravity)
    cat = build_catalog("\n".join([line1.rstrip(), line2.rstrip()]),
                        grav=grav, device=device)
    params = (cat.els, cat.deep)

    def propagate_fn(params, tsince, *, max_steps: Optional[int] = None):
        els, deep = params
        # broadcast against the one-satellite axis
        t = torch.as_tensor(tsince, dtype=torch.float64,
                            device=els.no_kozai.device)[..., None]
        if deep is not None:
            if max_steps is None and _functorch.is_functorch_wrapped_tensor(t):
                max_steps = _resonance_steps_under_transform(t)
            r, v, _, _ = sdp4_propagate(els, deep, t, grav,
                                        max_steps=max_steps)
        else:
            r, v, _ = sgp4_propagate(els, t, grav)
        return r[..., 0, :], v[..., 0, :]

    return params, propagate_fn
