"""Catalog propagation of mixed near-earth / deep-space catalogs.

Counterpart of ``astroz_tpu/propagation.py``: ``build_catalog`` parses
and initializes SGP4 and, where any lane is deep (period of 225 min or
more), SDP4 on the host, splits off the deep subset and moves the
elements to one device. ``propagate(method="fast")`` runs over the
separable grid ``tsince = t_time[t] - t_sat[s]``:

* a near-earth catalog through kernel K1 (``ops/cuda_sgp4.py``);
* a mixed catalog through kernel K2 over the deep subset, the full-f64
  recompute of its extreme half-day lanes (the HEO escape: the f64
  kernel's ESCAPE mode, which writes into K2's planes), then kernel K3,
  which is K1 with the deep columns copied in from K2's planes.

Frames, layouts and the satellite mask are one launch of the epilogue
kernel (``ops/cuda_finalize.py:finalize``) on the kernels' (3, T, S)
planes, or none where the caller asks for TEME planes.
``propagate(method="f64")`` (the default, as in the JAX package)
and :func:`propagate_tsince` compute ``ops/sgp4.py:sgp4_propagate`` or
``ops/sdp4.py:sdp4_propagate`` over the dense ``(T, S)`` grid of minutes
since each epoch in one launch of the f64 kernel: ``propagate`` hands it
the sweep's jd and fr rows, and the kernel forms each point's minutes
(``ops/cuda_sgp4.py:sgp4_f64_dense_epochs``), ``propagate_tsince`` its
own grid (``sgp4_f64_dense``). ``scan_times=True`` (``sgp4_f64_scan``,
the plain ``sdp4_propagate_scan`` on the CPU) takes that same launch on
the card, whose row walk carries the resonance from row to row; the
epilogue kernel turns the time-major outputs into the caller's frame
and layout. The deep subset's resonance tables are one launch of TABLES
(``ops/cuda_sgp4.py:resonance_tables``) per catalog and depth. The JAX
package's
small-grid route to its native host engine (item 11) is not ported: on a
CUDA catalog every fast propagate goes through the kernels.
"""

from __future__ import annotations

from functools import cached_property
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .constants import MINUTES_PER_DAY, WGS72, GravityModel
from .ops.cuda_finalize import (LAYOUTS, OUTPUT_MODES, finalize,
                                 is_identity)
from .ops.cuda_sgp4 import (LYDDANE_INCL, F64Staging, MergeMaps,
                             f64_staging, propagate_deep_sep,
                             propagate_fast_sep,
                             propagate_fast_sep_merge, resonance_tables,
                             sgp4_f64_dense, sgp4_f64_dense_epochs,
                             sgp4_f64_escape, sgp4_f64_scan)
from .ops.fast import (DEEP_FIELD_NAMES, DEEP_SPINE_FIELD_NAMES,
                       deep_f32_fields, shallow_staging)
from .ops.sdp4 import DeepElements, sdp4_init_np
from .ops.sgp4 import Sgp4Elements, _device, sgp4_init_np
from .profiling import span
from .tle import Tle, TleArrays, iter_tles, parse_omm

#: half-day resonant (irez == 2) lanes above this eccentricity are
#: recomputed in f64 by the fast path (SatCatalog.heo_escape): the f32
#: deep tail loses tens of metres near their perigees
HEO_ESCAPE_ECC = 0.7
#: with more escape lanes than this the f64 recompute would stop being a
#: small part of a sweep; such a catalog keeps the f32 tail's accuracy
_HEO_ESCAPE_CAP = 512


class DeepStaging(NamedTuple):
    """Per-catalog device tensors of the deep subset (kernels K2, K3)."""

    t_sat: torch.Tensor  # (D,) f64 epochs, minutes from the earliest
    spine: torch.Tensor  # (13, D) f64 rows ops.fast.DEEP_SPINE_FIELD_NAMES
    tail: torch.Tensor  # (33, D) f32 rows ops.fast.DEEP_FIELD_NAMES
    flags: torch.Tensor  # (2, D) i32 rows [irez, init error]
    slot: torch.Tensor  # (S,) i32: -1, or the column's deep-subset index
    maps: MergeMaps  # K3's column maps of `slot`


class FastStaging(NamedTuple):
    """Per-catalog device tensors every fast propagate reads."""

    t_sat: torch.Tensor  # (S,) f64 epochs, minutes from the earliest
    spine: torch.Tensor  # (12, S) f64 rows ops.fast.SPINE_FIELD_NAMES
    tail: torch.Tensor  # (21, S) f32 rows ops.fast.TAIL_FIELD_NAMES
    flags: torch.Tensor  # (2, S) i32 rows [isimp, init error]
    deep: Optional[DeepStaging]  # None for a near-earth catalog


class HeoEscape(NamedTuple):
    """The extreme half-day lanes of the deep subset, on the device."""

    t_sat: torch.Tensor  # (X,) f64 epochs, minutes from the earliest
    idx: torch.Tensor  # (X,) i32 positions in the deep subset
    staged: F64Staging  # their elements and deep-space coefficients as
    #                     the f64 kernel reads them (f64_unstage: back)


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _on(device, tree):
    return type(tree)(*(torch.as_tensor(x, device=device) for x in tree))


def deep_slots(host: Sgp4Elements, deep: DeepElements) -> np.ndarray:
    """The deep lanes of a catalog in kernel K2's slot order: grouped by
    regime (inclination under LYDDANE_INCL or not, then resonance irez
    0, 1, 2), in catalog order within a group, so that the 32 neighbouring
    slots of a warp seldom take both sides of K2's Lyddane or resonance
    branch. Each lane is propagated on its own, so the order moves no
    output bit."""
    idx = np.nonzero(host.is_deep)[0]
    key = ((host.inclo[idx] < LYDDANE_INCL) * 3
           + np.asarray(deep.irez)[idx])
    return idx[np.argsort(key, kind="stable")]


class SatCatalog:
    """An initialized catalog on one device.

    ``host`` keeps the f64 numpy elements from init; ``els`` holds the
    same fields as tensors on ``device``, moved there once. A catalog
    with deep lanes also keeps their SDP4 coefficients (``deep_host``,
    numpy, every lane; ``deep``, the same on the device, moved at first
    use by the f64 path, which takes SDP4 on every lane of a catalog
    that has them: a shard of a mixed catalog keeps them even where it
    holds no deep lane) and the static deep partition: ``deep_idx``
    (the deep columns, in K2's slot order, :func:`deep_slots`) and the
    deep subset's elements and coefficients in that order on the device
    (``els_deep``, ``deep_sub``); these are None otherwise."""

    def __init__(self, els: Sgp4Elements, grav: GravityModel,
                 satnum: np.ndarray, names=None, *,
                 deep: Optional[DeepElements] = None, device="cuda"):
        self.grav = grav
        self.satnum = satnum
        self.names = names
        self.device = _device(device)
        self.host = Sgp4Elements(*(_to_numpy(x) for x in els))
        self.els = _on(self.device, self.host)
        if deep is None and bool(self.host.is_deep.any()):
            raise ValueError("deep must hold the SDP4 coefficients "
                             "(ops.sdp4.sdp4_init_np) when a lane is deep")
        self.deep_host = deep
        self.deep_idx = self.els_deep = self.deep_sub = None
        if deep is not None:
            self.deep_idx = deep_slots(self.host, deep)
            self.els_deep = _on(self.device, Sgp4Elements(
                *(x[self.deep_idx] for x in self.host)))
            self.deep_sub = _on(self.device, DeepElements(
                *(np.asarray(x)[self.deep_idx] for x in deep)))
        self._tables = {}

    def __len__(self) -> int:
        return int(self.host.no_kozai.shape[0])

    @property
    def n_sats(self) -> int:
        return len(self)

    @property
    def is_deep(self) -> np.ndarray:
        return self.host.is_deep

    @property
    def n_deep(self) -> int:
        return int(self.is_deep.sum())

    @property
    def has_deep(self) -> bool:
        return bool(self.is_deep.any())

    @cached_property
    def deep(self) -> Optional[DeepElements]:
        """Every lane's SDP4 coefficients on the device (zeros on
        near-earth lanes), which the f64 path reads; None for a
        near-earth catalog."""
        if self.deep_host is None:
            return None
        return _on(self.device, DeepElements(
            *(np.asarray(x) for x in self.deep_host)))

    @property
    def epochs_jd(self) -> np.ndarray:
        return self.host.epoch_jd

    @cached_property
    def epoch_min_jd(self) -> float:
        return float(self.epochs_jd.min()) if len(self) else 0.0

    @property
    def init_errors(self) -> np.ndarray:
        """Per-satellite python-sgp4 init error codes (0 = ok)."""
        return self.host.error

    @property
    def deep_epochs_jd(self) -> Optional[np.ndarray]:
        return self.epochs_jd[self.deep_idx] if self.has_deep else None

    def _t_sat(self, epochs_jd) -> torch.Tensor:
        return torch.as_tensor(
            (epochs_jd - self.epoch_min_jd) * MINUTES_PER_DAY,
            dtype=torch.float64, device=self.device)

    @cached_property
    def fast_staging(self) -> FastStaging:
        """Epoch offsets and the field matrices of kernels K1-K3, built
        once per catalog on its device."""
        deep = None
        if self.has_deep:
            e, d = self.els_deep, self.deep_sub
            spine = {n: getattr(d if n in DeepElements._fields else e, n)
                     for n in DEEP_SPINE_FIELD_NAMES}
            tail = deep_f32_fields(e, d)
            slot = np.full(len(self), -1, np.int32)
            slot[self.deep_idx] = np.arange(self.n_deep, dtype=np.int32)
            slot, near_cols, deep_cols = (
                torch.as_tensor(x.astype(np.int32), device=self.device)
                for x in (slot, np.nonzero(~self.is_deep)[0],
                          self.deep_idx))
            deep = DeepStaging(
                t_sat=self._t_sat(self.deep_epochs_jd),
                spine=torch.stack([spine[n] for n in DEEP_SPINE_FIELD_NAMES]),
                tail=torch.stack([tail[n] for n in DEEP_FIELD_NAMES]),
                flags=torch.stack([d.irez.to(torch.int32),
                                   e.error.to(torch.int32)]),
                slot=slot, maps=MergeMaps(slot, near_cols, deep_cols))
        spine, tail, flags = shallow_staging(self.els)
        return FastStaging(t_sat=self._t_sat(self.epochs_jd), spine=spine,
                           tail=tail, flags=flags, deep=deep)

    def resonance_tables(self, steps: int) -> torch.Tensor:
        """The deep subset's resonance tables at depth ``steps``
        (``ops.cuda_sgp4.resonance_tables``: one launch of TABLES on the
        card), integrated once per catalog and depth and kept."""
        if steps not in self._tables:
            self._tables[steps] = resonance_tables(self.deep_sub,
                                                   self.els_deep, steps)
        return self._tables[steps]

    @cached_property
    def deep_kepler_iters(self) -> int:
        """Newton trips of kernel K2: 6 reach the f32 floor of 8 up to
        e = 0.8, which real deep catalogs stay under."""
        if not self.has_deep:
            return 8
        return 6 if float(self.host.ecco[self.deep_idx].max()) < 0.8 else 8

    @cached_property
    def heo_escape(self) -> Optional[HeoEscape]:
        """The deep subset's half-day resonant lanes (irez == 2) with
        eccentricity above :data:`HEO_ESCAPE_ECC`, which the fast path
        recomputes in f64 (:func:`_apply_escape`); None when there are
        none or more than ``_HEO_ESCAPE_CAP``."""
        if not self.has_deep:
            return None
        ecc = self.host.ecco[self.deep_idx]
        irez = np.asarray(self.deep_host.irez)[self.deep_idx]
        idx = np.nonzero((irez == 2) & (ecc > HEO_ESCAPE_ECC))[0]
        if idx.size == 0 or idx.size > _HEO_ESCAPE_CAP:
            return None
        idx_dev = torch.as_tensor(idx.astype(np.int32), device=self.device)
        return HeoEscape(
            t_sat=self._t_sat(self.deep_epochs_jd[idx]), idx=idx_dev,
            staged=f64_staging(
                Sgp4Elements(*(x[idx_dev] for x in self.els_deep)),
                DeepElements(*(x[idx_dev] for x in self.deep_sub))))

    def escape_tables(self, steps: int) -> torch.Tensor:
        """The resonance tables of the escape lanes: their columns of
        :meth:`resonance_tables` (each lane's integration is its own)."""
        return self.resonance_tables(steps)[:, :, self.heo_escape.idx]

    @cached_property
    def f64_staging(self) -> F64Staging:
        """Every lane's elements, and the SDP4 coefficients where the
        catalog has them, as the f64 kernel reads them, with its slot
        order (``ops.cuda_sgp4.f64_staging``), built once per catalog on
        its device."""
        return f64_staging(self.els, self.deep)

    @cached_property
    def kepler_iters(self) -> int:
        """Static Newton trip count for the shallow kernel, laddered on
        the near-earth lanes' eccentricity bound ``ecco + |bstar| *
        (|cc4| * 1440 + 2 |cc5|)`` (epoch eccentricity plus its drag
        growth over +-1 day): 3 trips below 0.05, 4 below 0.2, 5 below
        0.35, else 8 (the JAX package's ladder, rung-gated in its
        tests/test_fast.py)."""
        if not len(self):
            return 5
        h = self.host
        cc5 = np.where(h.isimp, 0.0, h.cc5)
        ecc = h.ecco + np.abs(h.bstar) * (np.abs(h.cc4) * 1440.0
                                          + 2.0 * np.abs(cc5))
        if self.has_deep:
            ecc = ecc[~self.is_deep]
        max_ecc = min(float(ecc.max()), 0.999) if ecc.size else 0.0
        if max_ecc < 0.05:
            return 3
        if max_ecc < 0.2:
            return 4
        if max_ecc < 0.35:
            return 5
        return 8


def _two_line_text(text: str) -> bool:
    """Text that is neither OMM JSON nor carries a name line: it has
    nothing that the native bulk parser drops."""
    return not text.lstrip().startswith(("[", "{")) and not any(
        ln and not ln.lstrip().startswith(("1 ", "2 "))
        for ln in text.splitlines())


def build_catalog(source: Union[str, Sequence[Tle], TleArrays],
                  grav: GravityModel = WGS72, *,
                  device="cuda") -> SatCatalog:
    """Parse and initialize a catalog on ``device``.

    ``source`` is TLE/3LE text, OMM JSON text, a sequence of
    :class:`~astroz_tpu_torch.tle.Tle` or a :class:`TleArrays`. Two-line
    text goes through the native bulk parser (``TleArrays.from_text``);
    named 3LE text, OMM and records go through the Python parser, and
    their names are kept.
    """
    names: Optional[Tuple[Optional[str], ...]] = None
    if isinstance(source, TleArrays):
        arrays = source
    elif isinstance(source, str) and _two_line_text(source):
        arrays = TleArrays.from_text(source)
        if len(arrays) == 0:
            raise ValueError("no TLEs found in source")
    else:
        if not isinstance(source, str):
            tles = list(source)
        elif source.lstrip().startswith(("[", "{")):
            tles = parse_omm(source)
        else:
            tles = list(iter_tles(source))
        if not tles:
            raise ValueError("no TLEs found in source")
        names = tuple(t.name for t in tles)
        arrays = TleArrays.from_tles(tles)
    return catalog_from_elements(elements_from_arrays(arrays, grav), grav,
                                 np.asarray(arrays.satnum), names=names,
                                 device=device)


def elements_from_arrays(arrays: TleArrays,
                         grav: GravityModel = WGS72) -> Sgp4Elements:
    """SGP4 init on the host of parsed TLE columns: f64 numpy elements."""
    return sgp4_init_np(
        grav, no_kozai=arrays.no_kozai, ecco=arrays.ecco,
        inclo=arrays.inclo, nodeo=arrays.nodeo, argpo=arrays.argpo,
        mo=arrays.mo, bstar=arrays.bstar, epoch_jd=arrays.epoch_jd)


def catalog_from_elements(els: Sgp4Elements, grav: GravityModel,
                          satnum: Optional[np.ndarray] = None,
                          names: Optional[Tuple[Optional[str], ...]] = None,
                          *, device="cuda") -> SatCatalog:
    """Finish a catalog from initialized SGP4 elements (numpy arrays or
    tensors on any device): SDP4 init on the host where any lane is
    deep, then the elements move to ``device`` once."""
    els = Sgp4Elements(*(_to_numpy(x) for x in els))
    if satnum is None:
        satnum = np.arange(els.no_kozai.shape[0], dtype=np.int64)
    deep = sdp4_init_np(grav, els) if els.is_deep.any() else None
    return SatCatalog(els, grav, satnum, names, deep=deep, device=device)


def resonance_steps(jd_sum: np.ndarray, deep_epochs_jd: np.ndarray) -> int:
    """Depth of the resonance tables for a sweep: the 720-minute steps to
    the farthest point from a deep epoch, plus one, rounded up to a
    power of two (at least 2)."""
    tmax = float(max(abs(jd_sum.max() - deep_epochs_jd.min()),
                     abs(jd_sum.min() - deep_epochs_jd.max()))
                 * MINUTES_PER_DAY)
    return max(2, int(2 ** np.ceil(np.log2(max(tmax / 720.0, 1.0) + 1.0))))


def _apply_escape(esc: HeoEscape, tables, t_time, grav,
                  want_vel: bool, d_r3, d_v3, d_err):
    """Overwrite the escape lanes' columns of K2's planes, in place, with
    their full-f64 recompute (``ops.fast.sdp4_propagate_tables``) cast
    to f32: one launch of the f64 kernel (``ops.cuda_sgp4.
    sgp4_f64_escape``), which reads the lanes' columns of the deep
    subset's resonance ``tables``."""
    sgp4_f64_escape(t_time, esc.t_sat, *esc.staged, esc.idx, tables, d_r3,
                    d_v3 if want_vel else None, d_err, grav=grav,
                    want_vel=want_vel)


def propagate(cat: SatCatalog, jd, fr=None, *, output: str = "teme",
              velocities: bool = True, layout: str = "time_major",
              scan_times: bool = False, method: str = "f64",
              satellite_mask=None):
    """Propagate every satellite to every epoch.

    Args:
      cat: a catalog from :func:`build_catalog`.
      jd, fr: Julian date split (python-sgp4 convention); ``fr``
        defaults to zeros. Scalars or 1-D arrays of equal length.
      output: ``"teme"`` (km, km/s), ``"ecef"`` (GMST-rotated),
        ``"geodetic"`` (lat rad, lon rad, alt km; velocities stay ECEF)
        or ``"geodetic_deg"``.
      velocities: with False, v is None and the kernel never computes
        the velocity terms.
      layout: ``"time_major"`` (T, S, 3), ``"sat_major"`` (S, T, 3) or
        ``"planes"`` (3, T, S).
      scan_times: with ``method="f64"``, thread the SDP4 resonance carry
        along the time axis, which must be sorted in one direction (the
        JAX package's option for long monotone grids with many deep
        lanes). On the card it takes the same launch as without it, whose
        row walk carries the resonance already, and gives the same bits;
        on the CPU it runs the plain scan (``sdp4_propagate_scan``). The
        fast method ignores it, as the JAX package's does.
      method: ``"f64"`` (full double precision, f64 outputs) or
        ``"fast"`` (f64 angle spine + f32 tail in the kernels, f32
        outputs).
      satellite_mask: optional (S,) bool; masked satellites come back
        zero-filled with error code -1.

    Returns ``(r, v, error)`` as tensors on the catalog's device; error
    is int32 with python-sgp4 codes, 0 = ok. With ``method="f64"`` the
    f64 kernel forms each point's minutes since its epoch from jd and fr
    itself (``ops.cuda_sgp4.sgp4_f64_dense_epochs``), with or without
    ``scan_times``, so the card holds no (T, S) grid of them. The frame,
    the layout and the mask are one launch of the epilogue kernel
    (``ops.cuda_finalize.finalize``), none for TEME in the sweep's own
    layout (planes fast, time-major f64) without a mask.

    The call returns with its work queued on the card and no host wait,
    as torch's own ops do: its epochs (and the mask) reach the card
    through one page-locked staging (:func:`_stage_epochs`), and the
    caller's arrays are read before it returns, so the caller may
    overwrite them at once.

    Under a ``torch.profiler`` the call is one ``astroz.propagate`` span,
    with one ``astroz.stage.epochs`` span around the staging of its
    epochs and mask, and ``astroz.alloc`` spans around the output
    allocations (``profiling``).
    """
    with span("astroz.propagate"):
        if output not in OUTPUT_MODES:
            raise ValueError(f"output must be one of {OUTPUT_MODES}")
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}")
        if method not in ("fast", "f64"):
            raise ValueError("method must be 'fast' or 'f64'")
        jd_h = np.atleast_1d(np.asarray(jd, np.float64))
        fr_h = (np.zeros_like(jd_h) if fr is None
                else np.atleast_1d(np.asarray(fr, np.float64)))
        jd_h, fr_h = np.broadcast_arrays(jd_h, fr_h)
        if method == "f64":
            return _propagate_f64(cat, jd_h, fr_h, output, velocities,
                                  layout, scan_times, satellite_mask)
        return _propagate_fast(cat, jd_h, fr_h, output, velocities, layout,
                               satellite_mask)


def _stage_epochs(device: torch.device, rows, mask=None):
    """One call's host epochs on ``device``: ``rows`` (arrays of one
    shape) as f64 tensors, and ``mask`` as a bool tensor (None stays
    None). One ``astroz.stage.epochs`` span under a profiler.

    On a CUDA device the rows are written into one page-locked buffer
    from torch's caching host allocator and cross in one non-blocking
    copy (the mask in a second), so the host does not wait for the
    card's queued work; the rows come back as views of the copy. The
    allocator records each copy on its stream and hands the buffer out
    again only once that copy has finished. On the CPU the rows become
    tensors as they are."""
    with span("astroz.stage.epochs"):
        if device.type != "cuda":
            return ([torch.as_tensor(x, dtype=torch.float64, device=device)
                     for x in rows],
                    None if mask is None else torch.as_tensor(
                        mask, dtype=torch.bool, device=device))
        staged = torch.empty((len(rows),) + np.shape(rows[0]),
                             dtype=torch.float64, pin_memory=True)
        host = staged.numpy()
        for i, x in enumerate(rows):
            host[i] = x
        card = staged.to(device, non_blocking=True)
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.bool)
            if mask.device.type == "cpu":
                mask = torch.empty(mask.shape, dtype=torch.bool,
                                   pin_memory=True).copy_(mask)
            mask = mask.to(device, non_blocking=True)
        return list(card), mask


def _propagate_f64(cat: SatCatalog, jd_h, fr_h, output: str,
                   velocities: bool, layout: str, scan_times: bool,
                   satellite_mask=None):
    """The f64 branch of :func:`propagate`: the f64 kernel's time-major
    outputs through the epilogue. One staging of jd, fr and, where the
    epilogue is not the identity (``cuda_finalize.is_identity``), of
    jd_sum, which only the epilogue reads. DENSE forms each point's
    minutes since its lane's epoch from the jd and fr rows
    (``ops.cuda_sgp4.sgp4_f64_dense_epochs``); with ``scan_times`` on a
    catalog with deep lanes ``ops.cuda_sgp4.sgp4_f64_scan`` takes the same
    rows (on the card the same launch in SDP4 mode)."""
    identity = is_identity("time_major", output, layout, satellite_mask)
    (jd, fr, *jd_sum), mask = _stage_epochs(
        cat.device, [jd_h, fr_h] if identity else [jd_h, fr_h, jd_h + fr_h],
        satellite_mask)
    kw = dict(grav=cat.grav, want_vel=velocities)
    if cat.deep is not None and scan_times:
        # one time row after the other, each resuming the resonance
        # integration from the row before (the rows sorted one way)
        r, v, err = sgp4_f64_scan(jd, fr, *cat.f64_staging, **kw)
    else:
        # SDP4 on every lane of a catalog that has the coefficients
        r, v, err = sgp4_f64_dense_epochs(jd, fr, *cat.f64_staging,
                                          sdp4=cat.deep is not None, **kw)
    if identity:
        return r, v, err
    return finalize(r, v, err, jd_sum[0][:, None], source="time_major",
                    output=output, layout=layout, velocities=velocities,
                    mask=mask)


def _propagate_fast(cat: SatCatalog, jd_h, fr_h, output: str,
                    velocities: bool, layout: str, satellite_mask=None):
    """The fast branch of :func:`propagate`: the kernels over the
    separable grid, their planes through the epilogue. One staging of
    the time factor and jd_sum."""
    jd_sum_h = jd_h + fr_h
    (t_time, jd_sum), mask = _stage_epochs(
        cat.device, [_t_time(cat.epoch_min_jd, jd_h, fr_h), jd_sum_h],
        satellite_mask)
    steps = (resonance_steps(jd_sum_h, cat.deep_epochs_jd)
             if cat.has_deep else 0)
    return finalize(*_fast_planes(cat, t_time, steps, velocities),
                    jd_sum[:, None], source="planes", output=output,
                    layout=layout, velocities=velocities, mask=mask)


def _t_time(epoch_min_jd: float, jd_h, fr_h) -> np.ndarray:
    """The fast path's time factor on the host: minutes of the epochs
    ``jd_h + fr_h`` from a catalog's earliest epoch, f64."""
    return ((jd_h - epoch_min_jd) + fr_h) * MINUTES_PER_DAY


def _fast_planes(cat: SatCatalog, t_time, steps: int, velocities: bool):
    """The kernels of the fast path over ``t_time`` (minutes from the
    catalog's ``epoch_min_jd``), resonance tables at depth ``steps``:
    (3, T, S) planes r, v (None without velocities) and (T, S) codes."""
    st = cat.fast_staging
    if st.deep is None:
        r3, v3, err = propagate_fast_sep(
            t_time, st.t_sat, st.spine, st.tail, st.flags, grav=cat.grav,
            kepler_iters=cat.kepler_iters, want_vel=velocities)
    else:
        ds = st.deep
        d_r3, d_v3, d_err = propagate_deep_sep(
            t_time, ds.t_sat, ds.spine, ds.tail, ds.flags,
            cat.resonance_tables(steps), grav=cat.grav,
            kepler_iters=cat.deep_kepler_iters, want_vel=velocities)
        if cat.heo_escape is not None:
            _apply_escape(cat.heo_escape, cat.resonance_tables(steps),
                          t_time, cat.grav, velocities, d_r3, d_v3, d_err)
        r3, v3, err = propagate_fast_sep_merge(
            t_time, st.t_sat, st.spine, st.tail, st.flags, ds.slot, d_r3,
            d_v3, d_err, grav=cat.grav, kepler_iters=cat.kepler_iters,
            want_vel=velocities, maps=ds.maps)
    return r3, v3, err


def propagate_tsince(cat: SatCatalog, tsince_min, *,
                     velocities: bool = True):
    """Propagate to offsets in minutes since each satellite's own epoch,
    in f64.

    ``tsince_min`` broadcasts against the catalog: (n_times, 1) or
    (n_times, n_sats) gives a dense grid, a scalar or (n_sats,) a single
    shot. Always TEME. Returns ``(r, v, error)`` on the catalog's
    device, r and v stacked ``(..., 3)`` f64 (v None with
    ``velocities=False``). One launch of the f64 kernel
    (``ops.cuda_sgp4.sgp4_f64_dense``). As :func:`propagate`, the call
    returns with its work queued and no host wait: host offsets cross in
    one page-locked staging (:func:`_stage_epochs`), offsets already on
    a card are moved as they are. Under a profiler, one
    ``astroz.propagate`` span holding the ``astroz.stage.epochs`` of
    host offsets."""
    with span("astroz.propagate"):
        if isinstance(tsince_min, torch.Tensor) and tsince_min.is_cuda:
            t = tsince_min.to(cat.device, torch.float64)
        else:
            (t,), _ = _stage_epochs(cat.device, [tsince_min])
        return sgp4_f64_dense(t, *cat.f64_staging, grav=cat.grav,
                              sdp4=cat.has_deep, want_vel=velocities)
