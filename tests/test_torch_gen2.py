"""The Starlink Gen2 deployment (``portbench/configs/
starlink-gen2-29988.json``: SpaceX's Gen2 filing, 29,988 near-earth
satellites in nine shells) through the port's normal path,
``build_catalog`` on its TLE text and ``propagate(method="f64",
output="ecef", layout="sat_major")``, against the benchmark's plain
reference (``portbench/reference``: the published SGP4 in f64 torch and
the GMST rotation, which import nothing of the port). On the CPU at a
small size (each shell cut to 2 planes x 2 satellites, 36 lanes, x 720
one-minute epochs), on the card at 3,000 of the fleet's lanes x 4,320
(marked ``cuda``). The port's float32 path (``method="fast"``) fails the
same tolerances, so that an f32 answer cannot pass as f64.

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest tests/test_torch_gen2.py -q
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from astroz_tpu_torch import build_catalog, propagate
from portbench.catalogs import walker_shells
from portbench.checks.propagate import readings
from portbench.reference import catalog as ref
from portbench.reference.tle import parse_catalog

torch.set_num_threads(1)

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "portbench"
                     / "configs" / "starlink-gen2-29988.json").read_text())
#: satellites of each shell as the filing lists them
SHELL_SIZES = (5280, 5280, 5280, 3600, 3360, 3360, 3360, 144, 324)
BIG_SEED = 2**31 + 77
#: the position gap (km) and velocity gap (m/s) allowed between the port
#: and the f64 reference where both report code 0. Both compute the
#: published f64 SGP4 and rotate by GMST in f64. On the CPU they agree bit
#: for bit; on the card the GMST row's f64 rounding differs (its argument
#: is ~5.5e4 rad before the reduction, 7.3e-12 rad an ulp), which reads
#: 1.53e-7 km and 1.68e-7 m/s on the fleet's 7,000 km orbits in every run
#: of the benchmark's Gen2 cell, and TEME gaps read ~4e-11. 1e-6 is above
#: that with room, and the f32 tail of ``method="fast"`` misses it by
#: ~7e-3 km and ~8e-3 m/s on these orbits, thousands of times more
R_TOL_KM = 1e-6
V_TOL_MPS = 1e-6
#: python-sgp4 codes must match exactly: a decay or an eccentricity out of
#: range is a different answer, not a rounding
CODES_TOL = 0


def _small_config():
    return dict(CONFIG, shells=[dict(sh, planes=2, per_plane=2)
                                for sh in CONFIG["shells"]])


def _epochs(day: int, n_times: int):
    """A request's rows as the benchmark sends them: the day in jd, the
    minutes in fr, 60 s apart."""
    jd = np.full(n_times, CONFIG["epoch_jd"] + day)
    fr = np.arange(n_times, dtype=np.float64) * 60.0 / 86400.0
    return jd, fr


def _gaps(text, jd, fr, device, *, method="f64", velocities=True):
    """The worst position gap (km), velocity gap (m/s) and the count of
    codes that differ between ``propagate`` to ECEF sat_major and the
    reference rotated to ECEF, where both report code 0."""
    cat = build_catalog(text, device=device)
    r, v, err = propagate(cat, jd, fr, method=method, output="ecef",
                          layout="sat_major", velocities=velocities)
    n_t = len(jd)
    assert r.shape == (len(cat), n_t, 3) and err.shape == (len(cat), n_t)
    assert (v is None) == (not velocities)
    if velocities:
        assert v.shape == r.shape
    got = readings(r.transpose(0, 1), None if v is None else v.transpose(0, 1),
                   err.T, ref.build(text), {"output": "ecef"}, jd, fr, device)
    return got["near_km"], got.get("vel_mps"), got["codes"]


@pytest.mark.parametrize("seed", [1, BIG_SEED])
def test_gen2_config_gives_the_filed_shells(seed):
    """29,988 lanes, each shell's count at its altitude's mean motion and
    its inclination (two shells share 53 deg), no deep lane."""
    text = walker_shells.text(CONFIG, seed)
    cols = parse_catalog(text)
    inc = np.round(np.degrees(cols["inclo"]), 4)
    rev = cols["no_kozai"] * 1440.0 / (2.0 * math.pi)
    assert len(inc) == sum(SHELL_SIZES) == 29988
    counts = []
    for sh in CONFIG["shells"]:
        want = walker_shells.rev_per_day(sh["altitude_km"],
                                         CONFIG["mu_km3_s2"], CONFIG["re_km"])
        counts.append(int(((inc == sh["inclination_deg"])
                           & (np.abs(rev - want) < 1e-6)).sum()))
    assert tuple(counts) == SHELL_SIZES
    assert ((cols["ecco"] >= 1e-4) & (cols["ecco"] <= 2.5e-4)).all()
    summary = ref.build(text).summary()
    assert summary["deep"] == 0 and summary["near"] == 29988


@pytest.mark.parametrize("day", [0, 6])
@pytest.mark.parametrize("velocities", [True, False])
def test_f64_ecef_sat_major_matches_reference(day, velocities):
    """36 lanes (every shell) x 12 hours at 60 s, on the first and the
    last day a request of the cell starts on."""
    text = walker_shells.text(_small_config(), BIG_SEED + day)
    dr, dv, codes = _gaps(text, *_epochs(day, 720), "cpu",
                          velocities=velocities)
    assert dr <= R_TOL_KM
    assert dv is None if not velocities else dv <= V_TOL_MPS
    assert codes <= CODES_TOL


def test_fast_path_fails_the_tolerances():
    """The port's float32 path in the f64 path's place: its position and
    velocity gaps each pass their tolerance by far."""
    text = walker_shells.text(_small_config(), BIG_SEED)
    dr, dv, _ = _gaps(text, *_epochs(3, 720), "cpu", method="fast")
    assert dr > 100 * R_TOL_KM and dv > 100 * V_TOL_MPS


def _fleet_sample(seed: int, n: int = 3000) -> str:
    """``n`` lanes of the whole fleet's TLE text, evenly spread over its
    shells."""
    pairs = walker_shells.text(CONFIG, seed).splitlines()
    keep = np.round(np.linspace(0, len(pairs) // 2 - 1, n)).astype(int)
    return "\n".join(f"{pairs[2 * k]}\n{pairs[2 * k + 1]}" for k in keep)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("velocities", [True, False])
def test_f64_ecef_sat_major_matches_reference_on_cuda(cuda_device,
                                                      velocities):
    """3,000 of the fleet's lanes x 72 hours at 60 s on the card (the f64
    kernel's SGP4 mode and the epilogue's f64 sat_major walk to ECEF)
    within the tolerances; the float32 path on the card misses them."""
    text = _fleet_sample(BIG_SEED)
    jd, fr = _epochs(6, 4320)
    dr, dv, codes = _gaps(text, jd, fr, cuda_device, velocities=velocities)
    assert dr <= R_TOL_KM and codes <= CODES_TOL
    assert dv is None if not velocities else dv <= V_TOL_MPS
    dr, dv, _ = _gaps(text, jd, fr, cuda_device, method="fast",
                      velocities=velocities)
    assert dr > R_TOL_KM
    assert dv is None if not velocities else dv > V_TOL_MPS
