"""The check against faults: a run of each cell on the CPU at a small
size, the program's plain versions under the harness (the look for a
card skipped), with the timed path broken underneath, comes out not
correct; the same run unbroken comes out correct. And the control, put
in the program's place, fails the cell's limits where the program
passes them.

Besides the cells of ``BENCHMARK.json``, the all-vs-all screen's check
is held here on the cell that its files describe
(``traffic/screen-5km.json``, ``limits/active13k.screen-5km.json``),
which waits outside ``BENCHMARK.json`` for the fast path's fix."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import control, harness
from portbench.checks.propagate import codes_time_major, time_major

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
SWEEPS = [w["name"] for w in SPEC["workloads"]]
SCREEN = "active13k.screen-5km"


def cell(name):
    if name == SCREEN:
        return harness.make_cell(
            ROOT, SCREEN, "portbench/configs/active-catalog-13478.json",
            "screen-5km")
    return harness.load_cell(ROOT, name, False)


def small(name):
    """The cell at a size the CPU runs in seconds: 300 lanes (the
    Starlink shells cut to a few planes) at 24 epochs; the screen's
    threshold raised so that its catalog has pairs."""
    c = cell(name)
    if "n_sats" in c.config:
        c.config["n_sats"] = 300
    else:
        for sh in c.config["shells"]:
            sh["planes"] = max(1, sh["planes"] // 12)
            sh["per_plane"] = max(2, sh["per_plane"] // 4)
    c.traffic.update(epochs=24, trace_requests=2)
    if c.traffic["kind"] == "screen_all":
        c.traffic["threshold_km"] = 400.0
    return c


def run(cell, seed=2**31 + 5):
    result, _ = harness.run_cell(cell, seed, 0.3, False,
                                 t_start=time.perf_counter(), device="cpu")
    return result


def broken_sweeps(monkeypatch, fault):
    """Wrap ``propagate`` so that ``fault(r, v, err)`` edits each sweep's
    (T, S, 3) / (T, S) views in place."""
    from astroz_tpu_torch import propagation

    real = propagation.propagate

    def propagate(*a, **kw):
        r, v, err = real(*a, **kw)
        layout = kw["layout"]
        fault(time_major(r, layout), time_major(v, layout),
              codes_time_major(err, layout))
        return r, v, err

    monkeypatch.setattr(propagation, "propagate", propagate)


def _answer_altered(r, v, err):
    ok = torch.nonzero(err == 0)[len(err) // 2]
    r[ok[0], ok[1], 0] += 2.0


def _code_altered(r, v, err):
    ok = torch.nonzero(err == 0)[0]
    err[ok[0], ok[1]] = 6


def _half_left_out(r, v, err):
    half = r.shape[1] // 2
    r[:, half:] = 0.0
    v[:, half:] = 0.0


@pytest.mark.parametrize("name", SWEEPS)
def test_sound_sweeps_are_correct(name):
    assert run(small(name))["correct"]


@pytest.mark.parametrize("fault", [_answer_altered, _code_altered,
                                   _half_left_out],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("name", SWEEPS)
def test_broken_sweeps_are_not_correct(monkeypatch, name, fault):
    broken_sweeps(monkeypatch, fault)
    assert run(small(name))["correct"] is False


def broken_screen(monkeypatch, fault):
    from astroz_tpu_torch import screening

    real = screening.screen_all

    def screen_all(*a, **kw):
        return fault(*(np.array(x) for x in real(*a, **kw)))

    monkeypatch.setattr(screening, "screen_all", screen_all)


def _pair_dropped(i, j, d, t):
    keep = np.arange(len(i)) != len(i) // 2
    return i[keep], j[keep], d[keep], t[keep]


def _distance_altered(i, j, d, t):
    d[len(d) // 2] += 0.5
    return i, j, d, t


def _epoch_moved(i, j, d, t):
    t[len(t) // 2] = (t[len(t) // 2] + 12) % 24
    return i, j, d, t


def _pair_added(i, j, d, t):
    return (np.append(i, 0), np.append(j, 1), np.append(d, 1.0),
            np.append(t, 0))


def test_sound_screen_is_correct():
    result = run(small(SCREEN))
    assert result["correct"]


@pytest.mark.parametrize("fault", [_pair_dropped, _distance_altered,
                                   _epoch_moved, _pair_added],
                         ids=lambda f: f.__name__.strip("_"))
def test_broken_screens_are_not_correct(monkeypatch, fault):
    broken_screen(monkeypatch, fault)
    assert run(small(SCREEN))["correct"] is False


@pytest.mark.parametrize("name", SWEEPS + [SCREEN])
def test_control_fails_where_the_program_passes(name):
    cell = small(name)
    rd = control.readings(cell, 2**31 + 9, [0, 6], device="cpu")
    lim = cell.limits
    assert all(rd["program"][k] <= lim[k] for k in lim if k in rd["program"])
    assert any(rd["control"][k] > lim[k] for k in lim if k in rd["control"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", SWEEPS)
def test_control_fails_at_the_cells_size(card, name):
    """The same on the card at the cell's own size, on three seeds."""
    c = cell(name)
    for seed in (2**31 + 21, 22, 23):
        rd = control.readings(c, seed, [0, 6], device=card)
        lim = c.limits
        assert all(rd["program"][k] <= lim[k] for k in lim
                   if k in rd["program"])
        assert any(rd["control"][k] > lim[k] for k in lim
                   if k in rd["control"])
