"""The port's spans (``profiling.span``) on the sweep and screen paths:
under a ``torch.profiler`` each ``propagate`` is one ``astroz.propagate``
span holding one ``astroz.stage.epochs`` span (its epochs and mask
staged for the card, fast or f64, masked or not) and no
``astroz.wait.epochs``, ``propagate_tsince`` and ``screen_all`` give
their roots and the screen its ``astroz.wait.pairs`` copies, the output allocations give ``astroz.alloc``; a span is a host
operation, never a user annotation that the profiler would copy onto the
card's timeline; with no profiler recording, a span is one shared no-op
and no record function is built or entered. The card's own spans (the
kernels' and the epilogue's allocations, K4's count fetch and relaunch,
and that no span reaches the card's timeline) are marked ``cuda``.

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest tests/test_torch_spans.py -q
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from astroz_tpu_torch import (build_catalog, profiling, propagate,
                              propagate_tsince, screen_all)
from astroz_tpu_torch.ops import cuda_screen, cuda_sgp4
from astroz_tpu_torch.screening import _positions_planes_f32

from test_torch_cuda import synthetic_leo_text

torch.set_num_threads(1)

#: epochs of a sweep: the catalog's mid epoch and 8 more over a day
JD = np.full(9, 2460310.5)
FR = np.linspace(0.0, 1.0, 9)
#: the one span a propagate holds around its epochs (and mask), fast or
#: f64; ``astroz.wait.epochs``, a copy that blocks, it holds none of
STAGE, WAIT = "astroz.stage.epochs", "astroz.wait.epochs"


@pytest.fixture(scope="module")
def cat():
    return build_catalog(synthetic_leo_text(24), device="cpu")


def _spans(prof, device=torch.autograd.DeviceType.CPU):
    """The ``astroz.*`` spans of a profile on ``device``: (name, start,
    end), in the order they started."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("astroz.")
                   and e.device_type == device),
                  key=lambda x: x[1])


def _traced(fn, cuda=False):
    """``fn``'s result and its host spans; traced with the card too, no
    span may reach the card's timeline."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with profile(activities=acts) as prof:
        out = fn()
        if cuda:
            torch.cuda.synchronize()
    if cuda:
        assert not _spans(prof, torch.autograd.DeviceType.CUDA)
    return out, _spans(prof)


def _inside(spans, root):
    """Each span but the roots, with the root that holds it by time (None
    where no root does)."""
    roots = [(a, b) for name, a, b in spans if name == root]
    return [(name, next(((r0, r1) for r0, r1 in roots
                         if r0 <= a and b <= r1), None))
            for name, a, b in spans if name != root]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("method", ["fast", "f64"])
def test_propagate_spans(cat, method, masked):
    """Two calls, two ``astroz.propagate`` spans; each holds one
    staging of its epochs (and mask) and no wait, and nothing lies
    outside a root."""
    mask = np.arange(len(cat)) % 3 != 0 if masked else None

    def sweep():
        return [propagate(cat, JD, FR, method=method, output="ecef",
                          satellite_mask=mask) for _ in range(2)]

    _, spans = _traced(sweep)
    roots = [s for s in spans if s[0] == "astroz.propagate"]
    assert len(roots) == 2
    held = _inside(spans, "astroz.propagate")
    assert all(root is not None for _, root in held)
    for r0, r1 in [(a, b) for _, a, b in roots]:
        names = [n for n, root in held if root == (r0, r1)]
        assert names.count(STAGE) == 1 and WAIT not in names
    assert {n for n, _ in held} == {STAGE}


def test_propagate_tsince_spans(cat):
    """``propagate_tsince``: one root holding its one staging and no
    wait."""
    _, spans = _traced(lambda: propagate_tsince(
        cat, np.linspace(0.0, 1440.0, 5)[:, None]))
    assert [s[0] for s in spans] == ["astroz.propagate", STAGE]
    assert _inside(spans, "astroz.propagate")[0][1] is not None


def test_screen_all_spans(cat):
    """``screen_all``: one ``astroz.screen_all`` root holding the sweep's
    ``astroz.propagate`` and the two copies of the refined pairs to the
    host."""
    (i, _, _, _), spans = _traced(lambda: screen_all(
        cat, JD, FR, threshold_km=20000.0))
    assert len(i) > 0
    names = [s[0] for s in spans]
    assert names.count("astroz.screen_all") == 1
    assert names.count("astroz.propagate") == 1
    assert names.count("astroz.wait.pairs") == 2
    assert all(root is not None
               for _, root in _inside(spans, "astroz.screen_all"))


@pytest.mark.parametrize("alloc", ["fast", "f64"])
def test_output_allocations_are_spans(alloc):
    """The kernels' output allocations (run on the card only; here called
    on the CPU) are one ``astroz.alloc`` span each: the fast kernels'
    (3, T, S) f32 planes, the f64 kernel's (T, S, 3) f64 rows."""
    dev = torch.device("cpu")
    (r, v, err), spans = _traced(
        (lambda: cuda_sgp4._outputs(dev, 4, 5, True)) if alloc == "fast"
        else (lambda: cuda_sgp4._outputs_rows(dev, (4, 5), True,
                                              torch.float64)))
    assert [s[0] for s in spans] == ["astroz.alloc"]
    assert r.shape == ((3, 4, 5) if alloc == "fast" else (4, 5, 3))
    assert v.shape == r.shape and err.shape == (4, 5)


def test_spans_are_host_operations(cat, tmp_path):
    """A span is an operator-kind record function (``cpu_op`` in the
    exported trace), not a user annotation, which a CUDA trace would copy
    onto the card's timeline as if it were device work."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        propagate(cat, JD, FR, method="fast")
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    kinds = {(e["name"], e.get("cat")) for e in events
             if str(e.get("name", "")).startswith("astroz.")}
    assert kinds == {("astroz.propagate", "cpu_op"), (STAGE, "cpu_op")}


def test_span_is_a_shared_no_op_when_nothing_records(cat, monkeypatch):
    """With no profiler recording, every span is one shared object, and a
    sweep (fast and f64, with a mask), ``propagate_tsince`` and a screen
    build and enter no record function."""
    assert profiling.span("astroz.propagate") is profiling.span("x")
    entered = []
    rf = torch.autograd.profiler.record_function
    enter = rf.__enter__
    fast = torch._C._profiler._RecordFunctionFast

    def counting(self):
        entered.append(self.name)
        return enter(self)

    def counting_fast(name, *args, **kwargs):
        entered.append(name)
        return fast(name, *args, **kwargs)

    monkeypatch.setattr(rf, "__enter__", counting)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        counting_fast)
    mask = np.arange(len(cat)) % 2 == 0
    for method in ("fast", "f64"):
        propagate(cat, JD, FR, method=method, satellite_mask=mask)
    propagate_tsince(cat, np.linspace(0.0, 60.0, 3)[:, None])
    screen_all(cat, JD, FR, threshold_km=20000.0)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("astroz.probe"):
            pass
    assert entered == ["astroz.probe"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("method, output, allocs", [
    ("fast", "ecef", 2), ("fast", "teme", 2), ("f64", "teme", 1),
    ("f64", "ecef", 2)])
def test_sweep_spans_on_cuda(cuda_device, method, output, allocs):
    """On the card, time-major: the kernel's outputs are one
    ``astroz.alloc`` and the epilogue's one more, where it is not the
    identity (fast TEME planes -> time-major is not; f64 TEME time-major
    is); one staging and no wait, as on the CPU; no span leaves its
    root."""
    cat = build_catalog(synthetic_leo_text(64), device=cuda_device)
    _, spans = _traced(lambda: propagate(
        cat, JD, FR, method=method, output=output, layout="time_major"),
        cuda=True)
    held = _inside(spans, "astroz.propagate")
    names = [n for n, _ in held]
    assert [s[0] for s in spans].count("astroz.propagate") == 1
    assert all(root is not None for _, root in held)
    assert names.count(STAGE) == 1 and WAIT not in names
    assert names.count("astroz.alloc") == allocs


@pytest.mark.cuda
def test_screen_spans_on_cuda(cuda_device):
    """On the card: the screen's count fetch is ``astroz.wait.count``;
    with room for one candidate, K4's relaunch is one
    ``astroz.retry.candidates`` holding its launch, and the pairs are
    those of the screen with room for all."""
    cat = build_catalog(synthetic_leo_text(64), device=cuda_device)
    _, spans = _traced(lambda: screen_all(cat, JD, FR,
                                          threshold_km=20000.0), cuda=True)
    names = [s[0] for s in spans]
    assert names.count("astroz.wait.count") == 1
    assert names.count("astroz.wait.pairs") == 2
    assert "astroz.retry.candidates" not in names
    planes = _positions_planes_f32(cat, JD, FR)
    full = cuda_screen.coarse_candidates(planes, 2.0e4 ** 2)
    (ii, jj), spans = _traced(lambda: cuda_screen.coarse_candidates(
        planes, 2.0e4 ** 2, cap=1), cuda=True)
    assert len(full[0]) > 1
    assert [s[0] for s in spans] == ["astroz.wait.count",
                                     "astroz.retry.candidates"]
    assert torch.equal(ii, full[0]) and torch.equal(jj, full[1])
