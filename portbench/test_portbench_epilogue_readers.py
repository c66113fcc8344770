"""The f64 kernel's roofline on its SGP4 mode and the epilogue's host
time on a hand-made trace: each reads its hand-computed value, and
nothing where the trace holds no launch of the f64 kernel or no
``astroz.finalize`` span.

The trace, in microseconds: a span 0-1000 of two sweeps of 1,000 lanes x
100 epochs (f64, ECEF, sat_major, with velocities). Each sweep runs DENSE
in SGP4 mode for 40 us and the epilogue kernel for 10 us; on the host
each ``astroz.propagate`` holds one ``astroz.finalize`` of 30 us, which
holds an ``astroz.alloc`` of 5 us and, in the second sweep, an
``astroz.wait.count`` of 8 us."""

from types import SimpleNamespace

import pytest

from portbench import harness, roofline
from portbench.trace import REQUEST, SPAN, Trace

LANES, EPOCHS = 1000, 100
SGP4_MODE = ("void (anonymous namespace)::sgp4_f64_walk_kernel<0, true>("
             "(anonymous namespace)::GridArgs)")
SDP4_MODE = SGP4_MODE.replace("<0, true>", "<1, true>")
EPILOGUE = ("void (anonymous namespace)::tile_kernel<double>("
            "(anonymous namespace)::Args<double>, long long)")
TRAFFIC = dict(kind="propagate", method="f64", output="ecef",
               layout="sat_major", velocities=True)


def _trace(dense=SGP4_MODE, finalize=True, wait=True):
    tr = Trace(requests=2, spans={SPAN: [(0.0, 1000.0)],
                                  REQUEST: [(0.0, 400.0), (500.0, 900.0)]})
    for k, base in enumerate((0.0, 500.0)):
        tr.device += [(dense, base + 100.0, base + 140.0),
                      (EPILOGUE, base + 140.0, base + 150.0)]
        tr.host.append(("astroz.propagate", base + 10.0, base + 90.0))
        if finalize:
            tr.host += [("astroz.finalize", base + 50.0, base + 80.0),
                        ("astroz.alloc", base + 52.0, base + 57.0)]
            if wait and k == 1:
                tr.host.append(("astroz.wait.count", base + 60.0,
                                base + 68.0))
    return tr


def _run(tr, **traffic):
    return SimpleNamespace(trace=tr, props=LANES * EPOCHS,
                           cell=SimpleNamespace(traffic=dict(TRAFFIC,
                                                             **traffic)))


def test_sgp4_f64_roofline_reads_the_sgp4_mode_launches():
    """Two sweeps of 100,000 points, 52 bytes each (r, v f64 and an i32
    code): bytes bound them (``roofline.F64_POINT_OPS`` f64 operations at
    34 TFLOP/s are under 8 ps a point, 52 bytes at 3.35 TB/s 15.5 ps),
    over 80 us of DENSE in SGP4 mode; SDP4 mode's launches read the
    same."""
    read = harness.reader("sgp4_f64_roofline")
    points = 2 * LANES * EPOCHS
    want = 100.0 * 52 * points / roofline.PEAK_BYTES_S / 80e-6
    assert roofline.f64_sweep_s(points, True) \
        == pytest.approx(52 * points / roofline.PEAK_BYTES_S)
    assert read(_run(_trace())) == pytest.approx(want)
    assert read(_run(_trace(dense=SDP4_MODE))) == pytest.approx(want)


@pytest.mark.parametrize("case", ["no_launch", "fast", "no_trace"])
def test_sgp4_f64_roofline_reads_nothing_without_its_launches(case):
    """A trace without the f64 kernel, a fast sweep and an untraced run
    give nothing."""
    read = harness.reader("sgp4_f64_roofline")
    run = {"no_launch": _run(_trace(dense=EPILOGUE)),
           "fast": _run(_trace(), method="fast"),
           "no_trace": _run(None)}[case]
    assert read(run) is None


def test_epilogue_host_ms_is_its_spans_less_their_waits():
    """(30 + 30 - 8) us over two sweeps: 0.026 ms; the allocation inside
    the span is host time and counts, the wait does not."""
    read = harness.reader("epilogue_host_ms")
    assert read(_run(_trace())) == pytest.approx(0.026)
    assert read(_run(_trace(wait=False))) == pytest.approx(0.030)


@pytest.mark.parametrize("case", ["no_span", "screen", "no_trace"])
def test_epilogue_host_ms_reads_nothing_without_the_span(case):
    """A program without the span (or an epilogue that is the identity),
    a screen and an untraced run give nothing."""
    read = harness.reader("epilogue_host_ms")
    run = {"no_span": _run(_trace(finalize=False)),
           "screen": _run(_trace(), kind="screen_all"),
           "no_trace": _run(None)}[case]
    assert read(run) is None
