"""The program's own spans (``astroz.*``) in a traced span, on a hand-made
profile: the readers that time the sweep from outside read the same with
and without them, and each reader of the spans reads its hand-computed
value (and nothing from a program without spans).

The program's spans are host operations (operator-kind record
functions): unlike the benchmark's ``record_function`` spans, which the
profiler also reports as user annotations on the card's timeline, they
have no device-side copy.

The profile, in microseconds: a span 0-1000 of two requests, 0-400 and
500-900. Each sweep is one ``astroz.propagate`` span (10-110, 510-610)
holding two waits (20-60 and 70-80, 520-560 and 570-580), each a
pageable copy and a stream synchronize, and one allocation (85-95,
585-595). The card runs a sweep kernel, a copy and an epilogue kernel a
sweep; it is idle 66-105, 450-520, 565-575, 576-605 and 950-1000, of
which 39 + 10 + 10 + 29 = 88 us fall inside the propagate spans."""

from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.trace import REQUEST, SPAN, Trace

OUTSIDE = ("sweep_launches", "sweep_syncs", "device_idle_pct.sweep",
           "sgp4_fast_roofline", "sgp4_f64_roofline", "finalize_roofline")
INSIDE = {"sweep_waits": 2.0, "sweep_wait_ms": 0.05, "sweep_host_ms": 0.05,
          "sweep_alloc_ms": 0.01, "device_idle_program_pct.sweep": 8.8}
#: the sweep's kernels by method
KERNELS = {"fast": ("void sgp4_shallow_kernel<true, 3, 0, double>(Args)",
                    "void flat_kernel<float>(Args)"),
           "f64": ("void sgp4_f64_walk_kernel<1, true>(Args)",
                   "void at::native::elementwise_kernel<128, 2>(Args)")}
TRAFFIC = {"fast": dict(method="fast", output="ecef", layout="time_major"),
           "f64": dict(method="f64", output="teme", layout="time_major")}


def _event(name, t0, t1, device="CPU"):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(
        start=t0, end=t1), device_type=SimpleNamespace(name=device))


def _with_annotation(name, t0, t1, d0, d1):
    """A ``record_function`` span as the profiler reports it: on the host,
    and as a user annotation over the device work it launched."""
    return [_event(name, t0, t1), _event(name, d0, d1, "CUDA")]


def _profile(method: str, program_spans: bool):
    sweep, epilogue = KERNELS[method]
    ev = _with_annotation(SPAN, 0, 1000, 0, 1000)
    for k, base in enumerate((0, 500)):
        ev += _with_annotation(REQUEST, base, base + 400, base, base + 450)
        for a, b in ((20, 60), (70, 80)):
            ev += [_event("aten::to", base + a, base + b),
                   _event("cudaMemcpyAsync", base + a + 1, base + a + 2),
                   _event("cudaStreamSynchronize", base + a + 2, base + b - 1)]
        ev += [_event("aten::empty_strided", base + 86, base + 94),
               _event("cudaLaunchKernel", base + 100, base + 104)]
        if program_spans:
            ev += [_event("astroz.propagate", base + 10, base + 110),
                   _event("astroz.wait.epochs", base + 20, base + 60),
                   _event("astroz.wait.epochs", base + 70, base + 80),
                   _event("astroz.alloc", base + 85, base + 95)]
    # the card: the first sweep's kernel runs from 0, the second's from 520
    ev += [_event(sweep, 0, 65, "CUDA"),
           _event("Memcpy HtoD (Pageable -> Device)", 65, 66, "CUDA"),
           _event(epilogue, 105, 450, "CUDA"),
           _event(sweep, 520, 565, "CUDA"),
           _event("Memcpy HtoD (Pageable -> Device)", 575, 576, "CUDA"),
           _event(epilogue, 605, 950, "CUDA")]
    return SimpleNamespace(events=lambda: ev)


def _run(method: str, program_spans: bool):
    traffic = dict(kind="propagate", epochs=8640, velocities=True,
                   **TRAFFIC[method])
    tr = Trace.from_profile(_profile(method, program_spans), 2)
    return SimpleNamespace(trace=tr, cell=SimpleNamespace(traffic=traffic),
                           props=4408 * 8640,
                           summary={"near": 4408, "deep": 0})


@pytest.mark.parametrize("method", ["fast", "f64"])
@pytest.mark.parametrize("name", OUTSIDE)
def test_outside_readers_ignore_program_spans(name, method):
    """The same reading with the program's spans as without them."""
    read = harness.reader(name)
    assert read(_run(method, True)) == read(_run(method, False))


@pytest.mark.parametrize("method", ["fast", "f64"])
def test_outside_readers_read_the_profile(method):
    """The readers that apply read the hand-made profile's values: 3
    kernels a sweep counted as launches (copies are not kernels), 2
    syncs, the card idle 19.8% (busy 802 of 1000 us)."""
    run = _run(method, True)
    assert harness.reader("sweep_launches")(run) == 2.0
    assert harness.reader("sweep_syncs")(run) == 2.0
    assert harness.reader("device_idle_pct.sweep")(run) == \
        pytest.approx(19.8)
    assert harness.reader("sgp4_fast_roofline" if method == "fast"
                          else "sgp4_f64_roofline")(run) > 0.0


@pytest.mark.parametrize("name, value", sorted(INSIDE.items()))
def test_program_span_readers(name, value):
    """Each reader of the program's spans: its hand-computed value, and
    None from a program that has no spans (the parent of this change)."""
    read = harness.reader(name)
    assert read(_run("fast", True)) == pytest.approx(value)
    assert read(_run("fast", False)) is None


def test_program_spans_stay_on_the_host():
    """The program's spans are host operations, so no ``astroz.*`` name
    is among the device's operations, nor among the benchmark's spans."""
    tr = _run("fast", True).trace
    assert sum(name == "astroz.propagate" for name, _, _ in tr.host) == 2
    assert not [x for x in tr.device if x[0].startswith("astroz.")]
    assert not [k for k, _ in tr.breakdown()["device_ops"]
                if k.startswith("astroz.")]
    assert set(tr.spans) == {SPAN, REQUEST}
