"""Metric readers on a hand-made trace."""

from types import SimpleNamespace

from portbench import harness, loop
from portbench.trace import REQUEST, SPAN, Trace


def test_sweep_syncs_counts_only_the_programs_waits():
    """Two requests that each copy once and synchronize once; the harness's
    event waits between them and its drain at the span's end are not
    counted."""
    tr = Trace(requests=2, spans={SPAN: [(0.0, 100.0)],
                                  REQUEST: [(10.0, 20.0), (40.0, 50.0)]})
    tr.runtime = [
        ("cudaMemcpyAsync", 11.0, 12.0), ("cudaStreamSynchronize", 12.0, 13.0),
        ("cudaLaunchKernel", 14.0, 15.0), ("cudaEventSynchronize", 30.0, 35.0),
        ("cudaMemcpy", 41.0, 42.0), ("cudaStreamSynchronize", 43.0, 44.0),
        ("cudaDeviceSynchronize", 90.0, 99.0)]
    run = SimpleNamespace(trace=tr, cell=SimpleNamespace(
        traffic={"kind": "propagate"}))
    assert harness.reader("sweep_syncs")(run) == 1.5


def test_window_pace_counts_completions_by_slice():
    """Completions at 0.5 s, 1.0 s and 3.9 s of a 4 s window: two in the
    first 2 s slice, one in the second; the longest wait is 2.9 s."""
    w = loop.Window(t0=10.0, t1=14.0, requests=[
        loop.Request(k, 0, 10.0, end=10.0 + e)
        for k, e in enumerate((0.5, 1.0, 3.9))])
    slices, gap_ms = w.pace(props=10**9)
    assert slices == [1.0, 0.5]
    assert gap_ms == 2900.0
