"""Profiling and throughput measurement utilities.

Counterpart of ``astroz_tpu/profiling.py``. The reference has no tracing
layer: its benchmarks time by hand and guard dead-code elimination with
``doNotOptimizeAway``. Here ``torch.profiler`` traces the host and the
card (viewable in ui.perfetto.dev or chrome://tracing), and the
throughput harness waits on the device of each call's outputs (that
wait is our doNotOptimizeAway).

The package names its own stages in such a trace with :func:`span`, a
host-side record function while a profiler records and a shared no-op
while none does. The spans are a closed set:

* ``astroz.propagate``: the whole host path of one ``propagate`` or
  ``propagate_tsince`` call; ``astroz.screen_all``: of one
  ``screen_all`` or ``screen_all_ring`` call;
* ``astroz.stage.epochs``: the host epochs of one ``propagate`` or
  ``propagate_tsince`` call (and the mask) written into page-locked
  memory and their copy to the card queued; host time only, since the
  copy does not wait for the card. A sweep thus returns with its work
  queued and no host wait, as torch's own ops do;
* ``astroz.wait.<what>``: one call that blocks the host until the card
  has finished its queued work: ``epochs`` (a copy of epochs that
  blocks; no CUDA sweep has one), ``count`` (K4's candidate count),
  ``pairs`` (a screen's pairs copied to the host);
* ``astroz.alloc``: a sweep's output allocation;
* ``astroz.finalize``: the output epilogue's work in one call of
  ``ops.cuda_finalize.finalize`` (the GMST row, the output
  allocation and the launch), none where the epilogue returns the
  sweep's own tensors;
* ``astroz.retry.candidates``: K4's relaunch when its hits pass the
  room it was given.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Optional, Set

import torch

#: what :func:`span` returns while no profiler records: one shared
#: context manager that does nothing
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that names a stage of the program in a trace.

    While a ``torch.profiler`` records on this thread it is a record
    function of the operator kind (``_RecordFunctionFast``): a host span
    on the clock of the device trace, and only a host span. A
    ``torch.profiler.record_function`` is a user annotation, which the
    profiler also copies onto the card's timeline over the kernels it
    launched, where it would read as device work. While nothing records
    it is a shared no-op, so that a span costs one check."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a host and device trace around a block::

        with profiling.trace("trace_dir") as prof:
            propagate(cat, jd, fr)

    Yields the ``torch.profiler.profile``; on exit the trace is written
    to ``log_dir/trace.json`` (Chrome trace format; ``log_dir`` defaults
    to ``astroz_torch_trace`` in the temporary directory)."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "astroz_torch_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclass
class ThroughputResult:
    seconds_per_call: float
    items_per_second: float
    n_calls: int

    def __str__(self) -> str:
        return (f"{self.items_per_second/1e6:.1f} M items/s "
                f"({self.seconds_per_call*1e3:.2f} ms/call)")


def _cuda_devices(out) -> Set[torch.device]:
    """The CUDA devices of the tensors in a (nested) output."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, dict):
        out = out.values()
    if isinstance(out, (list, tuple)) or hasattr(out, "_fields"):
        found = set()
        for x in out:
            found |= _cuda_devices(x)
        return found
    return set()


def _wait(out) -> None:
    """Wait until the devices of ``out``'s tensors finished their work
    (``jax.block_until_ready``'s role); CPU tensors are ready."""
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)


def measure_throughput(fn: Callable, *args, items_per_call: int = 1,
                       n_calls: int = 5, warmup: int = 1,
                       pipelined: bool = True) -> ThroughputResult:
    """Steady-state throughput of a device computation.

    ``pipelined=True`` dispatches all calls before waiting (hides
    per-dispatch launch latency — the realistic serving pattern);
    ``False`` waits on each call (includes launch latency).
    """
    for _ in range(warmup):
        _wait(fn(*args))
    t0 = time.perf_counter()
    if pipelined:
        outs = [fn(*args) for _ in range(n_calls)]
        for o in outs:
            _wait(o)
    else:
        for _ in range(n_calls):
            _wait(fn(*args))
    dt = (time.perf_counter() - t0) / n_calls
    return ThroughputResult(seconds_per_call=dt,
                            items_per_second=items_per_call / dt,
                            n_calls=n_calls)


def device_memory_stats(device="cuda") -> Optional[dict]:
    """``torch.cuda.memory_stats`` of a card; None for ``"cpu"``, which
    keeps no such stats (as JAX's returns None on a backend without
    them)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.memory_stats(device)
