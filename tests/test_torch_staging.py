"""How a sweep's host epochs reach the card (``propagation._stage_epochs``):
on a CUDA catalog one page-locked buffer a call, sent with one
non-blocking copy, so that ``propagate`` returns with its work queued
and no host wait. The card's cases (marked ``cuda``) trace a sweep for
blocking runtime calls and copies, queue sweeps of eight days back to
back behind a busy card (a buffer handed out again before its copy had
finished would give one day another's epochs), and overwrite the
caller's arrays while the card is still busy; the last also runs on the
CPU.

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest tests/test_torch_staging.py -q
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from astroz_tpu_torch import build_catalog, propagate

from test_torch_cuda import (BLOCKING, _same_bits,  # noqa: F401
                             cuda_device, synthetic_leo_text)

torch.set_num_threads(1)

#: a day of epochs at 10 minutes from the catalog's mid epoch
JD0 = 2460310.5
FR = np.arange(144) / 144.0
#: cycles of ``torch.cuda._sleep`` that keep the card busy (~25 ms) while
#: the host queues what follows
BUSY_CYCLES = 50_000_000


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda":
        return request.getfixturevalue("cuda_device")
    return torch.device("cpu")


def _busy(device):
    """Queue ~25 ms of work ahead of what follows, on a card."""
    if device.type == "cuda":
        torch.cuda._sleep(BUSY_CYCLES)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _same(a, b):
    return all((x is None and y is None) or _same_bits(x, y)
               for x, y in zip(a, b))


@pytest.mark.parametrize("method", ["fast", "f64"])
def test_caller_may_overwrite_epochs_after_return(device, method):
    """The caller's jd, fr and mask are read before ``propagate`` returns:
    overwritten at once, while the card is still busy with what was
    queued before, they leave the outputs bit-equal to a sweep whose
    arrays were left alone."""
    cat = build_catalog(synthetic_leo_text(64), device=device)
    mask = np.arange(len(cat)) % 3 != 0
    kw = dict(method=method, output="ecef", layout="sat_major")
    want = propagate(cat, np.full(FR.shape, JD0), FR.copy(),
                     satellite_mask=mask.copy(), **kw)
    _sync(device)
    jd, fr, m = np.full(FR.shape, JD0), FR.copy(), mask.copy()
    _busy(device)
    got = propagate(cat, jd, fr, satellite_mask=m, **kw)
    jd[:], fr[:], m[:] = JD0 + 3.0, 0.5, ~mask
    _sync(device)
    assert _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["fast", "f64"])
def test_back_to_back_sweeps_equal_sweeps_alone(cuda_device, method):
    """Eight sweeps of eight days queued behind a busy card with no host
    wait between them each equal the same day's sweep run alone, bit for
    bit: each call's staging buffer stays its own until its copy has
    finished."""
    cat = build_catalog(synthetic_leo_text(256), device=cuda_device)
    kw = dict(method=method, output="ecef", layout="time_major")
    days = [np.full(FR.shape, JD0 + d - 3.0) for d in range(8)]
    alone = []
    for jd in days:
        alone.append(propagate(cat, jd, FR, **kw))
        torch.cuda.synchronize()
    _busy(cuda_device)
    queued = [propagate(cat, jd, FR, **kw) for jd in days]
    torch.cuda.synchronize()
    for a, q in zip(alone, queued):
        assert _same(a, q)
    assert not _same(alone[0], alone[1])


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["fast", "f64"])
def test_sweep_makes_no_blocking_call(cuda_device, method):
    """A traced sweep (ECEF, so that the epilogue reads jd_sum) makes no
    stream or device synchronize and no synchronous copy inside its
    ``astroz.propagate`` span, and sends its epochs in one host-to-card
    ``cudaMemcpyAsync`` from page-locked memory."""
    cat = build_catalog(synthetic_leo_text(256), device=cuda_device)
    kw = dict(method=method, output="ecef", layout="time_major")
    propagate(cat, np.full(FR.shape, JD0), FR, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        propagate(cat, np.full(FR.shape, JD0), FR, **kw)
        torch.cuda.synchronize()
    events = prof.events()
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    (r0, r1), = [(e.time_range.start, e.time_range.end) for e in host
                 if e.name == "astroz.propagate"]
    inside = [e.name for e in host
              if r0 <= e.time_range.start and e.time_range.end <= r1]
    assert not [n for n in inside if BLOCKING.match(n)]
    assert inside.count("cudaMemcpyAsync") == 1
    copies = [e.name for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name.startswith("Memcpy")]
    assert len(copies) == 1 and copies[0].startswith("Memcpy HtoD")
    assert "Pinned" in copies[0]
