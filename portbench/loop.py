"""The one traffic generator: it reads a mix's parameters
(``traffic/<mix>.json``) and drives the program's public entries.

A mix names a request ``kind``:

* ``propagate``: ``propagation.propagate(cat, jd, fr, method=, output=,
  layout=, velocities=)``, a closed loop of one client that keeps at most
  ``in_flight`` sweeps on the card (one CUDA event a sweep) and keeps
  their outputs on the card;
* ``screen_all``: ``screening.screen_all(cat, jd, fr, threshold_km=,
  method=)``, one screen at a time, each ending with its numpy pair list.

Request k covers day ``(k + offset) mod days`` after the catalog's epoch
at ``epochs`` epochs ``step_s`` seconds apart; ``offset`` comes from the
seed, so every seed sends the same requests in another order. Set-up
runs every day's request once.
"""

from __future__ import annotations

import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

KINDS = ("propagate", "screen_all")
#: what each mix's file may set, with the values a key takes by default
DEFAULTS = {"kind": None, "days": 7, "epochs": 1440, "step_s": 60.0,
            "method": "fast", "output": "teme", "layout": "planes",
            "velocities": True, "in_flight": 1, "threshold_km": None,
            "trace_requests": 64}


def mix(params: dict) -> dict:
    unknown = set(params) - set(DEFAULTS) - {"why"}
    if unknown:
        raise ValueError(f"unknown traffic keys {sorted(unknown)}")
    out = dict(DEFAULTS, **params)
    if out["kind"] not in KINDS:
        raise ValueError(f"traffic kind must be one of {sorted(KINDS)}")
    return out


def epochs(traffic: dict, epoch_jd: float, day: int):
    """(jd, fr) numpy f64 arrays of one request's epochs."""
    n = traffic["epochs"]
    jd = np.full(n, float(epoch_jd) + day)
    fr = np.arange(n, dtype=np.float64) * traffic["step_s"] / 86400.0
    return jd, fr


@dataclass(eq=False)
class Request:
    k: int
    day: int
    start: float  # host clock, s
    end: float = float("nan")  # host clock when its completion was seen
    out: object = None


class Reservoir:
    """A uniform sample of ``size`` of the requests offered, drawn from
    the seed (algorithm R); only the sample keeps its outputs."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([seed % 2**63, 0x5EED])
        self.kept: List[Request] = []
        self.seen = 0

    def offer(self, req: Request):
        """Keep ``req`` or not; the request that leaves the sample (``req``
        itself, or the one it replaces) drops its outputs."""
        out = None
        if len(self.kept) < self.size:
            self.kept.append(req)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            out = req
            if j < self.size:
                out, self.kept[j] = self.kept[j], req
        self.seen += 1
        if out is not None:
            out.out = None


@dataclass
class Window:
    requests: List[Request] = field(default_factory=list)
    t0: float = 0.0
    t1: float = 0.0

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def pace(self, props: int, width: float = 2.0):
        """G props/s completed in each ``width``-second slice of the
        window, and the longest wait between two completions (ms): where
        a run reads low, they tell a host that stood still from a card
        that ran slower throughout."""
        ends = np.array([r.end for r in self.requests]) - self.t0
        n = max(1, int(self.seconds // width))
        counts = np.histogram(ends, bins=n, range=(0.0, n * width))[0]
        gaps = np.diff(np.concatenate([[0.0], np.sort(ends)]))
        return ([round(float(c) * props / width / 1e9, 3) for c in counts],
                round(float(gaps.max()) * 1e3, 3) if len(gaps) else 0.0)


class _NoEvent:
    """Stands in for a CUDA event on a CPU catalog."""

    def record(self):
        pass

    def synchronize(self):
        pass


def sync(device):
    """Wait for the card, where ``device`` is one."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Client:
    """One client of the program: builds the requests of a mix and sends
    them, for a window of time or a number of requests."""

    def __init__(self, cat, traffic: dict, epoch_jd: float, seed: int,
                 device):
        from astroz_tpu_torch import propagation, screening

        self.cat, self.traffic, self.device = cat, traffic, device
        self.days = [epochs(traffic, epoch_jd, d)
                     for d in range(traffic["days"])]
        self.offset = seed % traffic["days"]
        self.kind = traffic["kind"]
        self.propagation, self.screening = propagation, screening
        self.cuda = torch.device(device).type == "cuda"

    def day_of(self, k: int) -> int:
        return (k + self.offset) % len(self.days)

    def props(self) -> int:
        """Satellite-epochs of one request."""
        return len(self.cat) * self.traffic["epochs"]

    def send(self, day: int):
        """One request for ``day``: what the program's entry returns."""
        jd, fr = self.days[day]
        t = self.traffic
        if self.kind == "screen_all":
            return self.screening.screen_all(
                self.cat, jd, fr, threshold_km=t["threshold_km"],
                method=t["method"])
        return self.propagation.propagate(
            self.cat, jd, fr, method=t["method"], output=t["output"],
            layout=t["layout"], velocities=t["velocities"])

    def warm(self):
        """Every day's request once, all outputs held together so that the
        allocator keeps blocks for the sweeps in flight and the sample."""
        outs = [self.send(d) for d in range(len(self.days))]
        sync(self.device)
        del outs

    def run(self, *, seconds=None, count=None, reservoir=None,
            mark=None) -> Window:
        """Send requests until ``seconds`` have passed or ``count`` were
        sent, then wait for all of them. ``mark(k)`` is a context manager
        around each send (the traced span's record_function)."""
        w = Window()
        in_flight = self.traffic["in_flight"]
        pending = deque()
        w.t0 = time.perf_counter()
        end = None if seconds is None else w.t0 + seconds

        def complete():
            req, ev = pending.popleft()
            ev.synchronize()
            req.end = time.perf_counter()
            if reservoir is None:
                req.out = None
            else:
                reservoir.offer(req)

        k = 0
        while True:
            if end is not None and time.perf_counter() >= end:
                break
            if count is not None and k >= count:
                break
            if len(pending) == in_flight:
                complete()
            req = Request(k, self.day_of(k), time.perf_counter())
            with mark(k) if mark else nullcontext():
                req.out = self.send(req.day)
            ev = torch.cuda.Event() if self.cuda else _NoEvent()
            ev.record()
            pending.append((req, ev))
            w.requests.append(req)
            k += 1
        while pending:
            complete()
        sync(self.device)
        w.t1 = time.perf_counter()
        return w

