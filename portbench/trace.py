"""A traced span of requests: what the card ran and what the host did.

``torch.profiler`` records the span in memory (no file is written); this
module turns its events into plain lists in one clock (microseconds):
device activity (kernels, copies, fills), CUDA runtime calls and other
host operations, and the benchmark's own ``record_function`` spans
(``portbench.span`` around the whole span, ``portbench.request`` around
each request)."""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

SPAN = "portbench.span"
REQUEST = "portbench.request"
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")

Interval = Tuple[str, float, float]


@dataclass
class Trace:
    device: List[Interval] = field(default_factory=list)
    runtime: List[Interval] = field(default_factory=list)
    host: List[Interval] = field(default_factory=list)
    spans: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    requests: int = 0

    @classmethod
    def from_profile(cls, prof, requests: int) -> "Trace":
        tr = cls(requests=requests)
        for e in prof.events():
            name, t0, t1 = e.name, e.time_range.start, e.time_range.end
            on_device = getattr(e.device_type, "name",
                                str(e.device_type)).endswith("CUDA")
            if name.startswith("portbench."):
                if not on_device:
                    tr.spans.setdefault(name, []).append((t0, t1))
            elif on_device:
                tr.device.append((name, t0, t1))
            elif _RUNTIME.match(name):
                tr.runtime.append((name, t0, t1))
            else:
                tr.host.append((name, t0, t1))
        tr.device.sort(key=lambda x: x[1])
        return tr

    @property
    def window(self) -> Tuple[float, float]:
        (t0, t1), = self.spans[SPAN]
        return t0, t1

    @property
    def window_s(self) -> float:
        t0, t1 = self.window
        return (t1 - t0) * 1e-6

    def kernels(self, pattern=None) -> List[Interval]:
        """Kernels (device activity other than copies and fills) whose
        name matches ``pattern`` (a regex), all without one."""
        return [x for x in self.device
                if not x[0].startswith(("Memcpy", "Memset"))
                and (pattern is None or re.search(pattern, x[0]))]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The device's activity in the window, merged."""
        w0, w1 = self.window
        out = []
        for _, a, b in self.device:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [tuple(x) for x in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def gaps(self) -> List[Tuple[float, float]]:
        """The device's idle stretches in the window."""
        w0, w1 = self.window
        edges = [w0] + [t for iv in self.busy_intervals() for t in iv] + [w1]
        return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]

    def host_at(self, t: float) -> str:
        """The innermost host operation running at ``t``."""
        best = None
        for name, a, b in self.host + self.runtime + [
                (REQUEST, a, b) for a, b in self.spans.get(REQUEST, [])]:
            if a <= t <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else "host outside the program"

    def breakdown(self, top: int = 10) -> dict:
        """Device time by operation name, and idle time by what the host
        was doing in the middle of each gap: the ``top`` largest each,
        in seconds."""
        ops: Dict[str, float] = {}
        for name, a, b in self.device:
            ops[name[:160]] = ops.get(name[:160], 0.0) + (b - a) * 1e-6
        idle: Dict[str, float] = {}
        for a, b in self.gaps():
            name = self.host_at(0.5 * (a + b))[:160]
            idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6

        def largest(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]

        return {"device_ops": largest(ops), "idle_gaps": largest(idle)}
