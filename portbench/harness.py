"""One run of one cell: set-up, the timed window, the traced span, the
check against the reference, and the result line.

Everything that belongs to a configuration, a traffic mix or a metric is
found by name: ``BENCHMARK.json`` gives the cell's configuration
(``configs/<file>``, whose ``generator`` names a module of ``catalogs/``)
and traffic mix (``traffic/<mix>.json``, read by ``loop``), and each
metric is read by ``metrics/<name>.py``; the limits of the cell's check
are ``limits/<cell>.json``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import checks, loop
from .reference import catalog as ref
from .trace import REQUEST, SPAN, Trace

HERE = Path(__file__).resolve().parent
#: top-level module names that the process may not hold once the window
#: has closed: JAX, and the JAX package that the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "astroz_tpu")
#: requests of the window whose outputs the check compares, drawn from
#: the seed
SAMPLED = 2


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: list  # BENCHMARK.json's metric entries this run reports
    limits: dict


@dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    setup_s: float
    catalog_build_ms: float
    window: loop.Window
    props: int  # satellite-epochs a request
    summary: dict  # the reference's count of lanes by regime
    trace: Optional[Trace] = None


def load_cell(root: Path, workload: str, trace: bool) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json``, with the metrics that
    a ``--trace 0`` run (end-to-end) or ``--trace 1`` run (per-layer)
    reports."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: "
                         f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    metrics = [m for m in spec["per_layer" if trace else "end_to_end"]
               if workload in m.get("workloads", [workload])]
    return make_cell(root, workload, conf["file"], w["traffic"],
                     int(w["chips"]), metrics)


def make_cell(root: Path, name: str, config_file: str, traffic: str,
              chips: int = 1, metrics=()) -> Cell:
    """A cell from its files: the configuration, ``traffic/<traffic>.json``
    and ``limits/<name>.json``."""
    config = json.loads((root / config_file).read_text())
    mix = loop.mix(json.loads(
        (HERE / "traffic" / f"{traffic}.json").read_text()))
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return Cell(name, chips, config, mix, list(metrics), limits)


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             t_start: float, device="cuda", log=print):
    """Drive one run; returns the result dict (the JSON line) and the
    check's lines for standard error."""
    from astroz_tpu_torch import propagation

    on_card = torch.device(device).type == "cuda"
    marks = [("start", t_start)]

    def mark(what):
        marks.append((what, time.perf_counter()))

    mark("imports")
    if on_card:
        torch.zeros(1, device=device)
    mark("cuda context")
    gen = importlib.import_module(
        f"portbench.catalogs.{cell.config['generator']}")
    text = gen.text(cell.config, seed)
    mark("TLE text")
    t = time.perf_counter()
    cat = propagation.build_catalog(text, device=device)
    loop.sync(device)
    catalog_build_ms = (time.perf_counter() - t) * 1e3
    mark("build_catalog")
    client = loop.Client(cat, cell.traffic, cell.config["epoch_jd"], seed,
                         device)
    client.warm()
    loop.sync(device)
    mark("warm-up")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    sample = loop.Reservoir(SAMPLED, seed)
    window = client.run(seconds=seconds, reservoir=sample)
    tr = None
    if trace:
        tr = _traced_span(client, cell.traffic["trace_requests"])
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    ref_cat = ref.build(text)
    client_props = client.props()
    run = Run(cell, setup_s, catalog_build_ms, window, client_props,
              ref_cat.summary(), tr)
    metrics = {}
    for m in cell.metrics:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the program's state goes before the reference runs on the card
    kept = [(r.day, r.out) for r in sample.kept]
    del cat, client, sample
    if on_card:
        torch.cuda.empty_cache()
    bounded, info = judge(cell, kept, ref_cat, device)
    passed = {k: bool(c["value"] <= c["limit"]) for k, c in bounded.items()}
    correct = bool(bounded) and all(passed.values())
    result = {
        "correct": correct, "attempted": len(window.requests),
        "failed": sum(not ok for ok in info.pop("request_ok")),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card
                   else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)},
    }
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    # a number that is not finite is printed as text: JSON has no NaN
    result["checks"] = {
        k: {"value": c["value"] if np.isfinite(c["value"])
            else repr(c["value"]), "limit": c["limit"]}
        for k, c in bounded.items()}
    if tr is not None:
        calls = {}
        for name, _, _ in tr.runtime:
            calls[name] = calls.get(name, 0) + 1
        info["traced"] = (f"{tr.requests} requests, {len(tr.device)} device "
                          f"activities, runtime calls {calls}")
    slices, gap = window.pace(client_props)
    info["pace"] = (f"G props/s a 2 s slice {slices}; longest wait "
                    f"between completions {gap} ms")
    info["setup split s"] = ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:]))
    lines = [f"# info {k}: {v}" for k, v in info.items()]
    lines += [f"check {k}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if passed[k] else 'FAILED'}"
              for k, c in bounded.items()]
    return result, lines


def _traced_span(client: loop.Client, count: int) -> Trace:
    """``count`` requests of the same loop under ``torch.profiler``, in
    memory, after the window has drained."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if client.cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(SPAN):
            client.run(count=count, mark=lambda k: record_function(REQUEST))
    return Trace.from_profile(prof, count)


def judge(cell: Cell, kept, ref_cat, device):
    """The cell's numbers over the sampled requests, each beside its
    limit, and what else the check read."""
    check = importlib.import_module(
        f"portbench.checks.{cell.traffic['kind']}")
    readings, ok = [], []
    for day, out in kept:
        jd, fr = loop.epochs(cell.traffic, cell.config["epoch_jd"], day)
        rd = check.judge(out, ref_cat, cell.traffic, jd, fr, device)
        readings.append(rd)
        ok.append(all(rd.get(k, 0.0) <= lim
                      for k, lim in cell.limits.items()))
    worst = checks.worst(readings)
    bounded = {k: {"value": worst[k], "limit": lim}
               for k, lim in cell.limits.items() if k in worst}
    info = {k: v for k, v in worst.items() if k not in cell.limits}
    info["days"] = [d for d, _ in kept]
    info["request_ok"] = ok
    return bounded, info
