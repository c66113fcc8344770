"""Readings that set a cell's limits: the program and the control, on
many seeds, in one process.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
        [--days 0,3,6]

For each seed it builds the cell's catalog on the card, sends the cell's
request for each day asked for through the program's timed path, and
compares the outputs with the f64 reference (the program's readings, the
lower end of each limit); then it puts the control in the program's
place and compares it the same way (the upper end). The control is the
reference computed in float32, the step below the f64 spine of the fast
path; for an f64 mix it is the program's own float32 path
(``method="fast"``). Prints one JSON line a seed and a summary line.
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed, days, device="cuda"):
    """``{"program": {...}, "control": {...}, "reference_s": ...}``: the
    worst of each number over ``days`` for one seed."""
    import torch

    from astroz_tpu_torch import propagation
    from portbench import checks, loop
    from portbench.checks import propagate as pcheck
    from portbench.reference import catalog as ref

    check = importlib.import_module(
        f"portbench.checks.{cell.traffic['kind']}")
    gen = importlib.import_module(
        f"portbench.catalogs.{cell.config['generator']}")
    text = gen.text(cell.config, seed)
    cat = propagation.build_catalog(text, device=device)
    ref_cat = ref.build(text)
    client = loop.Client(cat, cell.traffic, cell.config["epoch_jd"], seed,
                         device)
    t = cell.traffic
    prog, ctrl, ref_s = [], [], 0.0
    for day in days:
        jd, fr = loop.epochs(t, cell.config["epoch_jd"], day)
        out = client.send(day)
        t0 = time.perf_counter()
        prog.append(check.judge(out, ref_cat, t, jd, fr, device))
        loop.sync(device)
        ref_s = max(ref_s, time.perf_counter() - t0)
        del out
        if t["kind"] == "propagate" and t["method"] == "f64":
            alt = propagation.propagate(
                cat, jd, fr, method="fast", output=t["output"],
                layout=t["layout"], velocities=t["velocities"])
            ctrl.append(check.judge(alt, ref_cat, t, jd, fr, device))
        elif t["kind"] == "propagate":
            r, v, err = check.control(ref_cat, t, jd, fr, device)
            ctrl.append(pcheck.readings(r, v if t["velocities"] else None,
                                        err, ref_cat, t, jd, fr, device))
        else:
            ctrl.append(check.judge(check.control(ref_cat, t, jd, fr,
                                                  device),
                                    ref_cat, t, jd, fr, device))
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return {"seed": seed, "days": list(days), "program": checks.worst(prog),
            "control": checks.worst(ctrl), "reference_s": ref_s,
            "summary": ref_cat.summary()}


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--days", default="0,1,2,3,4,5,6")
    args = p.parse_args()
    from portbench import harness

    cell = harness.load_cell(ROOT, args.workload, False)
    seeds = [int(s) for s in args.seeds.split(",")]
    days = [int(d) for d in args.days.split(",")]
    rows = []
    for seed in seeds:
        rows.append(readings(cell, seed, days))
        print(json.dumps(rows[-1]), flush=True)
    keys = rows[0]["program"].keys()
    print(json.dumps({
        "workload": cell.name, "seeds": len(rows),
        "program_max": {k: max(r["program"][k] for r in rows) for k in keys},
        "control_min": {k: min(r["control"][k] for r in rows
                               if k in r["control"]) for k in keys},
        "limits": cell.limits}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    main()
