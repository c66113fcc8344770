"""Interactive Cesium globe of a propagated catalog (the PyTorch port of
examples/cesium_demo.py).

The counterpart of the reference's headline visualization demo
(examples/cesium_fast.py: "full active catalog at interactive rates",
README.md:49,234), built the standard-format way: the propagated
trajectories are emitted as CZML (Cesium's native time-dynamic JSON)
and embedded in a small self-contained HTML viewer that loads CesiumJS
from its CDN when a browser opens it; this program fetches nothing.

Usage:
    python examples_torch/cesium_demo.py [catalog.txt] [out_dir]

It writes ``cesium_demo.html`` and ``cesium_demo.czml`` into
``out_dir`` (the working directory by default). With no catalog file, a
built-in multi-regime demo catalog is used (pass a downloaded
``active.txt`` for the full-catalog experience).
"""

import json
import sys
import time as time_module
from pathlib import Path

import numpy as np
import torch

from astroz_tpu_torch import build_catalog, propagate
from astroz_tpu_torch.time import jd_to_datetime_parts

DEMO_TLES = """ISS (ZARYA)
1 25544U 98067A   24001.50000000  .00016717  00000-0  10270-3 0  9993
2 25544  51.6400 200.0000 0001234  90.0000 270.0000 15.50000000000017
NOAA 18
1 28654U 05018A   24001.50000000  .00000191  00000+0  12900-3 0  9996
2 28654  98.8703  55.0702 0013600 237.1907 122.7998 14.13250767961157
GPS BIIR-2
1 20413U 90005A   24001.50000000  .00000012  00000+0  10000-3 0  9992
2 20413  55.4408  61.4858 0112981 129.5765 231.5553  2.00561730104446
GOES 16 (GEO)
1 41866U 16071A   24001.50000000 -.00000248  00000+0  00000+0 0  9994
2 41866   0.0563 267.7025 0000907 131.5276 323.0936  1.00271124 26134
MOLNIYA-LIKE
1 09880U 77021B   24001.50000000  .00000023  00000+0  00000+0 0  9999
2 09880  63.4300  75.8891 7318036 269.8735  16.7549  2.00611684 54321
STARLINK-LIKE 1
1 70001U 24001A   24001.50000000  .00001000  00000-0  10000-3 0  9996
2 70001  53.0000  10.0000 0001500  80.0000 280.0000 15.05000000000013
STARLINK-LIKE 2
1 70002U 24001B   24001.50000000  .00001000  00000-0  10000-3 0  9997
2 70002  53.0000  70.0000 0001500  80.0000 220.0000 15.05000000000014
STARLINK-LIKE 3
1 70003U 24001C   24001.50000000  .00001000  00000-0  10000-3 0  9998
2 70003  53.0000 130.0000 0001500  80.0000 160.0000 15.05000000000015
"""

HTML_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
  <meta charset="utf-8">
  <title>astroz_tpu_torch — __NSATS__ satellites</title>
  <script src="https://cesium.com/downloads/cesiumjs/releases/1.104/Build/Cesium/Cesium.js"></script>
  <link href="https://cesium.com/downloads/cesiumjs/releases/1.104/Build/Cesium/Widgets/widgets.css" rel="stylesheet">
  <style>
    html, body, #globe { width: 100%; height: 100%; margin: 0; padding: 0; }
    #panel { position: absolute; top: 12px; left: 12px; z-index: 10;
             background: rgba(20, 24, 40, 0.85); color: #eee;
             font: 13px monospace; padding: 14px 18px; border-radius: 8px; }
    #panel b { color: #7fd4ff; }
  </style>
</head>
<body>
  <div id="globe"></div>
  <div id="panel">
    <b>astroz_tpu_torch</b> catalog demo<br>
    satellites: <b>__NSATS__</b><br>
    samples/sat: <b>__NSAMPLES__</b><br>
    propagation: <b>__THROUGHPUT__</b> props/s
  </div>
  <script>
    const viewer = new Cesium.Viewer("globe", {
      baseLayerPicker: false, geocoder: false, sceneModePicker: false,
      timeline: true, animation: true,
      imageryProvider: new Cesium.TileMapServiceImageryProvider({
        url: Cesium.buildModuleUrl("Assets/Textures/NaturalEarthII") }),
    });
    const czml = __CZML__;
    viewer.dataSources.add(Cesium.CzmlDataSource.load(czml)).then(() => {
      viewer.clock.shouldAnimate = true;
      viewer.clock.multiplier = 60;
    });
  </script>
</body>
</html>
"""


def jd_to_iso(jd_sum: float) -> str:
    y, mo, d, h, mi, s = jd_to_datetime_parts(jd_sum)
    return (f"{y:04d}-{mo:02d}-{d:02d}T{h:02d}:{mi:02d}:"
            f"{min(s, 59.999):06.3f}Z")


def make_czml(names, r_teme_km, jd_times, step_s: float):
    """One CZML packet per satellite with inertial cartesian samples."""
    start = jd_to_iso(jd_times[0])
    end = jd_to_iso(jd_times[-1])
    avail = f"{start}/{end}"
    docs = [{
        "id": "document", "name": "astroz_tpu_torch catalog",
        "version": "1.0",
        "clock": {"interval": avail, "currentTime": start,
                  "multiplier": 60},
    }]
    n_times = r_teme_km.shape[0]
    for k, name in enumerate(names):
        samples = []
        for t in range(n_times):
            samples.append(round(t * step_s, 3))
            samples.extend(np.round(r_teme_km[t, k] * 1000.0, 1).tolist())
        docs.append({
            "id": f"sat-{k}", "name": name, "availability": avail,
            "position": {
                "epoch": start,
                "referenceFrame": "INERTIAL",
                "cartesian": samples,
                "interpolationAlgorithm": "LAGRANGE",
                "interpolationDegree": 5,
            },
            "point": {"pixelSize": 4,
                      "color": {"rgba": [127, 212, 255, 255]}},
            "label": {"text": name, "font": "10px monospace",
                      "fillColor": {"rgba": [220, 220, 220, 200]},
                      "pixelOffset": {"cartesian2": [8, -8]},
                      "show": len(names) <= 32},
            "path": {"leadTime": 0, "trailTime": 2700,
                     "material": {"solidColor": {"color": {
                         "rgba": [127, 212, 255, 80]}}}},
        })
    return docs


def main(device="cuda", small=False, out_dir=".", catalog=None):
    text = Path(catalog).read_text() if catalog else DEMO_TLES
    out = Path(out_dir) / "cesium_demo.html"

    cat = build_catalog(text, device=device)
    n = len(cat)
    names = ([nm or f"SAT-{sn}" for nm, sn in
              zip(cat.names, cat.satnum)] if cat.names is not None
             else [f"SAT-{sn}" for sn in cat.satnum])

    # 24 h at 1-min steps for small catalogs; 90 min at 30 s when big
    # (small: the latter for any catalog)
    if n <= 256 and not small:
        n_times, step_s = 1440, 60.0
    else:
        n_times, step_s = 180, 30.0
    epoch = float(cat.epochs_jd.min())
    jd = epoch + np.arange(n_times) * (step_s / 86400.0)

    propagate(cat, jd, velocities=False, method="fast")  # warm-up
    if cat.device.type == "cuda":
        torch.cuda.synchronize(cat.device)
    t0 = time_module.perf_counter()
    r, _, err = propagate(cat, jd, velocities=False, method="fast")
    r = r.cpu().numpy().astype(np.float64)
    dt = time_module.perf_counter() - t0
    ok = (err.cpu().numpy() == 0).all(axis=0)
    rate = n * n_times / dt
    rate_s = (f"{rate / 1e6:.1f}M" if rate >= 1e6
              else f"{rate / 1e3:.0f}k")
    print(f"propagated {n} sats x {n_times} epochs in {dt:.2f}s "
          f"({rate_s} props/s)")

    czml = make_czml([nm for nm, o in zip(names, ok) if o],
                     r[:, ok], jd, step_s)
    html = (HTML_TEMPLATE
            .replace("__NSATS__", f"{int(ok.sum()):,}")
            .replace("__NSAMPLES__", str(n_times))
            .replace("__THROUGHPUT__", rate_s)
            .replace("__CZML__", json.dumps(czml, separators=(",", ":"))))
    out.write_text(html)
    czml_path = out.with_suffix(".czml")
    czml_path.write_text(json.dumps(czml, indent=1))
    print(f"wrote {out} ({out.stat().st_size / 1e6:.1f} MB) and "
          f"{czml_path} — open {out} in a browser")


if __name__ == "__main__":
    args = sys.argv[1:]
    main(catalog=args[0] if args else None,
         out_dir=args[1] if len(args) > 1 else ".")
