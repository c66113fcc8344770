"""The ported examples (``examples_torch/``), each run in this process with
``main(device="cpu", small=True)``, and its output lines checked: where
the shortened scenario is the JAX script's own, against the lines the
JAX script prints (``examples/``); elsewhere the lines' form and the
numbers the short run gives. Every script's ``main`` defaults to the
card.
"""

import importlib.util
import inspect
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples_torch")

#: script -> lines (regular expressions, matched whole) its output holds
EXPECTED = {
    "attitude_determination": [
        r"determined quaternion: \[ 0\.9659  0\.      0\.     -0\.2588\]",
        r"after 6 s tumble:    \[ 0\.99\d\d  0\.      0\.     -0\.1\d+\]"],
    "cesium_demo": [
        r"propagated 8 sats x 180 epochs in \d+\.\d\ds \(\d+k props/s\)",
        r"wrote .*cesium_demo\.html \(\d+\.\d MB\) and .*cesium_demo\.czml "
        r"— open .*cesium_demo\.html in a browser"],
    "conjunction_screen": [
        r"10 pairs within 100 km:", r"  20001 - 20010: 48\.11 km",
        r"  20001 - 20050: 50\.56 km", r"  20048 - 20062: 78\.42 km"],
    "constellation_phasing": [
        r"=== Sun-Synchronous Orbit Design ===",
        r"differential drift: \d\.\d{4} deg/day",
        r"  4 slots: shift  90 deg costs  849\.35 m/s over  1\.20 h"],
    "create_ccsds_packet": [
        r"  version=0 type=1 apid=0x097 seq=0",
        r"  secondary header: 0{24}",
        r"reference test packet: apid=0x097 len=10 "
        r"payload=0102030405060708090a"],
    "fits_and_stars": [
        r"1 HDU\(s\); primary \(32, 32\), OBJECT=TESTOBJ",
        r"wrote .*demo\.pgm",
        r"Betelgeuse J2050: RA 5h57m52\.8s Dec 7d24m47s"],
    "force_models": [
        r"two-body after 1 h: \|r\| = 6778\.137 km \(\d+ adaptive steps\)",
        r"with J2 after 1 h:  \|r\| = 67\d\d\.\d{3} km "
        r"\(\d+ adaptive steps\)",
        r"J2-induced position drift: \d+\.\d km",
        r"  h0 =   800 km -> \|r\|\(1 h\) =   7\d{3}\.\d km"],
    "ground_track": [
        r"ground track for NORAD 55909 \(one orbit\):",
        r"     0    -0\.000   -155\.968    547\.9",
        r"     2     5\.260   -151\.036    548\.4",
        r"ECEF at epoch: x=-6325\.658 y=-2820\.573 z=-0\.002 km"],
    "mission_planning": [
        r"Earth -> Mars Hohmann: 5\.59 km/s, 259 days",
        r"synodic period 780 days, departure phase angle 44\.3 deg",
        r"LEO -> GEO: dv1=2\.426 dv2=1\.467 km/s in 5\.28 h",
        r"bi-elliptic 7000->140000 km: 3\.930 km/s"],
    "monte_carlo": [
        r"total_delta_v   mean=    3\.85\d\d  std= 0\.00\d{3}  "
        r"95% CI \[3\.85\d\d, 3\.85\d\d\]",
        r"transfer_time   mean=190\d\d\.\d{4}  std=\d+\.\d{5}  .*"],
    "numerical_propagation": [
        r"DP87: 10 samples, final \|r\| = 68\d\d\.\d km",
        r"after prograde burn: \|r\| = 68\d\d\.\d km"],
    "orbit_maneuvers": [
        r"basic propagation: 346 states, \|r\| = \d{4}\.\d km",
        r"after 2 impulses:  \|r\| = \d{4}\.\d km",
        r"after \+100 m/s prograde: semi-major axis = 7\d{3}\.\d km",
        r"plane change applied: 174 states, final \|r\| = \d{4}\.\d km"],
    "output_layouts": [
        r"time_major: \(25, 2, 3\)", r"sat_major:  \(2, 25, 3\)",
        r"planes:     \(3, 25, 2\)",
        r"velocities=False: v is None - positions bit-identical"],
    "parse_telemetry_files": [
        r"CCSDS: 4 frames recovered through sync resync",
        r"  APID 42 seq 3: obs-3", r"VITA49 stream 7: 12 payload bytes",
        r"VITA49: 3 frames"],
    "precess_star": [
        r"  RA  298\.00833 -> 298\.05664 deg",
        r"  Dec 40\.16944 -> 40\.18402 deg"],
    "propagate_catalog": [
        r"2 satellites \(1 deep-space\)",
        r"ISS \(ZARYA\): lat   -0\.09  lon   -80\.72  alt     417\.5 km",
        r"GOES-16: lat   -0\.02  lon    -0\.65  alt   35786\.3 km"],
    "python_sgp4_migration": [
        r"error=0  r=\(-6388\.625, -2316\.411, -10\.511\) km",
        r"batch shapes: \(1, 4\) \(1, 4, 3\) \(1, 4, 3\)",
        r"altitudes: \[417\.5 421\.5 409\.2 419\.7\]"],
    "spice_propagation": [
        r"SPICE unavailable \(\w+\) — fixed Sun/Moon positions\.",
        r"propagated 10 steps over one orbit",
        r"radius range: 679\d\.\d - 679\d\.\d km"],
    "telemetry_pipeline": [
        r"APID 100: frame-0", r"APID 104: frame-4", r"parsed 5 frames"],
}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_every_example_is_listed():
    scripts = sorted(f[:-3] for f in os.listdir(EXAMPLES) if f.endswith(".py"))
    reference = sorted(f[:-3] for f in os.listdir(os.path.join(REPO,
                                                               "examples"))
                       if f.endswith(".py"))
    assert scripts == reference == sorted(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_example_runs_on_the_cpu(name, capsys, tmp_path):
    module = _load(name)
    params = inspect.signature(module.main).parameters
    assert params["device"].default == "cuda"
    assert params["small"].default is False
    kw = {"out_dir": str(tmp_path)} if "out_dir" in params else {}
    module.main(device="cpu", small=True, **kw)
    lines = capsys.readouterr().out.splitlines()
    for pattern in EXPECTED[name]:
        assert any(re.fullmatch(pattern, ln) for ln in lines), (pattern,
                                                                 lines)
    if name == "cesium_demo":
        page = (tmp_path / "cesium_demo.html").read_text()
        assert "cesium.com/downloads/cesiumjs" in page
        assert (tmp_path / "cesium_demo.czml").exists()
