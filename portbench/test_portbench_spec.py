"""BENCHMARK.json against the contract's rules of form, the files the
harness finds by name, and what the harness may import."""

import ast
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
CELLS = {w["name"]: w for w in SPEC["workloads"]}
#: top-level module names nothing under portbench/ may import
FORBIDDEN = {"jax", "jaxlib", "flax", "astroz_tpu"}


def _line(text, limit=200):
    return 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(SPEC["command"]) <= 32 and all(_line(w) for w in
                                              SPEC["command"])
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_lines():
    names = [x["name"] for x in SPEC["configs"] + SPEC["workloads"]
             + METRICS]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/")
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m \
            else True
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for cell in CELLS:
        reported = [m for m in SPEC["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        assert len(reported) >= 2
        layered = [m for m in SPEC["per_layer"]
                   if cell in m.get("workloads", [cell])]
        assert layered
        for m in layered:
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_files_found_by_name():
    for c in SPEC["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert (HERE / "catalogs" / f"{conf['generator']}.py").exists()
    for w in SPEC["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (HERE / "limits" / f"{w['name']}.json").exists()
    for m in METRICS:
        assert (HERE / "metrics" / f"{m['name']}.py").exists()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_imports(path):
    """No file imports JAX or the JAX package (top-level names compared
    whole: the port's name begins with the JAX package's), and the
    reference imports nothing of the program; no file names the JAX
    package's benchmark scripts."""
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN
    if "reference" in path.parts:
        assert "astroz_tpu_torch" not in tops
    text = path.read_text()
    # the pattern is split so that this file does not match itself
    assert not re.search("chip" "_smoke|" r"\bbench\.py|" "benchmarks" "/",
                         text)
