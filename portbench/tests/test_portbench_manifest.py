"""BENCHMARK.json against the benchmark's contract, and every file of
every cell found by name."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests import test_portbench_tiny as tiny

ROOT = Path(harness.HERE).parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = harness.manifest(ROOT)
CELLS = tiny.CELLS


def test_top_level_keys_and_paths():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/") and ".." not in p
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_run_seconds_fits_a_full_check():
    rs = MAN["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]}) \
        == len(MAN["end_to_end"]) + len(MAN["per_layer"])


def test_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("name", CELLS)
def test_every_file_of_a_cell_is_found_by_name(name):
    c = harness.cell(tiny.manifest(), name)
    for key in ("sizes", "system", "reference", "traffic"):
        assert c["files"][key].is_file(), key
    sizes = json.loads(c["files"]["sizes"].read_text())
    traffic = json.loads(c["files"]["traffic"].read_text())
    assert (harness.HERE / "checks" / f"{sizes['kind']}.py").is_file()
    assert (harness.HERE / "loops" / f"{traffic['loop']}.py").is_file()
    for path in c["files"]["metrics"].values():
        assert path.is_file()
        assert callable(harness.load_module(path).read)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_reports_setup_another_metric_and_a_layer(name):
    c = harness.cell(tiny.manifest(), name)
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert m["moves"] in e2e


def test_one_layer_name_per_layer():
    by_layer = {}
    for m in tiny.manifest()["per_layer"]:
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        by_layer.setdefault(m["layer"], []).append(m["name"])
    roots = {n.split(".")[0]: layer for layer, ns in by_layer.items()
             for n in ns}
    for m in tiny.manifest()["per_layer"]:
        assert roots[m["name"].split(".")[0]] == m["layer"]
