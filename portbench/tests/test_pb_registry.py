"""Every cell, configuration and metric of BENCHMARK.json is found by its
name, and the file keeps to the shape the harness reads."""
from __future__ import annotations

import json
import re

import pytest

from portbench.tests import tiny  # noqa: F401  (puts src on the path)
from portbench.lib import cell, family

BENCH = cell.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    n = 24  # the most cells the benchmark may hold
    assert (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_found_by_name(entry):
    wl = cell.workload(entry["name"])
    assert wl["name"] == entry["name"] and wl["config"] == entry["config"]
    assert (cell.BENCH / "drivers" / f"{wl['driver']}.py").exists()
    assert entry["chips"] == 1 and NAME.match(entry["traffic"])
    assert cell.end_to_end(BENCH, entry["name"]) and cell.per_layer(BENCH, entry["name"])
    assert "setup_s" in {m["name"] for m in cell.end_to_end(BENCH, entry["name"])}
    assert set(wl["check"]["limits"]) and all(v > 0 for v in wl["check"]["limits"].values())
    assert wl["cpu_test"] and set(wl["cpu_test"]) <= set(wl) - {"cpu_test"}  # sizes it has


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configuration_found_by_name(entry):
    cfg = cell.config(BENCH, entry["name"])
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert all(k in cfg for k in entry["reduced"])
    assert cfg["compute_dtype"] == "float32" and cfg["tf32"] is False
    assert all(k in cfg for k in cfg["departures"] if k not in ("blocks", "source"))
    assert (family.DIR / f"{cfg['family']}.py").exists()
    family.of(cfg).dims(cfg)  # the run keys ask for what the harness runs
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader_found_by_name(metric):
    assert callable(cell.reader(metric["name"])) and metric["workloads"]
    assert metric["source"] in SOURCES
    for w in metric["workloads"]:
        assert metric["moves"] in {m["name"] for m in cell.end_to_end(BENCH, w)}


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert metric["source"] in {"host_clock", "device_trace"}
    assert 0.01 <= metric["bound"] <= 0.25
    assert metric["better"] in ("lower", "higher")


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(0 < len(x) <= 200 and "\n" not in x for x in layers)
    for path in (cell.BENCH).rglob("*"):
        rel = path.relative_to(cell.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024
