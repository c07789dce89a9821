"""Finding a cell's files by name, and the seeds drawn from ``--seed``.

A cell of ``BENCHMARK.json`` names its configuration and traffic; the
traffic is ``workloads/<cell>.json`` (its ``driver`` names the kind,
``drivers/<driver>.py``), the configuration is the file its entry names,
and each per-layer metric is read by ``metrics/<metric>.py``.  Nothing here
imports the port.
"""
from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def workload(name: str) -> dict:
    return json.loads((BENCH / "workloads" / f"{name}.json").read_text())


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(bench: dict, cell: str) -> list[dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in bench["end_to_end"] if _listed(m, cell)]


def per_layer(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics this cell reports: those that list it."""
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def driver(kind: str):
    """The module ``drivers/<kind>.py``."""
    return importlib.import_module(f"portbench.drivers.{kind}")


def reader(metric: str):
    """``read`` of ``metrics/<metric>.py``: ``read(record) -> float | None``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def derive(seed: int, *keys) -> int:
    """A 63-bit seed for one use of the run's seed (weights, a batch's
    tokens, the sample of requests checked): the same ``seed`` and keys
    give the same number on every machine."""
    text = repr((int(seed),) + tuple(keys)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1
