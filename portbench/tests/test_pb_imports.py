"""What a run loads, in a fresh process: a run of every cell (small, on the
CPU) loads neither JAX nor the JAX package, and the reference loads nothing
of the port.  Top-level names are compared whole: ``repro_torch`` begins
with ``repro`` and is not it."""
from __future__ import annotations

import json
import os
import subprocess
import sys

from portbench.tests import tiny

RUN_ALL = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from portbench.tests import tiny
from portbench.lib import cell
from portbench import run
for name in ("yi-9b.decode", "yi-9b.prefill", "stablelm-3b.train"):
    res, _ = tiny.run(name, tiny.workload(name), tiny.config())
    assert res["correct"], (name, res)
for m in cell.load_benchmark()["per_layer"]:
    cell.reader(m["name"])
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""

REFERENCE_ONLY = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import portbench.reference.model, portbench.reference.train
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""


def _top_level_modules(code: str) -> set:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)  # only what the code puts on the path
    out = subprocess.run([sys.executable, "-c", code.format(root=str(tiny.ROOT),
                                                            src=str(tiny.ROOT / "src"))],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    mods = _top_level_modules(RUN_ALL)
    assert "repro_torch" in mods and "portbench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_port():
    mods = _top_level_modules(REFERENCE_ONLY)
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_the_forbidden_names_are_whole_names():
    from portbench import run

    assert run.loaded_forbidden(["repro_torch.models", "reprox", "torch"]) == []
    assert run.loaded_forbidden(["repro.core.streams", "jaxlib.xla", "flax"]) == [
        "flax", "jaxlib", "repro"]


def test_without_a_card_a_run_prints_no_result():
    """Here there is no CUDA card: the command exits non-zero, silent on
    standard output."""
    out = subprocess.run([sys.executable, str(tiny.ROOT / "portbench" / "run.py"), "--workload",
                          "yi-9b.decode", "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tiny.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
