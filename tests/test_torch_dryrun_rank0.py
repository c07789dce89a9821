"""Rank 0's program in the port's dry-run, composed per block, against the
same program traced whole.

``launch/dryrun.rank0_cost`` composes rank 0's DTensor program of a cell
from traces of short stacks (``graph_cost.stack_cost`` for what adds up over
the nodes, ``graph_cost.group_peak`` for the peak live bytes); under
``--no-scan`` (``scan_layers=False``) it traces the whole unrolled step.
One child process, under torch's ``fake`` process group on a (2, 4) mesh,
runs both for reduced models deep enough that every composition has
something to extrapolate (four layers of yi-9b, so four pattern groups;
three of grok), for prefill, a training step (AdamW under remat, the
dry-run's train cell) and decode, and for jamba's decode and its prefill
(mamba blocks traced at 256 and 384 positions, extrapolated to 512).
Every metric of the record must be equal: the collective bytes and counts,
the nodes, the ``FlopCounterMode`` count and the peak live bytes.  Every
case that extrapolates does so to a length past both traced lengths.

The recurrent blocks' prefill and training cases of xLSTM and jamba's
training step are in ``tests/test_torch_dryrun_recurrent.py`` (children of
their own, so xdist puts them on another worker).
"""
import json
import os
import subprocess
import sys

import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 600
# (arch, layers or None for the reduced config's, sequence length, kind)
CASES = (("yi-9b", 4, 16, "prefill"), ("yi-9b", 4, 16, "train"), ("yi-9b", 4, 16, "decode"),
         ("grok-1-314b", 3, 16, "prefill"), ("grok-1-314b", 3, 16, "train"),
         ("grok-1-314b", 3, 16, "decode"),
         ("jamba-1.5-large-398b", None, 512, "prefill"),
         ("jamba-1.5-large-398b", None, 256, "decode"),
         ("xlstm-350m", 4, 32, "decode"))

_CHILD = r"""
import dataclasses, json
from repro_torch.configs.base import InputShape, get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh

dryrun.ensure_world(8)
mesh = make_test_mesh(2, 4, device="cpu")
out = []
for arch, layers, seq, kind in CASES:
    cfg = get_arch(arch).reduced()
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    shape = InputShape(kind, seq, 8, kind)
    opts = dryrun.DryRunOptions(q_block=16, kv_block=16)
    composed = dryrun.rank0_cost(arch, shape, mesh, opts, cfg=cfg)
    whole = dryrun.rank0_cost(arch, shape, mesh, dataclasses.replace(opts, scan_layers=False),
                              cfg=cfg)
    out.append({"composed": composed, "whole": whole})
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def child():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", f"CASES = {CASES!r}\n" + _CHILD], env=env,
                       capture_output=True, text=True, timeout=CHILD_TIMEOUT)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("i", range(len(CASES)), ids=["-".join(map(str, c)) for c in CASES])
def test_composed_rank0_program_equals_the_whole_trace(child, i):
    composed, whole = child[i]["composed"], child[i]["whole"]
    keys = set(whole) - {"seconds", "lengths"}
    assert keys == set(composed) - {"seconds", "lengths"}
    assert {k for k in keys if k.startswith("coll:")} >= {"coll:total", "coll:all-gather"}
    assert {k: composed[k] for k in keys} == {k: whole[k] for k in keys}
    assert whole["flop_counter"] > 0 and whole["nodes"] > 0 and whole["temp"] > 0
    # jamba's prefill is the one case whose mamba blocks are extrapolated,
    # and past both traced lengths
    assert (composed["lengths"] is not None) == (CASES[i][0].startswith("jamba")
                                                 and CASES[i][3] == "prefill")
    assert composed["lengths"] is None or CASES[i][2] > max(composed["lengths"])
