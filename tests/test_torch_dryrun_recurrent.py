"""Rank 0's program of the recurrent blocks in the port's dry-run,
composed per block, against the same program traced whole.

``graph_cost.stack_cost`` traces a block that loops over the sequence
(mamba, sLSTM, mLSTM) at two short lengths and extrapolates it linearly
to the cell's (``graph_cost.extrapolation_lengths``); ``group_peak`` does
the same for the peak live bytes.  That is exact only where every layout
DTensor gives the block's ops is the same at every length: the models run
each recurrence on local tensors (``AxisRules.local``), gather each FSDP
weight before its product (``layers.gathered``), and take and hand on the
block's residual and the router's gradients in fixed layouts.  Two child
processes, under torch's ``fake`` process group on a (2, 4) mesh, run
``launch/dryrun.rank0_cost`` composed and whole (``scan_layers=False``):

- reduced xlstm-350m, four layers, 8 x 32: prefill and a training step
  (sLSTM and mLSTM traced at 3 and 4 positions);
- reduced jamba-1.5-large-398b, 8 x 512: a training step (mamba blocks,
  some with an MoE FFN, traced at 256 and 384 positions, the least with
  two MoE groups on each batch shard).

Every metric of the record must be equal: the collective bytes and counts,
the nodes, the ``FlopCounterMode`` count and the peak live bytes, and each
case extrapolates past both traced lengths.
"""
import json
import os
import subprocess
import sys

import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 900
# (arch, layers or None for the reduced config's, sequence length, kind),
# one tuple of cases per child process
CHILDREN = ((("xlstm-350m", 4, 32, "prefill"), ("xlstm-350m", 4, 32, "train")),
            (("jamba-1.5-large-398b", None, 512, "train"),))
CASES = tuple(c for cases in CHILDREN for c in cases)

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
    """The children's results, in ``CASES`` order: both start at once and
    each has its own time limit."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, "-c", f"CASES = {cases!r}\n" + _CHILD],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cases in CHILDREN]
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=CHILD_TIMEOUT)
            assert p.returncode == 0, stderr[-4000:]
            out += json.loads(stdout.strip().splitlines()[-1])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return out


@pytest.mark.parametrize("i", range(len(CASES)), ids=["-".join(map(str, c)) for c in CASES])
def test_composed_recurrent_program_equals_the_whole_trace(child, i):
    composed, whole = child[i]["composed"], child[i]["whole"]
    keys = set(whole) - {"seconds", "lengths"}
    assert keys == set(composed) - {"seconds", "lengths"}
    assert {k for k in keys if k.startswith("coll:")} >= {"coll:total", "coll:all-gather"}
    assert {k: composed[k] for k in keys} == {k: whole[k] for k in keys}
    assert whole["flop_counter"] > 0 and whole["nodes"] > 0 and whole["temp"] > 0
    # the recurrent blocks are extrapolated, past both traced lengths
    assert composed["lengths"] is not None and CASES[i][2] > max(composed["lengths"])
    assert whole["lengths"] is None
