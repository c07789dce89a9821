"""``decode_proj_roofline.decode``: its reader on synthetic traces, and its
work (``lib/decode_proj.py``) held to what the port's decode step hands the
weight-streaming kernel, on the CPU at tiny widths.

The port's routing is made to see plain CPU tensors as plain CUDA tensors
(``kernels.ops._route`` answers ``"cuda"`` for ``decode_proj``) and the
kernel's wrapper is replaced by the plain version, which records each
launch's weights, rows in and outputs.  A product that fell back to ``@``
would be missing from the record, and the sum would fall short of the
metric's bytes."""
from __future__ import annotations

import pytest
import torch

from portbench.tests import tiny  # noqa: F401  (puts src on the path)
from portbench.tests.test_pb_jamba import config as jamba_config
from portbench.drivers import port
from portbench.lib import cell, cost, decode_proj, family, trace, weights

BENCH = cell.load_benchmark()
TINY = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4, vocab_size=512,
            num_hidden_layers=2)


def _config(name: str) -> dict:
    """The committed configuration at tiny widths."""
    if name == "jamba2-mini":
        return jamba_config()
    kv = {"yi-9b": 2, "stablelm-3b": 4}[name]
    cfg = dict(cell.config(BENCH, name), **TINY, num_key_value_heads=kv)
    cfg.pop("head_dim", None)
    return cfg


def _record(monkeypatch) -> list:
    from repro_torch.kernels import decode_proj as dp
    from repro_torch.kernels import ops, ref

    real = ops._route
    monkeypatch.setattr(ops, "_route", lambda t, what: (
        "cuda" if what == "decode_proj" and type(t) is torch.Tensor else real(t, what)))
    launches = []

    def launch(x, *ws, transposed=False, gated=False):
        ys = ref.decode_proj_ref(x, *ws, transposed=transposed, gated=gated)
        launches.append(cost.F32 * (sum(w.numel() for w in ws) + x.numel()
                                    + sum(y.numel() for y in ys)))
        return ys

    monkeypatch.setattr(dp, "decode_proj_cuda", launch)
    return launches


@pytest.mark.parametrize("rows", [4, 32])
@pytest.mark.parametrize("name", ["yi-9b", "stablelm-3b", "jamba2-mini"])
def test_the_metrics_bytes_are_what_the_decode_step_hands_the_kernel(name, rows, monkeypatch):
    cfg = _config(name)
    fam = family.of(cfg)
    dm = fam.dims(cfg)
    m = port.model(fam, dm, cfg, torch.device("cpu"))
    params = weights.make(fam, dm, 2**33 + 5, "cpu")
    # a prompt of 9 tokens: more rows than the kernel takes at either batch
    tokens = torch.randint(0, dm.vocab, (rows, 10), generator=torch.Generator().manual_seed(6))
    with torch.inference_mode():
        _, filled = m.prefill(params, {"tokens": tokens[:, :9]})
        cache = m.decode_cache(filled, 12)
        launches = _record(monkeypatch)
        m.decode_step(params, {"tokens": tokens[:, 9:]}, cache, 9)
        step = list(launches)
        launches.clear()
        m.prefill(params, {"tokens": tokens[:, :9]})
    flops, nbytes = decode_proj.cost_of(dm, rows)
    assert sum(step) == nbytes
    assert len(step) == 2 * dm.attn_layers + 2 * (dm.layers - getattr(dm, "moe_layers", 0)) + 1
    # a prefill's last launch is its head at the last positions (a short
    # one's experts may go too, each taking at most the kernel's rows)
    assert launches[-1] == decode_proj.cost_of(dm, rows, prefill=True)[1]
    assert len(launches) == 1 or name == "jamba2-mini"
    assert flops < nbytes * cost.PEAK_TF32 / cost.HBM_BW  # bound by bytes


def _proj_trace(n: int, us: float):
    """A device-only trace of ``n`` launches of the kernel, ``us`` each,
    beside a flash-decode launch and a GEMM."""
    ev = [tiny_x("void (anonymous namespace)::decode_proj_kernel<4, false, false>(Params)",
                 1000 + 400 * i, us) for i in range(n)]
    ev += [tiny_x("void decode_attn_kernel<128, 8>(float const*)", 900, 50),
           tiny_x("sm90_xmma_gemm_f32f32", 960, 30)]
    return trace.reduce(ev, 1.0)


def tiny_x(name, ts, dur):
    return {"ph": "X", "name": name, "cat": "kernel", "ts": ts, "dur": dur}


def test_the_reader_divides_the_steps_least_time_by_the_kernels():
    read = cell.reader("decode_proj_roofline.decode")
    dm = family.load("llama").dims(dict(cell.config(BENCH, "yi-9b"), num_hidden_layers=2))
    units = [{"kind": "decode", "rows": 32, "position": 2500},
             {"kind": "decode", "rows": 32, "position": 2501},
             {"kind": "prefill", "rows": 32, "length": 1920}]
    rec = {"dims": dm, "trace": _proj_trace(9, 300), "trace_units": units}
    # 2 layers of yi-9b: 1.39 GB of block weights and 1.05 GB of head a
    # step, and the prefill's head, 5.93 GB in all over 9 x 300 us
    nbytes = 2 * decode_proj.cost_of(dm, 32)[1] + decode_proj.cost_of(dm, 32, prefill=True)[1]
    want = 100.0 * nbytes / cost.HBM_BW / 2700e-6
    assert abs(read(rec) - want) < 1e-9 * want and 65 < want < 66
    # the launch count does not enter: the same device time in 3 launches
    assert abs(read(dict(rec, trace=_proj_trace(3, 900))) - want) < 1e-9 * want


def test_the_reader_finds_nothing_without_a_launch_of_the_kernel():
    read = cell.reader("decode_proj_roofline.decode")
    dm = family.load("llama").dims(cell.config(BENCH, "yi-9b"))
    rec = {"dims": dm, "trace": _proj_trace(0, 0),
           "trace_units": [{"kind": "decode", "rows": 32, "position": 2500}]}
    assert read(rec) is None  # a port without the kernel (the parent)
    assert read(dict(rec, trace=None)) is None
