"""The reduction of a profiler trace and the readers that use it, on a
synthetic chrome trace."""
from __future__ import annotations

from portbench.tests import tiny  # noqa: F401
from portbench.lib import cell, cost, trace
from portbench.lib.dims import dims


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _x(trace.TRACE_RANGE, "user_annotation", 1000, 100),
    _x("prefill", "user_annotation", 1000, 50),
    _x("aten::mm", "cpu_op", 1002, 10),
    _x("void flash_fwd_kernel<float, 128>(float const*)", "kernel", 1010, 20),
    _x("sm90_xmma_gemm_f32f32", "kernel", 1020, 15),    # overlaps the first: busy once
    _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 1060, 10),
    _x("decode_step", "user_annotation", 1052, 45),
    _x("aten::einsum", "cpu_op", 1075, 20),
    _x("void flash_fwd_kernel<float, 128>(float const*)", "kernel", 1080, 10),
    _x("ampere_sgemm", "kernel", 1200, 10),              # after the window
]


def test_busy_window_and_gaps():
    t = trace.reduce(EVENTS, 1.0)
    assert t["window_s"] == 100e-6
    assert abs(t["busy_s"] - (25 + 10 + 10) * 1e-6) < 1e-12
    gaps = dict(trace.top(t["gaps"]))
    # idle: 1000-1010 (prefill, aten::mm), 1035-1060 (prefill), 1070-1080
    # (decode_step/aten::einsum), 1090-1100 (decode_step/aten::einsum)
    assert abs(gaps["prefill/aten::mm"] - 10e-6) < 1e-12
    assert abs(gaps["prefill/host"] - 25e-6) < 1e-12
    assert abs(gaps["decode_step/aten::einsum"] - 20e-6) < 1e-12
    b = trace.breakdown(t)
    ops = dict(b["device_ops"])
    assert b["device_ops"][0][0] == "flash_fwd_kernel" and abs(ops["flash_fwd_kernel"] - 30e-6) < 1e-12
    assert abs(ops["Memcpy DtoD"] - 10e-6) < 1e-12
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_a_device_only_trace_takes_its_window_from_the_host_clock():
    dev = [e for e in EVENTS if e["cat"] in trace.DEVICE_CATS]
    t = trace.reduce(dev, 100e-6)
    assert abs(t["window_s"] - 100e-6) < 1e-15 and t["gaps"] == []
    assert abs(t["busy_s"] - 45e-6) < 1e-12  # the sgemm at 1200 is past the window
    assert [n for n, _, _ in t["ops"]].count("ampere_sgemm") == 0


def test_kernel_roofline_reads_only_a_matching_count():
    bench = cell.load_benchmark()
    dm = dims(cell.config(bench, "yi-9b"))
    read = cell.reader("flash_fwd_roofline.prefill")
    rec = {"dims": dm, "trace": trace.reduce(EVENTS, 1.0),
           "trace_units": [{"kind": "prefill", "rows": 1, "length": 64}]}
    assert read(rec) is None  # 2 launches where 48 layers make 48
    rec["trace_units"] = []
    assert read(rec) is None
    rec["trace"] = None
    assert read(rec) is None
    one = dims(dict(cell.config(bench, "yi-9b"), num_hidden_layers=2))
    rec = {"dims": one, "trace": trace.reduce(EVENTS, 1.0),
           "trace_units": [{"kind": "prefill", "rows": 1, "length": 64}]}
    want = 2 * cost.roofline_s(*cost.flash_fwd(1, 64, 64, 32, 4, 128)) / 30e-6 * 100
    assert abs(read(rec) - want) < 1e-9 * want


def test_idle_share_is_the_unbusy_percent():
    rec = {"trace": trace.reduce(EVENTS, 1.0)}
    assert abs(cell.reader("idle_share.prefill")(rec) - 55.0) < 1e-9
    assert cell.reader("idle_share.train")({"trace": None}) is None
