"""Device time put down to the program's spans, on a synthetic chrome
trace of the kind ``lib/trace.traced`` writes with host ops."""
from __future__ import annotations

import json

import pytest

from portbench.tests import tiny  # noqa: F401
from portbench import span_cost
from portbench.lib import cell, spans, trace

MAIN, OTHER = (7, 7), (7, 9)  # (pid, tid) of the host threads
DEVICE = (0, 3)


def _range(name, ts, dur, thread=MAIN):
    """A harness range (``record_function``)."""
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "pid": thread[0], "tid": thread[1]}


def _span(name, ts, dur, thread=MAIN):
    """A program span or a host op (``cpu_op``)."""
    return dict(_range(name, ts, dur, thread), cat="cpu_op")


def _launch(corr, ts, thread=MAIN, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": ts, "dur": 2,
            "pid": thread[0], "tid": thread[1], "args": {"correlation": corr}}


def _op(corr, ts, dur, cat="kernel", name="void k()"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": DEVICE[0], "tid": DEVICE[1], "args": {"correlation": corr}}


def _decode_steps():
    """Two decode steps inside the traced range: in each, two launches in
    ``attn.decode`` (one a copy), four in ``model.decode_step`` outside it
    (one inside a host op, one a memset, one through the driver API); the
    harness launches one more outside every program span."""
    ev = [_range(trace.TRACE_RANGE, 1000, 1000)]
    for i, t in enumerate((1000, 1400)):
        c = 10 * i
        ev += [_range("decode_step", t, 300), _span("model.decode_step", t + 1, 290),
               _span("aten::mm", t + 10, 5), _span("attn.decode", t + 40, 40),
               _launch(c + 1, t + 12), _op(c + 1, t + 50, 5),
               _launch(c + 2, t + 45), _op(c + 2, t + 60, 30),
               _launch(c + 3, t + 70), _op(c + 3, t + 95, 11, cat="gpu_memcpy"),
               _launch(c + 4, t + 115), _op(c + 4, t + 120, 40),
               _launch(c + 5, t + 150), _op(c + 5, t + 170, 3, cat="gpu_memset"),
               _launch(c + 6, t + 205, cat="cuda_driver"), _op(c + 6, t + 230, 7),
               _launch(c + 7, t + 295), _op(c + 7, t + 300, 2)]
    return ev


def test_kernels_go_to_the_innermost_span_through_their_launch():
    a = spans.attribute(_decode_steps())
    assert a["count"] == {"model.decode_step": 2, "attn.decode": 2}
    # the copy launched in attn.decode ran after the host had left it
    assert a["device_s"] == pytest.approx({"attn.decode": 82e-6,
                                           "model.decode_step": 110e-6}, abs=1e-15)
    assert a["unattributed_s"] == pytest.approx(4e-6, abs=1e-15)


def test_harness_ranges_and_host_ops_are_not_program_spans():
    ev = [_range(trace.TRACE_RANGE, 0, 100), _range("model.decode_step", 10, 50),
          _span("aten::mm", 10, 50), _launch(1, 20), _op(1, 30, 5)]
    a = spans.attribute(ev)
    assert a["device_s"] == {} and a["count"] == {}
    assert a["unattributed_s"] == pytest.approx(5e-6, abs=1e-15)


def test_a_launch_on_another_thread_is_not_the_main_threads():
    ev = [_range(trace.TRACE_RANGE, 0, 100), _span("optim.apply_updates", 10, 50),
          _launch(1, 20), _op(1, 30, 5),
          _launch(2, 25, thread=OTHER), _op(2, 40, 9),
          _span("attn.decode", 0, 100, thread=OTHER), _launch(3, 30, thread=OTHER),
          _op(3, 50, 4)]
    a = spans.attribute(ev)
    assert a["device_s"] == pytest.approx({"optim.apply_updates": 5e-6,
                                           "attn.decode": 13e-6}, abs=1e-15)
    assert a["unattributed_s"] == 0.0


def test_only_the_traced_range_counts():
    ev = _decode_steps() + [
        _span("model.decode_step", 2500, 100), _span("attn.decode", 2510, 50),
        _launch(99, 2520), _op(99, 2530, 1000),        # after the range
        _launch(98, 990), _op(98, 995, 77)]            # before it
    a = spans.attribute(ev)
    assert a["count"]["model.decode_step"] == 2
    assert a["device_s"]["attn.decode"] == pytest.approx(82e-6, abs=1e-15)
    assert a["unattributed_s"] == pytest.approx(4e-6, abs=1e-15)
    assert spans.attribute([e for e in ev if e["name"] != trace.TRACE_RANGE]) is None
    assert spans.attribute([e for e in ev if e["cat"] not in trace.DEVICE_CATS]) is None


def _record(tmp_path, monkeypatch, name, events):
    """A traced record of the cell ``name`` whose host-ops trace holds
    ``events`` (None: no file)."""
    monkeypatch.setattr(cell, "BENCH", tmp_path)
    if events is not None:
        (tmp_path / "out").mkdir(exist_ok=True)
        (tmp_path / "out" / f"{name}.host.json").write_text(
            json.dumps({"traceEvents": events}))
    return {"workload": {"name": name}, "trace": {"busy_s": 1.0, "window_s": 1.0}}


def test_the_decode_readers_divide_by_the_steps_exactly(tmp_path, monkeypatch):
    attn = cell.reader("decode_attn_ms.decode")
    weights = cell.reader("decode_weights_ms.decode")
    rec = _record(tmp_path, monkeypatch, "yi-9b.decode", _decode_steps())
    d = spans.attribute(_decode_steps())["device_s"]
    assert attn(rec) == 1e3 * d["attn.decode"] / 2 == pytest.approx(0.041, rel=1e-12)
    assert weights(rec) == 1e3 * d["model.decode_step"] / 2 == pytest.approx(0.055, rel=1e-12)


def test_the_optimizer_reader_divides_by_its_spans_exactly(tmp_path, monkeypatch):
    read = cell.reader("optimizer_ms.train")
    ev = [_range(trace.TRACE_RANGE, 0, 1000)]
    for i, t in enumerate((0, 500)):
        ev += [_range("train_step", t, 400), _span("optim.apply_updates", t + 300, 90),
               _launch(2 * i, t + 310), _op(2 * i, t + 320, 60),
               _launch(2 * i + 1, t + 10), _op(2 * i + 1, t + 20, 200)]
    rec = _record(tmp_path, monkeypatch, "stablelm-3b.train", ev)
    d = spans.attribute(ev)["device_s"]
    assert read(rec) == 1e3 * d["optim.apply_updates"] / 2 == pytest.approx(0.06, rel=1e-12)


@pytest.mark.parametrize("metric,cell_name", [("decode_attn_ms.decode", "yi-9b.decode"),
                                              ("decode_weights_ms.decode", "yi-9b.decode"),
                                              ("optimizer_ms.train", "stablelm-3b.train")])
def test_each_reader_finds_nothing_without_its_spans(metric, cell_name, tmp_path,
                                                     monkeypatch):
    read = cell.reader(metric)
    rec = _record(tmp_path, monkeypatch, cell_name, None)
    assert read(rec) is None                       # traced, but no file
    assert read(dict(rec, trace=None)) is None     # not traced
    # a trace whose device ops lie under no model.decode_step or
    # optim.apply_updates span: a program that opens no spans
    ev = [_range(trace.TRACE_RANGE, 0, 100), _range("decode_step", 0, 50),
          _range("train_step", 50, 50), _launch(1, 10), _op(1, 20, 5)]
    rec = _record(tmp_path, monkeypatch, cell_name, ev)
    assert read(rec) is None


def test_the_new_metrics_are_in_the_benchmark():
    bench = cell.load_benchmark()
    by_name = {m["name"]: m for m in bench["per_layer"]}
    want = {"decode_attn_ms.decode": ("yi-9b.decode", "output_tokens_per_s"),
            "decode_weights_ms.decode": ("yi-9b.decode", "output_tokens_per_s"),
            "optimizer_ms.train": ("stablelm-3b.train", "train_tokens_per_s")}
    for name, (w, moves) in want.items():
        m = by_name[name]
        assert w in m["workloads"]
        assert (m["moves"], m["unit"], m["better"], m["source"]) == (
            moves, "ms", "lower", "device_trace")


def test_the_cost_measurement_runs_at_the_tests_size():
    out = span_cost.cost(tiny=True, stretches=1, steps=2)
    assert out["device"] == "cpu" and set(out["modes"]) == set(span_cost.MODES)
    assert out["spans"]
    assert all(len(m["host_ms"]) == len(m["span_us"]) == 1 and m["wall_ms_median"] > 0
               for m in out["modes"].values())
