"""The port's spans: profiler ranges at the LM path's layer boundaries that
are on exactly while a torch profiler runs, and cost one flag read
otherwise."""
from __future__ import annotations

import json
import sys
import time

import pytest

torch = pytest.importorskip("torch")

import torch._C._profiler as c_profiler  # noqa: E402
import torch.autograd.profiler as autograd_profiler  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.optim import optimizer as opt_lib  # noqa: E402
from repro_torch.serving.observability import tracing  # noqa: E402

PROGRAM_SPANS = ("model.prefill", "model.decode_step", "attn.decode", "optim.apply_updates")


def _events(path) -> list:
    return json.loads(path.read_text())["traceEvents"]


def _ranges(prof, tmp_path) -> list:
    """(name, start, end) of every program span the profiler recorded,
    from its chrome trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in _events(path)
            if e.get("cat") == "cpu_op" and e["name"] in PROGRAM_SPANS]


def _refuse(*a, **k):
    raise AssertionError("a span reached the profiler or a clock")


@pytest.fixture(scope="module")
def tiny_decode():
    """A 2-layer yi-9b-shaped model on the CPU, prefilled over 6 tokens."""
    m = build_model("yi-9b", reduced=True, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, m.cfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        _, filled = m.prefill(params, {"tokens": tokens})
        cache = m.decode_cache(filled, 16)
    return m, params, cache


def _step(m, params, cache):
    with torch.inference_mode():
        return m.decode_step(params, {"tokens": torch.zeros((2, 1), dtype=torch.long)}, cache, 6)


def test_span_without_a_profiler_is_the_shared_null_object():
    assert not autograd_profiler._is_profiler_enabled
    assert spans.span("attn.decode") is spans.span("model.prefill") is spans._NULL_SPAN
    assert tracing.span is spans.span and tracing._NULL_SPAN is spans._NULL_SPAN
    assert tracing._NullSpan is spans._NullSpan
    with spans.span("model.decode_step") as s:
        assert s is spans._NULL_SPAN


def test_decode_step_without_a_profiler_enters_no_range_and_reads_no_clock(
        tiny_decode, monkeypatch):
    monkeypatch.setattr(c_profiler, "_RecordFunctionFast", _refuse)
    monkeypatch.setattr(autograd_profiler, "record_function", _refuse)
    for clock in ("perf_counter", "perf_counter_ns", "monotonic", "monotonic_ns", "time",
                  "time_ns", "thread_time", "thread_time_ns"):
        monkeypatch.setattr(time, clock, _refuse)
    logits, _ = _step(*tiny_decode)
    assert logits.shape == (2, tiny_decode[0].cfg.vocab_size)


def test_decode_step_under_a_profiler_emits_each_span_nested(tiny_decode, tmp_path):
    m = tiny_decode[0]
    L = m.cfg.num_layers
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # the cheap range, which records only through the host-op callbacks
        assert type(spans.span("x")) is c_profiler._RecordFunctionFast
        _step(*tiny_decode)
    assert not autograd_profiler._is_profiler_enabled
    ranges = _ranges(prof, tmp_path)
    names = [n for n, _, _ in ranges]
    steps = [r for r in ranges if r[0] == "model.decode_step"]
    assert len(steps) == 1 and names.count("attn.decode") == L
    assert sorted(set(names)) == ["attn.decode", "model.decode_step"]
    _, a, b = steps[0]
    assert all(a <= s and e <= b for _, s, e in ranges)


def test_prefill_under_a_profiler_emits_one_prefill_span(tiny_decode, tmp_path):
    m, params, _ = tiny_decode
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.inference_mode():
        m.prefill(params, {"tokens": torch.zeros((2, 4), dtype=torch.long)})
    names = [n for n, _, _ in _ranges(prof, tmp_path)]
    assert names == ["model.prefill"]


def test_apply_updates_emits_one_optimizer_span(tmp_path):
    cfg = opt_lib.AdamWConfig()
    params = {"w": torch.ones(4, 3), "b": {"x": torch.zeros(3)}}
    grads = {"w": torch.full((4, 3), 0.5), "b": {"x": torch.ones(3)}}
    state = opt_lib.init_state(params, cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        opt_lib.apply_updates(params, grads, state, cfg)
    names = [n for n, _, _ in _ranges(prof, tmp_path)]
    assert names == ["optim.apply_updates"]
    assert int(state["step"]) == 1 and not torch.equal(params["w"], torch.ones(4, 3))


def test_tracer_span_records_as_before_and_opens_no_range(tmp_path, monkeypatch):
    tr = tracing.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("decide", trace_id="r000001"):
            with tr.span("dispatch"):
                pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    assert not {"decide", "dispatch"} & {e["name"] for e in _events(path)}
    assert [(s.name, s.parent, s.depth) for s in tr.spans] == [
        ("dispatch", "decide", 1), ("decide", None, 0)]

    monkeypatch.setattr(c_profiler, "_RecordFunctionFast", _refuse)
    monkeypatch.setattr(autograd_profiler, "record_function", _refuse)
    tr.clear()
    with tr.span("retire", trace_id="r000002", load=1.5):
        pass
    (rec,) = tr.spans
    assert (rec.name, rec.trace_id, rec.attrs, rec.parent) == (
        "retire", "r000002", {"load": 1.5}, None)
    assert rec.t_end >= rec.t_start


def test_serve_trace_out_writes_the_models_spans(tmp_path, monkeypatch, capsys):
    out = tmp_path / "sub" / "lm.json"
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "yi-9b", "--device", "cpu", "--requests", "2", "--slots", "2",
        "--prompt-len", "8", "--gen-len", "3", "--trace-out", str(out)])
    serve_mod.main()
    assert f"chrome trace -> {out}" in capsys.readouterr().out
    names = [e["name"] for e in _events(out) if e.get("cat") == "cpu_op"]
    assert names.count("model.decode_step") == 2  # gen-len 3: one prefill token, 2 steps
    assert names.count("model.prefill") == 1
    assert not autograd_profiler._is_profiler_enabled
