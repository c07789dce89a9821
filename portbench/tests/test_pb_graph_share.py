"""The share of decode steps that replayed the port's CUDA graphs
(``decode_graph_share.decode``), and the other span readers beside a
``decode.graph`` span, on synthetic chrome traces of the kind
``lib/trace.traced`` writes with host ops."""
from __future__ import annotations

import pytest

from portbench.tests import tiny  # noqa: F401
from portbench.lib import cell, spans, trace
from portbench.tests.test_pb_spans import _launch, _op, _range, _record, _span


def _graph_steps(graphed: list[bool]):
    """Decode steps 400 us apart, each launching three ops (one inside
    ``attn.decode``); ``graphed`` says which steps opened a ``decode.graph``
    span around their launches (a step that replays the port's CUDA
    graphs)."""
    ev = [_range(trace.TRACE_RANGE, 1000, 400 * len(graphed))]
    for i, g in enumerate(graphed):
        t, c = 1000 + 400 * i, 10 * i
        ev += [_range("decode_step", t, 300), _span("model.decode_step", t + 1, 290),
               _span("attn.decode", t + 40, 40),
               _launch(c + 1, t + 12), _op(c + 1, t + 50, 5),
               _launch(c + 2, t + 45), _op(c + 2, t + 60, 30),
               _launch(c + 3, t + 115), _op(c + 3, t + 120, 40)]
        if g:
            ev.append(_span("decode.graph", t + 5, 270))
    return ev


@pytest.mark.parametrize("graphed,want", [([True] * 4, 100.0), ([False] * 4, 0.0),
                                          ([False, True, True, True], 75.0)],
                         ids=["every-step", "none", "first-step-eager"])
def test_the_graph_share_counts_the_steps_that_replayed(graphed, want, tmp_path, monkeypatch):
    read = cell.reader("decode_graph_share.decode")
    rec = _record(tmp_path, monkeypatch, "yi-9b.decode", _graph_steps(graphed))
    assert read(rec) == want


def test_the_graph_share_finds_nothing_without_a_trace_or_a_graph_path(tmp_path, monkeypatch):
    import importlib.util

    read = cell.reader("decode_graph_share.decode")
    rec = _record(tmp_path, monkeypatch, "yi-9b.decode", None)
    assert read(rec) is None and read(dict(rec, trace=None)) is None
    ev = [_range(trace.TRACE_RANGE, 0, 100), _span("decode.graph", 5, 50),
          _launch(1, 10), _op(1, 20, 5)]
    assert read(_record(tmp_path, monkeypatch, "yi-9b.decode", ev)) is None  # no step
    rec = _record(tmp_path, monkeypatch, "yi-9b.decode", _graph_steps([True, True]))
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name.endswith("decode_graph") else real(name, *a))
    assert read(rec) is None  # a port from before the graph path


@pytest.mark.parametrize("metric", ["decode_attn_ms.decode", "decode_weights_ms.decode",
                                    "moe_ms.decode", "mamba_ms.decode"])
def test_a_graph_span_around_the_replays_moves_no_other_reader(metric, tmp_path, monkeypatch):
    """``decode.graph`` is no span any other reader names: the device time
    under ``attn.decode`` and ``model.decode_step`` stays where it was."""
    read = cell.reader(metric)
    plain = read(_record(tmp_path, monkeypatch, "yi-9b.decode", _graph_steps([False] * 3)))
    graphed = read(_record(tmp_path, monkeypatch, "yi-9b.decode", _graph_steps([True] * 3)))
    assert graphed == plain
    if metric.startswith(("decode_attn", "decode_weights")):
        assert plain == pytest.approx({"decode_attn_ms.decode": 0.03,
                                       "decode_weights_ms.decode": 0.045}[metric], rel=1e-12)
    ev = _graph_steps([True] * 3)
    assert spans.attribute(ev) == spans.attribute(_graph_steps([False] * 3))
