"""The port's serving stats CLI against the JAX package's.

The stats cases of ``tests/test_observability.py`` run on the port's
``launch/stats.py``; then both packages' ``render`` give the same string
for the same samples and metrics snapshot (a seeded virtual-time replay
with faults, breakers and a drift refinement in it), and both CLIs print
the same report for the same files, a truncated trailing line included.
"""
import json

import pytest

from repro.launch import stats as jstats
from repro.serving import FaultPlan as JaxFaultPlan
from repro.serving import FaultSpec as JaxFaultSpec
from repro.serving import MetricsRegistry as JaxMetricsRegistry
from repro.serving import TelemetryLog as JaxTelemetryLog
from repro.serving import traces as jtr
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
from repro_torch.launch import stats
from repro_torch.launch.stats import read_telemetry, render
from repro_torch.serving import (FaultPlan, FaultSpec, MetricsRegistry,
                                 TelemetryLog, TelemetrySample)
from repro_torch.serving.traces import (TraceConfig, generate_trace,
                                        simulate_trace)


def _samples():
    return [TelemetrySample(
        seq=i, tenant="acme", workload="vecadd", key="k",
        backend="host-sync", partitions=1, tasks=2, cache_hit=i > 0,
        predicted_s=1e-3, measured_s=1.1e-3, rel_error=0.1,
        latency_s=2e-3, trace_id=f"r{i:06d}") for i in range(3)]


def test_stats_render_smoke():
    m = MetricsRegistry()
    m.counter("serving.requests").inc(3)
    m.histogram("serving.stage.decide.seconds").observe(1e-4)
    out = render(_samples(), m.snapshot())
    assert "requests 3" in out
    assert "hit_rate 0.67" in out
    assert "p95" in out
    assert "serving.requests" in out
    assert "serving.stage.decide.seconds" in out
    assert out == jstats.render(_samples(), m.snapshot())


def test_stats_render_empty_samples():
    out = render([])
    assert "no retired requests" in out
    assert out == jstats.render([])


CFG = dict(n_requests=1500, seed=4, arrival="bursty",
           burst_rate_rps=2600.0)
FAULTS = dict(site="dispatch", every=97, times=6)


def _replay(tmp_path):
    """One seeded replay per package, each with its telemetry file and
    metrics snapshot; the two must agree before they are rendered."""
    log = TelemetryLog(str(tmp_path / "port.jsonl"))
    jlog = JaxTelemetryLog(str(tmp_path / "jax.jsonl"))
    m, jm = MetricsRegistry(), JaxMetricsRegistry()
    m.gauge("serving.breaker.state", tenant="acme", stage="dispatch").set(2)
    jm.gauge("serving.breaker.state", tenant="acme", stage="dispatch").set(2)
    report = simulate_trace(
        generate_trace(TraceConfig(**CFG)), policy="deadline", seed=4,
        drift_injections=[(0.5, "vecadd", 5.0)], telemetry=log, metrics=m,
        faults=FaultPlan([FaultSpec(**FAULTS)]))
    jreport = jtr.simulate_trace(
        jtr.generate_trace(jtr.TraceConfig(**CFG)), policy="deadline",
        seed=4, drift_injections=[(0.5, "vecadd", 5.0)], telemetry=jlog,
        metrics=jm, faults=JaxFaultPlan([JaxFaultSpec(**FAULTS)]))
    log.close()
    jlog.close()
    assert report == jreport
    assert report["failed"] == 6
    assert m.snapshot() == jm.snapshot()
    return log, jlog, m, jm


def test_render_identical_on_a_replay(tmp_path):
    log, jlog, m, jm = _replay(tmp_path)
    out = render(list(log), m.snapshot())
    assert out == jstats.render(list(jlog), jm.snapshot())
    assert "== resilience ==" in out and "breaker" in out
    assert "failed 6" in out


def test_read_telemetry_cross_reads_and_skips_truncated_tail(tmp_path):
    log, jlog, _, _ = _replay(tmp_path)
    path = tmp_path / "port.jsonl"
    full = path.read_text()
    path.write_text(full + full.splitlines()[0][:40])   # mid-append
    port = read_telemetry(str(path))
    assert len(port) == len(list(log))
    assert [vars(s) for s in port] == \
        [vars(s) for s in jstats.read_telemetry(str(path))]
    assert [vars(s) for s in read_telemetry(str(tmp_path / "jax.jsonl"))] \
        == [vars(s) for s in jlog]


def test_cli_prints_the_same_report(tmp_path, capsys):
    _, _, m, _ = _replay(tmp_path)
    m.save(str(tmp_path / "metrics.json"))
    argv = ["--telemetry", str(tmp_path / "port.jsonl"),
            "--metrics", str(tmp_path / "metrics.json")]
    stats.main(argv)
    port = capsys.readouterr().out
    jstats.main(argv)
    assert port == capsys.readouterr().out
    assert port.startswith("== serving telemetry ==")
    json.loads((tmp_path / "metrics.json").read_text())


def test_cli_requires_an_input():
    with pytest.raises(SystemExit):
        stats.main([])
