"""The port's serving observability (``repro_torch.serving.observability``:
span tracing, the metrics registry, the empty-window telemetry contract,
one clock everywhere) against the JAX package's, on the CPU.

Every case of ``tests/test_observability.py`` runs here as one scenario
on both packages (the port's schedulers with ``device="cpu"``): the JAX
case's own assertions hold for each, and where the outcome does not
depend on wall-clock time (spans under a virtual clock, exports, metric
snapshots of the virtual-time harness, counts) the two packages must give
the same result.
"""
import json
import types

import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none

import repro.launch.stats as jstats
import repro.serving as jserving
import repro.serving.clock as jclock
import repro.serving.observability.metrics as jmetrics
import repro.serving.observability.tracing as jtracing
import repro.serving.telemetry as jtelemetry
import repro.serving.traces as jtraces
import repro_torch.launch.stats as tstats
import repro_torch.serving as tserving
import repro_torch.serving.clock as tclock
import repro_torch.serving.observability.metrics as tmetrics
import repro_torch.serving.observability.tracing as ttracing
import repro_torch.serving.telemetry as ttelemetry
import repro_torch.serving.traces as ttraces


def _pkg(name, serving, clock, metrics, tracing, telemetry, traces, stats, kw):
    return types.SimpleNamespace(name=name, s=serving, VirtualClock=clock.VirtualClock,
                                 metrics=metrics, tracing=tracing, telemetry=telemetry,
                                 traces=traces, render=stats.render, kw=kw)


JAX = _pkg("jax", jserving, jclock, jmetrics, jtracing, jtelemetry, jtraces, jstats, {})
PORT = _pkg("port", tserving, tclock, tmetrics, ttracing, ttelemetry, ttraces, tstats,
            {"device": "cpu"})
PKGS = (JAX, PORT)
BY_PKG = pytest.mark.parametrize("p", PKGS, ids=lambda p: p.name)


def _both(scenario):
    """Run ``scenario(pkg)`` on both packages and require equal results."""
    jax_out, port_out = (scenario(p) for p in PKGS)
    assert port_out == jax_out
    return port_out


def _sched(p, model=None, **kw):
    kw.setdefault("telemetry", p.s.TelemetryLog())
    kw.setdefault("keep_outputs", False)
    return p.s.AdaptiveScheduler(model or p.s.OverlapHeuristicModel(), **p.kw, **kw)


def _spans(tr):
    return [s.to_json() for s in tr.spans]


# -- span tracing ------------------------------------------------------------


def test_spans_nest_under_virtual_clock():
    def run(p):
        clock = p.VirtualClock()
        tr = p.s.Tracer(clock)
        with tr.span("retire", trace_id="r000000"):
            clock.advance(1.0)
            with tr.span("refine", trace_id="r000000", key="k"):
                clock.advance(2.0)
            clock.advance(0.5)
        inner, outer = tr.spans
        assert inner.name == "refine" and outer.name == "retire"
        assert inner.parent == "retire" and inner.depth == 1
        assert outer.parent is None and outer.depth == 0
        assert inner.t_start == 1.0 and inner.t_end == 3.0
        assert outer.t_start == 0.0 and outer.t_end == 3.5
        assert inner.duration_s == pytest.approx(2.0)
        assert inner.attrs == {"key": "k"}
        return [(s.name, s.parent, s.depth, s.t_start, s.t_end, s.attrs) for s in tr.spans]
    _both(run)


def test_stage_of_rollup():
    def run(p):
        out = [p.tracing.stage_of(n) for n in ("tune.cold.batch", "decide", "custom")]
        assert out == ["tune", "decide", "custom"]
        return out
    _both(run)


def test_aggregate_skips_nested_spans():
    def run(p):
        tr = p.s.Tracer(p.VirtualClock())
        tr.record("retire", 0.0, 3.0, trace_id="a")
        tr.record("refine", 1.0, 2.0, trace_id="a")
        with tr.span("decide"):
            with tr.span("tune.cold"):
                pass
        agg = p.s.aggregate_stage_times(tr.spans)
        assert agg["retire"]["wall_s"] == pytest.approx(3.0)
        assert agg["refine"]["count"] == 1
        assert agg["tune"]["count"] == 0
        assert agg["dispatch"] == {"wall_s": 0.0, "count": 0, "mean_s": None}
        return agg
    _both(run)


def test_trace_ids_survive_out_of_order_retirement():
    def run(p):
        tr = p.s.Tracer()
        sched = p.s.ConcurrentScheduler(p.s.OverlapHeuristicModel(), window=3, tracer=tr,
                                        telemetry=p.s.TelemetryLog(), keep_outputs=False,
                                        **p.kw)
        trace = p.s.make_trace(["vecadd", "dotprod"], occurrences=3)
        with sched:
            submitted = [sched.submit(r).trace_id for r in trace]
            results = sched.run()
        assert submitted == [f"r{i:06d}" for i in range(len(trace))]
        for r in results:
            assert r.sample.trace_id == r.request.trace_id
        assert {s.trace_id for s in sched.telemetry} == set(submitted)
        assert {s.trace_id for s in tr.spans if s.trace_id} == set(submitted)
        return submitted, sorted((r.request.trace_id, r.request.workload) for r in results)
    _both(run)


def test_chrome_export_is_valid_trace_event_json(tmp_path):
    def run(p):
        clock = p.VirtualClock()
        tr = p.s.Tracer(clock)
        with tr.span("decide", trace_id="r000000", tenant="acme"):
            clock.advance(0.25)
        tr.record("dispatch", 0.25, 0.75, trace_id="r000000", tid=1)
        path = tmp_path / f"{p.name}.json"
        assert tr.export_chrome(str(path)) == 2
        doc = json.loads(path.read_text())
        events = doc["traceEvents"]
        xs = [e for e in events if e["ph"] == "X"]
        assert len(xs) == 2
        for e in xs:
            assert set(e) >= {"name", "cat", "ph", "ts", "dur", "pid", "tid"}
            assert e["ts"] >= 0 and e["dur"] >= 0
        assert xs[0]["args"]["trace_id"] == "r000000"
        assert {e["tid"] for e in xs} == {0, 1}
        assert events[0]["ph"] == "M"
        return [{k: v for k, v in e.items() if k != "pid"} for e in events]
    _both(run)      # the same trace events, the process id aside


def test_jsonl_export_roundtrip(tmp_path):
    def run(p):
        tr = p.s.Tracer(p.VirtualClock())
        tr.record("retire", 1.0, 2.0, trace_id="r000003", load=1.5)
        path = tmp_path / f"{p.name}.jsonl"
        assert tr.export_jsonl(str(path)) == 1
        d = json.loads(path.read_text().strip())
        assert d == {"name": "retire", "t_start": 1.0, "t_end": 2.0, "tid": 0,
                     "trace_id": "r000003", "attrs": {"load": 1.5}}
        return path.read_text()
    _both(run)


@BY_PKG
def test_null_tracer_is_shared_noop(p):
    s1 = p.s.NULL_TRACER.span("decide", trace_id="r000000", tenant="a")
    s2 = p.s.NULL_TRACER.span("dispatch")
    assert s1 is s2 is p.tracing._NULL_SPAN
    with s1:
        pass
    p.s.NULL_TRACER.record("retire", 0.0, 1.0)
    assert len(p.s.NULL_TRACER) == 0 and p.s.NULL_TRACER.spans == []
    assert not p.s.NULL_TRACER.enabled


@BY_PKG
def test_scheduler_never_mutates_null_singletons(p):
    sched = _sched(p, clock=p.VirtualClock())
    assert sched.tracer is p.s.NULL_TRACER
    assert sched.metrics is p.s.NULL_METRICS
    assert p.s.NULL_TRACER.clock is None


# -- metrics registry --------------------------------------------------------


@BY_PKG
def test_null_metrics_shared_instrument(p):
    c = p.s.NULL_METRICS.counter("serving.requests")
    g = p.s.NULL_METRICS.gauge("serving.queue.depth", tenant="acme")
    h = p.s.NULL_METRICS.histogram("serving.stage.decide.seconds")
    assert c is g is h is p.metrics._NULL_INSTRUMENT
    c.inc()
    g.set(3)
    h.observe(0.1)
    assert p.s.NULL_METRICS.snapshot() == {}
    assert not p.s.NULL_METRICS.enabled


@BY_PKG
def test_registry_get_or_create_and_kind_confusion(p):
    m = p.s.MetricsRegistry()
    a = m.counter("serving.requests")
    assert m.counter("serving.requests") is a
    b = m.counter("serving.cache.hit", namespace="acme")
    assert m.counter("serving.cache.hit", namespace="globex") is not b
    with pytest.raises(TypeError):
        m.gauge("serving.requests")


def test_histogram_buckets_and_stats():
    def run(p):
        h = p.metrics.Histogram(buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05, 0.5, 5.0):
            h.observe(v)
        snap = h.snapshot()
        assert snap["count"] == 4 and snap["sum"] == pytest.approx(5.555)
        assert snap["min"] == 0.005 and snap["max"] == 5.0
        assert snap["buckets"] == {"0.01": 1, "0.1": 1, "1.0": 1, "+Inf": 1}
        return snap
    _both(run)


def test_prometheus_text_format():
    def run(p):
        m = p.s.MetricsRegistry()
        m.counter("serving.requests").inc(3)
        m.counter("serving.cache.hit", namespace="acme").inc()
        m.histogram("serving.stage.decide.seconds", buckets=(0.1, 1.0)).observe(0.05)
        text = m.to_prometheus()
        assert "# TYPE serving_requests counter" in text
        assert "serving_requests 3" in text
        assert 'serving_cache_hit{namespace="acme"} 1' in text
        assert 'serving_stage_decide_seconds_bucket{le="0.1"} 1' in text
        assert 'serving_stage_decide_seconds_bucket{le="+Inf"} 1' in text
        assert "serving_stage_decide_seconds_count 1" in text
        return text
    _both(run)      # the same exposition text


def test_metrics_snapshot_deterministic_across_replays():
    def run(p):
        def once():
            m = p.s.MetricsRegistry()
            tr = p.s.Tracer()
            cfg = p.traces.TraceConfig(n_requests=400, seed=7,
                                       workloads=("vecadd", "dotprod"), arrival="bursty")
            report = p.traces.simulate_trace(p.traces.generate_trace(cfg), policy="deadline",
                                             seed=7, tracer=tr, metrics=m)
            return report, m.snapshot(), _spans(tr)

        (r1, snap1, spans1), (_, snap2, spans2) = once(), once()
        assert snap1 == snap2 and spans1 == spans2
        assert snap1["serving.requests"]["values"][0]["value"] == r1["completed"]
        assert snap1["serving.queue.shed"]["values"][0]["value"] == r1["shed"]
        hit = snap1["serving.cache.hit"]["values"][0]["value"]
        miss = snap1["serving.cache.miss"]["values"][0]["value"]
        assert hit + miss == r1["completed"] and miss == r1["cold_misses"]
        return r1, snap1, spans1
    _both(run)      # the JAX package's report, snapshot and spans


def test_sim_spans_cover_stages_and_clock_is_virtual():
    def run(p):
        tr = p.s.Tracer()
        cfg = p.traces.TraceConfig(n_requests=50, seed=1, workloads=("vecadd",),
                                   slo_choices=None)
        p.traces.simulate_trace(p.traces.generate_trace(cfg), policy="fifo", tracer=tr)
        names = {p.tracing.stage_of(s.name) for s in tr.spans}
        assert {"decide", "tune", "dispatch", "retire"} <= names
        assert all(0.0 <= s.t_start <= s.t_end < 1e4 for s in tr.spans)
        return _spans(tr)
    _both(run)


# -- telemetry empty-window contract -----------------------------------------


@BY_PKG
def test_percentile_empty_raises_typed(p):
    with pytest.raises(p.telemetry.EmptyWindowError) as ei:
        p.telemetry.percentile([], 0.5)
    assert "empty window" in str(ei.value)
    assert isinstance(ei.value, ValueError)


def test_latency_stats_and_summary_empty_return_none():
    def run(p):
        assert p.telemetry.latency_stats([]) is None
        s = p.s.TelemetryLog().summary()
        assert s["requests"] == 0 and s["latency"] is None
        assert s["hit_rate"] == 0.0 and s["slo_violation_rate"] is None
        assert s["mean_rel_error"] is None and s["per_tenant"] == {}
        return s
    _both(run)


def test_summary_when_every_request_shed():
    def run(p):
        sched = _sched(p, policy="deadline", clock=p.VirtualClock())
        trace = p.s.make_trace(["vecadd"], occurrences=2)
        for req in trace:
            req.deadline_s = -1.0
        sched.submit_all(trace)
        assert sched.run() == []
        assert len(sched.queue.shed) == len(trace)
        s = sched.telemetry.summary()
        assert s["requests"] == 0 and s["latency"] is None
        return len(sched.queue.shed), s
    _both(run)


# -- one clock everywhere ----------------------------------------------------


@BY_PKG
def test_clock_plumbed_to_every_component(p):
    clock = p.VirtualClock()
    sched = _sched(p, clock=clock, tracer=p.s.Tracer(), metrics=p.s.MetricsRegistry())
    assert sched.clock is clock
    assert sched.queue.clock is clock
    assert sched.refiner.clock is clock
    assert sched.tracer.clock is clock


@BY_PKG
def test_explicit_tracer_clock_is_respected(p):
    mine = p.VirtualClock()
    tr = p.s.Tracer(mine)
    _sched(p, tracer=tr)
    assert tr.clock is mine


# -- live schedulers: spans + metrics on the real path -----------------------


def test_serial_scheduler_metrics_and_spans_consistent():
    def run(p):
        tr = p.s.Tracer()
        m = p.s.MetricsRegistry()
        sched = _sched(p, tracer=tr, metrics=m)
        with sched:
            sched.submit_all(p.s.make_trace(["vecadd", "dotprod"], occurrences=2))
            results = sched.run()
        n = len(results)
        snap = m.snapshot()

        def val(name):
            return snap[name]["values"][0]["value"]

        assert val("serving.requests") == n
        hits = sum(e["value"] for e in snap["serving.cache.hit"]["values"])
        misses = sum(e["value"] for e in snap["serving.cache.miss"]["values"])
        assert hits + misses == n
        assert misses == sum(not r.cache_hit for r in results)
        assert val("serving.model.searches") == sched.stats["model_searches"]
        for stage in ("decide", "dispatch", "retire"):
            assert val(f"serving.stage.{stage}.seconds")["count"] == n
        by_stage = p.s.aggregate_stage_times(tr.spans)
        assert by_stage["decide"]["count"] == by_stage["dispatch"]["count"] == n
        assert by_stage["retire"]["count"] == n
        assert all(s.trace_id is not None for s in sched.telemetry)
        # wall-clock seconds differ between the packages; the counts must not
        return (n, hits, misses, val("serving.model.searches"),
                sorted((k, v["count"]) for k, v in by_stage.items()),
                [(r.request.trace_id, r.cache_hit) for r in results])
    _both(run)


def test_engine_batched_tune_records_batch_size():
    def run(p):
        m = p.s.MetricsRegistry()
        sched = p.s.ConcurrentScheduler(p.s.OverlapHeuristicModel(), window=4, metrics=m,
                                        telemetry=p.s.TelemetryLog(), keep_outputs=False,
                                        **p.kw)
        with sched:
            sched.submit_all(p.s.make_trace(["vecadd", "dotprod", "mvmult"], occurrences=1))
            sched.run()
        batch = m.snapshot()["serving.cold_batch.size"]["values"][0]["value"]
        assert batch["count"] >= 1 and batch["max"] >= 2
        return batch
    _both(run)


# -- stats CLI ---------------------------------------------------------------


def test_stats_render_smoke():
    def run(p):
        samples = [p.s.TelemetrySample(
            seq=i, tenant="acme", workload="vecadd", key="k", backend="host-sync",
            partitions=1, tasks=2, cache_hit=i > 0, predicted_s=1e-3, measured_s=1.1e-3,
            rel_error=0.1, latency_s=2e-3, trace_id=f"r{i:06d}") for i in range(3)]
        m = p.s.MetricsRegistry()
        m.counter("serving.requests").inc(3)
        m.histogram("serving.stage.decide.seconds").observe(1e-4)
        out = p.render(samples, m.snapshot())
        for want in ("requests 3", "hit_rate 0.67", "p95", "serving.requests",
                     "serving.stage.decide.seconds"):
            assert want in out
        return out
    _both(run)


def test_stats_render_empty_samples():
    def run(p):
        out = p.render([])
        assert "no retired requests" in out
        return out
    _both(run)
