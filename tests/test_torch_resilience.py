"""The port's serving fault tolerance (``repro_torch.serving.resilience``
and the resilient schedulers) against the JAX package's, on the CPU.

Every case of ``tests/test_resilience.py`` runs here as one scenario on
both packages (the port's schedulers with ``device="cpu"``): the JAX
case's own assertions hold for each, and the two packages' decisions,
statuses, errors, breaker events, counters and metrics snapshots must be
equal.  Where threads decide an order (the concurrent engine under
repeated dispatch faults), the invariants are held instead.
"""
import dataclasses
import json
import os
import random
import shutil
import types

import numpy as np
import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none

import repro.core.autotuner as jautotuner
import repro.core.modeling as jmodeling
import repro.core.stream_config as jstream_config
import repro.core.workloads as jworkloads
import repro.launch.stats as jstats
import repro.serving as jserving
import repro.serving.clock as jclock
import repro.serving.telemetry as jtelemetry
import repro.serving.traces as jtraces
import repro_torch.core.autotuner as tautotuner
import repro_torch.core.modeling as tmodeling
import repro_torch.core.stream_config as tstream_config
import repro_torch.core.workloads as tworkloads
import repro_torch.launch.stats as tstats
import repro_torch.serving as tserving
import repro_torch.serving.clock as tclock
import repro_torch.serving.telemetry as ttelemetry
import repro_torch.serving.traces as ttraces


def _pkg(name, serving, clock, telemetry, traces, autotuner, modeling, stream_config,
         workloads, stats, kw):
    return types.SimpleNamespace(
        name=name, s=serving, VirtualClock=clock.VirtualClock, telemetry=telemetry,
        traces=traces, TuningCache=autotuner.TuningCache, TuneResult=autotuner.TuneResult,
        ModelRegistry=modeling.ModelRegistry, Heuristic=modeling.OverlapHeuristicModel,
        StreamConfig=stream_config.StreamConfig, get_workload=workloads.get_workload,
        render=stats.render, kw=kw)


JAX = _pkg("jax", jserving, jclock, jtelemetry, jtraces, jautotuner, jmodeling,
           jstream_config, jworkloads, jstats, {})
PORT = _pkg("port", tserving, tclock, ttelemetry, ttraces, tautotuner, tmodeling,
            tstream_config, tworkloads, tstats, {"device": "cpu"})
PKGS = (JAX, PORT)


def _both(scenario):
    """Run ``scenario(pkg)`` on both packages and require equal results."""
    jax_out, port_out = (scenario(p) for p in PKGS)
    assert port_out == jax_out
    return port_out


class _ConstModel:
    """Constant speedup-1.0 predictor (search picks single-stream)."""

    def predict_configs(self, feats, candidates):
        F = np.atleast_2d(np.asarray(feats))
        preds = np.ones((F.shape[0], len(candidates)))
        return preds[0] if np.ndim(feats) == 1 else preds


class _RaisingModel:
    """Primary model whose every prediction dies."""

    def __init__(self):
        self.calls = 0

    def predict_configs(self, feats, candidates):
        self.calls += 1
        raise RuntimeError("injected model failure")


def _req(p, workload="vecadd", rows=256, seed=0, **kw):
    chunked, shared = p.get_workload(workload).make_data(rows, np.random.default_rng(seed))
    return p.s.WorkloadRequest(workload=workload, chunked=chunked, shared=shared, **kw)


def _counter_total(metrics, name):
    snap = metrics.snapshot()
    return sum(v["value"] for v in snap.get(name, {}).get("values", []))


def _lenient_drift(p):
    return p.s.DriftDetector(threshold=1e9)


def _fire_all(plan, site, n):
    hits = []
    for _ in range(n):
        try:
            plan.fire(site)
            hits.append(False)
        except (jserving.InjectedFault, tserving.InjectedFault):
            hits.append(True)
    return hits


# -- fault injection ---------------------------------------------------------


@pytest.mark.parametrize("p", PKGS, ids=lambda p: p.name)
def test_fault_spec_validation(p):
    with pytest.raises(ValueError, match="unknown fault site"):
        p.s.FaultSpec(site="compile", at=(0,))
    with pytest.raises(ValueError, match="unknown fault kind"):
        p.s.FaultSpec(site="dispatch", kind="segfault", at=(0,))
    with pytest.raises(ValueError, match="needs at=, every="):
        p.s.FaultSpec(site="dispatch")


def test_fault_plan_at_every_times_semantics():
    def run(p):
        plan = p.s.FaultPlan([p.s.FaultSpec(site="dispatch", at=(1, 3)),
                              p.s.FaultSpec(site="retire", every=2, times=2)]).bind(sleep=None)
        out = (_fire_all(plan, "dispatch", 6), _fire_all(plan, "retire", 8),
               plan.invocations("dispatch"), plan.invocations("retire"), plan.fired)
        assert out == ([False, True, False, True, False, False],
                       [False, True, False, True, False, False, False, False], 6, 8, 4)
        return out
    _both(run)


def test_latency_fault_returns_delay_under_virtual_binding():
    def run(p):
        spec = p.s.FaultSpec(site="dispatch", kind="latency", at=(0,), delay_s=0.25)
        slept = []
        plan = p.s.FaultPlan([spec]).bind(sleep=slept.append)
        out = (plan.fire("dispatch"), list(slept), plan.fire("dispatch"),
               p.s.FaultPlan([spec]).bind(sleep=None).fire("dispatch"))
        assert out == (0.25, [0.25], 0.0, 0.25)
        return out
    _both(run)


def test_fault_plan_probability_deterministic_across_reset():
    def run(p):
        plan = p.s.FaultPlan([p.s.FaultSpec(site="decide", probability=0.3)],
                             seed=7).bind(sleep=None)
        first = _fire_all(plan, "decide", 50)
        plan.reset()
        assert _fire_all(plan, "decide", 50) == first
        assert any(first) and not all(first)
        return first
    _both(run)      # the same draws in both packages


def test_fault_plan_json_roundtrip_and_cross_load(tmp_path):
    def make(p):
        return p.s.FaultPlan([
            p.s.FaultSpec(site="dispatch", at=(3, 4), message="outage"),
            p.s.FaultSpec(site="tune.cold", kind="latency", every=10, times=2, delay_s=0.5),
        ], seed=3)

    for p in PKGS:
        make(p).save(tmp_path / f"{p.name}.json")
    assert (tmp_path / "jax.json").read_text() == (tmp_path / "port.json").read_text()
    for p in PKGS:
        for src in PKGS:    # each package loads the other's file
            loaded = p.s.FaultPlan.load(tmp_path / f"{src.name}.json")
            assert loaded.seed == 3 and loaded.enabled
            assert loaded.specs == make(p).specs
    assert ([dataclasses.asdict(s) for s in PORT.s.FaultPlan.load(tmp_path / "jax.json").specs]
            == [dataclasses.asdict(s) for s in make(JAX).specs])


def test_fault_plan_counts_injected_metric():
    def run(p):
        metrics = p.s.MetricsRegistry()
        plan = p.s.FaultPlan([p.s.FaultSpec(site="dispatch", at=(0,))])
        plan.bind(metrics=metrics, sleep=None)
        with pytest.raises(p.s.InjectedFault):
            plan.fire("dispatch")
        assert _counter_total(metrics, "serving.faults.injected") == 1
        return metrics.snapshot()
    _both(run)


@pytest.mark.parametrize("p", PKGS, ids=lambda p: p.name)
def test_null_faults_is_disabled_noop(p):
    assert not p.s.NULL_FAULTS.enabled
    assert p.s.NULL_FAULTS.fire("dispatch") == 0.0
    assert p.s.NULL_FAULTS.invocations("dispatch") == 0


@pytest.mark.parametrize("mode", ["truncate", "garbage", "empty"])
def test_corrupt_json_file_defeats_json_load(tmp_path, mode):
    def run(p):
        path = tmp_path / f"{p.name}.json"
        path.write_text(json.dumps({"entries": {"k": [1, 2, 3]}} | {"pad": list(range(64))}))
        p.s.corrupt_json_file(path, mode)
        with pytest.raises((json.JSONDecodeError, UnicodeDecodeError)):
            json.load(open(path))
        return path.read_bytes()
    _both(run)      # the same bytes


@pytest.mark.parametrize("p", PKGS, ids=lambda p: p.name)
def test_corrupt_json_file_rejects_unknown_mode(tmp_path, p):
    path = tmp_path / "x.json"
    path.write_text("{}")
    with pytest.raises(ValueError, match="unknown corruption mode"):
        p.s.corrupt_json_file(path, "bitflip")


# -- deadline-aware retry ----------------------------------------------------


def test_retry_succeeds_after_transients():
    def run(p):
        calls, slept, recovered = [], [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise RuntimeError("transient")
            return "ok"

        out = p.s.call_with_retry(flaky, policy=p.s.RetryPolicy(attempts=3, base_s=0.01,
                                                                jitter=0.0),
                                  rng=random.Random(0), sleep=slept.append,
                                  on_recover=recovered.append)
        assert out == "ok" and len(calls) == 3 and len(slept) == 2
        assert slept[1] > slept[0] and recovered == [2]
        return out, len(calls), slept, recovered
    _both(run)


def test_retry_exhausts_attempts_and_reraises():
    def run(p):
        calls = []

        def dead():
            calls.append(1)
            raise ValueError("permanent")

        with pytest.raises(ValueError, match="permanent"):
            p.s.call_with_retry(dead, policy=p.s.RetryPolicy(attempts=3, base_s=0.0,
                                                             jitter=0.0),
                                rng=random.Random(0), sleep=lambda s: None)
        assert len(calls) == 3
        return len(calls)
    _both(run)


def test_retry_deadline_budget_fails_fast_without_sleeping():
    def run(p):
        slept = []

        def dead():
            raise RuntimeError("down")

        with pytest.raises(RuntimeError, match="down"):
            p.s.call_with_retry(dead, policy=p.s.RetryPolicy(attempts=5, base_s=0.05,
                                                             jitter=0.0),
                                rng=random.Random(0), clock=p.VirtualClock(start=10.0),
                                deadline_s=10.01, sleep=slept.append)
        assert slept == []
        return slept
    _both(run)


def test_backoff_jitter_bounds_and_cap():
    def run(p):
        rng = random.Random(0)
        policy = p.s.RetryPolicy(attempts=5, base_s=0.01, multiplier=2.0, cap_s=0.03,
                                 jitter=0.5)
        out = []
        for attempt in range(6):
            raw = min(0.01 * 2.0 ** attempt, 0.03)
            for _ in range(20):
                b = policy.backoff_s(attempt, rng)
                assert raw <= b <= raw * 1.5 + 1e-12
                out.append(b)
        return out
    _both(run)      # the same jittered backoffs


# -- circuit breaker ---------------------------------------------------------


def test_breaker_trips_after_k_consecutive_failures():
    def run(p):
        br = p.s.CircuitBreaker(p.s.BreakerConfig(k=3, cooldown_s=1.0),
                                clock=p.VirtualClock())
        key = ("t0", "dispatch")
        for _ in range(2):
            br.record_failure(key)
        assert br.state(key) == "closed" and br.allow(key)
        br.record_failure(key)
        assert br.state(key) == "open" and not br.allow(key)
        return br.events
    _both(run)


def test_breaker_success_resets_consecutive_count():
    def run(p):
        br = p.s.CircuitBreaker(p.s.BreakerConfig(k=3), clock=p.VirtualClock())
        key = ("t0", "tune")
        for ok in (False, False, True, False, False):
            (br.record_success if ok else br.record_failure)(key)
        assert br.state(key) == "closed"
        return br.events, br.state(key)
    _both(run)


def test_breaker_half_open_single_probe_then_recover():
    def run(p):
        clock = p.VirtualClock()
        br = p.s.CircuitBreaker(p.s.BreakerConfig(k=2, cooldown_s=1.0), clock=clock)
        key = ("t0", "dispatch")
        br.record_failure(key)
        br.record_failure(key)
        assert not br.allow(key)
        clock.advance(1.5)
        assert br.allow(key) and br.state(key) == "half-open"
        assert not br.allow(key)
        br.record_success(key)
        assert br.state(key) == "closed" and br.allow(key)
        assert [s for _, k, s in br.events if k == key] == ["open", "half-open", "closed"]
        return br.events
    _both(run)


def test_breaker_half_open_failure_reopens():
    def run(p):
        clock = p.VirtualClock()
        br = p.s.CircuitBreaker(p.s.BreakerConfig(k=2, cooldown_s=1.0), clock=clock)
        key = ("t0", "dispatch")
        br.record_failure(key)
        br.record_failure(key)
        clock.advance(1.5)
        assert br.allow(key)
        br.record_failure(key)
        assert br.state(key) == "open" and not br.allow(key)
        clock.advance(1.5)
        assert br.allow(key)
        return br.events
    _both(run)


def test_breaker_exports_state_gauge_and_opened_counter():
    def run(p):
        metrics = p.s.MetricsRegistry()
        br = p.s.CircuitBreaker(p.s.BreakerConfig(k=1, cooldown_s=1.0),
                                clock=p.VirtualClock(), metrics=metrics)
        br.record_failure(("acme", "dispatch"))
        snap = metrics.snapshot()
        entries = snap["serving.breaker.state"]["values"]
        assert entries[0]["labels"] == {"tenant": "acme", "stage": "dispatch"}
        assert entries[0]["value"] == 2
        assert _counter_total(metrics, "serving.breaker.opened") == 1
        out = p.render([], snap)
        assert "== resilience ==" in out and "breaker" in out and "open" in out
        return snap, out
    _both(run)


# -- nearest-bucket fallback + crash-safe persistence ------------------------


def _cache_with_bucket(p, cache, rows, config, workload="vecadd", backend="host-sync",
                       seed=0):
    chunked, shared = p.get_workload(workload).make_data(rows, np.random.default_rng(seed))
    key = p.TuningCache.key(workload, chunked, shared, backend)
    cache.put(key, p.TuneResult(config, 1.2, 0.0, 0.0, backend=backend))
    return key


def _want_key(p, rows):
    chunked, shared = p.get_workload("vecadd").make_data(rows, np.random.default_rng(1))
    return p.TuningCache.key("vecadd", chunked, shared, "host-sync")


def test_nearest_bucket_borrows_closest_comparable_bucket():
    def run(p):
        cache = p.TuningCache()
        _cache_with_bucket(p, cache, 1024, p.StreamConfig(partitions=2, tasks=2))
        _cache_with_bucket(p, cache, 8192, p.StreamConfig(partitions=4, tasks=4))
        got = p.s.nearest_bucket_entry(cache, _want_key(p, 512), n_rows=512)
        assert got.config == p.StreamConfig(partitions=2, tasks=2)
        return dataclasses.astuple(got.config), got.key if hasattr(got, "key") else None
    _both(run)


def test_nearest_bucket_respects_feasibility_and_key_prefix():
    def run(p):
        cache = p.TuningCache()
        _cache_with_bucket(p, cache, 1024, p.StreamConfig(partitions=8, tasks=8))
        _cache_with_bucket(p, cache, 1024, p.StreamConfig(partitions=2, tasks=2),
                           workload="dotprod")
        want = _want_key(p, 16)
        out = (p.s.nearest_bucket_entry(cache, want, n_rows=16),
               p.s.nearest_bucket_entry(None, want, n_rows=16))
        assert out == (None, None)
        return out
    _both(run)


def test_atomic_write_json_replaces_and_leaves_no_tmp(tmp_path):
    def run(p):
        path = tmp_path / f"{p.name}.json"
        path.write_text(json.dumps({"old": True}))
        p.s.atomic_write_json(path, {"new": [1, 2, 3]})
        assert json.loads(path.read_text()) == {"new": [1, 2, 3]}
        assert not os.path.exists(str(path) + ".tmp")
        return path.read_text()
    _both(run)


def test_quarantine_file_collision_naming(tmp_path):
    def run(p):
        path = tmp_path / f"{p.name}-cache.json"
        path.write_text("not json")
        first = p.s.quarantine_file(path)
        assert first.endswith(".corrupt") and os.path.exists(first)
        path.write_text("still not json")
        second = p.s.quarantine_file(path)
        assert second != first and os.path.exists(second)
        assert not path.exists()
        return [os.path.basename(f).replace(p.name, "") for f in (first, second)]
    _both(run)


def test_corrupt_cache_quarantine_and_rebuild_roundtrip(tmp_path):
    def run(p):
        path = tmp_path / f"{p.name}-tuning.json"
        cache = p.TuningCache()
        key = _cache_with_bucket(p, cache, 1024, p.StreamConfig(partitions=2, tasks=2))
        cache.save(str(path))
        p.s.corrupt_json_file(path, "truncate")
        with pytest.warns(UserWarning, match="unreadable tuning cache"):
            fresh = p.TuningCache(str(path))
        assert len(fresh) == 0 and fresh.quarantined is not None
        assert os.path.exists(fresh.quarantined)
        _cache_with_bucket(p, fresh, 1024, p.StreamConfig(partitions=2, tasks=2))
        fresh.save()
        again = p.TuningCache(str(path))
        assert again.peek(key) is not None and again.quarantined is None
        return key, os.path.basename(fresh.quarantined).replace(p.name, "")
    _both(run)


# -- registry dangling-latest fallback ---------------------------------------


def test_dangling_latest_falls_back_to_newest_resolvable(tmp_path):
    def run(p):
        root = tmp_path / p.name
        metrics = p.s.MetricsRegistry()
        reg = p.ModelRegistry(root, metrics=metrics)
        v1 = reg.publish(p.Heuristic())
        v2 = reg.publish(p.Heuristic())
        fork = reg.publish(p.Heuristic(), tenant="acme")
        v3 = reg.publish(p.Heuristic())
        shutil.rmtree(root / v3)
        with pytest.warns(UserWarning, match="falling back"):
            model, manifest = reg.load("latest")
        assert manifest["artifact_id"] == v2
        assert isinstance(model, p.Heuristic)
        assert _counter_total(metrics, "serving.registry.latest_fallback") == 1
        ids = [v1, v2, fork, v3]
        return ids.index(manifest["artifact_id"]), metrics.snapshot()
    _both(run)


@pytest.mark.parametrize("p", PKGS, ids=lambda p: p.name)
def test_dangling_latest_with_no_surviving_artifact_still_raises(tmp_path, p):
    reg = p.ModelRegistry(tmp_path)
    aid = reg.publish(p.Heuristic())
    shutil.rmtree(tmp_path / aid)
    with pytest.raises(RuntimeError, match="points at"):
        reg.load("latest")


# -- resilient serial scheduler ----------------------------------------------


def _resilient_scheduler(p, model=None, *, backend="host-sync", faults=None, policy=None,
                         **kw):
    return p.s.AdaptiveScheduler(
        model if model is not None else _ConstModel(),
        backend=backend, drift=_lenient_drift(p), faults=faults,
        resilience=policy if policy is not None else p.s.ResiliencePolicy(
            retry=p.s.RetryPolicy(attempts=3, base_s=1e-4, jitter=0.0)),
        metrics=p.s.MetricsRegistry(), **p.kw, **kw)


def _outcome(results, configs=True):
    """What both packages must agree on: each request's status, error,
    degradation rung and (unless it comes from timed features) config."""
    return [(r.status, r.error, r.sample.status, r.sample.degraded_via,
             (r.config.partitions, r.config.tasks) if configs and r.config else None,
             bool(len(r.outputs)), r.measured_s is None) for r in results]


def _counters(metrics, *names):
    return {n: _counter_total(metrics, n) for n in names}


def test_transient_dispatch_fault_is_retried_and_recovered():
    def run(p):
        faults = p.s.FaultPlan([p.s.FaultSpec(site="dispatch", at=(0,),
                                              message="transient dispatch error")])
        sched = _resilient_scheduler(p, faults=faults)
        sched.submit_all([_req(p, seed=i) for i in range(2)])
        results = sched.run()
        assert [r.status for r in results] == ["served", "served"]
        assert all(len(r.outputs) for r in results)
        assert sched.stats.get("failed", 0) == 0
        out = (_outcome(results), _counters(sched.metrics, "serving.faults.recovered",
                                            "serving.faults.injected"))
        assert out[1]["serving.faults.recovered"] >= 1
        sched.close()
        return out
    _both(run)


def test_dispatch_outage_fails_requests_individually():
    def run(p):
        faults = p.s.FaultPlan([p.s.FaultSpec(site="dispatch", at=(0, 1, 2),
                                              message="injected outage")])
        sched = _resilient_scheduler(p, faults=faults)
        sched.submit_all([_req(p, seed=i) for i in range(3)])
        results = sched.run()
        assert [r.status for r in results] == ["failed", "served", "served"]
        failed = results[0]
        assert failed.measured_s is None and failed.outputs == []
        assert "InjectedFault" in failed.error and "outage" in failed.error
        assert failed.sample.status == "failed"
        summary = sched.telemetry.summary()
        assert summary["by_status"] == {"failed": 1, "ok": 2}
        assert sched.stats["failed"] == 1
        sched.close()
        return _outcome(results), summary["by_status"], sched.stats["failed"]
    _both(run)


def test_dispatch_steps_down_to_host_sync_fallback():
    def run(p):
        faults = p.s.FaultPlan([p.s.FaultSpec(site="dispatch", at=(0, 1, 2),
                                              message="primary backend down")])
        sched = _resilient_scheduler(p, backend="host-threads", faults=faults)
        sched.submit_all([_req(p, seed=0)])
        (r,) = sched.run()
        assert r.status == "degraded" and r.sample.degraded_via == "backend"
        assert len(r.outputs) and r.measured_s is not None
        counters = _counters(sched.metrics, "serving.faults.degraded")
        assert counters["serving.faults.degraded"] == 1
        sched.close()
        return _outcome([r]), counters
    _both(run)


def test_tune_ladder_falls_to_heuristic_and_breaker_opens():
    def run(p):
        raising = _RaisingModel()
        sched = _resilient_scheduler(
            p, raising, policy=p.s.ResiliencePolicy(
                retry=p.s.RetryPolicy(attempts=3, base_s=1e-4, jitter=0.0),
                breaker=p.s.BreakerConfig(k=2, cooldown_s=1e9)))
        sched.submit_all([_req(p, rows=r, seed=i) for i, r in enumerate((256, 1024, 4096))])
        results = sched.run()
        assert [r.status for r in results] == ["degraded"] * 3
        assert {r.sample.degraded_via for r in results} == {"heuristic-model"}
        assert all(len(r.outputs) for r in results)
        assert sched.breaker.state(("default", "tune")) == "open"
        assert raising.calls == 6
        events = [(k, s) for _, k, s in sched.breaker.events]
        sched.close()
        # the heuristic rung scores configs from the request's timed
        # features (t_compute_us, t_transfer_us), which each package
        # measures on its own runtime: its picks are not compared
        return _outcome(results, configs=False), raising.calls, events
    _both(run)


# -- resilient concurrent engine ---------------------------------------------


@pytest.mark.parametrize("p", PKGS, ids=lambda p: p.name)
def test_concurrent_engine_survives_dispatch_errors(p):
    # which dispatches the six faults hit depends on thread timing, in
    # either package: hold the JAX case's invariants on each
    faults = p.s.FaultPlan([p.s.FaultSpec(site="dispatch", every=1, times=6,
                                          message="flaky dispatch")])
    eng = p.s.ConcurrentScheduler(
        _ConstModel(), window=2, drift=_lenient_drift(p), faults=faults,
        resilience=p.s.ResiliencePolicy(
            retry=p.s.RetryPolicy(attempts=3, base_s=1e-4, jitter=0.0)),
        metrics=p.s.MetricsRegistry(), **p.kw)
    n = 5
    eng.submit_all([_req(p, seed=i) for i in range(n)])
    results = eng.run()
    assert len(results) == n
    assert all(r.status in ("served", "degraded", "failed") for r in results)
    assert eng.stats["failed"] >= 1
    assert sum(r.status != "failed" for r in results) >= 1
    assert eng.retirer.held == 0
    assert _counter_total(eng.metrics, "serving.faults.injected") == 6
    eng.close()


def test_watchdog_reaps_hung_dispatch_and_requeue_serves():
    def run(p):
        faults = p.s.FaultPlan([p.s.FaultSpec(site="dispatch", kind="latency", at=(0,),
                                              delay_s=0.4)])
        eng = p.s.ConcurrentScheduler(
            _ConstModel(), window=2, workers=2, drift=_lenient_drift(p), faults=faults,
            resilience=p.s.ResiliencePolicy(watchdog_s=0.08),
            metrics=p.s.MetricsRegistry(), **p.kw)
        eng.submit_all([_req(p, seed=0)])
        (r,) = eng.run()
        assert r.status == "served" and len(r.outputs)
        assert eng.stats["watchdog_fired"] == 1
        counters = _counters(eng.metrics, "serving.watchdog.fired")
        assert counters["serving.watchdog.fired"] == 1
        eng.close()
        return _outcome([r]), eng.stats["watchdog_fired"], counters
    _both(run)


def test_watchdog_requeue_exhausted_times_out_individually():
    def run(p):
        faults = p.s.FaultPlan([p.s.FaultSpec(site="dispatch", kind="latency", at=(0, 1),
                                              delay_s=0.3)])
        eng = p.s.ConcurrentScheduler(
            _ConstModel(), window=2, workers=2, drift=_lenient_drift(p), faults=faults,
            resilience=p.s.ResiliencePolicy(watchdog_s=0.05),
            metrics=p.s.MetricsRegistry(), **p.kw)
        eng.submit_all([_req(p, seed=0)])
        (r,) = eng.run()
        assert r.status == "timeout" and "watchdog" in r.error
        assert r.sample.status == "timeout" and r.sample.measured_s is None
        assert eng.stats["watchdog_fired"] == 2
        eng.close()
        return _outcome([r]), eng.stats["watchdog_fired"]
    _both(run)


# -- telemetry contracts + shutdown paths ------------------------------------


def _failed_sample(p, seq, **kw):
    return p.s.TelemetrySample(seq=seq, tenant="t", workload="vecadd", key="k",
                               backend="host-sync", partitions=0, tasks=0, cache_hit=False,
                               predicted_s=None, measured_s=None, rel_error=None,
                               status="failed", error="RuntimeError: boom", **kw)


def test_summary_with_all_requests_failed_is_none_shaped():
    def run(p):
        log = p.s.TelemetryLog()
        for i in range(4):
            log.append(_failed_sample(p, i))
        s = log.summary()
        assert s["requests"] == 4 and s["latency"] is None
        assert s["total_measured_s"] == 0.0
        assert s["mean_rel_error"] is None and s["slo_violation_rate"] is None
        assert s["by_status"] == {"failed": 4}
        out = p.render(log.samples)
        assert "failed 4" in out and "(no retired requests)" in out
        return s, out
    _both(run)


@pytest.mark.parametrize("p", PKGS, ids=lambda p: p.name)
def test_telemetry_close_idempotent_never_fsyncs_closed_file(tmp_path, monkeypatch, p):
    fsyncs = []
    real_fsync = os.fsync
    monkeypatch.setattr(p.telemetry.os, "fsync",
                        lambda fd: (fsyncs.append(fd), real_fsync(fd)))
    log = p.s.TelemetryLog(str(tmp_path / "t.jsonl"))
    log.append(_failed_sample(p, 0))
    log.close()
    assert log.closed and len(fsyncs) == 1
    log.close()
    log.close()
    assert len(fsyncs) == 1
    log.append(_failed_sample(p, 1))
    log.close()
    assert len(p.s.TelemetryLog.read(str(tmp_path / "t.jsonl"))) == 2


@pytest.mark.parametrize("p", PKGS, ids=lambda p: p.name)
def test_scheduler_close_is_idempotent_and_safe_mid_flight(tmp_path, p):
    sched = p.s.AdaptiveScheduler(_ConstModel(), drift=_lenient_drift(p),
                                  telemetry=p.s.TelemetryLog(str(tmp_path / "t.jsonl")),
                                  **p.kw)
    sched.submit_all([_req(p, seed=i) for i in range(2)])
    sched.run(max_requests=1)
    sched.close()
    assert sched.telemetry.closed
    sched.close()
    eng = p.s.ConcurrentScheduler(_ConstModel(), window=2, drift=_lenient_drift(p), **p.kw)
    eng.submit_all([_req(p, seed=0)])
    eng.run()
    eng.close()
    eng.close()


# -- virtual-clock trace harness under faults --------------------------------


def test_simulate_trace_with_faults_is_deterministic():
    def run(p):
        cfg = p.traces.TraceConfig(n_requests=800, seed=5, arrival="bursty")
        specs = [p.s.FaultSpec(site="dispatch", at=tuple(range(40, 52)), message="outage"),
                 p.s.FaultSpec(site="dispatch", kind="latency", every=97, delay_s=0.2)]

        def once():
            return p.traces.simulate_trace(p.traces.generate_trace(cfg), policy="fifo",
                                           seed=5, faults=p.s.FaultPlan(specs, seed=5))

        a, b = once(), once()
        assert a == b and a["failed"] > 0 and a["faults_injected"] > 0
        clean = p.traces.simulate_trace(p.traces.generate_trace(cfg), policy="fifo", seed=5)
        assert clean["failed"] == 0 and clean["completed"] >= a["completed"]
        return a, clean
    _both(run)      # the JAX package's reports, number for number
