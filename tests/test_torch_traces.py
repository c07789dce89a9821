"""The port's trace generator and virtual-time replay harness against the
JAX package's.

The cases of ``tests/test_traces.py`` run on the port's modules.  Then
parity: the harness touches no device (numpy data, a virtual clock,
service times from a seeded model), and the port's ``make_data`` and
``TuningCache.key`` are the JAX package's, so the port must give the
same traces field for field (data bytes included) and the same reports
``==``, not to a tolerance; and at ``BENCH_latency.json``'s committed
configuration it must reproduce every number of that file.
"""
import functools
import json
import operator
from pathlib import Path

import numpy as np
import pytest

from repro.serving import traces as jtr
from repro.serving.telemetry import TelemetryLog as JaxTelemetryLog
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
from repro_torch.serving import (POLICIES, RequestQueue, WorkloadRequest,
                                 contention_factor)
from repro_torch.serving.clock import VirtualClock
from repro_torch.serving.refinement import DriftDetector
from repro_torch.serving.telemetry import TelemetryLog, percentile
from repro_torch.serving.traces import (ServiceModel, TraceConfig,
                                        _NoiseStream, generate_trace,
                                        simulate_trace)

ROOT = Path(__file__).resolve().parents[1]

# small but bursty enough to overload: deadline must both shed and beat
# fifo on violations (calibrated against the default ServiceModel)
BURSTY = TraceConfig(n_requests=6000, seed=11, arrival="bursty",
                     burst_rate_rps=2600.0)


def _field_view(req):
    return (req.workload, req.tenant, req.priority,
            req.arrival_s, req.deadline_s)


# -- clock -------------------------------------------------------------------


def test_virtual_clock_semantics():
    c = VirtualClock()
    assert c.now() == 0.0
    assert c.advance(1.5) == 1.5
    assert c.advance_to(1.0) == 1.5          # monotone: no going back
    assert c.advance_to(4.0) == 4.0
    with pytest.raises(ValueError):
        c.advance(-0.1)


def test_percentile_interpolates():
    with pytest.raises(ValueError):
        percentile([], 0.5)
    assert percentile([7.0], 0.99) == 7.0
    assert percentile([1.0, 2.0, 3.0, 4.0], 0.5) == pytest.approx(2.5)
    assert percentile([1.0, 2.0, 3.0, 4.0], 1.0) == 4.0


# -- contention_factor edge cases --------------------------------------------


def test_contention_factor_zero_workers_is_serial():
    assert contention_factor(8, 1.6, workers=0) == 1.0
    assert contention_factor(1, 1.6, workers=0) == 1.0


def test_contention_factor_negative_workers_rejected():
    with pytest.raises(ValueError):
        contention_factor(4, 1.6, workers=-1)


def test_contention_factor_none_workers_uncapped():
    assert contention_factor(8, 1.6, workers=None) == pytest.approx(5.0)
    assert contention_factor(8, 1.6, workers=2) == pytest.approx(1.25)
    assert contention_factor(1, None, workers=4) == 1.0


# -- generator ---------------------------------------------------------------


def test_generate_trace_deterministic_and_sorted():
    cfg = TraceConfig(n_requests=800, seed=3, arrival="bursty")
    a = [_field_view(r) for r in generate_trace(cfg)]
    b = [_field_view(r) for r in generate_trace(cfg)]
    assert a == b
    assert len(a) == 800
    arrivals = [v[3] for v in a]
    assert arrivals == sorted(arrivals)
    c = [_field_view(r) for r in
         generate_trace(TraceConfig(n_requests=800, seed=4,
                                    arrival="bursty"))]
    assert a != c


def test_generate_trace_shares_data_per_bucket():
    cfg = TraceConfig(n_requests=400, seed=0,
                      workloads=("vecadd", "dotprod"))
    reqs = list(generate_trace(cfg))
    by_bucket = {}
    for r in reqs:
        shape = next(iter(r.chunked.values())).shape
        by_bucket.setdefault((r.workload, shape), set()).add(
            id(next(iter(r.chunked.values()))))
    assert all(len(ids) == 1 for ids in by_bucket.values())


def test_generate_trace_zipf_and_tenant_skew():
    cfg = TraceConfig(n_requests=4000, seed=5)
    reqs = list(generate_trace(cfg))
    wl_counts = {}
    tn_counts = {}
    for r in reqs:
        wl_counts[r.workload] = wl_counts.get(r.workload, 0) + 1
        tn_counts[r.tenant] = tn_counts.get(r.tenant, 0) + 1
    ranked = sorted(wl_counts.values(), reverse=True)
    assert ranked[0] > 4 * ranked[len(ranked) // 2]
    assert tn_counts[cfg.tenants[0]] > 2 * tn_counts[cfg.tenants[-1]]
    slos = {round(r.deadline_s - r.arrival_s, 6) for r in reqs}
    assert slos == {s for _, s in cfg.slo_choices}


def test_shape_churn_defeats_single_bucket():
    churned = TraceConfig(n_requests=900, seed=2, workloads=("vecadd",),
                          churn_prob=0.2)
    shapes = {next(iter(r.chunked.values())).shape
              for r in generate_trace(churned)}
    assert len(shapes) > 1
    frozen = TraceConfig(n_requests=900, seed=2, workloads=("vecadd",),
                         churn_prob=0.0, churn_every=0)
    shapes = {next(iter(r.chunked.values())).shape
              for r in generate_trace(frozen)}
    assert len(shapes) == 1


def test_generate_trace_rejects_unknown_arrival():
    with pytest.raises(ValueError):
        next(generate_trace(TraceConfig(n_requests=1, arrival="square")))


# -- queue policies under generated traffic ----------------------------------


def _mini(workload="w", tenant="t", priority=0, deadline=None):
    return WorkloadRequest(workload=workload, chunked={}, shared={},
                           tenant=tenant, priority=priority,
                           deadline_s=deadline)


def test_fair_rotates_under_tenant_skew():
    q = RequestQueue("fair")
    for i in range(6):
        q.push(_mini(workload=f"a{i}", tenant="chatty"))
    for i in range(2):
        q.push(_mini(workload=f"b{i}", tenant="quiet"))
    order = [(q.pop().tenant) for _ in range(8)]
    assert order == ["chatty", "quiet", "chatty", "quiet",
                     "chatty", "chatty", "chatty", "chatty"]


def test_priority_ties_break_by_arrival():
    q = RequestQueue("priority")
    q.push(_mini(workload="low", priority=0))
    q.push(_mini(workload="first", priority=5))
    q.push(_mini(workload="second", priority=5))
    assert [q.pop().workload for _ in range(3)] == \
        ["first", "second", "low"]


def test_deadline_boost_shed_and_ordering():
    clock = VirtualClock()
    q = RequestQueue("deadline", clock=clock)
    q.push(_mini(workload="slack", deadline=10.0))
    q.push(_mini(workload="doomed", deadline=1.0))
    q.push(_mini(workload="tight", deadline=2.0))
    q.push(_mini(workload="never"))
    assert q.pop().workload == "doomed"
    clock.advance_to(1.5)
    q.push(_mini(workload="expired", deadline=1.2))
    assert q.pop().workload == "tight"
    assert [r.workload for r in q.shed] == ["expired"]
    clock.advance_to(99.0)
    assert q.pop().workload == "never"
    assert [r.workload for r in q.shed] == ["expired", "slack"]
    with pytest.raises(IndexError):
        q.pop()


def test_deadline_queue_all_expired_raises_after_shedding():
    clock = VirtualClock()
    q = RequestQueue("deadline", clock=clock)
    q.push(_mini(workload="a", deadline=1.0))
    q.push(_mini(workload="b", deadline=2.0))
    clock.advance_to(5.0)
    assert len(q) == 2
    with pytest.raises(IndexError):
        q.pop()
    assert len(q.shed) == 2 and len(q) == 0


def test_pending_by_tenant_consistent_across_policies():
    reqs = [("acme", 2, 1.0), ("acme", 0, None), ("globex", 1, 2.0),
            ("initech", 0, None), ("globex", 2, 3.0)]
    expected = {"acme": 2, "globex": 2, "initech": 1}
    for policy in POLICIES:
        q = RequestQueue(policy, clock=VirtualClock())
        for tenant, prio, dl in reqs:
            q.push(_mini(tenant=tenant, priority=prio, deadline=dl))
        assert q.pending_by_tenant() == expected, policy
        assert len(q) == len(reqs)


# -- replay harness ----------------------------------------------------------


def test_deadline_beats_fifo_on_bursty_trace():
    fifo = simulate_trace(generate_trace(BURSTY), policy="fifo", seed=11)
    edf = simulate_trace(generate_trace(BURSTY), policy="deadline",
                         seed=11)
    assert fifo["slo"]["violation_rate"] > 0.1
    assert edf["slo"]["violation_rate"] < fifo["slo"]["violation_rate"]
    assert edf["shed"] > 0
    assert edf["completed"] + edf["shed"] == edf["n_requests"]
    assert edf["slo"]["violation_rate"] == pytest.approx(
        (edf["slo"]["violations_retired"] + edf["shed"])
        / edf["slo"]["with_deadline"])
    assert fifo["shed"] == 0 and fifo["completed"] == fifo["n_requests"]
    for r in (fifo, edf):
        qd = r["queue_depth"]
        assert 0 <= qd["mean"] <= qd["max"] and qd["p95"] <= qd["max"]


def test_stationary_trace_zero_refinements_at_window8():
    cfg = TraceConfig(n_requests=6000, seed=7, arrival="poisson")
    r = simulate_trace(generate_trace(cfg), policy="fifo", window=8,
                       seed=7)
    assert r["refinements"] == 0
    assert r["completed"] == 6000


def test_drift_injection_fires_exactly_one_refinement():
    cfg = TraceConfig(n_requests=5000, seed=5, arrival="poisson",
                      workloads=("vecadd",), churn_prob=0.0,
                      churn_every=0, slo_choices=None)
    r = simulate_trace(generate_trace(cfg), policy="fifo", seed=5,
                       drift_injections=[(4.0, "vecadd", 5.0)])
    assert r["refinements"] == 1
    assert r["refined_keys"][0].startswith("vecadd|")


def test_simulate_trace_deterministic():
    cfg = TraceConfig(n_requests=1500, seed=9, arrival="bursty")
    a = simulate_trace(generate_trace(cfg), policy="deadline", seed=9)
    b = simulate_trace(generate_trace(cfg), policy="deadline", seed=9)
    assert a == b


def test_policies_see_identical_service_draws():
    cfg = TraceConfig(n_requests=600, seed=13, arrival="poisson",
                      rate_rps=20.0, slo_choices=None)
    stats = {p: simulate_trace(generate_trace(cfg), policy=p, seed=13)
             for p in POLICIES}
    base = stats["fifo"]["latency"]
    for p in POLICIES:
        assert stats[p]["latency"] == pytest.approx(base)


def test_simulate_trace_telemetry_stamps_monotone():
    cfg = TraceConfig(n_requests=400, seed=1, arrival="poisson")
    log = TelemetryLog()
    r = simulate_trace(generate_trace(cfg), policy="fifo", seed=1,
                       telemetry=log)
    assert len(log) == r["completed"] == 400
    for s in log:
        assert s.t_enqueue_s <= s.t_decide_s <= s.t_dispatch_s \
            <= s.t_retire_s
        assert s.latency_s == pytest.approx(s.t_retire_s - s.t_enqueue_s)
        assert s.deadline_s is not None
        assert s.queue_depth >= 0 and s.inflight >= 1
    assert log.summary()["latency"]["p95_s"] == \
        pytest.approx(r["latency"]["p95_s"])


def test_simulate_trace_rejects_unknown_policy():
    with pytest.raises(ValueError):
        simulate_trace([], policy="lifo")


def test_service_model_shift_and_determinism():
    a, b = ServiceModel(3), ServiceModel(3)
    assert a.true_time("vecadd", 512) == b.true_time("vecadd", 512)
    before = a.true_time("vecadd", 512)
    a.shift("vecadd", 4.0)
    assert a.true_time("vecadd", 512) == pytest.approx(4.0 * before)
    assert a.true_time("dotprod", 512) == b.true_time("dotprod", 512)
    assert ServiceModel(4).true_time("vecadd", 512) != before


# -- parity with the JAX package ---------------------------------------------


def _arrays_equal(a: dict, b: dict) -> bool:
    return (list(a) == list(b)
            and all(a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                    and a[k].tobytes() == b[k].tobytes() for k in a))


@pytest.mark.parametrize("cfg", [
    TraceConfig(n_requests=3000, seed=0, arrival="bursty",
                churn_prob=0.2),
    TraceConfig(n_requests=9000, seed=7, arrival="poisson",
                workloads=("vecadd", "dotprod", "mvmult"),
                scale_indices=(4,), churn_prob=0.0, slo_choices=None),
], ids=["bursty-full-suite", "poisson-real-trace"])
def test_generate_trace_identical_field_for_field(cfg):
    """Same seed, same stream: every field of every request, and the
    bytes of every bucket's arrays (compared once per bucket, since a
    bucket's requests share them)."""
    jcfg = jtr.TraceConfig(**vars(cfg))
    port, ref = list(generate_trace(cfg)), list(jtr.generate_trace(jcfg))
    assert len(port) == len(ref) == cfg.n_requests
    seen = {}
    for p, r in zip(port, ref):
        assert vars(p).keys() == vars(r).keys()
        for f in ("workload", "tenant", "priority", "seq", "arrival_s",
                  "deadline_s", "trace_id"):
            assert getattr(p, f) == getattr(r, f), f
        pair = (id(p.chunked), id(r.chunked))
        if pair not in seen:
            seen[pair] = (_arrays_equal(p.chunked, r.chunked)
                          and _arrays_equal(p.shared, r.shared))
        assert seen[pair], p.workload
    assert len(seen) >= 3


def test_noise_stream_and_service_model_identical():
    z, jz = _NoiseStream([3, 1]), jtr._NoiseStream([3, 1])
    assert [z[i] for i in (0, 65535, 65536, 200_000)] == \
        [jz[i] for i in (0, 65535, 65536, 200_000)]
    s, js = ServiceModel(3), jtr.ServiceModel(3)
    for wl in ("vecadd", "dotprod", "mvmult", "binomial"):
        assert s.true_time(wl, 4096) == js.true_time(wl, 4096)
        assert s.sample(wl, 4096, 0.7) == js.sample(wl, 4096, 0.7)


N_PARITY = 10_000


@pytest.mark.parametrize("policy", POLICIES)
def test_simulate_trace_reports_identical(policy):
    cfg = TraceConfig(n_requests=N_PARITY, seed=0, arrival="bursty")
    port = simulate_trace(generate_trace(cfg), policy=policy, window=8,
                          capacity=1.6, seed=0)
    ref = jtr.simulate_trace(jtr.generate_trace(jtr.TraceConfig(
        **vars(cfg))), policy=policy, window=8, capacity=1.6, seed=0)
    assert port == ref


def test_simulate_trace_stationary_and_drift_identical():
    cfg = TraceConfig(n_requests=N_PARITY, seed=1, arrival="poisson")
    assert (simulate_trace(generate_trace(cfg), policy="fifo", window=8,
                           capacity=1.6, seed=1)
            == jtr.simulate_trace(
                jtr.generate_trace(jtr.TraceConfig(**vars(cfg))),
                policy="fifo", window=8, capacity=1.6, seed=1))
    # a drift injection with telemetry: the refinement and every sample
    cfg = TraceConfig(n_requests=5000, seed=5, arrival="poisson",
                      workloads=("vecadd",), churn_prob=0.0,
                      churn_every=0, slo_choices=None)
    log, jlog = TelemetryLog(), JaxTelemetryLog()
    port = simulate_trace(generate_trace(cfg), policy="fifo", seed=5,
                          drift=DriftDetector(load_discount=0.5),
                          drift_injections=[(4.0, "vecadd", 5.0)],
                          telemetry=log)
    ref = jtr.simulate_trace(
        jtr.generate_trace(jtr.TraceConfig(**vars(cfg))), policy="fifo",
        seed=5, drift_injections=[(4.0, "vecadd", 5.0)], telemetry=jlog)
    assert port == ref and port["refinements"] == 1
    assert [vars(s) for s in log] == [vars(s) for s in jlog]


def _naive_mean(log) -> float:
    """The mean of retired latencies summed left to right over the sorted
    list: ``sum`` of floats before Python 3.12, which made the committed
    file (3.12's ``sum`` compensates and lands one ulp away)."""
    lats = sorted(s.latency_s for s in log)
    return functools.reduce(operator.add, lats) / len(lats)


def _assert_reproduces(report: dict, committed: dict, log) -> None:
    for k, v in committed.items():
        if k == "latency":
            assert {f: x for f, x in report[k].items() if f != "mean_s"} \
                == {f: x for f, x in v.items() if f != "mean_s"}
            assert _naive_mean(log) == v["mean_s"]
        elif k == "slo":
            assert {f: report[k][f] for f in v} == v
        else:
            assert report[k] == v, k


def test_reproduces_bench_latency_exactly():
    """``BENCH_latency.json`` at its committed configuration (100,000
    bursty requests, window 8, capacity 1.6, seed 0; the stationary run
    at seed 1), every number of the file.  The file predates the
    reports' ``failed`` counts, so only its own keys are compared."""
    committed = json.loads((ROOT / "BENCH_latency.json").read_text())
    n, seed = committed["n_requests"], committed["seed"]
    window, capacity = committed["window"], committed["capacity"]
    assert (n, seed, window, capacity) == (100_000, 0, 8, 1.6)
    reports = {}
    for policy in POLICIES:
        log = TelemetryLog()
        reports[policy] = simulate_trace(
            generate_trace(TraceConfig(n_requests=n, seed=seed,
                                       arrival="bursty")),
            policy=policy, window=window, capacity=capacity, seed=seed,
            telemetry=log)
        _assert_reproduces(reports[policy], committed["policies"][policy],
                           log)
        del log
    log = TelemetryLog()
    stationary = simulate_trace(
        generate_trace(TraceConfig(n_requests=n, seed=seed + 1,
                                   arrival="poisson")),
        policy="fifo", window=window, capacity=capacity, seed=seed + 1,
        telemetry=log)
    _assert_reproduces(stationary, committed["stationary"], log)
    fifo = reports["fifo"]["slo"]["violation_rate"]
    dl = reports["deadline"]["slo"]["violation_rate"]
    assert committed["fifo_slo_violation_rate"] == fifo
    assert committed["deadline_slo_violation_rate"] == dl
    assert committed["deadline_p95_latency_ms"] == \
        reports["deadline"]["latency"]["p95_s"] * 1e3
    assert committed["stationary_refinements"] == stationary["refinements"]
    assert committed["deadline_vs_fifo_violation_improvement"] == \
        fifo / max(dl, 1e-9)
    assert np.isfinite(stationary["latency"]["p99_s"])
