"""The port's serial adaptive-serving path against the JAX package's.

Both packages take the same numpy inputs (``make_trace`` draws them with
numpy from one seed) and are held to the same decisions: queue orders,
telemetry rows, drift decisions, cache keys and files, and — through the
whole scheduler, with measured times pinned so drift is a function of
cache state alone — the same cache hits, configs, refinement and outputs
(rtol 2e-4 / atol 1e-3, the backend tolerance of
``tests/test_backends.py``).  The port runs on the CPU here.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
import torch

from repro.core.autotuner import TuningCache as JaxCache
from repro.launch.serve import adaptive_serve as jax_adaptive_serve
from repro.serving import AdaptiveScheduler as JaxScheduler
from repro.serving import DriftDetector as JaxDrift
from repro.serving import RequestQueue as JaxQueue
from repro.serving import TelemetryLog as JaxLog
from repro.serving import TelemetrySample as JaxSample
from repro.serving import VirtualClock as JaxClock
from repro.serving import WorkloadRequest as JaxRequest
from repro.serving import contention_factor as jax_contention
from repro.serving import make_trace as jax_make_trace
from repro.serving.telemetry import WIRE_FIELDS as JAX_WIRE_FIELDS
from repro.serving.telemetry import latency_stats as jax_latency_stats
from repro_torch.core.autotuner import TuningCache
from repro_torch.core.stream_config import SINGLE_STREAM
from repro_torch.core.streams import StreamedRunner
from repro_torch.core.workloads import get_workload
from repro_torch.launch.serve import adaptive_serve, resolve_serving_model
from repro_torch.serving import (POLICIES, AdaptiveScheduler, DriftDetector,
                                 RequestQueue, TelemetryLog,
                                 TelemetrySample, VirtualClock,
                                 WorkloadRequest, contention_factor,
                                 latency_stats, make_trace)
from repro_torch.serving.telemetry import WIRE_FIELDS

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-4, 1e-3
WORKLOADS = ["vecadd", "dotprod", "mvmult"]


class _CalibratedStub:
    """Speedup 1.0 for every config: the stable-sorted search picks
    single-stream, and predicted runtime is the profiled anchor."""

    def predict_configs(self, feats, candidates):
        F = np.asarray(feats)
        preds = np.ones((np.atleast_2d(F).shape[0], len(candidates)))
        return preds[0] if F.ndim == 1 else preds


class _RecordingRefitStub(_CalibratedStub):
    def __init__(self):
        self.refit_calls = []

    def refit(self, X, y, **kw):
        self.refit_calls.append(np.atleast_2d(X).shape[0])
        return 0.0


def _pinned(cls):
    """``measured_s`` pinned to the bucket's profiled single-stream
    anchor, as ``tests/test_serving.py`` pins the JAX scheduler: kernels
    really run, but drift is a pure function of cache state."""

    class Pinned(cls):
        def _execute(self, pending):
            outs, measured = super()._execute(pending)
            return outs, self._t_single.get(pending.key, measured)

    return Pinned


def _concat(outs):
    return np.concatenate([np.asarray(o) for o in outs], axis=0)


def _req(cls, workload="vecadd", rows=256, seed=0, **kw):
    wl = get_workload(workload)
    chunked, shared = wl.make_data(rows, np.random.default_rng(seed))
    return cls(workload=workload, chunked=chunked, shared=shared, **kw)


# -- queue, telemetry, drift: the pure-Python layers -------------------------


@pytest.mark.parametrize("policy", POLICIES)
def test_queue_orders_match_jax(policy):
    """Ten requests over three tenants with mixed priorities and
    deadlines (two already expired): both queues pop the same sequence
    and shed the same requests."""
    rng = np.random.default_rng(3)
    spec = [(f"t{rng.integers(3)}", int(rng.integers(4)),
             None if i % 4 == 3 else float(rng.uniform(-1.0, 5.0)))
            for i in range(10)]
    orders = []
    for q_cls, r_cls, clock in ((RequestQueue, WorkloadRequest, VirtualClock()),
                                (JaxQueue, JaxRequest, JaxClock())):
        q = q_cls(policy, clock=clock)
        for tenant, prio, dl in spec:
            q.push(r_cls(workload="vecadd", chunked={}, shared={},
                         tenant=tenant, priority=prio, deadline_s=dl))
        popped = []
        while q:
            try:
                popped.append(q.pop())
            except IndexError:
                break
        orders.append(([(r.seq, r.trace_id) for r in popped],
                       [r.seq for r in q.shed]))
    assert orders[0] == orders[1]
    assert len(orders[0][0]) + len(orders[0][1]) == 10


def test_telemetry_rows_and_summary_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(12):
        measured = float(rng.uniform(1e-4, 3e-3))
        predicted = None if i % 5 == 0 else float(rng.uniform(1e-4, 3e-3))
        rows.append(dict(
            seq=i + 1, tenant=f"tenant-{i % 3}",
            workload=WORKLOADS[i % 3], key=f"k{i % 4}",
            backend="host-sync", partitions=1 + i % 2, tasks=1 + i % 4,
            cache_hit=i >= 3, predicted_s=predicted, measured_s=measured,
            rel_error=(None if predicted is None
                       else abs(measured - predicted) / predicted),
            refined=i == 7, source="refined" if i > 7 else "model",
            status="ok" if i != 9 else "degraded",
            t_enqueue_s=float(i), t_retire_s=float(i) + measured,
            latency_s=measured + 0.001 * i,
            deadline_s=float(i) + 0.002 if i % 2 else None,
            slo_violation=bool(i % 4 == 1), trace_id=f"r{i:06d}"))
    texts, summaries = [], []
    for log_cls, sample_cls, name in ((TelemetryLog, TelemetrySample, "port"),
                                      (JaxLog, JaxSample, "jax")):
        path = str(tmp_path / f"{name}.jsonl")
        log = log_cls(path)
        for r in rows:
            log.append(sample_cls(**r))
        log.close()
        texts.append(Path(path).read_text())
        summaries.append(log.summary())
        assert log_cls.read(path) == log.samples
    assert texts[0] == texts[1]
    assert summaries[0] == summaries[1]
    assert WIRE_FIELDS == JAX_WIRE_FIELDS
    lats = [r["latency_s"] for r in rows]
    assert latency_stats(lats) == jax_latency_stats(lats)


def test_drift_and_contention_decisions_match_jax():
    rng = np.random.default_rng(7)
    kw = dict(window=6, threshold=0.8, min_samples=2, cooldown=2,
              load_discount=0.5)
    port, ref = DriftDetector(**kw), JaxDrift(**kw)
    for step in range(400):
        key = f"b{rng.integers(3)}"
        err = None if rng.random() < 0.1 else float(rng.exponential(0.7))
        load = float(rng.uniform(1.0, 4.0))
        fired = port.observe(key, err, load_factor=load)
        assert fired == ref.observe(key, err, load_factor=load), step
        if fired:
            port.reset(key)
            ref.reset(key)
        assert port.rolling_error(key) == ref.rolling_error(key)
    assert (port.triggers, port.suppressed) == (ref.triggers, ref.suppressed)
    assert port.triggers > 0 and port.suppressed > 0
    for inflight in range(1, 9):
        for cap in (None, 0.5, 1.0, 2.7, 8.0):
            for workers in (None, 0, 2, 4):
                assert contention_factor(inflight, cap, workers) == \
                    jax_contention(inflight, cap, workers)


def test_make_trace_arrays_match_jax():
    kw = dict(occurrences=2, tenants=3, scale_index=1, seed=4,
              priorities=(0, 2, 1))
    names = ["vecadd", "mvmult", "binomial", "jacobi-1d"]
    port, ref = make_trace(names, **kw), jax_make_trace(names, **kw)
    assert len(port) == len(ref) == 8
    for a, b in zip(port, ref):
        assert (a.workload, a.tenant, a.priority) == \
            (b.workload, b.tenant, b.priority)
        for mine, theirs in ((a.chunked, b.chunked), (a.shared, b.shared)):
            assert list(mine) == list(theirs)
            for k in mine:
                assert mine[k].dtype == theirs[k].dtype
                np.testing.assert_array_equal(mine[k], theirs[k])


def test_cache_keys_identical_and_files_cross_load(tmp_path):
    from repro.core.autotuner import TuneResult as JaxResult
    from repro_torch.core.autotuner import TuneResult
    from repro_torch.core.stream_config import StreamConfig

    trace = make_trace(["vecadd", "mvmult", "blackscholes"], occurrences=1,
                       scale_index=1, seed=0)
    for req in trace:
        for ns in ("", "tenant-3"):
            for tag in ("", "mlp-v001"):
                assert TuningCache.key(
                    req.workload, req.chunked, req.shared, "host-threads",
                    tag, namespace=ns) == JaxCache.key(
                    req.workload, req.chunked, req.shared, "host-threads",
                    tag, namespace=ns)
    port = TuningCache(str(tmp_path / "port.json"))
    ref = JaxCache(str(tmp_path / "jax.json"))
    for i, req in enumerate(trace):
        key = TuningCache.key(req.workload, req.chunked, req.shared,
                              "host-sync", "tag", namespace=f"t{i}")
        port.put(key, TuneResult(StreamConfig(2 ** i, 4), 1.5 + i, 1e-3,
                                 2e-4, backend="host-sync",
                                 source=("model", "refined", "model")[i]))
        ref.put(key, JaxResult(StreamConfig(2 ** i, 4), 1.5 + i, 1e-3,
                               2e-4, backend="host-sync",
                               source=("model", "refined", "model")[i]))
    port.save()
    ref.save()
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    into_jax = JaxCache(str(tmp_path / "port.json"))
    into_port = TuningCache(str(tmp_path / "jax.json"))
    assert into_jax.keys() == into_port.keys() == port.keys()
    for k in port.keys():
        assert into_jax.peek(k).to_json() == port.peek(k).to_json()
        assert into_port.peek(k).to_json() == ref.peek(k).to_json()


# -- the scheduler end to end --------------------------------------------------


def _end_to_end(sched_cls, req_cls, trace):
    """``tests/test_serving.py::test_end_to_end_adaptive_serving``'s
    sequence: serve the trace, poison the vecadd entry 40x, serve six
    more vecadd requests."""
    sched = _pinned(sched_cls)(
        _RecordingRefitStub(), backend="host-sync",
        drift=(DriftDetector if sched_cls is AdaptiveScheduler
               else JaxDrift)(window=8, threshold=6.0, min_samples=2,
                              cooldown=2),
        **({"device": "cpu"} if sched_cls is AdaptiveScheduler else {}))
    sched.submit_all(trace)
    first = sched.run()
    key = sched.cache.key("vecadd", trace[0].chunked, trace[0].shared,
                          "host-sync", "")
    entry = sched.cache.get(key)
    sched.cache.put(key, dataclasses.replace(
        entry, predicted_speedup=entry.predicted_speedup * 40.0))
    for seed in range(10, 16):
        sched.submit(_req(req_cls, "vecadd", rows=256, seed=seed))
    post = sched.run()
    return sched, first, post


def _pinned_profile(runner, configs, *, sweeps=3, prior=None):
    """The refiner's re-profiling with its times pinned: each probe
    config still runs once (its kernels really execute), but the times
    handed back grow with the slice count, so the refined entry is
    single-stream at speedup 1.0 in both packages and the drill's
    refinement count cannot depend on host noise."""
    for c in configs:
        runner.run(c, reps=1)
    return {c: 1e-3 * c.partitions * c.tasks for c in configs}


def test_end_to_end_trace_matches_jax(monkeypatch):
    import repro.serving.refinement as jax_refinement
    import repro_torch.serving.refinement as port_refinement

    monkeypatch.setattr(port_refinement, "profile_grid_interleaved",
                        _pinned_profile)
    monkeypatch.setattr(jax_refinement, "profile_grid_interleaved",
                        _pinned_profile)
    port, p_first, p_post = _end_to_end(
        AdaptiveScheduler, WorkloadRequest,
        make_trace(WORKLOADS, occurrences=2, seed=0))
    ref, r_first, r_post = _end_to_end(
        JaxScheduler, JaxRequest,
        jax_make_trace(WORKLOADS, occurrences=2, seed=0))

    assert [r.cache_hit for r in p_first] == [False] * 3 + [True] * 3
    for mine, theirs in ((p_first, r_first), (p_post, r_post)):
        assert [r.cache_hit for r in mine] == [r.cache_hit for r in theirs]
        assert [r.config.as_tuple() for r in mine] == \
            [r.config.as_tuple() for r in theirs]
        assert [r.refined for r in mine] == [r.refined for r in theirs]
        assert [r.sample.rel_error for r in mine] == pytest.approx(
            [r.sample.rel_error for r in theirs], rel=1e-9)
        assert [r.sample.source for r in mine] == \
            [r.sample.source for r in theirs]
        assert [r.sample.key for r in mine] == [r.sample.key for r in theirs]
        for a, b in zip(mine, theirs):
            np.testing.assert_allclose(_concat(a.outputs), _concat(b.outputs),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=a.request.workload)
    assert dict(port.stats) == dict(ref.stats)
    assert port.stats["refinements"] == 1 and port.stats["model_searches"] == 3
    assert len(port.model.refit_calls) == 1
    refined_at = next(i for i, r in enumerate(p_post) if r.refined)
    assert p_post[refined_at].sample.rel_error == pytest.approx(39.0)
    assert all(r.cache_hit and r.sample.source == "refined"
               and r.sample.rel_error == 0.0
               for r in p_post[refined_at + 1:])
    # the port's outputs against its own single-stream reference as well
    for r in p_first + p_post:
        want = _concat(StreamedRunner(
            get_workload(r.request.workload), r.request.chunked,
            r.request.shared, device="cpu").dispatch(SINGLE_STREAM))
        np.testing.assert_allclose(_concat(r.outputs), want, rtol=RTOL,
                                   atol=ATOL)


def test_adaptive_serve_returns_the_jax_summary(tmp_path):
    kw = dict(n_requests=3, model="heuristic", verbose=False,
              tenants=2, window=1)
    port = adaptive_serve(WORKLOADS, device="cpu",
                          trace_out=str(tmp_path / "p.json"),
                          metrics_out=str(tmp_path / "pm.json"), **kw)
    ref = jax_adaptive_serve(WORKLOADS, trace_out=str(tmp_path / "j.json"),
                             metrics_out=str(tmp_path / "jm.json"), **kw)
    # the port adds the device it served on, and nothing else
    assert set(port) == set(ref) | {"device"} and port["device"] == "cpu"
    assert set(port["metrics"]) == set(ref["metrics"])
    for key in ("requests", "cache_hits", "refinements", "isolate_tenants",
                "window", "backend", "policy", "model", "shed"):
        assert port[key] == ref[key], key
    assert port["requests"] == 3
    for name in ("p.json", "p.jsonl", "pm.json"):
        text = (tmp_path / name).read_text()
        if name.endswith(".jsonl"):
            assert all(json.loads(line) for line in text.splitlines())
        else:
            assert json.loads(text)


def test_entry_points_refuse_without_cuda(monkeypatch, tmp_path):
    from repro_torch.core.autotuner import AutoTuner
    from repro_torch.core.modeling.registry import ModelRegistry
    from repro_torch.launch.train_model import bootstrap_artifact
    from repro_torch.serving import ConcurrentScheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: AdaptiveScheduler(_CalibratedStub()),
                 lambda: ConcurrentScheduler(_CalibratedStub(), window=2),
                 lambda: AutoTuner(_CalibratedStub()),
                 lambda: resolve_serving_model("heuristic"),
                 lambda: adaptive_serve(n_requests=1, model="heuristic",
                                        verbose=False),
                 lambda: bootstrap_artifact(ModelRegistry(tmp_path),
                                            verbose=False)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_cli_refuses_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the CLI would serve on the card")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--adaptive",
            "--model", "heuristic", "--requests", "1"]
    proc = subprocess.run(base, capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "throughput_rps" not in proc.stdout
    proc = subprocess.run(base + ["--device", "cpu"], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout)
    assert summary["requests"] == 1 and summary["device"] == "cpu"


def test_serving_path_waits_on_no_whole_device():
    """The runner, the backends, the context swap, the feature timers,
    the capacity probe, the scheduler and the engine wait on their own
    stream or event, never on every stream of the card."""
    files = [ROOT / "src" / "repro_torch" / "core" / f
             for f in ("streams.py", "features.py", "autotuner.py")]
    files += sorted((ROOT / "src" / "repro_torch" / "core" / "backends").glob("*.py"))
    files += sorted((ROOT / "src" / "repro_torch" / "serving").rglob("*.py"))
    files.append(ROOT / "src" / "repro_torch" / "device.py")
    for f in files:
        text = f.read_text()
        assert "torch.cuda.synchronize" not in text, f
        assert "device.synchronize" not in text and \
            "import synchronize" not in text, f
