"""The port's concurrent serving engine against its serial scheduler and
the JAX package's engine.

Same trace (numpy inputs from one seed) through the port's
``ConcurrentScheduler`` at window 4, the port's serial scheduler and the
JAX package's engine: results in decision order, the same configs and
cache hits, outputs within rtol 2e-4 / atol 1e-3 (the backend tolerance
of ``tests/test_backends.py``), on ``host-sync`` and on ``host-threads``.
Also the engine's own machinery: ordered retirement under any completion
order, the watchdog's zombie futures, pooled contexts, and feature
tracing on the coordinator while a worker thread runs real kernels.  The
port runs on the CPU here.
"""
import itertools
import threading

import numpy as np
import pytest

from repro.serving import ConcurrentScheduler as JaxEngine
from repro.serving import DriftDetector as JaxDrift
from repro.serving import make_trace as jax_make_trace
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
from repro_torch.core.features import extract_features
from repro_torch.core.stream_config import SINGLE_STREAM, StreamConfig
from repro_torch.core.streams import StreamedRunner
from repro_torch.core.workloads import get_workload
from repro_torch.serving import (AdaptiveScheduler, ConcurrentScheduler,
                                 ContextPool, DriftDetector, FaultPlan,
                                 FaultSpec, MetricsRegistry, OrderedRetirer,
                                 ResiliencePolicy, WorkloadRequest,
                                 make_trace)

RTOL, ATOL = 2e-4, 1e-3
WORKLOADS = ["vecadd", "dotprod", "mvmult"]
# static features: everything before the timed t_single_us
N_STATIC = 18


class _BatchedStub:
    """Constant predictor for (F,) and (B, F) inputs that records every
    call's batch size."""

    def __init__(self):
        self.calls = []

    def predict_configs(self, feats, candidates):
        F = np.atleast_2d(np.asarray(feats))
        self.calls.append(F.shape[0])
        preds = np.ones((F.shape[0], len(candidates)))
        return preds[0] if np.ndim(feats) == 1 else preds


class _WideStub(_BatchedStub):
    """Prefers more tasks, so the engine dispatches split configs."""

    def predict_configs(self, feats, candidates):
        super().predict_configs(feats, candidates)
        score = np.array([np.log2(c.tasks) + 0.1 * np.log2(c.partitions)
                          for c in candidates])
        F = np.atleast_2d(np.asarray(feats))
        preds = np.tile(score, (F.shape[0], 1))
        return preds[0] if np.ndim(feats) == 1 else preds


def _lenient(cls=DriftDetector):
    return cls(threshold=1e9)


def _concat(outs):
    return np.concatenate([np.asarray(o) for o in outs], axis=0)


def _req(workload="vecadd", rows=256, seed=0, **kw):
    wl = get_workload(workload)
    chunked, shared = wl.make_data(rows, np.random.default_rng(seed))
    return WorkloadRequest(workload=workload, chunked=chunked,
                           shared=shared, **kw)


@pytest.mark.parametrize("backend", ["host-sync", "host-threads"])
def test_engine_matches_serial_port_and_jax_engine(backend):
    serial = AdaptiveScheduler(_WideStub(), device="cpu", backend=backend,
                               drift=_lenient())
    engine = ConcurrentScheduler(_WideStub(), window=4, device="cpu",
                                 backend=backend, drift=_lenient())
    ref = JaxEngine(_WideStub(), window=4, backend=backend,
                    drift=_lenient(JaxDrift), capacity=2.0)
    serial.submit_all(make_trace(WORKLOADS, occurrences=3, seed=0))
    engine.submit_all(make_trace(WORKLOADS, occurrences=3, seed=0))
    ref.submit_all(jax_make_trace(WORKLOADS, occurrences=3, seed=0))
    rs, rc, rj = serial.run(), engine.run(), ref.run()
    engine.close()
    ref.close()

    assert len(rs) == len(rc) == len(rj) == 9
    # decision order: results line up with the trace's arrival sequence
    assert [r.request.seq for r in rc] == list(range(9))
    assert [r.request.seq for r in rj] == list(range(9))
    want = [r.config.as_tuple() for r in rs]
    assert max(t for _, t in want) > 1          # split configs dispatched
    assert [r.config.as_tuple() for r in rc] == want
    assert [r.config.as_tuple() for r in rj] == want
    assert [r.cache_hit for r in rc] == [r.cache_hit for r in rs] == \
        [r.cache_hit for r in rj]
    assert [r.sample.key for r in rc] == [r.sample.key for r in rj]
    for a, b, c in zip(rs, rc, rj):
        assert len(b.outputs) == b.config.partitions * b.config.tasks
        np.testing.assert_allclose(_concat(b.outputs), _concat(a.outputs),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=a.request.workload)
        np.testing.assert_allclose(_concat(b.outputs), _concat(c.outputs),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=a.request.workload)
    for key in ("requests", "cache_hits", "cold_misses", "model_searches",
                "batched_searches", "refinements"):
        assert engine.stats[key] == ref.stats[key], key
    assert engine.stats["batched_searches"] >= 1
    assert engine.parallel_capacity >= 1.0      # probed on the CPU


def test_ordered_retirer_deterministic_under_any_completion_order():
    dispatch = ["a", "a", "b", "a", "b"]
    for perm in itertools.permutations(range(len(dispatch))):
        retirer = OrderedRetirer()
        issued = [(key, retirer.issue(key)) for key in dispatch]
        flushed: dict[str, list] = {"a": [], "b": []}
        for i in perm:
            key, idx = issued[i]
            flushed[key].extend(retirer.complete(key, idx, (key, idx)))
        assert retirer.held == 0
        assert flushed["a"] == [("a", 0), ("a", 1), ("a", 2)]
        assert flushed["b"] == [("b", 0), ("b", 1)]


def _counter(metrics, name):
    return sum(v["value"] for v in metrics.snapshot()[name]["values"])


def test_watchdog_reaps_zombie_and_requeue_serves():
    """A dispatch held past the watchdog is abandoned (its future parks
    as a zombie), its request re-dispatched on a fresh runner and served;
    close() joins the zombie and its context comes back to the pool."""
    faults = FaultPlan([FaultSpec(site="dispatch", kind="latency",
                                  at=(0,), delay_s=0.4)])
    eng = ConcurrentScheduler(
        _BatchedStub(), window=2, workers=2, device="cpu",
        drift=_lenient(), faults=faults,
        resilience=ResiliencePolicy(watchdog_s=0.08),
        metrics=MetricsRegistry())
    eng.submit(_req(seed=0))
    (r,) = eng.run()
    assert r.status == "served" and len(r.outputs)
    np.testing.assert_allclose(_concat(r.outputs),
                               r.request.chunked["a"] + r.request.chunked["b"],
                               rtol=RTOL, atol=ATOL)
    assert eng.stats["watchdog_fired"] == 1
    assert _counter(eng.metrics, "serving.watchdog.fired") == 1
    eng.close()                         # joins the abandoned zombie
    assert not eng._zombies
    assert sum(len(v) for v in eng.ctx_pool._free.values()) == 2


def test_watchdog_requeue_exhausted_times_out_individually():
    faults = FaultPlan([FaultSpec(site="dispatch", kind="latency",
                                  at=(0, 1), delay_s=0.3)])
    eng = ConcurrentScheduler(
        _BatchedStub(), window=2, workers=2, device="cpu",
        drift=_lenient(), faults=faults,
        resilience=ResiliencePolicy(watchdog_s=0.05),
        metrics=MetricsRegistry())
    eng.submit(_req(seed=0))
    (r,) = eng.run()
    assert r.status == "timeout" and "watchdog" in r.error
    assert r.sample.status == "timeout" and r.sample.measured_s is None
    assert eng.stats["watchdog_fired"] == 2
    eng.close()
    assert not eng._zombies


def test_failed_execution_releases_resources_and_bucket():
    class Flaky(ConcurrentScheduler):
        def _execute(self, pending):
            if pending.req.tenant == "boom":
                raise RuntimeError("injected")
            return super()._execute(pending)

    eng = Flaky(_BatchedStub(), window=4, device="cpu", drift=_lenient())
    eng.submit_all([_req(tenant="ok0", seed=0), _req(tenant="boom", seed=1),
                    _req(tenant="ok1", seed=2), _req(tenant="ok2", seed=3)])
    with pytest.raises(RuntimeError, match="injected"):
        eng.run()
    assert eng.retirer.held == 0
    served = {s.tenant for s in eng.telemetry}
    assert "boom" not in served and {"ok0", "ok1", "ok2"} <= served
    eng.submit(_req(tenant="after", seed=4))
    (res,) = eng.run()
    assert res.request.tenant == "after" and res.cache_hit
    eng.close()


def test_context_pool_recycles_and_swaps_buffers():
    pool = ContextPool("cpu")
    wl = get_workload("mvmult")
    rng = np.random.default_rng(0)
    c1, s1 = wl.make_data(128, rng)
    ctx1 = pool.lease(wl, c1, s1)
    pool.release(wl.name, ctx1)
    c2, s2 = wl.make_data(128, rng)
    ctx2 = pool.lease(wl, c2, s2)
    assert ctx2 is ctx1 and pool.reuses == 1
    runner = StreamedRunner(wl, c2, s2, device="cpu", ctx=ctx2)
    np.testing.assert_allclose(_concat(runner.dispatch(StreamConfig(1, 2))),
                               c2["A"] @ s2["v"], rtol=RTOL, atol=ATOL)
    assert pool.lease(wl, c1, s1) is not ctx2      # ctx2 still leased


def test_stream_pairs_go_back_when_execution_ends_not_at_retire(monkeypatch):
    """A slow first dispatch holds its bucket: every later request of the
    bucket executes and then waits to retire in dispatch order, leased,
    so the engine leases far more contexts than its window.  Each one's
    stream pair must go back when its execution ends; held to retire, the
    pairs of a card run a fault plan through outgrow CUDA's 32 pooled
    streams and every later request fails."""
    leased, most = set(), [0]
    lease, release = ContextPool.lease, ContextPool.release

    def counting_lease(self, *args):
        ctx = lease(self, *args)
        leased.add(id(ctx))
        most[0] = max(most[0], len(leased))
        return ctx

    def counting_release(self, name, ctx):
        leased.discard(id(ctx))
        return release(self, name, ctx)

    monkeypatch.setattr(ContextPool, "lease", counting_lease)
    monkeypatch.setattr(ContextPool, "release", counting_release)
    faults = FaultPlan([FaultSpec(site="dispatch", kind="latency", at=(0,),
                                  delay_s=0.3)])
    eng = ConcurrentScheduler(_BatchedStub(), window=4, workers=2,
                              device="cpu", drift=_lenient(), faults=faults)
    eng.submit_all([_req(seed=0) for _ in range(24)])
    results = eng.run()
    assert [r.status for r in results] == ["served"] * 24
    assert most[0] > eng.window          # the bucket held its completions
    assert eng.ctx_pool.max_attached <= eng.window
    assert not leased
    eng.close()


def test_features_traced_while_another_thread_dispatches():
    """The coordinator traces a kernel (``make_fx`` on fake tensors under
    ``FlopCounterMode``) while a worker thread runs real kernels: the
    dispatch modes are thread-local, so the trace sees none of the
    worker's ops and the worker computes real numbers throughout."""
    wl = get_workload("blackscholes")
    chunked, shared = wl.make_data(wl.datasets[0], np.random.default_rng(0))
    traced = StreamedRunner(wl, chunked, shared, device="cpu")
    alone = extract_features(traced, profile=False).values[:N_STATIC]

    busy = StreamedRunner(get_workload("sgemm"), *get_workload(
        "sgemm").make_data(64, np.random.default_rng(1)), device="cpu")
    want = _concat(busy.dispatch(StreamConfig(2, 2)))
    stop = threading.Event()
    worker_errs, rounds = [], [0]

    def work():
        while not stop.is_set():
            got = _concat(busy.dispatch(StreamConfig(2, 2)))
            if not np.allclose(got, want, rtol=RTOL, atol=ATOL):
                worker_errs.append(float(np.abs(got - want).max()))
            rounds[0] += 1

    t = threading.Thread(target=work, daemon=True)
    t.start()
    try:
        feats = [extract_features(traced, profile=False).values[:N_STATIC]
                 for _ in range(5)]
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()
    assert rounds[0] > 0 and not worker_errs
    for f in feats:
        np.testing.assert_array_equal(f, alone)


class _RoundRobinStream:
    """Stands in for ``torch.cuda.Stream``: hands out the 4 handles of a
    pool round-robin, as PyTorch's per-device stream pool does."""
    POOL = 4
    _next = itertools.count()

    def __init__(self, device=None):
        self.device_index = 0
        self.cuda_stream = 0x1000 + next(self._next) % self.POOL


def test_new_stream_never_hands_one_pooled_stream_to_two_owners(monkeypatch):
    import torch

    from repro_torch.core.backends import (WindowedPool, base, new_stream,
                                           release_stream)
    monkeypatch.setattr(torch.cuda, "Stream", _RoundRobinStream)
    monkeypatch.setattr(base, "_CLAIMED", set())
    held = [new_stream("cuda") for _ in range(_RoundRobinStream.POOL)]
    assert len({s.cuda_stream for s in held}) == _RoundRobinStream.POOL
    with pytest.raises(RuntimeError, match="every pooled CUDA stream"):
        new_stream("cuda")
    release_stream(held[1])
    assert new_stream("cuda", claim=False).cuda_stream == held[1].cuda_stream
    # pool threads claim a stream each until the pool shuts down
    release_stream(held[2], held[3])
    pool = WindowedPool(workers=2, window=2)
    start = threading.Barrier(2)

    def own(_):
        start.wait()
        return pool.thread_stream("cuda").cuda_stream

    got = list(pool.executor().map(own, range(2)))
    assert len(set(got)) == 2 and set(got) <= {s.cuda_stream for s in held[1:]}
    assert len(base._CLAIMED) == _RoundRobinStream.POOL - 1
    pool.shutdown()
    assert base._CLAIMED == {(0, held[0].cuda_stream)}


def test_windowed_pool_builds_one_executor_under_concurrent_first_use():
    from repro_torch.core.backends import WindowedPool
    pool = WindowedPool(workers=2, window=2)
    start = threading.Barrier(8)
    got = []

    def first_use():
        start.wait()
        got.append(pool.executor())

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(got) == 8 and all(e is got[0] for e in got)
    pool.shutdown()
    assert pool._pool is None
