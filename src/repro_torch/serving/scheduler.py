"""The adaptive serving scheduler: the paper's feature → model → config
loop, run online over a multi-tenant request stream.

Per request, the decision point is exactly paper §3.3 ("used as a utility
to quickly search for a good configuration at runtime"), made cheap
enough to sit on the serving path:

  warm path   TuningCache hit (microseconds) → dispatch immediately;
  cold path   extract features (one profiled iteration), rank the config
              space with the performance model via ``search_best``,
              cache the winner, dispatch.

Every dispatch appends a :class:`~repro_torch.serving.telemetry.TelemetrySample`
(chosen config, predicted vs. measured runtime) to the telemetry log, and
feeds the relative prediction error to the
:class:`~repro_torch.serving.refinement.DriftDetector`.  A triggered bucket is
handed to the :class:`~repro_torch.serving.refinement.Refiner`, which
re-profiles a small candidate set, refreshes the cache entry, and refits
the model incrementally — closing the offline-learn / online-correct
loop.

Every request runs on the scheduler's ``device`` (the card unless
``device="cpu"``): its runner pins the request's chunked arrays and
uploads its shared ones at decide time, and the execute stage waits on
the request's own stream, never on the whole device.
"""
from __future__ import annotations

import collections
import dataclasses
import random
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import features as feat_lib
from repro_torch.core.autotuner import TuneResult, TuningCache
from repro_torch.core.backends import get_backend
from repro_torch.core.features import RAW_FEATURE_NAMES
# re-exported for back-compat: the heuristic used to be defined here
from repro_torch.core.modeling.heuristic import OverlapHeuristicModel  # noqa: F401
from repro_torch.core.modeling.search import search_best, search_best_batch
from repro_torch.core.stream_config import SINGLE_STREAM, StreamConfig, \
    default_space
from repro_torch.core.streams import StreamedRunner, readback_outputs
from repro_torch.core.workloads import get_workload
from repro_torch.device import resolve_device
from repro_torch.serving.clock import SystemClock
from repro_torch.serving.observability import NULL_METRICS, NULL_TRACER, STAGES
from repro_torch.serving.queue import RequestQueue, WorkloadRequest
from repro_torch.serving.refinement import DriftDetector, Refiner
from repro_torch.serving.resilience import NULL_FAULTS, CircuitBreaker, \
    FaultPlan, ResiliencePolicy, call_with_retry, nearest_bucket_entry
from repro_torch.serving.telemetry import TelemetryLog, TelemetrySample, \
    relative_error
from repro_torch.serving.tenancy import TenantContext, TenantRegistry

_I_T_SINGLE = RAW_FEATURE_NAMES.index("t_single_us")


@dataclasses.dataclass
class RequestResult:
    request: WorkloadRequest
    config: Optional[StreamConfig]
    outputs: list                  # per-slice outputs, task-major order
    measured_s: Optional[float]
    predicted_s: Optional[float]
    cache_hit: bool
    refined: bool
    sample: TelemetrySample
    #: terminal disposition: "served" | "degraded" (served via a
    #: fallback rung) | "failed" | "timeout" — a request is NEVER lost;
    #: under a ResiliencePolicy every submitted request retires with one
    #: of these instead of crashing the scheduler
    status: str = "served"
    error: Optional[str] = None


@dataclasses.dataclass
class PendingRequest:
    """One request mid-flight through the decide → dispatch → retire
    pipeline.  The serial scheduler runs all three stages back to back;
    the concurrent engine (:mod:`repro_torch.serving.engine`) holds many of
    these in its in-flight window at once."""

    req: WorkloadRequest
    runner: StreamedRunner
    key: str
    n_rows: int
    entry: Optional[TuneResult] = None
    cache_hit: bool = False
    needs_anchor: bool = False     # warm persisted hit, anchor unprofiled
    order: int = -1                # global decision order
    bucket_idx: int = -1           # per-bucket dispatch index
    tenant_ctx: Optional[TenantContext] = None
    inflight: int = 1              # window occupancy at dispatch (engine)
    load_factor: float = 1.0       # contention normalization, set at retire
    defer_release: bool = False    # engine: runner held for a deferred
                                   # refinement, released after it runs
    # latency accounting stamps (scheduler clock; arrival lives on req)
    t_decide_s: Optional[float] = None
    t_dispatch_s: Optional[float] = None
    queue_depth: int = 0           # queue length observed at decide time
    # resilience bookkeeping (all inert without a ResiliencePolicy)
    degraded_via: Optional[str] = None   # first fallback rung taken
    requeues: int = 0              # watchdog re-dispatch count (engine)
    watchdog_deadline_s: Optional[float] = None


class AdaptiveScheduler:
    """Drains a :class:`RequestQueue`, making one model-informed placement
    decision per request and learning from every measurement."""

    def __init__(self, model, *,
                 device="cuda",
                 backend: str = "host-sync",
                 policy: str = "fifo",
                 cache: Optional[TuningCache] = None,
                 candidates: Optional[Sequence[StreamConfig]] = None,
                 telemetry: Optional[TelemetryLog] = None,
                 drift: Optional[DriftDetector] = None,
                 refiner: Optional[Refiner] = None,
                 model_tag: str = "",
                 isolate_tenants: bool = False,
                 tenants: Optional[TenantRegistry] = None,
                 warm_before_measure: bool = True,
                 keep_outputs: bool = True,
                 clock=None,
                 tracer=None,
                 metrics=None,
                 faults: Optional[FaultPlan] = None,
                 resilience: Optional[ResiliencePolicy] = None):
        self.model = model
        # every request's runner, and the engine's context pool and
        # capacity probe, live on this device
        self.device = resolve_device(device)
        self.backend_name = backend
        # ONE time source for every latency stamp, deadline judgment,
        # span timestamp, and tuning-overhead measurement: real
        # perf_counter in production, a VirtualClock under the trace
        # harness / timing tests (repro_torch.serving.clock).  The queue, the
        # refiner, and the tracer are all bound to this same instance
        # below, so their clocks can never disagree.
        self.clock = clock if clock is not None else SystemClock()
        # observability: both default to shared no-op singletons whose
        # hot-path calls allocate nothing (asserted by a micro-test)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if self.tracer.enabled and self.tracer.clock is None:
            self.tracer.clock = self.clock
        self.metrics = metrics if metrics is not None else NULL_METRICS
        self.queue = RequestQueue(policy, clock=self.clock,
                                  metrics=self.metrics)
        self.cache = cache if cache is not None else TuningCache()
        self.candidates = list(candidates or default_space())
        self.telemetry = telemetry if telemetry is not None else TelemetryLog()
        self.drift = drift if drift is not None else DriftDetector()
        self.refiner = refiner if refiner is not None else Refiner(
            model, self.cache, candidates=self.candidates)
        if self.refiner.clock is None:
            self.refiner.clock = self.clock
        # pre-bound instruments: hot-path metric updates are one method
        # call on a resolved object (a no-op singleton when disabled)
        m = self.metrics
        self._m_stage = {s: m.histogram(f"serving.stage.{s}.seconds")
                         for s in STAGES}
        self._m_requests = m.counter("serving.requests")
        self._m_searches = m.counter("serving.model.searches")
        self._m_batch_size = m.histogram("serving.cold_batch.size",
                                         buckets=(1, 2, 4, 8, 16, 32, 64))
        self._m_drift_fired = m.counter("serving.drift.fired")
        self._m_refinements = m.counter("serving.refinements")
        self._m_slo_violations = m.counter("serving.slo.violations")
        self._m_queue_depth = m.gauge("serving.queue.depth")
        self._m_inflight = m.gauge("serving.inflight")
        self._m_fault_recovered = m.counter("serving.faults.recovered")
        self._m_fault_degraded = m.counter("serving.faults.degraded")
        self._m_failed = m.counter("serving.requests.failed")
        # fault tolerance: OFF unless a policy is given — every resilient
        # wrapper below passes straight through when self.resilience is
        # None, so the legacy (raise-on-error) behavior is bit-identical
        self.faults = faults if faults is not None else NULL_FAULTS
        if self.faults.enabled:
            self.faults.bind(metrics=self.metrics)
        self.resilience = resilience
        self.breaker: Optional[CircuitBreaker] = None
        if resilience is not None:
            self.breaker = CircuitBreaker(resilience.breaker,
                                          clock=self.clock,
                                          metrics=self.metrics)
            self._fallback_model = OverlapHeuristicModel()
        # tenant isolation: with ``isolate_tenants`` every tenant gets a
        # private cache namespace, drift windows, and (on first refit) a
        # fork of the shared base model.  Off by default — the registry
        # then resolves every tenant to ONE shared context whose drift
        # detector is ``self.drift``, i.e. the pre-tenancy behavior.
        self.tenancy = tenants if tenants is not None else TenantRegistry(
            model, self.drift, isolate=isolate_tenants)
        self.model_tag = model_tag
        self.warm_before_measure = warm_before_measure
        self.keep_outputs = keep_outputs
        self.stats: collections.Counter = collections.Counter()
        # per-bucket serving state: raw program features and the profiled
        # single-stream runtime (the model predicts *speedup*; runtime
        # prediction needs the single-stream anchor)
        self._feats: dict[str, np.ndarray] = {}
        self._t_single: dict[str, float] = {}
        self._warmed: set = set()
        self._seq = 0
        self._order = 0
        # candidate (partitions, tasks) columns, computed once: feasibility
        # filtering and the vectorized heuristic never loop over configs
        self._cand_parts, self._cand_tasks = feat_lib.config_pt_arrays(
            self.candidates)
        self._cand_cost = self._cand_parts * self._cand_tasks

    # -- request intake -------------------------------------------------------

    def submit(self, request: WorkloadRequest) -> WorkloadRequest:
        if request.arrival_s is None:
            request.arrival_s = self.clock.now()
        self.stats[f"tenant.{request.tenant}.submitted"] += 1
        return self.queue.push(request)

    def submit_all(self, requests) -> None:
        for r in requests:
            self.submit(r)

    # -- serving loop ---------------------------------------------------------

    def run(self, max_requests: Optional[int] = None) -> list[RequestResult]:
        """Drain the queue (up to ``max_requests``), one decision per
        request, in queue-policy order."""
        results = []
        while self.queue and (max_requests is None
                              or len(results) < max_requests):
            try:
                req = self.queue.pop()
            except IndexError:
                break      # deadline policy shed everything that was left
            results.append(self._process(req))
        return results

    def step(self) -> RequestResult:
        return self._process(self.queue.pop())

    def _process(self, req: WorkloadRequest) -> RequestResult:
        """Serial pipeline: decide → (cold tune) → execute → retire, all
        on the calling thread.  The concurrent engine reuses exactly
        these stages, overlapped."""
        if self.resilience is None:
            pending = self._decide(req)
            if pending.needs_anchor:
                self._measure_anchor(pending)
            if pending.entry is None:
                self._tune_cold(pending)
            outs, measured_s = self._execute(pending)
            result = self._retire(pending, outs, measured_s)
            self._release_runner(pending.runner)
            return result
        # resilient pipeline: any stage error fails THIS request
        # individually (error telemetry sample + status), never the loop
        pending = None
        try:
            pending = self._decide(req)
            if pending.needs_anchor:
                self._try_anchor(pending)
            if pending.entry is None:
                self._tune_cold_safe(pending)
            outs, measured_s = self._execute_safe(pending)
            result = self._retire(pending, outs, measured_s)
        # the per-request fault barrier: ANY stage failure
        # becomes an individual terminal result, never a
        # scheduler crash
        except Exception as e:  # noqa: BLE001
            result = self._fail_request(req, pending, e)
        finally:
            if pending is not None:
                self._release_runner(pending.runner)
        return result

    def _try_anchor(self, pending: PendingRequest) -> None:
        """The anchor is advisory (it only re-enables runtime prediction
        and drift for a persisted warm hit): under a resilience policy a
        failing anchor measurement is skipped, not fatal."""
        try:
            self._measure_anchor(pending)
        except Exception:  # noqa: BLE001 — advisory stage
            pending.needs_anchor = False

    # -- stage 1: decide ------------------------------------------------------

    def _make_runner(self, req: WorkloadRequest) -> StreamedRunner:
        """One runner per request: each request carries its OWN shared
        buffers, so a cached ExecutionContext would serve stale
        shared_dev data.  Building it pins the request's chunked arrays
        and uploads its shared ones — charged to the decide stage, as the
        JAX package uploads ``shared`` untimed, never to ``measured_s``.
        The concurrent engine overrides this with a context pool that
        swaps the per-request buffers instead of rebuilding."""
        return StreamedRunner(get_workload(req.workload), req.chunked,
                              req.shared, device=self.device,
                              backend=self.backend_name)

    def _release_runner(self, runner: StreamedRunner) -> None:
        """Hook for the engine's context pool; serial runners are
        garbage."""

    def _decide(self, req: WorkloadRequest) -> PendingRequest:
        """Cache lookup + anchor bookkeeping.  A returned ``entry=None``
        means the request is cold and needs a tune before dispatch."""
        t0 = self.clock.now()
        with self.tracer.span("decide", trace_id=req.trace_id,
                              tenant=req.tenant, workload=req.workload):
            # fired before the runner lease so an injected decide error
            # never leaks a pooled ExecutionContext
            self.faults.fire("decide")
            runner = self._make_runner(req)
            n_rows = next(iter(req.chunked.values())).shape[0]
            ctx = self.tenancy.get(req.tenant)
            key = self.cache.key(runner.wl.name, req.chunked, req.shared,
                                 self.backend_name, self.model_tag,
                                 namespace=ctx.namespace)
            pending = PendingRequest(req=req, runner=runner, key=key,
                                     n_rows=n_rows, order=self._order,
                                     tenant_ctx=ctx,
                                     t_decide_s=self.clock.now(),
                                     queue_depth=len(self.queue))
            self._order += 1
            hit = self.cache.get(key, valid=lambda r: (
                r.config.partitions * r.config.tasks <= n_rows))
            if hit is not None:
                pending.entry, pending.cache_hit = hit, True
                # warm hit from a cache persisted by a previous process:
                # the single-stream anchor was never profiled here, and
                # without it predicted runtime — and therefore drift
                # detection — would stay disabled for this bucket.
                # Deferred to _measure_anchor so the engine can quiesce
                # its pool first (an anchor measured under contention
                # would bias rel_error for the bucket's lifetime).
                pending.needs_anchor = key not in self._t_single
        self._m_queue_depth.set(len(self.queue))
        self._m_stage["decide"].observe(self.clock.now() - t0)
        return pending

    def _measure_anchor(self, pending: PendingRequest) -> None:
        """One measured single-stream run restores the runtime anchor
        (and with it drift detection) for a persisted warm hit."""
        if pending.key not in self._t_single:
            with self.tracer.span("tune.anchor",
                                  trace_id=pending.req.trace_id,
                                  key=pending.key):
                self._t_single[pending.key] = pending.runner.run(
                    SINGLE_STREAM, reps=1)
        pending.needs_anchor = False

    # -- stage 1b: cold tune --------------------------------------------------

    def _feasible_configs(self, n_rows: int) -> list[StreamConfig]:
        # guard: an empty filtered list would make search_best fall back
        # to the FULL default grid, returning an unsplittable config
        mask = self._cand_cost <= n_rows
        return [c for c, ok in zip(self.candidates, mask)
                if ok] or [SINGLE_STREAM]

    def _extract(self, pending: PendingRequest) -> np.ndarray:
        feats = feat_lib.extract_features(pending.runner, profile_reps=1)
        self._feats[pending.key] = feats.values
        self._t_single[pending.key] = \
            float(feats.values[_I_T_SINGLE]) * 1e-6
        return feats.values

    def _model_for(self, pending: PendingRequest):
        """The model that ranks configs for this request: the tenant's
        fork once it has refitted, the shared base before that."""
        if pending.tenant_ctx is not None:
            return pending.tenant_ctx.active_model
        return self.model

    def _tune_cold(self, pending: PendingRequest, *,
                   model=None, source: str = "model") -> TuneResult:
        t0 = self.clock.now()
        with self.tracer.span("tune.cold", trace_id=pending.req.trace_id,
                              workload=pending.req.workload):
            self.faults.fire("tune.cold")
            feats = self._extract(pending)
            t_feat = self.clock.now() - t0
            cands = self._feasible_configs(pending.n_rows)
            best, preds, t_search = search_best(
                model if model is not None else self._model_for(pending),
                feats, cands)
            self.stats["model_searches"] += 1
            self._m_searches.inc()
            result = TuneResult(best, float(np.max(preds)), t_feat, t_search,
                                backend=self.backend_name, source=source)
            self.cache.put(pending.key, result)
            pending.entry = result
        self._m_stage["tune"].observe(self.clock.now() - t0)
        return result

    def _tune_cold_batch(self, pendings: Sequence[PendingRequest]) -> None:
        """The batched cold path: extract features once per unique
        bucket (profiling is measurement — it stays serial), then rank
        the config space for ALL cold buckets with ONE batched
        ``predict_configs`` call over the ``(B, F)`` feature matrix.

        Per-request feasibility (row counts differ across buckets) is a
        ``-inf`` mask into the shared prediction matrix, which keeps each
        pick identical to what a serial ``search_best`` over that
        request's filtered candidates would have returned.

        Tenant isolation: buckets are grouped by the model that must
        rank them — tenants that have forked search with their own
        model, so one batched search per DISTINCT model (one total until
        any tenant forks)."""
        # one representative pending per unique bucket, first-seen order
        by_key: dict[str, PendingRequest] = {}
        for p in pendings:
            by_key.setdefault(p.key, p)
        uniques = list(by_key.values())

        t_batch0 = self.clock.now()
        self._m_batch_size.observe(len(uniques))
        with self.tracer.span("tune.cold.batch",
                              trace_id=uniques[0].req.trace_id,
                              buckets=len(uniques),
                              requests=len(pendings)):
            self.faults.fire("tune.cold")
            t0 = self.clock.now()
            F = np.stack([self._extract(p) for p in uniques])
            t_feat = self.clock.now() - t0
            feasible = np.stack(
                [self._cand_cost <= p.n_rows for p in uniques])

            groups: dict[int, list[int]] = {}
            for i, p in enumerate(uniques):
                groups.setdefault(id(self._model_for(p)), []).append(i)

            # feature time was paid once across ALL uniques; search time
            # is per model-group — each term amortized over what it
            # covered
            per_feat = t_feat / len(uniques)
            for idxs in groups.values():
                model = self._model_for(uniques[idxs[0]])
                picks, best_preds, _, t_search = search_best_batch(
                    model, F[idxs], self.candidates,
                    feasible=feasible[idxs])
                self.stats["model_searches"] += 1
                self.stats["batched_searches"] += 1
                self.stats["batched_search_programs"] += len(idxs)
                self._m_searches.inc()
                per_search = t_search / len(idxs)

                for i, pick, pred in zip(idxs, picks, best_preds):
                    p = uniques[i]
                    if not np.isfinite(pred):  # every candidate infeasible
                        pick, pred = SINGLE_STREAM, float(
                            model.predict_configs(self._feats[p.key],
                                                  [SINGLE_STREAM])[0])
                    result = TuneResult(pick, float(pred), per_feat,
                                        per_search,
                                        backend=self.backend_name,
                                        source="model")
                    self.cache.put(p.key, result)
                    p.entry = result
        self._m_stage["tune"].observe(self.clock.now() - t_batch0)
        # same-bucket duplicates inside one batch are warm hits on the
        # representative's fresh entry — unless their own row count makes
        # that config unsplittable (possible within one shape-bucket
        # octave), in which case they re-tune individually, exactly as a
        # serial pass would have
        for p in pendings:
            if p.entry is not None:
                continue
            hit = self.cache.get(p.key, valid=lambda r: (
                r.config.partitions * r.config.tasks <= p.n_rows))
            if hit is not None:
                p.entry, p.cache_hit = hit, True
            else:
                self._tune_cold(p)

    # -- resilient stage wrappers ---------------------------------------------
    # (pass-throughs when self.resilience is None; see resilience/ and
    # the README "Resilience" ladder table)

    def _request_rng(self, req: WorkloadRequest) -> random.Random:
        """Per-request seeded RNG for retry jitter: deterministic given
        (policy seed, request seq), de-correlated across requests."""
        return random.Random((self.resilience.seed << 20) ^ (req.seq & 0xFFFFF))

    def _degrade(self, pending: PendingRequest, via: str) -> None:
        if pending.degraded_via is None:
            pending.degraded_via = via
            self._m_fault_degraded.inc()
            self.stats["degraded"] += 1

    def _tune_cold_safe(self, pending: PendingRequest) -> TuneResult:
        """Cold search down the ladder: primary model (retried within the
        SLO budget, breaker-guarded) → OverlapHeuristicModel → nearest
        cached shape-bucket → single stream.  Always yields an entry —
        a request is never failed for want of a *tuning* decision."""
        if self.resilience is None:
            return self._tune_cold(pending)
        req = pending.req
        bkey = (req.tenant, "tune")
        if self.breaker.allow(bkey):
            try:
                result = call_with_retry(
                    lambda: self._tune_cold(pending),
                    policy=self.resilience.retry,
                    rng=self._request_rng(req), clock=self.clock,
                    deadline_s=req.deadline_s,
                    on_recover=lambda n: self._m_fault_recovered.inc(n))
                self.breaker.record_success(bkey)
                return result
            except Exception:  # noqa: BLE001 — ladder rung
                self.breaker.record_failure(bkey)
        # rung 1: the shape-only heuristic needs no trained weights, but
        # still profiles features — it can fail too (backend death)
        try:
            result = self._tune_cold(pending, model=self._fallback_model,
                                     source="fallback")
            self._degrade(pending, "heuristic-model")
            return result
        except Exception:  # noqa: BLE001 — ladder rung
            pass
        # rung 2: no profiling at all — borrow the nearest cached shape
        # bucket, else run single-stream; NOT cached (it is a guess, and
        # caching it would freeze the guess into the warm path)
        entry = nearest_bucket_entry(self.cache, pending.key,
                                     pending.n_rows)
        if entry is not None:
            entry = dataclasses.replace(entry, source="nearest-bucket",
                                        cached=False)
            via = "nearest-bucket"
        else:
            entry = TuneResult(SINGLE_STREAM, 0.0, 0.0, 0.0,
                               backend=self.backend_name,
                               source="degraded")
            via = "single-stream"
        pending.entry = entry
        self._degrade(pending, via)
        return entry

    def _dispatch_fallback(self, pending: PendingRequest) -> tuple[list, float]:
        """One dispatch on the reference backend: the runner's
        ExecutionContext is backend-independent, so stepping down is a
        temporary swap of the dispatch strategy, not a new context."""
        runner = pending.runner
        prev = runner.backend
        runner.backend = get_backend(self.resilience.fallback_backend)
        try:
            return self._execute(pending)
        finally:
            runner.backend = prev

    def _execute_safe(self, pending: PendingRequest) -> tuple[list, float]:
        """Dispatch down the ladder: primary backend (retried within the
        SLO budget, breaker-guarded) → ``host-sync`` reference backend →
        individual request failure (raises; caller converts)."""
        if self.resilience is None:
            return self._execute(pending)
        req = pending.req
        bkey = (req.tenant, "dispatch")
        have_fallback = \
            self.backend_name != self.resilience.fallback_backend
        if not self.breaker.allow(bkey) and have_fallback:
            self._degrade(pending, "backend")
            return self._dispatch_fallback(pending)
        try:
            result = call_with_retry(
                lambda: self._execute(pending),
                policy=self.resilience.retry,
                rng=self._request_rng(req), clock=self.clock,
                deadline_s=req.deadline_s,
                on_recover=lambda n: self._m_fault_recovered.inc(n))
            self.breaker.record_success(bkey)
            return result
        except Exception:  # noqa: BLE001 — ladder rung
            self.breaker.record_failure(bkey)
            if not have_fallback:
                raise
        self._degrade(pending, "backend")
        return self._dispatch_fallback(pending)

    def _fail_request(self, req: WorkloadRequest,
                      pending: Optional[PendingRequest],
                      error: BaseException,
                      status: str = "failed") -> RequestResult:
        """Terminal *individual* failure: an error telemetry sample with
        ``status``/``error`` set, counters bumped, and a RequestResult
        the caller can return — the scheduler itself never crashes."""
        now = self.clock.now()
        config = pending.entry.config \
            if pending is not None and pending.entry is not None else None
        err = f"{type(error).__name__}: {error}"
        slo_violation = req.deadline_s is not None and now > req.deadline_s
        self._seq += 1
        sample = TelemetrySample(
            seq=self._seq, tenant=req.tenant, workload=req.workload,
            key=pending.key if pending is not None else "",
            backend=self.backend_name,
            partitions=config.partitions if config is not None else 0,
            tasks=config.tasks if config is not None else 0,
            cache_hit=bool(pending.cache_hit) if pending is not None
            else False,
            predicted_s=None, measured_s=None, rel_error=None,
            status=status, error=err,
            t_enqueue_s=req.arrival_s,
            t_decide_s=pending.t_decide_s if pending is not None else None,
            t_dispatch_s=pending.t_dispatch_s
            if pending is not None else None,
            t_retire_s=now,
            latency_s=(now - req.arrival_s
                       if req.arrival_s is not None else None),
            deadline_s=req.deadline_s, slo_violation=slo_violation,
            queue_depth=pending.queue_depth if pending is not None else 0,
            trace_id=req.trace_id)
        self.telemetry.append(sample)
        self.stats["requests"] += 1
        self.stats["failed"] += 1
        self.stats[f"tenant.{req.tenant}.failed"] += 1
        self._m_requests.inc()
        self._m_failed.inc()
        if slo_violation:
            self.stats["slo_violations"] += 1
            self._m_slo_violations.inc()
        return RequestResult(
            request=req, config=config, outputs=[], measured_s=None,
            predicted_s=None,
            cache_hit=bool(pending.cache_hit) if pending is not None
            else False,
            refined=False, sample=sample, status=status, error=err)

    # -- stage 2: execute -----------------------------------------------------

    def _execute(self, pending: PendingRequest) -> tuple[list, float]:
        """Dispatch + measure.  Thread-safe given distinct runners: the
        only shared state is the ``_warmed`` set (GIL-atomic adds; a rare
        duplicate warmup is harmless).  First occurrence of a
        (bucket, config) pair warms up so measured runtime is execution,
        not allocator growth and library plan setup."""
        runner, key = pending.runner, pending.key
        pending.t_dispatch_s = self.clock.now()
        config = pending.entry.config
        with self.tracer.span("dispatch", trace_id=pending.req.trace_id,
                              partitions=config.partitions,
                              tasks=config.tasks):
            self.faults.fire("dispatch")
            if self.warm_before_measure and \
                    (key, config) not in self._warmed:
                runner.warmup(config)
                self._warmed.add((key, config))
            t0 = self.clock.now()
            outs = runner.issue(config)
            # wait on this request's stream only: other requests in
            # flight on other contexts' streams keep running
            runner.ctx.wait()
            # read back like StreamedRunner.run does — every output — so
            # measured_s and the single-stream prediction anchor are
            # timed on the same basis (dispatch + compute + D2H);
            # otherwise rel_error carries a constant bias on
            # transfer-heavy workloads
            with runner.ctx.issuing():
                readback_outputs(outs)
            measured_s = self.clock.now() - t0
        self._m_stage["dispatch"].observe(measured_s)
        return outs, measured_s

    # -- stage 3: retire ------------------------------------------------------

    def _load_factor(self, pending: PendingRequest) -> float:
        """Contention normalization for the drift signal; 1.0 on the
        serial scheduler (nothing overlaps).  The concurrent engine
        overrides this with in-flight occupancy over the host's measured
        parallel capacity."""
        return 1.0

    def _retire(self, pending: PendingRequest, outs: list,
                measured_s: float) -> RequestResult:
        """Telemetry + drift + refinement.  Runs on the coordinating
        thread only — per-bucket ordering of drift observations is the
        engine's contract, and the refiner re-profiles on the pending
        request's own runner.

        The drift signal is load-aware: ``measured_s`` is divided by the
        contention factor (window occupancy / host parallel capacity)
        before the prediction error is computed, so concurrent-mode
        overlap inflation does not masquerade as model drift.  Drift is
        observed on the request tenant's own windows, and a triggered
        refinement refits the tenant's fork of the model — never the
        shared base another tenant serves from."""
        t_stage0 = self.clock.now()
        req, key, entry = pending.req, pending.key, pending.entry
        ctx = pending.tenant_ctx if pending.tenant_ctx is not None \
            else self.tenancy.get(req.tenant)
        with self.tracer.span("retire", trace_id=req.trace_id,
                              tenant=req.tenant,
                              cache_hit=pending.cache_hit):
            self.faults.fire("retire")
            config = entry.config
            predicted_s = self._predicted_runtime(key, entry)
            load = self._load_factor(pending)
            pending.load_factor = load
            measured_norm_s = measured_s / load
            rel = relative_error(measured_norm_s, predicted_s)

            refined = False
            if ctx.drift.observe(key, rel, load_factor=load):
                ctx.drift.reset(key)
                self._m_drift_fired.inc()
                try:
                    self._refine(pending, ctx, key, entry)
                    refined = True
                except Exception:  # noqa: BLE001
                    # refinement is an optimization: under a resilience
                    # policy a failing refine loses one model update,
                    # never the request (or the scheduler)
                    if self.resilience is None:
                        raise
                    self.stats["refine_failures"] += 1
                    self.metrics.counter("serving.refine.failed").inc()

            t_retire = self.clock.now()
            latency = (t_retire - req.arrival_s
                       if req.arrival_s is not None else None)
            slo_violation = (req.deadline_s is not None
                             and t_retire > req.deadline_s)
            self._seq += 1
            sample = TelemetrySample(
                seq=self._seq, tenant=req.tenant,
                workload=pending.runner.wl.name,
                key=key, backend=self.backend_name,
                partitions=config.partitions,
                tasks=config.tasks, cache_hit=pending.cache_hit,
                predicted_s=predicted_s, measured_s=measured_s,
                rel_error=rel,
                status=("degraded" if pending.degraded_via is not None
                        else "ok"),
                degraded_via=pending.degraded_via,
                refined=refined, source=entry.source,
                inflight=pending.inflight, load_factor=load,
                measured_norm_s=measured_norm_s,
                t_enqueue_s=req.arrival_s, t_decide_s=pending.t_decide_s,
                t_dispatch_s=pending.t_dispatch_s, t_retire_s=t_retire,
                latency_s=latency, deadline_s=req.deadline_s,
                slo_violation=slo_violation,
                queue_depth=pending.queue_depth,
                trace_id=req.trace_id)
            self.telemetry.append(sample)

        self.stats["requests"] += 1
        self.stats["cache_hits" if pending.cache_hit else "cold_misses"] += 1
        self._m_requests.inc()
        ns = (ctx.namespace or "shared") if ctx is not None else "shared"
        self.metrics.counter(
            "serving.cache.hit" if pending.cache_hit
            else "serving.cache.miss", namespace=ns).inc()
        if slo_violation:
            self.stats["slo_violations"] += 1
            self._m_slo_violations.inc()
        self.stats[f"tenant.{req.tenant}.served"] += 1
        ctx.served += 1
        self._m_stage["retire"].observe(self.clock.now() - t_stage0)

        return RequestResult(
            request=req, config=config,
            outputs=outs if self.keep_outputs else [],
            measured_s=measured_s, predicted_s=predicted_s,
            cache_hit=pending.cache_hit, refined=refined, sample=sample,
            status=("degraded" if pending.degraded_via is not None
                    else "served"))

    def _refine(self, pending: PendingRequest, ctx: TenantContext,
                key: str, entry: TuneResult) -> None:
        """Run one drift-triggered refinement with the tenant's own
        (forked) model and recalibrate the runtime anchor from the
        refinement's measured single-stream run.  The serial scheduler
        refines inline; the engine overrides this to DEFER the
        re-profiling to its next pool-quiesce point, so refinement
        measurements — like all profiling — happen on an idle pool."""
        with self.tracer.span("refine", trace_id=pending.req.trace_id,
                              key=key):
            self.faults.fire("refine")
            refinement = self.refiner.refine(
                pending.runner, key, self._feats.get(key), entry,
                model=ctx.fork_for_refit())
        self._t_single[key] = refinement.t_single_s
        self.stats["refinements"] += 1
        self.stats[f"tenant.{pending.req.tenant}.refinements"] += 1
        ctx.refinements += 1
        self._m_refinements.inc()
        self._m_stage["refine"].observe(refinement.seconds)
        self.metrics.histogram(
            "serving.refit.seconds").observe(refinement.seconds)

    def _predicted_runtime(self, key: str,
                           entry: TuneResult) -> Optional[float]:
        t_single = self._t_single.get(key)
        if t_single is None or entry.predicted_speedup <= 0:
            return None
        return t_single / entry.predicted_speedup

    # -- model lifecycle ------------------------------------------------------

    def swap_model(self, model, model_tag: Optional[str] = None) -> None:
        """Hot-swap the serving base model (a registry ``refresh`` handed
        us a newly published artifact).  Future cold searches, batched
        searches, and refinements rank with the new model; tenants that
        already forked keep their fork (their measured corrections are
        newer than any offline retrain) until their next explicit reset.

        ``model_tag`` should name the new artifact id: tuning-cache keys
        embed it, so every bucket decided under the old model becomes a
        cold miss and is re-ranked by the new one instead of serving
        stale picks."""
        self.model = model
        self.refiner.model = model
        self.tenancy.hot_swap(model)
        if model_tag is not None:
            self.model_tag = model_tag

    # -- teardown -------------------------------------------------------------

    def close(self) -> None:
        """Deterministic teardown: flush + fsync + close the telemetry
        JSONL so a mid-trace shutdown never leaves a truncated last line
        for CI artifact uploads.  Idempotent; the engine extends this
        with its worker-pool shutdown."""
        if self.metrics.enabled:
            # fires-vs-suppressions: the suppression half only settles at
            # teardown (per-tenant detectors accumulate independently)
            suppressed = self.drift.suppressed + sum(
                ctx.drift.suppressed for ctx in self.tenancy
                if ctx.drift is not self.drift)
            self.metrics.gauge("serving.drift.suppressed").set(suppressed)
        self.telemetry.close()

    def __enter__(self) -> "AdaptiveScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def make_trace(workloads: Sequence[str], *, occurrences: int = 2,
               tenants=("tenant-a", "tenant-b"),
               scale_index: int = 0, seed: int = 0,
               priorities: Optional[Sequence[int]] = None
               ) -> list[WorkloadRequest]:
    """A deterministic mixed-workload request trace: ``occurrences``
    rounds over ``workloads``, data re-drawn per request (same shapes, so
    later rounds land in the same tuning bucket), tenants round-robin.
    ``tenants`` is a sequence of names, or an int N for
    ``tenant-0 .. tenant-{N-1}``."""
    if isinstance(tenants, int):
        tenants = tuple(f"tenant-{i}" for i in range(tenants))
    rng = np.random.default_rng(seed)
    reqs = []
    for round_idx in range(occurrences):
        for i, name in enumerate(workloads):
            wl = get_workload(name)
            scale = wl.datasets[min(scale_index, len(wl.datasets) - 1)]
            chunked, shared = wl.make_data(scale, rng)
            reqs.append(WorkloadRequest(
                workload=name, chunked=chunked, shared=shared,
                tenant=tenants[(round_idx * len(workloads) + i)
                               % len(tenants)],
                priority=(priorities[i % len(priorities)]
                          if priorities else 0)))
    return reqs
