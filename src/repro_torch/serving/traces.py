"""Seeded synthetic request traces + a virtual-time replay harness.

The serving stack's tail behaviour — queueing delay under bursts,
SLO-violation rates per queue policy, drift-detector stability at deep
windows — only shows up at trace scale, and wall-clock replay of 10^5+
requests is hours.  This module makes those runs take seconds:

:func:`generate_trace`
    A deterministic generator of :class:`WorkloadRequest` streams.
    Arrivals are Poisson or bursty (a 2-state Markov-modulated Poisson
    process alternating quiet and burst segments); workload popularity
    is Zipf over the registered suite (all 39 programs by default);
    tenants are Zipf-skewed so one chatty tenant dominates; dataset
    scales churn (a rotating "hot" scale plus random off-scale draws)
    so new shape buckets keep arriving and the bucketed tuning cache
    never saturates; each request optionally carries an SLO deadline
    drawn from a mix of tight and slack classes.  Everything is driven
    by one seed: the same config always yields the identical trace.

:func:`simulate_trace`
    A discrete-event replay on a :class:`~repro_torch.serving.clock.
    VirtualClock`.  It reuses the *real* serving primitives — the
    :class:`RequestQueue` (so ``deadline`` sheds in virtual time), the
    real :class:`DriftDetector`, real bucketed cache keys via
    :meth:`TuningCache.key` — and substitutes only the execution layer:
    service times come from a seeded :class:`ServiceModel` instead of
    running kernels.  Service noise is pre-drawn per arrival index, so
    two policies replaying the same trace see identical per-request
    service draws and their tail-latency numbers are directly
    comparable.  ``drift_injections`` shifts a workload's true cost
    mid-trace to exercise the detect→refine loop deterministically.

The harness models the coordinator/worker split the concurrent engine
has: placement decisions (cache lookup, cold tune, refinement) occupy a
serial coordinator timeline (``busy_until``), execution overlaps on up
to ``window`` slots, and each request's wall time is inflated by the
same :func:`contention_factor` the engine divides out of its drift
signal — plus a residual, occupancy-scaled noise term the normalization
cannot cancel, which is exactly the signal ``load_discount`` exists to
keep below the drift threshold.
"""
from __future__ import annotations

import dataclasses
import heapq
import zlib
from typing import Iterable, Iterator, Optional

import numpy as np

from repro_torch.core.autotuner import TuningCache
from repro_torch.core.workloads import get_workload, list_workloads
from repro_torch.serving.clock import VirtualClock
from repro_torch.serving.observability import NULL_METRICS, NULL_TRACER
from repro_torch.serving.queue import (POLICIES, RequestQueue,
                                       WorkloadRequest)
from repro_torch.serving.refinement import (DriftDetector,
                                            contention_factor)
from repro_torch.serving.resilience import (NULL_FAULTS, FaultPlan,
                                            InjectedFault)
from repro_torch.serving.telemetry import (TelemetryLog, TelemetrySample,
                                           latency_stats, relative_error)

__all__ = ["TraceConfig", "generate_trace", "ServiceModel",
           "simulate_trace"]


# ---------------------------------------------------------------------------
# trace generation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Everything :func:`generate_trace` draws from, seed included."""

    n_requests: int = 100_000
    seed: int = 0
    #: "poisson" (stationary rate) or "bursty" (2-state MMPP)
    arrival: str = "poisson"
    rate_rps: float = 450.0
    #: bursty only: arrival rate inside a burst segment
    burst_rate_rps: float = 1400.0
    #: bursty only: mean quiet / burst segment lengths (exponential dwell)
    base_dwell_s: float = 1.5
    burst_dwell_s: float = 0.25
    #: workload names to draw from; None = the full registered suite
    workloads: Optional[tuple] = None
    #: Zipf exponent for workload popularity (rank r gets p ~ 1/r^s)
    zipf_s: float = 1.1
    tenants: tuple = ("acme", "globex", "initech", "umbrella")
    #: Zipf exponent for tenant skew — 1.4 gives the lead tenant ~45%
    tenant_zipf_s: float = 1.4
    priorities: tuple = (0, 1, 2)
    #: indices into each workload's ``datasets`` tuple (clamped per
    #: workload); the first is the initial "hot" scale
    scale_indices: tuple = (2, 3, 4)
    #: probability a request draws a uniformly random scale instead of
    #: the hot one — the steady trickle of off-bucket shapes
    churn_prob: float = 0.05
    #: rotate which scale is hot every N requests (None = n/len(scales),
    #: so every configured scale gets a hot phase; 0 disables rotation)
    churn_every: Optional[int] = None
    #: ((probability, slo_seconds), ...) deadline mix; None = no SLOs.
    #: The default mixes tight 30 ms deadlines into a slack majority —
    #: the spread EDF exploits and FIFO cannot.
    slo_choices: Optional[tuple] = ((0.30, 0.030), (0.70, 0.250))


def _zipf_probs(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return w / w.sum()


def _poisson_arrivals(rng: np.random.Generator, rate: float,
                      n: int) -> Iterator[float]:
    t = 0.0
    left = n
    while left > 0:
        m = min(left, 8192)
        ts = t + np.cumsum(rng.exponential(1.0 / rate, m))
        t = float(ts[-1])
        yield from ts.tolist()
        left -= m


def _bursty_arrivals(rng: np.random.Generator, cfg: TraceConfig,
                     n: int) -> Iterator[float]:
    """2-state MMPP: alternate exponential-dwell quiet/burst segments;
    within a segment, arrivals are a Poisson process at that segment's
    rate (drawn as count ~ Poisson(rate*dwell), times uniform-sorted —
    the exact conditional distribution)."""
    t = 0.0
    burst = False
    emitted = 0
    while emitted < n:
        dwell = rng.exponential(
            cfg.burst_dwell_s if burst else cfg.base_dwell_s)
        rate = cfg.burst_rate_rps if burst else cfg.rate_rps
        k = int(rng.poisson(rate * dwell))
        if k:
            ts = np.sort(rng.uniform(t, t + dwell, k))
            take = min(k, n - emitted)
            yield from ts[:take].tolist()
            emitted += take
        t += dwell
        burst = not burst


def generate_trace(cfg: TraceConfig) -> Iterator[WorkloadRequest]:
    """Yield ``cfg.n_requests`` requests in nondecreasing arrival order.

    Host data arrays are built once per (workload, scale) bucket and
    shared by reference across every request in that bucket, so a
    million-request trace costs bucket-count array allocations, not
    request-count.  Lazy: consume it straight into the simulator or
    ``list(...)`` it for inspection.
    """
    if cfg.arrival not in ("poisson", "bursty"):
        raise ValueError(f"unknown arrival process {cfg.arrival!r}")
    rng = np.random.default_rng(cfg.seed)
    names = tuple(cfg.workloads) if cfg.workloads else tuple(list_workloads())
    wl_probs = _zipf_probs(len(names), cfg.zipf_s)
    tn_probs = _zipf_probs(len(cfg.tenants), cfg.tenant_zipf_s)
    slo = cfg.slo_choices
    if slo is not None:
        slo_p = np.array([p for p, _ in slo], dtype=np.float64)
        slo_p = slo_p / slo_p.sum()
        slo_v = [float(v) for _, v in slo]
    n_scales = len(cfg.scale_indices)
    churn_every = cfg.churn_every
    if churn_every is None:
        churn_every = max(1, cfg.n_requests // max(1, n_scales))

    data_cache: dict[tuple, tuple] = {}

    def bucket_data(name: str, scale_pos: int) -> tuple:
        key = (name, scale_pos)
        hit = data_cache.get(key)
        if hit is None:
            wl = get_workload(name)
            idx = min(cfg.scale_indices[scale_pos], len(wl.datasets) - 1)
            data_rng = np.random.default_rng(
                [cfg.seed, zlib.crc32(name.encode()), idx])
            hit = wl.make_data(wl.datasets[idx], data_rng)
            data_cache[key] = hit
        return hit

    arrivals = (_poisson_arrivals(rng, cfg.rate_rps, cfg.n_requests)
                if cfg.arrival == "poisson"
                else _bursty_arrivals(rng, cfg, cfg.n_requests))
    # one vectorized draw batch at a time keeps rng call overhead off the
    # per-request path
    batch = 8192
    produced = 0
    while produced < cfg.n_requests:
        m = min(batch, cfg.n_requests - produced)
        wl_idx = rng.choice(len(names), size=m, p=wl_probs)
        tn_idx = rng.choice(len(cfg.tenants), size=m, p=tn_probs)
        pr_idx = rng.integers(0, len(cfg.priorities), size=m)
        churn_u = rng.random(m)
        churn_pick = rng.integers(0, n_scales, size=m)
        if slo is not None:
            slo_idx = rng.choice(len(slo_v), size=m, p=slo_p)
        for j in range(m):
            i = produced + j
            hot = ((i // churn_every) % n_scales) if churn_every else 0
            scale_pos = (int(churn_pick[j]) if churn_u[j] < cfg.churn_prob
                         else hot)
            name = names[int(wl_idx[j])]
            chunked, shared = bucket_data(name, scale_pos)
            t_arr = next(arrivals)
            deadline = (t_arr + slo_v[int(slo_idx[j])]
                        if slo is not None else None)
            yield WorkloadRequest(
                workload=name, chunked=chunked, shared=shared,
                tenant=cfg.tenants[int(tn_idx[j])],
                priority=int(cfg.priorities[int(pr_idx[j])]),
                arrival_s=float(t_arr), deadline_s=deadline)
        produced += m


# ---------------------------------------------------------------------------
# service-time model
# ---------------------------------------------------------------------------

class _NoiseStream:
    """Lazily extended array of standard-normal draws, indexed by arrival
    sequence number — so the noise a request experiences is a property of
    the *trace position*, not of the order a particular queue policy
    happened to dispatch in.  Policies replaying the same trace are then
    compared on identical service draws."""

    def __init__(self, seed):
        self._rng = np.random.default_rng(seed)
        self._z = np.empty(0)

    def __getitem__(self, i: int) -> float:
        while i >= len(self._z):
            self._z = np.concatenate(
                [self._z, self._rng.standard_normal(65536)])
        return float(self._z[i])


class ServiceModel:
    """Synthetic per-request service times.

    True cost is affine in the request's chunked row count with a fixed
    per-workload coefficient (seeded from the workload name, so it never
    depends on trace order); sampled cost multiplies in lognormal noise.
    :meth:`shift` scales a workload's true cost mid-trace — the drift
    injection: tuned predictions made before the shift keep the old
    truth, so the detector sees genuine sustained misprediction.
    """

    def __init__(self, seed: int = 0, *, t0_s: float = 5e-4,
                 per_row_s: float = 4e-6, noise_sigma: float = 0.05):
        self.seed = seed
        self.t0_s = t0_s
        self.per_row_s = per_row_s
        self.noise_sigma = noise_sigma
        self._coef: dict[str, float] = {}
        self._shift: dict[str, float] = {}

    def _coef_of(self, workload: str) -> float:
        c = self._coef.get(workload)
        if c is None:
            r = np.random.default_rng(
                [self.seed, zlib.crc32(workload.encode())])
            c = 0.5 + 1.2 * float(r.random())
            self._coef[workload] = c
        return c

    def true_time(self, workload: str, n_rows: int) -> float:
        return ((self.t0_s + self.per_row_s * n_rows)
                * self._coef_of(workload) * self._shift.get(workload, 1.0))

    def sample(self, workload: str, n_rows: int, z: float) -> float:
        return self.true_time(workload, n_rows) * \
            float(np.exp(self.noise_sigma * z))

    def shift(self, workload: str, factor: float) -> None:
        self._shift[workload] = self._shift.get(workload, 1.0) * factor


# ---------------------------------------------------------------------------
# discrete-event replay
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Inflight:
    req: WorkloadRequest
    key: str
    cache_hit: bool
    predicted_s: float
    service_s: float          # wall time incl. contention inflation
    load: float
    occupancy: int
    t_decide_s: float
    t_dispatch_s: float
    queue_depth: int


def simulate_trace(trace: Iterable[WorkloadRequest], *,
                   policy: str = "fifo", window: int = 8,
                   capacity: float = 1.6, workers: Optional[int] = None,
                   backend: str = "sim", model_tag: str = "sim",
                   decide_s: float = 2e-5, cold_tune_s: float = 2e-3,
                   refine_s: float = 2e-2,
                   drift: Optional[DriftDetector] = None,
                   service: Optional[ServiceModel] = None,
                   seed: int = 0, contention_sigma: float = 0.12,
                   drift_injections: Iterable[tuple] = (),
                   telemetry: Optional[TelemetryLog] = None,
                   tracer=None, metrics=None,
                   faults: Optional[FaultPlan] = None) -> dict:
    """Replay ``trace`` under ``policy`` on a virtual clock; return the
    tail-latency / SLO / queue-depth / drift report.

    Event loop: two event sources (next arrival from the lazily consumed
    trace, next completion from a min-heap) advance a shared
    :class:`VirtualClock`; after every event, free window slots are
    filled from the real :class:`RequestQueue` (``deadline`` sheds
    expired work here, in virtual time).  Placement decisions serialize
    on a coordinator timeline: each dispatch charges ``decide_s`` (warm
    hit) or ``cold_tune_s`` (first sight of a bucket), and a drift
    refinement charges ``refine_s`` — all of which delay subsequent
    decisions, exactly like the engine's quiesce points.

    ``drift_injections`` is ``(t_s, workload, factor)`` triples applied
    to the :class:`ServiceModel` when virtual time first reaches
    ``t_s``.  Pass ``telemetry`` to additionally record one full
    :class:`TelemetrySample` per retired request (keep it off for
    million-request runs; the report aggregates streamingly).

    ``tracer`` / ``metrics`` are the same observability objects the real
    schedulers take (:mod:`repro_torch.serving.observability`): the
    tracer is bound to the harness's virtual clock and records one span
    per stage on the virtual timeline (warm decisions as ``decide``, cold
    ones as ``tune.cold``, plus ``dispatch`` / ``retire`` / ``refine``); the
    metrics registry counts the same families the schedulers do, so a
    seeded replay's ``snapshot()`` is deterministic.

    ``faults`` is the same :class:`~repro_torch.serving.resilience.FaultPlan`
    the live schedulers take, evaluated at the ``decide`` /
    ``tune.cold`` / ``dispatch`` sites per dispatched request: an
    ``error`` fault fails the request individually (counted in the
    ``failed`` block and, when a deadline was carried, against the SLO
    like shed work); a ``latency`` fault's delay is charged to the
    request's virtual service time — the plan is bound with
    ``sleep=None`` so no real wall time passes.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")
    clock = VirtualClock()
    tracer = tracer if tracer is not None else NULL_TRACER
    if tracer.enabled and tracer.clock is None:
        tracer.clock = clock
    metrics = metrics if metrics is not None else NULL_METRICS
    m_requests = metrics.counter("serving.requests")
    m_hit = metrics.counter("serving.cache.hit", namespace="shared")
    m_miss = metrics.counter("serving.cache.miss", namespace="shared")
    m_drift = metrics.counter("serving.drift.fired")
    m_refine = metrics.counter("serving.refinements")
    m_slo = metrics.counter("serving.slo.violations")
    m_failed = metrics.counter("serving.requests.failed")
    faults = faults if faults is not None else NULL_FAULTS
    if faults.enabled:
        faults.bind(metrics=metrics, sleep=None)
    queue = RequestQueue(policy, clock=clock, metrics=metrics)
    drift = drift if drift is not None else DriftDetector(load_discount=0.5)
    service = service if service is not None else ServiceModel(seed)
    z_svc = _NoiseStream([seed, 1])
    z_load = _NoiseStream([seed, 2])
    injections = sorted(drift_injections)
    inj_i = 0

    tuned: dict[str, float] = {}          # bucket key -> predicted seconds
    key_cache: dict[tuple, tuple] = {}    # (workload, shapes) -> (key, rows)
    completions: list = []                # (t_finish, seq, _Inflight)
    inflight = 0
    busy_until = 0.0                      # coordinator timeline

    latencies: list[float] = []
    lat_by_tenant: dict[str, list] = {}   # tenant -> [count, sum]
    served_by_tenant: dict[str, int] = {}
    depth_hist: dict[int, int] = {}       # queue depth at arrival -> count
    n_arrived = 0
    n_deadline = 0
    violations = 0
    n_failed = 0
    failed_deadline = 0
    cold_misses = 0
    refinements = 0
    refined_keys: list[str] = []
    t_end = 0.0

    def bucket_of(req: WorkloadRequest) -> tuple:
        shapes = tuple(sorted(
            (k, tuple(v.shape)) for k, v in req.chunked.items()))
        ck = (req.workload, shapes)
        hit = key_cache.get(ck)
        if hit is None:
            key = TuningCache.key(req.workload, req.chunked, req.shared,
                                  backend, model_tag=model_tag)
            rows = next(iter(req.chunked.values())).shape[0]
            hit = (key, int(rows))
            key_cache[ck] = hit
        return hit

    def apply_injections(t: float) -> None:
        nonlocal inj_i
        while inj_i < len(injections) and injections[inj_i][0] <= t:
            _, wl, factor = injections[inj_i]
            service.shift(wl, factor)
            inj_i += 1

    def dispatch(req: WorkloadRequest) -> None:
        nonlocal inflight, busy_until, cold_misses, n_failed, \
            failed_deadline
        key, rows = bucket_of(req)
        t_decide = max(clock.now(), busy_until)
        fault_delay = 0.0
        if faults.enabled:
            try:
                fault_delay += faults.fire("decide")
                if key not in tuned:
                    fault_delay += faults.fire("tune.cold")
                fault_delay += faults.fire("dispatch")
            except InjectedFault as e:
                # individual failure: the request terminates here with
                # an error telemetry sample; the coordinator only pays
                # the decide overhead, the window slot stays free
                busy_until = t_decide + decide_s
                n_failed += 1
                m_failed.inc()
                m_requests.inc()
                viol = (req.deadline_s is not None
                        and busy_until > req.deadline_s)
                if req.deadline_s is not None:
                    failed_deadline += 1
                if telemetry is not None:
                    telemetry.append(TelemetrySample(
                        seq=req.seq, tenant=req.tenant,
                        workload=req.workload, key=key, backend=backend,
                        partitions=0, tasks=0, cache_hit=key in tuned,
                        predicted_s=None, measured_s=None, rel_error=None,
                        status="failed", error=f"InjectedFault: {e}",
                        t_enqueue_s=req.arrival_s, t_decide_s=t_decide,
                        t_retire_s=busy_until,
                        latency_s=busy_until - req.arrival_s,
                        deadline_s=req.deadline_s, slo_violation=viol,
                        queue_depth=len(queue), trace_id=req.trace_id))
                return
        if key in tuned:
            overhead = decide_s
            cache_hit = True
        else:
            # cold: profile the bucket — the entry predicts current truth
            tuned[key] = service.true_time(req.workload, rows)
            overhead = cold_tune_s
            cache_hit = False
            cold_misses += 1
        busy_until = t_decide + overhead
        inflight += 1
        occupancy = inflight
        load = contention_factor(occupancy, capacity, workers)
        sigma_eff = contention_sigma * (occupancy - 1) / max(1, window - 1)
        base = service.sample(req.workload, rows, z_svc[req.seq])
        wall = base * load * float(np.exp(sigma_eff * z_load[req.seq])) \
            + fault_delay
        sim = _Inflight(req=req, key=key, cache_hit=cache_hit,
                        predicted_s=tuned[key], service_s=wall,
                        load=load, occupancy=occupancy,
                        t_decide_s=t_decide, t_dispatch_s=busy_until,
                        queue_depth=len(queue))
        if tracer.enabled:
            # the coordinator timeline is track 0; execution slots land
            # on tracks 1..window (occupancy approximates the slot)
            tracer.record("decide" if cache_hit else "tune.cold",
                          t_decide, busy_until,
                          trace_id=req.trace_id, tid=0)
            tracer.record("dispatch", busy_until, busy_until + wall,
                          trace_id=req.trace_id, tid=occupancy)
        heapq.heappush(completions, (busy_until + wall, req.seq, sim))

    def retire(sim: _Inflight) -> None:
        nonlocal inflight, busy_until, refinements, violations, t_end
        inflight -= 1
        t_ret = clock.now()
        t_end = t_ret
        req = sim.req
        norm = sim.service_s / sim.load
        rel = relative_error(norm, sim.predicted_s)
        refined = False
        if drift.observe(sim.key, rel, load_factor=sim.load):
            drift.reset(sim.key)
            _, rows = bucket_of(req)
            tuned[sim.key] = service.true_time(req.workload, rows)
            refinements += 1
            refined_keys.append(sim.key)
            busy_until = max(busy_until, t_ret) + refine_s
            refined = True
            m_drift.inc()
            m_refine.inc()
            if tracer.enabled:
                tracer.record("refine", busy_until - refine_s, busy_until,
                              trace_id=req.trace_id, tid=0)
            # the engine runs refinements at pool-quiesce points, so no
            # request decided against the stale entry retires *after*
            # the refresh — mirror that by repointing still-inflight
            # same-key work at the refreshed prediction (<= window items)
            for _, _, other in completions:
                if other.key == sim.key:
                    other.predicted_s = tuned[sim.key]
        lat = t_ret - req.arrival_s
        latencies.append(lat)
        agg = lat_by_tenant.setdefault(req.tenant, [0, 0.0])
        agg[0] += 1
        agg[1] += lat
        served_by_tenant[req.tenant] = \
            served_by_tenant.get(req.tenant, 0) + 1
        viol = req.deadline_s is not None and t_ret > req.deadline_s
        if viol:
            violations += 1
            m_slo.inc()
        m_requests.inc()
        (m_hit if sim.cache_hit else m_miss).inc()
        if tracer.enabled:
            tracer.record("retire", t_ret, t_ret,
                          trace_id=req.trace_id, tid=0)
        if telemetry is not None:
            telemetry.append(TelemetrySample(
                seq=req.seq, tenant=req.tenant, workload=req.workload,
                key=sim.key, backend=backend, partitions=1, tasks=1,
                cache_hit=sim.cache_hit, predicted_s=sim.predicted_s,
                measured_s=sim.service_s, rel_error=rel, refined=refined,
                source="refined" if refined else "model",
                inflight=sim.occupancy, load_factor=sim.load,
                measured_norm_s=norm, t_enqueue_s=req.arrival_s,
                t_decide_s=sim.t_decide_s, t_dispatch_s=sim.t_dispatch_s,
                t_retire_s=t_ret, latency_s=lat, deadline_s=req.deadline_s,
                slo_violation=viol, queue_depth=sim.queue_depth,
                trace_id=req.trace_id))

    it = iter(trace)
    next_req = next(it, None)
    while next_req is not None or completions or len(queue):
        t_arr = next_req.arrival_s if next_req is not None else np.inf
        t_comp = completions[0][0] if completions else np.inf
        if t_arr <= t_comp:
            if next_req is None:
                break  # only unpoppable (all-expired) work remains
            apply_injections(t_arr)
            clock.advance_to(t_arr)
            queue.push(next_req)
            n_arrived += 1
            if next_req.deadline_s is not None:
                n_deadline += 1
            d = len(queue)
            depth_hist[d] = depth_hist.get(d, 0) + 1
            next_req = next(it, None)
        else:
            apply_injections(t_comp)
            clock.advance_to(t_comp)
            _, _, sim = heapq.heappop(completions)
            retire(sim)
        while inflight < window and len(queue):
            try:
                dispatch(queue.pop())
            except IndexError:
                break  # deadline policy shed everything poppable

    shed = len(queue.shed)
    if metrics.enabled:
        metrics.gauge("serving.drift.suppressed").set(drift.suppressed)
    depths = sorted(depth_hist)
    total_d = sum(depth_hist.values())
    depth_mean = (sum(d * c for d, c in depth_hist.items()) / total_d
                  if total_d else 0.0)

    def depth_pct(q: float) -> int:
        target = q * total_d
        seen = 0
        for d in depths:
            seen += depth_hist[d]
            if seen >= target:
                return d
        return depths[-1] if depths else 0

    slo_denom = n_deadline
    # shed work IS a missed SLO, and so is an individually failed
    # request that carried a deadline
    slo_misses = violations + shed + failed_deadline
    wall = t_end if t_end > 0 else clock.now()
    return {
        "policy": policy,
        "window": window,
        "capacity": capacity,
        "n_requests": n_arrived,
        "completed": len(latencies),
        "shed": shed,
        "failed": n_failed,
        "faults_injected": faults.fired if faults.enabled else 0,
        "cold_misses": cold_misses,
        "hit_rate": (1.0 - cold_misses / len(latencies)
                     if latencies else 0.0),
        "refinements": refinements,
        "refined_keys": refined_keys,
        "latency": latency_stats(latencies),
        "slo": {
            "with_deadline": slo_denom,
            "violations_retired": violations,
            "shed": shed,
            "failed": failed_deadline,
            "violation_rate": (slo_misses / slo_denom
                               if slo_denom else None),
        },
        "queue_depth": {
            "mean": depth_mean,
            "p95": depth_pct(0.95),
            "max": depths[-1] if depths else 0,
        },
        "per_tenant": {
            t: {"served": served_by_tenant.get(t, 0),
                "mean_latency_s": (agg[1] / agg[0]) if agg[0] else None}
            for t, agg in sorted(lat_by_tenant.items())},
        "virtual_wall_s": wall,
        "throughput_rps": (len(latencies) / wall) if wall > 0 else 0.0,
    }
