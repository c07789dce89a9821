"""Adaptive serving subsystem: the paper's runtime loop under multi-tenant
traffic, on one torch device (the card unless ``device="cpu"``).

Lifecycle per request:

  submit → queue (fifo / priority / fair / deadline) → cache hit? dispatch
                                          : features → model search →
                                            cache → dispatch
  every dispatch → telemetry (predicted vs measured) → drift detector
  drift → refiner: re-profile small candidate set, refresh cache entry,
          incremental model refit

The serial :class:`AdaptiveScheduler` runs that pipeline one request at
a time; :class:`ConcurrentScheduler` (``engine.py``) overlaps up to
``window`` requests on a bounded worker pool, each on its pooled
context's own CUDA stream, with batched cold-path model searches and a
load-aware drift signal (``measured_s`` normalized by window occupancy
over the host's calibrated parallel capacity).  ``isolate_tenants=True``
gives every tenant its own cache namespace, drift windows, and — on
first refit — a private fork of the shared base model (``tenancy.py``).

Fault tolerance (``resilience/``): pass ``resilience=ResiliencePolicy()``
to either scheduler for deadline-aware retries, a per-(tenant, stage)
circuit breaker over the degradation ladder, an execution watchdog, and
individual request failure instead of scheduler crashes; pass
``faults=FaultPlan(...)`` to deterministically inject the failures that
prove it.

Fleet serving (``fleet/``): :class:`FleetRouter` shards tenants across
N spawn-isolated worker processes (each one a private
``ConcurrentScheduler`` + tuning cache + telemetry/metrics stream, on
its own CUDA context on the card), respawns dead workers and requeues
their un-acked work, and merges the per-worker streams into one
worker-labeled fleet view.

Trace replay (``traces.py``): :func:`generate_trace` makes seeded
request streams and :func:`simulate_trace` replays them on a virtual
clock through the real queue, drift detector and cache keys, with
service times from a seeded model — no device, so its reports are
deterministic and equal the JAX package's.
"""
from repro_torch.serving.clock import SystemClock, VirtualClock
from repro_torch.serving.engine import (ConcurrentScheduler, ContextPool,
                                        OrderedRetirer)
from repro_torch.serving.fleet import (FleetRouter, WorkerConfig,
                                       fleet_summary, merge_metrics,
                                       merge_samples, shard_for)
from repro_torch.serving.observability import (NULL_METRICS, NULL_TRACER,
                                               HotPathProfiler,
                                               MetricsRegistry, NullMetrics,
                                               NullTracer, Tracer,
                                               aggregate_stage_times)
from repro_torch.serving.queue import POLICIES, RequestQueue, WorkloadRequest
from repro_torch.serving.refinement import (DriftDetector, RefinementResult,
                                            Refiner, contention_factor)
from repro_torch.serving.resilience import (NULL_FAULTS, BreakerConfig,
                                            CircuitBreaker, FaultPlan,
                                            FaultSpec, InjectedFault,
                                            ResiliencePolicy, RetryPolicy,
                                            atomic_write_json,
                                            call_with_retry,
                                            corrupt_json_file,
                                            nearest_bucket_entry,
                                            quarantine_file)
from repro_torch.serving.scheduler import (AdaptiveScheduler,
                                           OverlapHeuristicModel,
                                           PendingRequest, RequestResult,
                                           make_trace)
from repro_torch.serving.telemetry import (TelemetryLog, TelemetrySample,
                                           latency_stats, percentile,
                                           relative_error)
from repro_torch.serving.tenancy import TenantContext, TenantRegistry
from repro_torch.serving.traces import (ServiceModel, TraceConfig,
                                        generate_trace, simulate_trace)

__all__ = [
    "POLICIES", "RequestQueue", "WorkloadRequest",
    "SystemClock", "VirtualClock",
    "ServiceModel", "TraceConfig", "generate_trace", "simulate_trace",
    "latency_stats", "percentile",
    "DriftDetector", "RefinementResult", "Refiner", "contention_factor",
    "AdaptiveScheduler", "OverlapHeuristicModel", "PendingRequest",
    "RequestResult", "make_trace",
    "ConcurrentScheduler", "ContextPool", "OrderedRetirer",
    "FleetRouter", "WorkerConfig", "shard_for",
    "merge_samples", "merge_metrics", "fleet_summary",
    "TelemetryLog", "TelemetrySample", "relative_error",
    "TenantContext", "TenantRegistry",
    "Tracer", "NullTracer", "NULL_TRACER",
    "MetricsRegistry", "NullMetrics", "NULL_METRICS",
    "HotPathProfiler", "aggregate_stage_times",
    "BreakerConfig", "CircuitBreaker", "FaultPlan", "FaultSpec",
    "InjectedFault", "NULL_FAULTS", "ResiliencePolicy", "RetryPolicy",
    "atomic_write_json", "call_with_retry", "corrupt_json_file",
    "nearest_bucket_entry", "quarantine_file",
]
