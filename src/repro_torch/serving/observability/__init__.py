"""End-to-end serving observability: span tracing, a metrics registry,
and hot-path profiling.

Three planes, one clock:

  * :mod:`~repro_torch.serving.observability.tracing` — per-request nested
    spans (``decide`` → ``tune`` → ``dispatch`` → ``retire`` →
    ``refine``) stamped from the owning scheduler's injected clock, so
    the virtual-clock trace harness and the real concurrent engine
    share one instrumentation path; exported as JSONL or Chrome
    trace-event JSON (Perfetto-loadable).
  * :mod:`~repro_torch.serving.observability.metrics` — process-wide named
    counters / gauges / histograms with deterministic ``snapshot()``
    and a Prometheus text exporter.
  * :mod:`~repro_torch.serving.observability.profiling` — opt-in tracemalloc
    allocation profiling plus per-stage wall/CPU aggregation; feeds
    ``benchmarks/run.py --serve-real-trace`` → ``BENCH_overhead.json``.

Everything defaults off: the schedulers ship with :data:`NULL_TRACER` /
:data:`NULL_METRICS`, whose hot-path operations are shared no-op
singletons.
"""
from repro_torch.serving.observability.metrics import (DEFAULT_BUCKETS,
                                                 Counter, Gauge,
                                                 Histogram,
                                                 MetricsRegistry,
                                                 NULL_METRICS,
                                                 NullMetrics)
from repro_torch.serving.observability.profiling import (AllocationProfiler,
                                                   HotPathProfiler,
                                                   aggregate_stage_times)
from repro_torch.serving.observability.tracing import (NULL_TRACER, STAGES,
                                                 NullTracer, SpanRecord,
                                                 Tracer, stage_of)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "SpanRecord", "STAGES",
    "stage_of",
    "MetricsRegistry", "NullMetrics", "NULL_METRICS",
    "Counter", "Gauge", "Histogram", "DEFAULT_BUCKETS",
    "AllocationProfiler", "HotPathProfiler", "aggregate_stage_times",
]
