"""Serving telemetry: one append-only JSONL record per dispatched request.

Each :class:`TelemetrySample` captures the serving decision and its
outcome — which config was chosen, where it came from (model search,
cache hit, or drift refinement), what runtime the model predicted, and
what was actually measured.  The relative prediction error
``|measured - predicted| / predicted`` is the drift-detection signal
(:mod:`repro_torch.serving.refinement`) and the refit target provider.

The log is line-buffered JSONL: every ``append`` writes and flushes one
line, so a crashed serving process loses at most the in-flight request —
the same durability contract as the tuning cache's atomic save, but for
a stream instead of a snapshot.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import IO, Iterator, Optional


@dataclasses.dataclass
class TelemetrySample:
    seq: int                      # scheduler-assigned dispatch sequence
    tenant: str
    workload: str
    key: str                      # tuning-cache key (workload bucket id)
    backend: str
    partitions: int
    tasks: int
    cache_hit: bool
    predicted_s: Optional[float]  # model-predicted runtime (None if unknown)
    #: measured execution seconds; None for a request that never
    #: executed (status "failed"/"timeout" under a resilience policy)
    measured_s: Optional[float]
    rel_error: Optional[float]    # |measured - predicted| / predicted
    refined: bool = False         # this request triggered a refinement
    source: str = "model"         # config provenance: model | refined
    # -- resilience disposition ---------------------------------------------
    #: "ok" | "degraded" (served via a fallback rung) | "failed" |
    #: "timeout" — failed/timeout samples are the *error telemetry*: the
    #: request is terminal and accounted for, the scheduler survived
    status: str = "ok"
    #: "TypeName: message" for failed/timeout samples
    error: Optional[str] = None
    #: first fallback rung taken when status == "degraded"
    #: (heuristic-model | nearest-bucket | single-stream | backend)
    degraded_via: Optional[str] = None
    # -- load-aware drift fields (concurrent engine) ----------------------
    #: window occupancy when this request was dispatched (itself included);
    #: 1 under the serial scheduler
    inflight: int = 1
    #: contention factor measured_s was divided by before computing the
    #: drift signal: max(1, min(inflight, workers) / host parallel
    #: capacity); 1.0 when serving serially or load-awareness is off
    load_factor: float = 1.0
    #: measured_s / load_factor — the contention-normalized runtime that
    #: rel_error (and therefore drift detection) is computed from
    measured_norm_s: Optional[float] = None
    # -- latency accounting (the virtual-clock layer) ----------------------
    # All four stamps share the scheduler's clock (``SystemClock`` in
    # production, ``VirtualClock`` under the trace harness / tests):
    #: queue arrival (``WorkloadRequest.arrival_s``, stamped at submit)
    t_enqueue_s: Optional[float] = None
    #: placement decision made (cache lookup / model search done)
    t_decide_s: Optional[float] = None
    #: execution handed to the backend (pool submit / serial dispatch)
    t_dispatch_s: Optional[float] = None
    #: result retired (telemetry + drift observed)
    t_retire_s: Optional[float] = None
    #: t_retire_s - t_enqueue_s: the end-to-end latency the SLO is on
    latency_s: Optional[float] = None
    #: absolute SLO deadline carried by the request (None = no SLO)
    deadline_s: Optional[float] = None
    #: retired after its deadline (shed requests never get a sample —
    #: they are counted on the queue, not here)
    slo_violation: bool = False
    #: queue length observed at decision time
    queue_depth: int = 0
    #: queue-assigned request trace id — the span-tracing correlation
    #: key (repro_torch.serving.observability); stable across out-of-order
    #: retirement in the concurrent engine
    trace_id: Optional[str] = None
    # -- fleet serving (multi-process router/worker split) -----------------
    #: worker-process label ("w0", "w1", ...) under the fleet router;
    #: None for single-process serving.  ``from_json`` filters unknown
    #: keys, so pre-fleet JSONL streams load unchanged
    worker: Optional[str] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "TelemetrySample":
        fields = {f.name for f in dataclasses.fields(TelemetrySample)}
        return TelemetrySample(**{k: v for k, v in d.items() if k in fields})

    # -- compact positional codec (the fleet wire's slim payload) ----------

    def to_row(self) -> tuple:
        """Positional encoding in :data:`WIRE_FIELDS` order — the fleet
        wire's slim payload: no key strings cross the process boundary,
        only values.  The schema is the explicit field tuple below plus
        ``repro_torch.serving.fleet.wire.WIRE_VERSION``."""
        return tuple(getattr(self, f) for f in WIRE_FIELDS)

    @staticmethod
    def from_row(row) -> "TelemetrySample":
        """Inverse of :meth:`to_row`.  A shorter row (an older writer
        that predates trailing fields) rehydrates with dataclass
        defaults for the missing tail — WIRE_FIELDS is append-only."""
        return TelemetrySample(**dict(zip(WIRE_FIELDS, row)))


#: Explicit positional schema of :meth:`TelemetrySample.to_row`.
#: APPEND-ONLY: new dataclass fields go at the END of this tuple and
#: bump ``repro_torch.serving.fleet.wire.WIRE_VERSION`` — reordering or
#: removing entries breaks row decoding silently, which is exactly what
#: the wire version guard exists to prevent.  A tier-1 test asserts this
#: tuple stays in sync with the dataclass fields.
WIRE_FIELDS = (
    "seq", "tenant", "workload", "key", "backend", "partitions", "tasks",
    "cache_hit", "predicted_s", "measured_s", "rel_error", "refined",
    "source", "status", "error", "degraded_via", "inflight", "load_factor",
    "measured_norm_s", "t_enqueue_s", "t_decide_s", "t_dispatch_s",
    "t_retire_s", "latency_s", "deadline_s", "slo_violation", "queue_depth",
    "trace_id", "worker",
)


class EmptyWindowError(ValueError):
    """A statistic was requested over zero samples.

    The one typed signal for "there is nothing to aggregate":
    :func:`percentile` raises it on an empty window; the higher-level
    aggregators (:func:`latency_stats`, :meth:`TelemetryLog.summary`)
    catch the condition and return ``None``-shaped results instead, so
    a trace where admission control shed *every* request still renders
    a summary rather than blowing up the report path."""


def percentile(sorted_values, q: float) -> float:
    """Linear-interpolated percentile of an ascending-sorted sequence
    (``q`` in [0, 1]).  The one primitive the latency reports need —
    avoids dragging numpy into the telemetry hot path.  Raises
    :class:`EmptyWindowError` on an empty window (callers that can see
    empty windows should use :func:`latency_stats`, which maps the
    condition to ``None``)."""
    if not sorted_values:
        raise EmptyWindowError(
            "percentile over an empty window: no samples to aggregate "
            "(did a queue policy shed every request?)")
    if len(sorted_values) == 1:
        return float(sorted_values[0])
    pos = q * (len(sorted_values) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_values) - 1)
    frac = pos - lo
    return float(sorted_values[lo] * (1 - frac) + sorted_values[hi] * frac)


def latency_stats(latencies) -> Optional[dict]:
    """p50/p95/p99 + mean/max over a sequence of latency seconds;
    ``None`` when the sequence is empty (e.g. a trace where nothing
    retired) — the consistent empty-window contract: aggregators return
    ``None``, only the raw :func:`percentile` primitive raises."""
    lats = sorted(latencies)
    if not lats:
        return None
    return {
        "p50_s": percentile(lats, 0.50),
        "p95_s": percentile(lats, 0.95),
        "p99_s": percentile(lats, 0.99),
        "mean_s": sum(lats) / len(lats),
        "max_s": lats[-1],
        "n": len(lats),
    }


def relative_error(measured_s: float,
                   predicted_s: Optional[float]) -> Optional[float]:
    if predicted_s is None or predicted_s <= 0:
        return None
    return abs(measured_s - predicted_s) / predicted_s


class TelemetryLog:
    """In-memory sample list, mirrored to an append-only JSONL file.

    Usable as a context manager; ``close()`` flushes AND fsyncs before
    closing, and is idempotent.  A serving process torn down mid-trace
    (CI job timeout, SIGTERM between requests) must never leave a
    truncated last line for the artifact upload to capture — ``append``
    already flushes per line, but only fsync pushes the page cache to
    disk before the process dies."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.samples: list[TelemetrySample] = []
        self._fh: Optional[IO[str]] = None

    def append(self, sample: TelemetrySample) -> None:
        self.samples.append(sample)
        if self.path is not None:
            if self._fh is None:
                os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                            exist_ok=True)
                self._fh = open(self.path, "a")
            self._fh.write(json.dumps(sample.to_json(),
                                      separators=(",", ":")) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.flush()
                os.fsync(self._fh.fileno())
            except (OSError, ValueError):
                pass                  # already closed / non-seekable sink
            self._fh.close()
            self._fh = None

    @property
    def closed(self) -> bool:
        return self._fh is None

    def __enter__(self) -> "TelemetryLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __len__(self) -> int:
        return len(self.samples)

    def __iter__(self) -> Iterator[TelemetrySample]:
        return iter(self.samples)

    @staticmethod
    def read(path: str) -> list[TelemetrySample]:
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(TelemetrySample.from_json(json.loads(line)))
        return out

    def summary(self) -> dict:
        """Aggregate view for dashboards / the --serve benchmark JSON.

        Total on an empty log (e.g. a deadline policy shed the entire
        trace, so nothing ever retired): every ratio/stat field comes
        back ``None`` or zero rather than raising — asserted by the
        observability tests."""
        n = len(self.samples)
        hits = sum(s.cache_hit for s in self.samples)
        errs = [s.rel_error for s in self.samples if s.rel_error is not None]
        per_workload: dict[str, list[float]] = {}
        for s in self.samples:
            if s.rel_error is not None:
                per_workload.setdefault(s.workload, []).append(s.rel_error)
        per_tenant: dict[str, dict] = {}
        for s in self.samples:
            t = per_tenant.setdefault(
                s.tenant, {"requests": 0, "cache_hits": 0,
                           "refinements": 0, "errors": []})
            t["requests"] += 1
            t["cache_hits"] += bool(s.cache_hit)
            t["refinements"] += bool(s.refined)
            if s.rel_error is not None:
                t["errors"].append(s.rel_error)
        lats = [s.latency_s for s in self.samples if s.latency_s is not None]
        with_deadline = [s for s in self.samples if s.deadline_s is not None]
        violations = sum(s.slo_violation for s in with_deadline)
        by_status: dict[str, int] = {}
        for s in self.samples:
            by_status[s.status] = by_status.get(s.status, 0) + 1
        return {
            "requests": n,
            "cache_hits": hits,
            "hit_rate": hits / n if n else 0.0,
            "refinements": sum(s.refined for s in self.samples),
            # failed/timeout samples carry measured_s=None — a window
            # where EVERY request errored must still summarize, so the
            # aggregate skips them rather than TypeError-ing
            "total_measured_s": sum(s.measured_s for s in self.samples
                                    if s.measured_s is not None),
            "by_status": by_status,
            "latency": latency_stats(lats),
            "slo_violations": violations,
            "slo_violation_rate": (violations / len(with_deadline)
                                   if with_deadline else None),
            "mean_rel_error": (sum(errs) / len(errs)) if errs else None,
            "mean_rel_error_by_workload": {
                w: sum(v) / len(v) for w, v in sorted(per_workload.items())},
            "per_tenant": {
                name: {"requests": t["requests"],
                       "cache_hits": t["cache_hits"],
                       "refinements": t["refinements"],
                       "mean_rel_error": (sum(t["errors"]) / len(t["errors"])
                                          if t["errors"] else None)}
                for name, t in sorted(per_tenant.items())},
        }
