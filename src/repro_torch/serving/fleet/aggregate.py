"""Fleet-level aggregation: one view over N worker processes.

Each fleet worker owns a private :class:`TelemetryLog` and
:class:`MetricsRegistry`; the router ships their samples and snapshots
back over the result queue.  These pure functions merge the per-worker
streams into the exact shapes the single-process tooling already
consumes — :func:`merge_samples` yields a sample list that
``TelemetryLog.summary()`` / ``launch/stats.py render()`` accept
unchanged (every sample stamped with its worker label), and
:func:`merge_metrics` yields a ``MetricsRegistry.snapshot()``-shaped
dict with a ``worker`` label added to every series, so the metrics
renderer needs no fleet awareness.

Merged ordering is deterministic given the inputs: samples sort by
retirement time, then worker label, then the worker-local dispatch
sequence — so two workers racing the wall clock still produce one
stable fleet stream (ties broken by label), and re-merging the same
per-worker data always yields the same list.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional

from repro_torch.serving.telemetry import TelemetryLog, TelemetrySample


def payload_from_sample(sample: TelemetrySample) -> dict:
    """Rehydrate a result payload dict from its telemetry sample — the
    router-side inverse of the worker's slim wire encoding.

    Wire v2 sends only ``(token, sample_row)`` per result; everything
    the legacy per-request payload dict carried is derivable from the
    sample: the request's terminal ``status`` is the sample status with
    ``"ok"`` mapped back to ``"served"``, and the chosen config is
    ``(partitions, tasks)`` (``partitions == 0`` means no config was
    ever picked — a request that failed before decide).  Centralizing
    the mapping here keeps the payload shape consumed by
    ``launch/serve.py`` and the fleet tests identical across wire
    modes."""
    return {
        "status": "served" if sample.status == "ok" else sample.status,
        "error": sample.error,
        "workload": sample.workload,
        "tenant": sample.tenant,
        "config": ([sample.partitions, sample.tasks]
                   if sample.partitions else None),
        "measured_s": sample.measured_s,
        "predicted_s": sample.predicted_s,
        "cache_hit": sample.cache_hit,
        "refined": sample.refined,
        "sample": sample.to_json(),
    }


def _sort_key(s: TelemetrySample):
    retire = s.t_retire_s if s.t_retire_s is not None else math.inf
    return (retire, s.worker or "", s.seq)


def merge_samples(per_worker: Dict[str, Iterable[TelemetrySample]]
                  ) -> List[TelemetrySample]:
    """Merge per-worker telemetry streams into one fleet stream.

    Every sample is stamped with its worker label (a copy is made when
    the worker field is unset — inputs are never mutated) and the merged
    list is sorted by ``(t_retire_s, worker, seq)``: wall-clock order
    where stamps exist, with the worker label breaking cross-process
    ties deterministically.  Samples with no retirement stamp (failed
    before dispatch) sort last, in (worker, seq) order.
    """
    merged: List[TelemetrySample] = []
    for label in sorted(per_worker):
        for s in per_worker[label]:
            if s.worker != label:
                s = dataclasses.replace(s, worker=label)
            merged.append(s)
    merged.sort(key=_sort_key)
    return merged


def merge_metrics(per_worker: Dict[str, Optional[dict]]) -> dict:
    """Merge per-worker ``MetricsRegistry.snapshot()`` dicts.

    Returns the same snapshot shape — ``name -> {"type", "values"}`` —
    with a ``worker`` label added to every series, so fleet counters for
    the same family sit side by side instead of being summed away (the
    stats renderer's resilience block already sums across series where
    a total is wanted).  Value entries sort by their full label set, so
    the merged snapshot is deterministic regardless of dict iteration
    order.  Workers whose snapshot is missing (died before the goodbye
    handshake) are skipped, not fatal.
    """
    merged: dict = {}
    for label in sorted(per_worker):
        snap = per_worker[label]
        if not snap:
            continue
        for name, fam in snap.items():
            out = merged.setdefault(name, {"type": fam["type"],
                                           "values": []})
            if out["type"] != fam["type"]:
                raise ValueError(
                    f"metric family {name!r} has conflicting types across "
                    f"workers: {out['type']!r} vs {fam['type']!r}")
            for entry in fam["values"]:
                labels = dict(entry["labels"])
                labels["worker"] = label
                out["values"].append({"labels": labels,
                                      "value": entry["value"]})
    for fam in merged.values():
        fam["values"].sort(key=lambda e: sorted(e["labels"].items()))
    return merged


def fleet_summary(samples: Iterable[TelemetrySample]) -> dict:
    """``TelemetryLog.summary()`` over the merged stream, plus a
    ``per_worker`` breakdown keyed by worker label (requests / hits /
    refinements / failures per process) — the fleet twin of the
    summary's ``per_tenant`` block."""
    samples = list(samples)
    log = TelemetryLog()
    log.samples = samples
    summary = log.summary()
    per_worker: Dict[str, dict] = {}
    for s in samples:
        w = per_worker.setdefault(
            s.worker or "?", {"requests": 0, "cache_hits": 0,
                              "refinements": 0, "failed": 0})
        w["requests"] += 1
        w["cache_hits"] += bool(s.cache_hit)
        w["refinements"] += bool(s.refined)
        w["failed"] += s.status in ("failed", "timeout")
    summary["per_worker"] = dict(sorted(per_worker.items()))
    return summary
