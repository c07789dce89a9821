"""Hot-path profiling over the serving engine's decide/dispatch/retire
loop.

Two opt-in instruments, composable with the span tracer:

  :func:`aggregate_stage_times`
      Rolls a tracer's spans up into the five attribution stages
      (``decide`` / ``tune`` / ``dispatch`` / ``retire`` / ``refine``),
      reporting wall seconds, span counts, means, and — when the tracer
      recorded thread CPU time — the CPU share of each stage.  This is
      the per-stage breakdown ``BENCH_overhead.json`` commits to.

  :class:`AllocationProfiler`
      A ``tracemalloc`` wrapper that answers "where do the hot-path
      allocations live?" — the question ROADMAP's real-engine-replay
      item exists to expose.  Strictly opt-in: tracemalloc roughly
      doubles allocation cost, so the overhead benchmark runs its timed
      pass untraced and takes a separate, shorter allocation pass.

:class:`HotPathProfiler` bundles both around a callable for one-line
use in benchmarks and the serve CLI.
"""
from __future__ import annotations

import time
import tracemalloc
from typing import Iterable, Optional

from repro_torch.serving.observability.tracing import (STAGES, SpanRecord,
                                                 stage_of)


def aggregate_stage_times(spans: Iterable[SpanRecord],
                          stages: tuple = STAGES) -> dict:
    """Per-stage attribution: {stage: {"wall_s", "count", "mean_s"[,
    "cpu_s"]}}.  Only top-level spans (``depth == 0``) are summed so a
    nested ``tune.cold`` inside an outer span is never double-counted;
    every requested stage is present (zeroed) even if nothing hit it,
    so downstream JSON consumers see a stable schema."""
    out = {s: {"wall_s": 0.0, "count": 0, "mean_s": None}
           for s in stages}
    cpu_seen = False
    for span in spans:
        if span.depth:
            continue
        stage = stage_of(span.name)
        agg = out.get(stage)
        if agg is None:
            agg = out[stage] = {"wall_s": 0.0, "count": 0, "mean_s": None}
        agg["wall_s"] += span.duration_s
        agg["count"] += 1
        if span.cpu_s is not None:
            cpu_seen = True
            agg["cpu_s"] = agg.get("cpu_s", 0.0) + span.cpu_s
    for agg in out.values():
        if agg["count"]:
            agg["mean_s"] = agg["wall_s"] / agg["count"]
        if cpu_seen:
            agg.setdefault("cpu_s", 0.0)
    return out


class AllocationProfiler:
    """Top allocation sites over a profiled region, via ``tracemalloc``.

    ``start()``/``stop()`` bracket the region (also usable as a context
    manager); ``top(n)`` returns the heaviest allocation sites as plain
    dicts (``site``, ``size_kb``, ``count``) — grouped by (file, line)
    with ``frames`` stack depth available for deeper grouping.  The
    snapshot is taken at ``stop()`` so ``top()`` reflects live memory at
    region end — steady-state retention, not transient churn."""

    def __init__(self, *, frames: int = 8):
        self.frames = frames
        self._snapshot = None
        self._started_here = False

    def start(self) -> "AllocationProfiler":
        if not tracemalloc.is_tracing():
            tracemalloc.start(self.frames)
            self._started_here = True
        return self

    def stop(self) -> None:
        if tracemalloc.is_tracing():
            self._snapshot = tracemalloc.take_snapshot()
            if self._started_here:
                tracemalloc.stop()

    def __enter__(self) -> "AllocationProfiler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def top(self, n: int = 15) -> list[dict]:
        if self._snapshot is None:
            return []
        stats = self._snapshot.statistics("lineno")
        return [{
            "site": (f"{st.traceback[0].filename}:"
                     f"{st.traceback[0].lineno}"),
            "size_kb": st.size / 1024.0,
            "count": st.count,
        } for st in stats[:n]]


class HotPathProfiler:
    """One-line profiling of a serving run: per-stage wall/CPU from the
    tracer's spans, optional top allocation sites, and the overall
    wall/CPU envelope of the profiled region.

        prof = HotPathProfiler(tracer, alloc=True)
        with prof:
            scheduler.run()
        report = prof.report()
    """

    def __init__(self, tracer, *, alloc: bool = False):
        self.tracer = tracer
        self.alloc = AllocationProfiler() if alloc else None
        self._t0 = self._cpu0 = 0.0
        self.wall_s: Optional[float] = None
        self.cpu_s: Optional[float] = None

    def __enter__(self) -> "HotPathProfiler":
        if self.alloc is not None:
            self.alloc.start()
        self._cpu0 = time.process_time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.wall_s = time.perf_counter() - self._t0
        self.cpu_s = time.process_time() - self._cpu0
        if self.alloc is not None:
            self.alloc.stop()

    def report(self, *, top_allocations: int = 15) -> dict:
        rep = {
            "wall_s": self.wall_s,
            "cpu_s": self.cpu_s,
            "stages": aggregate_stage_times(self.tracer.spans),
        }
        if self.alloc is not None:
            rep["allocations"] = self.alloc.top(top_allocations)
        return rep
