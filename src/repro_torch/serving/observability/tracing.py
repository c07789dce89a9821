"""Request span tracing for the serving stack.

One :class:`Tracer` instance per scheduler records nested, named spans —
``decide``, ``tune.cold.batch``, ``dispatch``, ``retire``, ``refine`` —
each stamped from the *scheduler's own clock* (the tracer binds to the
injected clock at scheduler construction), so span timestamps, telemetry
latency stamps, and drift-window judgments can never disagree, and the
virtual-clock trace harness and the real concurrent engine share one
instrumentation code path.

Two recording APIs cover both worlds:

  ``span(name, ...)``    a context manager for live code (the real
      schedulers): enter/exit read the bound clock, nesting is tracked
      per thread (the engine's execute stage runs on pool workers), and
      the parent relationship is recorded explicitly;
  ``record(name, t0, t1, ...)``  an explicit-interval call for the
      discrete-event harness, whose stage intervals are computed on the
      virtual timeline rather than bracketed by real enter/exit.

Exports: ``export_jsonl`` (one span per line, greppable) and
``export_chrome`` — the Chrome trace-event format (``chrome://tracing``
/ https://ui.perfetto.dev): complete ``"ph": "X"`` events with
microsecond timestamps rebased to the trace start, one Perfetto track
per recording thread.

The disabled path must cost nothing: :data:`NULL_TRACER` is a process
singleton whose ``span()`` returns one shared no-op context manager —
no clock read, no allocation, no lock — so schedulers constructed
without a tracer (the default) keep their pre-observability hot path.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Optional

#: span name prefix -> attribution stage; ``stage_of("tune.cold.batch")``
#: is ``"tune"`` — the five-way split BENCH_overhead.json reports
STAGES = ("decide", "tune", "dispatch", "retire", "refine")


def stage_of(name: str) -> str:
    """The attribution stage a span name rolls up into (its first
    dot-component; unknown prefixes attribute to themselves)."""
    return name.split(".", 1)[0]


@dataclasses.dataclass
class SpanRecord:
    """One closed span.  ``t_start``/``t_end`` are seconds on the
    tracer's bound clock; ``cpu_s`` is thread CPU time consumed inside
    the span (None when the tracer was built with ``cpu=False`` or the
    span came from ``record()``)."""

    name: str
    t_start: float
    t_end: float
    tid: int = 0                    # dense per-tracer thread index
    trace_id: Optional[str] = None  # request correlation id
    parent: Optional[str] = None    # enclosing span's name (same thread)
    depth: int = 0                  # nesting depth on its thread
    cpu_s: Optional[float] = None
    attrs: Optional[dict] = None

    @property
    def duration_s(self) -> float:
        return self.t_end - self.t_start

    def to_json(self) -> dict:
        d = {"name": self.name, "t_start": self.t_start,
             "t_end": self.t_end, "tid": self.tid}
        if self.trace_id is not None:
            d["trace_id"] = self.trace_id
        if self.parent is not None:
            d["parent"] = self.parent
        if self.depth:
            d["depth"] = self.depth
        if self.cpu_s is not None:
            d["cpu_s"] = self.cpu_s
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class _SpanCM:
    """A live span.  Created per ``span()`` call on an enabled tracer;
    enter stamps the clock (and optionally thread CPU time), exit closes
    the record and appends it to the tracer under its lock."""

    __slots__ = ("tracer", "name", "trace_id", "attrs",
                 "_t0", "_cpu0", "_frame")

    def __init__(self, tracer: "Tracer", name: str,
                 trace_id: Optional[str], attrs: Optional[dict]):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.attrs = attrs

    def __enter__(self) -> "_SpanCM":
        stack = self.tracer._stack()
        self._frame = (self.name, len(stack))
        stack.append(self.name)
        self._cpu0 = time.thread_time() if self.tracer.cpu else None
        self._t0 = self.tracer.now()
        return self

    def __exit__(self, *exc) -> None:
        t1 = self.tracer.now()
        cpu = (time.thread_time() - self._cpu0
               if self._cpu0 is not None else None)
        stack = self.tracer._stack()
        stack.pop()
        name, depth = self._frame
        self.tracer._append(SpanRecord(
            name=name, t_start=self._t0, t_end=t1,
            tid=self.tracer._tid(),
            trace_id=self.trace_id,
            parent=stack[-1] if stack else None,
            depth=depth, cpu_s=cpu, attrs=self.attrs))


class _NullSpan:
    """The shared no-op span: zero clock reads, zero allocation."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """Collects :class:`SpanRecord`\\ s from any thread.

    ``clock`` is any object with ``now() -> float``; leave it ``None``
    to have the owning scheduler bind its own clock at construction
    (the recommended wiring — one time source per scheduler).  An
    unbound tracer used standalone falls back to ``time.perf_counter``.

    ``cpu=True`` additionally records per-span *thread* CPU time
    (``time.thread_time``), the wall-vs-CPU split the hot-path profiler
    attributes Python overhead with.
    """

    enabled = True

    def __init__(self, clock=None, *, cpu: bool = False):
        self.clock = clock
        self.cpu = cpu
        self.spans: list[SpanRecord] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._tids: dict[int, int] = {}

    # -- time & thread bookkeeping ---------------------------------------

    def now(self) -> float:
        return (self.clock.now() if self.clock is not None
                else time.perf_counter())

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _append(self, rec: SpanRecord) -> None:
        with self._lock:
            self.spans.append(rec)

    # -- recording APIs ---------------------------------------------------

    def span(self, name: str, *, trace_id: Optional[str] = None,
             **attrs) -> _SpanCM:
        """Context manager bracketing one live stage."""
        return _SpanCM(self, name, trace_id, attrs or None)

    def record(self, name: str, t_start: float, t_end: float, *,
               trace_id: Optional[str] = None, tid: int = 0,
               parent: Optional[str] = None, **attrs) -> None:
        """Record an explicit interval — the discrete-event harness's
        API, whose stage boundaries live on the virtual timeline."""
        self._append(SpanRecord(
            name=name, t_start=t_start, t_end=t_end, tid=tid,
            trace_id=trace_id, parent=parent, attrs=attrs or None))

    def clear(self) -> None:
        with self._lock:
            self.spans = []

    def __len__(self) -> int:
        return len(self.spans)

    # -- exports ----------------------------------------------------------

    def export_jsonl(self, path: str) -> int:
        """One span per line; returns the span count written."""
        spans = list(self.spans)
        _ensure_dir(path)
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps(s.to_json(), separators=(",", ":"))
                        + "\n")
        return len(spans)

    def export_chrome(self, path: str, *,
                      process_name: str = "repro-serving") -> int:
        """Chrome trace-event JSON (open in chrome://tracing or
        https://ui.perfetto.dev).  Timestamps are microseconds rebased
        to the earliest span, one track (tid) per recording thread;
        span attrs land in ``args``.  Returns the event count."""
        spans = sorted(self.spans, key=lambda s: (s.t_start, s.tid))
        t0 = spans[0].t_start if spans else 0.0
        events = [{"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
                   "args": {"name": process_name}}]
        for s in spans:
            args = dict(s.attrs or {})
            if s.trace_id is not None:
                args["trace_id"] = s.trace_id
            events.append({
                "name": s.name, "cat": stage_of(s.name), "ph": "X",
                "ts": (s.t_start - t0) * 1e6,
                "dur": max(s.duration_s, 0.0) * 1e6,
                "pid": 1, "tid": s.tid, "args": args,
            })
        _ensure_dir(path)
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"},
                      f, separators=(",", ":"))
        return len(spans)


class NullTracer:
    """The disabled tracer: every ``span()`` hands back one shared no-op
    context manager (identity-asserted by the overhead micro-test), and
    nothing is ever recorded.  ``clock`` exists so the scheduler's
    bind-my-clock wiring is branch-free."""

    enabled = False

    def __init__(self):
        self.clock = None
        self.spans: list = []

    def span(self, name: str, *, trace_id=None, **attrs) -> _NullSpan:
        return _NULL_SPAN

    def record(self, *a, **k) -> None:
        pass

    def clear(self) -> None:
        pass

    def __len__(self) -> int:
        return 0

    def export_jsonl(self, path: str) -> int:
        return 0

    def export_chrome(self, path: str, **k) -> int:
        return 0


#: process-wide disabled tracer; schedulers default to this
NULL_TRACER = NullTracer()


def _ensure_dir(path: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
