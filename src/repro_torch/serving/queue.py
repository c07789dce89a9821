"""Multi-tenant workload request queue.

A :class:`WorkloadRequest` is one unit of serving work: a named streamed
workload plus its host data, tagged with the submitting tenant, a
priority, and optionally an SLO deadline.  :class:`RequestQueue` orders
them under one of four policies:

  ``fifo``     — global arrival order;
  ``priority`` — higher ``priority`` first, arrival order within a level
                 (stable: equal-priority requests never reorder);
  ``fair``     — round-robin across tenants, arrival order within a
                 tenant, so one chatty tenant cannot starve the rest;
  ``deadline`` — earliest-deadline-first admission control: requests
                 nearest their deadline are boosted to the front (ties
                 broken by priority, then arrival), deadline-less
                 requests run last, and work whose deadline has already
                 expired by the time it is popped is *shed* — dropped
                 and counted on :attr:`RequestQueue.shed` — instead of
                 burning capacity on a guaranteed SLO miss.

All four are deterministic given the submission sequence and (for
``deadline``) the clock — the property the scheduler tests rely on.
Deadline expiry is judged against an injectable clock
(:mod:`repro_torch.serving.clock`), so the trace harness sheds in virtual time
and tests never race the wall clock.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import math
from typing import Optional

from repro_torch.serving.clock import SystemClock

POLICIES = ("fifo", "priority", "fair", "deadline")


@dataclasses.dataclass
class WorkloadRequest:
    """One serving request: run ``workload`` over this request's data."""

    workload: str
    chunked: dict
    shared: dict
    tenant: str = "default"
    priority: int = 0
    #: arrival sequence number, assigned at enqueue time
    seq: int = -1
    #: arrival timestamp (scheduler clock), stamped at submit when unset
    arrival_s: Optional[float] = None
    #: absolute SLO deadline (same clock); None = no deadline
    deadline_s: Optional[float] = None
    #: request trace id, assigned at enqueue (derived from ``seq``, so
    #: it is deterministic per submission order); every span and
    #: telemetry sample for this request carries it
    trace_id: Optional[str] = None


class RequestQueue:
    def __init__(self, policy: str = "fifo", clock=None, metrics=None):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")
        self.policy = policy
        self.clock = clock if clock is not None else SystemClock()
        self._seq = itertools.count()
        self._fifo: collections.deque = collections.deque()
        self._heap: list = []
        self._per_tenant: dict[str, collections.deque] = {}
        self._rr: collections.deque = collections.deque()  # tenant rotation
        #: requests dropped by deadline admission control, in shed order
        self.shed: list[WorkloadRequest] = []
        # observability: shed counter + depth gauge, no-ops by default
        if metrics is None:
            from repro_torch.serving.observability import NULL_METRICS
            metrics = NULL_METRICS
        self._m_shed = metrics.counter("serving.queue.shed")
        self._m_depth = metrics.gauge("serving.queue.depth")

    def push(self, req: WorkloadRequest) -> WorkloadRequest:
        req.seq = next(self._seq)
        if req.trace_id is None:
            # deterministic per submission order; survives any policy's
            # reordering and the engine's out-of-order retirement
            req.trace_id = f"r{req.seq:06d}"
        self._m_depth.set(len(self) + 1)
        if self.policy == "fifo":
            self._fifo.append(req)
        elif self.policy == "priority":
            heapq.heappush(self._heap, (-req.priority, req.seq, req))
        elif self.policy == "deadline":
            # EDF: the nearest deadline is served first (the "boost" —
            # near-deadline work overtakes everything slack), priority
            # breaks deadline ties, deadline-less requests sort last
            dl = req.deadline_s if req.deadline_s is not None else math.inf
            heapq.heappush(self._heap, (dl, -req.priority, req.seq, req))
        else:  # fair
            if req.tenant not in self._per_tenant:
                self._per_tenant[req.tenant] = collections.deque()
                self._rr.append(req.tenant)
            self._per_tenant[req.tenant].append(req)
        return req

    def pop(self) -> WorkloadRequest:
        """Next request in policy order.

        Under ``deadline`` this sheds every already-expired request it
        uncovers (recorded on :attr:`shed`) before returning a live one —
        so a non-empty queue can still raise ``IndexError`` when
        everything left in it is expired.  Callers draining a deadline
        queue must treat ``IndexError`` as "drained", not as a bug (the
        schedulers do).
        """
        if not len(self):
            raise IndexError("pop from an empty RequestQueue")
        if self.policy == "fifo":
            return self._fifo.popleft()
        if self.policy == "priority":
            return heapq.heappop(self._heap)[2]
        if self.policy == "deadline":
            now = self.clock.now()
            while self._heap:
                req = heapq.heappop(self._heap)[3]
                if req.deadline_s is not None and req.deadline_s < now:
                    self.shed.append(req)     # expired: shed, don't serve
                    self._m_shed.inc()
                    continue
                return req
            raise IndexError("every queued request was past its deadline")
        tenant = self._rr.popleft()
        req = self._per_tenant[tenant].popleft()
        if self._per_tenant[tenant]:
            self._rr.append(tenant)       # rotate: next tenant goes first
        else:
            del self._per_tenant[tenant]
        return req

    def peek_tenants(self) -> list[str]:
        """Tenants with queued work, in service order (fair policy)."""
        return list(self._rr)

    def pending_by_tenant(self) -> dict[str, int]:
        """Queued-request count per tenant, any policy — the serving
        dashboards' fairness view.  Under ``fair`` this is exactly the
        per-tenant backlog the round-robin rotation drains one-at-a-time:
        in any stretch where every tenant stays non-empty, each tenant is
        served exactly once per rotation (asserted in the tenancy
        tests).  Under ``deadline``, expired-but-not-yet-shed requests
        still count — they are only classified at pop time."""
        if self.policy == "fair":
            return {t: len(d) for t, d in self._per_tenant.items()}
        counts: dict[str, int] = {}
        items = (self._fifo if self.policy == "fifo"
                 else (entry[-1] for entry in self._heap))
        for req in items:
            counts[req.tenant] = counts.get(req.tenant, 0) + 1
        return counts

    def __len__(self) -> int:
        if self.policy == "fifo":
            return len(self._fifo)
        if self.policy in ("priority", "deadline"):
            return len(self._heap)
        return sum(len(d) for d in self._per_tenant.values())

    def __bool__(self) -> bool:
        return len(self) > 0
