"""Fleet router: tenant-sharded admission over N worker processes.

The router is the fleet's front end.  It owns admission — the same
fifo / priority / fair / deadline :class:`RequestQueue` policies the
single-process schedulers use — and drains the queue in policy order
into per-worker batches: each request goes to the worker its *tenant*
hashes to (stable CRC32, so a tenant's tuning-cache namespace, drift
windows, and model fork all live in exactly one process, and a respawn
reuses the slot so the mapping survives worker death).

The data plane is event-driven end to end (``fleet/wire.py``): the
router parks in :func:`~repro_torch.serving.fleet.wire.wait_any` over
every live slot's result-pipe read end *and* process sentinel, so it wakes
the moment any worker flushes a result frame or dies — there are no
sleep-polls anywhere in ``fleet/``.  Workers batch their return path
into framed ``("results", ...)`` messages of slim positional rows
(schema-versioned; ``REPRO_FLEET_WIRE=legacy`` restores per-request
payload dicts), and the router adapts its dispatch chunk to the
observed admission-queue depth so a deep queue crosses the task pipe in
a few large messages instead of many small ones.

Delivery is at-least-once with explicit handoff: the router keeps every
un-acked request (token → request) per slot, and when a worker dies —
crash, OOM, SIGKILL — it respawns the slot and re-sends the un-acked
work in original admission order.  Because the router closes its copy
of each result pipe's write end at spawn, a frame truncated by a
SIGKILL mid-``send`` surfaces as a clean ``EOFError`` on the read end
(never a hang), and the un-acked remainder is requeued.  Inside the
worker, the resilience path makes bad *requests* fail individually;
the router makes bad *processes* fail individually.  A slot that
exceeds its respawn budget fails its remaining requests terminally
(synthetic ``failed`` telemetry) instead of looping — a submitted
request always reaches a terminal status, the same contract the chaos
harness gates.  On the card a killed worker's CUDA context and pinned
memory go with its process; the respawned slot builds a new context.

Telemetry and metrics aggregate centrally: every result carries its
worker-labeled sample, appended live to the router's fleet
:class:`TelemetryLog` (and observed by a fleet-level
:class:`DriftDetector` — the cross-worker drift view; refinement itself
stays in the workers, which own the caches).  Each ``run()`` also
accounts the IPC tax explicitly: workers report their engine wall per
frame, and ``last_run["ipc_overhead_fraction"]`` is the fraction of
router wall NOT covered by the busiest worker's compute — the number
``fleet_serve`` and ``chip_smoke.py`` report.  At shutdown each worker ships
its ``MetricsRegistry`` snapshot in the goodbye handshake and
:func:`merge_metrics` folds them into one worker-labeled snapshot, so
``launch/stats.py`` renders a fleet exactly like a single process.
"""
from __future__ import annotations

import collections
import dataclasses
import multiprocessing
import os
import signal
import time
import zlib
from typing import Dict, List, Optional

from repro_torch.serving.clock import SystemClock
from repro_torch.serving.fleet.aggregate import (fleet_summary,
                                                 merge_metrics,
                                                 payload_from_sample)
from repro_torch.serving.fleet.wire import parse_results_frame, wait_any
from repro_torch.serving.fleet.worker import WorkerConfig, worker_main
from repro_torch.serving.observability import NULL_METRICS
from repro_torch.serving.queue import RequestQueue, WorkloadRequest
from repro_torch.serving.refinement import DriftDetector
from repro_torch.serving.telemetry import TelemetryLog, TelemetrySample

#: floor of the adaptive dispatch chunk: a shallow queue still sends
#: runs of a few requests so delivery pipelines with worker compute
DISPATCH_FLOOR = 4

#: ceiling of router-side dispatch coalescing: even a very deep queue
#: never puts more than this many requests in one task-pipe message
#: (bounds both the pickle spike and the blast radius of a send racing
#: a dying worker)
MAX_DISPATCH_CHUNK = 64

#: safety-net heartbeat for the event-driven collect loop.  Progress
#: never waits on it — frames and deaths both wake ``wait_any``
#: immediately — it only bounds how stale a missed-edge diagnosis can go
COLLECT_HEARTBEAT_S = 0.25


def shard_for(tenant: str, n_workers: int) -> int:
    """Stable tenant → worker-slot mapping.  CRC32, not ``hash()``:
    Python string hashing is salted per process, and the mapping must
    agree between a router, its respawned workers, and tests."""
    return zlib.crc32(tenant.encode("utf-8")) % max(1, n_workers)


def _ensure_child_pythonpath() -> None:
    """Spawn children re-import ``repro_torch`` from scratch and do NOT
    inherit the parent's ``sys.path`` edits (the ``sys.path.insert``
    that ``PYTHONPATH=src``-less entry points rely on) — so pin the
    package root into the environment the children will inherit."""
    import repro_torch
    # a namespace package (no __init__.py) has __file__ None —
    # __path__ always holds the package directory
    pkg_dir = (os.path.dirname(os.path.abspath(repro_torch.__file__))
               if getattr(repro_torch, "__file__", None)
               else os.path.abspath(list(repro_torch.__path__)[0]))
    pkg_root = os.path.dirname(pkg_dir)
    existing = os.environ.get("PYTHONPATH", "")
    if pkg_root not in existing.split(os.pathsep):
        os.environ["PYTHONPATH"] = (
            pkg_root + (os.pathsep + existing if existing else ""))


@dataclasses.dataclass
class _Slot:
    """One worker seat.  The seat (index) is stable; the process in it
    is replaceable."""
    index: int
    cfg: WorkerConfig
    proc: multiprocessing.process.BaseProcess
    task_q: object
    #: read end of this worker's result pipe; the write end lives only
    #: in the child (the router closes its copy at spawn), so worker
    #: death EOFs the channel instead of wedging it
    conn: object
    pid: Optional[int] = None
    model_tag: Optional[str] = None
    #: torch intra-op threads the worker reported when ready
    threads: Optional[int] = None
    respawns: int = 0
    #: un-acked work: token → the router's retained request copy,
    #: insertion == admission order (dicts preserve it) for fair requeue
    outstanding: Dict[str, WorkloadRequest] = dataclasses.field(
        default_factory=dict)
    bye: Optional[dict] = None
    fatal: Optional[str] = None
    refresh_acks: int = 0
    abandoned: bool = False      # respawn budget exhausted

    @property
    def label(self) -> str:
        return self.cfg.label


class FleetRouter:
    """Front-end for N spawn-isolated serving workers.

    ``worker`` is the :class:`WorkerConfig` template; the router stamps
    ``worker_id`` per slot and derives per-slot telemetry/cache paths
    from the template's (``path`` → ``path.w<i>``) so namespaces never
    collide.  ``telemetry_path`` is the *merged* fleet JSONL.  Workers
    start with spawn: CUDA cannot be used in a forked child, and the
    router's process has usually built a CUDA context already (resolving
    or bootstrapping the model); each worker then builds its own.
    ``dispatch_chunk=None`` (default) enables adaptive dispatch
    coalescing (see :meth:`_chunk_for_depth`); an explicit int pins a
    fixed chunk — tests and experiments that need exact framing opt out
    of adaptivity.  Each worker runs ``worker.intra_op_threads`` torch
    threads, by default an even share of the host's cores, so N workers
    do not each start a pool of every core.  ``metrics`` (a
    :class:`~repro_torch.serving.MetricsRegistry`) turns on router-side
    data-plane instrumentation — frame counts/sizes and the per-run
    ``fleet.ipc.overhead_fraction`` gauge.  Use as a context manager,
    or ``start() … run() … close()``; ``close()`` is idempotent and
    leaves no live children behind (graceful stop → join → terminate →
    kill escalation).
    """

    def __init__(self, n_workers: int, *,
                 worker: Optional[WorkerConfig] = None,
                 policy: str = "fifo",
                 telemetry_path: Optional[str] = None,
                 drift: Optional[DriftDetector] = None,
                 clock=None,
                 metrics=None,
                 max_respawns: int = 3,
                 spawn_timeout_s: float = 120.0,
                 shutdown_grace_s: float = 15.0,
                 dispatch_chunk: Optional[int] = None):
        assert n_workers >= 1, n_workers
        self.n_workers = n_workers
        self.worker_template = worker if worker is not None else WorkerConfig()
        self.clock = clock if clock is not None else SystemClock()
        self.queue = RequestQueue(policy, clock=self.clock)
        self.telemetry = TelemetryLog(telemetry_path)
        # fleet-level drift observer over the merged stream (refinement
        # stays worker-local where the caches live); threshold follows
        # the worker template so the two views judge by the same bar
        self.drift = drift if drift is not None else DriftDetector(
            threshold=self.worker_template.drift_threshold,
            load_discount=0.5)
        self.max_respawns = max_respawns
        self.spawn_timeout_s = spawn_timeout_s
        self.shutdown_grace_s = shutdown_grace_s
        self.dispatch_chunk = (None if dispatch_chunk is None
                               else max(1, dispatch_chunk))
        self.metrics = metrics if metrics is not None else NULL_METRICS
        self._m_dispatch_frames = self.metrics.counter(
            "fleet.dispatch.frames")
        self._m_dispatch_chunk = self.metrics.histogram(
            "fleet.dispatch.chunk")
        self._m_result_frames = self.metrics.counter("fleet.result.frames")
        self._m_frame_size = self.metrics.histogram("fleet.result.frame_size")
        self._m_ipc_fraction = self.metrics.gauge(
            "fleet.ipc.overhead_fraction")
        self.stats: collections.Counter = collections.Counter()
        self.worker_metrics: Dict[str, Optional[dict]] = {}
        self.worker_summaries: Dict[str, dict] = {}
        #: data-plane accounting of the most recent :meth:`run` —
        #: ``{"wall_s", "requests", "worker_busy_s", "ipc_overhead_fraction"}``
        self.last_run: dict = {}
        self._ctx = multiprocessing.get_context("spawn")
        self._slots: List[_Slot] = []
        #: worker-reported engine wall per label, reset per run() — the
        #: compute side of the ipc_overhead_fraction ledger
        self._run_busy: Dict[str, float] = {}
        #: terminal payloads for the *current* run() only — handed back
        #: and dropped when run() returns, so a long-lived router does
        #: not accumulate every historical result in memory
        self._results: Dict[str, dict] = {}
        #: all tokens ever acked (strings only) — survives across runs
        #: so a late replay from a respawned worker is still suppressed
        self._seen: set = set()
        self._kill_plan: Optional[tuple] = None  # (slot_idx, after_n)
        #: the process a planned kill hit, until its death is handled
        self._kill_victim = None
        self._started = False
        self._closed = False

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "FleetRouter":
        if self._started:
            return self
        _ensure_child_pythonpath()
        for i in range(self.n_workers):
            self._slots.append(self._spawn(i))
        for slot in self._slots:
            self._wait_ready(slot)
        self._started = True
        return self

    def _derived_cfg(self, index: int) -> WorkerConfig:
        def suffix(path: Optional[str]) -> Optional[str]:
            return f"{path}.w{index}" if path else None
        t = self.worker_template
        threads = t.intra_op_threads
        if threads is None:
            threads = max(1, (os.cpu_count() or 1) // self.n_workers)
        return dataclasses.replace(
            t, worker_id=index,
            telemetry_path=suffix(t.telemetry_path),
            cache_path=suffix(t.cache_path),
            intra_op_threads=threads)

    def _spawn(self, index: int, respawns: int = 0) -> _Slot:
        cfg = self._derived_cfg(index)
        task_q = self._ctx.Queue()
        recv_conn, send_conn = self._ctx.Pipe(duplex=False)
        proc = self._ctx.Process(
            target=worker_main, args=(cfg, task_q, send_conn),
            name=f"fleet-{cfg.label}", daemon=True)
        proc.start()
        # the child owns the ONLY write end from here on: when it dies,
        # the pipe EOFs and a half-sent frame raises EOFError in
        # _drain_slot instead of blocking a read forever
        send_conn.close()
        return _Slot(index=index, cfg=cfg, proc=proc,
                     task_q=task_q, conn=recv_conn, respawns=respawns)

    def _wait_ready(self, slot: _Slot) -> None:
        deadline = time.monotonic() + self.spawn_timeout_s
        while True:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                raise TimeoutError(
                    f"fleet worker {slot.label} not ready within "
                    f"{self.spawn_timeout_s:.0f}s")
            wait_any([slot.conn, slot.proc.sentinel], timeout=timeout)
            msg = None
            try:
                if slot.conn.poll():
                    msg = slot.conn.recv()
            except (EOFError, OSError):
                pass
            if msg is not None:
                if msg[0] == "ready":
                    slot.pid = msg[2]
                    slot.model_tag = msg[3]
                    slot.threads = msg[4]
                    return
                if msg[0] == "fatal":
                    raise RuntimeError(
                        f"fleet worker {slot.label} failed to start: "
                        f"{msg[2]}")
                continue    # stale kind: keep draining
            if not slot.proc.is_alive():
                raise RuntimeError(
                    f"fleet worker {slot.label} died during startup "
                    f"(exitcode {slot.proc.exitcode})")

    # -- admission ------------------------------------------------------------

    def shard_for(self, tenant: str) -> int:
        return shard_for(tenant, self.n_workers)

    def submit(self, request: WorkloadRequest) -> WorkloadRequest:
        if request.arrival_s is None:
            request.arrival_s = self.clock.now()
        self.stats[f"tenant.{request.tenant}.submitted"] += 1
        return self.queue.push(request)

    def submit_all(self, requests) -> None:
        for r in requests:
            self.submit(r)

    # -- serving --------------------------------------------------------------

    def run(self) -> List[dict]:
        """Drain the admission queue through the fleet; returns one
        terminal result payload per admitted request, in admission
        (policy) order.  Requests a deadline policy sheds at pop time
        are dropped here exactly as the single-process schedulers drop
        them — counted on ``queue.shed``, no result entry."""
        if not self._started:
            self.start()
        t0 = time.perf_counter()
        self._run_busy = {}
        depth = len(self.queue)
        chunk = self._chunk_for_depth(depth)
        order: List[str] = []
        batches: List[List[tuple]] = [[] for _ in self._slots]
        while len(self.queue):
            try:
                req = self.queue.pop()
            except IndexError:
                break                 # deadline policy shed the rest
            slot_i = self.shard_for(req.tenant)
            slot = self._slots[slot_i]
            token = req.trace_id
            order.append(token)
            if slot.abandoned:
                # seat already failed for good — don't route new work
                # into closed queues; fail it terminally at admission
                self._on_result(slot, token, self._terminal_failure(slot, req))
                continue
            slot.outstanding[token] = req
            batches[slot_i].append((token, req))
        for slot, batch in zip(self._slots, batches):
            self._send_batch(slot, batch, chunk=chunk)
        self._collect()
        wall = time.perf_counter() - t0
        out = [self._results[t] for t in order]
        for t in order:                # scope payloads to this run
            self._results.pop(t, None)
        busiest = max(self._run_busy.values(), default=0.0)
        fraction = (max(0.0, wall - busiest) / wall
                    if order and wall > 0 else None)
        self.last_run = {
            "wall_s": wall,
            "requests": len(order),
            "worker_busy_s": dict(sorted(self._run_busy.items())),
            # None in legacy wire mode (workers don't report busy wall)
            # and on empty runs — consumers must treat it as "unknown"
            "ipc_overhead_fraction": (fraction if self._run_busy else None),
        }
        if self.last_run["ipc_overhead_fraction"] is not None:
            self._m_ipc_fraction.set(self.last_run["ipc_overhead_fraction"])
        return out

    def _chunk_for_depth(self, depth: int) -> int:
        """Adaptive dispatch coalescing: target one task-pipe message
        per worker when the admission queue is deep (an even share of
        the depth each), floored at :data:`DISPATCH_FLOOR` so a shallow
        queue still pipelines, and capped at :data:`MAX_DISPATCH_CHUNK`
        so one message never carries an unbounded pickle.  An explicit
        ``dispatch_chunk`` pins the chunk instead."""
        if self.dispatch_chunk is not None:
            return self.dispatch_chunk
        share = -(-depth // max(1, len(self._slots) or self.n_workers))
        return max(DISPATCH_FLOOR, min(MAX_DISPATCH_CHUNK, share))

    def _send_batch(self, slot: _Slot, batch: List[tuple],
                    chunk: Optional[int] = None) -> None:
        # chunked sends keep delivery pipelined (the worker folds queued
        # chunks back into one engine window) and bound the blast radius
        # of a send racing a dying worker
        chunk = chunk if chunk is not None else self._chunk_for_depth(
            len(batch))
        for j in range(0, len(batch), chunk):
            try:
                slot.task_q.put(("serve", batch[j:j + chunk]))
            except (OSError, ValueError):
                break   # dead queue; the death handler requeues
            self.stats["dispatch_frames"] += 1
            self._m_dispatch_frames.inc()
            self._m_dispatch_chunk.observe(len(batch[j:j + chunk]))

    def _collect(self) -> None:
        """Event-driven result collection: drain every slot, then park
        in ``wait_any`` over the live result pipes AND process sentinels
        until something actually happens — a flushed frame or a death
        both wake the loop immediately.  The heartbeat timeout is a
        safety net, not a poll interval: no progress path depends on
        it."""
        while any(s.outstanding for s in self._slots):
            progressed = False
            for slot in self._slots:
                if not slot.abandoned:   # abandoned ⇒ channels are closed
                    progressed |= self._drain_slot(slot)
            self._maybe_fire_kill()
            for slot in self._slots:
                if slot.outstanding and not slot.proc.is_alive():
                    # final drain: results the worker flushed before
                    # dying are still valid
                    self._drain_slot(slot)
                    if slot.outstanding:
                        self._handle_death(slot)
                        progressed = True
            if progressed:
                continue
            waitables = []
            for slot in self._slots:
                if slot.abandoned:
                    continue
                if slot.outstanding or slot.proc.is_alive():
                    waitables.append(slot.conn)
                    waitables.append(slot.proc.sentinel)
            if not waitables:
                # every seat is abandoned; outstanding was terminally
                # failed in _handle_death — nothing left to wait for
                break
            wait_any(waitables, timeout=COLLECT_HEARTBEAT_S)
        self._land_planned_kill()

    def _land_planned_kill(self) -> None:
        """A planned kill always lands within its ``run()``: a plan still
        pending once every result is in fires now, and the victim's death
        is waited out and its seat respawned here, so the run counts the
        kill, the death and the respawn even when the victim had already
        returned its whole share (the loop above handles a death only
        while the victim still owes results)."""
        if self._kill_plan is not None:
            self._maybe_fire_kill(force=True)
        victim, self._kill_victim = self._kill_victim, None
        if victim is None:
            return
        slot = next((s for s in self._slots if s.proc is victim), None)
        if slot is None or slot.abandoned:
            return                     # already respawned (or given up)
        wait_any([victim.sentinel], timeout=self.spawn_timeout_s)
        victim.join(1.0)
        self._drain_slot(slot)
        self._handle_death(slot)

    def _drain_slot(self, slot: _Slot) -> bool:
        progressed = False
        while True:
            try:
                if not slot.conn.poll():
                    return progressed
                msg = slot.conn.recv()
            except (EOFError, OSError, ValueError, BrokenPipeError):
                # EOFError: pipe torn down with the worker — including a
                # frame truncated by SIGKILL mid-send (the router holds
                # no write end, so a partial frame EOFs instead of
                # hanging); OSError/ValueError: the connection itself
                # was close()d (abandoned slot) — same meaning, nothing
                # more will ever arrive
                return progressed
            progressed = True
            kind = msg[0]
            if kind == "results":
                busy_s, items = parse_results_frame(msg)
                self._run_busy[slot.label] = \
                    self._run_busy.get(slot.label, 0.0) + busy_s
                self.stats["result_frames"] += 1
                self._m_result_frames.inc()
                self._m_frame_size.observe(len(items))
                for token, row in items:
                    sample = TelemetrySample.from_row(row)
                    self._on_result(slot, token,
                                    payload_from_sample(sample),
                                    sample=sample)
            elif kind == "result":       # legacy wire: one payload per
                self.stats["result_frames"] += 1     # request
                self._m_result_frames.inc()
                self._m_frame_size.observe(1)
                self._on_result(slot, msg[2], msg[3])
            elif kind == "bye":
                slot.bye = msg[2]
            elif kind == "fatal":
                slot.fatal = msg[2]
                self.stats["worker_fatals"] += 1
            elif kind == "refreshed":
                slot.refresh_acks += 1
                slot.model_tag = msg[2] or slot.model_tag
                if msg[3]:
                    self.stats["refresh_failures"] += 1
            # "pong"/"ready" need no bookkeeping here

    def _on_result(self, slot: _Slot, token: str, payload: dict,
                   sample: Optional[TelemetrySample] = None) -> None:
        # at-least-once delivery: a respawn may replay work whose result
        # the dead worker already flushed — first ack wins, replays drop
        # (the token set, not the payload map: payloads are scoped to
        # one run() but a replay may straggle in much later)
        if token in self._seen:
            self.stats["duplicate_results"] += 1
            slot.outstanding.pop(token, None)
            return
        self._seen.add(token)
        slot.outstanding.pop(token, None)
        self._results[token] = payload
        if sample is None:
            sample = TelemetrySample.from_json(payload["sample"])
        self.telemetry.append(sample)
        if sample.rel_error is not None:
            if self.drift.observe(sample.key, sample.rel_error,
                                  load_factor=sample.load_factor):
                # cross-worker drift view: observational (workers refine
                # locally); reset so one fleet event is counted once
                self.stats["fleet_drift_fired"] += 1
                self.drift.reset(sample.key)

    # -- failure handling -----------------------------------------------------

    def inject_kill(self, slot_index: int, after_results: int = 1) -> None:
        """Chaos hook for benchmarks/tests: SIGKILL the process in
        ``slot_index`` once ``after_results`` results of the current
        ``run()`` have been collected fleet-wide, or once all of them
        have, whichever comes first; the death is handled and the seat
        respawned before that ``run()`` returns.  Counted on
        ``stats['injected_kills']`` so harnesses can separate planned
        kills from real crashes."""
        self._kill_plan = (slot_index, after_results)

    def _maybe_fire_kill(self, force: bool = False) -> None:
        if self._kill_plan is None:
            return
        slot_i, after = self._kill_plan
        if len(self._results) < after and not force:
            return
        self._kill_plan = None
        slot = self._slots[slot_i]
        if slot.proc.is_alive() and slot.pid:
            os.kill(slot.pid, signal.SIGKILL)
            self._kill_victim = slot.proc
            self.stats["injected_kills"] += 1

    def _handle_death(self, slot: _Slot) -> None:
        """Respawn the slot and requeue its un-acked work; past the
        respawn budget, fail the remainder terminally."""
        self.stats["worker_deaths"] += 1
        pending = list(slot.outstanding.items())   # admission order
        self._discard_channels(slot)
        if slot.respawns >= self.max_respawns:
            self.stats["abandoned_slots"] += 1
            slot.abandoned = True
            for token, req in pending:
                self._on_result(slot, token,
                                self._terminal_failure(slot, req))
            slot.outstanding.clear()
            return
        fresh = self._spawn(slot.index, respawns=slot.respawns + 1)
        self._wait_ready(fresh)
        fresh.outstanding = dict(pending)
        fresh.fatal = slot.fatal
        self._slots[slot.index] = fresh
        self.stats["worker_respawns"] += 1
        self.stats["requeued_requests"] += len(pending)
        self._send_batch(fresh, pending)

    def _terminal_failure(self, slot: _Slot, req: WorkloadRequest) -> dict:
        error = (f"worker {slot.label} died "
                 f"(respawn budget {self.max_respawns} exhausted)")
        sample = TelemetrySample(
            seq=req.seq, tenant=req.tenant, workload=req.workload,
            key=req.workload, backend=self.worker_template.backend,
            partitions=0, tasks=0, cache_hit=False, predicted_s=None,
            measured_s=None, rel_error=None, status="failed", error=error,
            t_enqueue_s=req.arrival_s, deadline_s=req.deadline_s,
            trace_id=req.trace_id, worker=slot.label)
        return {"status": "failed", "error": error,
                "workload": req.workload, "tenant": req.tenant,
                "config": None, "measured_s": None, "predicted_s": None,
                "cache_hit": False, "refined": False,
                "sample": sample.to_json()}

    @staticmethod
    def _discard_channels(slot: _Slot) -> None:
        # a SIGKILL mid-put can leave the task queue's pipe mid-frame;
        # cancel_join_thread so the feeder thread never blocks exit on
        # bytes nobody will read.  The result connection just closes —
        # the read end is ours alone
        try:
            slot.task_q.close()
            slot.task_q.cancel_join_thread()
        except (OSError, ValueError):
            pass
        try:
            slot.conn.close()
        except (OSError, ValueError):
            pass

    # -- model distribution ---------------------------------------------------

    def refresh_model(self, spec: str = "latest",
                      timeout_s: float = 60.0) -> Dict[str, Optional[str]]:
        """Broadcast a model refresh (registry ``load(spec)`` +
        ``swap_model`` in every worker) and wait for the acks — parked
        in the shared event-driven wait, woken per ack or death."""
        live = [s for s in self._slots if s.proc.is_alive()]
        baseline = {s.label: s.refresh_acks for s in live}
        for slot in live:
            slot.task_q.put(("refresh", spec))
        deadline = time.monotonic() + timeout_s
        pending = {s.label for s in live}
        while pending:
            for slot in live:
                self._drain_slot(slot)
                if slot.label in pending and (
                        slot.refresh_acks > baseline[slot.label]
                        or not slot.proc.is_alive()):
                    pending.discard(slot.label)
            remaining = deadline - time.monotonic()
            if not pending or remaining <= 0:
                break
            wait_any([w for slot in live if slot.label in pending
                      for w in (slot.conn, slot.proc.sentinel)],
                     timeout=remaining)
        return {s.label: s.model_tag for s in self._slots}

    # -- shutdown -------------------------------------------------------------

    def close(self) -> None:
        """Graceful, idempotent teardown: stop → goodbye handshake →
        join, escalating to terminate/kill for anything that lingers.
        No child of this router survives close()."""
        if self._closed:
            return
        self._closed = True
        for slot in self._slots:
            if slot.proc.is_alive():
                try:
                    slot.task_q.put(("stop",))
                except (OSError, ValueError):
                    pass
        deadline = time.monotonic() + self.shutdown_grace_s
        for slot in self._slots:
            while (slot.bye is None and slot.proc.is_alive()
                   and time.monotonic() < deadline):
                # event-driven: the goodbye frame or the process exit
                # wakes this immediately; the deadline only bounds a
                # worker that is wedged mid-request
                wait_any([slot.conn, slot.proc.sentinel],
                         timeout=deadline - time.monotonic())
                self._drain_slot(slot)
            if not slot.abandoned:       # abandoned ⇒ channels are closed
                self._drain_slot(slot)
            slot.proc.join(max(0.1, deadline - time.monotonic()))
            if slot.proc.is_alive():
                slot.proc.terminate()
                slot.proc.join(2.0)
            if slot.proc.is_alive():
                slot.proc.kill()
                slot.proc.join(2.0)
            if slot.bye is not None:
                self.worker_metrics[slot.label] = slot.bye.get("metrics")
                self.worker_summaries[slot.label] = slot.bye.get("summary")
            else:
                self.worker_metrics.setdefault(slot.label, None)
            self._discard_channels(slot)
        self.telemetry.close()

    def __enter__(self) -> "FleetRouter":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- fleet view -----------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    def metrics_snapshot(self) -> dict:
        """Worker-labeled merged metrics (populated at close())."""
        return merge_metrics(self.worker_metrics)

    def summary(self) -> dict:
        s = fleet_summary(self.telemetry.samples)
        s["workers"] = self.n_workers
        s["worker_deaths"] = self.stats.get("worker_deaths", 0)
        s["worker_respawns"] = self.stats.get("worker_respawns", 0)
        s["injected_kills"] = self.stats.get("injected_kills", 0)
        s["requeued_requests"] = self.stats.get("requeued_requests", 0)
        s["duplicate_results"] = self.stats.get("duplicate_results", 0)
        s["fleet_drift_fired"] = self.stats.get("fleet_drift_fired", 0)
        s["dispatch_frames"] = self.stats.get("dispatch_frames", 0)
        s["result_frames"] = self.stats.get("result_frames", 0)
        s["ipc_overhead_fraction"] = self.last_run.get(
            "ipc_overhead_fraction")
        s["shed"] = len(self.queue.shed)
        if self.worker_metrics and any(self.worker_metrics.values()):
            s["metrics"] = self.metrics_snapshot()
        return s
