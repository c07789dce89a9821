"""The concurrent serving engine: overlapped request execution on a
bounded worker pool.

The serial :class:`~repro_torch.serving.scheduler.AdaptiveScheduler` chains
every request's millisecond *execution* behind the previous one, even
though the paper's whole point (§3.3) is that the placement *decision* is
microseconds.  This engine splits the per-request pipeline into the three
stages the scheduler already exposes and overlaps them across requests:

  decide    coordinator thread: queue pop (policy order), cache lookup,
            and — for the cold requests of a window fill — ONE batched
            model search over a ``(B, F)`` feature matrix
            (:meth:`AdaptiveScheduler._tune_cold_batch`);
  dispatch  a bounded worker pool (the ``host-threads`` backend's
            :class:`~repro_torch.core.backends.host_threads.WindowedPool`
            machinery) executes up to ``window`` requests concurrently,
            each on its leased context's own CUDA stream;
  retire    coordinator thread: completions are collected out of order,
            but telemetry / drift observation for each tuning bucket is
            flushed in that bucket's dispatch order
            (:class:`OrderedRetirer`), so the drift detector sees the
            same per-bucket sample sequence a serial pass would.

Ordering guarantees:
  * decisions (and therefore config choices) happen in queue-policy
    order, identical to the serial scheduler;
  * ``run()`` returns results in decision order;
  * telemetry ``seq`` reflects retirement order — out of order across
    buckets, dispatch-ordered within each bucket.

The dispatch hot path is amortized two ways: partition slicing plans are
memoized per (row-count, config) in :mod:`repro_torch.core.backends.base`, and
:class:`ContextPool` recycles ``ExecutionContext`` objects per workload,
swapping in each request's buffers instead of rebuilding a
:class:`StreamedRunner` (an empty shared dict then costs zero H2D).

No thread here waits for the whole device: a worker waits on its
request's stream, and the coordinator's swaps and cold-path profiling
wait on the leased context's stream.  Leased contexts never share a
stream (:class:`ContextPool`), so such a wait covers that request's work
alone.  That lets requests in flight overlap on the card; it does not
make them: PERF.md records the window's measured throughput.  The coordinator's features trace
the kernel with ``make_fx`` / ``FlopCounterMode``, whose dispatch modes
are thread-local, so the workers' real launches never enter that trace.

Measurement discipline: cold-path profiling (feature extraction, the
single-stream anchor of a persisted warm hit) drains the in-flight
window first, so the numbers persisted into the tuning cache and the
prediction anchor are measured on an idle pool.  ``measured_s`` itself
is wall time under concurrency — contention inflates it relative to an
isolated run — so the drift signal is **load-aware**: each dispatch is
stamped with its window occupancy, and at retire time ``measured_s`` is
divided by ``contention_factor(inflight, parallel_capacity, workers)``
(occupancy over the host's calibrated thread-scaling ceiling) before
the prediction error is computed.  Overlap inflation therefore no
longer masquerades as model drift; ``load_aware=False`` restores the
raw-wall-time signal for A/B measurement.
"""
from __future__ import annotations

import collections
import dataclasses
import sys
from concurrent.futures import FIRST_COMPLETED, wait
from typing import Optional

from repro_torch.core.backends import (ExecutionContext, new_stream,
                                       release_stream)
from repro_torch.core.backends.host_threads import WindowedPool
from repro_torch.core.streams import StreamedRunner, probe_host_capacity
from repro_torch.core.workloads import get_workload
from repro_torch.device import resolve_device
from repro_torch.serving.queue import WorkloadRequest
from repro_torch.serving.refinement import DriftDetector, contention_factor
from repro_torch.serving.scheduler import (AdaptiveScheduler, PendingRequest,
                                     RequestResult)


class ContextPool:
    """Per-workload free lists of reusable :class:`ExecutionContext`\\ s,
    and the stream pairs they issue on.

    Concurrent requests of the same workload each lease their own
    context (their chunked/shared buffers differ); a released context is
    recycled for the next lease with
    :meth:`ExecutionContext.swap_buffers`.  The streams belong to the
    pool, not to the pooled contexts: a lease attaches a free (stream,
    copy stream) pair, and the pair goes back as soon as the request's
    execution is over (:meth:`detach`, its outputs read back) — not at
    retire, which may wait behind an earlier request of the same bucket
    for as long as that one retries.  So the pool holds as many pairs as
    requests executed at once (the window, plus runners held for a
    deferred refinement, which :meth:`attach` gives a pair again, or a
    watchdog zombie), each claimed with
    :func:`~repro_torch.core.backends.base.new_stream` until
    :meth:`close`, so no two executing contexts share a stream.
    ``max_attached`` is the most contexts that held a pair at once (on
    the CPU too, where the pair is two Nones)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._free: dict[str, list[ExecutionContext]] = {}
        self._streams: list[tuple] = []  # free (stream, copy_stream) pairs
        self._claimed: list = []         # every stream this pool claimed
        self._attached: set = set()      # ids of contexts holding a pair
        self.max_attached = 0
        self.leases = 0
        self.reuses = 0

    def _take_streams(self) -> tuple:
        if self.device.type != "cuda":
            return (None, None)
        if self._streams:
            return self._streams.pop()
        pair = (new_stream(self.device), new_stream(self.device))
        self._claimed.extend(pair)
        return pair

    def _mark_attached(self, ctx: ExecutionContext) -> ExecutionContext:
        self._attached.add(id(ctx))
        self.max_attached = max(self.max_attached, len(self._attached))
        return ctx

    def lease(self, wl, chunked: dict, shared: dict) -> ExecutionContext:
        """A context holding this request's buffers, on a free stream
        pair: the swap re-pins and re-uploads on that stream."""
        self.leases += 1
        streams = self._take_streams()
        free = self._free.get(wl.name)
        if free:
            self.reuses += 1
            ctx = free.pop()
            ctx.stream, ctx.copy_stream = streams
            return self._mark_attached(ctx.swap_buffers(chunked, shared))
        return self._mark_attached(ExecutionContext.create(
            wl.kernel, chunked, shared, self.device, streams=streams))

    def attach(self, ctx: ExecutionContext) -> None:
        """Give a leased, detached context a free stream pair again (a
        deferred refinement re-profiles on it)."""
        if id(ctx) not in self._attached:
            ctx.stream, ctx.copy_stream = self._take_streams()
            self._mark_attached(ctx)

    def detach(self, ctx: ExecutionContext) -> None:
        """``ctx``'s request issues nothing more: its stream pair goes
        back to the pool while the context waits to retire."""
        if id(ctx) in self._attached:
            self._attached.discard(id(ctx))
            if ctx.stream is not None:
                self._streams.append((ctx.stream, ctx.copy_stream))
                ctx.stream = ctx.copy_stream = None

    def release(self, name: str, ctx: ExecutionContext) -> None:
        """Recycle ``ctx``; its request is done, so its streams are idle."""
        self.detach(ctx)
        self._free.setdefault(name, []).append(ctx)

    def close(self) -> None:
        """Release the claimed streams; every request is done."""
        release_stream(*self._claimed)
        self._claimed, self._streams = [], []


class OrderedRetirer:
    """Buffers out-of-order completions so each bucket retires in its own
    dispatch order.

    ``issue(key)`` stamps a dispatch index for the bucket;
    ``complete(key, idx, payload)`` hands back every payload that is now
    retirable — i.e. the contiguous run of completions starting at the
    bucket's next-unretired index.  Deterministic: for ANY completion
    order of a fixed dispatch sequence, the concatenation of returned
    payload lists per bucket is that bucket's dispatch order."""

    def __init__(self):
        self._issued: collections.Counter = collections.Counter()
        self._next: collections.Counter = collections.Counter()
        self._held: dict = {}

    def issue(self, key: str) -> int:
        idx = self._issued[key]
        self._issued[key] += 1
        return idx

    def complete(self, key: str, idx: int, payload) -> list:
        self._held[(key, idx)] = payload
        ready = []
        while (key, self._next[key]) in self._held:
            ready.append(self._held.pop((key, self._next[key])))
            self._next[key] += 1
        return ready

    @property
    def held(self) -> int:
        return len(self._held)


class ConcurrentScheduler(AdaptiveScheduler):
    """Adaptive scheduler with up to ``window`` requests in flight.

    ``window=1`` degenerates to the serial scheduler (same stages, same
    results, one extra thread hop).  Decisions, cold tuning, and
    retirement all run on the coordinating thread; only the execute
    stage — warmup, dispatch, block, D2H read-back — runs on pool
    workers, so all scheduler state mutation stays single-threaded."""

    def __init__(self, model, *, window: int = 4,
                 workers: Optional[int] = None,
                 capacity: Optional[float] = None,
                 load_aware: bool = True, **kwargs):
        # default drift detector: same thresholds as the serial
        # scheduler's, plus a load discount — samples retired at high
        # window occupancy carry residual contention noise the
        # normalization can't fully cancel, and at 10^5-request scale
        # that noise WILL eventually line up into a spurious window.
        # Callers passing their own detector keep full control.
        if kwargs.get("drift") is None:
            kwargs["drift"] = DriftDetector(load_discount=0.5)
        super().__init__(model, **kwargs)
        assert window >= 1, window
        self.window = window
        self.workers = workers if workers is not None else window
        self.pool = WindowedPool(self.workers, window, name="serve-engine")
        self.ctx_pool = ContextPool(self.device)
        self.retirer = OrderedRetirer()
        # load-aware drift: ``capacity`` is the host's measured
        # N-thread kernel-scaling ceiling (see
        # core.streams.parallel_capacity).  None → calibrated by a
        # one-off probe at ``run()`` entry, while the pool is idle.
        # ``load_aware=False`` reverts to raw-wall-time drift (the
        # pre-tenancy behavior, kept for A/B measurement).
        self.load_aware = load_aware
        self._capacity = capacity
        # drift-triggered refinements queue here and re-profile at the
        # next pool-quiesce point (the runner is held un-released until
        # then): profiling on a busy pool would write contention-skewed
        # measured speedups into the cache — the exact poisoning the
        # load-aware drift signal exists to prevent
        self._deferred_refinements: list = []
        # watchdog-abandoned futures: the worker is still running (a
        # thread cannot be cancelled mid-dispatch), so the future parks
        # here and a done-callback reclaims its ExecutionContext when
        # the backend finally returns; pool.shutdown(wait=True) at
        # close() joins them
        self._zombies: set = set()
        self._m_watchdog = self.metrics.counter("serving.watchdog.fired")

    @property
    def parallel_capacity(self) -> float:
        """The calibrated thread-scaling ceiling the contention factor
        divides by; probed once on first use when not injected."""
        if self._capacity is None:
            self._capacity = max(1.0, probe_host_capacity(
                self.workers, device=self.device))
        return self._capacity

    # -- pooled runners -------------------------------------------------------

    def _make_runner(self, req: WorkloadRequest) -> StreamedRunner:
        wl = get_workload(req.workload)
        ctx = self.ctx_pool.lease(wl, req.chunked, req.shared)
        return StreamedRunner(wl, req.chunked, req.shared,
                              backend=self.backend_name, ctx=ctx)

    def _release_runner(self, runner: StreamedRunner) -> None:
        self.ctx_pool.release(runner.wl.name, runner.ctx)

    # -- load-aware drift -----------------------------------------------------

    def _load_factor(self, pending: PendingRequest) -> float:
        """Occupancy over capacity: a request that shared the window
        with others has its ``measured_s`` deflated back to an isolated-
        run estimate before drift detection sees it.  An uncontended
        request (``inflight == 1``) never pays the calibration probe."""
        if not self.load_aware or pending.inflight <= 1:
            return 1.0
        return contention_factor(pending.inflight, self.parallel_capacity,
                                 self.workers)

    def _refine(self, pending, ctx, key, entry) -> None:
        """Defer the re-profiling to the next quiesce point; the
        triggering request's runner is kept leased until then so the
        refiner measures this request's own buffers, not a recycled
        context's."""
        pending.defer_release = True
        self._deferred_refinements.append((pending, ctx, key, entry))

    def _flush_refinements(self) -> None:
        """Run queued refinements on the now-idle pool (callers drain
        first), then release the held runners.  Under a resilience
        policy a failing refinement loses one model update, never the
        run."""
        while self._deferred_refinements:
            pending, ctx, key, entry = self._deferred_refinements.pop(0)
            try:
                self.ctx_pool.attach(pending.runner.ctx)
                super()._refine(pending, ctx, key, entry)
            except Exception:  # noqa: BLE001 — fault barrier
                if self.resilience is None:
                    raise
                self.stats["refine_failures"] += 1
                self.metrics.counter("serving.refine.failed").inc()
            finally:
                self._release_runner(pending.runner)

    # -- the overlapped serving loop ------------------------------------------

    def run(self, max_requests: Optional[int] = None) -> list[RequestResult]:
        """Drain the queue with up to ``window`` requests in flight;
        returns results in decision (queue-policy) order."""
        # the coordinator contends for the GIL with busy workers; at the
        # default 5 ms switch interval a retire-and-refill cycle can
        # stall long enough to starve the pool, so run with a tighter
        # interval (restored on exit) — the same knob threaded Python
        # servers tune
        prev_switch = sys.getswitchinterval()
        sys.setswitchinterval(min(prev_switch, 1e-3))
        try:
            return self._run(max_requests)
        finally:
            sys.setswitchinterval(prev_switch)

    def _flush_ready(self, flushed, results: dict) -> None:
        """Retire a bucket's now-contiguous dispatch-order run.  ``None``
        payloads (failed or watchdog-abandoned slots) were already
        accounted for when their slot advanced."""
        for item in flushed:
            if item is None:
                continue
            rp, routs, rmeasured = item
            try:
                results[rp.order] = self._retire(rp, routs, rmeasured)
            except Exception as e:  # noqa: BLE001 — fault barrier
                if self.resilience is None:
                    raise
                results[rp.order] = self._fail_request(rp.req, rp, e)
                rp.defer_release = False
            # a retire that triggered a refinement keeps its runner
            # leased until the deferred re-profiling has run
            if not rp.defer_release:
                self._release_runner(rp.runner)

    def _retire_completed(self, done, inflight: dict,
                          results: dict) -> Optional[BaseException]:
        """Retire a set of completed futures, flushing each touched
        bucket's contiguous dispatch-order run.  A future that raised
        still advances its bucket (a poisoned slot would hold every
        later completion of that bucket forever) and releases its
        context before the error is reported.  Without a resilience
        policy the first error seen is returned rather than raised so
        the caller can drain the rest; WITH one, an execution error
        fails that request individually (error telemetry + ``status``)
        and the loop keeps serving."""
        error: Optional[BaseException] = None
        for fut in done:
            p = inflight.pop(fut)
            try:
                payload = (p, *fut.result())
                # executed and read back: the streams can serve the next
                # request while this one waits to retire in bucket order
                self.ctx_pool.detach(p.runner.ctx)
            # deliberate blanket catch: ANY worker outcome must advance
            # the bucket slot or every later completion hangs
            except BaseException as e:  # noqa: BLE001
                self._release_runner(p.runner)
                payload = None
                if self.resilience is not None and isinstance(e, Exception):
                    results[p.order] = self._fail_request(p.req, p, e)
                elif error is None:
                    error = e
            self._flush_ready(self.retirer.complete(p.key, p.bucket_idx,
                                                    payload), results)
        return error

    def _wait_completed(self, inflight: dict, results: dict) -> set:
        """Wait for at least one completion — with the resilience
        watchdog armed, wake at the earliest in-flight deadline instead
        and reap overdue executions (abandon + requeue once, then fail
        individually).  Returns the completed set; empty after a reap
        pass (the caller re-enters with the updated window)."""
        if not inflight:
            return set()
        wd = self.resilience.watchdog_s \
            if self.resilience is not None else None
        if wd is None:
            done, _ = wait(inflight, return_when=FIRST_COMPLETED)
            return done
        while True:
            now = self.clock.now()
            deadlines = [p.watchdog_deadline_s for p in inflight.values()
                         if p.watchdog_deadline_s is not None]
            # no stamped deadline = nothing has STARTED executing yet
            # (deadlines arm at worker entry); heartbeat at wd anyway
            timeout = max(1e-3, min(deadlines) - now) if deadlines else wd
            done, _ = wait(inflight, timeout=timeout,
                           return_when=FIRST_COMPLETED)
            if done:
                return done
            if self._reap_overdue(inflight, results) or not inflight:
                return set()

    def _reclaim_zombie(self, fut, runner):
        def _cb(f) -> None:
            self._zombies.discard(fut)
            try:
                f.result()
            # the zombie's outcome is irrelevant — its slot was already
            # advanced and its request requeued or failed
            except BaseException:  # noqa: BLE001
                pass
            self._release_runner(runner)
        return _cb

    def _watched_execute(self, p):
        """Execute stage under the watchdog: the deadline arms at
        WORKER ENTRY, not at submit — a task queued behind a
        zombie-occupied worker must not burn its execution budget
        waiting for a thread."""
        p.watchdog_deadline_s = self.clock.now() + self.resilience.watchdog_s
        return self._execute_safe(p)

    def _reap_overdue(self, inflight: dict, results: dict) -> bool:
        """Watchdog: an execution past its deadline is abandoned (the
        worker thread cannot be cancelled; the future parks in
        ``_zombies`` and a done-callback reclaims its context), its
        bucket slot advances, and the request is re-dispatched on a
        FRESH runner at most ``requeue_limit`` times before failing
        individually with ``status="timeout"``."""
        now = self.clock.now()
        acted = False
        for fut, p in list(inflight.items()):
            if fut.done() or p.watchdog_deadline_s is None \
                    or now < p.watchdog_deadline_s:
                continue
            acted = True
            del inflight[fut]
            self._zombies.add(fut)
            fut.add_done_callback(self._reclaim_zombie(fut, p.runner))
            self._m_watchdog.inc()
            self.stats["watchdog_fired"] += 1
            self._flush_ready(self.retirer.complete(p.key, p.bucket_idx,
                                                    None), results)
            if p.requeues < self.resilience.requeue_limit:
                p2 = dataclasses.replace(
                    p, runner=self._make_runner(p.req),
                    requeues=p.requeues + 1,
                    bucket_idx=self.retirer.issue(p.key),
                    watchdog_deadline_s=None)
                inflight[self.pool.submit(self._watched_execute, p2)] = p2
            else:
                results[p.order] = self._fail_request(
                    p.req, p,
                    TimeoutError(
                        f"execution exceeded the "
                        f"{self.resilience.watchdog_s:g}s watchdog "
                        f"{p.requeues + 1}x"),
                    status="timeout")
        return acted

    def _drain(self, inflight: dict,
               results: dict) -> Optional[BaseException]:
        """Retire everything in flight; returns the first error seen."""
        error = None
        while inflight:
            done = self._wait_completed(inflight, results)
            if done:
                error = self._retire_completed(done, inflight,
                                               results) or error
        return error

    def _run(self, max_requests: Optional[int]) -> list[RequestResult]:
        results: dict[int, RequestResult] = {}
        inflight: dict = {}                  # future -> PendingRequest
        decided = 0

        # calibrate the contention ceiling NOW, while nothing is in
        # flight: a lazy probe at the first contended retire would time
        # itself against the engine's own busy workers and cache a
        # permanently understated capacity (overstated load factors,
        # masked real drift)
        if self.load_aware and self.window > 1 and self._capacity is None:
            _ = self.parallel_capacity

        def budget_left() -> bool:
            return max_requests is None or decided < max_requests

        def check(error: Optional[BaseException]) -> None:
            if error is not None:
                # finish the survivors cleanly, then surface the failure;
                # queued refinements are abandoned (their runners still
                # go back to the pool), not profiled mid-error
                self._drain(inflight, results)
                for p, *_ in self._deferred_refinements:
                    self._release_runner(p.runner)
                self._deferred_refinements.clear()
                raise error

        while (self.queue and budget_left()) or inflight:
            # drift refinements queued by the last retire wave run FIRST,
            # on a drained pool, so (a) their re-profiling is measured
            # idle and (b) the decisions below see the refreshed cache
            # entry — the same visibility inline refinement had
            if self._deferred_refinements:
                check(self._drain(inflight, results))
                self._flush_refinements()
            # decide: fill the free window slots in queue-policy order
            batch: list[PendingRequest] = []
            while (self.queue and budget_left()
                   and len(inflight) + len(batch) < self.window):
                try:
                    req = self.queue.pop()
                except IndexError:
                    break   # deadline policy shed everything that was left
                try:
                    batch.append(self._decide(req))
                except Exception as e:  # noqa: BLE001 — fault barrier
                    if self.resilience is None:
                        raise
                    # _decide failed before allocating an order slot
                    results[self._order] = self._fail_request(req, None, e)
                    self._order += 1
                decided += 1
            # batched cold path: one model search for every cold bucket
            # in this fill, measured on a quiesced pool — profiling
            # (cold features, single-stream anchors) on a busy pool
            # would persist contention-skewed numbers into the tuning
            # cache and the prediction anchor
            colds = [p for p in batch if p.entry is None]
            anchors = [p for p in batch if p.needs_anchor]
            if colds or anchors:
                check(self._drain(inflight, results))
            for p in anchors:
                if self.resilience is None:
                    self._measure_anchor(p)
                else:
                    self._try_anchor(p)
            if len(colds) == 1:
                self._tune_cold_safe(colds[0])
            elif colds:
                try:
                    self._tune_cold_batch(colds)
                except Exception:  # noqa: BLE001 — fault barrier
                    if self.resilience is None:
                        raise
                    # batched search died: walk the ladder per bucket
                    for p in colds:
                        if p.entry is None:
                            self._tune_cold_safe(p)
            # dispatch: stamp each request's window occupancy — the
            # load-aware drift signal's numerator.  The whole wave is in
            # flight together (submits are microseconds, executions are
            # milliseconds), so every member gets the post-dispatch
            # occupancy; stamping len(inflight)+1 per submit would leave
            # the wave's FIRST request marked uncontended and its
            # contention-inflated wall time reading as drift
            occupancy = len(inflight) + len(batch)
            wd = self.resilience.watchdog_s \
                if self.resilience is not None else None
            run_stage = (self._execute_safe if wd is None
                         else self._watched_execute)
            for p in batch:
                p.bucket_idx = self.retirer.issue(p.key)
                p.inflight = occupancy
                inflight[self.pool.submit(run_stage, p)] = p
            self._m_inflight.set(occupancy)
            if not inflight:
                continue
            # retire whatever completed first (out of order); an empty
            # set means the watchdog reshaped the window instead
            done = self._wait_completed(inflight, results)
            if done:
                check(self._retire_completed(done, inflight, results))

        self._flush_refinements()          # pool is idle: nothing in flight
        self._m_inflight.set(0)
        assert self.retirer.held == 0, "completions left unretired"
        assert not inflight, "futures left in flight"
        self.stats["ctx_reuses"] = self.ctx_pool.reuses
        return [results[i] for i in sorted(results)]

    def step(self) -> RequestResult:
        (result,) = self.run(max_requests=1)
        return result

    def close(self) -> None:
        """Worker-pool shutdown, stream release + telemetry
        flush/fsync/close."""
        self.pool.shutdown()
        self.ctx_pool.close()
        super().close()

    def shutdown(self) -> None:
        self.close()
