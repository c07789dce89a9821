"""Thread-pool host backend: tasks issued from worker threads with a
bounded in-flight window.

Where ``host-pipelined`` overlaps H2D and compute by interleaving async
dispatches from one host thread, this backend overlaps them by issuing
each task (transfer + kernel launches + retire) from a pool thread — the
host-side analogue of multiple hardware queues.  Each pool thread issues
on its own claimed CUDA stream (:meth:`WindowedPool.thread_stream`):
non-blocking H2D copies from the pinned row-range views,
the kernel, then a wait on that stream alone before the task's future
completes.  Without a stream of its own every pool thread would issue on
the legacy default stream, and no two tasks could overlap on the card.

Ordering contract: outputs are collected into a task-indexed slot table,
so the returned list is task-major, partition-minor regardless of the
completion order of the workers.

The pool machinery lives in :class:`WindowedPool` so other consumers —
the concurrent serving engine (:mod:`repro_torch.serving.engine`) overlaps
whole *requests* on the same primitive — get the lazy executor and the
bounded-window discipline without reimplementing it.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core.backends.base import (ExecutionContext, StreamBackend,
                                            dispatch_plan, new_stream,
                                            release_stream, slice_rows,
                                            to_device)


class WindowedPool:
    """A lazily created thread pool plus a bounded in-flight window.

    ``window`` bounds how many submitted items may be un-retired at once
    — the live-buffer bound the pipelined backend gets from its
    depth-``d`` deque, enforced here by blocking the submitting thread on
    the oldest outstanding future.  :meth:`thread_stream` gives each
    thread that asks a claimed CUDA stream of its own, released by
    :meth:`shutdown`.
    """

    def __init__(self, workers: int = 4, window: int = 8,
                 name: str = "windowed-pool"):
        assert workers >= 1 and window >= 1, (workers, window)
        self.workers = workers
        self.window = window
        self.name = name
        self._pool: Optional[ThreadPoolExecutor] = None
        self._lock = threading.Lock()
        self._local = threading.local()
        self._streams: list = []    # every stream thread_stream claimed

    def executor(self) -> ThreadPoolExecutor:
        # lazy: module import registers backend instances, and spawning
        # threads at import time would cost every process that never
        # dispatches.  Locked: the registered backend instance is shared,
        # and engine workers dispatch on it at once
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.workers, thread_name_prefix=self.name)
            return self._pool

    def thread_stream(self, device: torch.device) -> torch.cuda.Stream:
        """The calling thread's own stream on ``device``, claimed on its
        first call: pool threads issue on it instead of the legacy default
        stream, which every thread without a stream of its own shares."""
        streams = getattr(self._local, "streams", None)
        if streams is None:
            streams = self._local.streams = {}
        stream = streams.get(device)
        if stream is None:
            stream = streams[device] = new_stream(device)
            with self._lock:
                self._streams.append(stream)
        return stream

    def submit(self, fn: Callable, *args) -> Future:
        return self.executor().submit(fn, *args)

    def run_ordered(self, fn: Callable, items: Sequence) -> list:
        """``[fn(x) for x in items]`` on the pool: submission order, at
        most ``window`` in flight, results in item order regardless of
        completion order."""
        pool = self.executor()
        results: list = [None] * len(items)
        inflight: collections.deque = collections.deque()
        for i, item in enumerate(items):
            while len(inflight) >= self.window:
                j, fut = inflight.popleft()
                results[j] = fut.result()
            inflight.append((i, pool.submit(fn, item)))
        while inflight:
            j, fut = inflight.popleft()
            results[j] = fut.result()
        return results

    def shutdown(self) -> None:
        """Join the threads and release their streams."""
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        with self._lock:
            streams, self._streams = self._streams, []
            self._local = threading.local()
        release_stream(*streams)


class ThreadedHostBackend(StreamBackend):
    name = "host-threads"
    kind = "runner"

    def __init__(self, workers: int = 4, window: int = 8):
        self.pool = WindowedPool(workers, window, name="host-threads")
        self.workers = workers
        self.window = window

    def dispatch(self, ctx: ExecutionContext, config) -> list:
        n_rows = next(iter(ctx.chunked.values())).shape[0]
        plans = dispatch_plan(n_rows, config)

        def issue(parts):
            stream = (self.pool.thread_stream(ctx.device)
                      if ctx.device.type == "cuda" else None)
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                devs = [to_device(slice_rows(ctx.chunked, lo, hi),
                                  ctx.device) for lo, hi in parts]
                outs = [ctx.kernel(pd, ctx.shared_dev) for pd in devs]
            if stream is not None:
                # the outputs were allocated on this thread's stream and
                # are read back, and freed, under the context's: the
                # allocator must not recycle them before that stream is
                # done with them.  The inputs and the shared buffers need
                # no mark — the wait below outlasts every use on this
                # stream, and the context frees them only after dispatch
                # returned.
                for o in outs:
                    o.record_stream(ctx.stream)
                # retire inside the worker: a completed future means the
                # task's buffers are no longer accumulating in flight
                stream.synchronize()
            return outs

        results = self.pool.run_ordered(issue, plans)
        return [o for task_outs in results for o in task_outs]
