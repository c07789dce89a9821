"""The streamed executor — AUTOSTREAMER's runtime.

The execution strategies themselves live in
:mod:`repro_torch.core.backends` (``host-sync``, ``host-pipelined``, plus
anything registered at runtime).  This module keeps the user-facing
runner: one object per (workload, dataset) pair that can execute, time,
and profile arbitrary stream configs on any registered runner backend.

Times are host wall-clock seconds around work that ends in a wait on
the context's own stream, with every output read back to the host.  No
wait here is device-wide: other requests' work on other streams goes on.
"""
from __future__ import annotations

import threading
import time
from typing import Union

import numpy as np
import torch

from repro_torch.core.backends import (ExecutionContext, StreamBackend,
                                       get_backend, new_stream,
                                       release_stream,
                                       to_device)
from repro_torch.core.stream_config import SINGLE_STREAM, StreamConfig
from repro_torch.core.workloads import Workload
from repro_torch.device import resolve_device


def readback_outputs(outs: list) -> None:
    """Copy EVERY output to the host (paper Fig 8c: results transferred
    back), one ``.cpu()`` per slice, so D2H is inside every measured
    runtime.  Each copy is issued on the calling thread's current stream
    and waits for that stream only: callers read back under the
    context's stream (``ctx.issuing()``)."""
    for o in outs:
        o.cpu()


class StreamedRunner:
    """Executes one workload+dataset under arbitrary stream configs.

    ``backend`` picks the execution strategy by registry name (or a
    :class:`StreamBackend` instance); every runner backend produces
    outputs in the same task-major order, allclose to the single-stream
    reference.  ``device`` defaults to the card; without CUDA the runner
    raises unless it is given ``device="cpu"``.
    """

    def __init__(self, wl: Workload, chunked: dict, shared: dict,
                 device="cuda", backend: Union[str, StreamBackend] = "host-sync",
                 ctx: Union[ExecutionContext, None] = None):
        self.wl = wl
        self.chunked = chunked
        self.shared = shared
        self.backend = (get_backend(backend) if isinstance(backend, str)
                        else backend)
        if self.backend.kind != "runner":
            raise ValueError(
                f"backend {self.backend.name!r} is a {self.backend.kind} "
                f"backend, not a runner")
        # a caller holding a pooled ExecutionContext wraps it instead of
        # paying create()'s pinning and shared-buffer upload again
        self.ctx = ctx if ctx is not None else ExecutionContext.create(
            wl.kernel, chunked, shared, device)
        self.device = self.ctx.device

    # -- execution -----------------------------------------------------------

    def issue(self, config: StreamConfig) -> list:
        """Issue the full iteration space under ``config`` on the
        context's own stream; returns the per-slice outputs, possibly
        still in flight there.  Wait with ``self.ctx.wait()``, and read
        them under ``self.ctx.issuing()``: the timed paths (``run``, the
        serving execute stage) do exactly that."""
        return self.backend.dispatch(self.ctx, config)

    def dispatch(self, config: StreamConfig) -> list:
        """``issue``, with the outputs handed over to the calling thread's
        current stream: that stream waits (on the device, the host does
        not block) for the context's, and each output is marked as used
        there, so the allocator does not recycle it under work the caller
        queues on it.  For callers that read the outputs on a stream of
        their own."""
        outs = self.issue(config)
        if self.ctx.stream is not None:
            current = torch.cuda.current_stream(self.device)
            if current != self.ctx.stream:
                current.wait_stream(self.ctx.stream)
                for o in outs:
                    o.record_stream(current)
        return outs

    def warmup(self, config: StreamConfig) -> None:
        """Run every sub-slice shape once before timing (allocator and
        library plans warm)."""
        self.issue(config)
        self.ctx.wait()

    def run(self, config: StreamConfig, *, reps: int = 3,
            warmed: bool = False) -> float:
        """Wall-clock seconds (min over reps) incl. H2D, compute, D2H."""
        if not warmed:
            self.warmup(config)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            outs = self.issue(config)
            # read back (paper Fig 8c: results transferred to host)
            self.ctx.wait()
            with self.ctx.issuing():
                readback_outputs(outs)
            best = min(best, time.perf_counter() - t0)
        return best

    def run_single_stream(self, *, reps: int = 3) -> float:
        return self.run(SINGLE_STREAM, reps=reps)

    # -- profiling hooks used by feature extraction ---------------------------

    def measure_transfer(self, *, reps: int = 3) -> float:
        """Seconds of one H2D copy of all the chunked data."""
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            with self.ctx.issuing():
                to_device(self.ctx.chunked, self.device)
            self.ctx.wait()
            best = min(best, time.perf_counter() - t0)
        return best

    def measure_compute(self, *, reps: int = 3) -> float:
        """Seconds of the kernel on the whole chunked data, resident."""
        with self.ctx.issuing():
            dev = to_device(self.ctx.chunked, self.device)
        self.ctx.wait()
        self.warmup(SINGLE_STREAM)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            with self.ctx.issuing():
                self.wl.kernel(dev, self.ctx.shared_dev)
            self.ctx.wait()
            best = min(best, time.perf_counter() - t0)
        return best


def parallel_capacity(calls, workers: int, *, reps: int = 8,
                      trials: int = 2) -> float:
    """Calibrate the host: how much does issuing ``calls`` from
    ``workers`` threads speed up over serial issue?

    ``calls`` are zero-arg callables that block until their work is
    done (device-resident kernels — so the ratio is the raw hardware
    scaling ceiling, not H2D noise).  Max over ``trials``
    serial/threaded pairs, because steal time on shared boxes deflates
    single trials."""
    import concurrent.futures

    n = max(1, reps) * len(calls)

    def one(i: int) -> None:
        calls[i % len(calls)]()

    pool = concurrent.futures.ThreadPoolExecutor(workers)
    try:
        best = 0.0
        for _ in range(max(1, trials)):
            t0 = time.perf_counter()
            for i in range(n):
                one(i)
            t_serial = time.perf_counter() - t0
            t0 = time.perf_counter()
            futs = [pool.submit(one, i) for i in range(n)]
            for f in futs:
                f.result()
            t_threaded = time.perf_counter() - t0
            best = max(best, t_serial / max(t_threaded, 1e-12))
    finally:
        pool.shutdown()
    return best


def probe_host_capacity(workers: int, *, size: int = 384, reps: int = 6,
                        device="cuda") -> float:
    """Capacity probe with a synthetic kernel (one matmul on ``device``)
    for callers that have no workload in hand yet — the concurrent
    engine's lazy calibration path.  Costs a few milliseconds once.

    Each calling thread issues on its own stream and waits for that
    stream alone (its own output, as the JAX package blocks on its own
    array), so the ratio measures how the host's issue scales with
    threads, not threads queued behind one another's waits."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (size, size)).astype(np.float32)).to(dev)
    if dev.type != "cuda":
        def call() -> None:
            x @ x
        call()                                  # warm, untimed
        return parallel_capacity([call], workers, reps=reps)
    torch.cuda.current_stream(dev).synchronize()  # x, uploaded here
    # one claimed stream for each thread that issues: the caller and the
    # workers
    streams = [new_stream(dev) for _ in range(workers + 1)]
    free, local, lock = list(streams), threading.local(), threading.Lock()

    def call() -> None:
        stream = getattr(local, "stream", None)
        if stream is None:
            with lock:
                stream = local.stream = free.pop()
        with torch.cuda.stream(stream):
            x @ x
        stream.synchronize()

    try:
        call()                                  # warm, untimed
        return parallel_capacity([call], workers, reps=reps)
    finally:
        release_stream(*streams)


def profile_config_grid(runner: StreamedRunner, configs, *, reps: int = 3,
                        verbose: bool = False) -> dict[StreamConfig, float]:
    """Exhaustive profiling of a config grid (paper §3.1.2)."""
    out = {}
    for cfg in configs:
        out[cfg] = runner.run(cfg, reps=reps)
        if verbose:
            print(f"  {cfg.partitions:3d}x{cfg.tasks:<3d} {out[cfg]*1e3:8.3f} ms")
    return out


def profile_grid_interleaved(runner: StreamedRunner, configs, *,
                             sweeps: int = 3,
                             prior: Union[dict, None] = None
                             ) -> dict[StreamConfig, float]:
    """Min-per-config over round-robin sweeps of the grid.

    Interleaving beats back-to-back reps on shared boxes: a
    neighbor-load spike spans one sweep's worth of configs, not every
    sample of one config, so the per-config min survives it and the
    argmin is not a lottery.  ``prior`` merges a previous profile of the
    same configs."""
    best = dict(prior) if prior else {c: float("inf") for c in configs}
    for c in configs:
        runner.warmup(c)
    for _ in range(max(1, sweeps)):
        for c in configs:
            best[c] = min(best[c], runner.run(c, reps=1, warmed=True))
    return best
