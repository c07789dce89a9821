"""Pipelined double-buffered host backend on two CUDA streams.

Three changes over the synchronous backend:

  1. **Partition slicing happens on the host, before transfer.**  Each
     partition slice is cut from the pinned host tensor and shipped
     exactly once.
  2. **Depth-``d`` in-flight window (double buffering at d=2).**  Task
     i+1's H2D copy is staged on a copy stream while task i's kernels run
     on the compute stream (the context's own), which waits on the copy's
     event;
     the oldest task is retired (its event synchronized) before a new one
     is issued, so at most ``depth`` tasks' buffers are live instead of
     the whole dataset's.
  3. **Buffer reuse.**  Each staged input is marked as used on the
     compute stream (``record_stream``), so when a retired task's inputs
     are freed the caching allocator hands their memory to later copies
     only after the kernels that read them have finished.

On the CPU device there are no streams: copies are no-ops and the window
only orders the calls.
"""
from __future__ import annotations

import collections
import contextlib

import torch

from repro_torch.core.backends.base import (ExecutionContext, StreamBackend,
                                            dispatch_plan, slice_rows,
                                            to_device)


class PipelinedHostBackend(StreamBackend):
    name = "host-pipelined"
    kind = "runner"

    def __init__(self, depth: int = 2):
        assert depth >= 1, depth
        self.depth = depth

    def dispatch(self, ctx: ExecutionContext, config) -> list:
        # host-side slicing plan: tasks x partitions, memoized boundaries,
        # each slice a view cut straight from the pinned host tensors
        n_rows = next(iter(ctx.chunked.values())).shape[0]
        plans = dispatch_plan(n_rows, config)
        cuda = ctx.device.type == "cuda"
        compute = ctx.stream

        staged: collections.deque = collections.deque()
        inflight: collections.deque = collections.deque()
        outs: list = []

        def stage(idx: int) -> None:
            with (torch.cuda.stream(ctx.copy_stream) if cuda
                  else contextlib.nullcontext()):
                parts = [to_device(slice_rows(ctx.chunked, lo, hi),
                                   ctx.device)  # async H2D
                         for lo, hi in plans[idx]]
            copied = None
            if cuda:
                copied = torch.cuda.Event()
                copied.record(ctx.copy_stream)
            staged.append((parts, copied))

        # prime the pipeline: H2D for the first `depth` tasks
        for idx in range(min(self.depth, len(plans))):
            stage(idx)
        next_stage = min(self.depth, len(plans))
        for _ in range(len(plans)):
            parts, copied = staged.popleft()
            if cuda:
                compute.wait_event(copied)
                for part in parts:
                    for t in part.values():
                        t.record_stream(compute)
            with ctx.issuing():
                task_outs = [ctx.kernel(part, ctx.shared_dev)  # async compute
                             for part in parts]
            outs.extend(task_outs)
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record(compute)
            inflight.append(done)
            if next_stage < len(plans):
                stage(next_stage)  # H2D of i+depth overlaps compute of i
                next_stage += 1
            while len(inflight) >= self.depth:
                # retire the oldest task: bounds live buffers to the window
                done = inflight.popleft()
                if done is not None:
                    done.synchronize()
        return outs
