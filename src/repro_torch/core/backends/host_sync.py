"""The synchronous host backend — the numerical reference.

Mirrors Figure 8c of the paper on one device and one stream:
  * the outer iteration space is split into ``tasks`` chunks;
  * each chunk's host->device copy is issued asynchronously from pinned
    memory on the context's stream, and the host runs ahead while the
    device works through copies and kernels in order;
  * each chunk's kernel is dispatched as ``partitions`` sub-slices, which
    sets the kernel working-set granularity and dispatch parallelism —
    the spatial-sharing analogue.

The host loop runs ahead without bound: nothing caps how many tasks are
in flight, and each task's buffers are fresh allocations.  The pipelined
sibling (:mod:`repro_torch.core.backends.host_pipelined`) fixes both.
"""
from __future__ import annotations

from repro_torch.core.backends.base import (ExecutionContext, StreamBackend,
                                            dispatch_plan, slice_rows,
                                            to_device)


class SyncHostBackend(StreamBackend):
    name = "host-sync"
    kind = "runner"

    def dispatch(self, ctx: ExecutionContext, config) -> list:
        n_rows = next(iter(ctx.chunked.values())).shape[0]
        outs = []
        with ctx.issuing():
            for parts in dispatch_plan(n_rows, config):
                t_lo = parts[0][0]
                task = slice_rows(ctx.chunked, t_lo, parts[-1][1])
                task_dev = to_device(task, ctx.device)      # async H2D
                # partition slicing happens on the DEVICE chunk, as in the
                # reference executor
                for p_lo, p_hi in parts:
                    part = slice_rows(task_dev, p_lo - t_lo, p_hi - t_lo)
                    outs.append(ctx.kernel(part, ctx.shared_dev))
        return outs
