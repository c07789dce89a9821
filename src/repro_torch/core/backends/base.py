"""Executor-backend protocol: how a (partitions, tasks) stream config is
realized on one torch device.

A backend receives an :class:`ExecutionContext` — the per-run state
(kernel, host data, device, resident shared buffers, its streams) —
and a :class:`~repro_torch.core.stream_config.StreamConfig`, and returns
the list of per-slice outputs in deterministic (task-major,
partition-minor) order.  That ordering contract is what makes every
backend comparable against the single-stream reference: concatenating the
outputs along axis 0 must reproduce the unsplit result for ``concat``
workloads.

Kernels run eagerly: each call launches the workload's torch ops on the
context's own stream, with nothing compiled ahead.  Every wait is on that
stream (or on an event recorded on it), never device-wide.  Streams come
from :func:`new_stream`, which never hands out a claimed stream, and
owners that issue at the same time claim theirs: a context is leased by
one request at a time, so its stream holds only that request's work,
and a wait on it does not wait for other requests in flight on other
contexts' streams.
"""
from __future__ import annotations

import abc
import contextlib
import dataclasses
import threading
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

# serializes the eviction loop of the plan cache: backends may dispatch
# from pool worker threads
_MEMO_LOCK = threading.Lock()


def split_arrays(arrs: dict, n: int) -> list[dict]:
    """Split every array in the dict into n chunks along axis 0."""
    if n == 1:
        return [arrs]
    keys = list(arrs)
    pieces = {k: np.array_split(arrs[k], n) for k in keys}
    return [{k: pieces[k][i] for k in keys} for i in range(n)]


# Dispatch-plan cache: the (start, stop) row ranges of every task and
# partition slice depend only on (row count, config), so the boundaries are
# memoized here and the arrays sliced directly — the hot-path cost per
# dispatch is plain ``a[lo:hi]`` views.
_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 4096


def _split_bounds(lo: int, hi: int, n: int) -> list[tuple[int, int]]:
    """(start, stop) ranges identical to ``np.array_split`` of hi-lo rows
    into n pieces (first ``rem`` pieces get the extra row)."""
    total = hi - lo
    base, rem = divmod(total, n)
    bounds = []
    start = lo
    for i in range(n):
        size = base + (1 if i < rem else 0)
        bounds.append((start, start + size))
        start += size
    return bounds


def dispatch_plan(n_rows: int, config) -> tuple:
    """Memoized slicing plan for one dispatch: a tuple of tasks, each a
    tuple of global (start, stop) partition row ranges — task-major,
    partition-minor, byte-identical boundaries to the nested
    ``split_arrays``.

    Thread-safe: the eviction loop runs under the memo lock (the hit path
    stays lock-free — a racy ``get`` of an immutable tuple is fine)."""
    key = (n_rows, config.partitions, config.tasks)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        with _MEMO_LOCK:
            plan = _PLAN_CACHE.get(key)
            if plan is None:
                while len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
                    _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)), None)
                plan = tuple(
                    tuple(_split_bounds(t_lo, t_hi, config.partitions))
                    for t_lo, t_hi in _split_bounds(0, n_rows, config.tasks))
                _PLAN_CACHE[key] = plan
    return plan


def slice_rows(arrs: dict, lo: int, hi: int) -> dict:
    """Row-range view of every array in the dict (no copies)."""
    return {k: a[lo:hi] for k, a in arrs.items()}


# (device index, raw handle) of every stream claimed and not yet released
_CLAIMED: set = set()
_CLAIM_LOCK = threading.Lock()


def _key(stream: torch.cuda.Stream) -> tuple:
    return (stream.device_index, stream.cuda_stream)


def new_stream(device: torch.device, claim: bool = True) -> torch.cuda.Stream:
    """A CUDA stream on ``device`` that no claimed stream is.

    ``torch.cuda.Stream`` hands out the streams of a small per-device pool
    round-robin, so two owners can get the same one, and a wait on it then
    waits for both owners' work.  An attempt that lands on a claimed
    stream takes the pool's next.  With ``claim`` the stream is claimed
    until :func:`release_stream`: owners that issue at the same time
    (the engine's leased contexts, pool threads) claim theirs.  Raises
    when every pooled stream is claimed."""
    with _CLAIM_LOCK:
        for _ in range(64):
            stream = torch.cuda.Stream(device)
            if _key(stream) not in _CLAIMED:
                if claim:
                    _CLAIMED.add(_key(stream))
                return stream
    raise RuntimeError(f"every pooled CUDA stream of {device} is claimed "
                       f"({len(_CLAIMED)} claims)")


def release_stream(*streams) -> None:
    """Give claimed streams back (None entries are skipped)."""
    with _CLAIM_LOCK:
        for stream in streams:
            if stream is not None:
                _CLAIMED.discard(_key(stream))


def to_device(tensors: dict, device: torch.device) -> dict:
    """Copy every tensor to ``device``, asynchronously from pinned memory
    on the current stream (on the CPU device: the tensors themselves)."""
    return {k: t.to(device, non_blocking=True) for k, t in tensors.items()}


def _host_tensors(arrs: dict, device: torch.device) -> dict:
    """The numpy arrays as host tensors, page-locked when they are to be
    copied to a CUDA device: a copy from pageable memory is synchronous,
    and then nothing overlaps."""
    out = {k: torch.from_numpy(np.ascontiguousarray(a))
           for k, a in arrs.items()}
    if device.type == "cuda":
        out = {k: t.pin_memory() for k, t in out.items()}
    return out


@dataclasses.dataclass
class ExecutionContext:
    """Per-(workload, dataset) state shared by every runner backend.

    ``chunked`` holds the host tensors the backends slice (pinned on a
    CUDA device), ``shared_dev`` the shared tensors, resident on the
    device.  ``stream`` is the stream this context's work is issued on
    and waited for; ``copy_stream`` the side stream the pipelined backend
    stages its copies on (both None on the CPU; on a CUDA device handed
    in by the caller, or else unclaimed streams from :func:`new_stream`:
    a runner on its own is used by one thread at a time).
    One stream per context, not per thread: the coordinator and a pool
    worker both touch a request's context (swap and features there,
    execution here), so the stream follows the request, not the thread.
    The serving engine's context pool owns its stream pairs and gives a
    free one to each context it leases (one request at a time), so the
    pool needs as many pairs as it has requests leased, not one per
    pooled context."""

    kernel: Callable
    chunked: dict
    device: torch.device
    shared_dev: dict
    stream: Optional[torch.cuda.Stream] = None
    copy_stream: Optional[torch.cuda.Stream] = None

    @classmethod
    def create(cls, kernel: Callable, chunked: dict, shared: dict,
               device="cuda", streams=None) -> "ExecutionContext":
        """``streams``: the (stream, copy_stream) pair to issue on; None
        takes a new unclaimed pair on a CUDA device."""
        device = resolve_device(device)
        if streams is None:
            streams = ((new_stream(device, claim=False),
                        new_stream(device, claim=False))
                       if device.type == "cuda" else (None, None))
        ctx = cls(kernel=kernel, chunked={}, device=device, shared_dev={},
                  stream=streams[0], copy_stream=streams[1])
        return ctx.swap_buffers(chunked, shared)

    def issuing(self):
        """Context manager: this context's stream is the calling thread's
        current stream inside it (nothing on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def wait(self) -> None:
        """Block until the work issued on this context's stream is done;
        work on every other stream goes on."""
        if self.stream is not None:
            self.stream.synchronize()

    def swap_buffers(self, chunked: dict, shared: dict) -> "ExecutionContext":
        """Re-point this context at a new request's data, keeping the
        device and its copy stream.

        The chunked arrays are pinned once, untimed; buffer-validity
        tracking (paper §4.4.5): shared buffers are transferred once and
        stay resident across tasks and runs.  A workload with an empty
        shared dict ships nothing."""
        self.chunked = _host_tensors(chunked, self.device)
        with self.issuing():
            self.shared_dev = to_device(_host_tensors(shared, self.device),
                                        self.device)
        self.wait()
        return self


class StreamBackend(abc.ABC):
    """One realization of the streamed-execution strategy."""

    #: unique registry key
    name: str = ""
    #: "runner" (chunkable kernels) or "train-step" (training loops)
    kind: str = "runner"

    def dispatch(self, ctx: ExecutionContext, config) -> list:
        """Issue the full iteration space under ``config``; returns the
        per-slice outputs (possibly still in flight — callers block)."""
        raise NotImplementedError(f"{self.name} is not a runner backend")

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<StreamBackend {self.name} ({self.kind})>"
