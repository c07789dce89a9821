"""Pluggable executor backends for the streamed runtime.

A *backend* is one realization of the paper's (partitions, tasks)
execution strategy on one torch device.  Backends register under a
string name; the runner (:class:`repro_torch.core.streams.StreamedRunner`)
addresses them by that name, the same names the JAX package uses, so
registries, tests and tuning caches map one to one.

Built-ins:
  ``host-sync``      — the synchronous reference executor (one stream)
  ``host-pipelined`` — depth-2 double-buffered pipeline: host-side
                       partition slicing, H2D on a copy stream, the
                       caching allocator's reuse of retired inputs
  ``host-threads``   — thread-pool task issue with a bounded in-flight
                       window, each pool thread on its own CUDA stream

The JAX package's ``mesh`` train-step backend is not ported yet.

Adding a backend::

    from repro_torch.core.backends import StreamBackend, register_backend

    class MyBackend(StreamBackend):
        name = "my-backend"
        def dispatch(self, ctx, config): ...

    register_backend(MyBackend())
"""
from __future__ import annotations

from repro_torch.core.backends.base import (ExecutionContext, StreamBackend,
                                            dispatch_plan, new_stream,
                                            release_stream, slice_rows,
                                            split_arrays, to_device)
from repro_torch.core.backends.host_pipelined import PipelinedHostBackend
from repro_torch.core.backends.host_sync import SyncHostBackend
from repro_torch.core.backends.host_threads import (ThreadedHostBackend,
                                                    WindowedPool)

_BACKENDS: dict[str, StreamBackend] = {}

#: the numerical reference every runner backend must reproduce
REFERENCE_BACKEND = "host-sync"


def register_backend(backend: StreamBackend, *,
                     overwrite: bool = False) -> StreamBackend:
    """Register a backend instance under ``backend.name``."""
    if not backend.name:
        raise ValueError(f"{backend!r} has no name")
    if backend.name in _BACKENDS and not overwrite:
        raise ValueError(f"backend {backend.name!r} already registered "
                         f"(pass overwrite=True to replace)")
    _BACKENDS[backend.name] = backend
    return backend


def get_backend(name: str) -> StreamBackend:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise KeyError(
            f"unknown backend {name!r}; registered: {list_backends()}"
        ) from None


def list_backends(kind: str | None = None) -> list[str]:
    """Sorted names of registered backends, optionally filtered by kind."""
    return sorted(n for n, b in _BACKENDS.items()
                  if kind is None or b.kind == kind)


register_backend(SyncHostBackend())
register_backend(PipelinedHostBackend())
register_backend(ThreadedHostBackend())

__all__ = [
    "ExecutionContext", "StreamBackend", "split_arrays", "to_device",
    "dispatch_plan", "slice_rows", "new_stream", "release_stream", "WindowedPool",
    "SyncHostBackend", "PipelinedHostBackend", "ThreadedHostBackend",
    "register_backend", "get_backend", "list_backends",
    "REFERENCE_BACKEND",
]
