"""Fleet wire protocol: framing, schema versioning, and the shared
event-driven wait primitive.

The router ↔ worker data plane moves plain picklable tuples whose first
element is the message kind:

  router → worker (task queue)
    ("serve", [(token, WorkloadRequest), ...])   run a batch
    ("refresh", spec)                            reload model, swap in
    ("ping",)                                    liveness probe
    ("stop",)                                    graceful shutdown

  worker → router (result connection)
    ("ready", label, pid, model_tag, threads)    startup handshake (threads:
                                                 torch's intra-op threads)
    ("results", label, version, busy_s, [(token, row), ...])
                                                 one *frame* of terminal
                                                 results (wire v2)
    ("result", label, token, payload_dict)       one terminal request
                                                 (legacy wire, opt-in)
    ("refreshed", label, model_tag, error)       refresh ack
    ("pong", label)
    ("bye", label, {"summary", "metrics", "stats"})  shutdown handshake
    ("fatal", label, error)                      dying; router respawns

Wire v2 is the slim return path: instead of pickling one
``{..., "sample": {27-key dict}}`` payload per request, a worker folds
every result of one engine run into a framed ``("results", ...)``
message whose items are ``(token, row)`` pairs — ``row`` is the
positional :data:`repro_torch.serving.telemetry.WIRE_FIELDS` tuple (no
key strings on the wire).  The router rehydrates rows centrally through
:func:`repro_torch.serving.fleet.aggregate.payload_from_sample`.
Result receipt doubles as the delivery ack, so acks ride the same frame.
The frames are the JAX package's, version for version: a row one
package encodes decodes in the other.

Frames carry an explicit schema version so a router and a worker from
different code versions fail loudly (:class:`WireProtocolError`) instead
of mis-zipping fields.  ``REPRO_FLEET_WIRE=legacy`` (or
``WorkerConfig(wire="legacy")``) is the escape hatch back to per-request
``("result", ...)`` payload dicts.

Coalescing: a frame is flushed at every engine-run boundary (the time
window — results are never held while the worker idles) and split at
``frame_max`` items (the size window) so a single oversized message
never monopolizes the pipe.
"""
from __future__ import annotations

import os
from multiprocessing import connection as _mp_connection
from typing import Iterable, List, Sequence, Tuple

#: bump whenever WIRE_FIELDS or the frame layout changes
WIRE_VERSION = 2
WIRE_MODES = ("v2", "legacy")
WIRE_ENV_VAR = "REPRO_FLEET_WIRE"


class WireProtocolError(RuntimeError):
    """A frame's schema version does not match this process's codec —
    a router and a worker are running different code versions.  Fail
    loudly: silently zipping mismatched positional rows would corrupt
    every field after the first drift."""


def resolve_wire_mode(mode: str = "auto") -> str:
    """Resolve a wire-mode spec: explicit ``"v2"``/``"legacy"`` wins,
    ``"auto"`` (or ``None``) falls back to ``$REPRO_FLEET_WIRE`` and
    then to the current protocol."""
    if mode in (None, "", "auto"):
        mode = os.environ.get(WIRE_ENV_VAR, "") or "v2"
    if mode not in WIRE_MODES:
        raise ValueError(f"unknown fleet wire mode {mode!r}; "
                         f"one of {WIRE_MODES + ('auto',)}")
    return mode


def make_results_frame(label: str, busy_s: float,
                       items: Sequence[Tuple[str, tuple]]) -> tuple:
    """One worker → router result frame: ``items`` are ``(token, row)``
    pairs, ``busy_s`` is the share of engine wall time attributed to
    this frame (the router sums it into per-worker compute wall for
    ``ipc_overhead_fraction``)."""
    return ("results", label, WIRE_VERSION, busy_s, list(items))


def parse_results_frame(msg: tuple) -> Tuple[float, List[Tuple[str, tuple]]]:
    """Validate and unpack a ``("results", ...)`` frame; returns
    ``(busy_s, items)``.  Raises :class:`WireProtocolError` on a schema
    version mismatch."""
    _kind, _label, version, busy_s, items = msg
    if version != WIRE_VERSION:
        raise WireProtocolError(
            f"result frame has wire version {version!r}, this router "
            f"speaks {WIRE_VERSION} — router and worker are running "
            f"different code (set {WIRE_ENV_VAR}=legacy to bridge)")
    return busy_s, items


def split_frames(results: Sequence, frame_max: int) -> Iterable[Sequence]:
    """Size-window coalescing: yield ``results`` in runs of at most
    ``frame_max`` (the whole batch when it fits in one frame)."""
    frame_max = max(1, frame_max)
    for i in range(0, len(results), frame_max):
        yield results[i:i + frame_max]


def wait_any(waitables, timeout: float):
    """The shared event-driven wait primitive: block until any of
    ``waitables`` (result :class:`~multiprocessing.connection.Connection`
    handles and/or :attr:`~multiprocessing.Process.sentinel` fds) is
    ready, or ``timeout`` seconds pass.  Returns the ready subset.

    This is what replaced every sleep-poll in ``fleet/``: the router
    parks in ``select``/``poll`` and wakes the instant a worker flushes
    a frame *or* dies (the process sentinel becomes readable on exit),
    instead of rediscovering both on a 5-10 ms timer.
    """
    if not waitables:
        return []
    return _mp_connection.wait(waitables, timeout=max(0.0, timeout))
