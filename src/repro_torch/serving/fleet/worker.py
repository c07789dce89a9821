"""Fleet worker process: one :class:`ConcurrentScheduler` per process.

Each worker serves on ``WorkerConfig.device`` (the card unless
``device="cpu"``): on the card every worker process holds its own CUDA
context on the one device, and its engine issues every request on its
own pooled streams as single-process serving does.  A worker asked for
``"cuda"`` where there is none fails its ``ready`` handshake with the
error, so the router raises instead of serving on the CPU.

``worker_main`` is the spawn target the router launches N of.  Each
worker builds its own serving stack — model, tuning cache, telemetry
log, metrics registry, drift detector — so nothing is shared across
processes except two channels: ``task_q`` (router → worker, an mp queue)
carries serve batches and control messages, and a per-worker result
:class:`~multiprocessing.connection.Connection` (worker → router, the
send end of a one-way pipe) carries result frames and the lifecycle
handshakes.  A dedicated result pipe per worker matters for crash
handling: a SIGKILL mid-``send`` can truncate a frame mid-byte-stream,
and with per-worker pipes the corruption dies with the worker — the
router holds only the read end (it closes its copy of the write end at
spawn), so a dead worker's truncated frame surfaces as a clean
``EOFError`` instead of wedging the whole fleet's result channel.

The message vocabulary lives in :mod:`repro_torch.serving.fleet.wire`.  The
return path is *batched*: every engine run's results fold into framed
``("results", ...)`` messages — the worker-side mirror of
``_drain_serve``'s request folding — instead of one pickled payload per
request, with the engine-run boundary as the time window and
``frame_max`` as the size window.  Result receipt doubles as the
delivery ack, so acks ride the same frame.  ``wire="legacy"`` (or
``REPRO_FLEET_WIRE=legacy``) restores the per-request payload-dict
messages.

``token`` is the router-assigned ``trace_id`` — the worker's own queue
preserves it (``RequestQueue.push`` only assigns when unset), so results
map back to router bookkeeping without a shared sequence space.

Workers default to a :class:`ResiliencePolicy`: a bad request fails
*individually* (terminal ``failed`` result) instead of taking the
process down.  Anything that still escapes — a scheduler bug, an OOM —
exits the process nonzero after a best-effort ``fatal`` message, and
the router's death handler requeues the un-acked work on a respawn:
crash recovery composes out of per-request resilience inside the
process and whole-process replacement outside it.
"""
from __future__ import annotations

import dataclasses
import os
import queue as queue_mod
import time
from typing import Optional

from repro_torch.serving.fleet.wire import (make_results_frame,
                                            resolve_wire_mode,
                                            split_frames)


@dataclasses.dataclass
class WorkerConfig:
    """Per-process serving configuration; must stay picklable (it is
    shipped to the spawn child as a process argument)."""

    worker_id: int = 0
    backend: str = "host-sync"
    #: in-flight window of the per-worker ConcurrentScheduler
    window: int = 2
    #: engine thread-pool size (default: window)
    workers: Optional[int] = None
    #: model spec — "heuristic", an artifact id, or a registry path.
    #: Pass a *pinned* artifact id rather than "latest": workers resolve
    #: with ``bootstrap=False`` so N processes never race to train
    model: str = "heuristic"
    model_dir: Optional[str] = None
    drift_threshold: float = 4.0
    #: per-worker tuning-cache JSON path (None = in-memory only); the
    #: router derives distinct paths per slot so namespaces never collide
    cache_path: Optional[str] = None
    #: per-worker telemetry JSONL path (None = in-memory; the router
    #: aggregates the merged fleet stream either way)
    telemetry_path: Optional[str] = None
    #: arm ResiliencePolicy: bad requests fail individually instead of
    #: killing the process
    resilience: bool = True
    #: load-aware drift capacity.  Fleet workers share one host, so a
    #: per-process thread-scaling probe would both slow startup and
    #: measure its neighbors; 1.0 disables within-worker load
    #: normalization (None = probe, as single-process serving does)
    capacity: Optional[float] = 1.0
    keep_outputs: bool = False
    #: result wire mode: "auto" (``$REPRO_FLEET_WIRE`` or v2), "v2"
    #: (framed positional rows), "legacy" (per-request payload dicts)
    wire: str = "auto"
    #: size window of result-frame coalescing: one engine run's results
    #: split into frames of at most this many items
    frame_max: int = 32
    #: torch device the worker serves on (a string, so the config stays
    #: picklable); "cuda" gives every worker its own CUDA context
    device: str = "cuda"
    #: torch intra-op threads of the worker (``torch.set_num_threads``,
    #: applied before the scheduler is built).  N workers share one host,
    #: and torch's default pool takes every core in each of them; the
    #: router fills None with ``max(1, os.cpu_count() // N)``.  None in a
    #: worker started without a router leaves torch's default
    intra_op_threads: Optional[int] = None

    @property
    def label(self) -> str:
        return f"w{self.worker_id}"


def _build_scheduler(cfg: WorkerConfig):
    """The worker's private serving stack on ``cfg.device``.  Imports
    live here, not at module top: the spawn child pays them once, and the
    router process can import this module's dataclass without dragging
    in the serving stack."""
    from repro_torch.core.autotuner import TuningCache
    from repro_torch.launch.serve import resolve_serving_model
    from repro_torch.serving import (ConcurrentScheduler, DriftDetector,
                                     MetricsRegistry, ResiliencePolicy,
                                     TelemetryLog)

    model, info = resolve_serving_model(
        cfg.model, cfg.model_dir, bootstrap=False, verbose=False,
        device=cfg.device)
    sched = ConcurrentScheduler(
        model,
        device=cfg.device,
        window=cfg.window,
        workers=cfg.workers,
        capacity=cfg.capacity,
        backend=cfg.backend,
        policy="fifo",                 # admission ordering is the router's
        cache=TuningCache(cfg.cache_path),
        telemetry=TelemetryLog(cfg.telemetry_path),
        drift=DriftDetector(threshold=cfg.drift_threshold,
                            load_discount=0.5),
        model_tag=info["artifact_id"],
        keep_outputs=cfg.keep_outputs,
        metrics=MetricsRegistry(),
        resilience=ResiliencePolicy() if cfg.resilience else None)
    return sched, info["artifact_id"]


def _light_result(r, label: str) -> dict:
    """Strip a RequestResult for the LEGACY wire: the request's numpy
    payload stays in the worker (the router kept its own copy for
    requeue), only the decision/outcome/telemetry crosses back.  Wire v2
    sends just the sample row instead — see :func:`_send_results`."""
    sample = r.sample
    sample.worker = label
    return {
        "status": r.status,
        "error": r.error,
        "workload": r.request.workload,
        "tenant": r.request.tenant,
        "config": ([r.config.partitions, r.config.tasks]
                   if r.config is not None else None),
        "measured_s": r.measured_s,
        "predicted_s": r.predicted_s,
        "cache_hit": r.cache_hit,
        "refined": r.refined,
        "sample": sample.to_json(),
    }


def _drain_serve(task_q, batch: list):
    """Greedily fold queued-up serve messages into one batch so the
    engine sees a full window instead of chunk-sized trickles; the first
    non-serve message ends the drain and is returned for handling."""
    while True:
        try:
            msg = task_q.get_nowait()
        except queue_mod.Empty:
            return batch, None
        if msg[0] == "serve":
            batch.extend(msg[1])
        else:
            return batch, msg


def _send_results(conn, label: str, results, busy_s: float,
                  wire: str, frame_max: int) -> None:
    """Ship one engine run's results back to the router.

    Wire v2 folds them into framed ``("results", ...)`` messages of
    ``(token, sample_row)`` items — the batched, slim return path — with
    the run's engine wall time spread across frames pro rata (the router
    sums busy time per worker, so the attribution split is lossless).
    Legacy mode sends one ``("result", ...)`` payload dict per request.
    """
    if wire == "legacy":
        for r in results:
            # token == the router-assigned trace_id, preserved by push()
            conn.send(("result", label, r.request.trace_id,
                       _light_result(r, label)))
        return
    n = max(1, len(results))
    for chunk in split_frames(results, frame_max):
        items = []
        for r in chunk:
            sample = r.sample
            sample.worker = label
            items.append((r.request.trace_id, sample.to_row()))
        conn.send(make_results_frame(
            label, busy_s * (len(chunk) / n), items))


def _serve_batch(sched, cfg: WorkerConfig, batch, conn, wire: str) -> None:
    for _token, req in batch:
        sched.submit(req)
    t0 = time.perf_counter()
    results = sched.run()
    busy = time.perf_counter() - t0
    _send_results(conn, cfg.label, results, busy, wire, cfg.frame_max)


def _refresh(sched, cfg: WorkerConfig, spec: str):
    from repro_torch.launch.serve import resolve_serving_model
    model, info = resolve_serving_model(
        spec, cfg.model_dir, bootstrap=False, verbose=False,
        device=cfg.device)
    sched.swap_model(model, model_tag=info["artifact_id"])
    return info["artifact_id"]


def worker_main(cfg: WorkerConfig, task_q, conn) -> None:
    """Spawn-target serving loop (must live in an importable module —
    spawn re-imports the target by qualified name, so a closure or
    ``__main__`` function would break under pytest and ``-m`` entry
    points).  ``conn`` is the send end of this worker's result pipe."""
    import torch

    label = cfg.label
    wire = resolve_wire_mode(cfg.wire)
    try:
        if cfg.intra_op_threads is not None:
            torch.set_num_threads(cfg.intra_op_threads)
        sched, model_tag = _build_scheduler(cfg)
    except BaseException as e:  # noqa: BLE001 — report, then die loudly
        conn.send(("fatal", label, f"{type(e).__name__}: {e}"))
        raise SystemExit(1)
    conn.send(("ready", label, os.getpid(), model_tag, torch.get_num_threads()))

    try:
        pending_ctrl = None
        while True:
            msg = pending_ctrl if pending_ctrl is not None else task_q.get()
            pending_ctrl = None
            kind = msg[0]
            if kind == "stop":
                break
            if kind == "serve":
                batch, pending_ctrl = _drain_serve(task_q, list(msg[1]))
                _serve_batch(sched, cfg, batch, conn, wire)
            elif kind == "refresh":
                try:
                    tag = _refresh(sched, cfg, msg[1])
                    conn.send(("refreshed", label, tag, None))
                except Exception as e:  # noqa: BLE001 — keep serving on
                    # a bad publish; the old model stays live
                    conn.send(("refreshed", label, None,
                               f"{type(e).__name__}: {e}"))
            elif kind == "ping":
                conn.send(("pong", label))
    except BaseException as e:  # noqa: BLE001 — anything past the
        # per-request resilience barrier is process-fatal: report, exit
        # nonzero, let the router respawn and requeue un-acked work
        conn.send(("fatal", label, f"{type(e).__name__}: {e}"))
        raise SystemExit(1)

    # graceful goodbye: ship the per-worker aggregates for the fleet
    # merge, then tear down (telemetry close fsyncs the JSONL)
    conn.send(("bye", label, {
        "summary": sched.telemetry.summary(),
        "metrics": sched.metrics.snapshot(),
        "stats": dict(sched.stats),
    }))
    if cfg.cache_path:
        sched.cache.save()
    sched.close()
    conn.close()
