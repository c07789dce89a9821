"""Fleet serving: a tenant-sharding router over N worker processes.

The single-process schedulers (:mod:`repro_torch.serving.scheduler`,
:mod:`repro_torch.serving.engine`) run every request's host work —
decisions, pinning, readback — under one interpreter's GIL; the fleet
splits the same serving pipeline across processes:

  submit → router admission queue (fifo/priority/fair/deadline)
         → tenant → worker shard (stable CRC32)
         → worker process: own ConcurrentScheduler + tuning cache +
           telemetry + metrics + drift/refinement, on its own device
           context (one CUDA context per worker on the card)
         → results stream back; worker-labeled samples merge into one
           fleet telemetry log / metrics snapshot

The data plane is event-driven and framed (see ``wire.py``): the
router parks in ``multiprocessing.connection.wait`` over result pipes
and process sentinels, and workers ship batched ``("results", ...)``
frames of slim positional rows (``REPRO_FLEET_WIRE=legacy`` restores
the per-request payload-dict wire).  Worker death is handled by
respawn-and-requeue (see ``router.py``); model versions distribute
through the shared ``ModelRegistry`` —
``FleetRouter.refresh_model("latest")`` makes every worker reload and
hot-swap the pinned artifact.  Entry point:
``launch/serve.py --worker-procs N``.
"""
from repro_torch.serving.fleet.aggregate import (fleet_summary,
                                                 merge_metrics,
                                                 merge_samples,
                                                 payload_from_sample)
from repro_torch.serving.fleet.router import FleetRouter, shard_for
from repro_torch.serving.fleet.wire import (WIRE_MODES, WIRE_VERSION,
                                            WireProtocolError,
                                            resolve_wire_mode)
from repro_torch.serving.fleet.worker import WorkerConfig, worker_main

__all__ = [
    "FleetRouter", "WorkerConfig", "worker_main", "shard_for",
    "merge_samples", "merge_metrics", "fleet_summary",
    "payload_from_sample", "WIRE_VERSION", "WIRE_MODES",
    "WireProtocolError", "resolve_wire_mode",
]
