"""Fault tolerance for the serving path.

Three pieces, threaded through ``AdaptiveScheduler``/
``ConcurrentScheduler`` via the ``faults=`` and ``resilience=``
constructor kwargs (both default off — the legacy path is untouched
when unset):

- :mod:`.faults` — deterministic seeded fault injection at named
  serving sites, so chaos results replay and gate in CI.
- :mod:`.retry` — deadline-aware capped-exponential-backoff retry
  around cold search and dispatch.
- :mod:`.degrade` — per-(tenant, stage) circuit breaker over the
  documented fallback ladder, plus crash-safe JSON persistence
  (atomic-write-rename, quarantine-and-rebuild).

:class:`ResiliencePolicy` bundles the knobs a scheduler needs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.serving.resilience.degrade import (            # noqa: F401
    BreakerConfig, CircuitBreaker, atomic_write_json,
    nearest_bucket_entry, quarantine_file,
)
from repro_torch.serving.resilience.faults import (             # noqa: F401
    NULL_FAULTS, SITES, FaultPlan, FaultSpec, InjectedFault,
    corrupt_json_file,
)
from repro_torch.serving.resilience.retry import (              # noqa: F401
    RetryPolicy, call_with_retry,
)


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """Everything the schedulers need to survive a failing stage.

    ``watchdog_s`` arms the concurrent engine's execution watchdog: a
    dispatch running past it is abandoned (the worker finishes in the
    background and its runner is reclaimed on completion) and the
    request is requeued on a fresh runner at most ``requeue_limit``
    times before failing individually with ``status="timeout"``.
    """

    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    breaker: BreakerConfig = dataclasses.field(
        default_factory=BreakerConfig)
    watchdog_s: Optional[float] = None
    requeue_limit: int = 1
    fallback_backend: str = "host-sync"
    seed: int = 0


__all__ = [
    "BreakerConfig", "CircuitBreaker", "FaultPlan", "FaultSpec",
    "InjectedFault", "NULL_FAULTS", "ResiliencePolicy", "RetryPolicy",
    "SITES", "atomic_write_json", "call_with_retry", "corrupt_json_file",
    "nearest_bucket_entry", "quarantine_file",
]
