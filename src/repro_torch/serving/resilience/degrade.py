"""Graceful degradation: circuit breaker + documented fallback ladder.

The serving path never has only one way to answer a request — it has a
*ladder* (README "Resilience" for the full table):

====================  =======================================
failing stage         step-down
====================  =======================================
model search          trained registry model -> OverlapHeuristicModel
                      -> cache-nearest-bucket config -> single stream
backend dispatch      host-pipelined/host-threads -> host-sync
persisted JSON        quarantine the corrupt file, rebuild empty
====================  =======================================

The :class:`CircuitBreaker` decides *when* to stop paying for the
primary: after ``k`` consecutive failures for a (tenant, stage) key it
opens (requests go straight to the fallback, no retry storm), and after
``cooldown_s`` it lets exactly one half-open probe through — success
closes it, failure re-opens.  State transitions are exported on the
metrics registry (``serving.breaker.state``: 0=closed, 1=half-open,
2=open) and recorded on ``events`` for recovery-time measurement in the
chaos bench.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
from typing import Optional

from repro_torch.core.autotuner import TuneResult, TuningCache, \
    quarantine_file  # noqa: F401  (re-exported: the resilience-facing name)

CLOSED, HALF_OPEN, OPEN = "closed", "half-open", "open"
_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """``k`` consecutive failures open the breaker for ``cooldown_s``."""

    k: int = 3
    cooldown_s: float = 2.0


class _Breaker:
    __slots__ = ("failures", "state", "opened_at", "probing")

    def __init__(self) -> None:
        self.failures = 0
        self.state = CLOSED
        self.opened_at = 0.0
        self.probing = False


class CircuitBreaker:
    """Per-key (conventionally ``(tenant, stage)``) circuit breaker.

    Thread-safe: the concurrent engine's workers record dispatch
    outcomes from the pool threads while the coordinator asks
    :meth:`allow` for the next request.
    """

    def __init__(self, config: BreakerConfig = BreakerConfig(), *,
                 clock=None, metrics=None):
        self.config = config
        self.clock = clock
        self.metrics = metrics
        self._lock = threading.Lock()
        self._keys: dict[tuple, _Breaker] = {}
        #: (t, key, state) transition log — the chaos bench derives
        #: open->closed recovery times from it
        self.events: list[tuple[float, tuple, str]] = []

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else 0.0

    def _transition(self, key: tuple, b: _Breaker, state: str) -> None:
        b.state = state
        self.events.append((self._now(), key, state))
        if self.metrics is not None:
            tenant, stage = (key if len(key) == 2 else (str(key), ""))
            self.metrics.gauge("serving.breaker.state",
                               tenant=str(tenant), stage=str(stage)
                               ).set(_STATE_CODE[state])
            if state == OPEN:
                self.metrics.counter("serving.breaker.opened",
                                     tenant=str(tenant), stage=str(stage)
                                     ).inc()

    def allow(self, key: tuple) -> bool:
        """May the primary path be attempted for ``key`` right now?"""
        with self._lock:
            b = self._keys.get(key)
            if b is None or b.state == CLOSED:
                return True
            if b.state == OPEN:
                if self._now() - b.opened_at >= self.config.cooldown_s:
                    self._transition(key, b, HALF_OPEN)
                    b.probing = True
                    return True     # this caller is the recovery probe
                return False
            # half-open: exactly one outstanding probe
            if b.probing:
                return False
            b.probing = True
            return True

    def record_success(self, key: tuple) -> None:
        with self._lock:
            b = self._keys.get(key)
            if b is None:
                return
            b.failures = 0
            b.probing = False
            if b.state != CLOSED:
                self._transition(key, b, CLOSED)

    def record_failure(self, key: tuple) -> None:
        with self._lock:
            b = self._keys.setdefault(key, _Breaker())
            b.failures += 1
            b.probing = False
            if b.state == HALF_OPEN or (b.state == CLOSED
                                        and b.failures >= self.config.k):
                b.opened_at = self._now()
                self._transition(key, b, OPEN)

    def state(self, key: tuple) -> str:
        with self._lock:
            b = self._keys.get(key)
            return b.state if b is not None else CLOSED

    def states(self) -> dict[tuple, str]:
        with self._lock:
            return {k: b.state for k, b in self._keys.items()}


# ---------------------------------------------------------------------------
# Cache-nearest-bucket fallback (the bottom rung above single-stream)
# ---------------------------------------------------------------------------


def _split_key(key: str) -> Optional[tuple[str, str, str, str, str]]:
    """Split a :meth:`TuningCache.key` string into
    (namespace, workload, backend, model_tag, signature)."""
    ns = ""
    if key.startswith("tenant:"):
        ns, _, key = key.partition("|")
        ns = ns[len("tenant:"):]
    parts = key.split("|", 3)
    if len(parts) != 4:
        return None
    workload, backend, tag, sig = parts
    return ns, workload, backend, tag, sig


def _lead_rows(sig: str) -> Optional[tuple[int, str]]:
    """(bucketed leading dim of the first chunked buffer, rest-of-sig)
    — the rest must match exactly for two buckets to be comparable."""
    try:
        d = json.loads(sig)
        chunked = d["chunked"]
        rows = int(chunked[0][1][0])
    except (ValueError, KeyError, IndexError, TypeError):
        return None
    skeleton = json.dumps(
        {"chunked": [[name, shape[1:], dt] for name, shape, dt in chunked],
         "shared": d.get("shared", [])}, separators=(",", ":"))
    return rows, skeleton


def nearest_bucket_entry(cache: Optional[TuningCache], key: str,
                         n_rows: int) -> Optional[TuneResult]:
    """Borrow the tuned config of the *nearest shape bucket* when the
    model search itself is down: same (tenant, workload, backend,
    model_tag) and identical inner dims/dtypes/shared buffers, minimal
    ``|log2(rows_a / rows_b)|`` distance, and still splittable for this
    batch.  Returns None when no comparable bucket exists."""
    if cache is None:
        return None
    want = _split_key(key)
    if want is None:
        return None
    want_rows = _lead_rows(want[4])
    if want_rows is None:
        return None
    best: Optional[TuneResult] = None
    best_d = math.inf
    for other in cache.keys():
        if other == key:
            continue
        got = _split_key(other)
        if got is None or got[:4] != want[:4]:
            continue
        got_rows = _lead_rows(got[4])
        if got_rows is None or got_rows[1] != want_rows[1]:
            continue
        entry = cache.peek(other)
        if entry is None or entry.config.partitions * entry.config.tasks \
                > n_rows:
            continue
        d = abs(math.log2(max(got_rows[0], 1) / max(want_rows[0], 1)))
        if d < best_d:
            best, best_d = entry, d
    return best


# ---------------------------------------------------------------------------
# Crash-safe persistence helpers
# ---------------------------------------------------------------------------


def atomic_write_json(path, payload, *, indent: Optional[int] = 0) -> str:
    """tmp + flush + fsync + rename: a crash mid-write leaves the old
    file intact, never a half-written JSON document."""
    path = str(path)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=indent)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path
