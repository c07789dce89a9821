"""Deterministic fault injection for the serving path.

A :class:`FaultPlan` is a committed, seeded schedule of failures that
the schedulers (and the discrete-event replay in ``serving.traces``)
evaluate at named *sites* on the hot path::

    decide, tune.cold, dispatch, retire, refine, registry.load

Each :class:`FaultSpec` matches site invocations either by explicit
0-based invocation index (``at=(3, 4, 5)``) or by period
(``every=50`` fires on the 50th, 100th, ... invocation), optionally
capped by ``times``.  Two kinds exist:

``error``
    :meth:`FaultPlan.fire` raises :class:`InjectedFault` — the layer
    under test must contain it (retry, degrade, or fail the request
    individually; never the scheduler).
``latency``
    :meth:`FaultPlan.fire` stalls for ``delay_s`` (a hung backend /
    co-tenant interference spike).  Under the virtual-clock harness the
    plan is bound with ``sleep=None`` and ``fire`` *returns* the delay
    so the simulator can charge it to the service time instead.

Matching is pure counter arithmetic on the per-site invocation count —
no wall clock, no RNG draw unless ``probability`` is set (and then from
the plan's own seeded RNG) — so a (plan, workload) pair replays
identically, which is what makes chaos results gateable in CI.

Fired faults are counted on the metrics registry as
``serving.faults.injected{site=..., kind=...}``.
"""
from __future__ import annotations

import dataclasses
import json
import random
import threading
import time
from typing import Callable, Optional, Sequence

#: the stage names schedulers evaluate; kept in one place so typos in a
#: committed schedule are caught at load time, not silently ignored
SITES = ("decide", "tune.cold", "dispatch", "retire", "refine",
         "registry.load")


class InjectedFault(RuntimeError):
    """The exception an ``error``-kind fault raises at its site."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic failure rule for a named site."""

    site: str
    kind: str = "error"                # "error" | "latency"
    at: tuple[int, ...] = ()           # explicit 0-based invocation idxs
    every: int = 0                     # fire each Nth invocation (1-based)
    times: int = 0                     # max fires (0 = unlimited)
    probability: float = 0.0           # seeded coin-flip gate (0 = off)
    delay_s: float = 0.05              # latency-kind stall
    message: str = ""

    def __post_init__(self) -> None:
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; valid: {SITES}")
        if self.kind not in ("error", "latency"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if not self.at and not self.every and not self.probability:
            raise ValueError(
                "FaultSpec needs at=, every= or probability= to match")

    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        out["at"] = list(self.at)
        return {k: v for k, v in out.items()
                if v not in ((), [], 0, 0.0, "") or k in ("site", "kind")}

    @staticmethod
    def from_json(payload: dict) -> "FaultSpec":
        payload = dict(payload)
        payload["at"] = tuple(payload.get("at", ()))
        return FaultSpec(**payload)


class FaultPlan:
    """A seeded, replayable schedule of :class:`FaultSpec` rules.

    One plan instance carries mutable per-site invocation counters, so
    use a fresh plan (or :meth:`reset`) per run.  ``bind`` attaches the
    run's metrics registry and, for virtual-time harnesses, disables
    real sleeping (``sleep=None``).
    """

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0):
        self.specs = tuple(specs)
        self.seed = seed
        self._rng = random.Random(seed)
        self._counts: dict[str, int] = {}
        self._fires: dict[int, int] = {}   # spec index -> fire count
        self._lock = threading.Lock()
        self._sleep: Optional[Callable[[float], None]] = time.sleep
        self._m_injected = None
        self.enabled = bool(self.specs)

    def reset(self) -> None:
        self._rng = random.Random(self.seed)
        self._counts.clear()
        self._fires.clear()

    def bind(self, *, metrics=None,
             sleep: Optional[Callable[[float], None]] = time.sleep) -> "FaultPlan":
        """Attach a metrics registry; ``sleep=None`` makes latency
        faults *return* their delay instead of stalling (virtual time).
        """
        self._m_injected = metrics
        self._sleep = sleep
        return self

    def _matches(self, spec: FaultSpec, idx: int, fired: int) -> bool:
        if spec.times and fired >= spec.times:
            return False
        if spec.at and idx in spec.at:
            return True
        if spec.every and (idx + 1) % spec.every == 0:
            return True
        if spec.probability and self._rng.random() < spec.probability:
            return True
        return False

    def fire(self, site: str) -> float:
        """Evaluate one invocation of ``site``.

        Raises :class:`InjectedFault` for a matched ``error`` spec;
        stalls (or returns) the summed delay for matched ``latency``
        specs; returns 0.0 when nothing matches.
        """
        if not self.enabled:
            return 0.0
        with self._lock:
            idx = self._counts.get(site, 0)
            self._counts[site] = idx + 1
            error: Optional[FaultSpec] = None
            delay = 0.0
            for i, spec in enumerate(self.specs):
                if spec.site != site:
                    continue
                if not self._matches(spec, idx, self._fires.get(i, 0)):
                    continue
                self._fires[i] = self._fires.get(i, 0) + 1
                if self._m_injected is not None:
                    self._m_injected.counter(
                        "serving.faults.injected",
                        site=site, kind=spec.kind).inc()
                if spec.kind == "error" and error is None:
                    error = spec
                elif spec.kind == "latency":
                    delay += spec.delay_s
        if delay > 0.0 and self._sleep is not None:
            self._sleep(delay)
        if error is not None:
            raise InjectedFault(
                error.message
                or f"injected fault at {site} (invocation {idx})")
        return delay

    def invocations(self, site: str) -> int:
        with self._lock:
            return self._counts.get(site, 0)

    @property
    def fired(self) -> int:
        """Total faults fired so far (all specs)."""
        with self._lock:
            return sum(self._fires.values())

    def to_json(self) -> dict:
        return {"seed": self.seed,
                "specs": [s.to_json() for s in self.specs]}

    @staticmethod
    def from_json(payload: dict) -> "FaultPlan":
        return FaultPlan(
            [FaultSpec.from_json(s) for s in payload.get("specs", ())],
            seed=payload.get("seed", 0))

    @staticmethod
    def load(path) -> "FaultPlan":
        with open(path) as f:
            return FaultPlan.from_json(json.load(f))

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")


#: shared no-op plan: ``enabled`` is False so ``fire`` is one attribute
#: check on the hot path when no chaos is configured
NULL_FAULTS = FaultPlan(())


def corrupt_json_file(path, mode: str = "truncate",
                      rng: Optional[random.Random] = None) -> str:
    """Deterministically damage a persisted JSON file in place.

    ``truncate`` cuts the file mid-token, ``garbage`` overwrites a span
    with non-JSON bytes from ``rng``, ``empty`` leaves a zero-byte file
    — the three corruption shapes crash-interrupted writes actually
    produce.
    """
    rng = rng or random.Random(0)
    with open(path, "rb") as f:
        data = f.read()
    if mode == "truncate":
        data = data[: max(1, len(data) // 2)]
    elif mode == "garbage":
        lo = len(data) // 4
        hi = max(lo + 1, len(data) // 2)
        junk = bytes(rng.randrange(0x80, 0xFF) for _ in range(hi - lo))
        data = data[:lo] + junk + data[hi:]
    elif mode == "empty":
        data = b""
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    with open(path, "wb") as f:
        f.write(data)
    return str(path)
