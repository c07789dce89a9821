"""Time sources for the serving stack.

Every latency-bearing decision in serving — enqueue/decide/dispatch/
retire stamps on telemetry, deadline expiry in the request queue — reads
time through one of these two clocks instead of calling
``time.perf_counter`` directly:

  :class:`SystemClock`   the production source, a thin wrapper over
      ``time.perf_counter`` (monotonic, sub-microsecond on Linux);
  :class:`VirtualClock`  a manually advanced clock for the trace
      harness (:mod:`repro_torch.serving.traces`) and for tests.  A
      million-request trace replays in seconds of real time while the
      latency accounting sees realistic virtual seconds, and timing
      assertions in tests become exact instead of wall-clock-flaky.

Both expose a single method, ``now() -> float`` (seconds, arbitrary
epoch); anything accepting a clock should type against that duck.
"""
from __future__ import annotations

import time


class SystemClock:
    """Real time: ``now()`` is ``time.perf_counter()``."""

    def now(self) -> float:
        return time.perf_counter()


class VirtualClock:
    """Deterministic simulated time, advanced explicitly by its owner.

    ``advance`` moves forward by a delta; ``advance_to`` jumps to an
    absolute timestamp and is monotone (a target in the past is a no-op,
    so interleaved event sources can never run time backwards).
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance a clock by {dt!r}")
        self._now += dt
        return self._now

    def advance_to(self, t: float) -> float:
        self._now = max(self._now, float(t))
        return self._now
