"""Deadline-aware retry with capped exponential backoff.

Wrapped around the two serving stages that are worth repeating —
cold-path model search and backend dispatch.  The budget is the
request's SLO deadline (``WorkloadRequest.deadline_s``): a retry
whose backoff sleep would land past the deadline is pointless work that
only *widens* the violation, so the loop re-raises the original error
instead of sleeping through the budget.

Jitter is drawn from the caller's RNG (seeded per request), keeping
replays deterministic while still de-correlating concurrent retries —
the same reason the trace harness indexes service-model noise by
arrival.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, TypeVar

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff: ``base * multiplier**attempt``,
    clipped at ``cap_s``, stretched by up to ``jitter`` fraction."""

    attempts: int = 3
    base_s: float = 0.005
    multiplier: float = 2.0
    cap_s: float = 0.1
    jitter: float = 0.5

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        raw = min(self.base_s * self.multiplier ** attempt, self.cap_s)
        return raw * (1.0 + self.jitter * rng.random())


def call_with_retry(fn: Callable[[], T], *,
                    policy: RetryPolicy,
                    rng: random.Random,
                    clock=None,
                    deadline_s: Optional[float] = None,
                    sleep: Callable[[float], None] = time.sleep,
                    retry_on: tuple = (Exception,),
                    on_retry: Optional[Callable[[int, BaseException], None]] = None,
                    on_recover: Optional[Callable[[int], None]] = None) -> T:
    """Run ``fn`` up to ``policy.attempts`` times.

    The retry budget is bounded by ``deadline_s`` (on ``clock``'s
    timeline): if the next backoff sleep would end past the deadline,
    the last error is re-raised immediately — failing fast inside the
    SLO beats succeeding after it.  ``on_recover(n_failures)`` fires
    when a success follows at least one failure (the scheduler counts
    it on ``serving.faults.recovered``).
    """
    failures = 0
    while True:
        try:
            result = fn()
        except retry_on as e:
            failures += 1
            if failures >= policy.attempts:
                raise
            backoff = policy.backoff_s(failures - 1, rng)
            if deadline_s is not None and clock is not None \
                    and clock.now() + backoff >= deadline_s:
                raise  # no budget left: retrying can only widen the miss
            if on_retry is not None:
                on_retry(failures, e)
            sleep(backoff)
        else:
            if failures and on_recover is not None:
                on_recover(failures)
            return result
