"""Drift detection and online refinement — the offline-learn / online-
correct loop the paper leaves open.

The paper's model is trained offline and applied once per program at
runtime (§3.3).  Under sustained serving the prediction can drift away
from reality: the data distribution shifts within a shape bucket, the
machine's load changes, or the model was simply wrong for this workload.
:class:`DriftDetector` watches the rolling relative prediction error per
workload bucket; past a threshold, :class:`Refiner` closes the loop:

  1. evict the stale cache entry,
  2. re-profile a *small* candidate set — the model's current top-k, the
     incumbent config, and the single-stream baseline (measured ground
     truth, a handful of runs, not the full grid),
  3. write back a cache entry whose "predicted" speedup is the measured
     one (``source="refined"``), so subsequent hits predict accurately,
  4. feed the measured (features ++ config, speedup) rows to the model's
     incremental ``refit`` hook, nudging future *cold* searches too.

Memeti & Pllana (arXiv:2106.01441) show exactly this measured-feedback
re-planning beating static offline decisions on heterogeneous systems.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.autotuner import TuneResult, TuningCache
from repro_torch.core.modeling.base import assemble_rows
from repro_torch.core.modeling.search import search_best
from repro_torch.core.stream_config import SINGLE_STREAM, StreamConfig, \
    default_space
from repro_torch.core.streams import StreamedRunner, profile_grid_interleaved


class DriftDetector:
    """Rolling prediction-error window per workload bucket.

    ``observe(key, rel_error, load_factor=...)`` pushes one sample and
    returns True when the bucket's mean error over the window crosses
    ``threshold`` (with at least ``min_samples`` observed).  After a
    refinement the caller ``reset``s the bucket: the window clears and a
    ``cooldown`` of subsequent observations is ignored entirely, so one
    drift event yields one refinement, not a burst.

    Cooldown observations are NOT accumulated into the window.  They
    cover the refreshed entry's settling period — recompile stutter,
    host-noise spikes on the first warm hits — and letting them pile up
    meant the first post-cooldown observation was judged against a mean
    of exactly the samples the cooldown existed to ignore, double-firing
    the drift→refine loop under timing noise.  A re-trigger requires
    ``min_samples`` fresh post-cooldown observations over threshold.

    ``load_factor`` is the contention stamp the scheduler already
    records per sample (window occupancy / host parallel capacity).
    ``measured_s`` is normalized by it *before* the error is computed,
    but the normalization is a model — the residual error it leaves
    grows with contention.  ``load_discount`` (default 0: off) divides
    each sample's contribution by ``1 + load_discount*(load_factor-1)``,
    so a window full of occupancy-8 samples needs proportionally more
    evidence to fire than an idle one, and contention at deep windows
    cannot masquerade as model drift over a 10^5-request trace.  Genuine
    drift still fires: a real 3x misprediction dwarfs the discount.
    """

    def __init__(self, *, window: int = 8, threshold: float = 1.0,
                 min_samples: int = 2, cooldown: int = 2,
                 load_discount: float = 0.0):
        assert window >= min_samples >= 1
        self.window = window
        self.threshold = threshold
        self.min_samples = min_samples
        self.cooldown = cooldown
        self.load_discount = load_discount
        self._errors: dict[str, collections.deque] = {}
        self._cooldowns: dict[str, int] = {}
        self.triggers = 0
        #: observations swallowed by a post-refinement cooldown — the
        #: "suppressions" half of the drift fires-vs-suppressions metric
        self.suppressed = 0

    def observe(self, key: str, rel_error: Optional[float],
                load_factor: float = 1.0) -> bool:
        if rel_error is None:
            return False
        if self._cooldowns.get(key, 0) > 0:
            # settling period after a refinement: ignored AND not
            # accumulated — see the class docstring
            self._cooldowns[key] -= 1
            self.suppressed += 1
            return False
        discount = 1.0 + self.load_discount * max(0.0, load_factor - 1.0)
        dq = self._errors.setdefault(
            key, collections.deque(maxlen=self.window))
        dq.append(float(rel_error) / discount)
        if len(dq) >= self.min_samples and \
                sum(dq) / len(dq) > self.threshold:
            self.triggers += 1
            return True
        return False

    def rolling_error(self, key: str) -> Optional[float]:
        dq = self._errors.get(key)
        return (sum(dq) / len(dq)) if dq else None

    def reset(self, key: str) -> None:
        self._errors.pop(key, None)
        self._cooldowns[key] = self.cooldown

    def clone(self) -> "DriftDetector":
        """A fresh detector with the same thresholds and EMPTY windows —
        the per-tenant template instantiation: every tenant judges drift
        by the same rules but over only its own samples."""
        return DriftDetector(window=self.window, threshold=self.threshold,
                             min_samples=self.min_samples,
                             cooldown=self.cooldown,
                             load_discount=self.load_discount)


def contention_factor(inflight: int, capacity: Optional[float],
                      workers: Optional[int] = None) -> float:
    """Expected wall-time inflation of one request that shared the host
    with ``inflight - 1`` others (itself included in ``inflight``).

    If aggregate kernel throughput scales by ``capacity`` when issued
    from many threads (the :func:`repro_torch.core.streams.parallel_capacity`
    ceiling), then ``k`` concurrently executing requests each run
    ``k / capacity`` slower than they would alone.  ``workers`` caps
    ``k`` — only that many execute at once regardless of window
    occupancy.  Clamped at 1.0: overlap never *deflates* a measurement,
    and the serial scheduler (``inflight=1``) is always factor 1.

    This is the load-aware drift signal's core arithmetic: dividing
    ``measured_s`` by this factor before computing relative prediction
    error stops concurrent-mode contention from masquerading as model
    drift.

    ``workers=0`` is a degenerate pool — nothing can overlap, so the
    factor is exactly 1.0.  It used to silently mean "uncapped" (a
    falsy-check bug): a caller probing an empty pool got its window
    occupancy treated as concurrency and every measurement deflated.
    ``workers=None`` (unknown pool size) remains uncapped on purpose."""
    if capacity is None:
        return 1.0
    if workers is not None and workers < 0:
        raise ValueError(f"workers must be >= 0, got {workers}")
    if workers == 0:
        return 1.0
    eff = min(inflight, workers) if workers is not None else inflight
    return max(1.0, eff / max(capacity, 1e-9))


@dataclasses.dataclass
class RefinementResult:
    key: str
    old_config: Optional[StreamConfig]
    new_config: StreamConfig
    measured: dict                 # StreamConfig -> seconds
    t_single_s: float
    speedup: float                 # measured, of new_config
    refit_loss: Optional[float]    # None when the model has no refit hook
    seconds: float                 # wall time of the whole refinement


class Refiner:
    """Re-profiles a small candidate set and refreshes cache + model."""

    def __init__(self, model, cache: TuningCache, *,
                 candidates: Optional[Sequence[StreamConfig]] = None,
                 top_k: int = 3, reps: int = 1,
                 refit_epochs: int = 150, refit_lr: float = 3e-3,
                 clock=None):
        self.model = model
        self.cache = cache
        self.candidates = list(candidates or default_space())
        self.top_k = top_k
        self.reps = reps
        self.refit_epochs = refit_epochs
        self.refit_lr = refit_lr
        self.history: list[RefinementResult] = []
        # the owning scheduler binds its own clock here (one time source
        # per scheduler — clock.py); an unbound standalone refiner falls
        # back to perf_counter
        self.clock = clock

    def _now(self) -> float:
        return (self.clock.now() if self.clock is not None
                else time.perf_counter())

    def refine(self, runner: StreamedRunner, key: str,
               prog_feats: Optional[np.ndarray],
               current: Optional[TuneResult], *,
               model=None) -> RefinementResult:
        """Re-profile and refresh ``key``.  ``model`` overrides the
        refiner's default for both the top-k search and the refit — the
        tenancy hook: an isolating scheduler passes the drifting
        tenant's own (forked) model so measured feedback never refits a
        model other tenants serve from."""
        model = model if model is not None else self.model
        t0 = self._now()
        if prog_feats is None:
            # hit on a persisted cache from a previous process: the raw
            # features were never extracted here, so re-profile them
            from repro_torch.core.features import extract_features
            prog_feats = extract_features(runner, profile_reps=1).values

        n_rows = next(iter(runner.chunked.values())).shape[0]
        # empty would make search_best fall back to the full default grid
        cands = [c for c in self.candidates
                 if c.partitions * c.tasks <= n_rows] or [SINGLE_STREAM]
        k = min(self.top_k, len(cands))
        picks, _, _ = search_best(model, prog_feats, cands, top_k=k)
        if k == 1:
            picks = [picks]
        probe = list(dict.fromkeys(
            [SINGLE_STREAM]
            + [*picks]
            + ([current.config] if current is not None else [])))

        self.cache.invalidate(key)
        # interleaved sweeps, not back-to-back reps — the shared
        # spike-resistant protocol (see streams.profile_grid_interleaved)
        measured = profile_grid_interleaved(runner, probe,
                                            sweeps=self.reps)
        t_single = measured[SINGLE_STREAM]
        best = min(measured, key=measured.get)
        speedup = t_single / max(measured[best], 1e-12)

        self.cache.put(key, TuneResult(
            best, float(speedup), 0.0, 0.0,
            backend=runner.backend.name, source="refined"))

        refit_loss = None
        if hasattr(model, "refit"):
            rows = assemble_rows(prog_feats, list(measured))
            ys = np.array([t_single / max(measured[c], 1e-12)
                           for c in measured])
            refit_loss = model.refit(rows, ys,
                                     epochs=self.refit_epochs,
                                     lr=self.refit_lr)

        result = RefinementResult(
            key=key,
            old_config=current.config if current is not None else None,
            new_config=best, measured=measured, t_single_s=t_single,
            speedup=float(speedup), refit_loss=refit_loss,
            seconds=self._now() - t0)
        self.history.append(result)
        return result
