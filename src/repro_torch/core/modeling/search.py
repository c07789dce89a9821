"""Runtime configuration search (paper §3.3): rank every candidate stream
configuration with the performance model and take the top one.  One vmapped
MLP forward over the whole grid — microseconds of overhead, which is the
point: exhaustive *profiling* is hours, exhaustive *prediction* is free.

Also provides the simulated-annealing searcher the paper uses to motivate
model-based search (§2.3: SA needed 310k iterations to reach 84%).
"""
from __future__ import annotations

import math
import time
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.modeling.perf_model import PerformanceModel
from repro_torch.core.stream_config import StreamConfig, default_space


def search_best(
    model: PerformanceModel,
    prog_feats: np.ndarray,
    candidates: Optional[Sequence[StreamConfig]] = None,
    *,
    top_k: int = 1,
):
    """Returns (best_config(s), predicted speedups, search seconds)."""
    candidates = list(candidates or default_space())
    t0 = time.perf_counter()
    preds = model.predict_configs(prog_feats, candidates)
    dt = time.perf_counter() - t0
    # stable sort: prediction ties resolve to the earlier (cheaper)
    # candidate, so repeated searches — and tuning-cache entries written
    # from them — are deterministic for a fixed model.
    order = np.argsort(-np.asarray(preds), kind="stable")
    picks = [candidates[i] for i in order[:top_k]]
    if top_k == 1:
        return picks[0], preds, dt
    return picks, preds, dt


def search_best_batch(
    model: PerformanceModel,
    feats_matrix: np.ndarray,
    candidates: Optional[Sequence[StreamConfig]] = None,
    *,
    feasible: Optional[np.ndarray] = None,
):
    """Rank the candidate grid for ``B`` programs with ONE batched
    ``predict_configs`` call over a ``(B, F)`` feature matrix.

    ``feasible`` is an optional ``(B, C)`` bool mask; a row's infeasible
    candidates (e.g. unsplittable for that request's row count) are
    scored ``-inf``, which — with the same stable descending sort as
    :func:`search_best` — makes each row's pick identical to a serial
    ``search_best`` over that row's filtered candidate list.

    Returns ``(picks, best_preds, preds, seconds)``: per-program best
    config, its predicted speedup, the full ``(B, C)`` prediction
    matrix, and the search wall time.
    """
    candidates = list(candidates or default_space())
    F = np.atleast_2d(np.asarray(feats_matrix, dtype=np.float64))
    t0 = time.perf_counter()
    preds = np.atleast_2d(np.asarray(model.predict_configs(F, candidates)))
    dt = time.perf_counter() - t0
    scored = preds if feasible is None else np.where(feasible, preds,
                                                     -np.inf)
    order = np.argsort(-scored, axis=1, kind="stable")
    picks = [candidates[order[b, 0]] for b in range(F.shape[0])]
    best_preds = scored[np.arange(F.shape[0]), order[:, 0]]
    return picks, best_preds, preds, dt


def simulated_annealing(
    objective: Callable[[StreamConfig], float],
    *,
    max_partitions: int = 32,
    max_tasks: int = 64,
    iters: int = 100,
    seed: int = 0,
):
    """Minimize measured runtime by SA over the (p, t) lattice.  Each
    ``objective`` call is a real profiled run — this is the expensive
    alternative the paper's model-based search replaces."""
    rng = np.random.default_rng(seed)
    lp = int(math.log2(max_partitions))
    lt = int(math.log2(max_tasks))
    cur = StreamConfig(1, 1)
    cur_cost = objective(cur)
    best, best_cost = cur, cur_cost
    temp = 1.0
    for i in range(iters):
        dp = int(rng.integers(-1, 2))
        dt_ = int(rng.integers(-1, 2))
        p = 2 ** int(np.clip(math.log2(cur.partitions) + dp, 0, lp))
        t = 2 ** int(np.clip(math.log2(cur.tasks) + dt_, 0, lt))
        cand = StreamConfig(p, max(t, 1))
        cost = objective(cand)
        if cost < cur_cost or rng.random() < math.exp(
                -(cost - cur_cost) / max(temp * cur_cost, 1e-12)):
            cur, cur_cost = cand, cost
        if cost < best_cost:
            best, best_cost = cand, cost
        temp *= 0.95
    return best, best_cost
