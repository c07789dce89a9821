"""Leave-one-program-out evaluation (paper §5.3.1) — the score stamped
into every published artifact and the ``--model-eval`` benchmark's core.

For each held-out program the model is trained on every other program
family, then asked to pick a config for each of the held-out program's
profiled (program, dataset) cells; the pick is scored against the cell's
profiled grid (achieved speedup vs the oracle's best).  Already-trained
estimators — including the zero-training heuristic baseline — are scored
on the same cells with :func:`evaluate_model`.
"""
from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.modeling import dataset as ds
from repro_torch.core.stream_config import StreamConfig


def geomean(xs) -> float:
    xs = np.asarray(list(xs), dtype=np.float64)
    return float(np.exp(np.mean(np.log(np.maximum(xs, 1e-9)))))


def nearest_profiled(sample: "ds.Sample", cfg: StreamConfig) -> StreamConfig:
    """Snap a predicted config to the nearest profiled grid cell (log2
    distance over both axes) so it can be scored against measurements."""
    if cfg.as_tuple() in sample.times:
        return cfg
    cand = min(sample.times, key=lambda pt: (
        abs(np.log2(pt[0]) - np.log2(cfg.partitions))
        + abs(np.log2(pt[1]) - np.log2(cfg.tasks))))
    return StreamConfig(*cand)


def achieved_speedup(sample: "ds.Sample", cfg: StreamConfig) -> float:
    return sample.speedup(nearest_profiled(sample, cfg))


def pick_config(model, sample: "ds.Sample") -> StreamConfig:
    """The model's choice among the sample's profiled grid — scored by
    the same ``search_best`` serving uses, so the CV number measures the
    exact runtime decision procedure (tie-breaks included)."""
    from repro_torch.core.modeling.search import search_best

    cfgs = [StreamConfig(p, t) for (p, t) in sample.times]
    best, _, _ = search_best(model, sample.features, cfgs)
    return best


def evaluate_model(model, samples: Sequence["ds.Sample"]) -> dict:
    """Score an already-trained estimator on profiled cells: geomean
    achieved speedup, oracle speedup, and their ratio."""
    ach = [achieved_speedup(s, pick_config(model, s)) for s in samples]
    orc = [s.oracle_speedup for s in samples]
    return {
        "mean_speedup": geomean(ach),
        "oracle_speedup": geomean(orc),
        "frac_of_oracle": geomean(ach) / geomean(orc),
        "n_cells": len(samples),
    }


def loo_evaluate(samples: Sequence["ds.Sample"], *,
                 model_cls=None,
                 train_kwargs: Optional[dict] = None,
                 verbose: bool = False) -> dict:
    """Leave-one-program-out CV over the corpus.

    Returns per-program and mean achieved/oracle geomean speedups plus
    ``frac_of_oracle`` — the number the paper reports as "% of oracle
    performance" and the CV score stamped into published artifacts."""
    from repro_torch.core.modeling.perf_model import PerformanceModel

    model_cls = model_cls or PerformanceModel
    train_kwargs = dict(train_kwargs or {})
    programs = sorted({s.program for s in samples})
    per_program = {}
    all_ach, all_orc = [], []
    for prog in programs:
        train, test = ds.loo_split(samples, prog)
        if not train or not test:
            continue
        X, y = ds.training_matrix(train)
        model = model_cls.train(X, y, **train_kwargs)
        ach = [achieved_speedup(s, pick_config(model, s)) for s in test]
        orc = [s.oracle_speedup for s in test]
        all_ach += ach
        all_orc += orc
        per_program[prog] = {
            "achieved": geomean(ach),
            "oracle": geomean(orc),
            "frac_of_oracle": geomean(ach) / geomean(orc),
        }
        if verbose:
            print(f"  loo[{prog:>16s}] achieved={geomean(ach):5.3f}x "
                  f"oracle={geomean(orc):5.3f}x "
                  f"({100 * geomean(ach) / geomean(orc):5.1f}%)",
                  file=sys.stderr, flush=True)
    if not per_program:
        raise ValueError(
            "leave-one-program-out CV needs at least two program "
            f"families; corpus has {sorted({s.program for s in samples})}")
    mean_ach, mean_orc = geomean(all_ach), geomean(all_orc)
    return {
        "per_program": per_program,
        "mean_achieved": mean_ach,
        "mean_oracle": mean_orc,
        "frac_of_oracle": mean_ach / mean_orc,
        "n_programs": len(per_program),
        "n_cells": len(all_ach),
    }
