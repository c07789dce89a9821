"""The zero-training overlap heuristic — the explicit fallback estimator.

Historically this lived inside the serving scheduler as the stand-in for
a trained model; serving now loads a trained artifact by default and the
heuristic is demoted to an opt-in fallback (``serve.py --model
heuristic``) and the no-training baseline the benchmark harness scores
the learnt model against.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import features as feat_lib
from repro_torch.core.features import RAW_FEATURE_NAMES
from repro_torch.core.modeling.base import EstimatorBase, register_estimator

_I_T_XFER = RAW_FEATURE_NAMES.index("t_transfer_us")
_I_T_COMP = RAW_FEATURE_NAMES.index("t_compute_us")


@register_estimator
class OverlapHeuristicModel(EstimatorBase):
    """Zero-training stand-in for a trained :class:`PerformanceModel`.

    Scores each candidate with the classic streams overlap bound: with
    ``n`` tasks the makespan is the dominant phase plus ``1/n`` of the
    overlapped phase plus a per-dispatch overhead that grows with
    partitions × tasks.  Deterministic given the extracted features, so
    smoke paths that opt into it (``--model heuristic``) need no
    training set.

    Fully vectorized: the candidate grid is scored as numpy arrays (the
    ``(partitions, tasks)`` columns are memoized per grid), and a
    ``(B, F)`` feature matrix scores ``B`` programs in one call — the
    same batched contract as :meth:`PerformanceModel.predict_configs`.
    """

    kind = "heuristic"

    def __init__(self, overhead_s: float = 30e-6):
        self.overhead_s = overhead_s

    def predict_configs(self, prog_feats: np.ndarray,
                        configs) -> np.ndarray:
        P = np.atleast_2d(np.asarray(prog_feats, dtype=np.float64))
        t_comp = P[:, _I_T_COMP, None] * 1e-6          # (B, 1)
        t_xfer = P[:, _I_T_XFER, None] * 1e-6
        base = np.maximum(t_comp + t_xfer, 1e-9)
        parts, tasks = feat_lib.config_pt_arrays(configs)   # (C,), (C,)
        makespan = (np.maximum(t_comp, t_xfer)
                    + np.minimum(t_comp, t_xfer) / tasks
                    + self.overhead_s * parts * tasks)
        preds = base / makespan                         # (B, C)
        return preds[0] if np.ndim(prog_feats) == 1 else preds

    # no ``refit``: the heuristic is immutable under serving, so tenancy
    # never forks it and drift refinement only rewrites cache entries

    def fork(self) -> "OverlapHeuristicModel":
        return self

    def to_state(self) -> tuple[dict, dict]:
        return {}, {"overhead_s": float(self.overhead_s)}

    @classmethod
    def from_state(cls, arrays: dict, extras: dict) -> "OverlapHeuristicModel":
        return cls(overhead_s=float(extras.get("overhead_s", 30e-6)))
