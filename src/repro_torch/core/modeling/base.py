"""The :class:`Estimator` protocol every performance predictor follows,
plus the estimator-kind registry that artifact loading dispatches on.

The serving stack, the autotuner, and the benchmark harness all talk to
models through the same small surface:

  ``predict_configs(prog_feats, configs)``  rank a candidate grid for one
      ``(F,)`` program or a ``(B, F)`` batch of programs;
  ``assemble_rows(prog_feats, configs)``    the raw training/inference row
      layout (program features ++ config encoding);
  ``refit(X, y)``       *optional* incremental online correction hook
      (absent on immutable estimators such as the heuristic);
  ``fork()``            a refit-isolated copy (per-tenant copy-on-refit);
  ``save(path)`` / ``load(path)``  versioned artifact round-trip
      (:mod:`repro_torch.core.modeling.artifacts`).

Concrete estimators register themselves under a short ``kind`` string
(``mlp``, ``cart``, ``forest``, ``krr``, ``heuristic``); the artifact
manifest records the kind so :func:`load_artifact` can rebuild the right
class without the caller knowing it.
"""
from __future__ import annotations

import copy
from typing import TYPE_CHECKING, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.core.features import config_feature_matrix

if TYPE_CHECKING:  # pragma: no cover
    from pathlib import Path

    from repro_torch.core.stream_config import StreamConfig


def assemble_rows(prog_feats: np.ndarray, configs) -> np.ndarray:
    """Program features ++ config encodings, vectorized: ``(F,)`` input
    yields ``(C, F+3)`` rows; ``(B, F)`` input yields ``(B*C, F+3)`` rows
    grouped program-major."""
    P = np.atleast_2d(np.asarray(prog_feats, dtype=np.float64))
    C = config_feature_matrix(configs)
    return np.concatenate([np.repeat(P, len(configs), axis=0),
                           np.tile(C, (P.shape[0], 1))], axis=1)


@runtime_checkable
class Estimator(Protocol):
    """Structural type of everything the serving/tuning layers accept as
    a model.  ``refit`` is deliberately absent: it is optional, and
    callers feature-test it with ``hasattr`` (the heuristic and the
    closed-form learners are immutable under serving)."""

    kind: str

    def predict_configs(self, prog_feats: np.ndarray,
                        configs: Sequence["StreamConfig"]) -> np.ndarray:
        ...

    def fork(self) -> "Estimator":
        ...

    def save(self, path: "str | Path", **meta) -> "Path":
        ...


#: kind string -> estimator class; artifact loading dispatches on this
ESTIMATOR_KINDS: dict[str, type] = {}


def register_estimator(cls):
    """Class decorator: file the estimator under its ``kind`` string."""
    assert getattr(cls, "kind", None), f"{cls.__name__} has no kind"
    ESTIMATOR_KINDS[cls.kind] = cls
    return cls


def get_estimator_kind(kind: str) -> type:
    try:
        return ESTIMATOR_KINDS[kind]
    except KeyError:
        raise KeyError(f"unknown estimator kind {kind!r}; "
                       f"registered: {sorted(ESTIMATOR_KINDS)}") from None


class EstimatorBase:
    """Shared implementation of the :class:`Estimator` surface.

    Subclasses provide ``kind``, ``predict(rows)`` (row-wise regression),
    and the ``to_state`` / ``from_state`` serialization pair; everything
    else — batched config ranking, forking, artifact save/load — is
    inherited."""

    kind: str = ""

    def predict(self, X_raw: np.ndarray) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    assemble_rows = staticmethod(assemble_rows)

    def predict_configs(self, prog_feats: np.ndarray,
                        configs) -> np.ndarray:
        """Rank many configs for one or many programs (the runtime search
        core).  ``prog_feats`` may be a single ``(F,)`` feature vector —
        returns ``(C,)`` predictions — or a ``(B, F)`` matrix of programs
        — returns ``(B, C)``, one forward pass for the whole batch (the
        serving engine's batched cold path)."""
        P = np.atleast_2d(np.asarray(prog_feats, dtype=np.float64))
        rows = assemble_rows(P, configs)
        preds = self.predict(rows).reshape(P.shape[0], len(configs))
        return preds[0] if np.ndim(prog_feats) == 1 else preds

    def fork(self):
        """A refit-isolated copy.  Estimators with cheap shareable state
        (e.g. the MLP's frozen feature pipeline) override this."""
        return copy.deepcopy(self)

    # -- versioned artifact round-trip ---------------------------------------

    def to_state(self) -> tuple[dict, dict]:  # pragma: no cover
        """Returns ``(arrays, extras)``: numpy arrays for the ``.npz``
        payload and JSON-safe scalars for the manifest."""
        raise NotImplementedError

    @classmethod
    def from_state(cls, arrays: dict, extras: dict):  # pragma: no cover
        raise NotImplementedError

    def save(self, path, **meta):
        """Write this estimator as a versioned artifact directory
        (``manifest.json`` + ``weights.npz``); see
        :func:`repro_torch.core.modeling.artifacts.save_artifact`."""
        from repro_torch.core.modeling.artifacts import save_artifact
        return save_artifact(self, path, **meta)

    @classmethod
    def load(cls, path):
        """Load an artifact directory saved by any estimator kind; when
        called on a concrete subclass the kind must match."""
        from repro_torch.core.modeling.artifacts import load_artifact
        model, _ = load_artifact(path)
        if cls is not EstimatorBase and not isinstance(model, cls):
            raise TypeError(f"artifact at {path} holds kind "
                            f"{model.kind!r}, not {cls.kind!r}")
        return model
