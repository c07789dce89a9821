"""The shared feature pipeline (paper §3.2.1-§3.2.2):

  raw program features ++ config encoding
    -> Z-score standardization
    -> correlation pruning (|Pearson rho| > 0.7 drops the later feature)
    -> PCA (9 components; paper: "PCA with 9 components gives the best
       overall result")
  target: speedup over single-stream, Z-score standardized.

Every estimator kind front-ends its learner with one of these; the
artifact layer serializes it to a flat array dict so a saved model
carries its input space with it.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FeaturePipeline:
    mean: np.ndarray
    std: np.ndarray
    keep_idx: np.ndarray          # surviving columns after pruning
    pca_components: np.ndarray    # (kept, n_comp)
    pca_mean: np.ndarray
    y_mean: float
    y_std: float

    @staticmethod
    def fit(X: np.ndarray, y: np.ndarray, *, n_components: int = 9,
            corr_threshold: float = 0.7) -> "FeaturePipeline":
        X = np.asarray(X, dtype=np.float64)
        mean = X.mean(axis=0)
        std = X.std(axis=0)
        constant = std < 1e-12
        std = np.where(constant, 1.0, std)
        Z = (X - mean) / std

        # correlation pruning: keep the earlier feature of any |rho|>0.7
        # pair.  Constant columns are dropped outright — they carry no
        # signal, and their NaN correlations (masked to 0 below) would
        # otherwise always survive the pruning rule.
        n = Z.shape[1]
        with np.errstate(divide="ignore", invalid="ignore"):
            corr = np.corrcoef(Z, rowvar=False)
        corr = np.nan_to_num(np.atleast_2d(corr))
        keep: list[int] = []
        for j in range(n):
            if constant[j]:
                continue
            if all(abs(corr[j, i]) <= corr_threshold for i in keep):
                keep.append(j)
        if not keep:      # fully degenerate input: keep one column so the
            keep = [0]    # transform still produces a well-formed matrix
        keep_idx = np.array(keep, dtype=np.int64)
        Zk = Z[:, keep_idx]

        # PCA, clamped to the numerical rank: with constant columns or
        # n_samples < n_components the trailing singular vectors span the
        # null space — arbitrary axes (sign/permutation unstable across
        # BLAS builds) that would inject pure noise dimensions
        pca_mean = Zk.mean(axis=0)
        Zc = Zk - pca_mean
        _, s, vt = np.linalg.svd(Zc, full_matrices=False)
        tol = (float(s[0]) if s.size else 0.0) \
            * max(Zc.shape) * np.finfo(np.float64).eps
        rank = int(np.sum(s > max(tol, 1e-12)))
        n_comp = max(1, min(n_components, Zk.shape[1], max(rank, 1)))
        components = vt[:n_comp].T  # (kept, n_comp)

        y = np.asarray(y, dtype=np.float64)
        y_mean, y_std = float(y.mean()), float(max(y.std(), 1e-9))
        return FeaturePipeline(mean, std, keep_idx, components, pca_mean,
                               y_mean, y_std)

    def transform(self, X: np.ndarray) -> np.ndarray:
        Z = (X - self.mean) / self.std
        Zk = Z[:, self.keep_idx]
        return (Zk - self.pca_mean) @ self.pca_components

    def transform_y(self, y: np.ndarray) -> np.ndarray:
        return (y - self.y_mean) / self.y_std

    def inverse_y(self, yn: np.ndarray) -> np.ndarray:
        return yn * self.y_std + self.y_mean

    # -- artifact serialization ----------------------------------------------

    def to_arrays(self, prefix: str = "pipe.") -> dict:
        """Flat float64/int64 array dict (npz-ready); scalars become 0-d
        arrays so the round-trip is bit-exact, not JSON-float-exact."""
        return {
            f"{prefix}mean": np.asarray(self.mean, np.float64),
            f"{prefix}std": np.asarray(self.std, np.float64),
            f"{prefix}keep_idx": np.asarray(self.keep_idx, np.int64),
            f"{prefix}pca_components": np.asarray(self.pca_components,
                                                  np.float64),
            f"{prefix}pca_mean": np.asarray(self.pca_mean, np.float64),
            f"{prefix}y_mean": np.asarray(self.y_mean, np.float64),
            f"{prefix}y_std": np.asarray(self.y_std, np.float64),
        }

    @staticmethod
    def from_arrays(arrays: dict, prefix: str = "pipe.") -> "FeaturePipeline":
        return FeaturePipeline(
            mean=arrays[f"{prefix}mean"],
            std=arrays[f"{prefix}std"],
            keep_idx=arrays[f"{prefix}keep_idx"],
            pca_components=arrays[f"{prefix}pca_components"],
            pca_mean=arrays[f"{prefix}pca_mean"],
            y_mean=float(arrays[f"{prefix}y_mean"]),
            y_std=float(arrays[f"{prefix}y_std"]),
        )

    @property
    def n_features_in(self) -> int:
        return int(self.mean.shape[0])
