"""Alternative learners for the Table-5 comparison: a CART regression
tree, a bagged random forest, and RBF kernel ridge regression (the
closed-form stand-in for the paper's SVR — no sklearn offline).  All
share the :class:`~repro_torch.core.modeling.pipeline.FeaturePipeline` front
end and the :class:`~repro_torch.core.modeling.base.EstimatorBase` surface, so
they serve, fork, and round-trip through artifacts exactly like the MLP.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.modeling.base import EstimatorBase, register_estimator
from repro_torch.core.modeling.pipeline import FeaturePipeline

__all__ = ["TreeRegressor", "ForestRegressor", "KernelRidgeRBF"]


@dataclasses.dataclass
class _TreeNode:
    feature: int = -1
    thresh: float = 0.0
    value: float = 0.0
    left: Optional["_TreeNode"] = None
    right: Optional["_TreeNode"] = None


def _build_tree(X, y, depth, min_leaf=8) -> _TreeNode:
    node = _TreeNode(value=float(y.mean()))
    if depth == 0 or len(y) < 2 * min_leaf or y.std() < 1e-9:
        return node
    best = (None, None, np.inf)
    n_feat = X.shape[1]
    for j in range(n_feat):
        order = np.argsort(X[:, j])
        xs, ys = X[order, j], y[order]
        csum = np.cumsum(ys)
        csq = np.cumsum(ys ** 2)
        total, total_sq = csum[-1], csq[-1]
        for i in range(min_leaf, len(ys) - min_leaf):
            if xs[i] == xs[i - 1]:
                continue
            nl, nr = i, len(ys) - i
            sl, sr = csum[i - 1], total - csum[i - 1]
            ql, qr = csq[i - 1], total_sq - csq[i - 1]
            sse = (ql - sl**2 / nl) + (qr - sr**2 / nr)
            if sse < best[2]:
                best = (j, (xs[i] + xs[i - 1]) / 2, sse)
    if best[0] is None:
        return node
    j, t, _ = best
    mask = X[:, j] <= t
    node.feature, node.thresh = j, t
    node.left = _build_tree(X[mask], y[mask], depth - 1, min_leaf)
    node.right = _build_tree(X[~mask], y[~mask], depth - 1, min_leaf)
    return node


def _tree_predict_one(node: _TreeNode, x) -> float:
    while node.feature >= 0:
        node = node.left if x[node.feature] <= node.thresh else node.right
    return node.value


def _tree_to_arrays(root: _TreeNode, prefix: str) -> dict:
    """Preorder-flattened node table: parallel arrays of (feature,
    thresh, value, left, right) with -1 child indices at leaves."""
    feature, thresh, value, left, right = [], [], [], [], []

    def visit(node: _TreeNode) -> int:
        idx = len(feature)
        feature.append(node.feature)
        thresh.append(node.thresh)
        value.append(node.value)
        left.append(-1)
        right.append(-1)
        if node.left is not None:
            left[idx] = visit(node.left)
        if node.right is not None:
            right[idx] = visit(node.right)
        return idx

    visit(root)
    return {
        f"{prefix}feature": np.asarray(feature, np.int64),
        f"{prefix}thresh": np.asarray(thresh, np.float64),
        f"{prefix}value": np.asarray(value, np.float64),
        f"{prefix}left": np.asarray(left, np.int64),
        f"{prefix}right": np.asarray(right, np.int64),
    }


def _tree_from_arrays(arrays: dict, prefix: str) -> _TreeNode:
    feature = arrays[f"{prefix}feature"]
    thresh = arrays[f"{prefix}thresh"]
    value = arrays[f"{prefix}value"]
    left = arrays[f"{prefix}left"]
    right = arrays[f"{prefix}right"]

    def build(idx: int) -> _TreeNode:
        node = _TreeNode(int(feature[idx]), float(thresh[idx]),
                         float(value[idx]))
        if left[idx] >= 0:
            node.left = build(int(left[idx]))
        if right[idx] >= 0:
            node.right = build(int(right[idx]))
        return node

    return build(0)


@register_estimator
@dataclasses.dataclass
class TreeRegressor(EstimatorBase):
    pipeline: FeaturePipeline
    root: _TreeNode

    kind = "cart"

    @staticmethod
    def train(X_raw, y, *, depth=10, n_components=9,
              max_rows=4000, seed=0) -> "TreeRegressor":
        pipe = FeaturePipeline.fit(X_raw, y, n_components=n_components)
        X = pipe.transform(X_raw)
        yn = pipe.transform_y(y)
        if len(yn) > max_rows:
            idx = np.random.default_rng(seed).choice(
                len(yn), max_rows, replace=False)
            X, yn = X[idx], yn[idx]
        root = _build_tree(X, yn, depth)
        return TreeRegressor(pipe, root)

    def predict(self, X_raw) -> np.ndarray:
        X = self.pipeline.transform(np.atleast_2d(X_raw))
        yn = np.array([_tree_predict_one(self.root, x) for x in X])
        return self.pipeline.inverse_y(yn)

    def to_state(self) -> tuple[dict, dict]:
        arrays = self.pipeline.to_arrays()
        arrays.update(_tree_to_arrays(self.root, "tree."))
        return arrays, {}

    @classmethod
    def from_state(cls, arrays: dict, extras: dict) -> "TreeRegressor":
        return cls(FeaturePipeline.from_arrays(arrays),
                   _tree_from_arrays(arrays, "tree."))


@register_estimator
@dataclasses.dataclass
class ForestRegressor(EstimatorBase):
    pipeline: FeaturePipeline
    roots: list

    kind = "forest"

    @staticmethod
    def train(X_raw, y, *, n_trees=5, depth=8, n_components=9,
              max_rows=2000, seed=0) -> "ForestRegressor":
        pipe = FeaturePipeline.fit(X_raw, y, n_components=n_components)
        X = pipe.transform(X_raw)
        yn = pipe.transform_y(y)
        rng = np.random.default_rng(seed)
        roots = []
        for _ in range(n_trees):
            idx = rng.integers(0, len(yn), min(len(yn), max_rows))
            roots.append(_build_tree(X[idx], yn[idx], depth))
        return ForestRegressor(pipe, roots)

    def predict(self, X_raw) -> np.ndarray:
        X = self.pipeline.transform(np.atleast_2d(X_raw))
        yn = np.mean([[_tree_predict_one(r, x) for x in X]
                      for r in self.roots], axis=0)
        return self.pipeline.inverse_y(yn)

    def to_state(self) -> tuple[dict, dict]:
        arrays = self.pipeline.to_arrays()
        for i, root in enumerate(self.roots):
            arrays.update(_tree_to_arrays(root, f"tree{i}."))
        return arrays, {"n_trees": len(self.roots)}

    @classmethod
    def from_state(cls, arrays: dict, extras: dict) -> "ForestRegressor":
        roots = [_tree_from_arrays(arrays, f"tree{i}.")
                 for i in range(int(extras["n_trees"]))]
        return cls(FeaturePipeline.from_arrays(arrays), roots)


@register_estimator
@dataclasses.dataclass
class KernelRidgeRBF(EstimatorBase):
    """RBF kernel ridge regression — closed-form SVR stand-in (no sklearn
    offline; documented substitution for the paper's SVM regressor)."""

    pipeline: FeaturePipeline
    X_train: np.ndarray
    alpha: np.ndarray
    gamma: float

    kind = "krr"

    @staticmethod
    def train(X_raw, y, *, lam=1e-2, gamma=None,
              n_components=9, max_train=3000, seed=0) -> "KernelRidgeRBF":
        pipe = FeaturePipeline.fit(X_raw, y, n_components=n_components)
        X = pipe.transform(X_raw)
        yn = pipe.transform_y(y)
        if len(yn) > max_train:
            rng = np.random.default_rng(seed)
            idx = rng.choice(len(yn), max_train, replace=False)
            X, yn = X[idx], yn[idx]
        gamma = gamma or 1.0 / X.shape[1]
        K = _rbf(X, X, gamma)
        alpha = np.linalg.solve(K + lam * np.eye(len(yn)), yn)
        return KernelRidgeRBF(pipe, X, alpha, gamma)

    def predict(self, X_raw) -> np.ndarray:
        X = self.pipeline.transform(np.atleast_2d(X_raw))
        yn = _rbf(X, self.X_train, self.gamma) @ self.alpha
        return self.pipeline.inverse_y(yn)

    def to_state(self) -> tuple[dict, dict]:
        arrays = self.pipeline.to_arrays()
        arrays["krr.X_train"] = np.asarray(self.X_train, np.float64)
        arrays["krr.alpha"] = np.asarray(self.alpha, np.float64)
        arrays["krr.gamma"] = np.asarray(self.gamma, np.float64)
        return arrays, {}

    @classmethod
    def from_state(cls, arrays: dict, extras: dict) -> "KernelRidgeRBF":
        return cls(FeaturePipeline.from_arrays(arrays),
                   arrays["krr.X_train"], arrays["krr.alpha"],
                   float(arrays["krr.gamma"]))


def _rbf(A, B, gamma):
    d2 = (np.sum(A**2, 1)[:, None] + np.sum(B**2, 1)[None, :]
          - 2 * A @ B.T)
    return np.exp(-gamma * np.maximum(d2, 0.0))
