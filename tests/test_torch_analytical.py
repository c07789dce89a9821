"""The port's analytical baselines (Liu et al., Werkhoven et al.) and the
classification baseline against the JAX package's.

The cases of ``tests/test_analytical.py`` run on the port's modules, and
on the JAX package's committed CPU corpus
(``benchmarks/data/profile_cache.json``, 6 programs x 2 scales) both
packages pick the same configuration for every sample: Liu and
Werkhoven from ``probe_from_features``, the k-NN classifier under
leave-one-program-out, each scored through ``achieved_speedup``.
"""
import shutil
from pathlib import Path

import numpy as np
import pytest

from repro.core import analytical as jan
from repro.core.classifier import KNNClassifier as JaxKNN
from repro.core.modeling import dataset as jds
from repro.core.modeling import evaluate as jeval
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
from repro_torch.core.analytical import (ProgramProbe, liu_config,
                                         probe_from_features,
                                         werkhoven_config)
from repro_torch.core.classifier import KNNClassifier, merge_labels
from repro_torch.core.features import RAW_FEATURE_NAMES
from repro_torch.core.modeling import dataset as ds
from repro_torch.core.modeling import evaluate
from repro_torch.core.stream_config import StreamConfig

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "benchmarks" / "data" / "profile_cache.json"
PROGRAMS = ("vecadd", "dotprod", "mvmult", "binomial", "blackscholes",
            "jacobi-1d")


def test_liu_transfer_dominated_gives_two_tasks():
    probe = ProgramProbe(n_rows=1024, bytes_h2d=1e8, bytes_d2h=1e6,
                         t_transfer=10e-3, t_kernel=1e-3)
    cfg = liu_config(probe)
    assert cfg.tasks == 2  # paper: m = N/2 for transfer-dominated


def test_liu_kernel_dominated_scales_with_overhead():
    probe = ProgramProbe(n_rows=4096, bytes_h2d=1e7, bytes_d2h=1e5,
                         t_transfer=1e-3, t_kernel=50e-3)
    cfg = liu_config(probe)
    assert 1 <= cfg.tasks <= 64
    assert cfg.partitions == cfg.tasks  # XeonPhi convention (paper §5.2)


def test_werkhoven_returns_valid_config():
    probe = ProgramProbe(n_rows=2048, bytes_h2d=5e7, bytes_d2h=5e7,
                         t_transfer=5e-3, t_kernel=5e-3)
    cfg = werkhoven_config(probe)
    assert cfg.tasks >= 1 and cfg.partitions == cfg.tasks


def test_werkhoven_prefers_more_tasks_when_overlappable():
    probe = ProgramProbe(n_rows=2048, bytes_h2d=1e8, bytes_d2h=1e8,
                         t_transfer=20e-3, t_kernel=20e-3)
    assert werkhoven_config(probe).tasks > 1


def test_probe_from_features_roundtrip():
    feats = dict(zip(RAW_FEATURE_NAMES, np.arange(len(RAW_FEATURE_NAMES),
                                                  dtype=float)))
    feats["loop_count"] = 128
    feats["dts"] = 1e6
    feats["out_bytes"] = 1e5
    feats["t_transfer_us"] = 100.0
    feats["t_compute_us"] = 900.0
    p = probe_from_features(feats)
    assert p.n_rows == 128 and p.t_kernel == 900e-6
    assert p == ProgramProbe(**vars(jan.probe_from_features(feats)))


def test_label_merging_removes_rare_labels():
    labels = [StreamConfig(1, 8)] * 5 + [StreamConfig(16, 64)]  # one rare
    merged = merge_labels(labels, min_count=2)
    assert merged.count(StreamConfig(1, 8)) == 6


def test_knn_classifier_predicts_seen_label():
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(0, 0.1, (10, 5)),
                        rng.normal(5, 0.1, (10, 5))])
    labels = [StreamConfig(1, 4)] * 10 + [StreamConfig(8, 32)] * 10
    clf = KNNClassifier.train(X, labels, k=3)
    assert clf.predict(np.zeros(5)) == StreamConfig(1, 4)
    assert clf.predict(np.full(5, 5.0)) == StreamConfig(8, 32)


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    """Both packages' Samples of the committed corpus, read from a copy so
    nothing profiles or writes the original."""
    cache = tmp_path_factory.mktemp("corpus") / "profile_cache.json"
    shutil.copy(CORPUS, cache)
    port = ds.generate(PROGRAMS, datasets_per_program=2, cache_path=cache,
                       verbose=False, device="cpu")
    ref = jds.generate(PROGRAMS, datasets_per_program=2, cache_path=cache,
                       verbose=False)
    assert len(port) == len(ref) == 12
    return port, ref


def _as_tuple(cfg):
    return (cfg.partitions, cfg.tasks)


@pytest.mark.parametrize("method", ["liu_config", "werkhoven_config"])
def test_analytical_picks_identical_on_the_corpus(samples, method):
    port, ref = samples
    fn, jfn = globals()[method], getattr(jan, method)
    for s, r in zip(port, ref):
        assert (s.program, s.scale) == (r.program, r.scale)
        feats = dict(zip(RAW_FEATURE_NAMES, s.features))
        pick = fn(probe_from_features(feats))
        jpick = jfn(jan.probe_from_features(
            dict(zip(RAW_FEATURE_NAMES, r.features))))
        assert _as_tuple(pick) == _as_tuple(jpick)
        assert (evaluate.achieved_speedup(s, pick)
                == jeval.achieved_speedup(r, jpick))


def test_knn_loo_picks_identical_on_the_corpus(samples):
    port, ref = samples
    for prog in PROGRAMS:
        train, test = ds.loo_split(port, prog)
        jtrain, jtest = jds.loo_split(ref, prog)
        clf = KNNClassifier.train(np.stack([s.features for s in train]),
                                  [s.best_config for s in train], k=3)
        jclf = JaxKNN.train(np.stack([s.features for s in jtrain]),
                            [s.best_config for s in jtrain], k=3)
        assert ([_as_tuple(c) for c in clf.labels]
                == [_as_tuple(c) for c in jclf.labels])
        for s, r in zip(test, jtest):
            pick, jpick = clf.predict(s.features), jclf.predict(r.features)
            assert _as_tuple(pick) == _as_tuple(jpick)
            assert (evaluate.achieved_speedup(s, pick)
                    == jeval.achieved_speedup(r, jpick))
