"""The port's performance model (``repro_torch.core.perf_model``: the
feature pipeline, the MLP regression and the numpy learners) against the
JAX package's, on the CPU.

Every case of ``tests/test_perf_model.py`` runs here under its own name on
both packages: the JAX case's assertions hold for each, and the two
outcomes must agree.  The pipeline, the config features and the numpy
learners are the same float64 arithmetic and agree exactly.  The port's
MLP trains with ``device="cpu"`` from the JAX package's initial weights;
its float32 Adam steps agree with JAX's within ``TRAIN_TOL`` (measured
on this corpus: predictions at most 1.3e-6 apart after 200, 300 and 500
epochs), and the configs each package picks are equal.
"""
import types

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none

import repro.core.features as jfeatures
import repro.core.modeling.perf_model as jmlp
import repro.core.perf_model as jperf_model
import repro.core.stream_config as jstream_config
import repro_torch.core.features as tfeatures
import repro_torch.core.modeling.perf_model as tmlp
import repro_torch.core.perf_model as tperf_model
import repro_torch.core.stream_config as tstream_config

N_SYN_FEATURES = 6
TRAIN_TOL = dict(rtol=1e-5, atol=1e-5)


def _pkg(name, perf_model, features, stream_config, kw):
    return types.SimpleNamespace(name=name, pm=perf_model, f=features,
                                 Config=stream_config.StreamConfig, kw=kw)


JAX = _pkg("jax", jperf_model, jfeatures, jstream_config, {})
PORT = _pkg("port", tperf_model, tfeatures, tstream_config, {"device": "cpu"})


def _jax_init(seed, in_dim, hidden=(9, 9, 9), *, device="cpu"):
    """The JAX package's initial MLP weights for ``seed``, as tensors."""
    params = jmlp._init_mlp(jax.random.key(seed), in_dim, hidden)
    return [{k: torch.from_numpy(np.array(layer[k])).to(device) for k in ("w", "b")}
            for layer in params]


def _synthetic(n=600, seed=0, n_feat=N_SYN_FEATURES):
    """``test_perf_model._synthetic``."""
    rng = np.random.default_rng(seed)
    X, y = [], []
    for _ in range(n):
        feats = rng.normal(size=n_feat)
        ratio = feats[-1]
        p = 2 ** rng.integers(0, 5)
        t = 2 ** rng.integers(0, 6)
        opt_logt = 2.0 + ratio
        speed = 1.5 - 0.15 * (np.log2(t) - opt_logt) ** 2 - 0.1 * np.log2(p)
        speed += rng.normal() * 0.02
        X.append(np.concatenate([feats, jfeatures.config_features(p, t)]))
        y.append(max(speed, 0.1))
    return np.asarray(X), np.asarray(y)


@pytest.fixture(scope="module")
def data():
    return _synthetic()


@pytest.fixture(scope="module")
def trained(data):
    """``trained(p, epochs)``: package ``p``'s MLP on ``data``, trained once
    per epoch count (the port's from the JAX package's initial weights)."""
    X, y = data
    memo = {}

    def get(p, epochs):
        if (p.name, epochs) not in memo:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(tmlp, "_init_mlp", _jax_init)
                memo[(p.name, epochs)] = p.pm.PerformanceModel.train(X, y, epochs=epochs,
                                                                     **p.kw)
        return memo[(p.name, epochs)]
    return get


def test_pipeline_shapes_and_pruning(data):
    X, y = data
    X2 = np.concatenate([X, X[:, :1] * 2.0], axis=1)

    def scenario(p):
        pipe = p.pm.FeaturePipeline.fit(X2, y, n_components=9)
        assert len(pipe.keep_idx) < X2.shape[1]
        Z = pipe.transform(X2)
        assert Z.shape[0] == len(y) and Z.shape[1] <= 9
        yn = pipe.transform_y(y)
        assert abs(yn.mean()) < 1e-8 and abs(yn.std() - 1) < 1e-6
        np.testing.assert_allclose(pipe.inverse_y(yn), y, rtol=1e-6)
        return pipe.keep_idx.tolist(), Z, yn
    (jk, jz, jy), (tk, tz, ty) = scenario(JAX), scenario(PORT)
    assert tk == jk
    np.testing.assert_array_equal(tz, jz)
    np.testing.assert_array_equal(ty, jy)


def test_mlp_learns_synthetic_speedups(data, trained):
    X, y = data

    def scenario(p):
        pred = trained(p, 500).predict(X)
        mse = float(np.mean((pred - y) ** 2))
        assert mse < 0.05, mse
        return pred
    np.testing.assert_allclose(scenario(PORT), scenario(JAX), **TRAIN_TOL)


def test_model_ranks_configs_sensibly(trained):
    def scenario(p):
        m = trained(p, 500)
        feats = np.zeros(N_SYN_FEATURES)
        feats[-1] = 1.0
        cfgs = [p.Config(1, t) for t in (1, 2, 4, 8, 16, 32)]
        preds = m.predict_configs(feats, cfgs)
        best = cfgs[int(np.argmax(preds))]
        assert best.tasks in (4, 8, 16), best
        return best.as_tuple(), preds
    (jb, jp), (tb, tp) = scenario(JAX), scenario(PORT)
    assert tb == jb
    np.testing.assert_allclose(tp, jp, **TRAIN_TOL)


def test_generalizes_to_unseen_configs(trained):
    def scenario(p):
        m = trained(p, 300)
        pred = m.predict_configs(np.zeros(N_SYN_FEATURES), [p.Config(3, 24)])
        assert np.isfinite(pred).all()
        return pred
    np.testing.assert_allclose(scenario(PORT), scenario(JAX), **TRAIN_TOL)


@pytest.mark.parametrize("cls", ["TreeRegressor", "ForestRegressor", "KernelRidgeRBF"])
def test_alternative_learners(cls):
    X, y = _synthetic(n=400)

    def scenario(p):
        pred = getattr(p.pm, cls).train(X, y).predict(X)
        assert np.isfinite(pred).all()
        mse = float(np.mean((pred - y) ** 2))
        assert mse < 0.25, (cls, mse)
        return pred
    np.testing.assert_array_equal(scenario(PORT), scenario(JAX))


def test_config_features_monotone():
    def scenario(p):
        a, b = p.f.config_features(1, 1), p.f.config_features(4, 16)
        assert a.shape == (p.f.N_CONFIG_FEATURES,)
        assert b[0] > a[0] and b[1] > a[1]
        return np.stack([a, b])
    np.testing.assert_array_equal(scenario(PORT), scenario(JAX))


def test_predict_configs_batched_matches_per_program(trained):
    progs = np.random.default_rng(1).normal(size=(3, N_SYN_FEATURES))

    def scenario(p):
        m = trained(p, 200)
        cands = [p.Config(1, 1), p.Config(1, 8), p.Config(2, 4), p.Config(4, 16)]
        batched = m.predict_configs(progs, cands)
        assert batched.shape == (3, len(cands))
        for b in range(3):
            single = m.predict_configs(progs[b], cands)
            assert single.shape == (len(cands),)
            np.testing.assert_allclose(batched[b], single, rtol=1e-5, atol=1e-6)
        return batched
    np.testing.assert_allclose(scenario(PORT), scenario(JAX), **TRAIN_TOL)
