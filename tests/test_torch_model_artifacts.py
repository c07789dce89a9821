"""The port's versioned model artifacts and feature pipeline
(``repro_torch.core.modeling.artifacts``, ``.pipeline``, the learners)
against the JAX package's, on the CPU.

Every case of ``tests/test_model_artifacts.py`` runs here under its own
name on both packages: the JAX case's assertions hold for each, and the
two outcomes must be equal (manifests' fields, refusals by exception
type, fingerprints, kept columns, transformed features).  The port's MLP
carries the JAX-trained weights (``weights.perf_model_from_jax``), so the
two packages' MLP predictions agree within 1e-6; the numpy learners and
the heuristic are the same arithmetic and agree exactly.  Where a case
trains an MLP, the port starts from the JAX package's initial weights
and its Adam steps agree within 1e-4 (``test_torch_modeling``).
"""
import json
import types

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none

import repro.core.features as jfeatures
import repro.core.modeling as jmodeling
import repro.core.modeling.perf_model as jperf_model
import repro.core.stream_config as jstream_config
import repro_torch.core.features as tfeatures
import repro_torch.core.modeling as tmodeling
import repro_torch.core.modeling.perf_model as tperf_model
import repro_torch.core.stream_config as tstream_config
from repro_torch.weights import perf_model_from_jax

N_FEAT = len(jfeatures.RAW_FEATURE_NAMES)
PRED_TOL = dict(rtol=1e-6, atol=1e-6)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-4)
KINDS = ["mlp", "cart", "forest", "krr", "heuristic"]


def _pkg(name, modeling, features, stream_config, kw):
    return types.SimpleNamespace(name=name, m=modeling, f=features, kw=kw,
                                 cands=[stream_config.StreamConfig(*c) for c in
                                        ((1, 1), (1, 8), (2, 4), (4, 16), (8, 32))])


JAX = _pkg("jax", jmodeling, jfeatures, jstream_config, {})
PORT = _pkg("port", tmodeling, tfeatures, tstream_config, {"device": "cpu"})


def _corpus(n=240, seed=0):
    """``test_model_artifacts._corpus``."""
    rng = np.random.default_rng(seed)
    X, y = [], []
    for _ in range(n):
        feats = rng.uniform(0.5, 2.0, size=N_FEAT)
        p = 2 ** rng.integers(0, 4)
        t = 2 ** rng.integers(0, 6)
        speed = 1.0 + 0.4 * np.log2(t) - 0.1 * np.log2(p) \
            + 0.05 * feats[0] + rng.normal() * 0.02
        X.append(np.concatenate([feats, jfeatures.config_features(p, t)]))
        y.append(max(speed, 0.1))
    return np.asarray(X), np.asarray(y)


def _trained_models(p, jax_mlp):
    X, y = _corpus()
    return {
        "mlp": jax_mlp if p is JAX else perf_model_from_jax(jax_mlp),
        "cart": p.m.TreeRegressor.train(X, y, depth=6),
        "forest": p.m.ForestRegressor.train(X, y, n_trees=3, depth=5),
        "krr": p.m.KernelRidgeRBF.train(X, y, max_train=150),
        "heuristic": p.m.OverlapHeuristicModel(overhead_s=42e-6),
    }


@pytest.fixture(scope="module")
def models():
    X, y = _corpus()
    jax_mlp = jmodeling.PerformanceModel.train(X, y, epochs=60)
    return {p.name: _trained_models(p, jax_mlp) for p in (JAX, PORT)}


@pytest.fixture
def jax_init(monkeypatch):
    """The port's MLPs start from the JAX package's initial weights."""
    def init(seed, in_dim, hidden=(9, 9, 9), *, device="cpu"):
        params = jperf_model._init_mlp(jax.random.key(seed), in_dim, hidden)
        return [{k: torch.from_numpy(np.array(layer[k])).to(device) for k in ("w", "b")}
                for layer in params]
    monkeypatch.setattr(tperf_model, "_init_mlp", init)


def _refusal(fn, exc, match):
    """The type of the exception ``fn()`` raises (``pytest.raises``)."""
    with pytest.raises(exc, match=match) as info:
        fn()
    return type(info.value).__name__


def _compare(jax_out, port_out, tol):
    """Equal outcomes but for the last item, predictions within ``tol``
    (exact where ``tol`` is None)."""
    assert port_out[:-1] == jax_out[:-1]
    if tol is None:
        np.testing.assert_array_equal(port_out[-1], jax_out[-1])
    else:
        np.testing.assert_allclose(port_out[-1], jax_out[-1], **tol)


@pytest.mark.parametrize("kind", KINDS)
def test_artifact_round_trip_bit_identical(models, kind, tmp_path):
    def scenario(p):
        model = models[p.name][kind]
        assert model.kind == kind
        assert isinstance(model, p.m.Estimator)
        path = p.m.save_artifact(model, tmp_path / p.name / kind, corpus="cafe0123",
                                 cv={"frac_of_oracle": 0.9}, tag="test")
        loaded, manifest = p.m.load_artifact(path)
        assert type(loaded) is type(model)
        rng = np.random.default_rng(7)
        feats = rng.uniform(0.5, 2.0, size=N_FEAT)
        batch = rng.uniform(0.5, 2.0, size=(3, N_FEAT))
        preds = []
        for x in (feats, batch):
            preds.append(loaded.predict_configs(x, p.cands))
            np.testing.assert_array_equal(model.predict_configs(x, p.cands), preds[-1])
        return (manifest["kind"], manifest["corpus_fingerprint"], manifest["cv"],
                manifest["tag"], manifest["feature_schema_hash"], manifest["format_version"],
                np.concatenate([preds[0][None], preds[1]]))
    _compare(scenario(JAX), scenario(PORT), PRED_TOL if kind == "mlp" else None)


def test_every_registered_kind_is_covered(models):
    assert set(models["jax"]) == set(jmodeling.ESTIMATOR_KINDS)
    assert set(models["port"]) == set(tmodeling.ESTIMATOR_KINDS) == set(KINDS)


def test_schema_hash_mismatch_refuses_to_load(models, tmp_path):
    def scenario(p):
        path = p.m.save_artifact(models[p.name]["mlp"], tmp_path / p.name)
        manifest = json.loads((path / "manifest.json").read_text())
        manifest["feature_schema_hash"] = "deadbeefdeadbeef"
        (path / "manifest.json").write_text(json.dumps(manifest))
        refused = _refusal(lambda: p.m.load_artifact(path), p.m.SchemaMismatchError,
                           "feature schema")
        model, _ = p.m.load_artifact(path, allow_schema_mismatch=True)
        assert isinstance(model, p.m.PerformanceModel)
        return refused, type(model).__name__
    assert scenario(PORT) == scenario(JAX) == ("SchemaMismatchError", "PerformanceModel")


def test_newer_format_version_refuses_to_load(models, tmp_path):
    def scenario(p):
        path = p.m.save_artifact(models[p.name]["heuristic"], tmp_path / p.name)
        manifest = json.loads((path / "manifest.json").read_text())
        manifest["format_version"] = 99
        (path / "manifest.json").write_text(json.dumps(manifest))
        return _refusal(lambda: p.m.load_artifact(path), RuntimeError,
                        "format_version")
    assert scenario(PORT) == scenario(JAX) == "RuntimeError"


def test_loaded_model_refits_independently(models, tmp_path, jax_init):
    def scenario(p):
        model = models[p.name]["mlp"]
        path = p.m.save_artifact(model, tmp_path / p.name)
        loaded, _ = p.m.load_artifact(path)
        X, y = _corpus(n=24, seed=3)
        loaded.refit(X, y, epochs=10)
        again, _ = p.m.load_artifact(path)
        feats = np.full(N_FEAT, 1.3)
        np.testing.assert_array_equal(model.predict_configs(feats, p.cands),
                                      again.predict_configs(feats, p.cands))
        refit = loaded.predict_configs(feats, p.cands)
        assert not np.array_equal(refit, again.predict_configs(feats, p.cands))
        return (again.predict_configs(feats, p.cands), refit)
    jax_out, port_out = scenario(JAX), scenario(PORT)
    np.testing.assert_allclose(port_out[0], jax_out[0], **PRED_TOL)
    np.testing.assert_allclose(port_out[1], jax_out[1], **TRAIN_TOL)


def test_corpus_fingerprint_is_order_independent():
    class S:
        def __init__(self, program, scale, times):
            self.program, self.scale, self.times = program, scale, times

    a = [S("x", 1, {(1, 1): 0.1}), S("y", 2, {(1, 1): 0.2, (2, 4): 0.3})]
    c = [a[0], S("y", 2, {(1, 1): 0.2, (4, 2): 0.3})]

    def scenario(p):
        fp = p.m.corpus_fingerprint
        assert fp(a) == fp(list(reversed(a)))
        assert fp(a) != fp(a[:1])
        assert fp(a) != fp(c)
        return fp(a), fp(a[:1]), fp(c)
    assert scenario(PORT) == scenario(JAX)


def _pipeline(p, X, y):
    pipe = p.m.FeaturePipeline.fit(X, y, n_components=9)
    Z = pipe.transform(X)
    assert np.isfinite(Z).all()
    return pipe, Z


def test_pipeline_drops_constant_columns():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 5))
    X[:, 2] = 7.0
    y = rng.normal(size=40)

    def scenario(p):
        pipe, Z = _pipeline(p, X, y)
        assert 2 not in set(pipe.keep_idx.tolist())
        return pipe.keep_idx.tolist(), Z
    _compare(scenario(JAX), scenario(PORT), None)


def test_pipeline_clamps_components_to_rank():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(4, 12))
    y = rng.normal(size=4)

    def scenario(p):
        pipe, Z = _pipeline(p, X, y)
        assert pipe.pca_components.shape[1] <= 3
        return pipe.keep_idx.tolist(), pipe.pca_components.shape, Z
    _compare(scenario(JAX), scenario(PORT), None)


def test_pipeline_survives_fully_constant_input():
    X = np.full((10, 4), 3.0)
    y = np.linspace(1, 2, 10)

    def scenario(p):
        pipe, Z = _pipeline(p, X, y)
        assert Z.shape[0] == 10 and Z.shape[1] >= 1
        return pipe.keep_idx.tolist(), Z
    _compare(scenario(JAX), scenario(PORT), None)


def test_degenerate_training_still_serves(jax_init):
    """Both packages train on the rank-deficient corpus and serve finite
    rankings from the same pipeline.  Their trained MLPs are not compared:
    this corpus's PCA rows come in +/- pairs, so at the zero-bias start
    the MLP's output and the targets both have mean 0 and the output
    bias's gradient is of rounding size (9.2e-9 in JAX), which Adam's first
    step turns into a move of up to ``lr`` whose sign is rounding (the two
    packages' predictions then differ by 9.5e-3).  The JAX-trained weights,
    carried into the port, rank as in JAX within 1e-6."""
    rng = np.random.default_rng(2)
    n = 6
    feats = np.tile(rng.normal(size=3), (n, 1))
    cfgf = np.stack([jfeatures.config_features(2 ** (i % 3), 2 ** i) for i in range(n)])
    X = np.concatenate([feats, cfgf], axis=1)
    y = np.linspace(1.0, 2.0, n)

    def scenario(p):
        m = p.m.PerformanceModel.train(X, y, epochs=30, **p.kw)
        preds = m.predict_configs(feats[0], p.cands)
        assert np.isfinite(preds).all()
        return m, m.pipeline.keep_idx.tolist(), m.pipeline.transform(X)
    jax_m, *jax_out = scenario(JAX)
    _, *port_out = scenario(PORT)
    _compare(jax_out, port_out, None)
    np.testing.assert_allclose(perf_model_from_jax(jax_m).predict_configs(feats[0], PORT.cands),
                               jax_m.predict_configs(feats[0], JAX.cands), **PRED_TOL)
