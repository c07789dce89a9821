"""The port's modeling stack against the JAX package's.

The MLP is held to the JAX one with the same weights carried across
(``perf_model_from_jax``); artifacts load in both directions; the
numpy-only learners and the heuristic give the JAX package's numbers; and
leave-one-program-out (LOO) evaluation on the JAX package's committed CPU
corpus (``benchmarks/data/profile_cache.json``, 6 programs x 2 scales)
gives the JAX package's predictions, picks and score.  Everything runs on
the CPU.
"""
import json
import runpy
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
import torch

from repro.core.modeling import dataset as jds
from repro.core.modeling import evaluate as jeval
from repro.core.modeling import learners as jlearn
from repro.core.modeling import perf_model as jpm
from repro.core.modeling.artifacts import load_artifact as jax_load
from repro.core.modeling.heuristic import OverlapHeuristicModel as JaxHeur
from repro_torch.core.features import RAW_FEATURE_NAMES, config_features
from repro_torch.core.modeling import dataset as ds
from repro_torch.core.modeling import evaluate
from repro_torch.core.modeling import learners, perf_model
from repro_torch.core.modeling.artifacts import load_artifact
from repro_torch.core.modeling.heuristic import OverlapHeuristicModel
from repro_torch.core.modeling.registry import ModelRegistry
from repro_torch.core.stream_config import StreamConfig
from repro_torch.weights import perf_model_from_jax

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "benchmarks" / "data" / "profile_cache.json"
PROGRAMS = ("vecadd", "dotprod", "mvmult", "binomial", "blackscholes",
            "jacobi-1d")
CANDS = [StreamConfig(1, 1), StreamConfig(1, 8), StreamConfig(2, 4),
         StreamConfig(4, 16), StreamConfig(8, 32)]


@pytest.fixture(autouse=True)
def small_port_grid(monkeypatch):
    """A 4x8 config grid for anything the port profiles here, as
    ``tests/conftest.py`` gives the JAX package's ``grid_for``."""
    orig = ds.grid_for
    monkeypatch.setattr(ds, "grid_for",
                        lambda n_rows, max_partitions=4, max_tasks=8:
                        orig(n_rows, max_partitions, max_tasks))


def _corpus(n=240, seed=0):
    """Synthetic (raw features ++ config) -> speedup rows over the full
    22-feature layout."""
    rng = np.random.default_rng(seed)
    X, y = [], []
    for _ in range(n):
        feats = rng.uniform(0.5, 2.0, size=len(RAW_FEATURE_NAMES))
        p = 2 ** rng.integers(0, 4)
        t = 2 ** rng.integers(0, 6)
        speed = 1.0 + 0.4 * np.log2(t) - 0.1 * np.log2(p) \
            + 0.05 * feats[0] + rng.normal() * 0.02
        X.append(np.concatenate([feats, config_features(p, t)]))
        y.append(max(speed, 0.1))
    return np.asarray(X), np.asarray(y)


@pytest.fixture(scope="module")
def jax_mlp():
    X, y = _corpus()
    return jpm.PerformanceModel.train(X, y, epochs=60), X


def _jax_init(seed, in_dim, hidden=(9, 9, 9), *, device="cpu"):
    """The JAX package's initial MLP weights for ``seed``, as tensors."""
    params = jpm._init_mlp(jax.random.key(seed), in_dim, hidden)
    return [{k: torch.from_numpy(np.array(layer[k])).to(device)
             for k in ("w", "b")} for layer in params]


def test_mlp_forward_with_carried_weights_matches_jax(jax_mlp):
    ref, X = jax_mlp
    port = perf_model_from_jax(ref)
    np.testing.assert_allclose(port.predict(X), ref.predict(X),
                               rtol=1e-6, atol=1e-6)
    feats = X[0, :len(RAW_FEATURE_NAMES)]
    np.testing.assert_allclose(port.predict_configs(feats, CANDS),
                               ref.predict_configs(feats, CANDS),
                               rtol=1e-6, atol=1e-6)


def test_adam_training_matches_jax_from_the_same_start(jax_mlp, monkeypatch):
    monkeypatch.setattr(perf_model, "_init_mlp", _jax_init)
    X, y = _corpus()
    ref = jpm.PerformanceModel.train(X, y, epochs=60)
    port = perf_model.PerformanceModel.train(X, y, epochs=60, device="cpu")
    np.testing.assert_allclose(port.predict(X), ref.predict(X),
                               rtol=1e-4, atol=1e-4)


def test_training_needs_the_card_unless_told(monkeypatch):
    X, y = _corpus(n=40)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        perf_model.PerformanceModel.train(X, y, epochs=2)
    model = perf_model.PerformanceModel.train(X, y, epochs=2, device="cpu")
    assert model.device == torch.device("cpu")


def test_init_is_seeded_and_refit_forks_isolate():
    a = perf_model._init_mlp(3, 5)
    b = perf_model._init_mlp(3, 5)
    for la, lb in zip(a, b):
        assert torch.equal(la["w"], lb["w"])
    X, y = _corpus(n=60)
    model = perf_model.PerformanceModel.train(X, y, epochs=20, device="cpu")
    fork = model.fork()
    before = model.predict(X)
    fork.refit(X[:10], y[:10] * 1.5, epochs=20)
    np.testing.assert_array_equal(model.predict(X), before)
    assert not np.array_equal(fork.predict(X), before)


def test_jax_artifact_loads_in_port_and_back(jax_mlp, tmp_path):
    ref, X = jax_mlp
    ref.save(tmp_path / "jax")
    port, manifest = load_artifact(tmp_path / "jax")
    assert manifest["kind"] == "mlp"
    np.testing.assert_allclose(port.predict(X), ref.predict(X),
                               rtol=1e-6, atol=1e-6)
    port.save(tmp_path / "port")
    back, _ = jax_load(tmp_path / "port")
    np.testing.assert_allclose(np.asarray(back.predict(X)), ref.predict(X),
                               rtol=1e-6, atol=1e-6)
    with np.load(tmp_path / "port" / "weights.npz") as a, \
            np.load(tmp_path / "jax" / "weights.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kind", ["cart", "forest", "krr"])
def test_numpy_learners_match_jax(kind, tmp_path):
    X, y = _corpus()
    kw = {"cart": dict(depth=6), "forest": dict(n_trees=3, depth=5),
          "krr": dict(max_train=150)}[kind]
    cls = {"cart": "TreeRegressor", "forest": "ForestRegressor",
           "krr": "KernelRidgeRBF"}[kind]
    ref = getattr(jlearn, cls).train(X, y, **kw)
    port = getattr(learners, cls).train(X, y, **kw)
    np.testing.assert_array_equal(port.predict(X), ref.predict(X))
    port.save(tmp_path / kind)
    back, _ = jax_load(tmp_path / kind)
    np.testing.assert_array_equal(back.predict(X), ref.predict(X))


def _samples(tmp_path):
    """Both packages' Samples of the committed 12-cell CPU corpus, read
    from a copy so nothing profiles or writes the original."""
    cache = tmp_path / "profile_cache.json"
    shutil.copy(CORPUS, cache)
    port = ds.generate(PROGRAMS, datasets_per_program=2, cache_path=cache,
                       verbose=False, device="cpu")
    ref = jds.generate(PROGRAMS, datasets_per_program=2, cache_path=cache,
                       verbose=False)
    assert CORPUS.read_bytes() == cache.read_bytes()
    return port, ref


def test_heuristic_evaluation_identical(tmp_path):
    port, ref = _samples(tmp_path)
    assert len(port) == 12
    assert (evaluate.evaluate_model(OverlapHeuristicModel(), port)
            == jeval.evaluate_model(JaxHeur(), ref))


def _recording(cls, log, **fixed):
    class Recorder:
        @staticmethod
        def train(X, y, **kw):
            model = cls.train(X, y, **kw, **fixed)
            log.append(model)
            return model
    return Recorder


@pytest.fixture
def jax_random_stream_of_the_bench():
    """The JAX random stream ``BENCH_model.json`` was made with: JAX 0.5
    turned ``jax_threefry_partitionable`` on, which changed the initial
    weights ``jax.random`` draws for a seed (the JAX package's LOO on the
    committed corpus reads 0.7035 with it on, 0.7504 with it off)."""
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", before)


# Folds whose JAX training is chaotic: moving the JAX package's own
# initial weights by 1e-7 relative moves its trained predictions by 0.042
# (blackscholes held out), so no implementation that rounds differently
# can agree to 1e-3 there.  Their picks are held to the same achieved
# speedup instead.
CHAOTIC_FOLDS = {"blackscholes"}


def test_loo_parity_on_the_committed_corpus(tmp_path, monkeypatch,
                                            jax_random_stream_of_the_bench):
    """The JAX package's LOO on its committed CPU corpus, run by both
    packages, with the JAX initial weights carried into the port."""
    monkeypatch.setattr(perf_model, "_init_mlp", _jax_init)
    port_samples, ref_samples = _samples(tmp_path)
    port_models, ref_models = [], []
    got = evaluate.loo_evaluate(
        port_samples, model_cls=_recording(
            perf_model.PerformanceModel, port_models, device="cpu"))
    want = jeval.loo_evaluate(
        ref_samples, model_cls=_recording(jpm.PerformanceModel, ref_models))
    assert len(port_models) == len(ref_models) == 6

    near_ties = []
    programs = sorted({s.program for s in ref_samples})
    for prog, pm_, rm in zip(programs, port_models, ref_models):
        for ps, rs in zip(*(
                [s for s in ss if s.program == prog]
                for ss in (port_samples, ref_samples))):
            pick_a = evaluate.pick_config(pm_, ps).as_tuple()
            pick_b = jeval.pick_config(rm, rs).as_tuple()
            if prog in CHAOTIC_FOLDS:
                assert abs(ps.speedup(StreamConfig(*pick_a))
                           - rs.speedup(StreamConfig(*pick_b))) <= 0.01
                continue
            cfgs = [StreamConfig(p, t) for p, t in rs.times]
            a = pm_.predict_configs(ps.features, cfgs)
            b = np.asarray(rm.predict_configs(rs.features, cfgs))
            # 1e-3 relative, and for predictions near 0 relative to the
            # largest prediction of the cell
            np.testing.assert_allclose(a, b, rtol=1e-3,
                                       atol=1e-3 * np.abs(b).max(),
                                       err_msg=f"{prog}@{rs.scale}")
            if pick_a != pick_b:
                top = np.sort(b)[-2:]
                # a pick may differ only where the JAX model's two best
                # candidates are within the prediction tolerance
                assert top[1] - top[0] <= 1e-3 * abs(top[1]), (
                    prog, rs.scale, pick_a, pick_b)
                near_ties.append((prog, rs.scale, pick_a, pick_b))
    assert near_ties == []
    print(f"LOO frac_of_oracle: port {got['frac_of_oracle']:.6f}, "
          f"JAX {want['frac_of_oracle']:.6f}")
    assert got["n_cells"] == want["n_cells"] == 12
    assert got["mean_oracle"] == want["mean_oracle"]
    assert abs(got["frac_of_oracle"] - want["frac_of_oracle"]) <= 0.01
    bench = json.loads((ROOT / "BENCH_model.json").read_text())
    assert want["frac_of_oracle"] == pytest.approx(
        bench["model_frac_of_oracle"], abs=1e-9)
    assert abs(got["frac_of_oracle"] - bench["model_frac_of_oracle"]) <= 0.01


def test_train_model_cli_publishes_an_artifact_that_reloads(tmp_path,
                                                            monkeypatch):
    model_dir = tmp_path / "models"
    monkeypatch.setattr(sys, "argv", [
        "train_model", "--programs", "vecadd,dotprod", "--datasets", "2",
        "--epochs", "40", "--device", "cpu",
        "--profile-cache", str(tmp_path / "cache.json"),
        "--model-dir", str(model_dir)])
    runpy.run_module("repro_torch.launch.train_model", run_name="__main__")
    model, manifest = ModelRegistry(model_dir).load("latest")
    assert manifest["artifact_id"] == "mlp-v001"
    assert manifest["cv"]["n_programs"] == 2
    samples = ds.generate(["vecadd"], datasets_per_program=2,
                          cache_path=tmp_path / "cache.json",
                          verbose=False, device="cpu")
    assert len(samples) == 2
    preds = model.predict_configs(samples[0].features, CANDS)
    assert preds.shape == (len(CANDS),) and np.isfinite(preds).all()
    # and the JAX package loads what the port published; trained on
    # measured times, the weights are larger than the synthetic ones above,
    # and the two float32 forward passes (XLA's tanh approximation, other
    # summation orders) part by a few 1e-6
    jmodel, _ = jax_load(model_dir / "mlp-v001")
    np.testing.assert_allclose(
        np.asarray(jmodel.predict_configs(samples[0].features, CANDS)),
        preds, rtol=1e-5, atol=1e-5)


def test_default_paths_stay_apart_from_jax(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_PROFILE_CACHE", raising=False)
    monkeypatch.delenv("REPRO_TORCH_MODEL_DIR", raising=False)
    from repro_torch.core.modeling.registry import default_model_dir
    assert ds.default_cache_path() == ROOT / "build" / "profile_cache_cuda.json"
    assert ds.default_cache_path("cpu").name == "profile_cache_cpu.json"
    assert default_model_dir() == ROOT / "build" / "models"
    monkeypatch.setenv("REPRO_TORCH_PROFILE_CACHE", "/elsewhere/c.json")
    assert ds.default_cache_path() == Path("/elsewhere/c.json")
