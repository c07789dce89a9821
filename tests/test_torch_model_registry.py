"""The port's model lifecycle (``repro_torch.core.modeling.registry``,
``TenantRegistry``, ``AdaptiveScheduler.swap_model`` and
``launch.serve.resolve_serving_model``) against the JAX package's, on the
CPU.

Every case of ``tests/test_model_registry.py`` runs here under its own
name on both packages: the JAX case's assertions hold for each, and the
two outcomes must be equal (artifact ids, pointers, manifests' fields,
refusals by exception type).  The port's MLPs carry the JAX-trained
weights (``weights.perf_model_from_jax``), so both packages serve the same
model; their predictions agree within 1e-6.
"""
import shutil
import types

import numpy as np
import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none

import repro.core.features as jfeatures
import repro.core.modeling as jmodeling
import repro.core.stream_config as jstream_config
import repro.launch.serve as jserve
import repro.serving as jserving
import repro_torch.core.modeling as tmodeling
import repro_torch.core.stream_config as tstream_config
import repro_torch.launch.serve as tserve
import repro_torch.serving as tserving
from repro_torch.weights import perf_model_from_jax

N_FEAT = len(jfeatures.RAW_FEATURE_NAMES)
PRED_TOL = dict(rtol=1e-6, atol=1e-6)


def _pkg(name, modeling, stream_config, serve, serving, carry, kw):
    return types.SimpleNamespace(name=name, m=modeling, sc=stream_config, serve=serve,
                                 s=serving, carry=carry, kw=kw)


JAX = _pkg("jax", jmodeling, jstream_config, jserve, jserving, lambda m: m, {})
PORT = _pkg("port", tmodeling, tstream_config, tserve, tserving, perf_model_from_jax,
            {"device": "cpu"})


def _tiny_jax_model(seed=0, epochs=25):
    """``test_model_registry._tiny_model``: the JAX package's MLP."""
    rng = np.random.default_rng(seed)
    n = 60
    X = np.concatenate(
        [rng.uniform(0.5, 2.0, size=(n, N_FEAT)),
         np.stack([jfeatures.config_features(2 ** (i % 3), 2 ** (i % 5))
                   for i in range(n)])], axis=1)
    y = rng.uniform(0.5, 3.0, size=n)
    return jmodeling.PerformanceModel.train(X, y, epochs=epochs)


@pytest.fixture(scope="module")
def jax_models():
    return {seed: _tiny_jax_model(seed) for seed in range(4)}


def _run(scenario, jax_models, tmp_path):
    """``scenario(pkg, models, dir)`` on both packages, each with its own
    copy of the same MLPs and its own directory: (JAX's outcome, the
    port's)."""
    outs = []
    for p in (JAX, PORT):
        d = tmp_path / p.name
        d.mkdir()
        outs.append(scenario(p, {s: p.carry(m) for s, m in jax_models.items()}, d))
    return outs


def _both(scenario, jax_models, tmp_path):
    """``_run``, requiring equal outcomes; returns JAX's."""
    jax_out, port_out = _run(scenario, jax_models, tmp_path)
    assert port_out == jax_out
    return jax_out


def _close(scenario, jax_models, tmp_path):
    """``_run`` for an outcome whose last item is predictions: the rest
    equal, the predictions within ``PRED_TOL``."""
    jax_out, port_out = _run(scenario, jax_models, tmp_path)
    assert port_out[:-1] == jax_out[:-1]
    np.testing.assert_allclose(port_out[-1], jax_out[-1], **PRED_TOL)


def _refusal(fn, exc, match):
    """The type of the exception ``fn()`` raises (``pytest.raises``)."""
    with pytest.raises(exc, match=match) as info:
        fn()
    return type(info.value).__name__


def test_publish_allocates_versions_and_pins_latest(jax_models, tmp_path):
    def scenario(p, models, d):
        reg = p.m.ModelRegistry(d)
        assert reg.list() == [] and reg.latest_id() is None
        a1 = reg.publish(models[0])
        a2 = reg.publish(models[0])
        assert [a1, a2] == ["mlp-v001", "mlp-v002"]
        assert reg.latest_id() == a2
        model, manifest = reg.load("latest")
        assert manifest["artifact_id"] == a2
        assert isinstance(model, p.m.PerformanceModel)
        assert reg.load(a1)[1]["artifact_id"] == a1
        assert reg.load(str(d / a1))[1]["artifact_id"] == a1
        return [a1, a2], reg.list(), reg.latest_id(), manifest["kind"]
    _both(scenario, jax_models, tmp_path)


def test_tenant_publish_never_auto_pins(jax_models, tmp_path):
    def scenario(p, models, d):
        reg = p.m.ModelRegistry(d)
        fleet = reg.publish(models[0])
        fork_id = reg.publish(models[0].fork(), tenant="tenant-a")
        assert fork_id == "mlp-tenant-a-v001"
        assert reg.latest_id() == fleet
        assert reg.manifest(fork_id)["tenant"] == "tenant-a"
        again = reg.publish(models[0].fork(), tenant="tenant-a")
        assert again == "mlp-tenant-a-v002"
        return fleet, fork_id, again, reg.latest_id(), reg.list()
    _both(scenario, jax_models, tmp_path)


def test_refresh_hot_swaps_only_on_pointer_move(jax_models, tmp_path):
    def scenario(p, models, d):
        reg = p.m.ModelRegistry(d)
        a1 = reg.publish(models[0])
        _, manifest = reg.load("latest")
        assert reg.refresh(manifest["artifact_id"]) is None
        a2 = reg.publish(models[1])
        swapped = reg.refresh(manifest["artifact_id"])
        assert swapped is not None
        new_model, new_manifest = swapped
        assert new_manifest["artifact_id"] == a2 != a1
        assert reg.refresh(a2) is None
        feats = np.full(N_FEAT, 1.1)
        cands = list(p.sc.default_space(4, 8))
        return a1, a2, new_model.predict_configs(feats, cands).tolist()
    _close(scenario, jax_models, tmp_path)


def test_load_missing_artifact_raises(jax_models, tmp_path):
    def scenario(p, models, d):
        reg = p.m.ModelRegistry(d)
        return (_refusal(lambda: reg.load("latest"), FileNotFoundError, "no 'latest'"),
                _refusal(lambda: reg.load("mlp-v999"), FileNotFoundError, "no artifact"))
    assert _both(scenario, jax_models, tmp_path) == ("FileNotFoundError",) * 2


def test_dangling_latest_pointer_is_corruption_not_empty(jax_models, tmp_path):
    """latest -> a deleted artifact raises RuntimeError on both packages,
    from the registry and from serving's model resolution."""
    def scenario(p, models, d):
        reg = p.m.ModelRegistry(d)
        aid = reg.publish(models[0])
        shutil.rmtree(d / aid)
        return (_refusal(lambda: reg.load("latest"), RuntimeError, "points at"),
                _refusal(lambda: p.serve.resolve_serving_model("latest", d, verbose=False,
                                                               **p.kw),
                         RuntimeError, "points at"))
    assert _both(scenario, jax_models, tmp_path) == ("RuntimeError",) * 2


def test_tenant_registry_draws_base_from_model_registry(jax_models, tmp_path):
    def scenario(p, models, d):
        reg = p.m.ModelRegistry(d)
        aid = reg.publish(models[0])
        tenants = p.s.TenantRegistry.from_model_registry(reg, p.s.DriftDetector(),
                                                         isolate=True)
        assert tenants.base_artifact_id == aid
        ctx = tenants.get("tenant-a")
        preds = ctx.active_model.predict_configs(np.full(N_FEAT, 1.2),
                                                 [p.sc.SINGLE_STREAM])
        assert np.isfinite(preds).all()
        return tenants.base_artifact_id, preds.tolist()
    _close(scenario, jax_models, tmp_path)


def test_persist_forks_publishes_tenant_tagged_artifacts(jax_models, tmp_path):
    def scenario(p, models, d):
        reg = p.m.ModelRegistry(d)
        reg.publish(models[0])
        tenants = p.s.TenantRegistry.from_model_registry(reg, p.s.DriftDetector(),
                                                         isolate=True)
        ctx = tenants.get("tenant-a")
        fork = ctx.fork_for_refit()
        assert ctx.forked and fork is not tenants.base_model
        tenants.get("tenant-b")
        published = tenants.persist_forks(reg, tag="drift-corrected")
        assert list(published) == ["tenant-a"]
        fork_id = published["tenant-a"]
        loaded, manifest = reg.load(fork_id)
        assert manifest["tenant"] == "tenant-a"
        assert manifest["tag"] == "drift-corrected"
        assert reg.latest_id() != fork_id
        feats = np.full(N_FEAT, 0.8)
        cands = list(p.sc.default_space(4, 8))
        np.testing.assert_array_equal(fork.predict_configs(feats, cands),
                                      loaded.predict_configs(feats, cands))
        return (published, manifest["tenant"], manifest["tag"], reg.latest_id(),
                loaded.predict_configs(feats, cands).tolist())
    _close(scenario, jax_models, tmp_path)


def test_hot_swap_updates_unforked_contexts_only(jax_models, tmp_path):
    def scenario(p, models, d):
        old, new = models[0], models[2]
        tenants = p.s.TenantRegistry(old, p.s.DriftDetector(), isolate=True)
        forked_ctx = tenants.get("tenant-a")
        fork = forked_ctx.fork_for_refit()
        fresh_ctx = tenants.get("tenant-b")
        tenants.hot_swap(new)
        picks = (tenants.base_model is new, fresh_ctx.active_model is new,
                 forked_ctx.active_model is fork, tenants.get("tenant-c").active_model is new)
        assert picks == (True,) * 4
        return picks
    _both(scenario, jax_models, tmp_path)


def test_scheduler_swap_model_rotates_model_and_tag(jax_models, tmp_path):
    def scenario(p, models, d):
        new = models[3]
        sched = p.s.AdaptiveScheduler(models[0], model_tag="mlp-v001", **p.kw)
        try:
            sched.swap_model(new, model_tag="mlp-v002")
            out = (sched.model is new, sched.refiner.model is new,
                   sched.tenancy.base_model is new, sched.model_tag,
                   sched.tenancy.get("anyone").active_model is new)
            assert out == (True, True, True, "mlp-v002", True)
            return out
        finally:
            sched.close()
    _both(scenario, jax_models, tmp_path)


def test_resolve_serving_model_heuristic_and_artifact(jax_models, tmp_path):
    def scenario(p, models, d):
        resolve = p.serve.resolve_serving_model
        model, info = resolve("heuristic", d, verbose=False, **p.kw)
        assert isinstance(model, p.m.OverlapHeuristicModel)
        assert info["artifact_id"] == "heuristic"
        reg = p.m.ModelRegistry(d)
        aid = reg.publish(models[0], cv={"frac_of_oracle": 0.88})
        model2, info2 = resolve("latest", d, verbose=False, **p.kw)
        assert isinstance(model2, p.m.PerformanceModel)
        assert info2["artifact_id"] == aid
        assert info2["cv_frac_of_oracle"] == 0.88
        refused = _refusal(lambda: resolve("latest", d / "empty", bootstrap=False,
                                           verbose=False, **p.kw), FileNotFoundError, None)
        return (info["artifact_id"], aid, info2["artifact_id"], info2["cv_frac_of_oracle"],
                refused)
    _both(scenario, jax_models, tmp_path)
